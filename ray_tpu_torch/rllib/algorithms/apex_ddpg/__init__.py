from ray_tpu_torch.rllib.algorithms.apex_ddpg.apex_ddpg import ApexDDPG, ApexDDPGConfig  # noqa: F401
