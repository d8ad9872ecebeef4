from ray_tpu_torch.rllib.algorithms.apex_dqn.apex_dqn import ApexDQN, ApexDQNConfig  # noqa: F401
