from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import DDPG, TD3, DDPGConfig, TD3Config  # noqa: F401
