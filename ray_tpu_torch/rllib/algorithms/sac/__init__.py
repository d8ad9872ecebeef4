from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig  # noqa: F401
