from ray_tpu_torch.rllib.algorithms.a3c.a3c import A3C, A3CConfig  # noqa: F401
