from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2C, A2CConfig, a2c_loss  # noqa: F401
