from ray_tpu_torch.rllib.algorithms.simple_q.simple_q import SimpleQ, SimpleQConfig  # noqa: F401
