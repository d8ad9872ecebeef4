from ray_tpu_torch.rllib.algorithms.r2d2.r2d2 import R2D2, R2D2Config

__all__ = ["R2D2", "R2D2Config"]
