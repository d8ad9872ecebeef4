from ray_tpu_torch.rllib.algorithms.ars.ars import ARS, ARSConfig

__all__ = ["ARS", "ARSConfig"]
