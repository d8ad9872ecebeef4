from ray_tpu_torch.rllib.algorithms.crr.crr import CRR, CRRConfig

__all__ = ["CRR", "CRRConfig"]
