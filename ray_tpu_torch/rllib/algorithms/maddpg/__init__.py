from ray_tpu_torch.rllib.algorithms.maddpg.maddpg import MADDPG, MADDPGConfig

__all__ = ["MADDPG", "MADDPGConfig"]
