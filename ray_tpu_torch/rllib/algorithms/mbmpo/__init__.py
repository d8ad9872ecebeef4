from ray_tpu_torch.rllib.algorithms.mbmpo.mbmpo import MBMPO, MBMPOConfig  # noqa: F401
