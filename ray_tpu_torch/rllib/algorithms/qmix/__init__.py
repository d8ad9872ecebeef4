from ray_tpu_torch.rllib.algorithms.qmix.qmix import QMIX, QMIXConfig  # noqa: F401
