from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig  # noqa: F401
