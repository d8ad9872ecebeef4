from ray_tpu_torch.rllib.algorithms.dt.dt import DT, DTConfig  # noqa: F401
