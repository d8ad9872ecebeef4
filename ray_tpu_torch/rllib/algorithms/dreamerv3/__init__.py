from ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3 import (  # noqa: F401
    DreamerV3,
    DreamerV3Config,
)
