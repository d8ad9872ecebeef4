from ray_tpu_torch.rllib.algorithms.bandits.bandits import (  # noqa: F401
    BanditConfig,
    BanditLinTS,
    BanditLinUCB,
)
