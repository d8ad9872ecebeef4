from ray_tpu_torch.rllib.algorithms.alpha_zero.alpha_zero import (
    AlphaZero,
    AlphaZeroConfig,
    StateCloneWrapper,
)

__all__ = ["AlphaZero", "AlphaZeroConfig", "StateCloneWrapper"]
