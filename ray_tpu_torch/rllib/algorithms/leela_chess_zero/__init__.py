from ray_tpu_torch.rllib.algorithms.leela_chess_zero.leela_chess_zero import (  # noqa: F401
    LeelaChessZero,
    LeelaChessZeroConfig,
)
