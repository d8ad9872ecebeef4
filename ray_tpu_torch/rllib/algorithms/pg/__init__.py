from ray_tpu_torch.rllib.algorithms.pg.pg import PG, PGConfig, pg_loss  # noqa: F401
