from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig  # noqa: F401
