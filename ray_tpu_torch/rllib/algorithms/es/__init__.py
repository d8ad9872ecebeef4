from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig  # noqa: F401
