from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
