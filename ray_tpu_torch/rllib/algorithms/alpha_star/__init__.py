from ray_tpu_torch.rllib.algorithms.alpha_star.alpha_star import AlphaStar, AlphaStarConfig  # noqa: F401
