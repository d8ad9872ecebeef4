from ray_tpu_torch.rllib.algorithms.marwil.marwil import BC, MARWIL, BCConfig, MARWILConfig  # noqa: F401
