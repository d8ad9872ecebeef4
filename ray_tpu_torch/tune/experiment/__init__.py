from ray_tpu_torch.tune.experiment.trial import Trial  # noqa: F401
