from ray_tpu_torch.tune.analysis.experiment_analysis import ExperimentAnalysis

__all__ = ["ExperimentAnalysis"]
