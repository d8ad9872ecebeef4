from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker, WorkerSet  # noqa: F401
