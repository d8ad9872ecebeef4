"""DataParallelTrainer (analog of python/ray/train/data_parallel_trainer.py:58,
training_loop :422): N workers run ``train_loop_per_worker`` with an air
session; the backend plugin forms the collective plane."""

from __future__ import annotations

import logging

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._internal.backend_executor import Backend, BackendExecutor
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.base_trainer import BaseTrainer, Result

logger = logging.getLogger(__name__)


class DataParallelTrainer(BaseTrainer):
    _backend_cls = Backend

    def __init__(
        self,
        train_loop_per_worker,
        *,
        train_loop_config: dict | None = None,
        backend: Backend | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        datasets: dict | None = None,
        resume_from_checkpoint=None,
    ):
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
            datasets=datasets,
        )
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend = backend or self._backend_cls()

    def _shards_per_rank(self):
        """Split datasets into per-rank shards (reference: DataConfig /
        get_dataset_shard; SURVEY.md §2.6 ingest bridge)."""
        n = self.scaling_config.num_workers
        if not self.datasets:
            return None
        per_rank = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "split"):
                shards = ds.split(n)
                for rank in range(n):
                    per_rank[rank][name] = shards[rank]
            else:
                for rank in range(n):
                    per_rank[rank][name] = ds
        return per_rank

    def _fit_direct(self) -> Result:
        run_dir = self._run_dir()
        ckpt_mgr = CheckpointManager(run_dir, self.run_config.checkpoint_config)
        executor = BackendExecutor(
            self.backend,
            self.scaling_config,
            max_failures=self.run_config.failure_config.max_failures,
        )
        executor.start()
        last_metrics: dict = {}
        history: list[dict] = []

        def on_report(metrics, checkpoint):
            nonlocal last_metrics
            last_metrics = metrics
            history.append(metrics)
            if checkpoint is not None:
                ckpt_mgr.register(checkpoint, metrics)

        try:
            final = executor.run(
                self.train_loop_per_worker,
                config=self.train_loop_config,
                dataset_shards_per_rank=self._shards_per_rank(),
                on_report=on_report,
                checkpoint=self.resume_from_checkpoint,
            )
            metrics = final[0] or last_metrics
            result = Result(metrics=metrics, checkpoint=ckpt_mgr.latest, path=run_dir)
        except Exception as e:
            result = Result(metrics=last_metrics, checkpoint=ckpt_mgr.latest, error=str(e), path=run_dir)
            raise
        finally:
            executor.shutdown()
        try:
            import pandas as pd

            result.metrics_dataframe = pd.DataFrame(history)
        except Exception:
            pass
        return result
