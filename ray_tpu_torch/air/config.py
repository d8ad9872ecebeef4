"""AIR configs (analog of python/ray/air/config.py: ScalingConfig:91,
RunConfig:704, FailureConfig:523, CheckpointConfig:574). The accelerator
knob is ``use_gpu``/``gpu_per_worker``, on by default: a trainer runs on the
card unless the caller asks for the CPU (``use_gpu=False``). A GPU gang is
reserved atomically through a placement group."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = True
    gpu_per_worker: int = 1
    resources_per_worker: dict | None = None
    placement_strategy: str = "PACK"  # STRICT_PACK => one node

    def worker_resources(self) -> dict:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu:
            res.setdefault("GPU", self.gpu_per_worker)
        else:
            res.setdefault("CPU", 1)
        return res

    def as_placement_group_bundles(self) -> list[dict]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    max_failures: int = 0  # -1 = infinite retries of the whole worker group


@dataclass
class CheckpointConfig:
    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: dict | None = None
    verbose: int = 1
    sync_config: object | None = None  # tune.syncer.SyncConfig (kept untyped: air must not import tune)

    def resolve_dir(self, default_name: str) -> str:
        """Experiment/run directory: <storage_path>/<name> (single source of
        the storage-path policy for Train and Tune)."""
        import os
        import time

        from ray_tpu_torch._private.config import runtime_root

        root = self.storage_path or os.path.join(runtime_root(), "results")
        name = self.name or f"{default_name}_{time.strftime('%Y%m%d-%H%M%S')}"
        return os.path.join(root, name)
