"""BackendExecutor — orchestrates the worker gang for one training run.

Analog of the reference's BackendExecutor
(python/ray/train/_internal/backend_executor.py: start:104,
start_training:342) + the backend plugin protocol (train/torch/config.py:155).
Worker-gang LIFECYCLE goes through the shared AIR execution layer
(`ray_tpu_torch.air.execution.ActorManager`): the gang's resources are one
multi-bundle ``ResourceRequest`` (a placement group for GPU gangs), each
``TrainWorker`` is a tracked actor pinned to
its bundle, and gang start / gang restart / shutdown are manager operations.
That makes release guaranteed: a gang restart frees the old placement group
before reserving the new one (the pre-manager code leaked one PG per
restart), and ``shutdown()`` leaves nothing in ``GlobalState``.

The run loop: run the backend's ``on_start`` (device binding and the
``dist.init_process_group`` moment, SURVEY.md §3.4 step 5), start the user
loop everywhere, poll reports, and restart the whole gang from the last
checkpoint on worker failure (a process group is static — membership change
means rebuild, SURVEY.md §7 hard part 1). A GPU gang that the cluster's
cards cannot hold raises before any worker starts.
"""

from __future__ import annotations

import logging
import time

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.air.execution import (
    ActorManager,
    FixedResourceManager,
    PlacementGroupResourceManager,
    ResourceRequest,
)
from ray_tpu_torch.train._internal.worker_group import TrainWorker, WorkerGroup

logger = logging.getLogger(__name__)


class Backend:
    """Backend plugin protocol (reference: train/_internal/backend.py)."""

    def on_start(self, worker_group: WorkerGroup, scaling_config: ScalingConfig):
        pass

    def on_shutdown(self, worker_group: WorkerGroup):
        pass


class BackendExecutor:
    def __init__(
        self,
        backend: Backend,
        scaling_config: ScalingConfig,
        max_failures: int = 0,
    ):
        self.backend = backend
        self.scaling_config = scaling_config
        self.max_failures = max_failures
        self.worker_group: WorkerGroup | None = None
        # GPU gangs need atomic co-reservation; CPU gangs get budget
        # bookkeeping with raylet enforcement.
        resource_manager = (
            PlacementGroupResourceManager()
            if scaling_config.use_gpu
            else FixedResourceManager()
        )
        self._actor_manager = ActorManager(resource_manager)
        self._tracked: list = []
        self.num_gang_restarts = 0

    def start(self):
        sc = self.scaling_config
        n = sc.num_workers
        if sc.use_gpu:
            _check_gpus(n * sc.gpu_per_worker)
        # One request for the whole gang: N bundles, acquired and released
        # as a unit (refcounted by the manager across the N tracked actors).
        request = ResourceRequest(
            sc.as_placement_group_bundles(), strategy=sc.placement_strategy
        )
        self._tracked = [
            self._actor_manager.add_actor(
                TrainWorker,
                kwargs=dict(rank=rank, world_size=n, use_gpu=sc.use_gpu),
                resource_request=request,
                bundle_index=rank,
                # Whole-gang restart is executor policy (static process group):
                # a lone member restarting in place would rejoin a dead
                # collective, so per-actor auto-restart stays off.
                max_restarts=0,
                graceful_stop_method="shutdown",
            )
            for rank in range(n)
        ]
        try:
            self._actor_manager.wait_for_actors(self._tracked, timeout=300)
        except (TimeoutError, RuntimeError):
            # Guaranteed release on failed start: no PG/bundle survives a
            # gang that never came up.
            self._remove_gang()
            raise
        self.worker_group = WorkerGroup.from_handles(
            [t.actor_handle for t in self._tracked]
        )
        try:
            self.backend.on_start(self.worker_group, sc)
        except BaseException:
            self._remove_gang()  # a gang whose backend never came up holds nothing
            raise

    def _remove_gang(self):
        """Tear the gang down through the manager: cancels in-flight tasks,
        kills the workers, and frees the gang's resource acquisition (the
        placement group) once the last member is removed."""
        for tracked in self._tracked:
            self._actor_manager.remove_actor(tracked)
        self._tracked = []
        self.worker_group = None

    def run(
        self,
        train_fn,
        config: dict | None = None,
        dataset_shards_per_rank: list | None = None,
        on_report=None,
        checkpoint: Checkpoint | None = None,
    ) -> list[dict]:
        """Run the loop on all workers until completion; returns final
        reports per rank. Restarts the gang on failure (whole-group restart
        from the latest checkpoint)."""
        failures_left = self.max_failures
        latest_checkpoint = checkpoint
        while True:
            try:
                return self._run_once(
                    train_fn, config, dataset_shards_per_rank, on_report, latest_checkpoint
                )
            except _WorkerGroupError as e:
                if failures_left == 0:
                    raise TrainingFailedError(str(e)) from None
                failures_left -= 1 if failures_left > 0 else 0
                latest_checkpoint = e.latest_checkpoint or latest_checkpoint
                logger.warning(
                    "worker group failed (%s); restarting from %s",
                    e,
                    "checkpoint" if latest_checkpoint else "scratch",
                )
                # Gang restart as manager operations: remove (frees the old
                # placement group) then start (reserves a fresh one).
                self._remove_gang()
                self.num_gang_restarts += 1
                self.start()

    def _run_once(self, train_fn, config, shards_per_rank, on_report, checkpoint):
        wg = self.worker_group
        final_reports: list[dict] = [{} for _ in wg.workers]
        done = [False] * len(wg.workers)
        latest_checkpoint = None
        refs = []
        for rank, worker in enumerate(wg.workers):
            shards = shards_per_rank[rank] if shards_per_rank else None
            refs.append(
                worker.run_train_fn.remote(train_fn, config or {}, shards, checkpoint)
            )
        try:
            ray_tpu_torch.get(refs, timeout=600)
        except ray_tpu_torch.exceptions.RayTpuError as e:
            raise _WorkerGroupError(str(e), None) from None
        while not all(done):
            time.sleep(0.1)
            polls = []
            try:
                polls = ray_tpu_torch.get(
                    [w.poll.remote() for w in wg.workers], timeout=60
                )
            except ray_tpu_torch.exceptions.RayTpuError as e:
                raise _WorkerGroupError(str(e), latest_checkpoint) from None
            for rank, p in enumerate(polls):
                for metrics, ckpt_blob in p["reports"]:
                    final_reports[rank] = metrics
                    ckpt = Checkpoint.from_bytes(ckpt_blob) if ckpt_blob else None
                    if rank == 0 and ckpt is not None:
                        latest_checkpoint = ckpt
                    if rank == 0 and on_report is not None:
                        on_report(metrics, ckpt)
                if p["error"]:
                    raise _WorkerGroupError(
                        f"rank {rank} failed: {p['error']}", latest_checkpoint
                    )
                done[rank] = p["done"]
        return final_reports

    def shutdown(self):
        self._remove_gang()
        # Belt-and-braces: clear() force-releases anything still acquired,
        # so the executor cannot leak a placement group on any exit path.
        self._actor_manager.clear()


def _check_gpus(needed: int) -> None:
    """Raise, before any worker starts, when the cluster's cards cannot hold
    a GPU gang: a trainer asked for the card never falls back to the CPU."""
    total = sum(
        n.get("resources_total", {}).get("GPU", 0)
        for n in ray_tpu_torch.nodes()
        if n.get("state") == "ALIVE"
    )
    if total < needed:
        raise RuntimeError(
            f"ScalingConfig(use_gpu=True) needs {needed} GPU(s) but the cluster has {total:g}; "
            "start it on a host with a CUDA card (init(num_gpus=...)), or pass "
            "ScalingConfig(use_gpu=False) to train on the CPU"
        )


class TrainingFailedError(RuntimeError):
    """Analog of the reference's TrainingFailedError."""


class _WorkerGroupError(RuntimeError):
    def __init__(self, msg: str, latest_checkpoint=None):
        super().__init__(msg)
        self.latest_checkpoint = latest_checkpoint
