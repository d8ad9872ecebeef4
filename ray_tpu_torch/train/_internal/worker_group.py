"""WorkerGroup — actor fan-out for distributed training.

Analog of the reference's WorkerGroup (python/ray/train/_internal/worker_group.py:100,
execute/execute_async :260/:233): spawns N TrainWorker actors (optionally under
a placement group, so a GPU gang is reserved as a unit), runs functions on all
of them, polls session reports.
"""

from __future__ import annotations

import queue
import threading

import ray_tpu_torch
from ray_tpu_torch.air import session as air_session


@ray_tpu_torch.remote
class TrainWorker:
    """One training worker process (actor). Hosts the user train loop in a
    thread, with an air session bound to it."""

    def __init__(self, rank: int, world_size: int, env: dict | None = None, use_gpu: bool = False):
        import os

        self.rank = rank
        self.world_size = world_size
        for k, v in (env or {}).items():
            os.environ[k] = str(v)
        self._report_q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._error = None
        self._done = False
        self.use_gpu = use_gpu
        self._device = None
        self._mesh = None

    def setup_device(self) -> str:
        """Bind this worker to its device before the loop starts: with a GPU,
        ``cuda:<local rank mod cards>`` becomes the current device; without,
        the CPU. Returns the device's name (the card's, on a GPU)."""
        import torch

        if not self.use_gpu:
            self._device = torch.device("cpu")
            return "cpu"
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"train worker {self.rank} was given a GPU but this process sees no CUDA device"
            )
        index = self.rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        self._device = torch.device("cuda", index)
        return torch.cuda.get_device_name(index)

    def build_mesh(self) -> dict:
        """The gang's mesh, once the process group is up: one ``dp`` axis over
        every rank (the JAX package's ``build_local_mesh`` /
        ``init_collective`` mesh). Returns its axes."""
        from ray_tpu_torch.parallel.mesh import single_axis_mesh

        self._mesh = single_axis_mesh("dp", device_type=self._device.type)
        return self._mesh.axes

    def run_train_fn(self, fn, config, dataset_shards=None, checkpoint=None):
        """Start the user loop in a thread; returns immediately."""
        ctx = air_session.TrainContext(
            world_rank=self.rank,
            world_size=self.world_size,
            local_rank=self.rank,
            config=config or {},
            dataset_shards=dataset_shards or {},
            report_queue=self._report_q,
            checkpoint=checkpoint,
            device=self._device,
            mesh=self._mesh,
        )

        def runner():
            air_session._set_context(ctx)
            try:
                fn(config) if _wants_config(fn) else fn()
            except BaseException as e:  # noqa: BLE001 — surfaced via poll()
                import traceback

                self._error = f"{e!r}\n{traceback.format_exc()}"
            finally:
                self._done = True

        self._done = False
        self._error = None
        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        return True

    def poll(self):
        """Drain queued reports; returns (reports, done, error)."""
        reports = []
        while True:
            try:
                metrics, ckpt = self._report_q.get_nowait()
                blob = ckpt.to_bytes() if ckpt is not None else None
                reports.append((metrics, blob))
            except queue.Empty:
                break
        return {"reports": reports, "done": self._done, "error": self._error}

    def execute(self, fn, *args, **kwargs):
        """Run an arbitrary function in the worker (reference: execute)."""
        return fn(*args, **kwargs)

    def shutdown(self):
        return True


def _wants_config(fn) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


class WorkerGroup:
    def __init__(
        self,
        num_workers: int,
        resources_per_worker: dict | None = None,
        placement_group=None,
        env: dict | None = None,
    ):
        self.num_workers = num_workers
        opts = {}
        self.workers = []
        for rank in range(num_workers):
            actor_cls = TrainWorker
            if resources_per_worker:
                opts["resources"] = dict(resources_per_worker)
            if placement_group is not None:
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy,
                )

                opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                    placement_group, rank
                )
            self.workers.append(actor_cls.options(**opts).remote(rank, num_workers, env))

    @classmethod
    def from_handles(cls, workers: list) -> "WorkerGroup":
        """Wrap pre-created TrainWorker handles (the BackendExecutor creates
        the gang through the AIR execution layer's ActorManager; this class
        stays the fan-out/execute surface the Backend plugins see)."""
        group = cls.__new__(cls)
        group.workers = list(workers)
        group.num_workers = len(group.workers)
        return group

    def execute(self, fn, *args, timeout: float | None = 300, **kwargs):
        """Run fn on every worker; returns per-rank results."""
        refs = [w.execute.remote(fn, *args, **kwargs) for w in self.workers]
        return ray_tpu_torch.get(refs, timeout=timeout)

    def execute_single(self, rank: int, fn, *args, **kwargs):
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs), timeout=300)

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
