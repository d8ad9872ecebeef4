"""Training session context (analog of python/ray/air/session.py:43 report,
:359 get_dataset_shard and train/_internal/session.py's _TrainSession).

Inside ``train_loop_per_worker`` the functions here expose rank/world info,
deliver per-rank dataset shards, and queue (metrics, checkpoint) reports back
to the driver.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

_thread_local = threading.local()


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    config: dict = field(default_factory=dict)
    dataset_shards: dict = field(default_factory=dict)
    report_queue: Any = None  # queue.Queue of (metrics, Checkpoint|None)
    checkpoint: Any = None  # restored checkpoint, if resuming
    device: Any = None  # torch.device this worker trains on (cuda:<i> or cpu)
    mesh: Any = None  # parallel.mesh.Mesh over the gang (dp = world size)


def _set_context(ctx: TrainContext):
    _thread_local.ctx = ctx


def _get_context() -> TrainContext:
    ctx = getattr(_thread_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("not inside a train session")
    return ctx


def in_session() -> bool:
    return getattr(_thread_local, "ctx", None) is not None


def report(metrics: dict, checkpoint=None) -> None:
    """Queue a result back to the driver (rank 0's checkpoint is persisted)."""
    ctx = _get_context()
    if ctx.report_queue is not None:
        ctx.report_queue.put((dict(metrics), checkpoint))


def get_world_rank() -> int:
    return _get_context().world_rank


def get_world_size() -> int:
    return _get_context().world_size


def get_local_rank() -> int:
    return _get_context().local_rank


def get_config() -> dict:
    return _get_context().config


def get_checkpoint():
    return _get_context().checkpoint


def get_dataset_shard(name: str = "train"):
    return _get_context().dataset_shards.get(name)


def get_device():
    """The ``torch.device`` this worker trains on: ``cuda:<i>``, made current
    by the backend before the loop starts, or ``cpu`` with
    ``ScalingConfig(use_gpu=False)``."""
    return _get_context().device


def get_mesh():
    """The gang's device mesh (``ray_tpu_torch.parallel.mesh.Mesh``): one
    ``dp`` axis over every worker of the process group the backend formed
    (NCCL on GPUs, gloo on CPUs; a group of one for one worker), for
    ``make_train_step(..., mesh=session.get_mesh())``."""
    return _get_context().mesh
