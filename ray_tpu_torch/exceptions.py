"""Public exception types.

Analog of the reference's python/ray/exceptions.py: typed errors surfaced by
``get``/task execution so user code can distinguish application errors from
system failures.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception; re-raised at ray_tpu_torch.get() on the caller.

    Analog of the reference's RayTaskError (python/ray/exceptions.py): wraps
    the remote exception plus its remote traceback.
    """

    def __init__(self, cause: BaseException | None = None, remote_traceback: str = "", task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(str(cause) if cause else remote_traceback)

    @classmethod
    def from_exception(cls, exc: BaseException, task_name: str = "") -> "TaskError":
        return cls(cause=exc, remote_traceback=traceback.format_exc(), task_name=task_name)

    def __str__(self):
        return (
            f"Task {self.task_name or '<unknown>'} failed:\n{self.remote_traceback}"
        )


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead: it crashed, was killed, or exhausted restarts."""

    def __init__(self, msg: str = "The actor died.", actor_id=None):
        super().__init__(msg)
        self.actor_id = actor_id


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ReplicaDrainingError(ActorError):
    """A Serve replica in drain mode (deliberate retirement: downscale or
    rolling update) refused a NEW request. In-flight work still completes
    there; callers should reassign to another replica. The HTTP proxy does
    so transparently (it owns the request until the response lands); a
    DeploymentHandle caller sees this at ``ray_tpu_torch.get()`` — after the
    handle already returned its ref — and resubmits itself (the handle's
    transparent reassign covers only the died-before-accepting race, which
    is detectable at submission time)."""

    def __init__(self, msg: str = "", deployment: str = "", replica_id: str = ""):
        self.deployment = deployment
        self.replica_id = replica_id
        super().__init__(
            msg
            or (
                f"replica {replica_id or '<unknown>'} of deployment "
                f"{deployment or '<unknown>'} is draining and refuses new "
                "requests"
            )
        )


class ObjectLostError(RayTpuError):
    """Object was lost (all copies gone) and could not be reconstructed."""

    def __init__(self, object_id_hex: str = "", msg: str = ""):
        super().__init__(msg or f"Object {object_id_hex} was lost and could not be recovered.")
        self.object_id_hex = object_id_hex


class DeviceObjectLostError(ObjectLostError):
    """A device-resident object (experimental/device_object/) is gone: the
    holder process that kept the tensor on its device is dead or
    unreachable AND no spilled/host copy exists. Names the holder so the
    postmortem starts at the right process."""

    def __init__(self, object_id_hex: str = "", holder: str = "", msg: str = ""):
        self.holder = holder
        super().__init__(
            object_id_hex,
            msg
            or (
                f"device object {object_id_hex[:16]} was lost: holder "
                f"{holder or '<unknown>'} is dead or unreachable and no "
                "spilled/host copy exists"
            ),
        )


class CollectiveError(RayTpuError):
    """A collective-plane operation (util/collective) failed."""


class CollectiveTimeoutError(CollectiveError):
    """A collective op or p2p recv timed out waiting for peers. Names the
    group, the ranks still missing, and (for p2p) the transfer tag, so the
    postmortem starts at the right member. Deliberately NOT a TimeoutError
    subclass: the chaos-matrix contract treats bare timeouts as untyped
    failures, and this class exists to carry the blame."""

    def __init__(self, msg: str = "", *, group: str = "", ranks=None, tag: str = ""):
        self.group = group
        self.ranks = sorted(ranks) if ranks else []
        self.tag = tag
        super().__init__(
            msg
            or (
                f"collective op on group {group or '<unknown>'} timed out "
                f"waiting for ranks {self.ranks}"
                + (f" (tag {tag!r})" if tag else "")
            )
        )


class CollectiveBroadcastError(CollectiveError):
    """A device-object group broadcast could not deliver to every rank.
    Surviving ranks HAVE the payload (their resolves stay local); ``failed``
    maps each undelivered rank to the reason, so callers can name the dead
    member and decide whether to respawn it. Failed ranks were already
    EVICTED from the group roster (epoch bump), so the next broadcast
    addresses survivors only; a respawned replacement re-registers via
    roster_join and is back on the broadcast plane from its first
    post-rejoin sync."""

    def __init__(self, msg: str = "", *, group: str = "", failed: dict | None = None, info: dict | None = None):
        self.group = group
        self.failed = dict(failed or {})
        self.info = dict(info or {})
        super().__init__(
            msg
            or (
                f"group broadcast on {group or '<unknown>'} failed for ranks "
                f"{sorted(self.failed)}: {self.failed}"
            )
        )


class CollectiveReduceError(CollectiveError):
    """A device-object group reduce/allreduce could not complete on every
    holder. Unlike a failed broadcast (survivors keep their payload), a
    PARTIAL reduce is poison — some holders may already hold the combined
    value while others kept their contribution — so ``failed`` names every
    holder that did not finish and the caller must treat the gang as
    divergent (re-run or rebuild)."""

    def __init__(self, msg: str = "", *, group: str = "", failed: dict | None = None, info: dict | None = None):
        self.group = group
        self.failed = dict(failed or {})
        self.info = dict(info or {})
        super().__init__(
            msg
            or (
                f"group reduce on {group or '<unknown>'} failed for holders "
                f"{sorted(self.failed)}: {self.failed}"
            )
        )


class OwnerDiedError(ObjectLostError):
    """The object's owner process died; the object's lineage is gone."""


class OutOfMemoryError(RayTpuError):
    """A task's worker was killed by the node memory monitor (reference:
    ray.exceptions.OutOfMemoryError + worker_killing_policy)."""


class ObjectStoreFullError(RayTpuError):
    """The node's shared-memory arena is full even after spilling/eviction."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get() timed out."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the task/actor runtime environment failed."""


class NodeDiedError(RayTpuError):
    """The node hosting the computation died."""


class PlacementGroupUnavailableError(RayTpuError):
    """Placement group cannot be scheduled (infeasible or removed)."""
