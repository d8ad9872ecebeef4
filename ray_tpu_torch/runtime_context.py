"""Runtime context — introspection of the current driver/worker process.

Analog of the reference's ``ray.runtime_context``
(python/ray/runtime_context.py): exposes ids (job/node/task/actor/worker),
namespace, the GCS address, and the resources assigned to the currently
executing task.
"""

from __future__ import annotations

from ray_tpu_torch._private import worker_context


class RuntimeContext:
    """Snapshot-free view onto the process's CoreWorker state."""

    def __init__(self, core_worker):
        self._cw = core_worker

    # ---- ids ----

    def get_job_id(self) -> str:
        # Worker processes carry a placeholder job id; the real submitting
        # job rides on the executing task's spec.
        spec = self._cw.current_task_spec or self._cw._actor_creation_spec
        if spec is not None and spec.job_id:
            return spec.job_id
        return self._cw.job_id.hex()

    def get_node_id(self) -> str:
        return self._cw.node_id

    def get_worker_id(self) -> str:
        return self._cw.worker_id

    def get_task_id(self) -> str | None:
        spec = self._cw.current_task_spec
        return spec.task_id if spec is not None else None

    def get_task_name(self) -> str | None:
        spec = self._cw.current_task_spec
        return spec.name if spec is not None else None

    def get_actor_id(self) -> str | None:
        return self._cw._actor_id

    def get_actor_name(self) -> str | None:
        spec = self._cw._actor_creation_spec
        if spec is None:
            return None
        return spec.actor_name or None

    # ---- environment ----

    @property
    def namespace(self) -> str:
        return self._cw.namespace

    @property
    def gcs_address(self):
        return tuple(self._cw.gcs.address)

    @property
    def worker_mode(self) -> str:
        return self._cw.mode

    def get_assigned_resources(self) -> dict:
        """Resources held by the currently executing task (empty on drivers)."""
        spec = self._cw.current_task_spec
        if spec is None:
            return {}
        return dict(spec.resources or {})

    def get_runtime_env(self) -> dict:
        spec = self._cw.current_task_spec or self._cw._actor_creation_spec
        if spec is None:
            return {}
        return dict(spec.runtime_env or {})

    def get_placement_group_id(self) -> str | None:
        spec = self._cw.current_task_spec
        if spec is None or not spec.placement_group_id:
            return None
        return spec.placement_group_id

    def to_dict(self) -> dict:
        return {
            "job_id": self.get_job_id(),
            "node_id": self.get_node_id(),
            "worker_id": self.get_worker_id(),
            "task_id": self.get_task_id(),
            "actor_id": self.get_actor_id(),
            "namespace": self.namespace,
            "worker_mode": self.worker_mode,
        }


def get_runtime_context() -> RuntimeContext:
    """Return the RuntimeContext of the current process."""
    return RuntimeContext(worker_context.get_core_worker())
