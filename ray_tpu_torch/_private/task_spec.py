"""Task specification.

Analog of the reference's TaskSpecification
(src/ray/common/task/task_spec.h:186, built via TaskSpecBuilder
task_util.h:102): a msgpack-able description of one task/actor-creation/
actor-method invocation, carrying everything a remote worker needs to execute
it — function (by GCS function-table key), serialized/reference args, return
count, resource demand, retry policy, scheduling strategy, and owner address
for result routing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

NORMAL_TASK = 0
ACTOR_CREATION_TASK = 1
ACTOR_TASK = 2


@dataclass
class TaskSpec:
    task_id: str  # hex
    job_id: str
    name: str
    task_type: int = NORMAL_TASK
    # Function table key in the GCS KV (see function_manager.py); workers
    # fetch-and-cache by this key (reference: _private/function_manager.py).
    function_key: str = ""
    # Each arg is ("v", <serialized bytes>) inline or ("r", <oid hex>, <owner addr>).
    args: list = field(default_factory=list)
    num_returns: int = 1
    resources: dict = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Owner (submitting process) core-worker RPC address, [host, port].
    owner_addr: list | None = None
    owner_worker_id: str = ""
    # Actor fields.
    actor_id: str = ""
    method_name: str = ""
    seq_no: int = -1  # per-caller ordering for actor tasks
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    actor_name: str = ""  # named actor registration
    namespace: str = ""
    get_if_exists: bool = False
    # Device object plane (experimental/device_object/): non-empty on an
    # actor-creation spec makes every top-level tensor the actor returns
    # stay device-resident (the actor is the holder; callers get a
    # descriptor that resolves out of band).
    tensor_transport: str = ""
    # Scheduling.
    placement_group_id: str = ""
    placement_group_bundle_index: int = -1
    scheduling_strategy: str = "DEFAULT"  # DEFAULT | SPREAD | node:<id> | node:<id>:soft
    # Tracing span context propagated across process boundaries (reference:
    # util/tracing/tracing_helper.py — span context rides task metadata).
    trace_ctx: dict = field(default_factory=dict)
    runtime_env: dict = field(default_factory=dict)
    # Execution language (reference: TaskSpecification language field,
    # src/ray/common/task/task_spec.h — drives worker-pool selection).
    # "py" workers run pickled functions; "cpp" specs carry a
    # self-describing "cpp!<library>!<symbol>" function key and route to
    # the native worker runtime (cpp/ray_tpu_worker.cc).
    language: str = "py"
    # Non-empty marks this spec as a WORKER-LEASE REQUEST (reference:
    # direct_task_transport.cc lease requests ride the task scheduler): it
    # flows through the raylet queue like a task, but dispatch grants the
    # worker to the owner instead of pushing a task onto it.
    lease_id: str = ""

    def to_wire(self) -> dict:
        """Delta-encoded against field defaults: a typical no-frills task
        ships ~8 keys instead of 26, which matters at 1k+ tasks/s — wire
        size and msgpack time are on the submit hot path (the reference gets
        the same effect from protobuf default-field elision)."""
        return {
            k: v for k, v in self.__dict__.items() if _WIRE_DEFAULTS.get(k, _MISSING) != v
        }

    @classmethod
    def from_wire(cls, d: dict) -> "TaskSpec":
        return cls(**d)

    def return_object_ids(self) -> list[str]:
        from ray_tpu_torch._private.ids import ObjectID, TaskID

        if not isinstance(self.num_returns, int):
            return []  # streaming: return ids are dynamic (yielded one by one)
        tid = TaskID.from_hex(self.task_id)
        return [ObjectID.for_return(tid, i).hex() for i in range(self.num_returns)]

    def is_streaming(self) -> bool:
        return self.num_returns == "streaming"

    def is_actor_task(self) -> bool:
        return self.task_type == ACTOR_TASK

    def is_actor_creation(self) -> bool:
        return self.task_type == ACTOR_CREATION_TASK


import dataclasses as _dataclasses

_MISSING = object()
_WIRE_DEFAULTS = {}
for _f in _dataclasses.fields(TaskSpec):
    if _f.default is not _dataclasses.MISSING:
        _WIRE_DEFAULTS[_f.name] = _f.default
    elif _f.default_factory is not _dataclasses.MISSING:  # type: ignore[misc]
        _WIRE_DEFAULTS[_f.name] = _f.default_factory()  # type: ignore[misc]
