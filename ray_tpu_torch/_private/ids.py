"""Binary IDs.

Analog of the reference's typed ID system
(src/ray/common/id.h, spec in src/ray/design_docs/id_specification.md):
JobID(4B) < ActorID(16B) = JobID + unique; TaskID(24B) = ActorID + unique;
ObjectID(28B) = TaskID + 4B index. IDs embed their lineage so ownership and
the producing task are recoverable from the object id alone.
"""

from __future__ import annotations

import os
import struct
import threading

JOB_ID_SIZE = 4
UNIQUE_ID_SIZE = 12
ACTOR_ID_SIZE = JOB_ID_SIZE + UNIQUE_ID_SIZE  # 16
TASK_ID_SIZE = ACTOR_ID_SIZE + 8  # 24
OBJECT_ID_SIZE = TASK_ID_SIZE + 4  # 28
NODE_ID_SIZE = 16
WORKER_ID_SIZE = 16
PLACEMENT_GROUP_ID_SIZE = 16


class BaseID:
    SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"


class JobID(BaseID):
    SIZE = JOB_ID_SIZE
    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class NodeID(BaseID):
    SIZE = NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = PLACEMENT_GROUP_ID_SIZE


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(UNIQUE_ID_SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(8))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(ActorID(job_id.binary() + b"\x00" * UNIQUE_ID_SIZE).binary() + b"\x00" * 8)

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[:ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[:JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID) -> "ObjectID":
        # Puts get a random index with the high bit set to avoid colliding
        # with return-value indices.
        idx = int.from_bytes(os.urandom(4), "big") | 0x8000_0000
        return cls(task_id.binary() + struct.pack(">I", idx))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    def return_index(self) -> int:
        return struct.unpack(">I", self._bytes[TASK_ID_SIZE:])[0]


class BoundedIdSet:
    """Insertion-ordered bounded set of id strings (cancel tombstones —
    reference: CoreWorker's cancelled-task bookkeeping in CancelTask).
    O(1) membership; evicts oldest-first past ``cap``. The trim walks an
    unbounded order deque on purpose: a maxlen deque would silently drop
    the true oldest id on append (stranding it in the set forever) while
    a manual pop then discarded a newer, still-needed entry."""

    def __init__(self, cap: int = 4096):
        import collections

        self._cap = cap
        self._set: set = set()
        self._order = collections.deque()

    def add(self, item) -> None:
        if item in self._set:
            return
        self._set.add(item)
        self._order.append(item)
        while len(self._order) > self._cap:
            self._set.discard(self._order.popleft())

    def discard(self, item) -> None:
        self._set.discard(item)

    def __contains__(self, item) -> bool:
        return item in self._set

    def __len__(self) -> int:
        return len(self._set)
