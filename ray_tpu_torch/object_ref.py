"""ObjectRef — a future for a value in the distributed object store.

Analog of the reference's ObjectRef (python/ray/_raylet.pyx:208): carries the
28-byte object id plus the owner's core-worker RPC address so any borrower can
reach the owner for inline values and ref-count bookkeeping
(src/ray/core_worker/reference_count.h:61).
"""

from __future__ import annotations

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner_addr", "_registered")

    def __init__(self, object_id: ObjectID, owner_addr: tuple | None = None, *, _register: bool = True):
        self.id = object_id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        self._registered = False
        if _register:
            from ray_tpu_torch._private import worker_context

            cw = worker_context.get_core_worker_if_initialized()
            if cw is not None:
                cw.register_ref(self)
                self._registered = True

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def __reduce__(self):
        from ray_tpu_torch._private.serialization import record_contained_ref

        record_contained_ref(self)
        return (_deserialize_ref, (self.id.binary(), self.owner_addr))

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    def __del__(self):
        if self._registered:
            try:
                from ray_tpu_torch._private import worker_context

                cw = worker_context.get_core_worker_if_initialized()
                if cw is not None:
                    cw.deregister_ref(self)
            except Exception:
                pass

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch._private import worker_context

        return worker_context.get_core_worker().as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _deserialize_ref(binary: bytes, owner_addr):
    return ObjectRef(ObjectID(binary), owner_addr)


class ObjectRefGenerator:
    """Iterator over a streaming task's dynamically-yielded returns
    (reference: StreamingObjectRefGenerator, _raylet.pyx:227). Yields
    ObjectRefs AS the running task produces them — iteration overlaps with
    the producer; ray_tpu_torch.get each ref (or next_ready()) for the values."""

    def __init__(self, core_worker, task_id: str):
        self._cw = core_worker
        self._task_id = task_id
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self):
        oid_hex = self._cw.stream_next(self._task_id, self._index)
        self._index += 1
        return ObjectRef(ObjectID.from_hex(oid_hex), self._cw.address)

    def next_with_timeout(self, timeout: float):
        """Like next() but raises GetTimeoutError instead of blocking
        indefinitely when the producer stalls."""
        oid_hex = self._cw.stream_next(self._task_id, self._index, timeout=timeout)
        self._index += 1
        return ObjectRef(ObjectID.from_hex(oid_hex), self._cw.address)

    @property
    def task_id(self) -> str:
        return self._task_id
