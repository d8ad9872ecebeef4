"""Per-node shared-memory object store.

Analog of the reference's Plasma store + object lifecycle manager
(src/ray/object_manager/plasma/store.h:55, eviction_policy.h, and spilling in
src/ray/raylet/local_object_manager.h:110):

- ``StoreCore`` runs inside the raylet (the store daemon): owns allocation
  metadata, seal states, per-object reference counts, LRU eviction and
  disk spilling. All methods are asyncio-native (called from raylet handlers).
- ``StoreClient`` lives in every worker/driver process on the node: it attaches
  the node's shm arena directly (zero-copy data plane) and performs metadata
  operations over the raylet's RPC server (control plane).

Unlike plasma there is no fd-passing: the arena segment has a per-node name.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
import weakref
from dataclasses import dataclass, field

from ray_tpu_torch._private import flight_recorder

logger = logging.getLogger(__name__)


@dataclass
class ObjectEntry:
    object_id: str  # hex
    offset: int | None
    size: int
    sealed: bool = False
    ref_count: int = 0  # client pins (get without release)
    last_access: float = 0.0
    spilled_path: str | None = None
    sealed_event: asyncio.Event = field(default_factory=asyncio.Event)
    created_ts: float = field(default_factory=time.monotonic)


class StoreCore:
    """Daemon-side store state. Single-threaded (asyncio) access."""

    def __init__(self, arena, spill_dir: str, index=None):
        from ray_tpu_torch._private.store.external_storage import create_external_storage

        self.arena = arena
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        # Pluggable spill target (reference: external_storage.py) — local
        # filesystem by default, remote URI or custom backend via
        # RAY_TPU_TORCH_OBJECT_SPILLING_CONFIG.
        self.external_storage = create_external_storage(spill_dir)
        self.objects: dict[str, ObjectEntry] = {}
        # Compiled-graph channel rings (experimental/channel/): arena blocks
        # allocated outside the object lifecycle — no seal/evict/spill; held
        # until the owning CompiledDAG's teardown frees them.
        self.channels: dict[str, tuple[int, int]] = {}  # channel_id -> (offset, size)
        # Native shm index: clients resolve local sealed objects without RPC.
        self.index = index
        # Arena blocks whose index slot still has client pins: freed once the
        # readers drain (list of (object_id, offset)).
        self._deferred_frees: list[tuple[str, int]] = []
        from ray_tpu_torch._private import self_metrics

        self._metrics = self_metrics.instruments()

    def _index_remove_then_free(self, object_id: str, offset: int | None):
        """Tombstone the index entry; free the arena block now if no client
        pins it, else defer (drained opportunistically on later calls)."""
        busy = False
        if self.index is not None:
            busy = self.index.remove(object_id) == 1
        if offset is None:
            return
        if busy:
            self._deferred_frees.append((object_id, offset))
        else:
            self.arena.free(offset)

    def drain_deferred_frees(self):
        if not self._deferred_frees or self.index is None:
            return
        still = []
        for object_id, offset in self._deferred_frees:
            if self.index.readers(object_id) == 0:
                self.arena.free(offset)
            else:
                still.append((object_id, offset))
        self._deferred_frees = still

    # ---- creation / sealing ----

    async def create(self, object_id: str, size: int) -> int | None:
        """Allocate space; returns arena offset, or None if the object is
        already sealed here (idempotent create — lineage reconstruction may
        re-execute a task whose output still exists). Evicts/spills if needed.
        """
        if object_id in self.objects:
            entry = self.objects[object_id]
            if entry.sealed:
                return None
            return entry.offset
        self.drain_deferred_frees()
        offset = self.arena.alloc(size)
        if offset is None:
            await self._make_space(size)
            # A concurrent creator (pull racing push is routine) may have
            # inserted the entry during the await — clobbering it would leak
            # its arena block and let OUR empty allocation be sealed by THEIR
            # writer. Defer to the winner: None tells the caller to re-check
            # (sealed -> use it; unsealed -> someone else is filling it).
            if object_id in self.objects:
                return None
            offset = self.arena.alloc(size)
            if offset is None:
                from ray_tpu_torch.exceptions import ObjectStoreFullError

                raise ObjectStoreFullError(
                    f"cannot allocate {size} bytes "
                    f"(used={self.arena.used()}, capacity={self.arena.capacity})"
                )
        self.objects[object_id] = ObjectEntry(
            object_id=object_id, offset=offset, size=size, last_access=time.monotonic()
        )
        if self.index is not None:
            self.index.put(object_id, offset, size)
        return offset

    def seal(self, object_id: str):
        entry = self.objects[object_id]
        entry.sealed = True
        entry.sealed_event.set()
        if self.index is not None:
            self.index.seal(object_id)
        flight_recorder.record("store_seal", f"{object_id[:12]}:{entry.size}")
        try:
            self._metrics["store_seals"].inc()
        except Exception:
            pass

    def abort(self, object_id: str):
        entry = self.objects.pop(object_id, None)
        if entry is not None:
            self._index_remove_then_free(object_id, entry.offset)
            # Wake any get() blocked on the seal; they re-check the table and
            # fail fast instead of waiting out their (possibly infinite)
            # timeout on an entry that will never seal.
            entry.sealed_event.set()

    # ---- channel rings (compiled graphs; experimental/channel/) ----

    async def channel_create(self, channel_id: str, size: int) -> int:
        """Allocate a channel ring from the arena (idempotent per id).
        Channel blocks are never evicted or spilled — they are live SPSC
        rings, not objects — but allocating one may evict/spill objects."""
        existing = self.channels.get(channel_id)
        if existing is not None:
            return existing[0]
        self.drain_deferred_frees()
        offset = self.arena.alloc(size)
        if offset is None:
            await self._make_space(size)
            offset = self.arena.alloc(size)
            if offset is None:
                from ray_tpu_torch.exceptions import ObjectStoreFullError

                raise ObjectStoreFullError(
                    f"cannot allocate {size}-byte channel ring "
                    f"(used={self.arena.used()}, capacity={self.arena.capacity})"
                )
        # Zero the ring header: stale arena bytes must not read as counts.
        self.arena.write(offset, b"\x00" * min(size, 64))
        self.channels[channel_id] = (offset, size)
        return offset

    def channel_free(self, channel_id: str) -> bool:
        """Release a channel ring back to the arena (idempotent)."""
        entry = self.channels.pop(channel_id, None)
        if entry is None:
            return False
        self.arena.free(entry[0])
        return True

    # ---- access ----

    def contains(self, object_id: str) -> bool:
        e = self.objects.get(object_id)
        return e is not None and e.sealed

    async def get(self, object_id: str, timeout: float | None = None) -> tuple[int, int]:
        """Block until sealed; returns (offset, size) and pins the object."""
        entry = self.objects.get(object_id)
        if entry is None:
            raise KeyError(object_id)
        if not entry.sealed:
            await asyncio.wait_for(entry.sealed_event.wait(), timeout)
            if self.objects.get(object_id) is not entry or not entry.sealed:
                # Aborted while we waited (failed push/pull session).
                raise KeyError(object_id)
        if entry.offset is None:
            await self._restore(entry)
        entry.ref_count += 1
        entry.last_access = time.monotonic()
        return entry.offset, entry.size

    def release(self, object_id: str):
        entry = self.objects.get(object_id)
        if entry is not None and entry.ref_count > 0:
            entry.ref_count -= 1

    def delete(self, object_id: str):
        entry = self.objects.pop(object_id, None)
        if entry is None:
            return
        self._index_remove_then_free(object_id, entry.offset)
        if entry.spilled_path:
            # Off the daemon loop: a network backend's delete round trip
            # must not stall concurrent store RPCs (put/get use executors
            # in _spill/_restore for the same reason).
            path = entry.spilled_path

            def _ext_delete():
                try:
                    self.external_storage.delete(path)
                except Exception:
                    pass

            try:
                asyncio.get_running_loop().run_in_executor(None, _ext_delete)
            except RuntimeError:
                _ext_delete()  # no loop (unit tests call delete directly)

    def object_ids(self) -> list[str]:
        return [oid for oid, e in self.objects.items() if e.sealed]

    def reap_orphaned_unsealed(self, max_age_s: float = 60.0, exclude=()) -> int:
        """Abort unsealed entries nobody is filling anymore: a producer
        SIGKILLed between create and seal (memory-monitor kills do exactly
        this) leaves an entry that would otherwise block any re-producer's
        put_serialized forever. Active transfer sessions (caller passes
        their ids in `exclude`) are exempt — big chunked pulls can
        legitimately run long."""
        now = time.monotonic()
        reaped = 0
        for oid, entry in list(self.objects.items()):
            if (
                not entry.sealed
                and oid not in exclude
                and now - entry.created_ts > max_age_s
            ):
                logger.warning("aborting orphaned unsealed object %s", oid[:12])
                self.abort(oid)
                reaped += 1
        return reaped

    def usage(self) -> dict:
        """Summary only — shipped in every raylet heartbeat, so it must stay
        O(1); per-object metadata goes through objects_info(). Blocks whose
        last reader has let go are freed first (a short list), so "used"
        falls within a heartbeat of the last pinned view's collection."""
        self.drain_deferred_frees()
        return {
            "capacity": self.arena.capacity,
            "used": self.arena.used(),
            "num_objects": len(self.objects),
            "num_spilled": sum(1 for e in self.objects.values() if e.spilled_path),
            "num_channels": len(self.channels),
        }

    def objects_info(self) -> dict:
        """Per-object metadata for the state API (list_objects)."""
        return {
            oid: {
                "size": e.size,
                "sealed": e.sealed,
                "ref_count": e.ref_count,
                "spilled": bool(e.spilled_path),
            }
            for oid, e in self.objects.items()
        }

    # ---- eviction / spilling (reference: LocalObjectManager::SpillObjects) ----

    async def _make_space(self, needed: int):
        """Spill-then-evict LRU sealed, unpinned objects until `needed` fits."""
        candidates = sorted(
            (
                e
                for e in self.objects.values()
                if e.sealed and e.ref_count == 0 and e.offset is not None
            ),
            key=lambda e: e.last_access,
        )
        for entry in candidates:
            if self.arena.largest_free() >= needed:
                return
            if self.index is not None and self.index.readers(entry.object_id) > 0:
                continue  # a client is reading it via the index right now
            await self._spill(entry)
            self._index_remove_then_free(entry.object_id, entry.offset)
            entry.offset = None
            flight_recorder.record("store_evict", f"{entry.object_id[:12]}:{entry.size}")
            try:
                self._metrics["store_evictions"].inc()
            except Exception:
                pass

    async def _spill(self, entry: ObjectEntry):
        if entry.spilled_path:
            return
        data = bytes(self.arena.read(entry.offset, entry.size))
        loop = asyncio.get_event_loop()
        entry.spilled_path = await loop.run_in_executor(
            None, self.external_storage.put, entry.object_id, data
        )
        flight_recorder.record("store_spill", f"{entry.object_id[:12]}:{entry.size}")
        try:
            self._metrics["store_spills"].inc()
            self._metrics["store_spilled_bytes"].inc(entry.size)
        except Exception:
            pass
        logger.debug("spilled %s (%d bytes)", entry.object_id, entry.size)

    async def _restore(self, entry: ObjectEntry):
        if entry.spilled_path is None:
            raise KeyError(entry.object_id)
        loop = asyncio.get_event_loop()
        data = await loop.run_in_executor(
            None, self.external_storage.get, entry.spilled_path
        )
        offset = self.arena.alloc(entry.size)
        if offset is None:
            await self._make_space(entry.size)
            offset = self.arena.alloc(entry.size)
            if offset is None:
                from ray_tpu_torch.exceptions import ObjectStoreFullError

                raise ObjectStoreFullError("cannot restore spilled object")
        self.arena.write(offset, data)
        entry.offset = offset
        flight_recorder.record("store_restore", entry.object_id[:12])
        if self.index is not None:
            self.index.put(entry.object_id, offset, entry.size)
            self.index.seal(entry.object_id)

    def close(self):
        if self.index is not None:
            self.index.close(unlink=True)
        self.arena.close(unlink=True)


class StoreClient:
    """Client-side view: direct arena mapping + RPC metadata ops to raylet.

    Local sealed objects resolve through the native shm index (two atomic
    loads + a pin) with no RPC; everything else — unsealed waits, remote
    pulls, spilled restores — falls back to the raylet RPC path."""

    def __init__(self, arena_name: str, raylet_client):
        import threading as _threading

        from ray_tpu_torch._private.store.arena import attach_arena
        from ray_tpu_torch._private.store.index import attach_index

        self.arena = attach_arena(arena_name)
        self.index = attach_index(arena_name + "_idx")
        self.raylet = raylet_client
        # object_id -> stack of pins: ("idx", version) | ("rpc", None)
        self._pins: dict[str, list] = {}
        self._pins_lock = _threading.Lock()

    def put_serialized(self, object_id_hex: str, serialized) -> None:
        """create -> write payload zero-copy into arena -> seal."""
        size = serialized.total_size
        for _ in range(20):  # bounded: the raylet reaps orphaned unsealed
            # entries within ~60s, so a handful of wait+retry rounds always
            # terminates; 20 rounds of 60s wait_seal is pathological.
            resp = self.raylet.call(
                "store_create", {"object_id": object_id_hex, "size": size}
            )
            if resp.get("exists"):
                if resp.get("sealed", True):
                    return  # already sealed here (idempotent reconstruction)
                # An in-flight pull/push session owns the buffer. Wait for it
                # to seal (object materialized -> done) or abort (retry our
                # own create so the result cannot be silently dropped).
                wait = self.raylet.call(
                    "store_wait_seal", {"object_id": object_id_hex}, timeout=60
                )
                if wait.get("sealed"):
                    return
                continue
            break
        else:
            raise RuntimeError(
                f"object {object_id_hex[:12]} stuck unsealed: a rival "
                "session never sealed or aborted within the retry budget"
            )
        offset = resp["offset"]
        try:
            serialized.write_to(self.arena.read(offset, size))
        except BaseException:
            self.raylet.call("store_abort", {"object_id": object_id_hex})
            raise
        self.raylet.call("store_seal", {"object_id": object_id_hex})

    def get_view(self, object_id_hex: str, timeout: float | None = None) -> memoryview:
        """Blocks until sealed locally; returns a zero-copy READ-ONLY view
        (pinned). Read-only is load-bearing: the view aliases the node's
        shared arena, and numpy arrays deserialized zero-copy from it would
        otherwise be writable in place — one caller's mutation would corrupt
        the sealed object for every other reader on the node."""
        view, pin = self._pin(object_id_hex, timeout)
        with self._pins_lock:
            self._pins.setdefault(object_id_hex, []).append(pin)
        return view

    def _pin(self, object_id_hex: str, timeout: float | None) -> tuple[memoryview, tuple]:
        """(read-only view, pin): ("idx", token) through the shm index, or
        ("rpc", None) through the daemon."""
        if self.index is not None:
            hit = self.index.get_pinned(object_id_hex)
            if hit is not None:
                offset, size, token = hit
                return self.arena.read(offset, size).toreadonly(), ("idx", token)
        resp = self.raylet.call(
            "store_get", {"object_id": object_id_hex, "timeout": timeout}, timeout=timeout
        )
        return self.arena.read(resp["offset"], resp["size"]).toreadonly(), ("rpc", None)

    def get_pinned(self, object_id_hex: str, timeout: float | None = None) -> "PinnedView":
        """``get_view`` whose pin lasts as long as the returned view (see
        ``PinnedView``). The pin is registered with the daemon as this
        process's hold, and the daemon releases it: when the view is
        collected, or when this process dies holding it."""
        view, (kind, token) = self._pin(object_id_hex, timeout)
        hold = {"hold": os.urandom(8).hex(), "pid": os.getpid(), "object_id": object_id_hex, "kind": kind,
                "slot": token[0] if token else 0, "version": token[1] if token else 0}
        self._spawn_push("store_hold", hold)
        return PinnedView(self, hold, view)

    def _spawn_push(self, method: str, payload: dict) -> None:
        """Fire and forget, from any thread, the loop's own included."""
        try:
            self.raylet._io.spawn(self.raylet.apush(method, payload))
        except RuntimeError:  # the IO loop is gone: the process is shutting down
            pass

    def contains(self, object_id_hex: str) -> bool:
        if self.index is not None:
            hit = self.index.get_pinned(object_id_hex)
            if hit is not None:
                # Probe only: release the pin we just took.
                self.index.release(hit[2])
                return True
            # Miss is authoritative only for sealed-local; spilled objects
            # have no index entry but still "exist" — ask the daemon.
        return self.raylet.call("store_contains", {"object_id": object_id_hex})["found"]

    def release(self, object_id_hex: str):
        with self._pins_lock:
            stack = self._pins.get(object_id_hex)
            pin = stack.pop() if stack else None
            if stack is not None and not stack:
                self._pins.pop(object_id_hex, None)
        if pin is not None and pin[0] == "idx":
            if self.index is not None:
                self.index.release(pin[1])
            return
        try:
            self.raylet.push("store_release", {"object_id": object_id_hex})
        except Exception:
            pass

    def close(self):
        if self.index is not None:
            self.index.close(unlink=False)
        self.arena.close(unlink=False)


class PinnedView:
    """A pinned, read-only view of a sealed object that exports its bytes
    (the buffer protocol, PEP 688) and releases its pin when it is garbage:
    each buffer taken from it, and so each array deserialized zero-copy from
    it, keeps it alive. The store frees no arena block a reader pins, so such
    an array stays valid after the object's last reference is dropped (the
    JAX package releases the pin at once, and a later object can overwrite
    the array: ROADMAP C11)."""

    __slots__ = ("_view", "__weakref__")

    def __init__(self, store: StoreClient, hold: dict, view: memoryview):
        self._view = view
        weakref.finalize(self, store._spawn_push, "store_unhold", {"hold": hold["hold"], "pid": hold["pid"]})

    def __buffer__(self, flags: int) -> memoryview:
        return self._view.__buffer__(flags)
