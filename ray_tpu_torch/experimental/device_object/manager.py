"""DeviceObjectManager — per-process registry of device-resident payloads.

From ``ray_tpu/experimental/device_object/manager.py``, holding torch
tensors (on a card or on the CPU) where the JAX package holds jax.Arrays.

One per core worker (lazily, first device put/return creates it). The
manager holds the live tensor for every device object this process
is the HOLDER of, plus the spill state: under memory pressure
(``devobj_resident_limit_bytes``) the least-recently-used arrays are
serialized device→host into the node's shm arena (under the SAME object id,
so every existing host-path consumer — local deserialize, cross-node pull,
holder-death fallback — finds the copy with zero new plumbing) and restored
onto their devices on the next local resolve.

Observability: every transition records a typed flight-recorder event
(``devobj_create/transfer/spill/restore/free``) and bumps the plain-int
``DEVOBJ_STATS`` counters folded into ``ray_tpu_devobj_*`` metrics by
``device_object_stats()`` reads (no instrument lock on the create path).
A best-effort GCS KV row (``devobj/<oid>``) backs a cluster state view.

Streams: every tensor here is made and read on its device's current stream,
which a thread that never set one shares with the process's other threads
(the legacy default stream), so a live tensor handed to a consumer in the
same process needs no event. A tensor serialized for a consumer elsewhere
goes to the host with a blocking copy, complete before its bytes are read.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private.concurrency import any_thread, blocking

logger = logging.getLogger(__name__)


class _DevObjStats:
    """Plain-int hot-path counters (self_metrics folds them at flush).
    ``chan_sends``/``chan_recvs`` count descriptor-channel payloads
    eager-pushed to / taken from the p2p direct mailbox — the steady-state
    microbatch path, distinct from the pull-driven transfer kinds above."""

    __slots__ = (
        "creates",
        "frees",
        "spills",
        "restores",
        "transfers_local",
        "transfers_collective",
        "transfers_host",
        "chan_sends",
        "chan_recvs",
    )

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)


DEVOBJ_STATS = _DevObjStats()

# The process's manager, for the metrics collector and device_object_stats();
# written once under _active_lock when the first device object is created.
_active_manager = None
_active_lock = threading.Lock()


def active_manager():
    return _active_manager


def device_object_stats() -> dict:
    """Snapshot of this process's device-object plane (tests, actor-side
    introspection, the CLI state view's per-holder detail)."""
    mgr = _active_manager
    counters = {name: getattr(DEVOBJ_STATS, name) for name in _DevObjStats.__slots__}
    if mgr is None:
        return {"resident_count": 0, "resident_bytes": 0, "spilled_count": 0, **counters}
    return {**mgr.usage(), **counters}


def refuse_sharded(t) -> None:
    """A DTensor cannot be kept device-resident: this process holds only its
    own shards (the JAX package refuses a multi-host jax.Array the same way)."""
    if type(t).__name__ == "DTensor":
        raise TypeError(
            "cannot keep a sharded DTensor device-resident: this process holds only its own "
            "shards (ROADMAP A9f); put dtensor.to_local() per rank, or full_tensor(), instead"
        )


def dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def tensor_nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


@dataclass
class DeviceObjectEntry:
    meta: object  # DeviceObjectMeta
    array: object | None  # live tensor; None once spilled
    in_store: bool = False  # host copy sealed into the shm arena (same oid)
    last_access: float = 0.0
    # Channel-payload bookkeeping: pins = consumers that have not
    # yet released this payload; scope = the resident loop / compiled DAG
    # that created it, so teardown can reclaim whatever releases never
    # arrived. scope == "" marks an ordinary ObjectRef-owned device object.
    pins: int = 0
    scope: str = ""


class DeviceObjectManager:
    def __init__(self, core_worker):
        global _active_manager
        self.cw = core_worker
        self._lock = threading.Lock()
        self._entries: dict[str, DeviceObjectEntry] = {}
        with _active_lock:
            _active_manager = self

    # ---- creation (holder side: put / actor-task return packaging) ----

    @blocking
    def create_resident(self, oid_hex: str, arr, transport: str, holder_id: str, holder_kind: str):
        """Register ``arr`` as device-resident under ``oid_hex``; returns the
        DeviceObjectMeta to seal into the normal store."""
        from ray_tpu_torch.experimental.device_object.descriptor import DeviceObjectMeta
        from ray_tpu_torch.util.collective import local_group_hints

        refuse_sharded(arr)
        try:
            hints = local_group_hints()
        except Exception:
            hints = []
        meta = DeviceObjectMeta(
            object_id=oid_hex,
            shape=tuple(arr.shape),
            dtype=dtype_name(arr),
            nbytes=tensor_nbytes(arr),
            transport=transport,
            holder_addr=tuple(self.cw.address),
            holder_id=holder_id,
            holder_kind=holder_kind,
            sharding=str(arr.device),
            group_hints=hints,
        )
        with self._lock:
            self._entries[oid_hex] = DeviceObjectEntry(
                meta=meta, array=arr, last_access=time.monotonic()
            )
        DEVOBJ_STATS.creates += 1
        flight_recorder.record("devobj_create", f"{oid_hex[:12]}:{meta.nbytes}")
        self._registry_put(meta)
        limit = getattr(self.cw.cfg, "devobj_resident_limit_bytes", 0)
        if limit > 0:
            self._spill_for_pressure(limit, protect=oid_hex)
        return meta

    @blocking
    def create_channel_payload(self, arr, pins: int, scope: str):
        """Register a TRANSIENT channel payload (descriptor channel plane,
        experimental/channel/device_envelope.py): this process holds the
        live array while its DeviceObjectMeta rides a channel slot to
        ``pins`` consumers. Unlike create_resident there is no ObjectRef
        and no owner — consumers release their pin after resolving (the
        last release frees), and ``reclaim_scope`` frees whatever is left
        when the creating loop/DAG tears down. Skips the GCS state-registry
        row (one KV write per microbatch per edge would be pure churn for
        an object that lives milliseconds) and is exempt from spill
        pressure (spilling would seal a host copy — exactly the copy the
        descriptor plane exists to avoid)."""
        import os

        from ray_tpu_torch.experimental.device_object.descriptor import DeviceObjectMeta
        from ray_tpu_torch.util.collective import local_group_hints

        try:
            hints = local_group_hints()
        except Exception:
            hints = []
        oid_hex = os.urandom(14).hex()
        holder_id, holder_kind = self.cw._holder_identity()
        meta = DeviceObjectMeta(
            object_id=oid_hex,
            shape=tuple(arr.shape),
            dtype=dtype_name(arr),
            nbytes=tensor_nbytes(arr),
            transport="collective",
            holder_addr=tuple(self.cw.address),
            holder_id=holder_id,
            holder_kind=holder_kind,
            sharding=str(arr.device),
            group_hints=hints,
        )
        with self._lock:
            self._entries[oid_hex] = DeviceObjectEntry(
                meta=meta,
                array=arr,
                last_access=time.monotonic(),
                pins=max(1, int(pins)),
                scope=scope,
            )
        DEVOBJ_STATS.creates += 1
        flight_recorder.record("devobj_create", f"{oid_hex[:12]}:{meta.nbytes}:chan")
        return meta

    @any_thread
    def release_pin(self, oid_hex: str) -> None:
        """One consumer of a channel payload is done with it; the last pin
        release frees the entry (and with it the holder's reference to the
        device buffers)."""
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None:
                return
            entry.pins -= 1
            if entry.pins > 0:
                return
        self.free(oid_hex)

    @any_thread
    def reclaim_scope(self, scope: str) -> int:
        """Free every channel payload created under ``scope`` (a resident
        loop or compiled DAG tearing down): releases that were lost to a
        dead consumer or a torn connection must not leak device buffers."""
        if not scope:
            return 0
        with self._lock:
            victims = [o for o, e in self._entries.items() if e.scope == scope]
        for oid in victims:
            self.free(oid)
        return len(victims)

    # ---- resolution (consumer side, via resolve.py) ----

    def entry(self, oid_hex: str) -> DeviceObjectEntry | None:
        with self._lock:
            return self._entries.get(oid_hex)

    @blocking
    def get_local(self, oid_hex: str):
        """The live array if this process holds it (restoring a spilled one
        from the arena first); None when not the holder."""
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None:
                return None
            entry.last_access = time.monotonic()
            arr = entry.array
        if arr is not None:
            return arr
        return self._restore(oid_hex)

    # ---- host materialization / spill / restore ----

    @blocking
    def host_bytes(self, oid_hex: str) -> bytes | None:
        """Serialized host copy (small-object inline fallback)."""
        from ray_tpu_torch._private import serialization

        arr = self.get_local(oid_hex)
        if arr is None:
            return None
        return serialization.dumps(arr)

    @blocking
    def materialize_to_store(self, oid_hex: str) -> bool:
        """Seal a host copy into the node's shm arena under the same object
        id — the no-group/cross-mesh fallback target — KEEPING the device
        copy resident. Idempotent."""
        from ray_tpu_torch._private import serialization

        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None:
                return False
            if entry.in_store:
                return True
            arr = entry.array
        if arr is None:  # spilled: the arena copy already exists
            return True
        ser = serialization.serialize(arr)
        self.cw.store.put_serialized(oid_hex, ser)
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is not None:
                entry.in_store = True
        if entry is None:
            # free() raced the seal and saw in_store=False, so it skipped
            # the store cleanup — the copy we just sealed would be orphaned.
            async def _free_store():
                try:
                    await self.cw.raylet.acall("free_object", {"object_id": oid_hex})
                except Exception:
                    pass

            self.cw._io.spawn(_free_store())
            return False
        return True

    @blocking
    def spill(self, oid_hex: str) -> bool:
        """Device→host under memory pressure: seal the host copy into the
        arena, then release the device buffers (drop the live array)."""
        if not self.materialize_to_store(oid_hex):
            return False
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None or entry.array is None:
                return entry is not None
            entry.array = None
            nbytes = entry.meta.nbytes
        DEVOBJ_STATS.spills += 1
        flight_recorder.record("devobj_spill", f"{oid_hex[:12]}:{nbytes}")
        return True

    @blocking
    def _restore(self, oid_hex: str):
        """Arena → device: deserialize the spilled copy (original sharding
        lands back on its device index through the tensor reducer) and pin
        it live again."""
        from ray_tpu_torch._private import serialization

        view = self.cw.store.get_view(oid_hex, timeout=30.0)
        try:
            arr = serialization.deserialize(view)
        finally:
            self.cw.store.release(oid_hex)
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None:
                return arr  # freed while restoring: hand the value out anyway
            if entry.array is None:
                entry.array = arr
            entry.last_access = time.monotonic()
            arr = entry.array
        DEVOBJ_STATS.restores += 1
        flight_recorder.record("devobj_restore", oid_hex[:12])
        return arr

    @blocking
    def _spill_for_pressure(self, limit_bytes: int, protect: str = ""):
        """Spill LRU live entries until resident bytes fit the limit."""
        while True:
            with self._lock:
                live = [
                    (e.last_access, oid)
                    for oid, e in self._entries.items()
                    # Channel payloads (scope set) are exempt: they live
                    # milliseconds, and spilling one would seal the very
                    # host copy the descriptor plane avoids.
                    if e.array is not None and oid != protect and not e.scope
                ]
                resident = sum(
                    e.meta.nbytes for e in self._entries.values() if e.array is not None
                )
            if resident <= limit_bytes or not live:
                return
            live.sort()
            if not self.spill(live[0][1]):
                return

    # ---- transfer (holder side, driven by rpc_devobj_pull) ----

    @blocking
    def send_via_group(self, oid_hex: str, group_name: str, dst_rank: int, tag: str):
        """p2p-send the live array to the consumer's rank (the direct
        mailbox; an unclaimed payload is swept by the consumer's inbox).
        Runs on an executor thread (the pull RPC handler must not block the
        IO loop). After a grace period the group's stale GCS rows are
        swept, as the JAX package's mailbox janitor does."""
        from ray_tpu_torch.util.collective import get_group

        try:
            arr = self.get_local(oid_hex)
            if arr is None:
                raise KeyError(oid_hex)
            group = get_group(group_name)
            group.send(arr, dst_rank, tag)
            DEVOBJ_STATS.transfers_collective += 1
            flight_recorder.record("devobj_transfer", f"{oid_hex[:12]}:collective:{group_name}")
            self._schedule_group_sweep(group_name)
        except Exception:
            logger.exception(
                "collective send of device object %s on group %s failed",
                oid_hex[:12], group_name,
            )

    @blocking
    def broadcast_via_group(self, oid_hex: str, group_name: str, timeout: float = 30.0) -> dict:
        """Group analog of :meth:`send_via_group`: fan the live array to
        EVERY member of ``group_name`` with ONE group operation — one
        serialize, concurrent acked chunk pushes at each member's direct
        mailbox (``p2p.group_bcast_send``; the NCCL group takes the same
        host plane). Members then
        resolve the same descriptor straight from
        their inbox, zero pull round trips. Runs on an executor thread
        (driven by ``rpc_devobj_broadcast``; serialization plus K ack RTTs
        must not stall the IO loop). Returns the per-rank delivery map —
        a dead member lands in ``failed`` (the driver-side API turns that
        into a typed CollectiveBroadcastError naming it) while surviving
        ranks complete."""
        from ray_tpu_torch.util.collective import get_group

        arr = self.get_local(oid_hex)
        if arr is None:
            raise KeyError(oid_hex)
        group = get_group(group_name)
        # No mailbox fallback: descriptor consumers resolve from the direct
        # inbox only — a KV drop would be a false "delivered" plus dead
        # payload bytes in the GCS until the janitor.
        result = group.bcast_send_payload(
            arr, tag=oid_hex, timeout=timeout, mailbox_fallback=False
        )
        result["group"] = group_name
        result["src_rank"] = group.rank
        DEVOBJ_STATS.transfers_collective += 1
        # Denominator is the ROSTER SNAPSHOT the send targeted (elastic
        # membership), not the world size frozen at group init.
        targets = (
            len(result["ok_ranks"]) + len(result["fallback_ranks"])
            + len(result["failed"])
        )
        flight_recorder.record(
            "coll_broadcast",
            f"{oid_hex[:12]}:{group_name}:{len(result['ok_ranks'])}/"
            f"{targets}:{result['bytes']}",
        )
        return result

    @blocking
    def reduce_via_group(self, oid_hex: str, group_name: str, mode: str,
                         op_name: str, dst_rank: int, tag: str,
                         timeout: float = 60.0) -> dict:
        """This HOLDER's share of a device-object group reduce/allreduce:
        feed the live array into the tree combine
        (``group.allreduce_payload`` / ``reduce_send_payload`` — chunk-wise
        combine at relay hops on the cpu backend, the group's own allreduce
        on nccl/gloo) and REPLACE the resident tensor with the result — NCCL-style in-place semantics:
        the descriptor keeps its identity/shape/dtype and every consumer's
        NEXT resolve sees the combined value. ``allreduce`` replaces on
        every holder; ``reduce`` only on the ``dst_rank`` holder (other
        holders keep their contribution). Runs on an executor thread
        (driven by ``rpc_devobj_reduce``). Raises KeyError when the entry
        was freed; collective errors (typed timeout naming a silent child,
        shape disagreement) propagate for the RPC layer to answer with."""
        from ray_tpu_torch.util.collective import get_group
        from ray_tpu_torch.util.collective.types import ReduceOp

        arr = self.get_local(oid_hex)
        if arr is None:
            raise KeyError(oid_hex)
        group = get_group(group_name)
        op = ReduceOp[op_name] if isinstance(op_name, str) else op_name
        if mode == "allreduce":
            out = group.allreduce_payload(arr, tag=tag, op=op, timeout=timeout)
        else:
            out = group.reduce_send_payload(
                arr, tag=tag, op=op, dst_rank=dst_rank, timeout=timeout
            )
        replaced = out is not None
        if replaced:
            self._replace_resident(oid_hex, out)
        DEVOBJ_STATS.transfers_collective += 1
        flight_recorder.record(
            "coll_reduce",
            f"{oid_hex[:12]}:{group_name}:{mode}:{group.rank}:{int(replaced)}",
        )
        return {"rank": group.rank, "world_size": group.world_size, "reduced": replaced}

    @any_thread
    def _replace_resident(self, oid_hex: str, value) -> None:
        """Swap the live tensor under an existing entry, preserving the
        descriptor's dtype, shape and device (the meta already sealed into
        the store must stay truthful). A freed-while-reducing entry is a
        no-op."""
        import numpy as np
        import torch

        from ray_tpu_torch._private.serialization import is_tensor

        if not is_tensor(value):
            value = torch.from_numpy(np.ascontiguousarray(value))
        with self._lock:
            entry = self._entries.get(oid_hex)
            if entry is None or entry.array is None:
                return
            old = entry.array
            entry.array = value.to(device=old.device, dtype=old.dtype).reshape(old.shape)
            entry.last_access = time.monotonic()
            had_store_copy = entry.in_store
            entry.in_store = False
        if had_store_copy:
            # The arena held PRE-reduce bytes: a later spill/restore or
            # host-path pull must not resurrect them. Delete the copy; the
            # next materialize reseals from the combined array.
            async def _free_store():
                try:
                    await self.cw.raylet.acall("free_object", {"object_id": oid_hex})
                except Exception:
                    pass

            self.cw._io.spawn(_free_store())

    def _schedule_group_sweep(self, group_name: str, delay_s: float = 180.0):
        # The per-group stale-row janitor: dead-epoch roster/coord rows and
        # orphaned addr rows of departed members.
        async def _sweep():
            import asyncio

            from ray_tpu_torch.util.collective.p2p import sweep_stale_group_rows

            await asyncio.sleep(delay_s)
            await sweep_stale_group_rows(self.cw.gcs, group_name)

        self.cw._io.spawn(_sweep())

    # ---- release (ownership protocol: owner's last ref dropped) ----

    @any_thread
    def free(self, oid_hex: str):
        with self._lock:
            entry = self._entries.pop(oid_hex, None)
        if entry is None:
            return
        DEVOBJ_STATS.frees += 1
        flight_recorder.record("devobj_free", oid_hex[:12])
        if not entry.scope:  # channel payloads never wrote a registry row
            self._registry_del(oid_hex)
        if entry.in_store:
            # The arena/spilled copy is holder-managed (the owner's plasma
            # bookkeeping never saw it) — delete it cluster-wide here.
            async def _free_store():
                try:
                    await self.cw.raylet.acall("free_object", {"object_id": oid_hex})
                except Exception:
                    pass

            self.cw._io.spawn(_free_store())

    # ---- introspection ----

    def usage(self) -> dict:
        with self._lock:
            live = [e for e in self._entries.values() if e.array is not None]
            spilled = sum(1 for e in self._entries.values() if e.array is None)
            return {
                "resident_count": len(live),
                "resident_bytes": sum(e.meta.nbytes for e in live),
                "spilled_count": spilled,
            }

    def object_ids(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    # ---- cluster state registry (best-effort, async) ----

    def _registry_put(self, meta):
        row = json.dumps(
            {
                "object_id": meta.object_id,
                "shape": list(meta.shape),
                "dtype": meta.dtype,
                "nbytes": meta.nbytes,
                "transport": meta.transport,
                "holder_id": meta.holder_id,
                "holder_kind": meta.holder_kind,
                "node_id": self.cw.node_id,
                "created_ts": meta.created_ts,
            }
        ).encode()  # the GCS KV schema takes bytes values

        async def _put():
            try:
                await self.cw.gcs.acall(
                    "kv_put", {"key": f"devobj/{meta.object_id}", "value": row}
                )
            except Exception:
                pass

        self.cw._io.spawn(_put())

    def _registry_del(self, oid_hex: str):
        async def _del():
            try:
                await self.cw.gcs.acall("kv_del", {"key": f"devobj/{oid_hex}"})
            except Exception:
                pass

        self.cw._io.spawn(_del())
