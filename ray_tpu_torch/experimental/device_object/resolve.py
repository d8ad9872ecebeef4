"""Consumer-side resolution: DeviceObjectMeta → live value.

``CoreWorker.get`` (and therefore task-arg resolution) hands every
materialized ``DeviceObjectMeta`` here. Resolution order:

1. **same process** — this process IS the holder: hand back the live array
   (restoring from the arena first if it was spilled). Zero payload copies.
2. **shared collective group** — ask the holder to p2p-send over a group
   both sides initialized (``devobj_pull`` RPC kicks the send on the
   holder; we ``recv`` on the consumer thread). Sharding survives the hop.
3. **host fallback** — no shared group (or transport rejected): the holder
   ships small arrays inline in the RPC reply and seals large ones into its
   node's shm arena under the same object id, which the existing store pull
   path resolves from anywhere in the cluster.
4. **holder dead** — fall back to a spilled/arena copy when one exists,
   else raise :class:`DeviceObjectLostError` naming the holder.
"""

from __future__ import annotations

import logging
import os
import time

from ray_tpu_torch._private import flight_recorder, serialization
from ray_tpu_torch._private.concurrency import blocking
from ray_tpu_torch.exceptions import DeviceObjectLostError, GetTimeoutError

logger = logging.getLogger(__name__)

# Per-ATTEMPT ceiling on one devobj_pull RPC; with retries the unbounded-
# deadline worst case stays at the old 60s total, but a lost frame now
# costs one attempt (~15s), not the whole budget. Large enough for the
# holder to materialize a multi-10s-of-MiB host copy before answering.
_PULL_ATTEMPT_S = 15.0


def _remaining(deadline, cap: float) -> float:
    if deadline is None:
        return cap
    rem = deadline - time.monotonic()
    if rem <= 0:
        raise GetTimeoutError("ray_tpu_torch.get() timed out resolving a device object")
    return min(rem, cap)


def _pick_group(meta):
    """(group_name, consumer_rank, holder_rank) for a collective group both
    endpoints initialized, or None."""
    from ray_tpu_torch.util.collective import local_group_hints

    try:
        local = {name: rank for name, rank, _ in local_group_hints()}
    except Exception:
        return None
    for name, holder_rank, _ in meta.group_hints or []:
        my_rank = local.get(name)
        if my_rank is not None and my_rank != holder_rank:
            return (name, my_rank, holder_rank)
    return None


@blocking
def resolve_meta(cw, meta, deadline=None):
    """Turn a descriptor into the payload. ``cw`` is this process's
    CoreWorker; blocking (runs on get()'s calling thread)."""
    from ray_tpu_torch.experimental.device_object.manager import DEVOBJ_STATS, active_manager

    oid = meta.object_id
    # 1. Same process: live (or spilled-here) array, zero payload copies.
    mgr = active_manager()
    if mgr is not None and mgr.entry(oid) is not None:
        arr = mgr.get_local(oid)
        if arr is not None:
            DEVOBJ_STATS.transfers_local += 1
            flight_recorder.record("devobj_transfer", f"{oid[:12]}:local")
            return arr
    # 1b. Group-sourced descriptor: a holder-side group broadcast
    # (device_object.broadcast) pre-delivered the payload into this
    # process's direct mailbox under a key derived from (group, oid, rank)
    # — take it with zero round trips. Non-blocking: a miss (no broadcast
    # happened, or this ref was already taken once) just falls through to
    # the pull path.
    if meta.transport == "collective":
        value = _take_broadcast(cw, meta)
        if value is not None:
            return value
    # 1c. A host copy already on THIS node's arena (the cut-through relay
    # fallback of device_object.broadcast lands one per node, and a holder
    # on this node may have materialized/spilled): resolve from local shm
    # without waking the holder.
    try:
        if cw.store.contains(oid):
            return _from_store(cw, meta, deadline)
    except GetTimeoutError:
        raise
    except Exception:
        logger.debug("local-store probe for device object %s failed", oid[:12], exc_info=True)
    # 2./3. Ask the holder. One RPC decides the path: it kicks off a
    # collective send when we named a shared group, else it hands back an
    # inline/arena host copy.
    pick = _pick_group(meta) if meta.transport == "collective" else None
    if pick is not None:
        # This process IS a member of a group it shares with the holder,
        # yet the broadcast inbox had nothing — the member fell off the
        # group-sync fast path (stale roster, missed epoch, respawn that
        # never re-registered) and is quietly riding pull-resolve. Count
        # it: this is the elastic-membership degradation signal
        # (ray_tpu_collective_host_sync_fallbacks_total).
        from ray_tpu_torch.util.collective.p2p import COLL

        COLL.host_sync_fallbacks += 1
        flight_recorder.record("devobj_transfer", f"{oid[:12]}:host_sync_fallback:{pick[0]}")
    req: dict = {"object_id": oid}
    tag = ""
    if pick is not None:
        group_name, my_rank, _ = pick
        tag = f"{oid[:16]}-{os.urandom(4).hex()}"
        req.update({"group": group_name, "dst_rank": my_rank, "tag": tag})
    try:
        # Short-connect client: a dead holder surfaces in ~2s
        # (ConnectionLost) and falls through to the host-copy fallback /
        # typed loss instead of grinding the full connect-retry budget.
        # Per-ATTEMPT timeout is _PULL_ATTEMPT_S, not the whole pull
        # budget: a silently lost request/reply frame (chaos drop; receiver
        # hiccup) used to stall the resolve 60s before its one retry —
        # bounded attempts heal it in ~15s while the deadline still caps
        # the total (the holder's answer is idempotent, so a retry racing
        # a slow first answer is harmless).
        client = cw._devobj_client(tuple(meta.holder_addr))
        resp = client.call(
            "devobj_pull", req,
            timeout=_remaining(deadline, _PULL_ATTEMPT_S), retries=3,
        )
    except GetTimeoutError:
        raise
    except Exception:
        return _host_copy_or_lost(cw, meta, deadline)
    kind = resp.get("kind")
    if kind == "collective":
        from ray_tpu_torch.util.collective import get_group

        try:
            value = get_group(resp["group"]).recv(
                resp["src_rank"], tag, timeout=_remaining(deadline, 120.0)
            )
        except GetTimeoutError:
            raise
        except Exception:
            # Holder-side send failed (object freed mid-pull, group torn
            # down, mailbox hiccup) — the holder answered, so it was alive:
            # re-pull over the host path before declaring the object lost.
            logger.warning(
                "collective recv of device object %s failed; falling back to "
                "the host path", oid[:12],
            )
            return _host_pull(cw, meta, deadline)
        DEVOBJ_STATS.transfers_collective += 1
        flight_recorder.record("devobj_transfer", f"{oid[:12]}:collective:{resp['group']}")
        return value
    if kind == "inline":
        value = serialization.loads(resp["data"])
        _bump_host(oid, "host_inline")
        return value
    if kind == "plasma":
        return _from_store(cw, meta, deadline)
    # "missing": the holder no longer tracks it (freed under us, or a stale
    # descriptor after holder restart) — a host copy may still exist.
    return _host_copy_or_lost(cw, meta, deadline)


def _take_broadcast(cw, meta):
    """Non-blocking inbox probe for a group-broadcast payload of this
    descriptor: for every collective group this process shares with the
    holder, try the deterministic broadcast key. At-most-once per ref per
    process (the inbox take consumes the entry); a second resolve of the
    same ref falls back to the pull path."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.util.collective import local_group_hints
    from ray_tpu_torch.util.collective.p2p import COLL, bcast_key

    oid = meta.object_id
    try:
        local = {name: rank for name, rank, _ in local_group_hints()}
    except Exception:
        return None
    for name, holder_rank, _ in meta.group_hints or []:
        my_rank = local.get(name)
        if my_rank is None or my_rank == holder_rank:
            continue
        data = cw.p2p_inbox.take(bcast_key(name, oid))
        if data is None:
            continue
        value = serialization.loads(data)
        from ray_tpu_torch.experimental.device_object.manager import DEVOBJ_STATS

        COLL.bcast_recvs += 1
        DEVOBJ_STATS.transfers_collective += 1
        flight_recorder.record("devobj_transfer", f"{oid[:12]}:bcast:{name}")
        return value
    return None


def _host_pull(cw, meta, deadline):
    """Pull WITHOUT naming a group: the holder ships inline or seals an
    arena copy. Used directly for non-collective descriptors and as the
    recovery path when a collective transfer dies mid-flight."""
    oid = meta.object_id
    try:
        client = cw._devobj_client(tuple(meta.holder_addr))
        resp = client.call(
            "devobj_pull",
            {"object_id": oid},
            timeout=_remaining(deadline, _PULL_ATTEMPT_S),
            retries=3,
        )
    except GetTimeoutError:
        raise
    except Exception:
        return _host_copy_or_lost(cw, meta, deadline)
    kind = resp.get("kind")
    if kind == "inline":
        value = serialization.loads(resp["data"])
        _bump_host(oid, "host_inline")
        return value
    if kind == "plasma":
        return _from_store(cw, meta, deadline)
    return _host_copy_or_lost(cw, meta, deadline)


def _bump_host(oid: str, label: str):
    from ray_tpu_torch.experimental.device_object.manager import DEVOBJ_STATS

    DEVOBJ_STATS.transfers_host += 1
    flight_recorder.record("devobj_transfer", f"{oid[:12]}:{label}")


def _from_store(cw, meta, deadline):
    """Pull the host copy sealed under the same object id (local arena hit,
    or a cross-node pull through the raylet)."""
    oid = meta.object_id
    view = cw.store.get_view(oid, timeout=_remaining(deadline, 30.0))
    try:
        value = serialization.deserialize(view)
    finally:
        cw.store.release(oid)
    _bump_host(oid, "host_store")
    return value


def _host_copy_or_lost(cw, meta, deadline):
    """Holder unreachable/ignorant: the spilled/arena copy is the last
    resort before a typed loss naming the holder."""
    oid = meta.object_id
    try:
        if cw.store.contains(oid) or cw._has_any_location(oid):
            return _from_store(cw, meta, deadline)
    except GetTimeoutError:
        raise
    except Exception:
        logger.debug("device-object host-copy fallback for %s failed", oid[:12], exc_info=True)
    raise DeviceObjectLostError(oid, holder=meta.holder_label())
