"""Device object plane — device-resident tensors, passed by reference with
out-of-band collective transfer.

From ``ray_tpu/experimental/device_object/``: a torch tensor (a CUDA tensor
on the card; a CPU tensor stays resident the same way) takes the place of
the jax.Array.

The base object plane (``_private/serialization.py``) DMAs every device
array host-side on ``put`` and back on ``get``: an actor-to-actor tensor
handoff (learner→sampler weight sync, KV-cache migration, pipeline
activations) pays two host copies plus shm traffic even when both endpoints
sit on the same mesh. This plane keeps the array ON its devices and seals
only a small :class:`DeviceObjectMeta` descriptor into the normal store —
the ``ObjectRef`` stays first-class (refcounted, waitable, passable,
reconstruct-free), while the payload moves out of band:

- **same process** — the consumer gets the live tensor back (the same
  ``data_ptr``), zero
  copies of the payload anywhere;
- **same mesh** — a ``util/collective`` group p2p ``send``/``recv`` moves
  it holder→consumer over the host p2p plane, landing on the consumer's
  device index;
- **no shared group / cross-mesh** — the holder materializes a host copy
  (inline for small arrays, its node's shm arena otherwise) and the
  consumer resolves through the existing host-shm path, transparently.

Opt in per value with ``ray_tpu_torch.put(arr, tensor_transport="collective")``
or per actor with ``@ray_tpu_torch.remote(tensor_transport="collective")`` —
every top-level plain tensor such an actor returns stays device-resident
on the actor, which is the HOLDER; the caller stays the owner and the
normal ownership protocol frees the device buffers when the last ref
drops. Under memory pressure (``devobj_resident_limit_bytes``) the holder
spills device→host into the arena and restores on the next resolve; holder
death surfaces :class:`~ray_tpu_torch.exceptions.DeviceObjectLostError` naming
the holder, falling back to the spilled/host copy when one exists.

Reference direction: Ray GPU objects / `tensor_transport=` direct tensor
transport over ``ray.util.collective``; Podracer (arXiv:2104.06272) is the
case for keeping data device-resident end to end; the original
Ray paper (arXiv:1712.05889) is why this stays inside the ObjectRef
ownership model instead of becoming a side API.
"""

import itertools

from ray_tpu_torch.experimental.device_object.descriptor import (  # noqa: F401
    TENSOR_TRANSPORTS,
    DeviceObjectMeta,
    validate_transport,
)
from ray_tpu_torch.experimental.device_object.manager import (  # noqa: F401
    DEVOBJ_STATS,
    DeviceObjectManager,
    device_object_stats,
)
from ray_tpu_torch.experimental.device_object.resolve import resolve_meta  # noqa: F401


def _unreachable_errors() -> tuple:
    """Exception classes that mean 'the holder process cannot be reached'
    (vs. 'the holder answered with an error')."""
    from ray_tpu_torch._private.rpc import ConnectionLost

    return (ConnectionLost, ConnectionError, TimeoutError)


def broadcast(ref, group_name: str | None = None, *, timeout: float = 60.0,
              strict: bool = True, node_ids: list | None = None) -> dict:
    """Fan a device object's payload out with ONE group operation, so a
    learner syncing weights to K samplers stops paying K serial unicasts
    (Podracer, arXiv:2104.06272 — the fan-out this plane exists for).

    With ``group_name``: the holder runs a group broadcast over that
    collective group (``p2p.group_bcast_send`` on the cpu backend — one
    serialize, concurrent acked chunk pushes at every member's direct
    mailbox; the NCCL group rides the same host plane). Each
    member's NEXT resolve of ``ref`` (get / task-arg) takes the payload
    straight from its inbox — zero pull round trips, zero host-store
    copies. One broadcast per ref: the inbox tombstones repeated keys.

    Without ``group_name``: the cross-node host fallback — the holder
    seals a host copy into its arena and the copy rides the cut-through
    relay tree (``util.object_transfer.broadcast_object``) to every alive
    node (or ``node_ids``); consumers resolve from their LOCAL arena.

    Returns the delivery map (``ok_ranks``/``fallback_ranks``/``failed``
    for the group path, ``pushed_nodes`` for the host path). ``strict=True``
    raises :class:`~ray_tpu_torch.exceptions.CollectiveBroadcastError` NAMING any
    rank the group path could not deliver to — surviving ranks keep their
    payload either way, and a respawned member transparently falls back to
    the pull path."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.exceptions import CollectiveBroadcastError

    cw = worker_context.get_core_worker()
    meta = cw.get_device_meta(ref, timeout=timeout)
    if group_name is None:
        from ray_tpu_torch.util.object_transfer import broadcast_object

        if tuple(meta.holder_addr) == tuple(cw.address):
            ok = cw._device_manager().materialize_to_store(meta.object_id)
        else:
            resp = cw._devobj_client(tuple(meta.holder_addr)).call(
                "devobj_broadcast", {"object_id": meta.object_id}, timeout=timeout
            )
            ok = resp.get("kind") == "plasma"
        if not ok:
            raise CollectiveBroadcastError(
                f"holder of device object {meta.object_id[:12]} could not "
                f"materialize a host copy (holder {meta.holder_label()})",
            )
        pushed = broadcast_object(ref, node_ids=node_ids, timeout=timeout)
        return {"kind": "plasma", "pushed_nodes": pushed}
    if tuple(meta.holder_addr) == tuple(cw.address):
        # Same typed surface as the RPC path: a freed entry is a lost
        # object, an uninitialized group a broadcast error.
        try:
            result = cw._device_manager().broadcast_via_group(
                meta.object_id, group_name, timeout
            )
        except KeyError:
            from ray_tpu_torch.exceptions import DeviceObjectLostError

            raise DeviceObjectLostError(meta.object_id, holder=meta.holder_label())
        except ValueError as e:
            raise CollectiveBroadcastError(str(e), group=group_name) from e
        result["kind"] = "collective"
    else:
        try:
            result = cw._devobj_client(tuple(meta.holder_addr)).call(
                "devobj_broadcast",
                {"object_id": meta.object_id, "group": group_name, "timeout": timeout},
                timeout=timeout + 20.0,
            )
        except _unreachable_errors() as e:
            # Holder genuinely unreachable: the object may be lost with it.
            from ray_tpu_torch.exceptions import DeviceObjectLostError

            raise DeviceObjectLostError(
                meta.object_id,
                holder=meta.holder_label(),
                msg=(
                    f"group broadcast of {meta.object_id[:12]} failed: holder "
                    f"{meta.holder_label()} unreachable ({e!r})"
                ),
            ) from e
        except Exception as e:
            # Holder answered with an error (or a handler bug surfaced):
            # the object is intact — a broadcast failure, not a loss.
            raise CollectiveBroadcastError(
                f"group broadcast of {meta.object_id[:12]} failed on holder "
                f"{meta.holder_label()}: {e!r}",
                group=group_name,
            ) from e
    kind = result.get("kind")
    if kind == "missing":
        from ray_tpu_torch.exceptions import DeviceObjectLostError

        raise DeviceObjectLostError(meta.object_id, holder=meta.holder_label())
    if kind == "error":
        raise CollectiveBroadcastError(result.get("error", "group broadcast failed"), group=group_name)
    if strict and result.get("failed"):
        raise CollectiveBroadcastError(group=group_name, failed=result["failed"], info=result)
    return result


_REDUCE_SEQ = itertools.count(1)


def reduce(refs: list, group_name: str, *, op=None, dst_rank: int = 0,
           timeout: float = 120.0, strict: bool = True) -> dict:
    """Group reduce over device objects: ``refs`` holds ONE ref per group
    member (rank order), each device-resident on its holder; the holders
    combine them elementwise up the relay tree (chunk-wise at every hop on
    the cpu backend, the group's own reduce on nccl/gloo) and the
    ``dst_rank`` holder's tensor is
    REPLACED in place with the result — its descriptor is unchanged, so
    the next resolve of ``refs[dst_rank]`` sees the combined value. Other
    holders keep their contribution. ``strict=True`` raises
    :class:`~ray_tpu_torch.exceptions.CollectiveReduceError` naming any holder
    that did not finish (a partial reduce is poison — see the exception)."""
    return _reduce_verb(refs, group_name, "reduce", op, dst_rank, timeout, strict)


def allreduce(refs: list, group_name: str, *, op=None,
              timeout: float = 120.0, strict: bool = True) -> dict:
    """Group allreduce over device objects: like :func:`reduce`, but the
    combined result broadcasts back down the tree and EVERY holder's array
    is replaced in place — after this, all of ``refs`` resolve to the same
    reduced value (the multi-host gradient-sync primitive the Podracer
    learner seam rides as ``grad_sync="device_allreduce"``)."""
    return _reduce_verb(refs, group_name, "allreduce", op, 0, timeout, strict)


def _reduce_verb(refs, group_name, mode, op, dst_rank, timeout, strict) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.exceptions import CollectiveReduceError
    from ray_tpu_torch.util.collective.types import ReduceOp

    if not refs:
        raise ValueError("reduce/allreduce needs one ref per group member")
    op = op or ReduceOp.SUM
    cw = worker_context.get_core_worker()
    metas = [cw.get_device_meta(ref, timeout=timeout) for ref in refs]
    # One tag per gang op: every holder must combine under the SAME stream
    # keys, and a second reduce over the same refs must not collide with
    # the first (unlike broadcast, reduces repeat per training step).
    tag = f"{metas[0].object_id[:16]}.{next(_REDUCE_SEQ)}"

    def _one(meta):
        if tuple(meta.holder_addr) == tuple(cw.address):
            try:
                out = cw._device_manager().reduce_via_group(
                    meta.object_id, group_name, mode, op.name, dst_rank, tag, timeout
                )
                return {"kind": "collective", **out}
            except KeyError:
                return {"kind": "missing"}
            except Exception as e:
                return {"kind": "error", "error": repr(e)}
        try:
            return cw._devobj_client(tuple(meta.holder_addr)).call(
                "devobj_reduce",
                {"object_id": meta.object_id, "group": group_name, "mode": mode,
                 "op": op.name, "dst_rank": dst_rank, "tag": tag, "timeout": timeout},
                timeout=timeout + 20.0,
            )
        except _unreachable_errors() as e:
            return {"kind": "error", "error": f"holder unreachable: {e!r}"}
        except Exception as e:
            return {"kind": "error", "error": repr(e)}

    # The gang is concurrent BY REQUIREMENT: every holder blocks inside the
    # collective until its children/parent move, so the pool must be wide
    # enough for all of them at once — a capped pool would deadlock the op.
    with ThreadPoolExecutor(max_workers=len(metas)) as pool:
        per_holder = list(pool.map(_one, metas))

    failed: dict = {}
    ranks = []
    for meta, res in zip(metas, per_holder):
        if res.get("kind") == "collective":
            ranks.append(res.get("rank"))
        elif res.get("kind") == "missing":
            failed[meta.holder_label()] = "device object missing on holder"
        else:
            failed[meta.holder_label()] = res.get("error", "reduce failed")
    result = {
        "kind": "collective", "group": group_name, "mode": mode, "op": op.name,
        "tag": tag, "ok_ranks": sorted(r for r in ranks if r is not None),
        "failed": failed,
    }
    if strict and failed:
        raise CollectiveReduceError(group=group_name, failed=failed, info=result)
    return result


def allgather(refs: list, group_name: str | None = None, *, timeout: float = 60.0,
              strict: bool = True) -> list:
    """Group allgather for device objects: every member ends up able to
    resolve EVERY ref in ``refs`` locally — one descriptor and one group
    operation per ref, with the per-holder fan-outs running concurrently
    (the holders push in parallel; the driver's RPCs overlap on threads).
    Returns one delivery map per ref, in order."""
    from concurrent.futures import ThreadPoolExecutor

    if not refs:
        return []
    if len(refs) == 1:
        return [broadcast(refs[0], group_name, timeout=timeout, strict=strict)]
    with ThreadPoolExecutor(max_workers=min(8, len(refs))) as pool:
        futs = [
            pool.submit(broadcast, ref, group_name, timeout=timeout, strict=strict)
            for ref in refs
        ]
        return [f.result() for f in futs]


__all__ = [
    "DEVOBJ_STATS",
    "DeviceObjectManager",
    "DeviceObjectMeta",
    "TENSOR_TRANSPORTS",
    "allgather",
    "allreduce",
    "broadcast",
    "device_object_stats",
    "reduce",
    "resolve_meta",
    "validate_transport",
]
