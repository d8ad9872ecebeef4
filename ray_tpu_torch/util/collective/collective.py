"""Collective API.

Analog of the reference's ray.util.collective.collective
(python/ray/util/collective/collective.py: init_collective_group:120,
create_collective_group:151, allreduce:258, reduce:311, broadcast:373,
allgather:423, reducescatter:472, send:531, recv:594); from
``ray_tpu/util/collective/collective.py``. The JAX package's XLA world
(``tpu_group.py``) becomes a torch.distributed group per named collective
group (``nccl_group.py``: NCCL on CUDA tensors, gloo on CPU tensors), and the
host ring (``cpu_group.py``) stays.

Usage inside member actors (one per card):

    from ray_tpu_torch.util import collective as col

    class TrainWorker:
        def setup(self, world_size, rank):
            col.init_collective_group(world_size, rank, backend="nccl")
        def step(self, grads):
            return col.allreduce(grads)

Driver side: ``create_collective_group(actors, ...)`` declares the group and
invokes ``init`` on every member (gang init, all-or-nothing — a process group
is static).
"""

from __future__ import annotations

import logging
import threading

from ray_tpu_torch.util.collective.types import Backend, ReduceOp

logger = logging.getLogger(__name__)


class GroupManager:
    """Per-process registry (reference: GroupManager collective.py:40)."""

    def __init__(self):
        self._groups: dict = {}
        self._lock = threading.Lock()

    def create(self, group_name: str, world_size: int, rank: int, backend: str, coordinator=None):
        backend = Backend.validate(backend)
        with self._lock:
            if group_name in self._groups:
                raise ValueError(f"collective group {group_name!r} already exists")
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker_if_initialized()
        gcs = cw.gcs if cw is not None else None
        if backend in (Backend.NCCL, Backend.GLOO):
            from ray_tpu_torch.util.collective.nccl_group import NcclCollectiveGroup

            # This node's GCS-registered address: the rendezvous store must
            # be dialable from member actors on OTHER hosts, so loopback is
            # structurally wrong on a real cluster.
            node_ip = None
            if cw is not None and rank == 0:
                try:
                    nodes = gcs.call("get_nodes").get("nodes", {})
                    addr = nodes.get(cw.node_id, {}).get("address")
                    if addr:
                        node_ip = addr[0]
                except Exception:
                    logger.warning("could not resolve node IP from GCS; using interface IP")
            group = NcclCollectiveGroup(
                group_name, world_size, rank, backend=backend, coordinator=coordinator,
                gcs=gcs, node_ip=node_ip,
            )
        else:
            from ray_tpu_torch.util.collective.cpu_group import CpuCollectiveGroup

            group = CpuCollectiveGroup(group_name, world_size, rank, gcs=gcs)
        with self._lock:
            self._groups[group_name] = group
        if cw is not None and gcs is not None:
            # Publish this member's core-worker RPC address so a group
            # broadcast (p2p.group_bcast_send) can push payload frames
            # straight at its direct mailbox instead of going through the
            # GCS-KV mailbox per rank. Best-effort: members without a row
            # get the mailbox fallback.
            from ray_tpu_torch.util.collective.p2p import register_member_addr, roster_join

            register_member_addr(gcs, group_name, rank, cw.address)
            # Then JOIN the epochal roster (address row first: a rank the
            # roster lists always has a dialable row). A rank already
            # listed is a RE-REGISTER — a respawned member at a new
            # address — and still bumps the epoch, which is what drops
            # every peer's address cache.
            try:
                roster_join(gcs, group_name, rank, world_size)
            except Exception:
                logger.warning(
                    "roster join failed for group %r rank %s (verbs fall "
                    "back to the static world)", group_name, rank,
                )
        return group

    def get(self, group_name: str):
        group = self._groups.get(group_name)
        if group is None:
            raise ValueError(
                f"no collective group {group_name!r} in this process; "
                "call init_collective_group first"
            )
        return group

    def destroy(self, group_name: str):
        with self._lock:
            group = self._groups.pop(group_name, None)
        if group is not None:
            group.destroy()


_manager = GroupManager()


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str = "nccl",
    group_name: str = "default",
    coordinator: str | None = None,
):
    """Member-side group init (reference: collective.py:120)."""
    return _manager.create(group_name, world_size, rank, backend, coordinator)


def create_collective_group(
    actors: list,
    world_size: int | None = None,
    ranks: list[int] | None = None,
    backend: str = "nccl",
    group_name: str = "default",
):
    """Driver-side gang init (reference: collective.py:151): calls
    ``init_collective_group`` in every member actor concurrently and waits for
    all (the process group's rendezvous requires all processes to join)."""
    import ray_tpu_torch

    world_size = world_size or len(actors)
    ranks = ranks or list(range(len(actors)))
    # Convention: member actors expose
    # ``init_collective(world_size, rank, backend, group_name)`` which calls
    # init_collective_group (see module docstring).
    refs = [
        actor.init_collective.remote(world_size, r, backend, group_name)
        for actor, r in zip(actors, ranks)
    ]
    return ray_tpu_torch.get(refs, timeout=300)


def get_group(group_name: str = "default"):
    return _manager.get(group_name)


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _manager.get(group_name)
        return True
    except ValueError:
        return False


def destroy_collective_group(group_name: str = "default"):
    _manager.destroy(group_name)


def allreduce(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default"):
    return _manager.get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _manager.get(group_name).broadcast(tensor, src_rank)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default", op: ReduceOp = ReduceOp.SUM):
    return _manager.get(group_name).reduce(tensor, dst_rank, op)


def barrier(group_name: str = "default"):
    _manager.get(group_name).barrier()


def send_recv(tensor, perm, group_name: str = "default"):
    """Pairwise exchange (ppermute). The p2p primitive (reference send/recv)."""
    return _manager.get(group_name).send_recv(tensor, perm)


def send(value, dst_rank: int, group_name: str = "default", tag: str = "0"):
    """2-party point-to-point send (reference: collective.py:531): only the
    two endpoints participate. ``tag`` pairs one send with one recv; a CUDA
    tensor lands back on its device index."""
    return _manager.get(group_name).send(value, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: str = "0", timeout: float = 120.0):
    """2-party point-to-point recv (reference: collective.py:594)."""
    return _manager.get(group_name).recv(src_rank, tag, timeout)


def roster(group_name: str = "default") -> dict | None:
    """Current epochal-membership snapshot of ``group_name`` from the GCS:
    ``{"epoch", "ranks", "world_size"}``, or None for a group that never
    published one. Works from ANY process with a GCS connection (the
    driver introspecting a group it is not a member of included)."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.util.collective.p2p import fetch_roster

    cw = worker_context.get_core_worker()
    return fetch_roster(cw.gcs, group_name)


def rejoin_group(group_name: str = "default") -> int | None:
    """Re-assert THIS process's membership in a group it already holds
    locally: re-publish the address row, then re-join the roster. The
    self-healing lever for a LIVE member that a verb EVICTED on a
    transient stall (eviction also deleted its address row) — the epoch
    bump puts it back on every sender's fast path at the next snapshot.
    Returns the new roster epoch, or None when this process never
    initialized the group (a respawned replacement must init, not
    rejoin)."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.util.collective.p2p import register_member_addr, roster_join

    try:
        group = _manager.get(group_name)
    except ValueError:
        return None
    cw = worker_context.get_core_worker_if_initialized()
    if cw is None:
        return None
    register_member_addr(cw.gcs, group_name, group.rank, cw.address)
    return roster_join(cw.gcs, group_name, group.rank, group.world_size)


def evict_member(group_name: str, rank: int, reason: str = "leave") -> int | None:
    """Driver-side LEAVE on behalf of a member that cannot leave for
    itself (SIGKILLed actor, shrink of a fleet whose workers are killed
    outright): drops ``rank`` from the roster, advances the epoch, and
    deletes its orphaned address row. Returns the new epoch, or None if
    the rank was not listed. The next verb on the group topologizes over
    the survivors."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.util.collective.p2p import roster_leave

    cw = worker_context.get_core_worker()
    return roster_leave(cw.gcs, group_name, rank, reason=reason)


def local_group_hints() -> list:
    """[(group_name, rank, world_size)] for every collective group THIS
    process has initialized. The device-object plane stamps these into its
    descriptors so a consumer can pick a transfer group it shares with the
    holder without a directory service."""
    with _manager._lock:
        groups = list(_manager._groups.items())
    return [(name, g.rank, g.world_size) for name, g in groups]
