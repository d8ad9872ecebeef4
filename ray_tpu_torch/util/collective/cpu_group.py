"""CPU collective group over the GCS KV / object store.

Analog of the reference's GLOOGroup
(python/ray/util/collective/collective_group/gloo_collective_group.py); from
``ray_tpu/util/collective/cpu_group.py``: a pure-Python host ring, so
collective code runs on nodes with no card (and in unit tests) without any
extra dependency. Data moves through the GCS KV (small control-plane scale)
and, for the group payload verbs, over the p2p direct mailbox.

Payload semantics: tensors in, tensors out; numpy in, numpy out. Values
serialize through ``_private/serialization``, so a CUDA tensor posts its
host bytes and lands back on its device, bit for bit. ``broadcast`` hands
every rank the src rank's value as posted, placed on the caller's device.
The reducing ops combine on the host exactly as the JAX package's ring does
(``np.stack(...).sum(axis=0)`` and friends), so f32 results are bit-equal to
it; the result goes back to the caller's tensor device. A tensor dtype numpy
has no counterpart for (bfloat16) reduces in torch on the CPU instead.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from ray_tpu_torch.util.collective.types import ReduceOp

_REDUCE = {
    ReduceOp.SUM: lambda stack: stack.sum(axis=0),
    ReduceOp.PRODUCT: lambda stack: stack.prod(axis=0),
    ReduceOp.MIN: lambda stack: stack.min(axis=0),
    ReduceOp.MAX: lambda stack: stack.max(axis=0),
    ReduceOp.MEAN: lambda stack: stack.mean(axis=0),
}


def _is_tensor(v) -> bool:
    from ray_tpu_torch._private.serialization import is_tensor

    return is_tensor(v)


def _like(value, out):
    """Place ``out`` like the caller's ``value``: a tensor on ``value``'s
    device when ``value`` is a tensor, as computed otherwise."""
    if not _is_tensor(value):
        return out
    import torch

    if not _is_tensor(out):
        out = torch.from_numpy(np.ascontiguousarray(out))
    return out.to(value.device)


_TORCH_REDUCE = {
    ReduceOp.SUM: lambda stack: stack.sum(0),
    ReduceOp.PRODUCT: lambda stack: stack.prod(0),
    ReduceOp.MIN: lambda stack: stack.amin(0),
    ReduceOp.MAX: lambda stack: stack.amax(0),
    ReduceOp.MEAN: lambda stack: stack.mean(0),
}


def _uniform_stack(group_name: str, step: str, values: list) -> np.ndarray:
    """np.stack with a TYPED shape check: ranks contributing mismatched
    shapes/dtypes is a programming error that must name the offenders, not
    surface as a bare numpy ValueError deep in a reduce."""
    from ray_tpu_torch.exceptions import CollectiveError

    arrs = [_host(v) for v in values]
    shapes = {a.shape for a in arrs}
    if len(shapes) > 1:
        per_rank = {r: a.shape for r, a in enumerate(arrs)}
        raise CollectiveError(
            f"collective {step} on group {group_name!r} requires uniform "
            f"shapes across ranks, got {per_rank}"
        )
    return np.stack(arrs)


def _host(v):
    """A host array of one contribution: a tensor's host copy as numpy
    (numpy dtypes), as a CPU tensor otherwise; anything else np.asarray."""
    if _is_tensor(v):
        from ray_tpu_torch._private.serialization import _NUMPY_DTYPES

        host = v.detach().cpu()
        return host.numpy() if str(host.dtype).removeprefix("torch.") in _NUMPY_DTYPES else host
    return np.asarray(v)


def _reduce_stack(group_name: str, step: str, values: list, op: ReduceOp):
    """Stack-and-reduce on the host with the JAX package's numpy math (the
    same order, so f32 results are bit-equal to its ring). Only when every
    contribution is a tensor of a dtype numpy lacks (bfloat16) does the
    reduce run in torch on the CPU."""
    hosts = [_host(v) for v in values]
    if hosts and all(_is_tensor(h) for h in hosts):
        from ray_tpu_torch.exceptions import CollectiveError

        shapes = {tuple(h.shape) for h in hosts}
        if len(shapes) > 1:
            per_rank = {r: tuple(h.shape) for r, h in enumerate(hosts)}
            raise CollectiveError(
                f"collective {step} on group {group_name!r} requires uniform "
                f"shapes across ranks, got {per_rank}"
            )
        import torch

        return _TORCH_REDUCE[op](torch.stack(hosts))
    if any(_is_tensor(h) for h in hosts):
        hosts = [h.float().numpy() if _is_tensor(h) else h for h in hosts]
    return _REDUCE[op](_uniform_stack(group_name, step, hosts))


class CpuCollectiveGroup:
    def __init__(self, group_name: str, world_size: int, rank: int, gcs=None):
        from ray_tpu_torch._private import worker_context

        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.gcs = gcs or worker_context.get_core_worker().gcs
        self._epoch = 0
        # (roster_epoch, {rank: core-worker addr}) — the address cache is
        # KEYED ON THE ROSTER EPOCH and dropped on any bump: membership is
        # elastic, and a member that re-registered at the SAME coordinator
        # epoch has a new address under the same rank row (the bug the
        # static "fetch once per group" cache had).
        self._addr_cache: tuple[int, dict] | None = None
        # Set by destroy(): a verb racing a concurrent
        # destroy_collective_group must surface a typed CollectiveError,
        # never park until its timeout.
        self._destroyed = False
        # Sends and receives so far per (direction, peer rank, tag): the
        # n-th send of a tag to a peer pairs with its n-th receive.
        self._p2p_counts = collections.Counter()

    def _key(self, step: str, rank: int) -> str:
        return f"collective/{self.group_name}/{self._epoch}/{step}/{rank}"

    def _post(self, step: str, value):
        from ray_tpu_torch._private import serialization

        self.gcs.call(
            "kv_put", {"key": self._key(step, self.rank), "value": serialization.dumps(value)}
        )

    def _check_destroyed(self, verb: str) -> None:
        if self._destroyed:
            from ray_tpu_torch.exceptions import CollectiveError

            raise CollectiveError(
                f"collective group {self.group_name!r} was destroyed "
                f"(rank {self.rank}, during {verb})"
            )

    def _collect(self, step: str, timeout: float = 120.0) -> list:
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.exceptions import CollectiveTimeoutError

        out: list = [None] * self.world_size
        deadline = time.monotonic() + timeout
        remaining = set(range(self.world_size))
        while remaining and time.monotonic() < deadline:
            self._check_destroyed(step)
            for r in list(remaining):
                resp = self.gcs.call("kv_get", {"key": self._key(step, r)})
                if resp.get("found"):
                    out[r] = serialization.loads(resp["value"])
                    remaining.discard(r)
            if remaining:
                time.sleep(0.01)
        if remaining:
            from ray_tpu_torch.util.collective.p2p import COLL

            COLL.timeouts += 1
            raise CollectiveTimeoutError(
                f"collective {step} on group {self.group_name!r} (rank "
                f"{self.rank}) timed out after {timeout}s waiting for ranks "
                f"{sorted(remaining)}",
                group=self.group_name, ranks=remaining,
            )
        return out

    def _sync(self, step: str, value) -> list:
        self._post(step, value)
        stack = self._collect(step)
        self._epoch += 1
        return stack

    def allreduce(self, x, op: ReduceOp = ReduceOp.SUM):
        # Tensors post as-is (a CUDA tensor as its host bytes); the reduce
        # runs on the host and the result goes back to x's device.
        stack = self._sync("allreduce", x if _is_tensor(x) else np.asarray(x))
        return _like(x, _reduce_stack(self.group_name, "allreduce", stack, op))

    def allgather(self, x):
        stack = self._sync("allgather", x)
        if _is_tensor(x) and all(_is_tensor(v) for v in stack):
            import torch

            return torch.stack([v.to(x.device) for v in stack])
        return _like(x, _uniform_stack(self.group_name, "allgather", stack))

    def reducescatter(self, x, op: ReduceOp = ReduceOp.SUM):
        post = x if _is_tensor(x) else np.asarray(x)
        assert post.shape[0] == self.world_size
        stack = self._sync("reducescatter", post)
        return _like(x, _reduce_stack(self.group_name, "reducescatter", stack, op)[self.rank])

    def broadcast(self, x, src_rank: int = 0):
        """Every rank gets the src rank's value AS POSTED, bit for bit (the
        payload-parity contract the device-object broadcast path relies
        on); a tensor lands on the caller's device."""
        stack = self._sync("broadcast", x)
        out = stack[src_rank]
        return out.to(x.device) if _is_tensor(x) and _is_tensor(out) else out

    def reduce(self, x, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        out = self.allreduce(x, op)
        return out if self.rank == dst_rank else None

    def barrier(self):
        self._sync("barrier", np.zeros((1,)))

    def send_recv(self, x, perm):
        """Pairwise exchange: returns the tensor sent to this rank (or x)."""
        stack = self._sync("sendrecv", x)
        for src, dst in perm:
            if dst == self.rank:
                return _like(x, _host(stack[src]))
        return x if _is_tensor(x) else np.asarray(x)

    def send(self, value, dst_rank: int, tag: str) -> int:
        """2-party p2p send (reference: collective.py:531). Unlike the ring
        collectives above, only the two endpoints participate; a tensor
        lands back on its device index (p2p.group_send: the direct mailbox
        at the member's registered address)."""
        from ray_tpu_torch.util.collective.p2p import group_send

        return group_send(self.gcs, self.group_name, self.rank, dst_rank, tag, value,
                          addr=self._addrs().get(dst_rank), counts=self._p2p_counts)

    def recv(self, src_rank: int, tag: str, timeout: float = 120.0):
        """2-party p2p recv (reference: collective.py:594)."""
        from ray_tpu_torch.util.collective.p2p import group_recv

        return group_recv(self.gcs, self.group_name, src_rank, self.rank, tag, timeout,
                          counts=self._p2p_counts)

    # ---- group broadcast (ONE op fanning a payload to every member) ----

    def _snapshot(self) -> tuple:
        """(roster, {rank: addr}) for the CURRENT roster epoch. One cheap
        epoch read per verb; the address fan-fetch reruns only when the
        epoch moved (join/leave/re-register all bump it). Groups that never
        published a roster (pre-elastic callers) fall back to the static
        ``range(world_size)`` world under cache key epoch 0."""
        from ray_tpu_torch.util.collective.p2p import fetch_member_addrs, fetch_roster

        roster = fetch_roster(self.gcs, self.group_name)
        repoch = roster["epoch"] if roster else 0
        cache = self._addr_cache
        if cache is None or cache[0] != repoch:
            ranks = roster["ranks"] if roster else list(range(self.world_size))
            world = max(self.world_size, roster["world_size"] if roster else 0)
            cache = (repoch, fetch_member_addrs(self.gcs, self.group_name, world, ranks=ranks))
            self._addr_cache = cache
        return roster, cache[1]

    def _addrs(self) -> dict:
        return self._snapshot()[1]

    def bcast_send_payload(self, value, tag: str, timeout: float = 30.0,
                           mailbox_fallback: bool = True,
                           topology: str = "tree") -> dict:
        """Holder-side group broadcast: one serialize, acked chunk pushes
        riding the binomial relay tree by default (p2p.group_bcast_send) —
        the fan-out device_object.broadcast() rides. The target set is the
        ROSTER SNAPSHOT at send time (members that joined since init are
        included, departed ones are not), a mid-op rejoiner is retried at
        its fresh address, and unreachable members are evicted into the
        next epoch. Returns the per-rank delivery map; never raises for a
        dead member (the caller owns the policy). ``mailbox_fallback=False``
        when receivers only watch the direct inbox (the
        descriptor-resolution path); ``topology="flat"`` forces the
        per-rank fan-out (an A/B arm)."""
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_bcast_send

        self._check_destroyed("bcast_send_payload")
        cw = worker_context.get_core_worker()
        roster, addrs = self._snapshot()
        world = max(self.world_size, roster["world_size"] if roster else 0)
        return group_bcast_send(
            cw, self.gcs, self.group_name, self.rank, world, tag,
            value, member_addrs=addrs, timeout=timeout,
            mailbox_fallback=mailbox_fallback, topology=topology,
            roster=roster,
        )

    def _finalize_like(self, value, out):
        """Payload-parity for the reducing verbs: a tensor input produces a
        tensor output on its device (the tree combines on the host — numpy
        bytes on the wire — so the root converts back once before handing
        out/broadcasting)."""
        return _like(value, out)

    def reduce_send_payload(self, value, tag: str, op: ReduceOp = ReduceOp.SUM,
                            dst_rank: int = 0, timeout: float = 60.0):
        """Tree reduce toward ``dst_rank`` over the direct-mailbox plane
        (p2p.group_reduce_send): partials combine chunk-wise at every relay
        hop, so no single member ever receives K payloads. Returns the
        reduced value on ``dst_rank`` (same placement as ``value``), None
        elsewhere. The tree spans the roster snapshot at call time. Falls
        back to the GCS ring when any member lacks a registered address
        (old-style members) or the group is trivial (world_size < 2)."""
        self._check_destroyed("reduce_send_payload")
        roster, addrs = self._snapshot()
        ranks = roster["ranks"] if roster else list(range(self.world_size))
        missing = [r for r in ranks if r != self.rank and r not in addrs]
        if len(ranks) < 2 or missing:
            return self.reduce(value, dst_rank, op)
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_reduce_send

        cw = worker_context.get_core_worker()
        out = group_reduce_send(
            cw, self.gcs, self.group_name, self.rank, self.world_size, tag,
            value, op=op, dst_rank=dst_rank, member_addrs=addrs, timeout=timeout,
            roster=roster,
        )
        if out is None:
            return None
        return self._finalize_like(value, out)

    def allreduce_payload(self, value, tag: str, op: ReduceOp = ReduceOp.SUM,
                          timeout: float = 60.0):
        """Tree allreduce (reduce up to rank 0, tree-broadcast back down):
        every rank returns the same reduced value, placed like ``value``
        (the root finalizes ONCE before the down-broadcast). Ring fallback
        under the same conditions as :meth:`reduce_send_payload`."""
        self._check_destroyed("allreduce_payload")
        roster, addrs = self._snapshot()
        ranks = roster["ranks"] if roster else list(range(self.world_size))
        missing = [r for r in ranks if r != self.rank and r not in addrs]
        if len(ranks) < 2 or missing:
            return self.allreduce(value, op)
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_allreduce

        cw = worker_context.get_core_worker()
        return group_allreduce(
            cw, self.gcs, self.group_name, self.rank, self.world_size, tag,
            value, op=op, member_addrs=addrs, timeout=timeout,
            finalize=lambda reduced: self._finalize_like(value, reduced),
            roster=roster,
        )

    def reducescatter_payload(self, value, tag: str, op: ReduceOp = ReduceOp.SUM,
                              timeout: float = 60.0):
        """Tree reduce-scatter over the direct-mailbox plane
        (p2p.group_reducescatter): partials combine chunk-wise up the tree
        and the root hands each member only ITS reduced slice — O(log K)
        hops and 1/K of the ring's per-member download. Ring contract
        preserved: leading dim == member count; sorted-roster position i
        gets slice i, placed like ``value`` (the root finalizes per shard
        before fanning out). Ring fallback under the same conditions as
        :meth:`reduce_send_payload`."""
        self._check_destroyed("reducescatter_payload")
        roster, addrs = self._snapshot()
        ranks = roster["ranks"] if roster else list(range(self.world_size))
        missing = [r for r in ranks if r != self.rank and r not in addrs]
        if len(ranks) < 2 or missing:
            return self.reducescatter(value, op)
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_reducescatter

        cw = worker_context.get_core_worker()
        return group_reducescatter(
            cw, self.gcs, self.group_name, self.rank, self.world_size, tag,
            value, op=op, member_addrs=addrs, timeout=timeout,
            finalize=lambda shard: self._finalize_like(value, shard),
            roster=roster,
        )

    def bcast_recv_payload(self, src_rank: int, tag: str, timeout: float = 120.0):
        """Member-side receive of a group broadcast (direct mailbox, GCS
        fallback, typed timeout naming group/rank/tag). A concurrent
        destroy of this group aborts the wait with a typed CollectiveError
        instead of parking until the deadline."""
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_bcast_recv

        self._check_destroyed("bcast_recv_payload")
        cw = worker_context.get_core_worker()
        return group_bcast_recv(
            cw, self.gcs, self.group_name, src_rank, self.rank, tag, timeout,
            abort_check=lambda: self._destroyed,
        )

    def destroy(self):
        from ray_tpu_torch.util.collective.p2p import (
            roster_leave,
            sweep_group_kv,
            unregister_member_addr,
        )

        self._destroyed = True
        try:
            roster_leave(self.gcs, self.group_name, self.rank)
        except Exception:
            pass
        unregister_member_addr(self.gcs, self.group_name, self.rank)
        if self.rank == 0:
            # Rank 0 (conventionally the driver/learner side, destroyed
            # last in the gang-teardown idiom) sweeps the group's KV back
            # to baseline: repoch + roster back-window + every addr row.
            try:
                sweep_group_kv(self.gcs, self.group_name, self.world_size)
            except Exception:
                pass
