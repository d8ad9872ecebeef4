"""NCCL collective group — a torch.distributed process group per named group.

Replaces the JAX package's XLA world (``ray_tpu/util/collective/tpu_group.py``)
and is the counterpart of the reference's NCCLGroup
(python/ray/util/collective/collective_group/nccl_collective_group.py:127):

- rendezvous: rank 0 starts a ``TCPStore`` and publishes its address in the
  GCS KV under an epoch-scoped key (the reference's Rendezvous-via-named-store
  pattern, nccl_collective_group.py:28; ``tpu_group.py:159-216``); every
  member dials it;
- each member builds its OWN process group on ``PrefixStore(group, store)``
  — ``ProcessGroupNCCL`` on CUDA tensors, ``ProcessGroupGloo`` on CPU ones.
  The default process group is never touched: a ``TorchTrainer`` worker
  already owns it (``train/torch/config.py``), and one process may hold any
  number of named groups;
- collectives are SPMD: every member must call the same op in the same
  order, the contract NCCL imposes.

NCCL takes one rank per card: two processes on one card cannot form a
2-rank NCCL group (NCCL reports a duplicate GPU). ``backend="gloo"`` is the
same class on CPU tensors, which is how it runs where there is no card.
A world-1 group needs no rendezvous: its store is a local ``HashStore``.
"""

from __future__ import annotations

import collections
import logging
import socket
import time

from ray_tpu_torch.util.collective.types import ReduceOp

logger = logging.getLogger(__name__)

# Highest collective-group epoch this process has participated in, per group
# name: a member re-forming a group after destroy must not accept the dead
# epoch's store address from the KV (fresh processes start at 0 and accept
# the current epoch).
_last_epochs: dict = {}


def _epoch_key(group_name: str) -> str:
    return f"collective/{group_name}/epoch"


def _coord_key(group_name: str, epoch: int) -> str:
    return f"collective/{group_name}/coord/{epoch}"


class NcclCollectiveGroup:
    """One member's view of a torch.distributed group."""

    def __init__(
        self,
        group_name: str,
        world_size: int,
        rank: int,
        backend: str = "nccl",
        coordinator: str | None = None,
        gcs=None,
        node_ip: str | None = None,
    ):
        import datetime

        import torch
        import torch.distributed as dist

        from ray_tpu_torch._private.config import get_config

        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend='nccl' needs a CUDA device in this process; use backend='gloo' "
                    "for CPU tensors or 'cpu' for the host ring"
                )
            self.device = torch.device("cuda", torch.cuda.current_device())
        elif backend == "gloo":
            self.device = torch.device("cpu")
        else:
            raise ValueError(f"NcclCollectiveGroup backend must be 'nccl' or 'gloo', got {backend!r}")
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.epoch = 0
        self._gcs = gcs
        self._node_ip = node_ip
        self._bcast_addrs = None
        # The n-th send of a tag to a peer pairs with its n-th receive.
        self._p2p_counts = collections.Counter()
        timeout = datetime.timedelta(seconds=get_config().collective_rendezvous_timeout_s)
        if world_size > 1:
            self._store = self._rendezvous(gcs, coordinator, timeout)
        else:
            self._store = dist.HashStore()
        # Every epoch has a store of its own (rank 0 starts a new one), so
        # the group's name alone scopes its keys.
        prefix = dist.PrefixStore(group_name, self._store)
        if backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self.pg = dist.ProcessGroupNCCL(prefix, rank, world_size, opts)
        else:
            self.pg = dist.ProcessGroupGloo(prefix, rank, world_size, timeout)
        logger.info("collective group %s: %s rank %d/%d on %s", group_name, backend, rank, world_size, self.device)

    # ---- rendezvous via GCS KV (reference: Rendezvous in
    # nccl_collective_group.py:28, unique id in a named store actor) ----

    def _rendezvous(self, gcs, coordinator, timeout):
        """Rank 0 starts the TCPStore and advertises ``<node-ip>:<port>``
        under an epoch-scoped KV key; members poll the epoch counter, then
        the address for that epoch. The epoch bump is what lets a destroyed
        group re-form under the same name: a member never dials a dead
        epoch's store, and a stale key from a crashed rank 0 fails the
        liveness probe until a newer epoch supersedes it."""
        import torch.distributed as dist

        from ray_tpu_torch._private.config import get_config

        host = self._node_ip if self._node_ip not in (None, "", "0.0.0.0") else "127.0.0.1"
        if self.rank == 0:
            if gcs is None:
                raise ValueError("a multi-process collective group needs the GCS for its rendezvous")
            # Port 0: the store binds a free port itself (no pick-then-bind race).
            store = dist.TCPStore(host, 0, self.world_size, is_master=True,
                                  wait_for_workers=False, timeout=timeout)
            resp = gcs.call("kv_get", {"key": _epoch_key(self.group_name)})
            epoch = int(bytes(resp["value"]).decode()) + 1 if resp.get("found") else 1
            gcs.call("kv_put", {"key": _coord_key(self.group_name, epoch), "value": f"{host}:{store.port}".encode()})
            gcs.call("kv_put", {"key": _epoch_key(self.group_name), "value": str(epoch).encode()})
            self.epoch = epoch
            _last_epochs[self.group_name] = epoch
            return store
        if coordinator is None:
            assert gcs is not None, "GCS client required for multi-process rendezvous"
            coordinator = self._find_coordinator(gcs, get_config().collective_rendezvous_timeout_s)
        chost, cport = coordinator.rsplit(":", 1)
        return dist.TCPStore(chost, int(cport), self.world_size, is_master=False, timeout=timeout)

    def _find_coordinator(self, gcs, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        last_seen = _last_epochs.get(self.group_name, 0)
        candidate = None  # (epoch, address)
        while time.monotonic() < deadline:
            resp = gcs.call("kv_get", {"key": _epoch_key(self.group_name)})
            if resp.get("found"):
                epoch = int(bytes(resp["value"]).decode())
                if epoch > (candidate[0] if candidate else last_seen):
                    coord = gcs.call("kv_get", {"key": _coord_key(self.group_name, epoch)})
                    if coord.get("found"):
                        candidate = (epoch, bytes(coord["value"]).decode())
            if candidate is not None:
                # Liveness probe: a stale key from a crashed rank 0 (whose
                # destroy never ran) must not block the init on a dead
                # endpoint; a refused connect means "keep polling".
                host, port = candidate[1].rsplit(":", 1)
                try:
                    socket.create_connection((host, int(port)), timeout=0.25).close()
                    self.epoch = candidate[0]
                    _last_epochs[self.group_name] = candidate[0]
                    return candidate[1]
                except OSError:
                    pass
            time.sleep(0.05)
        raise TimeoutError(f"collective rendezvous for group {self.group_name} timed out")

    # ---- helpers ----

    def _tensor(self, x):
        """(a tensor of x on this group's device, how to hand results back)."""
        import numpy as np
        import torch

        from ray_tpu_torch._private.serialization import is_tensor

        if is_tensor(x):
            return x.to(self.device), x.device
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device), None

    @staticmethod
    def _out(t, like):
        return t.to(like) if like is not None else t.cpu().numpy()

    def _allreduce_(self, t, op: ReduceOp):
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        # MEAN: summed, divided once below (gloo has no AVG).
        opts.reduceOp = dist.ReduceOp.SUM if op is ReduceOp.MEAN else self._dist_op(op)
        self.pg.allreduce([t], opts).wait()
        if op is ReduceOp.MEAN:
            t.div_(self.world_size)
        return t

    # ---- collectives (API parity with collective.py:258-594) ----

    def allreduce(self, x, op: ReduceOp = ReduceOp.SUM):
        t, like = self._tensor(x)
        return self._out(self._allreduce_(t.clone(), op), like)

    def allgather(self, x):
        """Returns the (world, *shape) stack of every rank's tensor."""
        import torch

        t, like = self._tensor(x)
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.world_size)]
        self.pg.allgather([outs], [t]).wait()
        return self._out(torch.stack(outs), like)

    def reducescatter(self, x, op: ReduceOp = ReduceOp.SUM):
        """x: this rank's (world, chunk) stacked input; returns this rank's
        reduced chunk (x[rank] reduced over ranks)."""
        import torch
        import torch.distributed as dist

        t, like = self._tensor(x)
        assert t.shape[0] == self.world_size, "leading dim must equal world size"
        out = torch.empty_like(t[0])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = dist.ReduceOp.SUM if op is ReduceOp.MEAN else self._dist_op(op)
        self.pg.reduce_scatter([out], [[c.contiguous() for c in t.unbind(0)]], opts).wait()
        if op is ReduceOp.MEAN:
            out.div_(self.world_size)
        return self._out(out, like)

    @staticmethod
    def _dist_op(op: ReduceOp):
        import torch.distributed as dist

        return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
                ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX}[op]

    def broadcast(self, x, src_rank: int = 0):
        import torch.distributed as dist

        t, like = self._tensor(x)
        t = t.clone().contiguous()
        opts = dist.BroadcastOptions()
        opts.rootRank = src_rank
        self.pg.broadcast([t], opts).wait()
        return self._out(t, like)

    def reduce(self, x, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM):
        # As the JAX package's group does: allreduce, and the other ranks
        # drop the value.
        out = self.allreduce(x, op)
        return out if self.rank == dst_rank else None

    def barrier(self):
        import torch

        self._allreduce_(torch.zeros((1,), dtype=torch.float32, device=self.device), ReduceOp.SUM)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def send_recv(self, x, perm: list[tuple[int, int]]):
        """ppermute: pairwise exchange (the p2p primitive — reference
        collective.py:531/594 send/recv). Returns the tensor sent to this
        rank, or x when none is."""
        import torch

        t, like = self._tensor(x)
        t = t.contiguous()
        out = None
        works = []
        for src, dst in perm:
            if src == dst == self.rank:
                out = t.clone()
            elif src == self.rank:
                works.append(self.pg.send([t], dst, 0))
            elif dst == self.rank:
                out = torch.empty_like(t)
                works.append(self.pg.recv([out], src, 0))
        for w in works:
            w.wait()
        return self._out(t if out is None else out, like)

    def send(self, value, dst_rank: int, tag: str) -> int:
        """2-party p2p send (reference: collective.py:531) of an
        out-of-band object over the host plane (p2p.group_send); a CUDA
        tensor lands back on its device index."""
        from ray_tpu_torch.util.collective.p2p import group_send

        _, addrs = self._snapshot()
        return group_send(self._gcs, self.group_name, self.rank, dst_rank, tag, value,
                          addr=addrs.get(dst_rank), counts=self._p2p_counts)

    def recv(self, src_rank: int, tag: str, timeout: float = 120.0):
        """2-party p2p recv (reference: collective.py:594)."""
        from ray_tpu_torch.util.collective.p2p import group_recv

        return group_recv(self._gcs, self.group_name, src_rank, self.rank, tag, timeout,
                          counts=self._p2p_counts)

    # ---- group payload verbs (device_object broadcast/reduce seam) ----
    #
    # As in the JAX package's group: an out-of-band payload fans out over
    # the host plane (one serialize, acked chunk pushes down the relay
    # tree), and the reducing verbs map onto the group's own collectives
    # (every holder's tensor is already on this group's device).

    def bcast_send_payload(self, value, tag: str, timeout: float = 30.0,
                           mailbox_fallback: bool = True) -> dict:
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_bcast_send

        cw = worker_context.get_core_worker()
        roster, addrs = self._snapshot()
        world = max(self.world_size, roster["world_size"] if roster else 0)
        return group_bcast_send(
            cw, self._gcs, self.group_name, self.rank, world, tag,
            value, member_addrs=addrs, timeout=timeout,
            mailbox_fallback=mailbox_fallback, roster=roster,
        )

    def _snapshot(self) -> tuple:
        """(roster, {rank: addr}), the address cache keyed on the ROSTER
        epoch: a member that re-registered under its old rank has a new
        address under the same row, and only a roster bump says so."""
        from ray_tpu_torch.util.collective.p2p import fetch_member_addrs, fetch_roster

        if self._gcs is None:
            return None, {}
        roster = fetch_roster(self._gcs, self.group_name)
        repoch = roster["epoch"] if roster else 0
        if self._bcast_addrs is None or self._bcast_addrs[0] != repoch:
            world = max(self.world_size, roster["world_size"] if roster else 0)
            ranks = roster["ranks"] if roster else None
            self._bcast_addrs = (repoch, fetch_member_addrs(self._gcs, self.group_name, world, ranks=ranks))
        return roster, self._bcast_addrs[1]

    def bcast_recv_payload(self, src_rank: int, tag: str, timeout: float = 120.0):
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util.collective.p2p import group_bcast_recv

        cw = worker_context.get_core_worker()
        return group_bcast_recv(cw, self._gcs, self.group_name, src_rank, self.rank, tag, timeout)

    def reduce_send_payload(self, value, tag: str, op: ReduceOp = ReduceOp.SUM,
                            dst_rank: int = 0, timeout: float = 60.0):
        """Out-of-band group reduce: the group's own reduce. ``tag`` and
        ``timeout`` are accepted for parity with the host ring's seam."""
        return self.reduce(value, dst_rank, op)

    def allreduce_payload(self, value, tag: str, op: ReduceOp = ReduceOp.SUM,
                          timeout: float = 60.0):
        return self.allreduce(value, op)

    def destroy(self):
        """Tear the process group down so the group can re-form (gang
        restart): shut the backend down, leave the roster, and, on rank 0,
        sweep this epoch's store address and the dead-epoch rows behind it.
        The next init under the same name bumps the epoch."""
        try:
            self.pg.shutdown()
        except Exception as e:  # already down
            logger.debug("process group shutdown: %s", e)
        self.pg = None
        self._store = None
        if self._gcs is None:
            return
        from ray_tpu_torch.util.collective.p2p import roster_leave, sweep_group_kv, unregister_member_addr

        try:
            roster_leave(self._gcs, self.group_name, self.rank)
        except Exception:
            pass
        unregister_member_addr(self._gcs, self.group_name, self.rank)
        if self.world_size > 1 and self.rank == 0:
            for e in range(max(1, self.epoch - 16), self.epoch + 1):
                try:
                    self._gcs.call("kv_del", {"key": _coord_key(self.group_name, e)})
                except Exception:
                    pass
            try:
                sweep_group_kv(self._gcs, self.group_name, self.world_size)
            except Exception:
                pass
