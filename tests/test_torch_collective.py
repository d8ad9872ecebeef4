"""The port's collectives (``ray_tpu_torch.util.collective``) on the CPU.

The host ring group (backend "cpu") over 3 actors runs every verb — the ring
collectives, reduce, barrier, send/recv, send_recv and the tree payload verbs
— on the same seeded numpy inputs as the JAX package's group over 3 of its
actors: f32 results equal the reference's bit for bit (the same host math in
the same order), numpy in and numpy out, and tensors in give tensors out with
the same bits. Then the elastic cases of ``tests/test_collective_elastic.py``
that need no chaos plane, and the torch.distributed group on gloo over 2
actors, destroyed and re-formed under the same name.

The module boots one JAX cluster (computes the reference, shuts it down)
and one port cluster; ~25 s here.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import CollectiveError

WORLD = 3


def _inputs(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {
        "vec": rng.standard_normal(64).astype(np.float32),
        "pos": (rng.random(64) + 0.5).astype(np.float32),
        "stack": rng.standard_normal((WORLD, 16)).astype(np.float32),
        "big": rng.standard_normal(300_000).astype(np.float32),  # 1.2 MB: several 512 KiB chunks
    }


class _Member:
    """One rank: every verb in one fixed order (SPMD), through ``pkg``'s
    collective module; ``tensors`` feeds torch tensors instead of numpy."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.col = importlib.import_module(f"{pkg}.util.collective")

    def init_collective(self, world_size, rank, backend, group_name):
        self.col.init_collective_group(world_size, rank, backend=backend, group_name=group_name)
        self.rank = rank
        return rank

    def run_all(self, group, tensors=False):
        sfx = "t" if tensors else "n"  # tree verbs take a fresh tag per operation
        col = self.col
        op = col.ReduceOp
        x = _inputs(self.rank)
        if tensors:
            x = {k: torch.from_numpy(v) for k, v in x.items()}
        g = col.get_group(group)
        out = {
            "allreduce_sum": col.allreduce(x["vec"], group),
            "allreduce_mean": col.allreduce(x["vec"], group, op.MEAN),
            "allreduce_max": col.allreduce(x["vec"], group, op.MAX),
            "allreduce_prod": col.allreduce(x["pos"], group, op.PRODUCT),
            "broadcast": col.broadcast(x["vec"], 1, group),
            "allgather": col.allgather(x["vec"], group),
            "reducescatter": col.reducescatter(x["stack"], group),
            "reduce": col.reduce(x["vec"], 0, group),
        }
        col.barrier(group)
        if self.rank == 0:
            col.send(x["vec"], 2, group, tag="t0")
        elif self.rank == 2:
            out["recv"] = col.recv(0, group, tag="t0")
        out["send_recv"] = col.send_recv(x["vec"], [(0, 1), (1, 2), (2, 0)], group)
        if self.rank == 0:
            g.bcast_send_payload(x["big"], "b0" + sfx, timeout=30)
            out["bcast_payload"] = x["big"]
        else:
            out["bcast_payload"] = g.bcast_recv_payload(0, "b0" + sfx, timeout=30)
        out["tree_allreduce"] = g.allreduce_payload(x["big"], "a0" + sfx)
        out["tree_reduce"] = g.reduce_send_payload(x["vec"], "r0" + sfx, dst_rank=0)
        out["tree_reducescatter"] = g.reducescatter_payload(x["stack"], "s0" + sfx)
        kinds = {k: type(v).__name__ for k, v in out.items() if v is not None}
        host = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items() if v is not None}
        return host, kinds


JMember = ray_tpu.remote(_Member)
TMember = rt.remote(_Member)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def reference():
    """Every rank's results from the JAX package's host ring group."""
    from ray_tpu.util import collective as jcol

    ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        members = [JMember.remote("ray_tpu") for _ in range(WORLD)]
        jcol.create_collective_group(members, backend="cpu", group_name="ring")
        got = ray_tpu.get([m.run_all.remote("ring") for m in members], timeout=180)
        # Copies: the results are views of the cluster's shared memory.
        return [{k: np.array(v) for k, v in host.items()} for host, _ in got]
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture(scope="module")
def ring(cluster):
    from ray_tpu_torch.util import collective as col

    members = [TMember.remote("ray_tpu_torch") for _ in range(WORLD)]
    col.create_collective_group(members, backend="cpu", group_name="ring")
    return members


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensors"])
def test_cpu_group_equals_the_reference_bit_for_bit(reference, ring, tensors):
    got = rt.get([m.run_all.remote("ring", tensors) for m in ring], timeout=180)
    for rank, ((host, kinds), want) in enumerate(zip(got, reference)):
        assert sorted(host) == sorted(want), rank
        for name in want:
            assert _same_bits(host[name], want[name]), (rank, name)
        expected = "Tensor" if tensors else "ndarray"
        assert set(kinds.values()) == {expected}, (rank, kinds)
    # Sanity of the values themselves, beyond agreement.
    x = [_inputs(r) for r in range(WORLD)]
    np.testing.assert_allclose(reference[1]["allreduce_sum"], sum(i["vec"] for i in x), rtol=1e-6)
    assert _same_bits(reference[2]["recv"], x[0]["vec"])
    assert _same_bits(reference[1]["bcast_payload"], x[0]["big"])
    assert reference[1]["tree_reducescatter"].shape == (16,)


def test_tpu_backend_raises():
    from ray_tpu_torch.util.collective.types import Backend

    with pytest.raises(ValueError, match="nccl"):
        Backend.validate("tpu")
    assert Backend.validate("gloo") == "gloo" and Backend.validate("nccl") == "nccl"
    assert Backend.validate("cpu") == "cpu"


# ---------------------------------------------------------------------------
# The elastic cases of tests/test_collective_elastic.py that need no chaos.
# ---------------------------------------------------------------------------


def _gcs():
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker().gcs


@rt.remote
class Member:
    def pid(self):
        return os.getpid()

    def init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend=backend, group_name=group_name)
        return rank

    def bcast_recv(self, group_name, src_rank, tag, timeout=30.0):
        from ray_tpu_torch.util import collective as col

        out = col.get_group(group_name).bcast_recv_payload(src_rank, tag, timeout=timeout)
        return float(out.sum())

    def destroy_group(self, group_name):
        from ray_tpu_torch.util import collective as col

        col.destroy_collective_group(group_name)
        return True

    def destroy_race(self, group_name):
        """Park in bcast_recv_payload on a tag nobody sends, destroy the
        group 0.5 s later, and report how the wait ended."""
        import threading

        from ray_tpu_torch.util import collective as col

        g = col.get_group(group_name)
        out = {}

        def _recv():
            t0 = time.monotonic()
            try:
                g.bcast_recv_payload(0, "never-sent", timeout=60.0)
                out["recv"] = "no-error"
            except CollectiveError as e:
                out["recv"] = f"typed:{type(e).__name__}:{e}"
            except Exception as e:
                out["recv"] = f"raw:{type(e).__name__}"
            out["elapsed"] = time.monotonic() - t0

        th = threading.Thread(target=_recv, daemon=True)
        th.start()
        time.sleep(0.5)
        col.destroy_collective_group(group_name)
        th.join(timeout=30)
        out["joined"] = not th.is_alive()
        try:
            g.bcast_send_payload(torch.zeros(4), "after-destroy")
            out["send"] = "no-error"
        except CollectiveError as e:
            out["send"] = f"typed:{type(e).__name__}"
        return out

    def gloo_allreduce(self, group_name):
        from ray_tpu_torch.util import collective as col

        g = col.get_group(group_name)
        out = col.allreduce(torch.full((4,), float(g.rank + 1)), group_name)
        return out.tolist(), str(out.device), g.epoch


def test_roster_join_leave_rejoin_epochs(cluster):
    from ray_tpu_torch.util.collective import p2p

    gcs, group = _gcs(), "rg-unit"
    try:
        assert p2p.roster_join(gcs, group, 0, world_size=2) == 1
        assert p2p.roster_join(gcs, group, 1, world_size=2) == 2
        assert p2p.fetch_roster(gcs, group) == {"epoch": 2, "ranks": [0, 1], "world_size": 2}
        assert p2p.roster_leave(gcs, group, 1) == 3
        assert p2p.fetch_roster(gcs, group)["ranks"] == [0]
        # Re-register at a listed rank still bumps the epoch (drops peers' address caches).
        assert p2p.roster_join(gcs, group, 0, world_size=2) == 4
        assert p2p.fetch_roster(gcs, group)["ranks"] == [0]
        assert p2p.roster_leave(gcs, group, 7) is None
        assert p2p.fetch_roster_epoch(gcs, group) == 4
    finally:
        p2p.sweep_group_kv(gcs, group, world_size=2)
    assert p2p.fetch_roster(gcs, group) is None
    assert p2p.fetch_roster_epoch(gcs, group) == 0


def test_group_kv_rows_return_to_baseline_after_destroy(cluster):
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import p2p

    gcs, group = _gcs(), "kvbase2"
    keys = ([p2p.roster_epoch_key(group)] + [p2p.roster_key(group, e) for e in range(1, 9)]
            + [p2p.member_addr_key(group, r) for r in range(2)])

    def count():
        return sum(1 for k in keys if gcs.call("kv_get", {"key": k}).get("found"))

    assert count() == 0
    m = Member.remote()
    col.init_collective_group(2, 0, backend="cpu", group_name=group)
    rt.get(m.init_collective.remote(2, 1, "cpu", group), timeout=60)
    pending = m.bcast_recv.remote(group, 0, "t1", 30.0)
    info = col.get_group(group).bcast_send_payload(torch.ones(512), "t1", timeout=30)
    assert info["ok_ranks"] == [1], info
    assert rt.get(pending, timeout=60) == 512.0
    assert count() >= 3
    rt.get(m.destroy_group.remote(group), timeout=60)
    col.destroy_collective_group(group)
    assert count() == 0


def test_broadcast_evicts_dead_rank_and_rejoiner_rides_fast_path(cluster):
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util.collective import p2p

    gcs, group = _gcs(), "elastic3"
    a, b = Member.remote(), Member.remote()
    col.init_collective_group(3, 0, backend="cpu", group_name=group)
    try:
        rt.get([a.init_collective.remote(3, 1, "cpu", group), b.init_collective.remote(3, 2, "cpu", group)], timeout=60)
        pid_b = rt.get(b.pid.remote(), timeout=60)
        g = col.get_group(group)
        payload = torch.ones(256)
        pend = [a.bcast_recv.remote(group, 0, "t1"), b.bcast_recv.remote(group, 0, "t1")]
        info = g.bcast_send_payload(payload, "t1", timeout=30)
        assert sorted(info["ok_ranks"]) == [1, 2], info
        assert rt.get(pend, timeout=60) == [256.0, 256.0]
        epoch_before = p2p.fetch_roster_epoch(gcs, group)

        rt.kill(b)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                os.kill(pid_b, 0)
                time.sleep(0.1)
            except ProcessLookupError:
                break
        else:
            pytest.fail("victim worker process survived kill()")
        pend = a.bcast_recv.remote(group, 0, "t2")
        info = g.bcast_send_payload(payload, "t2", timeout=10)
        assert info["ok_ranks"] == [1] and 2 in info["failed"], info
        assert info["evicted_ranks"] == [2], info
        assert rt.get(pend, timeout=60) == 256.0
        snap = p2p.fetch_roster(gcs, group)
        assert snap["ranks"] == [0, 1] and snap["epoch"] > epoch_before, snap

        pend = a.bcast_recv.remote(group, 0, "t3")
        info = g.bcast_send_payload(payload, "t3", timeout=10)
        assert info["ok_ranks"] == [1] and info["failed"] == {}, info
        assert info["roster_epoch"] == snap["epoch"], info
        assert rt.get(pend, timeout=60) == 256.0

        c = Member.remote()
        rt.get(c.init_collective.remote(3, 2, "cpu", group), timeout=60)
        assert p2p.fetch_roster(gcs, group)["ranks"] == [0, 1, 2]
        pend = [a.bcast_recv.remote(group, 0, "t4"), c.bcast_recv.remote(group, 0, "t4")]
        info = g.bcast_send_payload(payload, "t4", timeout=30)
        assert sorted(info["ok_ranks"]) == [1, 2] and info["failed"] == {}, info
        assert rt.get(pend, timeout=60) == [256.0, 256.0]
    finally:
        col.destroy_collective_group(group)


def test_destroy_racing_bcast_recv_raises_typed_never_hangs(cluster):
    m = Member.remote()
    rt.get(m.init_collective.remote(2, 1, "cpu", "race2"), timeout=60)
    out = rt.get(m.destroy_race.remote("race2"), timeout=90)
    assert out["joined"], out
    assert out["recv"].startswith("typed:CollectiveError") and "destroyed" in out["recv"], out
    assert out["elapsed"] < 30, out
    assert out["send"] == "typed:CollectiveError", out


def test_gloo_group_destroy_and_reform(cluster):
    """backend="gloo": a torch.distributed group of 2 actors on CPU tensors
    (the NCCL group's class), rendezvousing in the GCS KV; destroyed and
    re-formed under the same name with the next epoch."""
    from ray_tpu_torch.util import collective as col

    members = [Member.remote() for _ in range(2)]
    col.create_collective_group(members, backend="gloo", group_name="reform")
    outs = rt.get([m.gloo_allreduce.remote("reform") for m in members], timeout=120)
    assert [o[:2] for o in outs] == [([3.0] * 4, "cpu")] * 2
    epoch = outs[0][2]
    assert epoch >= 1 and outs[1][2] == epoch
    rt.get([m.destroy_group.remote("reform") for m in members], timeout=60)
    col.create_collective_group(members, backend="gloo", group_name="reform")
    outs = rt.get([m.gloo_allreduce.remote("reform") for m in members], timeout=120)
    assert [o[:2] for o in outs] == [([3.0] * 4, "cpu")] * 2
    assert {o[2] for o in outs} == {epoch + 1}
    with pytest.raises(RuntimeError, match="CUDA"):
        from ray_tpu_torch.util.collective.nccl_group import NcclCollectiveGroup

        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        NcclCollectiveGroup("nocard", 1, 0, backend="nccl")


def test_send_to_unregistered_rank_raises(cluster):
    """A group's send/recv has one transport, the direct mailbox: a send to
    a rank that never registered its address raises naming that rank (no
    quiet GCS-KV post), and a recv nobody sends to raises the typed timeout
    naming the source rank and the tag."""
    from ray_tpu_torch.exceptions import CollectiveTimeoutError
    from ray_tpu_torch.util import collective as col

    group = "half"
    col.init_collective_group(2, 0, backend="cpu", group_name=group)
    try:
        with pytest.raises(CollectiveError, match="rank 1 has no registered address"):
            col.send(np.zeros(4, np.float32), 1, group, tag="t")
        t0 = time.monotonic()
        with pytest.raises(CollectiveTimeoutError, match="from rank 1") as e:
            col.recv(1, group, tag="t", timeout=0.5)
        assert e.value.ranks == [1] and e.value.tag == "t"
        assert time.monotonic() - t0 < 5
    finally:
        col.destroy_collective_group(group)
