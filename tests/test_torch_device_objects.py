"""The port's device-object plane (``ray_tpu_torch.experimental.device_object``)
on the CPU, against the JAX package's.

One scenario runs in both runtimes on the same seeded values: put/get in the
driver under ``tensor_transport="collective"`` (the live value back), an
actor holder read by a consumer over a shared group (the p2p path), one
group ``broadcast`` to two consumers, an in-place group ``allreduce`` of two
holders' objects, spill and restore under ``devobj_resident_limit_bytes``,
and a holder's death (``DeviceObjectLostError`` naming it). After each step
every process's ``DEVOBJ_STATS`` delta must equal the reference's (``frees``
is left out: it follows the owner's garbage collection, not the step), and
every value the port returns must equal the reference's bit for bit. A
holder counts its p2p send after the send returns, on an executor thread,
so the consumer's read may return first: each snapshot waits (bounded)
until the counters hold still. Then
the port alone: the same ``data_ptr`` in the holder, CPU tensors stay
resident, and a DTensor is refused naming ROADMAP A9f.

The module boots one JAX cluster (runs the scenario, shuts it down) and one
port cluster; ~30 s here.
"""

import importlib
import os
import signal
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt

COMPARED = ("creates", "spills", "restores", "transfers_local", "transfers_collective", "transfers_host",
            "chan_sends", "chan_recvs")


def _value(pkg: str, n: int, fill=None):
    """arange(n) (or n copies of ``fill``) as the package's device value."""
    host = np.arange(float(n), dtype=np.float32) if fill is None else np.full(n, fill, np.float32)
    if pkg == "ray_tpu":
        import jax.numpy as jnp

        return jnp.asarray(host)
    return torch.from_numpy(host)


def _host(v) -> np.ndarray:
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)


class _Actor:
    """A group member that holds and reads device objects of ``pkg``."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.rt = importlib.import_module(pkg)

    def pid(self):
        return os.getpid()

    def init_collective(self, world_size, rank, backend, group_name):
        col = importlib.import_module(f"{self.pkg}.util.collective")
        col.init_collective_group(world_size, rank, backend=backend, group_name=group_name)

    def make(self, n, fill=None):
        return _value(self.pkg, n, fill)

    def read(self, refs):
        return _host(self.rt.get(refs[0], timeout=60))

    def stats(self):
        return importlib.import_module(f"{self.pkg}.experimental.device_object").device_object_stats()


def _driver_stats(pkg):
    return importlib.import_module(f"{pkg}.experimental.device_object").device_object_stats()


def scenario(pkg: str) -> tuple[list, list]:
    """The steps above through ``pkg``; returns (per-step stats deltas of
    every process, values read)."""
    r = importlib.import_module(pkg)
    col = importlib.import_module(f"{pkg}.util.collective")
    dobj = importlib.import_module(f"{pkg}.experimental.device_object")
    config = importlib.import_module(f"{pkg}._private.config")
    exceptions = importlib.import_module(f"{pkg}.exceptions")
    Holder = r.remote(tensor_transport="collective")(_Actor)
    h1, c1, c2, h2 = (Holder.remote(pkg) for _ in range(4))
    procs = [h1, c1, c2, h2]
    col.create_collective_group([h1, c1, c2], backend="cpu", group_name="g")
    col.create_collective_group([h1, h2], backend="cpu", group_name="red")

    def snap():
        return [_driver_stats(pkg)] + r.get([p.stats.remote() for p in procs], timeout=60)

    def settled_snap(timeout_s=20.0, quiet_s=0.25):
        """A snapshot once no compared counter of any process has moved for
        `quiet_s`: a holder's send is counted after the consumer may have
        its value."""
        deadline = time.monotonic() + timeout_s
        now = snap()
        while True:
            time.sleep(quiet_s)
            again = snap()
            if [{k: s[k] for k in COMPARED} for s in again] == [{k: s[k] for k in COMPARED} for s in now]:
                return again
            if time.monotonic() > deadline:
                pytest.fail(f"{pkg}: the device-object counters still move after {timeout_s} s: {now} -> {again}")
            now = again

    deltas, values = [], []
    last = settled_snap()

    def step():
        nonlocal last
        now = settled_snap()
        deltas.append([{k: b[k] - a[k] for k in COMPARED} for a, b in zip(last, now)])
        last = now

    # 1. Same process: the live value.
    x = _value(pkg, 64)
    ref = r.put(x, tensor_transport="collective")
    values.append(_host(r.get(ref)))
    assert r.get(ref) is x
    step()
    # 2. An actor holder read by a consumer over the shared group "g".
    ra = h1.make.remote(300_000)
    values.append(r.get(c1.read.remote([ra]), timeout=120))
    step()
    # 3. One broadcast over "g", then both consumers read it.
    rb = h1.make.remote(1000, 7.0)
    info = dobj.broadcast(rb, "g", timeout=60)
    assert sorted(info["ok_ranks"]) == [1, 2], info
    values += r.get([c1.read.remote([rb]), c2.read.remote([rb])], timeout=120)
    step()
    # 4. In-place allreduce of h1's and h2's objects over "red".
    r1, r2 = h1.make.remote(500, 1.0), h2.make.remote(500, 2.0)
    dobj.allreduce([r1, r2], "red", timeout=60)
    values += r.get([h1.read.remote([r1]), h2.read.remote([r2])], timeout=60)
    step()
    # 5. Spill and restore in the driver.
    cfg = config.get_config()
    cfg.devobj_resident_limit_bytes = 6000
    try:
        s1 = r.put(_value(pkg, 1000, 1.0), tensor_transport="collective")
        s2 = r.put(_value(pkg, 1000, 2.0), tensor_transport="collective")
        values += [_host(r.get(s1)), _host(r.get(s2))]
    finally:
        cfg.devobj_resident_limit_bytes = 0
    step()
    # 6. The holder of r2 dies: the loss names it.
    os.kill(r.get(h2.pid.remote()), signal.SIGKILL)
    procs.remove(h2)
    time.sleep(0.5)
    with pytest.raises(exceptions.DeviceObjectLostError) as err:
        r.get(r2, timeout=60)
    assert h2._actor_id[:16] in str(err.value)
    last = [last[i] for i in range(4)]  # h2's column is gone
    step()
    for p in procs:
        r.kill(p)
    return deltas, values


@pytest.fixture(scope="module")
def reference():
    ray_tpu.init(num_cpus=6, object_store_memory=128 * 1024 * 1024)
    try:
        return scenario("ray_tpu")
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=6, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


def test_scenario_stats_and_values_equal_the_reference(reference, cluster):
    deltas, values = scenario("ray_tpu_torch")
    want_deltas, want_values = reference
    assert [len(s) for s in deltas] == [len(s) for s in want_deltas]
    names = ("this process", "h1", "c1", "c2", "h2")  # each step's columns, in order
    differ = [f"step {i + 1}, {names[j]}, {k}: {got[k]} against the reference's {want[k]}"
              for i, (steps, want_steps) in enumerate(zip(deltas, want_deltas))
              for j, (got, want) in enumerate(zip(steps, want_steps)) for k in COMPARED if got[k] != want[k]]
    assert not differ, "; ".join(differ)
    assert len(values) == len(want_values)
    for got, want in zip(values, want_values):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # The values themselves: the allreduce summed both holders' objects.
    np.testing.assert_array_equal(values[4], np.full(500, 3.0, np.float32))
    # The p2p path and the broadcast were taken, not the host path.
    assert want_deltas[1][1]["transfers_collective"] == 1 and want_deltas[1][2]["transfers_collective"] == 1
    assert sum(p["transfers_host"] for step in want_deltas[:4] for p in step[1:]) == 0


@rt.remote(tensor_transport="collective")
class Holder:
    def make(self, n):
        self.t = torch.arange(float(n))
        return self.t

    def same_ptr(self, refs):
        return rt.get(refs[0]).data_ptr() == self.t.data_ptr()

    def make_dtensor(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor

        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        return distribute_tensor(torch.ones(4), init_device_mesh("cpu", (1,)))


def test_holder_resolve_is_the_live_tensor(cluster):
    h = Holder.remote()
    ref = h.make.remote(1000)
    assert rt.get(h.same_ptr.remote([ref]), timeout=60)
    assert torch.equal(rt.get(ref, timeout=60), torch.arange(1000.0))
    rt.kill(h)


def test_cpu_tensor_stays_resident_and_dtensor_is_refused(cluster):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.experimental.device_object import device_object_stats

    before = device_object_stats()
    x = torch.ones(8, dtype=torch.bfloat16)
    ref = rt.put(x, tensor_transport="collective")
    assert rt.get(ref).data_ptr() == x.data_ptr()
    assert device_object_stats()["resident_count"] == before["resident_count"] + 1
    with pytest.raises(TypeError, match="torch.Tensor"):
        rt.put(np.zeros(4), tensor_transport="collective")
    with pytest.raises(ValueError, match="tensor_transport"):
        rt.put(x, tensor_transport="nvlink")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        d = distribute_tensor(torch.ones(4), init_device_mesh("cpu", (1,)))
        with pytest.raises(TypeError, match="A9f"):
            rt.put(d, tensor_transport="collective")
    finally:
        dist.destroy_process_group()
    h = Holder.remote()
    with pytest.raises(rt.exceptions.TaskError, match="A9f"):
        rt.get(h.make_dtensor.remote(), timeout=60)
    rt.kill(h)
