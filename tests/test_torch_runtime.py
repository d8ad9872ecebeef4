"""The port's runtime (ray_tpu_torch's copy of GCS, raylet, core worker and
object store) on the CPU: tasks, actors, objects (numpy and tensors, bf16 bit
for bit), typed timeouts, placement groups, kill, and what is not ported
raising. One cluster for the module, always shut down."""

import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


def test_remote_task_and_error(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def boom():
        raise ValueError("boom")

    assert rt.get(add.remote(1, 2)) == 3
    assert rt.get([add.remote(i, i) for i in range(4)]) == [0, 2, 4, 6]
    with pytest.raises(TaskError, match="boom"):
        rt.get(boom.remote())


def test_actor_keeps_state(cluster):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert rt.get([c.inc.remote() for _ in range(3)]) == [11, 12, 13]
    assert rt.get(c.inc.remote(5)) == 18
    rt.kill(c)


@pytest.mark.parametrize("kind", ["numpy", "f32", "bf16", "bf16-big"])
def test_put_get_round_trip(cluster, kind):
    """Inline (small) and shared-memory (large) objects; tensors keep their
    dtype, shape and bits, through the store and through a task."""
    rng = np.random.default_rng(0)
    if kind == "numpy":
        value = rng.standard_normal((64, 33)).astype(np.float32)
    elif kind == "f32":
        value = torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32))
    else:
        n = 512 * 1024 if kind == "bf16-big" else 1000  # 1 MiB: past the inline cutoff
        value = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)

    @rt.remote
    def echo(x):
        return x

    for got in (rt.get(rt.put(value)), rt.get(echo.remote(value))):
        if kind == "numpy":
            np.testing.assert_array_equal(got, value)
            continue
        assert isinstance(got, torch.Tensor) and got.dtype == value.dtype and got.shape == value.shape
        assert torch.equal(got.view(torch.int16) if kind.startswith("bf16") else got,
                           value.view(torch.int16) if kind.startswith("bf16") else value)


def test_get_timeout_is_typed(cluster):
    @rt.remote
    def slow():
        import time

        time.sleep(30)

    ref = slow.remote()
    with pytest.raises(GetTimeoutError):
        rt.get(ref, timeout=0.5)
    rt.cancel(ref, force=True)


def test_placement_group_hosts_an_actor(cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=60)

    @rt.remote(num_cpus=1)
    class Where:
        def pid(self):
            return os.getpid()

    a = Where.options(scheduling_strategy=PlacementGroupSchedulingStrategy(pg, 1)).remote()
    assert rt.get(a.pid.remote(), timeout=60) != os.getpid()
    rt.kill(a)
    remove_placement_group(pg)


def test_parked_placement_group_is_created_when_resources_return(cluster):
    """A group that does not fit waits; once the group holding the resources
    is removed it is created (the GCS retries parked groups when a node's
    resources change, not only when a node joins: two GPU trainers in turn
    on one card otherwise left a third waiting forever)."""
    from ray_tpu_torch.exceptions import PlacementGroupUnavailableError

    holder = placement_group([{"CPU": 4}])
    parked = None
    try:
        assert holder.ready(timeout=60)
        parked = placement_group([{"CPU": 4}])
        with pytest.raises(PlacementGroupUnavailableError):
            parked.ready(timeout=1)
        remove_placement_group(holder)
        assert parked.ready(timeout=30)
    finally:
        for pg in (holder, parked):
            if pg is not None:
                remove_placement_group(pg)


def test_kill_ends_the_actor(cluster):
    @rt.remote
    class Sleeper:
        def ping(self):
            return "pong"

    a = Sleeper.remote()
    assert rt.get(a.ping.remote()) == "pong"
    rt.kill(a)
    # kill() returns before the worker is gone: calls may still land for a
    # moment, then every call must fail with ActorDiedError.
    deadline = time.monotonic() + 30
    with pytest.raises(ActorDiedError):
        while time.monotonic() < deadline:
            rt.get(a.ping.remote(), timeout=10)


def test_kill_during_creation_frees_its_resources(cluster):
    """An actor killed before its worker is up stays dead: the worker exits
    when it comes up and the actor's CPUs return, so an actor needing every
    CPU, queued behind them, starts (ROADMAP C15: the reference's GCS
    revived such an actor, which then held its CPUs with no handle left to
    kill it, and the big actor never started)."""

    @rt.remote(num_cpus=1)
    class Idle:
        def ping(self):
            return "pong"

    total = int(rt.cluster_resources()["CPU"])
    actors = [Idle.remote() for _ in range(2)]
    for a in actors:
        rt.kill(a)
    big = Idle.options(num_cpus=total).remote()
    try:
        assert rt.get(big.ping.remote(), timeout=60) == "pong"
    finally:
        rt.kill(big)
    for a in actors:
        with pytest.raises(ActorDiedError):
            rt.get(a.ping.remote(), timeout=10)


def test_workers_belong_to_the_port(cluster):
    """A worker is started as the port's entry, reads the port's variables,
    and imports nothing of JAX or of ray_tpu."""

    @rt.remote
    def probe():
        import os as _os
        import sys as _sys

        return (
            _sys.argv[0],
            sorted(k for k in _os.environ if k.startswith("RAY_TPU_TORCH_")),
            sorted(m for m in _sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")),
        )

    argv0, env, foreign = rt.get(probe.remote())
    assert "RAY_TPU_TORCH_GCS_ADDR" in env and "RAY_TPU_TORCH_SESSION_DIR" in env
    assert foreign == []
    assert os.path.join("ray_tpu_torch", "_private") in argv0, argv0


def test_what_is_not_ported_raises(cluster):
    """The device-object plane exists (ROADMAP A10): an unknown transport is
    refused, a DTensor under tensor_transport= names ROADMAP A9f, and the
    client address still raises (A14)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    with pytest.raises(ValueError, match="tensor_transport"):
        rt.put(torch.ones(2), tensor_transport="bogus")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        d = distribute_tensor(torch.ones(4), init_device_mesh("cpu", (1,)))
        with pytest.raises(TypeError, match="A9f"):
            rt.put(d, tensor_transport="collective")
    finally:
        dist.destroy_process_group()
    with pytest.raises(NotImplementedError):
        rt.init("ray_tpu_torch://localhost:1")


def test_cuda_tensor_needs_its_device():
    """A CUDA tensor's object restores onto cuda:<index>; a process without
    that device raises instead of handing back a CPU tensor."""
    from ray_tpu_torch._private import serialization

    if torch.cuda.is_available() and torch.cuda.device_count() > 3:
        pytest.skip("this host has a cuda:3")
    host, dtype = serialization.tensor_to_numpy(torch.ones(3, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError, match="cuda:3"):
        serialization._rebuild_tensor(host, dtype, 3, False)


def test_checkpoint_of_tensors_keeps_bf16(tmp_path):
    from ray_tpu_torch.air.checkpoint import Checkpoint, checkpoint_from_tensors, tensors_from_checkpoint

    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
            "layers": {"b": torch.randn(3, generator=g), "i": torch.arange(5)}}
    ckpt = checkpoint_from_tensors(tree, step=7)
    assert isinstance(ckpt.to_dict()["tensors"]["w"].array, np.ndarray)
    back = tensors_from_checkpoint(Checkpoint.from_directory(ckpt.to_directory(str(tmp_path / "c"))), device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(back["layers"]["b"], tree["layers"]["b"]) and torch.equal(back["layers"]["i"], tree["layers"]["i"])
    assert Checkpoint.from_bytes(ckpt.to_bytes()).to_dict()["step"] == 7


def test_sessions_live_under_the_ports_root(cluster):
    node = rt._global_node
    assert node.session_dir.startswith(os.path.join(tempfile.gettempdir(), "ray_tpu_torch") + os.sep)
    assert flight_recorder.flight_dir(node.session_dir) == os.path.join(node.session_dir, "flight")
    assert node.raylet.arena_name.startswith("/rtpu_torch_")
    assert os.path.dirname(sys.modules["ray_tpu_torch._private.store.arena"]._SO).endswith(
        os.path.join("ray_tpu_torch", "_native", "build")
    )
