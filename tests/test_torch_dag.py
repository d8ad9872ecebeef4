"""The port's DAG API, compiled graphs and MPMD pipeline on the CPU
(``ray_tpu_torch.dag``, ``experimental/channel``, ``parallel/mpmd_pipeline``).

The cases of ``tests/test_dag.py``, ``tests/test_dag_compiled.py`` and
``tests/test_mpmd_pipeline.py`` on the port's runtime: lazy task and actor
DAGs, the compiled DAG's zero raylet RPCs an iteration, error flow,
backpressure, timeouts, poison on actor death, teardown reclaiming every
channel, descriptor streaming with no host-store copies, SIGKILL of a stage.
Then the JAX package's ``_stage_fn`` through both packages' ``mpmd_pipeline``
at M = S and M > S: the port's output equals its in-process composition bit
for bit, and the reference's ``pipeline_apply`` and ``mpmd_pipeline`` within
f32 rel_l2 1e-6; and a 2-stage pipeline of a small transformer's layers
(2 layers, d 64) against the JAX ``_layer`` composition at
``tests/test_torch_transformer.py``'s f32 tolerance.

The module boots one JAX cluster (the reference pipeline, then shut down)
and one port cluster, whose channel re-poll cap is 2 s (the doorbell case
reads it); ~50 s here.
"""

import gc
import os
import signal
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.experimental.channel import ChannelTimeoutError

N_STAGES, D = 4, 8


@pytest.fixture(scope="module")
def cluster():
    os.environ["RAY_TPU_TORCH_CHANNEL_POLL_INTERVAL_MS"] = "2000"
    try:
        rt.init(num_cpus=6, object_store_memory=192 * 1024 * 1024)
        try:
            yield
        finally:
            rt.shutdown()
    finally:
        os.environ.pop("RAY_TPU_TORCH_CHANNEL_POLL_INTERVAL_MS", None)


def _jax_stage_fn(w, h):
    import jax.numpy as jnp

    return jnp.tanh(h @ w)


def _stage_fn(w, h):
    return torch.tanh(h @ w)


def _pipeline_inputs():
    """The reference test's stacked weights and each M's batch, as numpy."""
    import jax

    ws = np.array(jax.random.normal(jax.random.PRNGKey(1), (N_STAGES, D, D)) * 0.3)
    xs = {M: np.array(jax.random.normal(jax.random.PRNGKey(M), (M * 2, D))) for M in (4, 8)}
    return ws, xs


@pytest.fixture(scope="module")
def reference():
    """The JAX package's pipeline_apply (in process, 8 virtual devices) and
    mpmd_pipeline (its own cluster) on the same weights and batches."""
    import jax.numpy as jnp

    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.parallel.mpmd_pipeline import mpmd_pipeline
    from ray_tpu.parallel.pipeline import pipeline_apply

    ws, xs = _pipeline_inputs()
    mesh = create_mesh(MeshConfig(pp=4, dp=2))
    applied = {M: np.asarray(pipeline_apply(_jax_stage_fn, jnp.asarray(ws), jnp.asarray(x), mesh, num_microbatches=M))
               for M, x in xs.items()}
    ray_tpu.init(num_cpus=6, object_store_memory=128 * 1024 * 1024)
    try:
        pipe = mpmd_pipeline(_jax_stage_fn, jnp.asarray(ws), num_microbatches=4)
        try:
            mpmd = {M: np.array(pipe.apply(jnp.asarray(x), num_microbatches=M)) for M, x in xs.items()}
        finally:
            pipe.teardown()
    finally:
        ray_tpu.shutdown()
    return applied, mpmd


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _drain_resident(stats_fn, target: int, timeout: float = 30.0) -> dict:
    """Pin releases and loop-exit reclaims are asynchronous: poll the
    counters down instead of sleeping blind."""
    deadline = time.monotonic() + timeout
    st = stats_fn()
    while time.monotonic() < deadline:
        st = stats_fn()
        if st["resident_count"] <= target:
            return st
        time.sleep(0.1)
    return st


# ---------------------------------------------------------------------------
# tests/test_dag.py and tests/test_dag_compiled.py
# ---------------------------------------------------------------------------


def test_function_dag(cluster):
    @rt.remote
    def a(x):
        return x + 1

    @rt.remote
    def b(x):
        return x * 2

    @rt.remote
    def combine(x, y):
        return x + y

    with InputNode() as inp:
        dag = combine.bind(a.bind(inp), b.bind(inp))

    # (5+1) + (5*2) = 16
    assert rt.get(dag.execute(5)) == 16
    # DAG is reusable
    assert rt.get(dag.execute(1)) == 4


def test_shared_upstream_node_runs_once(cluster):
    @rt.remote
    def source():
        import os
        import time

        return (os.getpid(), time.time_ns())

    @rt.remote
    def ident(x):
        return x

    src = source.bind()
    dag = MultiOutputNode([ident.bind(src), ident.bind(src)])
    left, right = rt.get(dag.execute())
    assert left == right  # one submission, shared ref


def test_dag_input_attributes(cluster):
    @rt.remote
    def add(x, y):
        return x + y

    with InputNode() as inp:
        dag = add.bind(inp["a"], inp["b"])

    assert rt.get(dag.execute({"a": 3, "b": 4})) == 7


def test_class_node_dag(cluster):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def add(self, x):
            self.v += x
            return self.v

    with InputNode() as inp:
        counter = Counter.bind(10)
        dag = counter.add.bind(inp)

    assert rt.get(dag.execute(5)) == 15


def test_multi_output(cluster):
    @rt.remote
    def f(x):
        return x * 10

    with InputNode() as inp:
        dag = MultiOutputNode([f.bind(inp), f.bind(2)])

    refs = dag.execute(1)
    assert rt.get(refs) == [10, 20]


def test_options_on_node(cluster):
    @rt.remote
    def f():
        return "ok"

    dag = f.bind().options(name="dag-step")
    assert rt.get(dag.execute()) == "ok"


@rt.remote
class Stage:
    def __init__(self, inc=1):
        self.inc = inc

    def work(self, x):
        return x + self.inc

    def mul(self, x):
        return x * 10

    def add(self, x, y):
        return x + y

    def boom(self, x):
        if x == 3:
            raise ValueError("x was 3")
        return x

    def slow(self, x):
        time.sleep(1.5)
        return x

    def pid(self):
        return os.getpid()


def _linear_dag(n_stages):
    stages = [Stage.bind() for _ in range(n_stages)]
    with InputNode() as inp:
        d = inp
        for s in stages:
            d = s.work.bind(d)
    return d, stages


def _control_plane_busy(cw) -> dict:
    """What this driver still holds from earlier cases that reaches the
    raylet or the ownership tables on its own: worker leases (the lease
    manager's maintenance tick, every 2 s, returns an idle one or renews a
    held one through the raylet client), tasks not yet done, and raylet
    requests in flight (a deferred ``free_object``). Empty when quiet."""
    lm = cw._lease_mgr
    shapes = list(lm._shapes.values()) if lm is not None else []
    busy = {
        "leases": sum(len(s.leases) + len(s.pending_requests) + len(s.queue) for s in shapes),
        "pending_tasks": len(cw.pending_tasks),
        "raylet_requests_in_flight": len(cw.raylet._pending),
    }
    return {k: v for k, v in busy.items() if v}


def _await_quiet_control_plane(cw, timeout_s=20.0):
    """Collect the earlier cases' garbage, then wait (bounded) until nothing
    of theirs is left to reach the control plane and the raylet client has
    sent nothing for a quarter second."""
    gc.collect()
    deadline = time.monotonic() + timeout_s
    while True:
        seq = cw.raylet._seq
        if not _control_plane_busy(cw):
            time.sleep(0.25)
            if not _control_plane_busy(cw) and cw.raylet._seq == seq:
                return
        if time.monotonic() > deadline:
            pytest.fail(f"the driver's control plane is not quiet after {timeout_s} s: {_control_plane_busy(cw)}")
        time.sleep(0.05)


def test_compiled_linear_pipeline_zero_control_plane(cluster):
    from ray_tpu_torch._private import worker_context

    d, _ = _linear_dag(4)
    compiled = d.experimental_compile()
    try:
        assert compiled.execute(0).get() == 4  # warm the loop
        cw = worker_context.get_core_worker()
        # The earlier cases' function tasks leave worker leases behind, which
        # the lease manager returns (or renews) on its own tick: read the
        # baselines once those are gone, so the window sees only the loop.
        _await_quiet_control_plane(cw)
        raylet_seq0 = cw.raylet._seq
        owned0 = len(cw.owned)
        pending0 = len(cw.pending_tasks)
        for i in range(25):
            assert compiled.execute(i).get() == i + 4
        # The steady-state iteration touches neither the raylet nor the
        # ObjectRef/ownership plane — the whole point of compiling.
        assert cw.raylet._seq - raylet_seq0 == 0, (
            f"raylet RPCs (cw.raylet._seq) moved by {cw.raylet._seq - raylet_seq0}; "
            f"outstanding: {_control_plane_busy(cw)}")
        assert len(cw.owned) - owned0 == 0, f"owned objects (len(cw.owned)) moved by {len(cw.owned) - owned0}"
        assert len(cw.pending_tasks) - pending0 == 0, (
            f"pending tasks (len(cw.pending_tasks)) moved by {len(cw.pending_tasks) - pending0}")
    finally:
        compiled.teardown()


def test_compiled_out_of_order_get_and_pipelining(cluster):
    d, _ = _linear_dag(2)
    compiled = d.experimental_compile()
    try:
        refs = [compiled.execute(i) for i in range(8)]
        # Consume newest-first: earlier results buffer driver-side.
        assert [r.get() for r in reversed(refs)] == [i + 2 for i in reversed(range(8))]
        # Repeated get returns the cached value.
        assert refs[0].get() == 2
    finally:
        compiled.teardown()


def test_compiled_multi_output_and_input_attributes(cluster):
    a, b = Stage.bind(), Stage.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([a.work.bind(inp["x"]), b.mul.bind(inp["y"])])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute({"x": 1, "y": 2}).get() == [2, 20]
        assert compiled.execute({"x": 5, "y": 7}).get() == [6, 70]
    finally:
        compiled.teardown()


def test_compiled_fan_in_and_const_args(cluster):
    a, b, c = Stage.bind(), Stage.bind(), Stage.bind()
    with InputNode() as inp:
        left = a.work.bind(inp)
        right = b.mul.bind(inp)
        dag = c.add.bind(left, right)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(3).get() == (3 + 1) + (3 * 10)
    finally:
        compiled.teardown()


def test_compiled_validation_errors(cluster):
    @rt.remote
    def task(x):
        return x

    with InputNode() as inp:
        fn_dag = task.bind(inp)
    with pytest.raises(ValueError, match="actor-method nodes only"):
        fn_dag.experimental_compile()

    s = Stage.bind()
    no_input = s.work.bind(1)
    with pytest.raises(ValueError, match="InputNode"):
        no_input.experimental_compile()

    with InputNode() as inp:
        dangling_src = Stage.bind()
        used = s.work.bind(inp)
        dangling = dangling_src.work.bind(inp)  # produced, never consumed
        dag = MultiOutputNode([used])
    del dangling
    # (dangling node is unreachable from the root, so this compiles fine)
    dag.experimental_compile(max_buffered_results=2).teardown()


def test_compiled_application_error_flows_and_dag_survives(cluster):
    a, b = Stage.bind(), Stage.bind()
    with InputNode() as inp:
        dag = b.work.bind(a.boom.bind(inp))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(2).get() == 3
        with pytest.raises(TaskError, match="x was 3"):
            compiled.execute(3).get()
        # Per-iteration failure only: the pipeline keeps serving.
        assert compiled.execute(4).get() == 5
    finally:
        compiled.teardown()


def test_compiled_backpressure_blocks_producer(cluster):
    d, _ = _linear_dag(1)
    compiled = d.experimental_compile(max_buffered_results=2, submit_timeout_s=0.5)
    try:
        refs = [compiled.execute(i) for i in range(2)]
        time.sleep(0.3)  # drain the input ring into the output ring
        compiled.execute(2)
        with pytest.raises(ChannelTimeoutError, match="unconsumed"):
            for i in range(3, 8):  # must jam within num_slots extra writes
                compiled.execute(i)
        assert refs[0].get() == 1  # buffered results still retrievable
    finally:
        compiled.teardown()


def test_compiled_get_honors_timeout(cluster):
    s = Stage.bind()
    with InputNode() as inp:
        dag = s.slow.bind(inp)
    compiled = dag.experimental_compile()
    try:
        ref = compiled.execute(7)
        t0 = time.monotonic()
        with pytest.raises(GetTimeoutError):
            ref.get(timeout=0.2)
        assert time.monotonic() - t0 < 1.0
        assert ref.get() == 7  # late result still lands
    finally:
        compiled.teardown()


def test_compiled_multi_output_get_timeout_keeps_iterations_paired(cluster):
    """A get(timeout=) that expires after consuming SOME output channels of
    an iteration must not skew pairing: the partially-drained envelopes
    stage, and the retry resumes with the same iteration."""
    fast, slow = Stage.bind(), Stage.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([fast.work.bind(inp), slow.slow.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        ref = compiled.execute(1)
        with pytest.raises(GetTimeoutError):
            ref.get(timeout=0.3)  # fast output consumed, slow still pending
        assert ref.get() == [2, 1]
        assert compiled.execute(5).get() == [6, 5]  # pairing intact
    finally:
        compiled.teardown()


def test_compiled_abandoned_results_raise_instead_of_leaking(cluster):
    """Skipping refs cannot grow the driver-side result buffer without
    bound: draining past max_buffered_results unconsumed results raises."""
    d, _ = _linear_dag(1)
    compiled = d.experimental_compile(max_buffered_results=2)
    try:
        refs = [compiled.execute(i) for i in range(3)]
        with pytest.raises(ValueError, match="buffered"):
            refs[2].get(timeout=10)
        # Nothing was lost: consuming in order recovers every result.
        assert [refs[i].get(timeout=10) for i in range(3)] == [1, 2, 3]
    finally:
        compiled.teardown()


def test_compiled_execute_after_teardown_raises(cluster):
    d, _ = _linear_dag(1)
    compiled = d.experimental_compile()
    assert compiled.execute(1).get() == 2
    compiled.teardown()
    compiled.teardown()  # idempotent
    with pytest.raises(ValueError, match="torn down"):
        compiled.execute(2)


def test_compiled_actor_death_chaos(cluster):
    """SIGKILL a mid-pipeline actor during compiled execution: get() raises
    a typed error naming the dead stage, teardown() completes, and the
    channel slots return to the arena (no leaked shm)."""
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    stages = [Stage.bind() for _ in range(3)]
    pids = [rt.get(s.resolve_actor_handle().pid.remote()) for s in stages]
    with InputNode() as inp:
        d = inp
        for s in stages:
            d = s.work.bind(d)
    store0 = cw.raylet.call("get_state")["store"]
    compiled = d.experimental_compile()
    assert compiled.execute(0).get() == 3
    assert cw.raylet.call("get_state")["store"]["num_channels"] > 0

    os.kill(pids[1], signal.SIGKILL)
    ref = compiled.execute(1)
    with pytest.raises(ActorDiedError, match="1:work"):
        ref.get(timeout=30)
    with pytest.raises(ActorDiedError):
        compiled.execute(2)

    t0 = time.monotonic()
    compiled.teardown()
    # The reference's teardown sends each dead reader a close frame and
    # waits ~40 s on the connect retries (ROADMAP C4); the port skips them.
    assert time.monotonic() - t0 < 10
    store1 = cw.raylet.call("get_state")["store"]
    assert store1["num_channels"] == store0["num_channels"]
    assert store1["used"] <= store0["used"]


def test_classic_calls_still_served_while_compiled(cluster):
    """The resident loop runs on its own thread: an actor bound into a
    compiled graph still answers classic method calls (and classic
    execute() of the same DAG) instead of queuing behind the loop forever."""
    d, stages = _linear_dag(2)
    compiled = d.experimental_compile()
    try:
        assert compiled.execute(1).get() == 3
        handle = stages[0].resolve_actor_handle()
        assert rt.get(handle.work.remote(10), timeout=20) == 11
        assert rt.get(d.execute(1), timeout=30) == 3  # classic walk
        assert compiled.execute(2).get() == 4  # compiled path unaffected
    finally:
        compiled.teardown()


def test_compiled_oversize_payload_side_channel(cluster):
    """Envelopes larger than a ring slot ride the chunked side-channel
    (marker slot + acked channel_data chunks) and still arrive in order."""
    np = pytest.importorskip("numpy")

    @rt.remote
    class Big:
        def double(self, arr):
            return arr * 2

    b = Big.bind()
    with InputNode() as inp:
        dag = b.double.bind(inp)
    # 8 KiB slots vs ~1 MiB payloads: every hop goes side-channel.
    compiled = dag.experimental_compile(slot_size_bytes=8 * 1024)
    try:
        arr = np.arange(256 * 1024, dtype=np.int32)
        for i in range(3):
            out = compiled.execute(arr + i).get()
            assert out.dtype == np.int32 and out[1] == (1 + i) * 2
        assert compiled.execute(np.int32(21)).get() == 42  # small again
    finally:
        compiled.teardown()


def test_channel_remote_mode_fallback(cluster):
    """Cross-node (no shared arena) channels: every envelope rides the
    chunked RPC path with channel_query backpressure. Exercised directly
    with both endpoints in this process and a remote-only descriptor."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.experimental.channel import (
        KIND_VALUE,
        ChannelReader,
        ChannelTimeoutError as CTE,
        ChannelWriter,
        make_descriptor,
    )
    from ray_tpu_torch._private import serialization

    cw = worker_context.get_core_worker()
    desc = make_descriptor(
        "rm" * 12, arena=None, offset=0, num_slots=2, slot_size=8 * 1024,
        reader_addr=cw.address, label="remote-test",
    )
    writer = ChannelWriter(desc, cw)
    reader = ChannelReader(desc, cw)
    assert not writer.shm and not reader.shm
    kinds_vals = []
    for i in range(3):
        writer.write(KIND_VALUE, serialization.serialize(i * 7).to_bytes())
        kind, data, _hop = reader.read(timeout=5)
        kinds_vals.append((kind, serialization.deserialize(data)))
    assert kinds_vals == [(KIND_VALUE, 0), (KIND_VALUE, 7), (KIND_VALUE, 14)]
    # Backpressure: 2 unconsumed envelopes fill the remote queue bound.
    writer.write(KIND_VALUE, serialization.serialize(1).to_bytes())
    writer.write(KIND_VALUE, serialization.serialize(2).to_bytes())
    with pytest.raises(CTE):
        writer.write(KIND_VALUE, serialization.serialize(3).to_bytes(), timeout=0.5)
    cw.channels.drop([desc["cid"]])


def test_classic_execute_reuses_actor_gang(cluster):
    """Satellite: classic dag.execute() on ClassNode graphs reuses the
    per-DAG actor cache instead of spawning fresh actors per call."""

    @rt.remote
    class Counter:
        def __init__(self):
            self.v = 0

        def add(self, x):
            self.v += x
            return self.v

        def pid(self):
            return os.getpid()

    with InputNode() as inp:
        counter = Counter.bind()
        dag = counter.add.bind(inp)
    assert rt.get(dag.execute(5)) == 5
    # Same actor: state accumulates and the pid is stable across executes.
    assert rt.get(dag.execute(5)) == 10
    pid_dag = counter.pid.bind()
    assert rt.get(pid_dag.execute()) == rt.get(pid_dag.execute())


def test_compile_rejects_double_binding(cluster):
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    d, stages = _linear_dag(1)
    compiled = d.experimental_compile()
    try:
        channels_live = cw.raylet.call("get_state")["store"]["num_channels"]
        with InputNode() as inp:
            other = stages[0].mul.bind(inp)
        with pytest.raises(ValueError, match="already participates"):
            other.experimental_compile()
        # The failed compile released every channel it had allocated.
        assert (
            cw.raylet.call("get_state")["store"]["num_channels"] == channels_live
        )
    finally:
        compiled.teardown()
    # After teardown the actor is free to join a new compiled graph.
    compiled2 = other.experimental_compile()
    try:
        assert compiled2.execute(3).get() == 30
    finally:
        compiled2.teardown()


# ---------------------------------------------------------------------------
# tests/test_mpmd_pipeline.py
# ---------------------------------------------------------------------------


def test_doorbell_wakes_backed_off_reader(cluster):
    """channel_poll_interval_ms is a config knob (2 s in this module), and a
    doorbell never waits for a full poll interval."""
    from ray_tpu_torch._private import worker_context

    assert worker_context.get_core_worker().cfg.channel_poll_interval_ms == 2000

    @rt.remote
    class Inc:
        def work(self, x):
            return x + 1

    a, b = Inc.bind(), Inc.bind()
    with InputNode() as inp:
        dag = b.work.bind(a.work.bind(inp))
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(0).get() == 2
        time.sleep(1.2)  # every blocked reader backs off towards the 2 s cap
        t0 = time.monotonic()
        assert compiled.execute(5).get(timeout=30) == 7
        assert time.monotonic() - t0 < 1.5
    finally:
        compiled.teardown()
    for n in (a, b):
        rt.kill(n.resolve_actor_handle())


@rt.remote(tensor_transport="collective")
class DeviceStage:
    def work(self, x):
        return torch.tanh(x) + 1.0

    def devobj_stats(self):
        from ray_tpu_torch.experimental.device_object import device_object_stats

        return device_object_stats()


def test_device_descriptor_stream_zero_host_copy(cluster):
    """A tensor_transport actor's tensor result crosses a compiled edge as a
    descriptor slot while the payload rides the p2p direct mailbox: the
    store sees no activation object, the producer's pins trail the ring by
    at most 2 slots, and teardown reclaims every payload."""
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    s1, s2 = DeviceStage.bind(), DeviceStage.bind()
    with InputNode() as inp:
        dag = s2.work.bind(s1.work.bind(inp))
    compiled = dag.experimental_compile()
    h1, h2 = s1.resolve_actor_handle(), s2.resolve_actor_handle()
    try:
        store0 = cw.raylet.call("get_state")["store"]["num_objects"]
        x = torch.arange(8.0)
        expected = torch.tanh(torch.tanh(x) + 1.0) + 1.0
        iters = 6
        for _ in range(iters):
            assert torch.equal(compiled.execute(x).get(timeout=60), expected)
        assert cw.raylet.call("get_state")["store"]["num_objects"] == store0
        st = rt.get(h1.devobj_stats.remote(), timeout=30)
        assert st["chan_sends"] >= iters and st["transfers_host"] == 0, st
        assert st["resident_count"] <= 2, st
    finally:
        compiled.teardown()
    st = _drain_resident(lambda: rt.get(h1.devobj_stats.remote(), timeout=30), target=0)
    assert st["resident_count"] == 0, st
    rt.kill(h1)
    rt.kill(h2)


def test_driver_device_input_routed_as_descriptor(cluster):
    """execute() fed a tensor routes it as a descriptor slot (the driver is
    the holder) instead of serializing it through the host ring; teardown
    reclaims the driver's payload scope."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.experimental.device_object import device_object_stats

    cw = worker_context.get_core_worker()

    @rt.remote
    class SumStage:
        def total(self, x):
            return float(x.sum())

    node = SumStage.bind()
    with InputNode() as inp:
        dag = node.total.bind(inp)
    compiled = dag.experimental_compile()
    base = device_object_stats()
    try:
        store0 = cw.raylet.call("get_state")["store"]["num_objects"]
        for _ in range(4):
            assert compiled.execute(torch.ones(16)).get(timeout=60) == 16.0
        st = device_object_stats()
        assert st["chan_sends"] - base["chan_sends"] >= 4, (base, st)
        assert cw.raylet.call("get_state")["store"]["num_objects"] == store0
    finally:
        compiled.teardown()
    st = _drain_resident(device_object_stats, target=base["resident_count"])
    assert st["resident_count"] <= base["resident_count"], (base, st)
    rt.kill(node.resolve_actor_handle())


def test_unserializable_result_is_per_iteration_error(cluster):
    import threading

    @rt.remote
    class Sometimes:
        def work(self, x):
            if x == 1:
                return threading.Lock()  # pickle refuses
            return x

    node = Sometimes.bind()
    with InputNode() as inp:
        dag = node.work.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(0).get(timeout=30) == 0
        with pytest.raises(TaskError):
            compiled.execute(1).get(timeout=30)
        assert compiled.execute(2).get(timeout=30) == 2
    finally:
        compiled.teardown()
    rt.kill(node.resolve_actor_handle())


def test_mpmd_equals_its_composition_and_the_reference(reference, cluster):
    from ray_tpu_torch.parallel.mpmd_pipeline import mpmd_pipeline

    applied, ref_mpmd = reference
    ws, xs = _pipeline_inputs()
    ws_t = torch.from_numpy(ws)
    pipe = mpmd_pipeline(_stage_fn, ws_t, num_microbatches=4, device="cpu")
    try:
        for M, x in xs.items():  # M == S and M > S
            xt = torch.from_numpy(x)
            out = pipe.apply(xt, num_microbatches=M)
            composed = []
            for mb in xt.split(2):
                for k in range(N_STAGES):
                    mb = _stage_fn(ws_t[k], mb)
                composed.append(mb)
            assert torch.equal(out, torch.cat(composed)), f"M={M}"
            assert _rel_l2(out.numpy(), applied[M]) <= 1e-6, M
            assert _rel_l2(out.numpy(), ref_mpmd[M]) <= 1e-6, M
        with pytest.raises(AssertionError, match="not divisible"):
            pipe.apply(torch.zeros(10, D), num_microbatches=4)
        pipe.reset_stage_stats()
        pipe.apply(torch.from_numpy(xs[8]), num_microbatches=8)
        rows = pipe.stage_stats()
        assert len(rows) == N_STAGES and all(r["iters"] >= 8 for r in rows), rows
        assert 0.0 <= pipe.bubble_fraction() < 1.0
        assert all(s["transfers_host"] == 0 for s in pipe.stage_devobj_stats())
        # The stage's own timings: CUDA event spans exist only on a card;
        # alone, issue and finish are host ms and the profiler reads nothing.
        s0 = pipe.stages[0]
        rt.get(s0.time_device.remote(True))
        pipe.apply(torch.from_numpy(xs[8]), num_microbatches=8)
        assert rt.get(s0.device_spans.remote()) == []
        alone = rt.get(s0.time_alone.remote(torch.from_numpy(xs[8][:2]), 2))
        assert alone["kernel_ms"] is None and alone["ops"] is None
        assert 0 < alone["issue_ms"] <= alone["wall_ms"]
    finally:
        pipe.teardown()


def test_mpmd_on_the_card_needs_a_card(cluster):
    """device="cuda" stage actors ask for num_gpus: on a cluster without a
    GPU their placement fails with the runtime's own error instead of
    running on the CPU."""
    from ray_tpu_torch.parallel.mpmd_pipeline import MPMDPipeline

    with pytest.raises(Exception, match="no feasible node"):
        MPMDPipeline(_stage_fn, torch.zeros(2, D, D), device="cuda")


def test_mpmd_transformer_layers_match_the_jax_layers(cluster):
    """Two stages of one layer each of a small transformer (2 layers, d 64,
    f32) against the JAX package's _layer composition on the same weights
    (params_from_jax)."""
    import functools

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jt
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel.mpmd_pipeline import mpmd_pipeline

    kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, max_seq_len=64)
    cfg_j, cfg_t = jt.TransformerConfig(dtype=jnp.float32, **kw), tt.TransformerConfig(dtype=torch.float32, **kw)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, size=(4, 64)).astype(np.int32)
    x_j = params_j["embed"].astype(jnp.float32)[jnp.asarray(tokens)]
    rope = jt._rope_tables(jnp.broadcast_to(jnp.arange(64)[None], (4, 64)), cfg_j.head_dim, cfg_j.rope_theta)
    for i in range(cfg_j.n_layers):
        x_j = jt._layer(jax.tree.map(lambda w: w[i], params_j["layers"]), x_j, rope, cfg_j, None, "auto")[0]
    stacked = {n: w.reshape(2, 1, *w.shape[1:]) for n, w in params_t["layers"].items()}
    pipe = mpmd_pipeline(functools.partial(_layers_stage, cfg=cfg_t), stacked, num_microbatches=2, device="cpu")
    try:
        out = pipe.apply(params_t["embed"][torch.from_numpy(tokens).long()], num_microbatches=2)
    finally:
        pipe.teardown()
    np.testing.assert_allclose(out.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-5)


def _layers_stage(params, h, cfg):
    from ray_tpu_torch.models import transformer as tt

    cos, sin = tt._rope_tables(torch.arange(h.shape[1])[None], cfg.head_dim, cfg.rope_theta)
    for i in range(next(iter(params.values())).shape[0]):
        h = tt._layer({n: w[i] for n, w in params.items()}, h, cos, sin, cfg)[0]
    return h


def test_mpmd_chaos_sigkill_stage_reclaims_everything(cluster):
    """SIGKILL one stage mid-schedule: a typed ActorDiedError, and teardown
    reclaims the channels, the driver's payload scope and the surviving
    stages' pinned payloads."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.experimental.device_object import device_object_stats
    from ray_tpu_torch.parallel.mpmd_pipeline import mpmd_pipeline

    cw = worker_context.get_core_worker()
    ws, _ = _pipeline_inputs()
    driver_base = device_object_stats()["resident_count"]
    chan0 = cw.raylet.call("get_state")["store"]["num_channels"]
    pipe = mpmd_pipeline(_stage_fn, torch.from_numpy(ws), num_microbatches=4, device="cpu")
    survivors = [s for i, s in enumerate(pipe.stages) if i != 1]
    victim_pid = rt.get(pipe.stages[1].pid.remote(), timeout=30)
    try:
        assert pipe.apply(torch.randn(8, D), num_microbatches=4).shape == (8, D)
        x_mb = torch.randn(2, D)
        refs = [pipe.compiled.execute(x_mb) for _ in range(3)]
        os.kill(victim_pid, signal.SIGKILL)
        with pytest.raises(ActorDiedError, match="run"):
            for r in refs:
                r.get(timeout=60)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                pipe.compiled.execute(x_mb).get(timeout=60)
    finally:
        pipe.teardown(kill_actors=False)
    assert cw.raylet.call("get_state")["store"]["num_channels"] == chan0
    st = _drain_resident(device_object_stats, target=driver_base)
    assert st["resident_count"] <= driver_base, st
    for s in survivors:
        st = _drain_resident(lambda s=s: rt.get(s.devobj_stats.remote(), timeout=30), target=0)
        assert st["resident_count"] == 0, st
    for s in survivors:
        rt.kill(s)
