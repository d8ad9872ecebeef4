"""The Podracer weight sync on the port, on the CPU: ``tests/test_podracer.py``'s
six cluster cases on ``ray_tpu_torch.rllib`` (``device="cpu"``).

``weight_sync="device_broadcast"`` packs the learner's parameters into ONE
flat vector held as a device object, forms a learner<->sampler weight group
at setup, and every sync is one ``device_object.broadcast`` over the host
plane. The port's cases add a bit-equality check: after a sync every
sampler's packed weights hash to the learner's (``weights_checksum``). The
topology case runs with the learner in this process (the driver holds the
vector) and in a learner actor (the actor holds it), as ``chip_smoke.py``
runs it on the card.

The dead-sampler case waits on the weight group's roster (the replacement
re-listed at its old rank in a later epoch), never on a sleep.

The gradient sync of two learner actors is held to independent answers on
the same two batches from the same weights, for ``grad_sync="host"`` and
``"device_allreduce"``: with Adam, to the JAX package's two learners with
``grad_sync="device_allreduce"`` (weights rtol 1e-5 / atol 1e-6, metrics
rtol 1e-4 / atol 1e-6 as in ``test_torch_rllib_pg.py``); with SGD and no
clip, which a wrongly scaled mean would move (Adam or the clip would not),
to one learner in this process that averages the two shards' gradients by
hand (rtol 1e-5 / atol 1e-6). The JAX package's cluster runs first, alone, then the port's.
One port cluster for the module, torch pinned to one thread; ~80 s here.
"""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.core.learner import weights_checksum

F32 = dict(rtol=1e-5, atol=1e-6)
METRICS = dict(rtol=1e-4, atol=1e-6)
SPEC = dict(obs_dim=4, action_dim=2, discrete=True)
GRAD_LR, GRAD_CLIP, LOSS_CFG = 4e-3, 0.1, {"entropy_coeff": 0.01}


def _grad_batches():
    """Two 64-row batches for ``pg_loss``, made from a seed: each update's
    two shards are its halves."""
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, OBS, VALUE_TARGETS

    rng = np.random.default_rng(11)
    return [{OBS: rng.normal(size=(64, 4)).astype(np.float32),
             ACTIONS: rng.integers(0, 2, 64).astype(np.int32),
             VALUE_TARGETS: rng.normal(1.0, 2.0, 64).astype(np.float32)} for _ in range(2)]


@pytest.fixture(scope="module")
def jax_grad_sync():
    """The JAX package's two learner actors with ``grad_sync=
    "device_allreduce"``: their initial weights, the two updates' metrics
    and both ranks' weights after them."""
    import jax
    import ray_tpu
    from ray_tpu.rllib.algorithms.pg.pg import pg_loss as j_pg_loss
    from ray_tpu.rllib.core import learner as jl
    from ray_tpu.rllib.core import rl_module as jrm
    from ray_tpu.rllib.policy.sample_batch import SampleBatch as JBatch

    def copy(tree):  # the results are views of the cluster's shared memory
        return jax.tree_util.tree_map(np.array, tree)

    ray_tpu.init(num_cpus=2, object_store_memory=128 * 1024 * 1024)
    try:
        group = jl.LearnerGroup(jrm.RLModuleSpec(**SPEC), j_pg_loss, lr=GRAD_LR, grad_clip=GRAD_CLIP, seed=3,
                                num_learners=2, grad_sync="device_allreduce")
        init = copy(group.get_weights())
        metrics = [dict(group.update(JBatch(dict(b)), LOSS_CFG)) for b in _grad_batches()]
        weights = [copy(w) for w in ray_tpu.get([a.get_weights.remote() for a in group._actors])]
        group.stop()
        return init, metrics, weights
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def pod_cluster(jax_grad_sync):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt.init(num_cpus=6, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()
    torch.set_num_threads(threads)


def _impala_config(**training_overrides):
    from ray_tpu_torch.rllib import IMPALAConfig

    return (
        IMPALAConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, rollout_fragment_length=16)
        .training(lr=5e-4, train_batch_size=64, **training_overrides)
        .resources(device="cpu")
        .debugging(seed=0)
    )


def _assert_samplers_hold_learner_weights(algo):
    want = weights_checksum(algo.learner_group.get_weights())
    got = algo.workers.weights_checksums()
    assert got == [want] * algo.workers.num_workers, (want, got)


def _wait_roster(algo, ranks, after_epoch, timeout=60.0):
    """The weight group's roster once it lists exactly ``ranks`` at an epoch
    past ``after_epoch``."""
    deadline = time.monotonic() + timeout
    while True:
        roster = algo.learner_group.weight_group_roster(algo._weight_group)
        if roster is not None and roster["ranks"] == ranks and roster["epoch"] > after_epoch:
            return roster
        assert time.monotonic() < deadline, f"roster {roster} never listed {ranks} past epoch {after_epoch}"
        time.sleep(0.05)


def _wait_dead(actor, timeout=60.0):
    """Return once ``actor`` answers no call: ``kill`` returns before the
    process is gone."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            rt.get(actor.ping.remote(), timeout=5)
        except Exception:
            return
    raise AssertionError(f"{actor} still answers {timeout} s after kill()")


@pytest.mark.parametrize("holder", ["local", "actor"])
def test_impala_device_broadcast_topology(pod_cluster, holder):
    """The weight group forms at setup, every sync rides the group broadcast
    (the holder's bcast_sends, every sampler's bcast_recvs), the samplers hold
    the learner's weights bit for bit, and the losses stay finite."""
    from ray_tpu_torch.util.collective.p2p import COLL

    cfg = _impala_config(weight_sync="device_broadcast", learner_mesh=True)
    if holder == "actor":
        cfg.resources(num_learners=1)
    algo = cfg.build()
    try:
        assert algo._device_sync_ready
        _assert_samplers_hold_learner_weights(algo)
        before = COLL.bcast_sends
        recvs = [s["bcast_recvs"] for s in algo.workers.coll_stats()]
        m1 = algo.step()
        _assert_samplers_hold_learner_weights(algo)
        m2 = algo.step()
        _assert_samplers_hold_learner_weights(algo)
        if holder == "local":
            # This process holds the vector: the fan-outs are counted here.
            assert COLL.bcast_sends - before >= 2
        stats = algo.workers.coll_stats()
        assert all(s["bcast_recvs"] - r >= 2 for s, r in zip(stats, recvs)), (recvs, stats)
        assert all(s["host_sync_fallbacks"] == 0 for s in stats), stats
        assert np.isfinite(m1["total_loss"]) and np.isfinite(m2["total_loss"])
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.cleanup()


def test_impala_device_broadcast_survives_dead_sampler(pod_cluster):
    """Kill one sampler between iterations: the sync loop respawns it, the
    replacement re-registers at its old rank (a roster epoch bump), and the
    next broadcast covers it: its bcast_recvs climb across the post-respawn
    steps while host_sync_fallbacks stays at most 1 (the sync that raced the
    respawn) and then flat."""
    cfg = _impala_config(weight_sync="device_broadcast")
    algo = cfg.build()
    try:
        algo.step()
        epoch = algo.learner_group.weight_group_roster(algo._weight_group)["epoch"]
        victim = algo.workers._workers[0]
        rt.kill(victim)
        _wait_dead(victim)
        algo.sync_worker_weights()  # respawns, re-registers and delivers
        assert algo.workers.num_workers == 2
        _wait_roster(algo, [0, 1, 2], epoch)
        _assert_samplers_hold_learner_weights(algo)
        m = algo.step()  # first post-respawn iteration: back on the broadcast plane
        assert np.isfinite(m["total_loss"])
        base = algo.workers.coll_stats()[0]  # the replacement
        assert base is not None and base["host_sync_fallbacks"] <= 1, base
        algo.step()
        after = algo.workers.coll_stats()[0]
        assert after["bcast_recvs"] > base["bcast_recvs"], (base, after)
        assert after["host_sync_fallbacks"] == base["host_sync_fallbacks"], (base, after)
        _assert_samplers_hold_learner_weights(algo)
    finally:
        algo.cleanup()


def test_impala_resize_oracle_weight_sync_stays_on_fast_path(pod_cluster):
    """Grow 2 -> 4 and shrink 4 -> 2 mid-IMPALA: growing joins the new
    samplers at fresh tail ranks, shrinking evicts the tail from the roster,
    no group is re-formed, and after the first post-resize iteration every
    live sampler resolves syncs from its inbox with host_sync_fallbacks flat."""
    cfg = _impala_config(weight_sync="device_broadcast")
    algo = cfg.build()
    try:
        assert algo._device_sync_ready
        algo.step()
        assert algo.resize_workers(4) == 4
        roster = algo.learner_group.weight_group_roster(algo._weight_group)
        assert roster["ranks"] == [0, 1, 2, 3, 4], roster
        _assert_samplers_hold_learner_weights(algo)
        m = algo.step()  # first post-grow iteration
        assert np.isfinite(m["total_loss"])
        base = algo.workers.coll_stats()
        assert all(s is not None for s in base), base
        algo.step()
        after = algo.workers.coll_stats()
        for b, a in zip(base, after):
            assert a["bcast_recvs"] > b["bcast_recvs"], (base, after)
            assert a["host_sync_fallbacks"] == b["host_sync_fallbacks"], (base, after)
        assert algo.resize_workers(2) == 2
        roster = algo.learner_group.weight_group_roster(algo._weight_group)
        assert roster["ranks"] == [0, 1, 2], roster  # tail ranks evicted
        m = algo.step()  # first post-shrink iteration
        assert np.isfinite(m["total_loss"])
        base = algo.workers.coll_stats()
        algo.step()
        after = algo.workers.coll_stats()
        for b, a in zip(base, after):
            assert a["host_sync_fallbacks"] == b["host_sync_fallbacks"], (base, after)
        _assert_samplers_hold_learner_weights(algo)
    finally:
        algo.cleanup()


def test_appo_device_broadcast_runs(pod_cluster):
    from ray_tpu_torch.rllib import APPOConfig

    cfg = (
        APPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, rollout_fragment_length=16)
        .training(lr=5e-4, train_batch_size=64, weight_sync="device_broadcast")
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        assert algo._device_sync_ready
        m = algo.step()
        assert np.isfinite(m["total_loss"])
        _assert_samplers_hold_learner_weights(algo)
    finally:
        algo.cleanup()


def test_impala_device_allreduce_grad_sync(pod_cluster):
    """Two learner actors with ``grad_sync="device_allreduce"``: every
    gradient sync rides the relay-tree allreduce as one packed vector, which
    the ``grad_allreduce_tree`` metric (the tree reduce sends seen inside the
    learner during its update) shows on every step; the learners stay equal."""
    cfg = _impala_config(grad_sync="device_allreduce").resources(num_learners=2)
    algo = cfg.build()
    try:
        m1 = algo.step()
        m2 = algo.step()
        for m in (m1, m2):
            assert np.isfinite(m["total_loss"]), m
            # The mean over the 2 learners; each did >= 1 tree reduce a step.
            assert m.get("grad_allreduce_tree", 0.0) >= 1.0, m
        w = rt.get([a.get_weights.remote() for a in algo.learner_group._actors])
        assert weights_checksum(w[0]) == weights_checksum(w[1])
    finally:
        algo.cleanup()


def _run_learner_group(grad_sync, optimizer, grad_clip, init):
    """Two port learner actors from ``init``, two updates on the batches:
    the metrics and both ranks' weights."""
    from ray_tpu_torch.rllib.algorithms.pg.pg import pg_loss
    from ray_tpu_torch.rllib.core import LearnerGroup, RLModuleSpec
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    group = LearnerGroup(RLModuleSpec(**SPEC), pg_loss, lr=GRAD_LR, grad_clip=grad_clip, num_learners=2,
                         grad_sync=grad_sync, optimizer=optimizer, device="cpu",
                         group_name=f"grads_{grad_sync}_{optimizer}")
    try:
        group.set_weights(init)
        metrics = [group.update(SampleBatch(dict(b)), LOSS_CFG) for b in _grad_batches()]
        return metrics, rt.get([a.get_weights.remote() for a in group._actors])
    finally:
        group.stop()


def _assert_trees_close(got, want, tol, what):
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want), strict=True)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol, err_msg=f"{what}, leaf {i}")


@pytest.mark.parametrize("grad_sync", ["device_allreduce", "host"])
def test_grad_sync_matches_reference_and_a_hand_averaged_step(pod_cluster, jax_grad_sync, grad_sync):
    """Two learners on the halves of each batch, from the same weights: with
    Adam and the clip the port's weights and metrics after two updates
    equal the JAX package's ``device_allreduce`` learners'; with SGD and no
    clip (both would hide a wrongly scaled mean) they equal one learner
    stepping on the mean of the two halves' gradients, computed here."""
    from ray_tpu_torch.rllib.algorithms.pg.pg import pg_loss
    from ray_tpu_torch.rllib.core import Learner, RLModuleSpec
    from ray_tpu_torch.rllib.core.learner import global_norm
    from ray_tpu_torch.rllib.core.rl_module import tree_leaves

    init, jmetrics, jweights = jax_grad_sync
    metrics, weights = _run_learner_group(grad_sync, "adam", GRAD_CLIP, init)
    for step, (got, want) in enumerate(zip(metrics, jmetrics)):
        tree = got.pop("grad_allreduce_tree", None)
        assert (tree is not None) == (grad_sync == "device_allreduce"), got
        if tree is not None:
            assert tree == want["grad_allreduce_tree"], (tree, want)
        want = {k: v for k, v in want.items() if k != "grad_allreduce_tree"}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **METRICS, err_msg=f"step {step} {k}")
    for rank in range(2):
        _assert_trees_close(weights[rank], jweights[rank], F32, f"adam, rank {rank} against the reference")

    metrics, weights = _run_learner_group(grad_sync, "sgd", None, init)
    oracle = Learner(RLModuleSpec(**SPEC), pg_loss, lr=GRAD_LR, optimizer="sgd", device="cpu")
    oracle.set_weights(init)
    for b in _grad_batches():
        halves = [oracle.compute_grads({k: v[lo:lo + 32] for k, v in b.items()}, LOSS_CFG)[2] for lo in (0, 32)]
        mean = [(g0 + g1) / 2 for g0, g1 in zip(*halves)]
        oracle.opt.step(mean, global_norm(mean))
    assert weights_checksum(weights[0]) == weights_checksum(weights[1])
    _assert_trees_close(weights[0], oracle.get_weights(), F32, "sgd against the hand-averaged step")
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(tree_leaves(weights[0]), tree_leaves(init)))
    assert moved > 1e-4, "the SGD steps should move the weights past the bars"


def test_only_a_worker_actor_pins_its_process_to_the_host(pod_cluster):
    """A rollout worker actor pins its process to the host (a CUDA tensor it
    receives is rebuilt on the CPU); a worker built in this process leaves
    this process unpinned."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.rllib.core import RLModuleSpec
    from ray_tpu_torch.rllib.evaluation.rollout_worker import RolloutWorker

    class Probe(RolloutWorker):
        def pinned(self) -> bool:
            from ray_tpu_torch._private.serialization import _HostPin

            return _HostPin.pinned

    spec = RLModuleSpec(**SPEC)
    local = Probe("CartPole-v1", spec)
    assert not local.pinned() and not serialization._HostPin.pinned
    actor = rt.remote(num_cpus=1)(Probe).remote("CartPole-v1", spec)
    try:
        assert rt.get(actor.pinned.remote(), timeout=60)
    finally:
        rt.kill(actor)
        local.stop()


def test_host_weight_sync_unchanged(pod_cluster):
    """The default stays the default: no group forms, no broadcast."""
    cfg = _impala_config()
    algo = cfg.build()
    try:
        assert not getattr(algo, "_device_sync_ready", False)
        m = algo.step()
        assert np.isfinite(m["total_loss"])
        _assert_samplers_hold_learner_weights(algo)
    finally:
        algo.cleanup()


def test_device_sync_failures_raise_instead_of_taking_the_host_path(pod_cluster, monkeypatch):
    """The reference degrades a failed weight-group setup and a failed
    broadcast to the host path with a warning
    (ray_tpu/rllib/algorithms/algorithm.py:373-379, :405-412); the port
    raises, so no sync quietly leaves the device path; a failed setup first
    releases its workers' CPUs."""
    from ray_tpu_torch.experimental import device_object
    from ray_tpu_torch.rllib.evaluation.rollout_worker import WorkerSet

    def refuse(*args, **kwargs):
        raise RuntimeError("planted: no weight group")

    with monkeypatch.context() as mp:
        mp.setattr(WorkerSet, "init_weight_group", refuse)
        with pytest.raises(RuntimeError, match="planted: no weight group"):
            _impala_config(weight_sync="device_broadcast").build()
    deadline = time.monotonic() + 60
    while rt.available_resources().get("CPU", 0) < rt.cluster_resources()["CPU"]:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.05)
    algo = _impala_config(weight_sync="device_broadcast").build()
    try:
        with monkeypatch.context() as mp:
            mp.setattr(device_object, "broadcast", refuse)
            with pytest.raises(RuntimeError, match="planted"):
                algo.sync_worker_weights()
        algo.sync_worker_weights()
        _assert_samplers_hold_learner_weights(algo)
    finally:
        algo.cleanup()
