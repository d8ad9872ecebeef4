"""The port's ES and ARS on the CPU, held to ``ray_tpu.rllib``, in one port
cluster (their worker actors).

- ``_flatten`` of the reference's weights carried across
  (``rl_module_params_from_jax``) against the reference's flat vector, bit for
  bit (the leaves in ``jax.tree_util``'s order, ``w`` as ``[in, out]``), for a
  discrete and a continuous module; ``_unflatten`` back.
- ``_centered_ranks`` on returns with ties (numpy's ``argsort`` on both
  sides).
- One ES update (centered ranks, Adam) and one ARS update (top-k by max(R+,
  R-) with ties, ``sigma_r``, the workers' observation statistics merged)
  from given returns and the seeds the reference drew, against the
  reference's ``training_step`` driven with its workers in this process (its
  ``ray_tpu.remote``/``get``/``kill`` stood in for: no JAX cluster): the flat
  vector, Adam's moments and the filter bit for bit; ``compute_single_action``
  from the same vector.
- An ES and an ARS worker actor's antithetic episode returns (and the ARS
  worker's observation statistics) from the reference's flat vector, equal to
  the reference worker's.
- The reference tests' learning bars on the port: ES > 35 within 6
  iterations, ARS >= 150 within 30, each stopping once met; ARS's checkpoint.

The updates are numpy float32 on both sides: equal, not close. ~25 s here.
"""

import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.rllib.algorithms.ars.ars as jars
import ray_tpu.rllib.algorithms.es.es as jes
import ray_tpu_torch as rt
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu_torch.rllib import ARSConfig, ESConfig
from ray_tpu_torch.rllib.algorithms.ars import ars as tars
from ray_tpu_torch.rllib.algorithms.es import es as tes
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, rl_module_params_from_jax, tree_leaves

ES_TRAINING = dict(episodes_per_batch=16, stepsize=0.02, noise_stdev=0.05, episode_horizon=200, eval_episodes=3,
                   model_hiddens=(16,))
ARS_TRAINING = dict(episodes_per_batch=16, num_top_directions=8, noise_stdev=0.05, stepsize=0.05,
                    episode_horizon=500, eval_episodes=3)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


class _InProcess:
    """An actor handle's stand-in: ``h.method.remote(*args)`` calls the
    method now; ``ray_tpu.get`` then returns the result as it is."""

    def __init__(self, obj):
        self.obj = obj

    def __getattr__(self, name):
        return types.SimpleNamespace(remote=getattr(self.obj, name))


@pytest.fixture
def in_process_reference(monkeypatch):
    """The reference's ES/ARS build their workers in this process: its
    ``ray_tpu.remote`` makes in-process stand-ins, ``get`` passes a result
    through, ``kill`` does nothing."""
    monkeypatch.setattr(ray_tpu, "remote", lambda **_: (lambda cls: types.SimpleNamespace(
        remote=lambda *a, **kw: _InProcess(cls(*a, **kw)))))
    monkeypatch.setattr(ray_tpu, "get", lambda ref, timeout=None: ref)
    monkeypatch.setattr(ray_tpu, "kill", lambda handle: None)


# -- the flat vector and the ranks ---------------------------------------------------


@pytest.mark.parametrize("kw", [dict(obs_dim=4, action_dim=2, discrete=True, hiddens=(16,)),
                                dict(obs_dim=3, action_dim=1, discrete=False, hiddens=(64, 64))],
                         ids=["discrete", "continuous"])
def test_flatten_matches_reference_bit_for_bit(kw):
    params = jrm.init_params(jax.random.PRNGKey(3), jrm.RLModuleSpec(**kw))
    want, _, want_shapes = jes._flatten(params)
    module = rl_module_params_from_jax(_host(params), RLModuleSpec(**kw), device="cpu")
    flat, template, shapes = tes._flatten(module)
    assert flat.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(flat, want)
    assert [tuple(s) for s in shapes] == [tuple(s) for s in want_shapes]
    back = tes._unflatten(flat, template, shapes)
    for got, w in zip(tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_centered_ranks_with_ties_match_reference():
    rng = np.random.default_rng(0)
    for n in (8, 32, 33):
        x = rng.integers(9, 13, n).astype(np.float32)  # CartPole-like integer returns: many ties
        np.testing.assert_array_equal(tes._centered_ranks(x), jes._centered_ranks(x))
    x = np.asarray([20.0, 20.0, 20.0, 15.0, 15.0, 200.0], np.float32)
    np.testing.assert_array_equal(tes._centered_ranks(x), jes._centered_ranks(x))


# -- the updates from given returns --------------------------------------------------


def _given_returns(n, seed):
    """Integer returns with many ties, in (R+, R-) pairs."""
    return np.random.default_rng(seed).integers(8, 14, (n, 2)).astype(np.float32)


def _feed(ref, returns):
    """Point the reference's in-process workers at ``returns``: each
    ``rollout`` answers the next pairs and records the seeds it was given;
    ``evaluate`` answers three 10-step episodes of reward 10."""
    seen, queue = [], list(map(tuple, returns))
    for w in ref._workers:
        def rollout(flat, seeds, sigma, horizon):
            seen.extend(int(s) for s in seeds)
            return [queue.pop(0) + (10,) for _ in seeds]

        w.obj.rollout = rollout
        w.obj.evaluate = lambda flat, episodes, horizon: [(10.0, 10)] * episodes
    return seen


def test_es_update_matches_reference(cluster, in_process_reference):
    ref = jes.ESConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ES_TRAINING) \
        .debugging(seed=0).build()
    ours = ESConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ES_TRAINING) \
        .debugging(seed=0).resources(device="cpu").build()
    try:
        flat0 = ref.flat.copy()
        returns = _given_returns(16, 1)
        seen = _feed(ref, returns)
        res = ref.training_step()
        # The port draws the reference's seeds from the same stream.
        np.testing.assert_array_equal(ours._np_rng.integers(0, 1 << 31, 16), np.asarray(seen))
        ours.flat = flat0.copy()
        grad = ours.es_update(returns, seen)
        np.testing.assert_array_equal(ours.flat, ref.flat)
        np.testing.assert_array_equal(ours._m, ref._m)
        np.testing.assert_array_equal(ours._v, ref._v)
        assert ours._t == ref._t == 1 and float(np.linalg.norm(grad)) == res["grad_norm"]
        obs = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
        assert [ours.compute_single_action(o) for o in obs] == [ref.compute_single_action(o) for o in obs]
    finally:
        ref.cleanup()
        ours.cleanup()


def test_ars_update_matches_reference(cluster, in_process_reference):
    ref = jars.ARSConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ARS_TRAINING) \
        .debugging(seed=0).build()
    ours = ARSConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ARS_TRAINING) \
        .debugging(seed=0).resources(device="cpu").build()
    try:
        flat0 = ref.flat.copy()
        returns = _given_returns(16, 3)
        assert len(set(returns.max(axis=1))) < 16  # ties at the top-k boundary's scale
        seen = _feed(ref, returns)
        rng = np.random.default_rng(4)
        drained = [(int(c), rng.normal(size=4).astype(np.float32) * c, rng.uniform(1, 2, 4).astype(np.float32) * c)
                   for c in (57, 81)]
        for w, d in zip(ref._workers, drained):
            w.obj.drain_obs_stats = lambda d=d: d
        res = ref.training_step()
        ours.merge_obs_stats(drained)
        np.testing.assert_array_equal(ours._obs_mean_cur, ref._obs_mean_cur)
        np.testing.assert_array_equal(ours._obs_std_cur, ref._obs_std_cur)
        assert ours._obs_count == ref._obs_count == 138
        ours.flat = flat0.copy()
        k, sigma_r = ours.ars_update(returns, seen)
        assert (k, sigma_r) == (res["top_directions_used"], res["return_std"]) == (8, sigma_r)
        np.testing.assert_array_equal(ours.flat, ref.flat)
        obs = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
        assert [ours.compute_single_action(o) for o in obs] == [ref.compute_single_action(o) for o in obs]
    finally:
        ref.cleanup()
        ours.cleanup()


# -- the workers ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["es", "ars"])
def test_worker_returns_match_reference(cluster, kind):
    """A worker actor of the port (pinned to the host) and the reference's
    worker in this process, from the reference's flat vector: the same
    antithetic returns and env steps; the ARS worker, normalizing with the
    same statistics, also the same raw observation sums."""
    jspec = jrm.RLModuleSpec(obs_dim=4, action_dim=2, discrete=True, hiddens=(16,))
    tspec = RLModuleSpec(obs_dim=4, action_dim=2, discrete=True, hiddens=(16,))
    flat, _, shapes = jes._flatten(jrm.init_params(jax.random.PRNGKey(0), jspec))
    jcls, tcls = (jes._ESWorker, tes._ESWorker) if kind == "es" else (jars._ARSWorker, tars._ARSWorker)
    ref = jcls("CartPole-v1", jspec, {}, shapes, 5)
    ours = rt.remote(num_cpus=1)(tcls).remote("CartPole-v1", tspec, {}, shapes, 5)
    try:
        if kind == "ars":
            mean, std = np.asarray([0.0, 0.1, 0.0, -0.1], np.float32), np.asarray([0.1, 0.5, 0.05, 0.5], np.float32)
            ref.set_obs_stats(mean, std)
            rt.get(ours.set_obs_stats.remote(mean, std))
        want = ref.rollout(flat, [11, 22], 0.05, 200)
        got = rt.get(ours.rollout.remote(flat, [11, 22], 0.05, 200))
        assert [tuple(x) for x in got] == [tuple(x) for x in want]
        assert rt.get(ours.evaluate.remote(flat, 1, 200)) == ref.evaluate(flat, 1, 200)
        if kind == "ars":
            (n1, s1, q1), (n2, s2, q2) = rt.get(ours.drain_obs_stats.remote()), ref.drain_obs_stats()
            assert n1 == n2 > 0
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(q1, q2)
    finally:
        rt.kill(ours)


# -- the reference tests' learning bars ----------------------------------------------


def test_es_improves_cartpole(cluster):
    """tests/test_rllib_algorithms.py's ES case: a mean eval reward above 35
    within 6 iterations (random CartPole is ~20)."""
    algo = ESConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ES_TRAINING) \
        .debugging(seed=0).resources(device="cpu").build()
    try:
        rewards = []
        for _ in range(6):
            r = algo.step()
            if np.isfinite(r["episode_reward_mean"]):
                rewards.append(r["episode_reward_mean"])
            if rewards and max(rewards) > 35:
                break
        assert max(rewards) > 35, f"ES made no progress: {rewards}"
        assert r["timesteps_total"] > 0
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.cleanup()


def test_ars_learns_cartpole(cluster):
    """tests/test_rllib_ars_crr.py's ARS case: a mean eval reward of 150
    within 30 iterations, with the observation filter; its checkpoint."""
    cfg = ARSConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2).training(**ARS_TRAINING) \
        .debugging(seed=0).resources(device="cpu")
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(30):
            reward = algo.step().get("episode_reward_mean")
            if reward == reward:  # not NaN
                best = max(best, reward)
            if best >= 150:
                break
        assert best >= 150, f"ARS failed to learn CartPole (best={best})"
        assert algo.compute_single_action([0.0, 0.1, 0.0, -0.1]) in (0, 1)
        ckpt = algo.save_checkpoint()
        algo.load_checkpoint(ckpt)
        np.testing.assert_array_equal(algo._obs_mean_cur, ckpt.to_dict()["obs_filter"]["mean"])
    finally:
        algo.cleanup()
