"""The port's continuous-action family on the CPU, held to ``ray_tpu.rllib``:
the port's Pendulum-v1, SAC, DDPG/TD3, CQL and CRR (no cluster).

- Pendulum-v1 against ``gymnasium.make("Pendulum-v1")`` step for step from
  three seeds: the reset draw, observations, rewards, and the truncation at
  200 steps.
- One ``train_step`` of SAC (continuous, discrete), CQL (continuous,
  discrete) and CRR (exp and binary weights, discrete and continuous) from
  the reference's weights (``*_params_from_jax``): the losses, the gradients
  (those the reference's step computes, recorded from an eager run of it), the
  Adam-updated weights and the Polyak targets. The reference's draws are rebuilt here from its key with
  the same ``split``/``fold_in`` calls its loss makes and passed to the port
  as its explicit draw tensors.
- DDPG and TD3: two consecutive steps, the first updating the actor, the
  second skipping it: the critic first, the actor through the UPDATED
  critic, the actor, its Adam moments and the targets untouched on the
  skipped step, and TD3's clipped target noise.
- SAC's and TD3's first iteration step for step from the reference's
  weights and draws: the replay buffer element for element through
  ``learning_starts``, within the stated bars after it.
- The reference's smoke tests at their sizes and bars, and each algorithm's
  checkpoint round trip.

Tolerances (f32 on the CPU, both sides): losses and metrics rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 / atol 1e-6, weights after an update rtol
1e-5 / atol 1e-6; replay rows after ``learning_starts`` and the weights
after an iteration (a hundred updates that each round in their own order)
rtol 1e-4 / atol 1e-5.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib.algorithms.sac.sac as jrl_sac
from ray_tpu.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS
from ray_tpu_torch.rllib.algorithms.cql import cql as tcql
from ray_tpu_torch.rllib.algorithms.crr import crr as tcrr
from ray_tpu_torch.rllib.algorithms.ddpg import ddpg as tddpg
from ray_tpu_torch.rllib.algorithms.sac import sac as tsac
from ray_tpu_torch.rllib.core.learner import to_device
from ray_tpu_torch.rllib.core.rl_module import copy_into, tree_leaves
from torch_rllib_reference import reference_grads

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small MLPs: one intra-op thread beside the suite's other test
    processes (as tests/test_torch_rllib_value.py), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _assert_tree(got, want, tol, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"{what} leaf {i}")


def _batch(B, obs_dim, action_dim, discrete, seed):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.normal(size=(B, obs_dim)).astype(np.float32),
        ACTIONS: (rng.integers(0, action_dim, B) if discrete
                  else rng.uniform(-0.95, 0.95, (B, action_dim)).astype(np.float32)),
        REWARDS: rng.normal(size=B).astype(np.float32),
        DONES: (rng.random(B) < 0.2).astype(np.float32),
        NEXT_OBS: rng.normal(size=(B, obs_dim)).astype(np.float32),
    }


def _pair(JC, TC, env, **training):
    """The reference algorithm and the port's (on the CPU), the port holding
    the reference's initial weights and targets."""
    ref = JC().environment(env).training(**training).debugging(seed=3).build()
    ours = TC().environment(env).training(**training).debugging(seed=3).resources(device="cpu").build()
    return ref, ours


# -- Pendulum-v1 ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 123])
def test_pendulum_matches_gymnasium(seed):
    from ray_tpu_torch.rllib.env import make

    ours, ref = make("Pendulum-v1"), gym.make("Pendulum-v1")
    assert ours.action_space.shape == ref.action_space.shape == (1,)
    np.testing.assert_array_equal(ours.action_space.low, ref.action_space.low)
    np.testing.assert_array_equal(ours.observation_space.high, ref.observation_space.high)
    o1, _ = ours.reset(seed=seed)
    o2, _ = ref.reset(seed=seed)
    np.testing.assert_array_equal(o1, o2)
    assert o1.dtype == o2.dtype == np.float32
    rng = np.random.default_rng(seed)
    ends = 0
    for t in range(450):
        u = rng.uniform(-3.0, 3.0, (1,)).astype(np.float32)  # beyond max_torque: the clip
        s1, s2 = ours.step(u), ref.step(u)
        np.testing.assert_array_equal(s1[0], s2[0])
        assert s1[1] == s2[1] and s1[2] is s2[2] is False and s1[3] == s2[3], t
        if s1[3]:
            ends += 1
            assert t + 1 == 200 * ends
            np.testing.assert_array_equal(ours.reset()[0], ref.reset()[0])  # the next draw of the stream
    assert ends == 2
    # The reset bounds of options, and stepping before a reset.
    np.testing.assert_array_equal(ours.reset(seed=seed, options={"x_init": 0.5, "y_init": 0.1})[0],
                                  ref.reset(seed=seed, options={"x_init": 0.5, "y_init": 0.1})[0])
    with pytest.raises(RuntimeError):
        make("Pendulum-v1").step(np.zeros(1, np.float32))


def test_pendulum_through_the_vector_env_matches_reference():
    """The reference's VectorEnv over gymnasium's Pendulum and the port's
    over its own: the same observations, rewards, ends and final
    observations (auto-reset included)."""
    from ray_tpu.rllib.env.vector_env import VectorEnv as JVec
    from ray_tpu_torch.rllib.env.vector_env import VectorEnv as TVec

    ours, ref = TVec("Pendulum-v1", 2, {}, 0, seed=5), JVec("Pendulum-v1", 2, {}, 0, seed=5)
    rng = np.random.default_rng(0)
    for _ in range(210):
        a = rng.uniform(-2, 2, (2, 1)).astype(np.float32)
        (o1, r1, d1, i1), (o2, r2, d2, i2) = ours.step(a), ref.step(a)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        for x, y in zip(i1, i2):
            assert x["truncated"] == y["truncated"] and x["terminated"] == y["terminated"]
            if "final_observation" in y:
                np.testing.assert_array_equal(x["final_observation"], y["final_observation"])
    assert ours.pop_episode_stats() == ref.pop_episode_stats()


# -- SAC ----------------------------------------------------------------------------


def _sac_draws(key, B, d):
    k1, k2 = jax.random.split(key)
    return {"next": _t(jax.random.normal(k1, (B, d))), "cur": _t(jax.random.normal(k2, (B, d)))}


@pytest.mark.parametrize("env", ["Pendulum-v1", "CartPole-v1"], ids=["continuous", "discrete"])
def test_sac_train_step_matches_reference(env):
    """One jitted train_step of the reference and the port's update from the
    reference's weights, batch and draws: the metrics, the gradients of the
    summed loss (one tree: actor, log_alpha, q1, q2), the weights after the
    one Adam step, and the Polyak targets toward the updated critics."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ref, ours = _pair(jrl.SACConfig, trl.SACConfig, env, train_batch_size=32, model_hiddens=(16, 16),
                      initial_alpha=0.5)
    try:
        jp, jt = ref.params, ref.target
        copy_into(ours.params, tsac.sac_params_from_jax(_host(jp), device="cpu"))
        copy_into(ours.target, tsac.sac_params_from_jax(_host(jt), device="cpu"))
        B, d = 32, ref.action_dim
        batch = _batch(B, ref.obs_dim, d, ref.discrete, 1)
        key = jax.random.PRNGKey(7)
        draws = {} if ref.discrete else _sac_draws(key, B, d)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        new_p, new_t, _, jm = ref._train_step(jp, jt, ref.opt_state, jb, key)
        jgrads = reference_grads(ref._train_step, jp, jt, ref.opt_state, jb, key)
        tb = to_device(batch, ours.device)
        tm, grads = ours.loss_and_grads(tb, draws)
        for g, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(_np(g), _np(want), **GRADS)
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **F32, err_msg=k)
        m = ours.update(batch, draws)
        for k in jm:
            np.testing.assert_allclose(_np(m[k]), _np(jm[k]), **F32, err_msg=k)
        _assert_tree(ours.params, new_p, F32, "params")
        _assert_tree(ours.target, new_t, F32, "target")
        assert ours.opt.count == 1
    finally:
        ref.cleanup()
        ours.cleanup()


def test_squashed_sample_matches_reference():
    """The squashed gaussian from the same actor and the same standard-normal
    draws: the action, its log-density (tanh jacobian included) and
    tanh(mean), with log_std past both clip bounds."""
    params = jrl_sac._mlp_params(jax.random.PRNGKey(0), 3, (8,), 4)
    params[-1]["b"] = jnp.asarray([0.0, 0.3, -25.0, 3.0])  # log_std below -20 and above 2
    obs = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    a, logp, det = jrl_sac._squashed_sample(params, jnp.asarray(obs), key, 2)
    ta, tlogp, tdet = tsac._squashed_sample(tsac.mlp_params_from_jax(_host(params), device="cpu"),
                                            torch.from_numpy(obs), _t(jax.random.normal(key, (16, 2))), 2)
    for got, want in ((ta, a), (tlogp, logp), (tdet, det)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def _mirror_keys(algo, seed, hooks):
    """Route the port algorithm's draw hooks through the reference's key
    chain (``PRNGKey(seed + 1)``, one ``split`` a call, as its
    training_step splits)."""
    state = {"rng": jax.random.PRNGKey(seed + 1)}

    def next_key():
        state["rng"], key = jax.random.split(state["rng"])
        return key

    for name, make in hooks.items():
        setattr(algo, name, (lambda make: lambda n: make(next_key(), n))(make))


@pytest.mark.parametrize("algo", ["SAC", "TD3"])
def test_first_iteration_matches_reference_step_for_step(algo):
    """300 Pendulum steps with learning_starts 200 (then 100 updates of 64):
    from the reference's weights, with its draws, the replay buffer holds
    the reference's transitions element for element through
    learning_starts and within TRAJ after it, then the weights and targets
    within TRAJ."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    kw = dict(train_batch_size=64, learning_starts=200, rollout_steps_per_iter=300, model_hiddens=(32, 32))
    ref = getattr(jrl, f"{algo}Config")().environment("Pendulum-v1").training(**kw).debugging(seed=0).build()
    ours = (getattr(trl, f"{algo}Config")().environment("Pendulum-v1").training(**kw)
            .resources(device="cpu").debugging(seed=0).build())
    try:
        if algo == "SAC":
            convert = tsac.sac_params_from_jax
            _mirror_keys(ours, 0, {"_act_draws": lambda k, n: _t(jax.random.normal(k, (n, 1))),
                                   "_update_draws": lambda k, n: _sac_draws(k, n, 1)})
        else:
            convert = tddpg.ddpg_params_from_jax
            _mirror_keys(ours, 0, {"_target_noise": lambda k, n: _t(jax.random.normal(k, (n, 1)))})
        copy_into(ours.params, convert(_host(ref.params), device="cpu"))
        copy_into(ours.target, convert(_host(ref.target), device="cpu"))
        rm, om = ref.step(), ours.step()
        start = 200
        for k in ref.buffer._cols:
            got, want = ours.buffer._cols[k], ref.buffer._cols[k]
            np.testing.assert_array_equal(got[:start], want[:start], err_msg=k)
            np.testing.assert_allclose(got[start:300], want[start:300], **TRAJ, err_msg=k)
        assert ours._timesteps_total == ref._timesteps_total == 300
        for k in rm:
            if k not in ("time_this_iter_s", "episode_reward_mean"):
                np.testing.assert_allclose(om[k], rm[k], **TRAJ, err_msg=k)
        np.testing.assert_allclose(om["episode_reward_mean"], rm["episode_reward_mean"], **TRAJ)
        _assert_tree(ours.params, ref.params, TRAJ, "params")
        _assert_tree(ours.target, ref.target, TRAJ, "target")
        if algo == "TD3":
            assert ours._updates == ref._updates == 101
    finally:
        ref.cleanup()
        ours.cleanup()


# -- DDPG / TD3 ------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["DDPG", "TD3"])
def test_ddpg_steps_update_critic_first_and_skip_the_actor(algo):
    """Two consecutive reference train_steps (update_actor 1, then 0) and the
    port's from the same weights, batches and target noise: the metrics, the
    weights, both Adam states and the targets after each; on the skipped
    step the actor, its moments and the targets stay bit for bit."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ref, ours = _pair(getattr(jrl, f"{algo}Config"), getattr(trl, f"{algo}Config"), "Pendulum-v1",
                      train_batch_size=32, model_hiddens=(16, 16))
    try:
        copy_into(ours.params, tddpg.ddpg_params_from_jax(_host(ref.params), device="cpu"))
        copy_into(ours.target, tddpg.ddpg_params_from_jax(_host(ref.target), device="cpu"))
        p, t, o = ref.params, ref.target, ref.opt_state
        for step, update_actor in enumerate((1.0, 0.0)):
            batch = _batch(32, 3, 1, False, 10 + step)
            key = jax.random.PRNGKey(20 + step)
            noise = _t(jax.random.normal(key, (32, 1)))
            before = {k: [x.clone() for x in tree_leaves(v)] for k, v in (("actor", ours.params["actor"]),
                                                                          ("target", ours.target))}
            moments = [x.clone() for x in ours.opt["actor"].mu + ours.opt["actor"].nu]
            p, t, o, jm = ref._train_step(p, t, o, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                          jnp.asarray(update_actor, jnp.float32))
            m, _ = ours.train_step(batch, bool(update_actor), noise if algo == "TD3" else None)
            for k in jm:
                np.testing.assert_allclose(_np(m[k]), _np(jm[k]), **F32, err_msg=k)
            _assert_tree(ours.params, p, F32, f"params after step {step}")
            _assert_tree(ours.target, t, F32, f"target after step {step}")
            for name in ("actor", "critic"):
                mu = jax.tree_util.tree_leaves(o[name][0].mu)
                np.testing.assert_allclose(np.concatenate([_np(x).ravel() for x in ours.opt[name].mu]),
                                           np.concatenate([np.asarray(x).ravel() for x in mu]), **F32)
            if not update_actor:
                assert float(m["actor_loss"]) == 0.0 and ours.opt["actor"].count == 1
                for x, y in zip(tree_leaves(ours.params["actor"]), before["actor"]):
                    assert torch.equal(x, y)
                for x, y in zip(tree_leaves(ours.target), before["target"]):
                    assert torch.equal(x, y)
                for x, y in zip(ours.opt["actor"].mu + ours.opt["actor"].nu, moments):
                    assert torch.equal(x, y)
        assert ours.opt["critic"].count == 2
    finally:
        ref.cleanup()
        ours.cleanup()


def test_td3_target_noise_is_clipped_then_the_action():
    """TD3's smoothing: noise * 0.2 clipped to [-0.5, 0.5], then the
    smoothed action clipped to [-1, 1] — the critic loss at large draws
    equals the reference's, and differs from the unclipped one's."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ref, ours = _pair(jrl.TD3Config, trl.TD3Config, "Pendulum-v1", train_batch_size=16, model_hiddens=(8,))
    try:
        copy_into(ours.params, tddpg.ddpg_params_from_jax(_host(ref.params), device="cpu"))
        copy_into(ours.target, tddpg.ddpg_params_from_jax(_host(ref.target), device="cpu"))
        batch = _batch(16, 3, 1, False, 4)
        key = jax.random.PRNGKey(2)
        big = jax.random.normal(key, (16, 1)) * 10.0  # most past the 0.5 / 0.2 = 2.5 clip
        cfg = ours._algo_config
        tb = to_device(batch, torch.device("cpu"))
        kw = dict(gamma=cfg.gamma, twin_q=True, smooth=True, target_noise=0.2, noise_clip=0.5)
        got, _, _ = tddpg.ddpg_critic_loss(ours._critic(), ours.target, tb, _t(big), **kw)
        jt = ref.target
        next_a = jnp.tanh(jrl_sac._mlp_apply(jt["actor"], jnp.asarray(batch[NEXT_OBS])))
        next_a = jnp.clip(next_a + jnp.clip(big * 0.2, -0.5, 0.5), -1.0, 1.0)

        def qv(q, o, a):
            return jrl_sac._mlp_apply(q, jnp.concatenate([o, a], -1))[:, 0]

        nobs, obs = jnp.asarray(batch[NEXT_OBS]), jnp.asarray(batch[OBS])
        tq = jnp.minimum(qv(jt["q1"], nobs, next_a), qv(jt["q2"], nobs, next_a))
        y = batch[REWARDS] + cfg.gamma * (1 - batch[DONES]) * tq
        want = (jnp.mean((qv(ref.params["q1"], obs, batch[ACTIONS]) - y) ** 2)
                + jnp.mean((qv(ref.params["q2"], obs, batch[ACTIONS]) - y) ** 2))
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        loose, _, _ = tddpg.ddpg_critic_loss(ours._critic(), ours.target, tb, _t(big),
                                             **dict(kw, noise_clip=100.0))
        assert abs(float(loose.detach()) - float(got.detach())) > 1e-4
    finally:
        ref.cleanup()
        ours.cleanup()


# -- CQL --------------------------------------------------------------------------------


def _cql_data(tmp_path, env_id, n=400, seed=0):
    """tests/test_rllib_algorithms.py's random-policy dataset, through the
    port's env and the port's JsonWriter (the reference reads the same
    files)."""
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    env = make(env_id)
    discrete = env_id == "CartPole-v1"
    path = str(tmp_path / f"data_{env_id}")
    writer = JsonWriter(path)
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
    for _ in range(n):
        a = np.int64(rng.integers(2)) if discrete else rng.uniform(-1, 1, size=(1,)).astype(np.float32)
        nobs, r, term, trunc, _ = env.step(a if discrete else a * 2.0)
        rows[OBS].append(np.asarray(obs, np.float32))
        rows[ACTIONS].append(a)
        rows[REWARDS].append(np.float32(r))
        rows[DONES].append(np.float32(term or trunc))
        rows[NEXT_OBS].append(np.asarray(nobs, np.float32))
        obs = nobs
        if term or trunc:
            obs, _ = env.reset()
    writer.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    writer.close()
    return path


def _cql_draws(key, B, n, d):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return {"next": _t(jax.random.normal(k1, (B, d))),
            "rand": _t(jax.random.uniform(k2, (B, n, d), minval=-1.0, maxval=1.0)),
            "pol": _t(jax.random.normal(k3, (B * n, d))), "cur": _t(jax.random.normal(k4, (B, d)))}


@pytest.mark.parametrize("env", ["Pendulum-v1", "CartPole-v1"], ids=["continuous", "discrete"])
def test_cql_train_step_matches_reference(env, tmp_path):
    """One CQL train_step from the reference's weights on a reader batch both
    read from the same files (seeded alike), with the reference's four
    draws: the metrics (bellman, the conservative term), the gradients of
    the whole loss, the weights and the targets."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    path = _cql_data(tmp_path, env, n=120)
    kw = dict(train_batch_size=32, model_hiddens=(16, 16), cql_alpha=0.5, num_cql_actions=3)
    ref = jrl.CQLConfig().environment(env).offline_data(input_=path).training(**kw).debugging(seed=3).build()
    ours = (trl.CQLConfig().environment(env).offline_data(input_=path).training(**kw)
            .resources(device="cpu").debugging(seed=3).build())
    try:
        copy_into(ours.params, tcql.cql_params_from_jax(_host(ref.params), device="cpu"))
        copy_into(ours.target, tcql.cql_params_from_jax(_host(ref.target), device="cpu"))
        raw_j, raw_t = ref.reader.next(32), ours.reader.next(32)
        np.testing.assert_array_equal(np.asarray(raw_t[OBS]), np.asarray(raw_j[OBS]))
        tb = ours.read_batch(raw_t)
        key = jax.random.PRNGKey(9)
        B, n, d = 32, 3, ref.action_dim
        draws = {} if ref.discrete else _cql_draws(key, B, n, d)
        actions = np.asarray(raw_j[ACTIONS])
        if not ref.discrete:
            actions = np.clip((actions.reshape(B, -1).astype(np.float32) - ref._act_offset)
                              / np.maximum(ref._act_scale, 1e-8), -1.0, 1.0)
        jb = {OBS: jnp.asarray(np.asarray(raw_j[OBS], np.float32)), ACTIONS: jnp.asarray(actions),
              REWARDS: jnp.asarray(np.asarray(raw_j[REWARDS], np.float32)),
              DONES: jnp.asarray(np.asarray(raw_j[DONES], np.float32)),
              NEXT_OBS: jnp.asarray(np.asarray(raw_j[NEXT_OBS], np.float32))}
        np.testing.assert_array_equal(_np(tb[ACTIONS]), np.asarray(jb[ACTIONS]))
        new_p, new_t, _, jm = ref._train_step(ref.params, ref.target, ref.opt_state, jb, key)
        tm, grads = ours.loss_and_grads(tb, draws)
        for k in jm:
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **F32, err_msg=k)
        jgrads = reference_grads(ref._train_step, ref.params, ref.target, ref.opt_state, jb, key)
        for g, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(_np(g), _np(want), **GRADS)
        m = ours.update(tb, draws)
        for k in jm:
            np.testing.assert_allclose(_np(m[k]), _np(jm[k]), **F32, err_msg=k)
        _assert_tree(ours.params, new_p, F32, "params")
        _assert_tree(ours.target, new_t, F32, "target")
    finally:
        ref.cleanup()
        ours.cleanup()


def test_cql_offline_smoke(tmp_path):
    """tests/test_rllib_algorithms.py's case: its data, config and checks,
    plus the checkpoint round trip's state."""
    from ray_tpu_torch.rllib import CQLConfig

    path = _cql_data(tmp_path, "Pendulum-v1")
    cfg = (CQLConfig().environment("Pendulum-v1").offline_data(input_=path)
           .training(train_batch_size=32, updates_per_iter=20, model_hiddens=(32, 32), cql_alpha=0.5)
           .resources(device="cpu").debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        r = algo.step()
        assert np.isfinite(r["bellman_loss"])
        assert np.isfinite(r["cql_term"])
        a = algo.compute_single_action(np.zeros(3, np.float32))
        assert a.shape == (1,)
        _roundtrip(algo, algo2, ("params", "target"))
        assert algo2._timesteps_total == 20 * 32
    finally:
        algo.cleanup()
        algo2.cleanup()


def _roundtrip(algo, algo2, trees):
    """save -> load into a second build: the trees bit for bit, the Adam
    states, the generator's state (its next draws), the numpy stream."""
    algo.load_checkpoint(algo.save_checkpoint())  # loading into itself changes nothing
    ckpt = algo.save_checkpoint()
    algo2.load_checkpoint(ckpt)
    for name in trees:
        for a, b in zip(tree_leaves(getattr(algo, name)), tree_leaves(getattr(algo2, name))):
            assert torch.equal(a.detach(), b.detach()), name
    opts = algo.opt if isinstance(algo.opt, dict) else {"": algo.opt}
    opts2 = algo2.opt if isinstance(algo2.opt, dict) else {"": algo2.opt}
    for k in opts:
        s1, s2 = opts[k].state_dict(), opts2[k].state_dict()
        assert s1["count"] == s2["count"] > 0
        for a, b in zip(s1["mu"] + s1["nu"], s2["mu"] + s2["nu"]):
            np.testing.assert_array_equal(a, b)
    assert torch.equal(torch.randn(4, generator=algo._gen), torch.randn(4, generator=algo2._gen))
    if hasattr(algo, "_np_rng"):
        assert algo._np_rng.random() == algo2._np_rng.random()
    assert algo2._timesteps_total == algo._timesteps_total


# -- SAC / TD3 smoke -------------------------------------------------------------------------


def test_sac_pendulum_smoke():
    """tests/test_rllib_algorithms.py's case and checks, and the round trip."""
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig().environment("Pendulum-v1")
           .training(lr=3e-4, train_batch_size=64, learning_starts=200, rollout_steps_per_iter=300,
                     model_hiddens=(32, 32))
           .resources(device="cpu").debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        for _ in range(3):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert np.isfinite(r["alpha"]) and r["alpha"] > 0
        a = algo.compute_single_action(np.zeros(3, np.float32))
        assert a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0
        _roundtrip(algo, algo2, ("params", "target"))
        obs = np.array([1.0, 0.0, 0.5], np.float32)
        np.testing.assert_array_equal(algo.compute_single_action(obs), algo2.compute_single_action(obs))
    finally:
        algo.cleanup()
        algo2.cleanup()


def test_sac_discrete_smoke():
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig().environment("CartPole-v1")
           .training(lr=3e-4, train_batch_size=64, learning_starts=200, rollout_steps_per_iter=300,
                     model_hiddens=(32, 32), target_entropy=0.3)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    try:
        r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
        assert algo.compute_single_action(np.zeros(4, np.float32), explore=True) in (0, 1)
    finally:
        algo.cleanup()


def test_td3_pendulum_smoke():
    from ray_tpu_torch.rllib import TD3Config

    cfg = (TD3Config().environment("Pendulum-v1")
           .training(lr=1e-3, train_batch_size=64, learning_starts=200, rollout_steps_per_iter=300,
                     model_hiddens=(32, 32))
           .resources(device="cpu").debugging(seed=0))
    assert cfg.twin_q and cfg.policy_delay == 2 and cfg.smooth_target_policy
    algo, algo2 = cfg.build(), cfg.build()
    try:
        for _ in range(2):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        a = algo.compute_single_action(np.zeros(3, np.float32))
        assert -2.0 <= float(a[0]) <= 2.0
        _roundtrip(algo, algo2, ("params", "target"))
        assert algo2._updates == algo._updates == 401
    finally:
        algo.cleanup()
        algo2.cleanup()


# -- CRR -------------------------------------------------------------------------------


def _crr_draws(key, n, B, d):
    out = {}
    for name, j in (("next", 1), ("cur", 2)):
        sub = jax.random.fold_in(key, j)
        out[name] = torch.stack([_t(jax.random.normal(jax.random.fold_in(sub, i), (B, d))) for i in range(n)])
    return out


@pytest.mark.parametrize("weight_type", ["exp", "binary"])
@pytest.mark.parametrize("env", ["Pendulum-v1", "CartPole-v1"], ids=["continuous", "discrete"])
def test_crr_update_matches_reference(env, weight_type, tmp_path):
    """One CRR update from the reference's weights on a reader batch, with
    its fold_in draws: the metrics, the gradients, the weights and target_q.
    (Actions at the box's edge, where the inverse tanh's clips act, are
    test_crr_inverse_tanh_at_the_clip's.)"""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    path = _cql_data(tmp_path, env, n=120, seed=1)
    kw = dict(train_batch_size=32, model_hiddens=(16, 16), weight_type=weight_type, n_action_samples=3,
              temperature=0.5)
    ref = jrl.CRRConfig().environment(env).offline_data(input_=path).training(**kw).debugging(seed=4).build()
    ours = (trl.CRRConfig().environment(env).offline_data(input_=path).training(**kw)
            .resources(device="cpu").debugging(seed=4).build())
    try:
        copy_into(ours.params, tcrr.crr_params_from_jax(_host(ref.params), device="cpu"))
        copy_into(ours.target_q, tcrr.crr_params_from_jax(_host(ref.target_q), device="cpu"))
        raw = ref.reader.next(32)
        ours.reader.next(32)
        jb = {k: jnp.asarray(np.asarray(raw[k], np.float32)) for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
        if not ref.discrete:
            jb[ACTIONS] = (jb[ACTIONS] - ref._act_offset) / ref._act_scale
        tb = ours.read_batch(raw)
        np.testing.assert_array_equal(_np(tb[ACTIONS]), np.asarray(jb[ACTIONS]))
        key = jax.random.PRNGKey(11)
        draws = {} if ref.discrete else _crr_draws(key, 3, 32, ref.action_dim)
        new_p, new_t, _, aux = ref._update(ref.params, ref.target_q, ref.opt_state, jb, key)
        total, taux, grads = ours.loss_and_grads(tb, draws)
        np.testing.assert_allclose(_np(total), _np(aux["total_loss"]), **F32)
        for k in taux:
            np.testing.assert_allclose(_np(taux[k]), _np(aux[k]), **F32, err_msg=k)
        jgrads = reference_grads(ref._update, ref.params, ref.target_q, ref.opt_state, jb, key)
        for g, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(_np(g), _np(want), **GRADS)
        m = ours.update(tb, draws)
        np.testing.assert_allclose(_np(m["total_loss"]), _np(aux["total_loss"]), **F32)
        _assert_tree(ours.params, new_p, F32, "params")
        _assert_tree(ours.target_q, new_t, F32, "target_q")
        if weight_type == "binary":
            assert 0.0 <= float(m["mean_weight"]) <= 1.0
    finally:
        ref.cleanup()
        ours.cleanup()


def test_crr_inverse_tanh_at_the_clip():
    """Dataset actions at the box's edge: the 1e-6 clips give atanh(1 - 1e-6)
    on both sides, and the port's jacobian term log(1 - a^2 + 1e-6) equals
    the expression evaluated in f64, as eager JAX's does; the reference's
    compiled program folds it into (1 + 1e-6) - a^2 and lands more than 0.01
    lower there (ROADMAP C17), and agrees off the edge."""
    a = np.array([[1.0], [-1.0], [0.99999994], [0.5]], np.float32)

    def jterm(a):
        a = jnp.clip(a, -1 + 1e-6, 1 - 1e-6)
        return jnp.arctanh(a), jnp.log(1 - jnp.square(a) + 1e-6)

    ta = torch.clamp(torch.from_numpy(a), -1 + 1e-6, 1 - 1e-6)
    edge = np.arctanh(np.float64(np.float32(1 - 1e-6)))
    want = np.log(1 - np.float64(ta.numpy()) ** 2 + 1e-6)
    np.testing.assert_allclose(_np(torch.atanh(ta)), _np(jterm(a)[0]), **F32)
    np.testing.assert_allclose(_np(torch.atanh(ta))[:3, 0], [edge, -edge, edge], **F32)
    np.testing.assert_allclose(_np(torch.log(1 - torch.square(ta) + 1e-6)), want, **F32)
    np.testing.assert_allclose(_np(jterm(a)[1]), want, **F32)  # eager: as written
    jit = _np(jax.jit(jterm)(a)[1])
    np.testing.assert_allclose(jit[3], want[3], **F32)
    assert np.all(want[:3] - jit[:3] > 1e-2)
    # The port's loss at those rows: exp weights of a flat critic are 1, so
    # the actor loss is minus the mean log-density, the f64 value's.
    mean, log_std = 0.25, -0.5
    batch = {OBS: torch.zeros(4, 3), ACTIONS: torch.from_numpy(a), REWARDS: torch.zeros(4), DONES: torch.ones(4),
             NEXT_OBS: torch.zeros(4, 3)}
    actor = [{"w": torch.zeros(3, 2), "b": torch.tensor([mean, log_std])}]
    q = [{"w": torch.zeros(4, 1), "b": torch.zeros(1)}]
    eps = torch.zeros(2, 4, 1)
    _, m = tcrr.crr_loss({"actor": actor, "q": q}, q, batch, {"next": eps, "cur": eps}, discrete=False, gamma=0.99,
                         beta=1.0, wmax=20.0, binary=False)
    pre = np.arctanh(np.float64(ta.numpy()))
    logp = -0.5 * ((pre - mean) ** 2 / np.exp(2 * log_std) + 2 * log_std + np.log(2 * np.pi)) - want
    np.testing.assert_allclose(_np(m["mean_weight"]), 1.0)
    np.testing.assert_allclose(_np(m["actor_loss"]), -logp.mean(), **F32)


def _expert_action(obs) -> int:
    """Decent scripted CartPole controller (pole angle + velocity)."""
    return int(obs[2] + 0.3 * obs[3] > 0)


def _crr_cartpole_data(path, steps, seed, expert_share):
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    env = make("CartPole-v1")
    writer = JsonWriter(path)
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
    obs, _ = env.reset(seed=seed)
    for _ in range(steps):
        a = _expert_action(obs) if expert_share and rng.random() < expert_share else int(rng.integers(2))
        nobs, r, term, trunc, _ = env.step(a)
        rows[OBS].append(np.asarray(obs, np.float32))
        rows[ACTIONS].append(np.int64(a))
        rows[REWARDS].append(np.float32(r))
        rows[DONES].append(np.float32(term or trunc))
        rows[NEXT_OBS].append(np.asarray(nobs, np.float32))
        obs = nobs
        if term or trunc:
            obs, _ = env.reset()
    writer.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    writer.close()
    return env


def test_crr_learns_cartpole_offline(tmp_path):
    """tests/test_rllib_ars_crr.py's case: 60% expert / 40% random data
    through the port's CartPole, its config and bar (>= 120 over the same
    five evaluation episodes). Its budget, 10 iterations, is the most this
    spends: the policy is evaluated after each iteration and the run stops
    once the bar is met."""
    from ray_tpu_torch.rllib import CRRConfig

    env = _crr_cartpole_data(str(tmp_path / "crr_data"), 6000, 0, 0.6)
    cfg = (CRRConfig().environment("CartPole-v1").offline_data(input_=str(tmp_path / "crr_data"))
           .training(lr=1e-3, train_batch_size=256, updates_per_iter=300, weight_type="exp", temperature=1.0)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    try:
        for _ in range(10):
            r = algo.step()
            assert np.isfinite(r["total_loss"])
            rewards = []
            for ep in range(5):
                obs, _ = env.reset(seed=100 + ep)
                total = 0.0
                for _ in range(500):
                    obs, rr, term, trunc, _ = env.step(algo.compute_single_action(obs))
                    total += rr
                    if term or trunc:
                        break
                rewards.append(total)
            mean_r = float(np.mean(rewards))
            if mean_r >= 120:
                break
        assert mean_r >= 120, f"CRR failed to recover the expert (reward={mean_r})"
    finally:
        env.close()
        algo.cleanup()


def test_crr_binary_weights_smoke(tmp_path):
    """tests/test_rllib_ars_crr.py's case, and the checkpoint round trip."""
    from ray_tpu_torch.rllib import CRRConfig

    _crr_cartpole_data(str(tmp_path / "crr_bin"), 1000, 1, 0.0).close()
    cfg = (CRRConfig().environment("CartPole-v1").offline_data(input_=str(tmp_path / "crr_bin"))
           .training(updates_per_iter=50, weight_type="binary").resources(device="cpu").debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        r = algo.step()
        assert np.isfinite(r["total_loss"])
        assert 0.0 <= r["mean_weight"] <= 1.0  # binary weights are indicators
        _roundtrip(algo, algo2, ("params", "target_q"))
        obs = np.array([0.0, 0.1, 0.0, -0.1], np.float32)
        assert algo2.compute_single_action(obs) == algo.compute_single_action(obs) in (0, 1)
    finally:
        algo.cleanup()
        algo2.cleanup()
