"""The port's value-based algorithms on the CPU, held to ``ray_tpu.rllib``:
DQN, SimpleQ, Ape-X DQN and R2D2.

- ``dqn_loss`` and its gradients from the same weights on the same batch
  (with and without importance weights); the TD targets (double-Q and plain)
  and the priorities written after an update.
- DQN's and SimpleQ's first iteration step for step against the reference
  from the reference's initial weights: the exploration and replay draws are
  numpy in both, the port's CartPole is gymnasium's, so every transition in
  the replay buffer must be equal, then the weights within f32 bars. The
  smallest gap between the two best Q-values the reference acted on is
  recorded: a parting at an argmax tie would show there, not as a fault.
- R2D2's ``gru_cell``, ``q_scan``, ``h_rescale``/``h_inverse``, the loss, its
  gradients and one clipped Adam step (``r2d2_params_from_jax``).
- Ape-X's epsilon ladder and its explorers' transitions against the
  reference's, and the shard round-robin (one port cluster, lazily booted
  for those cases).
- SimpleQ's rejection of DQN's extensions, SimpleQ learning CartPole at the
  reference test's bar, and the DQN and R2D2 checkpoint round trips.

Tolerances (f32 on the CPU, both sides): losses and metrics rtol 1e-5 (1e-4
for a learner update's metrics, as in tests/test_torch_rllib.py), gradients
rtol 1e-4 / atol 1e-6, weights after updates rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms.dqn.dqn import dqn_loss as j_dqn_loss
from ray_tpu.rllib.algorithms.dqn.dqn import q_forward as j_q_forward
from ray_tpu.rllib.algorithms.r2d2 import r2d2 as jr2
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu_torch.rllib.algorithms.dqn.dqn import dqn_loss, td_errors, td_targets
from ray_tpu_torch.rllib.algorithms.r2d2 import r2d2 as tr2
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
METRICS = dict(rtol=1e-4, atol=1e-6)
SPEC = dict(obs_dim=4, action_dim=3, discrete=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's updates are tens to hundreds of rows: torch's intra-op
    pool over every core, beside the suite's other test processes, made
    SimpleQ's learning case ~90x slower. One thread for the module,
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _modules(seed):
    """The reference's params (seeded) and the port's module holding them."""
    jspec, tspec = jrm.RLModuleSpec(**SPEC), trm.RLModuleSpec(**SPEC)
    params = jrm.init_params(jax.random.PRNGKey(seed), jspec)
    module = trm.rl_module_params_from_jax(jax.tree_util.tree_map(np.asarray, params), tspec, device="cpu")
    return jspec, params, tspec, module


def _transitions(n, seed):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.normal(size=(n, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 3, n),
        REWARDS: rng.normal(1.0, 0.5, n).astype(np.float32),
        DONES: (rng.random(n) < 0.1).astype(np.float32),
        NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, n).astype(np.float32),
    }


# -- DQN's loss, targets and priorities --------------------------------------


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
def test_dqn_loss_and_grads_match_reference(weighted):
    jspec, params, tspec, module = _modules(1)
    batch = _transitions(64, 2)
    batch["td_target"] = np.random.default_rng(3).normal(2.0, 1.0, 64).astype(np.float32)
    keys = [OBS, ACTIONS, "td_target"] + (["weights"] if weighted else [])
    jb = {k: jnp.asarray(batch[k]) for k in keys}
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: j_dqn_loss(p, jb, jspec, {}), has_aux=True)(params)
    tb = {k: torch.from_numpy(batch[k]) for k in keys}
    leaves = trm.tree_leaves(module.param_tree())
    tloss, tm = dqn_loss(module, tb, tspec, {})
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    np.testing.assert_allclose(_np(tloss), _np(jloss), **F32)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **F32, err_msg=k)
    for p, g, want in zip(leaves, tgrads, jax.tree_util.tree_leaves(jgrads)):
        got = np.zeros(p.shape, np.float32) if g is None else _np(g)  # the value head: jax.grad's zeros
        np.testing.assert_allclose(got, _np(want), **GRADS)


@pytest.mark.parametrize("double_q", [True, False], ids=["double_q", "max"])
def test_td_targets_and_priorities_match_reference(double_q):
    """The targets as the reference's _train_once computes them (numpy over
    its jitted Q forwards, online and target weights apart), and the
    priorities a prioritized buffer holds after the port's update_priorities."""
    jspec, online, tspec, t_online = _modules(4)
    _, target, _, t_target = _modules(5)
    batch = _transitions(32, 6)
    gamma = 0.99
    q_next_target = np.asarray(j_q_forward(target, jnp.asarray(batch[NEXT_OBS]), jspec))
    if double_q:
        best = np.asarray(j_q_forward(online, jnp.asarray(batch[NEXT_OBS]), jspec)).argmax(axis=-1)
        q_next = q_next_target[np.arange(len(best)), best]
    else:
        q_next = q_next_target.max(axis=-1)
    want = (batch[REWARDS] + gamma * (1.0 - batch[DONES]) * q_next).astype(np.float32)
    got = td_targets(t_online, t_target, batch, gamma, double_q)
    np.testing.assert_allclose(_np(got), want, **F32)
    # The priorities after an update: |Q(s, a) - target| + 1e-6 at the
    # sampled rows, written by the same buffer code on both sides.
    q = np.asarray(j_q_forward(online, jnp.asarray(batch[OBS]), jspec))
    want_err = q[np.arange(32), batch[ACTIONS]] - want
    bufs = []
    for err in (td_errors(t_online, batch, got), want_err):
        buf = PrioritizedReplayBuffer(128, seed=0)
        from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

        buf.add(SampleBatch({k: v for k, v in _transitions(128, 7).items() if k != "weights"}))
        buf.sample(32)
        buf.update_priorities(err)
        bufs.append(buf._priorities)
    np.testing.assert_allclose(bufs[0], bufs[1], **F32)


# -- the first iteration, step for step ---------------------------------------


def _q_config(C, double_q):
    cfg = C().environment("CartPole-v1").rollouts(num_envs_per_worker=4)
    extra = dict(target_network_update_freq=100) if double_q else {}
    return cfg.training(lr=1e-3, train_batch_size=64, learning_starts=500, epsilon_timesteps=4000,
                        rollout_steps_per_iter=250, train_intensity=4, **extra).debugging(seed=0)


@pytest.mark.parametrize("algo", ["DQN", "SimpleQ"])
def test_first_iteration_matches_reference_step_for_step(algo):
    """1,000 env steps (4 envs), 126 updates (a target sync among them for
    DQN): from the reference's initial weights, the same transitions in the
    same order, the same updates, then the weights within f32 bars."""
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ref = _q_config(getattr(jrl, f"{algo}Config"), algo == "DQN").build()
    ours = _q_config(getattr(trl, f"{algo}Config"), algo == "DQN").resources(device="cpu").build()
    gaps = []
    q_fn = ref._q_fn

    def recording(p, o):
        q = q_fn(p, o)
        if o.shape[0] == 4:  # an acting forward (4 envs), not a training batch
            top = np.sort(np.asarray(q), axis=-1)
            gaps.append(float((top[:, -1] - top[:, -2]).min()))
        return q

    ref._q_fn = recording
    try:
        ours.learner.set_weights(ref.learner.get_weights())
        ours.target.load_params(ref.target_params)
        rm, om = ref.step(), ours.step()
        assert len(gaps) == 250
        for k in ref.buffer._cols:
            np.testing.assert_array_equal(ours.buffer._cols[k], ref.buffer._cols[k],
                                          err_msg=f"{k} (smallest Q gap acted on: {min(gaps):.3g})")
        assert ours._updates == ref._updates == 126
        for k in ("total_loss", "grad_norm", "td_error_abs", "q_mean", "epsilon", "episode_reward_mean"):
            np.testing.assert_allclose(om[k], rm[k], **METRICS, err_msg=k)
        for got, want in zip(trm.tree_leaves(ours.learner.get_weights()),
                             jax.tree_util.tree_leaves(ref.learner.get_weights())):
            np.testing.assert_allclose(got, np.asarray(want), **F32)
        for got, want in zip(trm.tree_leaves(ours.target_params), jax.tree_util.tree_leaves(ref.target_params)):
            np.testing.assert_allclose(got, np.asarray(want), **F32)
        if algo == "DQN":  # prioritized replay: the priorities the updates wrote
            np.testing.assert_allclose(ours.buffer._priorities, ref.buffer._priorities, rtol=1e-4, atol=1e-5)
    finally:
        ref.cleanup()
        ours.cleanup()


def test_simple_q_rejects_dqn_extensions():
    from ray_tpu_torch.rllib import SimpleQConfig

    with pytest.raises(ValueError):
        SimpleQConfig().training(double_q=True)
    with pytest.raises(ValueError):
        SimpleQConfig().training(prioritized_replay=True)
    cfg = SimpleQConfig()
    assert not cfg.double_q and not cfg.prioritized_replay


def test_simple_q_learns_cartpole():
    """tests/test_rllib_new_families.py's case: its config, bar and budget."""
    from ray_tpu_torch.rllib import SimpleQConfig

    cfg = (
        SimpleQConfig()
        .environment("CartPole-v1")
        .rollouts(num_envs_per_worker=4)
        .training(lr=1e-3, train_batch_size=64, learning_starts=500, epsilon_timesteps=4000,
                  rollout_steps_per_iter=500, model_hiddens=(64, 64))
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(16):
            r = algo.step()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 80:
                break
        assert best >= 80, f"SimpleQ failed to improve on CartPole (best={best})"
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.cleanup()


def test_dqn_checkpoint_roundtrip():
    from ray_tpu_torch.rllib import DQNConfig

    cfg = _q_config(DQNConfig, True).resources(device="cpu")
    algo, algo2 = cfg.build(), cfg.build()
    try:
        algo.step()
        ckpt = algo.save_checkpoint()
        algo2.load_checkpoint(ckpt)
        assert algo2._timesteps_total == algo._timesteps_total == 1000
        for tree in ("get_policy_weights", "target_params"):
            a, b = getattr(algo, tree), getattr(algo2, tree)
            a, b = (a(), b()) if callable(a) else (a, b)
            for x, y in zip(trm.tree_leaves(a), trm.tree_leaves(b)):
                np.testing.assert_array_equal(x, y)
        obs = np.array([0.0, 0.1, 0.0, -0.1], np.float32)
        assert algo2.compute_single_action(obs) == algo.compute_single_action(obs)
    finally:
        algo.cleanup()
        algo2.cleanup()


# -- R2D2 ------------------------------------------------------------------------


def _r2d2_params(seed=0, obs_dim=4, action_dim=2, hidden=16):
    params = jr2.init_params(jax.random.PRNGKey(seed), obs_dim, action_dim, hidden)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, tr2.r2d2_params_from_jax(np_params, device="cpu")


def test_gru_cell_and_q_scan_match_reference():
    jp, tp = _r2d2_params(1)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(5, 16)).astype(np.float32)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tr2.gru_cell(tp, torch.from_numpy(h), torch.from_numpy(x))),
                               _np(jr2.gru_cell(jp, jnp.asarray(h), jnp.asarray(x))), **F32)
    obs = rng.normal(size=(5, 12, 4)).astype(np.float32)
    q, h_last = tr2.q_scan(tp, torch.from_numpy(obs), torch.from_numpy(h))
    jq, jh = jr2.q_scan(jp, jnp.asarray(obs), jnp.asarray(h))
    np.testing.assert_allclose(_np(q), _np(jq), **F32)
    np.testing.assert_allclose(_np(h_last), _np(jh), **F32)


def test_h_rescale_and_inverse_match_reference():
    x = np.concatenate([np.linspace(-300, 300, 601), [0.0, 1e-6, -1e-6]]).astype(np.float32)
    np.testing.assert_allclose(_np(tr2.h_rescale(torch.from_numpy(x))), _np(jr2.h_rescale(jnp.asarray(x))), **F32)
    # h_inverse cancels in sqrt(1 + 4 eps (|y| + 1 + eps)) - 1: in f32 both
    # sides sit up to ~1e-3 off its float64 value (the cancellation magnifies
    # the square root's rounding, and XLA's CPU square root rounds otherwise
    # than torch's). The port's worst error against float64 may not exceed
    # the reference's.
    y = np.array(jr2.h_rescale(jnp.asarray(x)))
    eps, a = 1e-3, np.abs(y.astype(np.float64))
    exact = np.sign(y) * (np.square((np.sqrt(1 + 4 * eps * (a + 1 + eps)) - 1) / (2 * eps)) - 1)
    ours = _np(tr2.h_inverse(torch.from_numpy(y))).astype(np.float64)
    ref = _np(jr2.h_inverse(jnp.asarray(y))).astype(np.float64)
    assert np.abs(ours - exact).max() <= np.abs(ref - exact).max()


def _r2d2_batch(cfg, n, seed):
    """A replay batch shaped as R2D2 stores it: sequences of burn-in + seq_len
    steps with their start states, episode ends padded and masked."""
    rng = np.random.default_rng(seed)
    T = cfg.burn_in + cfg.seq_len
    lengths = rng.integers(T // 2, T + 1, n)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    dones = np.where(np.arange(T)[None] == lengths[:, None] - 1, rng.random((n, 1)) < 0.5, 0.0)
    return {
        "h0": rng.normal(0, 0.5, size=(n, cfg.hidden_size)).astype(np.float32),
        "obs": (rng.normal(size=(n, T, 4)) * mask[..., None]).astype(np.float32),
        "actions": (rng.integers(0, 2, (n, T)) * mask).astype(np.int32),
        "rewards": (mask * rng.normal(1.0, 0.3, (n, T))).astype(np.float32),
        "dones": np.maximum(dones, 1.0 - mask).astype(np.float32),
        "mask": mask,
    }


def test_r2d2_loss_grads_and_adam_step_match_reference():
    """The reference's jitted update_fn (from a reference R2D2 built in this
    process) and the port's R2D2.update from the same online and target
    weights on the same batch: the loss, td_abs, the gradients, and the
    weights after one clipped Adam step."""
    from ray_tpu.rllib.algorithms.r2d2 import R2D2Config as JC
    from ray_tpu_torch.rllib import R2D2Config as TC

    def conf(C):  # R2D2Config's defaults but a narrower GRU
        return C().environment("CartPole-v1").training(hidden_size=16).debugging(seed=0)

    ref, ours = conf(JC).build(), conf(TC).resources(device="cpu").build()
    try:
        jp, _ = _r2d2_params(3)
        jt, _ = _r2d2_params(4)
        ours.set_weights(jax.tree_util.tree_map(np.asarray, jp))
        ours.target_params = tr2.r2d2_params_from_jax(jax.tree_util.tree_map(np.asarray, jt), device="cpu")
        batch = _r2d2_batch(ours._algo_config, 8, 5)
        opt_state = ref.tx.init(jp)
        new_jp, _, aux = ref._update_fn(jp, jt, opt_state, batch)
        loss, taux, grads = ours.loss_and_grads(batch)
        cfg = ref._algo_config

        def jloss(p):
            # The reference update_fn's loss, rebuilt for its gradients.
            tb = {k: jnp.asarray(v) for k, v in batch.items()}
            q_all, _ = jr2.q_scan(p, tb["obs"], tb["h0"])
            qt_all, _ = jr2.q_scan(jt, tb["obs"], tb["h0"])
            acts = tb["actions"].astype(jnp.int32)
            q_taken = jnp.take_along_axis(q_all, acts[..., None], -1)[..., 0]
            best_next = jnp.argmax(q_all[:, 1:, :], axis=-1)
            q_next = jr2.h_inverse(jnp.take_along_axis(qt_all[:, 1:, :], best_next[..., None], -1)[..., 0])
            target = jr2.h_rescale(tb["rewards"][:, :-1] + cfg.gamma * (1.0 - tb["dones"][:, :-1]) * q_next)
            td = q_taken[:, :-1] - jax.lax.stop_gradient(target)
            mask = tb["mask"][:, :-1].at[:, : cfg.burn_in].set(0.0)
            huber = jnp.where(jnp.abs(td) < 1.0, 0.5 * td * td, jnp.abs(td) - 0.5)
            return jnp.sum(huber * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        jgrads = jax.grad(jloss)(jp)
        np.testing.assert_allclose(_np(loss), float(aux["total_loss"]), **F32)
        np.testing.assert_allclose(_np(taux["td_abs"]), float(aux["td_abs"]), **F32)
        for g, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(_np(g), _np(want), **GRADS)
        m = ours.update(batch)
        np.testing.assert_allclose(m["total_loss"], float(aux["total_loss"]), **F32)
        for got, want in zip(trm.tree_leaves(ours.get_weights()), jax.tree_util.tree_leaves(new_jp)):
            np.testing.assert_allclose(got, _np(want), **F32)
    finally:
        ref.cleanup()
        ours.cleanup()


def test_r2d2_checkpoint_roundtrip():
    """tests/test_rllib_r2d2_maddpg.py's case (its config), and the
    restored optimizer state, target and greedy recurrent action."""
    from ray_tpu_torch.rllib import R2D2Config

    cfg = (R2D2Config().environment("CartPole-v1")
           .training(rollout_steps_per_iter=200, learning_starts=100, train_intensity=20)
           .resources(device="cpu").debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        algo.step()
        assert algo._updates > 0
        ckpt = algo.save_checkpoint()
        algo2.load_checkpoint(ckpt)
        assert algo2._timesteps_total == algo._timesteps_total and algo2._updates == algo._updates
        for a, b in zip(trm.tree_leaves(algo.get_weights()), trm.tree_leaves(algo2.get_weights())):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(trm.tree_leaves(algo.target_params), trm.tree_leaves(algo2.target_params)):
            np.testing.assert_array_equal(_np(a), _np(b))
        s1, s2 = algo.opt.state_dict(), algo2.opt.state_dict()
        assert s1["count"] == s2["count"]
        for a, b in zip(s1["mu"] + s1["nu"], s2["mu"] + s2["nu"]):
            np.testing.assert_array_equal(a, b)
        state = np.zeros((1, cfg.hidden_size), np.float32)
        a1, h1 = algo.compute_single_action([0.0, 0.1, 0.0, -0.1], state=state)
        a2, h2 = algo2.compute_single_action([0.0, 0.1, 0.0, -0.1], state=state)
        assert a1 == a2 and a1 in (0, 1) and h1.shape == (1, cfg.hidden_size)
        np.testing.assert_array_equal(h1, h2)
    finally:
        algo.cleanup()
        algo2.cleanup()


# -- Ape-X DQN ---------------------------------------------------------------------


def test_apex_epsilon_ladder_and_explorer_match_reference():
    """eps_i = 0.4^(1 + 7 i / (N - 1)) per worker, and an explorer's fragment
    from the reference's weights: the same transitions."""
    from ray_tpu.rllib.algorithms.apex_dqn.apex_dqn import _ApexWorker as JWorker
    from ray_tpu_torch.rllib.algorithms.apex_dqn.apex_dqn import _ApexWorker as TWorker

    jspec = jrm.RLModuleSpec(obs_dim=4, action_dim=2, discrete=True)
    tspec = trm.RLModuleSpec(obs_dim=4, action_dim=2, discrete=True)
    params = jax.tree_util.tree_map(np.asarray, jrm.init_params(jax.random.PRNGKey(8), jspec))
    for n in (1, 2, 4):
        for i in range(n):
            ours = TWorker("CartPole-v1", {}, tspec, i, n, 2, 3)
            ref = JWorker("CartPole-v1", {}, jspec, i, n, 2, 3)
            assert ours.epsilon == ref.epsilon == 0.4 ** (1 + 7 * i / max(n - 1, 1))
            if n == 4:
                ours.set_weights(params)
                ref.set_weights(params)
                (got, grews, gn), (want, wrews, wn) = ours.sample(60), ref.sample(60)
                assert gn == wn == 120 and grews == wrews
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            ours.stop()
            ref.stop()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


class _Recording:
    """Forwards to a replay-shard handle, counting its sample calls."""

    def __init__(self, shard, log, i):
        self._shard, self._log, self._i = shard, log, i

    def __getattr__(self, name):
        if name == "sample_with_idx":
            self._log.append(self._i)
        return getattr(self._shard, name)


def test_apex_shard_round_robin(cluster):
    """Fragments go to the shards in turn, the learner samples them in turn
    (and pushes each batch's priorities back to the shard it came from),
    weights broadcast every weight_sync_period_updates, and the loss is
    finite."""
    from ray_tpu_torch.rllib import ApexDQNConfig

    cfg = (ApexDQNConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2)
           .training(num_replay_shards=2, rollout_fragment_length=25, learning_starts=100, train_batch_size=32,
                     train_rounds_per_iter=4, updates_per_round=3, weight_sync_period_updates=4)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    try:
        log = []
        algo.shards = [_Recording(s, log, i) for i, s in enumerate(algo.shards)]
        r = algo.step()
        sizes = rt.get([s.size.remote() for s in algo.shards])
        assert sizes == [100, 100] and r["replay_size"] == 200 and algo._timesteps_total == 200
        assert algo._add_rr == 8
        # Learning starts after round 2 (100 rows): rounds 2-4 take 3 updates each.
        assert log == [0, 1] * 4 + [0] and algo._updates == 9
        assert algo._last_sync == 6
        assert np.isfinite(r["total_loss"]) and np.isfinite(r["td_error_abs"])
    finally:
        algo.cleanup()
