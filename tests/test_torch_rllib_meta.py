"""The port's meta-learning family on the CPU, held to ``ray_tpu.rllib``:
``PointGoalEnv``, MAML and MBMPO.

- ``PointGoalEnv`` step for step against the reference's (tasks, positions,
  rewards, truncation), and its tensor ``reward_fn``/``transition_fn``
  against the reference's jnp versions.
- MAML's pieces from the reference's weights (``rl_module_params_from_jax``)
  on the same task batches: ``inner_pg_loss`` at a 4-row batch (the
  population std, ddof 0: Bessel's correction would part by more than the
  bar), ``adapt`` with 1 and 2 inner steps, the second-order meta-gradient
  over 4 stacked tasks against the gradient the reference's jitted
  ``meta_update`` takes (``jax.value_and_grad`` spied) — and its distance
  from the first-order gradient, which must exceed the bar — and two Adam
  ``meta_update`` steps (weights and moments). The reference side is built as
  its ``_build_meta_update``/``_build_fns`` build it and driven directly, with
  no cluster.
- MBMPO: the ensemble update (K = 3) through ``_train_ensemble`` on the same
  replay and the same bootstrap indices, ``_imagined_batch`` with the
  reference's imagination draws rebuilt from its key, and the meta-update on
  imagined stacks; then the reference's ``test_mbmpo_learned_dynamics_match_
  truth`` bars on the port.
- MAML's learning test (the reference's config and bars: adaptation delta
  > 0.5, post-adaptation return up by 1.0, ``adapt_to_task``, the checkpoint)
  in the file's one port cluster.

Tolerances (f32 on the CPU, both sides): losses and one step rtol 1e-5 /
atol 1e-6, gradients rtol 1e-4 / atol 1e-6, weights after two steps or
more rtol 1e-4 / atol 1e-6; an imagined rollout's columns rtol 1e-4 /
atol 1e-5 of the column's largest magnitude; the ensemble's Adam step
within lr where a gradient element is below Adam's eps (see its test).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib.algorithms.maml.maml as jmaml
import ray_tpu.rllib.algorithms.mbmpo.mbmpo as jmbmpo
import ray_tpu_torch as rt
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.env.meta_env import PointGoalEnv as JPointGoalEnv
from ray_tpu.rllib.models import ModelCatalog as JCatalog
from ray_tpu.rllib.policy.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, VALUE_TARGETS
from ray_tpu_torch.rllib.algorithms.maml import maml as tmaml
from ray_tpu_torch.rllib.algorithms.mbmpo import mbmpo as tmbmpo
from ray_tpu_torch.rllib.core.rl_module import copy_into, tree_leaves
from ray_tpu_torch.rllib.env import PointGoalEnv
from ray_tpu_torch.rllib.models import ModelCatalog
from torch_rllib_reference import reference_grads

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small MLPs: one intra-op thread beside the suite's other test
    processes, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(got, want, tol, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"{what} leaf {i}")


def _specs(hiddens=(16, 16)):
    """The reference's module spec for PointGoalEnv and the port's."""
    jenv, tenv = JPointGoalEnv({}), PointGoalEnv({})
    model = {"fcnet_hiddens": hiddens, "conv_filters": None}
    return (JCatalog.get_model_spec(jenv.observation_space, jenv.action_space, model),
            ModelCatalog.get_model_spec(tenv.observation_space, tenv.action_space, model))


def _task_batch(rng, rows, logp_center=-2.0):
    """One task's post-GAE columns: observations, actions, recorded logp
    (near the policy's, so the clip acts on some rows), advantages and
    value targets."""
    return {
        OBS: rng.normal(0, 0.5, (rows, 2)).astype(np.float32),
        ACTIONS: rng.normal(0, 0.8, (rows, 2)).astype(np.float32),
        LOGPS: (logp_center + rng.normal(0, 0.3, rows)).astype(np.float32),
        ADVANTAGES: rng.normal(0.3, 1.0, rows).astype(np.float32),
        VALUE_TARGETS: rng.normal(-1.0, 1.0, rows).astype(np.float32),
    }


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _meta_pair(cfg_kw, hiddens=(16, 16), seed=0):
    """The reference's MAML meta-update built as its ``_build_meta_update``
    builds it (on a stand-in holding its spec and Adam), its initial
    params, and the port's MetaLearner on the CPU holding them."""
    jspec, tspec = _specs(hiddens)
    jcfg = jmaml.MAMLConfig().training(**cfg_kw).debugging(seed=seed)
    ref = types.SimpleNamespace(module_spec=jspec, tx=optax.adam(jcfg.lr))
    jmaml.MAML._build_meta_update(ref, jcfg)
    params = jrm.init_params(jax.random.PRNGKey(seed), jspec)
    tcfg = tmaml.MAMLConfig().training(**cfg_kw).debugging(seed=seed)
    learner = tcfg.meta_learner(tspec, "cpu")
    learner.module.load_params(_host(params))
    return ref, params, jcfg, learner


# -- PointGoalEnv ------------------------------------------------------------------


def test_point_goal_env_matches_reference_step_for_step():
    """The same tasks from the same seed, then each task's episode with the
    same actions (some past the clip): positions, rewards, ends."""
    ours, ref = PointGoalEnv({"seed": 3}), JPointGoalEnv({"seed": 3})
    assert ours.observation_space.shape == ref.observation_space.shape == (2,)
    np.testing.assert_array_equal(ours.action_space.low, ref.action_space.low)
    t1, t2 = ours.sample_tasks(4), ref.sample_tasks(4)
    for a, b in zip(t1, t2):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for task in t1:
        ours.set_task(task)
        ref.set_task(task)
        np.testing.assert_array_equal(ours.get_task(), ref.get_task())
        np.testing.assert_array_equal(ours.reset()[0], ref.reset()[0])
        for t in range(ours.horizon):
            a = rng.uniform(-1.5, 1.5, 2).astype(np.float32)
            s1, s2 = ours.step(a), ref.step(a)
            np.testing.assert_array_equal(s1[0], s2[0])
            assert s1[1:4] == s2[1:4], t
        assert s1[3] is True and s1[2] is False
    np.testing.assert_array_equal(ours.reset(seed=5)[0], ref.reset(seed=5)[0])
    np.testing.assert_array_equal(ours.sample_tasks(2), ref.sample_tasks(2))


def test_point_goal_tensor_dynamics_match_reference():
    """``reward_fn`` and ``transition_fn`` on tensors against the reference's
    jnp versions, actions past the clip included."""
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(32, 2)).astype(np.float32)
    act = rng.uniform(-2, 2, (32, 2)).astype(np.float32)
    task = np.array([0.6, -0.8], np.float32)
    nxt = PointGoalEnv.transition_fn(torch.from_numpy(obs), torch.from_numpy(act), step_size=0.15)
    np.testing.assert_allclose(_np(nxt), np.asarray(JPointGoalEnv.transition_fn(obs, act, step_size=0.15)), **F32)
    r = PointGoalEnv.reward_fn(torch.from_numpy(obs), torch.from_numpy(act), nxt, torch.from_numpy(task))
    np.testing.assert_allclose(_np(r), np.asarray(JPointGoalEnv.reward_fn(obs, act, _np(nxt), task)), **F32)
    # The env's own step agrees with its tensor transition and reward.
    env = PointGoalEnv({})
    env.set_task(task)
    env.reset()
    o, rew, *_ = env.step(act[0])
    np.testing.assert_allclose(o, _np(nxt[:1] - torch.from_numpy(obs[:1]))[0], **F32)
    np.testing.assert_allclose(rew, float(PointGoalEnv.reward_fn(None, None, torch.from_numpy(o), torch.from_numpy(task))),
                               **F32)


# -- MAML ----------------------------------------------------------------------------


def test_inner_pg_loss_uses_the_population_std():
    """At 4 rows the reference's jnp std (ddof 0) and Bessel's (ddof 1) part
    by far more than the bar: the port's loss and gradient are the
    reference's, not Bessel's."""
    ref, params, jcfg, learner = _meta_pair({})
    batch = _task_batch(np.random.default_rng(2), 4)
    jloss, jgrads = jax.value_and_grad(jmaml.inner_pg_loss)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                                            ref.module_spec)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = learner.params()
    loss = tmaml.inner_pg_loss(learner.module, p, tb)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **F32)
    grads = torch.autograd.grad(loss, [p[n] for n in learner._names], allow_unused=True)
    for g, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(_np(g) if g is not None else np.zeros_like(want), np.asarray(want), **GRADS)
    adv = tb[ADVANTAGES]
    bessel = (adv - adv.mean()) / (adv.std() + 1e-8)
    logp, _, _ = learner.module.action_logp_and_entropy(tb[OBS], tb[ACTIONS])
    assert abs(float(-torch.mean(logp * bessel).detach()) - float(jloss)) > 1e-2 * abs(float(jloss))


@pytest.mark.parametrize("steps", [1, 2])
def test_adapt_matches_reference(steps):
    """The adapted parameters after 1 and 2 inner steps (the value head
    untouched: the PG loss has no value term)."""
    ref, params, jcfg, learner = _meta_pair({"inner_lr": 0.3, "inner_adaptation_steps": steps})
    batch = _task_batch(np.random.default_rng(3), 20)
    adapt = jmaml.make_inner_adapt(ref.module_spec, 0.3, steps)
    want = adapt(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = learner.adapt(learner.params(), {k: torch.from_numpy(v) for k, v in batch.items()}, create_graph=False)
    _assert_tree(learner.host_tree(got), want, F32, f"adapted after {steps}")
    for name in ("vf_out",):
        np.testing.assert_array_equal(learner.host_tree(got)[name]["w"], np.asarray(params[name]["w"]))


def _meta_stacks(seed, n_tasks=4, rows=20):
    rng = np.random.default_rng(seed)
    return (_stack([_task_batch(rng, rows) for _ in range(n_tasks)]),
            _stack([_task_batch(rng, rows) for _ in range(n_tasks)]))


@pytest.mark.parametrize("steps", [1, 2])
def test_meta_gradient_is_second_order_and_the_references(steps):
    """The meta-gradient over 4 stacked tasks against the one the
    reference's jitted meta_update takes, and the meta-loss; the
    first-order gradient (inner gradients as constants) parts from it by
    more than the bar."""
    kw = {"inner_lr": 0.5, "inner_adaptation_steps": steps, "entropy_coeff": 0.01}
    ref, params, jcfg, learner = _meta_pair(kw)
    pre, post = _meta_stacks(4 + steps)
    jpre, jpost = ({k: jnp.asarray(v) for k, v in s.items()} for s in (pre, post))
    opt_state = ref.tx.init(params)
    _, _, jloss = ref._meta_update(params, opt_state, jpre, jpost)
    jgrads = reference_grads(ref._meta_update, params, opt_state, jpre, jpost)
    tpre, tpost = ({k: torch.from_numpy(v) for k, v in s.items()} for s in (pre, post))
    loss, grads = learner.meta_loss_and_grads(tpre, tpost)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **F32)
    want = jax.tree_util.tree_leaves(jgrads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRADS, err_msg=f"leaf {i}")
    # First order: the same losses with the inner gradients as constants.
    first = [tmaml.outer_surrogate_loss(learner.module,
                                        learner.adapt(learner.params(), tmaml.task_slice(tpre, i), create_graph=False),
                                        tmaml.task_slice(tpost, i), learner.loss_cfg) for i in range(4)]
    fo = torch.autograd.grad(torch.stack(first).mean(), [learner.params()[n] for n in learner._names])
    so = np.concatenate([_np(g).ravel() for g in grads])
    fo = np.concatenate([_np(g).ravel() for g in fo])
    gap = np.linalg.norm(so - fo) / np.linalg.norm(so)
    assert gap > 100 * GRADS["rtol"], gap
    assert not np.allclose(so, fo, **GRADS)


def test_two_meta_updates_match_reference():
    """Two Adam meta_update steps: the losses, the weights and the moments."""
    ref, params, jcfg, learner = _meta_pair({"lr": 5e-3, "inner_lr": 0.3})
    pre, post = _meta_stacks(9)
    jpre, jpost = ({k: jnp.asarray(v) for k, v in s.items()} for s in (pre, post))
    tpre, tpost = ({k: torch.from_numpy(v) for k, v in s.items()} for s in (pre, post))
    p, o = params, ref.tx.init(params)
    for step in range(2):
        p, o, jloss = ref._meta_update(p, o, jpre, jpost)
        loss = learner.meta_update(tpre, tpost)
        np.testing.assert_allclose(_np(loss), np.asarray(jloss), **F32)
        tol = F32 if step == 0 else TRAJ
        _assert_tree(learner.module.param_tree(), p, tol, f"params after step {step}")
        np.testing.assert_allclose(np.concatenate([_np(x).ravel() for x in learner.opt.mu]),
                                   np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(o[0].mu)]),
                                   **tol)
    assert learner.opt.count == 2


# -- MBMPO ---------------------------------------------------------------------------


def _mbmpo_pair(hiddens=(16, 16), K=3, seed=0, **training):
    """The reference MBMPO's functions built as its ``_build_fns`` builds them
    (on a stand-in holding its env, spec, optax chains, ensemble and
    streams), and the port's MBMPO on the CPU holding the same weights."""
    kw = dict(dict(ensemble_size=K, model_hiddens=hiddens, dynamics_train_epochs=3, imagined_episodes_per_task=6),
              **training)
    jcfg = jmbmpo.MBMPOConfig().environment(JPointGoalEnv, env_config={"seed": 0}).training(**kw).debugging(seed=seed)
    env = JPointGoalEnv({"seed": 0})
    jspec = JCatalog.get_model_spec(env.observation_space, env.action_space, jcfg.model_config())
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), K)
    per_model = [jmbmpo._dyn_init(k, 2, 2, jcfg.dynamics_hiddens) for k in keys]
    ref = types.SimpleNamespace(
        _algo_config=jcfg, env=env, module_spec=jspec, tx=optax.adam(jcfg.lr), dyn_tx=optax.adam(jcfg.dynamics_lr),
        _horizon=env.horizon, params=jrm.init_params(jax.random.PRNGKey(seed), jspec),
        dyn_params=jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_model),
        _rng=jax.random.PRNGKey(seed + 13), _np_rng=np.random.default_rng(seed))
    ref.dyn_opt = ref.dyn_tx.init(ref.dyn_params)
    ref.opt_state = ref.tx.init(ref.params)
    jmbmpo.MBMPO._build_fns(ref, jcfg)
    ours = (tmbmpo.MBMPOConfig().environment(PointGoalEnv, env_config={"seed": 0}).training(**kw)
            .resources(device="cpu").debugging(seed=seed).build())
    ours.learner.module.load_params(_host(ref.params))
    copy_into(ours.dyn_params, tmbmpo.mbmpo_dyn_params_from_jax(_host(ref.dyn_params), device="cpu"))
    rng = np.random.default_rng(11)
    data = {"_replay_obs": rng.normal(0, 0.7, (300, 2)), "_replay_act": rng.uniform(-1, 1, (300, 2)),
            "_start_obs": rng.normal(0, 0.3, (40, 2))}
    data["_replay_next"] = data["_replay_obs"] + 0.15 * np.clip(data["_replay_act"], -1, 1)
    for k, v in data.items():
        setattr(ref, k, v.astype(np.float32))
        setattr(ours, k, v.astype(np.float32))
    return ref, ours


def _imagine_noise(key, H, B, d):
    """The reference's imagination draws: its key split once a step, the
    policy's normal draws from the subkey."""
    out = []
    for _ in range(H):
        key, sk = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sk, (B, d))))
    return torch.from_numpy(np.stack(out))


def test_mbmpo_ensemble_update_matches_reference():
    """One ``_train_ensemble`` epoch on both from the same replay with the
    same bootstrap stream (K = 3): each member's loss and gradients (against
    the reference's own ``model_loss`` under ``vmap(value_and_grad)``), the
    stacked leaves after the Adam step and the moments; then one member's
    slice predicts as the reference's. Where a gradient element is below
    Adam's eps (1e-8), the step ``g / (|g| + eps)`` turns the gradient's last
    bits into a change of up to lr: an element off the F32 bar must be such
    an element and within lr, and there may be at most a handful (of
    12,675)."""
    ref, ours = _mbmpo_pair(dynamics_train_epochs=1)
    try:
        fn = ref._ensemble_update.__wrapped__
        model_loss = fn.__closure__[fn.__code__.co_freevars.index("model_loss")].cell_contents
        idx = np.random.default_rng(0).integers(0, 300, (3, 256))  # both streams' first bootstrap draw
        cols = [x[idx] for x in (ref._replay_obs, ref._replay_act, ref._replay_next)]
        jl, jg = jax.vmap(jax.value_and_grad(model_loss))(ref.dyn_params, *map(jnp.asarray, cols))
        tl, tg = tmbmpo.ensemble_loss_and_grads(ours.dyn_params, *map(torch.from_numpy, cols))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **F32)
        jg = jax.tree_util.tree_leaves(jg)
        for i, (g, w) in enumerate(zip(tg, jg)):
            np.testing.assert_allclose(_np(g), np.asarray(w), **GRADS, err_msg=f"gradient leaf {i}")
        want = jmbmpo.MBMPO._train_ensemble(ref)
        got = ours._train_ensemble()
        np.testing.assert_allclose(got, want, **F32)
        lr, n_off = ref._algo_config.dynamics_lr, 0
        for i, (p, w, g) in enumerate(zip(tree_leaves(ours.dyn_params), jax.tree_util.tree_leaves(ref.dyn_params), jg)):
            p, w, g = _np(p), np.asarray(w), np.asarray(g)
            off = ~np.isclose(p, w, **F32)
            assert np.all(np.abs(g[off]) < 1e-7), f"ensemble leaf {i}: {p[off]} vs {w[off]}, gradients {g[off]}"
            assert np.all(np.abs(p[off] - w[off]) <= lr), i
            n_off += int(off.sum())
        assert n_off < 10, n_off
        for a, b in zip(ours.dyn_opt.mu, jax.tree_util.tree_leaves(ref.dyn_opt[0].mu)):
            np.testing.assert_allclose(_np(a), np.asarray(b), **F32)
        assert ours.dyn_opt.count == 1
        x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
        np.testing.assert_allclose(_np(tmbmpo.dyn_apply(ours._model_slice(1), torch.from_numpy(x))),
                                   np.asarray(jmbmpo._dyn_apply(jax.tree_util.tree_map(lambda t: t[1], ref.dyn_params),
                                                                jnp.asarray(x))), **TRAJ)
    finally:
        ours.cleanup()


def _assert_rollout(got, want):
    """An imagined batch's columns: rtol 1e-4, and atol 1e-5 of the column's
    largest magnitude (a 20-step rollout through an untrained ensemble
    reaches magnitudes near 20; an element near zero carries its column's
    rounding)."""
    for col in want.keys():
        scale = float(np.abs(want[col]).max())
        np.testing.assert_allclose(got[col], want[col], rtol=TRAJ["rtol"], atol=max(1e-5 * scale, 1e-6), err_msg=col)


def test_mbmpo_imagination_and_meta_update_match_reference():
    """``_imagined_batch`` from each member with the reference's draws (the
    columns after GAE, the mean return), adaptation across the members, the
    post-adaptation batches, then one meta-update on the stacks."""
    ref, ours = _mbmpo_pair()
    try:
        cfg = ref._algo_config
        B, H = cfg.imagined_episodes_per_task, ref._horizon
        theta = {k: p.detach() for k, p in ours.learner.params().items()}
        pre, post = [], []
        for k in range(3):
            _, key = jax.random.split(ref._rng)
            want, want_r = jmbmpo.MBMPO._imagined_batch(ref, ref.params, jmbmpo.MBMPO._model_slice(ref, k))
            got, got_r = ours._imagined_batch(theta, ours._model_slice(k), _imagine_noise(key, H, B, 2))
            _assert_rollout(got, want)
            np.testing.assert_allclose(got_r, want_r, **TRAJ)
            pre.append((got, want))
        tpre = tmaml.stack_batches([g for g, _ in pre], ours.device)
        jpre = jmbmpo.MBMPO._stack([w for _, w in pre])
        adapted = jax.vmap(ref._adapt, in_axes=(None, 0))(ref.params, jpre)
        for k, mine in enumerate(ours.learner.adapted_params(tpre)):
            _assert_tree(ours.learner.host_tree(mine), jax.tree_util.tree_map(lambda x, k=k: x[k], adapted), TRAJ,
                         f"adapted {k}")
            _, key = jax.random.split(ref._rng)
            want, _ = jmbmpo.MBMPO._imagined_batch(ref, jax.tree_util.tree_map(lambda x, k=k: x[k], adapted),
                                                    jmbmpo.MBMPO._model_slice(ref, k))
            got, _ = ours._imagined_batch(mine, ours._model_slice(k), _imagine_noise(key, H, B, 2))
            _assert_rollout(got, want)
            post.append((got, want))
        tpost = tmaml.stack_batches([g for g, _ in post], ours.device)
        jpost = jmbmpo.MBMPO._stack([w for _, w in post])
        params, _, jloss = ref._meta_update(ref.params, ref.opt_state, jpre, jpost)
        loss = ours.learner.meta_update(tpre, tpost)
        np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TRAJ)
        _assert_tree(ours.learner.module.param_tree(), params, TRAJ, "meta params")
    finally:
        ours.cleanup()


def test_mbmpo_reward_takes_the_task_on_the_device():
    """PointGoalEnv's reward takes a task: MBMPO reads it at setup as a
    tensor on its device and passes it; a three-argument reward gets none."""
    ref, ours = _mbmpo_pair()
    try:
        assert isinstance(ours._task, torch.Tensor) and ours._task.device == ours.device
        np.testing.assert_array_equal(_np(ours._task), ours.env.get_task())
        s = torch.zeros(3, 2)
        nxt = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
        np.testing.assert_allclose(_np(ours.reward(s, s, nxt)), -np.linalg.norm(_np(nxt) - ours.env.get_task(), axis=-1),
                                   **F32)

        class NoTask(PointGoalEnv):
            @staticmethod
            def reward_fn(obs, action, next_obs):
                return -next_obs.sum(-1)

        other = (tmbmpo.MBMPOConfig().environment(NoTask).training(model_hiddens=(8,))
                 .resources(device="cpu").build())
        assert other._task is None
        np.testing.assert_allclose(_np(other.reward(s, s, nxt)), [-1.0, -1.0, -1.0])
        other.cleanup()
    finally:
        ours.cleanup()


def test_mbmpo_learned_dynamics_match_truth():
    """tests/test_rllib_meta.py's case on the port: its config and bars."""
    cfg = (
        tmbmpo.MBMPOConfig()
        .environment(PointGoalEnv, env_config={"seed": 1})
        .training(
            ensemble_size=3, dynamics_train_epochs=80,
            real_episodes_per_iter=25, imagined_episodes_per_task=8,
            maml_optimizer_steps=1, model_hiddens=(32, 32),
        )
        .resources(device="cpu")
        .debugging(seed=1)
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    try:
        algo.step()
        algo.step()  # two rounds of real data + ensemble fitting
        obs = torch.from_numpy(algo._replay_obs[:64])
        act = torch.from_numpy(algo._replay_act[:64])
        true_next = PointGoalEnv.transition_fn(obs, act, step_size=0.15)
        preds = [obs + tmbmpo.dyn_apply(algo._model_slice(k), torch.cat([obs, act], -1))
                 for k in range(cfg.ensemble_size)]
        err = (torch.stack(preds).mean(0) - true_next).abs()
        assert float(err.max()) < 0.15, f"learned dynamics off by {float(err.max())} (max)"
        assert float(err.mean()) < 0.05, f"learned dynamics off by {float(err.mean())} (mean)"
        ckpt = algo.save_checkpoint()
        w = [x.detach().clone() for x in tree_leaves(algo.dyn_params)]
        algo.load_checkpoint(ckpt)
        for a, b in zip(tree_leaves(algo.dyn_params), w):
            assert torch.equal(a.detach(), b)
    finally:
        algo.cleanup()


# -- MAML learning (one port cluster) ---------------------------------------------------


@pytest.fixture(scope="module")
def port_cluster():
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def test_maml_learns_to_adapt(port_cluster):
    """tests/test_rllib_meta.py's case on the port (2 CPU rollout actors,
    the meta-update on the CPU): its config and bars, the deploy-time
    adaptation, the checkpoint, and the second setup() after build()."""
    from ray_tpu_torch.rllib import MAMLConfig

    cfg = (
        MAMLConfig()
        .environment(PointGoalEnv, env_config={"seed": 0})
        .rollouts(num_rollout_workers=2)
        .training(
            lr=5e-3, inner_lr=0.3, meta_batch_size=8, episodes_per_task=8,
            maml_optimizer_steps=5, model_hiddens=(32, 32),
        )
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    try:
        deltas, posts = [], []
        for _ in range(15):
            r = algo.step()
            deltas.append(r["adaptation_delta"])
            posts.append(r["post_adaptation_reward_mean"])
        assert np.mean(deltas[-5:]) > 0.5, f"no adaptation gain: {deltas}"
        assert np.mean(posts[-4:]) > np.mean(posts[:4]) + 1.0, (
            f"post-adaptation return did not improve: {posts}"
        )
        task = algo._task_env.sample_tasks(1)[0]
        adapted = algo.adapt_to_task(task)
        assert set(adapted.keys()) == set(algo.get_policy_weights().keys())
        ckpt = algo.save_checkpoint()
        w = algo.get_policy_weights()
        algo.learner.module.load_params(adapted)
        algo.load_checkpoint(ckpt)
        for a, b in zip(tree_leaves(algo.get_policy_weights()), tree_leaves(w)):
            np.testing.assert_array_equal(a, b)
        a = algo.compute_single_action(np.zeros(2, np.float32))
        assert a.shape == (2,) and np.all(np.isfinite(a))
    finally:
        algo.cleanup()
