"""The port's DreamerV3 on the CPU, held to ``ray_tpu.rllib``'s, for
continuous (Pendulum-v1) and discrete (CartPole-v1) actions (no cluster).

The reference side is the reference algorithm as its ``setup`` builds it
(weights, optax chains, jitted functions), one for each env; ``imagine`` and
``lambda_returns`` are read from the closures of its jitted ``update`` and
called directly, and the update is traced once more with
``jax.value_and_grad`` spied, which gives the world loss's and the actor and
critic losses' values, metrics and gradients as the update computes them.
The port holds the reference's weights
(``dreamerv3_params_from_jax``), and the reference's draws are rebuilt from its
key with the same ``split`` calls (``jax.random.categorical`` is ``argmax(logits
+ gumbel(key, logits.shape))``) and passed as the port's explicit draw tensors.

- the GRU cell and its gradients (it is ``torch.nn.GRUCell``'s with a zero
  hidden bias);
- ``world_loss``'s metrics, the detached states and the gradients, then
  ``ac_loss`` through the updated world model with the actor's and the
  critic's gradients (the reference's ``argnums=(0, 1)``), and the update
  leaving the world model with no gradient from it (its tensors' ``.grad``
  stays None, and it holds the world step's values);
- ``imagine``'s features and entropies, ``lambda_returns``;
- three full ``update``s (the world model, actor, critic, critic EMA, the
  three Adam states and the return scale after each);
- ``_SequenceReplay.sample`` element for element (numpy on both sides);
- the reference's Pendulum smoke with the checkpoint round trip, the CartPole
  smoke, evaluation leaving the live carry intact, and Reach1D learning to
  the reference's bar (> -8), stopping once the bar is met.

Tolerances (f32 on the CPU, both sides): losses, features and one update
rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6, the state after the
second and third update rtol 1e-4 / atol 1e-6; where a gradient element is
below Adam's eps, the weight after the step within lr (``_assert_stepped``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.rllib.algorithms.dreamerv3.dreamerv3 as jdv3
from ray_tpu_torch.rllib.algorithms.dreamerv3 import dreamerv3 as tdv3
from ray_tpu_torch.rllib.core.rl_module import copy_into, tree_leaves
from ray_tpu_torch.rllib.env import Box

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-6)
# free_bits 0.01 (the default 1.0 clamps a fresh model's KL, ~0.3 here): the
# KL terms and their stop-gradients take part in the gradients.
SMALL = dict(batch_size=4, batch_length=6, deter_size=32, model_hiddens=(32,), latent_groups=4, latent_classes=8,
             imagine_horizon=5, free_bits=0.01)


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


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _assert_tree(got, want, tol, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"{what} leaf {i}")


def _assert_stepped(got, want, grads, lr, what):
    """Weights after one Adam step against the reference's: within F32,
    except where the reference's gradient element is below 1e-7 — Adam's
    first step there, ``g / (|g| + 1e-8)``, turns the gradient's last bits
    into a change of up to lr — within lr (at most a handful of elements)."""
    n_off = 0
    for i, (g, w, dg) in enumerate(zip(tree_leaves(got), jax.tree_util.tree_leaves(want), grads)):
        g, w, dg = _np(g), np.asarray(w), np.asarray(dg)
        off = ~np.isclose(g, w, **F32)
        assert np.all(np.abs(dg[off]) < 1e-7), f"{what} leaf {i}: {g[off]} vs {w[off]}, gradients {dg[off]}"
        assert np.all(np.abs(g[off] - w[off]) <= lr), f"{what} leaf {i}"
        n_off += int(off.sum())
    assert n_off < 10, n_off


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


_REFERENCE = {}


@pytest.fixture(scope="module", autouse=True)
def close_references():
    yield
    for ref, _, _ in _REFERENCE.values():
        ref.cleanup()
    _REFERENCE.clear()


def _reference(env):
    """The reference DreamerV3 (built once per env for the file), its inner
    functions, and its jitted ``update`` traced once more with
    ``jax.value_and_grad`` spied: ``probe(*state, batch, key)`` returns the
    update's outputs and what its two ``value_and_grad`` calls returned
    (the world loss's, then the actor and critic losses')."""
    if env not in _REFERENCE:
        import ray_tpu.rllib as jrl

        kw = dict(SMALL, learning_starts=10, rollout_steps_per_iter=10)
        ref = jrl.DreamerV3Config().environment(env).training(**kw).debugging(seed=2).build()
        update = ref._update_fn.__wrapped__
        ac = _closure(update, "ac_loss")
        fns = {"imagine": _closure(ac, "imagine"), "lambda_returns": _closure(ac, "lambda_returns")}
        real = jax.value_and_grad

        def run(*args):
            found = []

            def spy(fn, *a, **kw):
                vg = real(fn, *a, **kw)

                def recorded(*call):
                    out = vg(*call)
                    found.append(out)
                    return out

                return recorded

            jax.value_and_grad = spy
            try:
                out = update(*args)
            finally:
                jax.value_and_grad = real
            return out, found

        _REFERENCE[env] = (ref, fns, jax.jit(run))
    return _REFERENCE[env]


def _ours(ref):
    """The port's DreamerV3 on the CPU with ``ref``'s config, holding its
    initial weights."""
    import ray_tpu_torch.rllib as trl

    kw = dict(SMALL, learning_starts=10, rollout_steps_per_iter=10)
    ours = trl.DreamerV3Config().environment(ref._algo_config.env).training(**kw).resources(device="cpu") \
        .debugging(seed=2).build()
    for name in ("params", "actor_params", "critic_params", "critic_ema"):
        copy_into(getattr(ours, name), tdv3.dreamerv3_params_from_jax(_host(getattr(ref, name)), device="cpu"))
    return ours


def _state(ref):
    """The reference's update state; the return scale as a strongly typed f32
    (as the update returns it), so its jitted update compiles once."""
    return (ref.params, ref.actor_params, ref.critic_params, ref.critic_ema, ref.model_opt, ref.actor_opt,
            ref.critic_opt, jnp.asarray(ref.return_scale, jnp.float32))


def _batch(ref, seed):
    """A [B, L] replay batch of the env's shapes: sampled from a buffer of
    random rows with episode starts inside."""
    cfg = ref._algo_config
    rng = np.random.default_rng(seed)
    buf = tdv3._SequenceReplay(64, ref.obs_dim, ref.act_dim, seed)
    for i in range(64):
        if ref.discrete:
            action = np.eye(ref.act_dim, dtype=np.float32)[rng.integers(ref.act_dim)]
        else:
            action = rng.uniform(-1, 1, ref.act_dim).astype(np.float32)
        buf.add(rng.normal(size=ref.obs_dim).astype(np.float32), action, float(rng.normal()),
                bool(rng.random() < 0.1), i % 20 == 0)
    return buf.sample(cfg.batch_size, cfg.batch_length)


def _gumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape))


def _imagine_draws(key, N, cfg, act_dim, discrete):
    """imagine's draws from its key: split H ways, each split into the
    action's key and the prior latent's."""
    act, lat = [], []
    for k in jax.random.split(key, cfg.imagine_horizon):
        ka, kz = jax.random.split(k)
        act.append(_gumbel(ka, (N, act_dim)) if discrete else np.asarray(jax.random.normal(ka, (N, act_dim))))
        lat.append(_gumbel(kz, (N, cfg.latent_groups, cfg.latent_classes)))
    return {"action": _t(np.stack(act)), "latent": _t(np.stack(lat))}


def _world_draws(key, B, cfg):
    return _t(np.stack([_gumbel(k, (B, cfg.latent_groups, cfg.latent_classes))
                        for k in jax.random.split(key, cfg.batch_length)]))


def _update_draws(key, ref):
    """The reference update's draws: ``k1, k2 = split(key)``, the world
    loss's from k1, imagination's from k2."""
    cfg = ref._algo_config
    k1, k2 = jax.random.split(key)
    draws = _imagine_draws(k2, cfg.batch_size * cfg.batch_length, cfg, ref.act_dim, ref.discrete)
    draws["world"] = _world_draws(k1, cfg.batch_size, cfg)
    return draws


def _adam_mu(state):
    adam = [s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    return adam[0]


ENVS = pytest.mark.parametrize("env", ["Pendulum-v1", "CartPole-v1"], ids=["continuous", "discrete"])


def test_gru_cell_matches_reference():
    """The reference's cell (the candidate's recurrent term gated by r after
    one fused product), its output and its gradients in x, h and the
    weights."""
    p = jdv3._gru_params(jax.random.PRNGKey(0), 6, 5)
    p["b"] = jax.random.normal(jax.random.PRNGKey(1), (15,))
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(7, 6)).astype(np.float32), rng.normal(size=(7, 5)).astype(np.float32)

    def jloss(p, x, h):
        return jnp.sum(jdv3._gru_apply(p, x, h) ** 2)

    want = jdv3._gru_apply(p, x, h)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(p, x, h)
    tp = {k: _t(v).requires_grad_() for k, v in _host(p).items()}
    tx, th = _t(x).requires_grad_(), _t(h).requires_grad_()
    got = tdv3.gru_apply(tp, tx, th)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    grads = torch.autograd.grad((got ** 2).sum(), [tp["b"], tp["wh"], tp["wx"], tx, th])
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRADS)
    # The cell is torch.nn.GRUCell's with its hidden bias at zero (gates r, u,
    # candidate; the weights transposed): the port computes it in tensor ops
    # in the reference's layout.
    cell = torch.nn.GRUCell(6, 5)
    with torch.no_grad():
        cell.weight_ih.copy_(_t(np.asarray(p["wx"])).T)
        cell.weight_hh.copy_(_t(np.asarray(p["wh"])).T)
        cell.bias_ih.copy_(_t(np.asarray(p["b"])))
        cell.bias_hh.zero_()
        np.testing.assert_allclose(_np(cell(tx, th)), np.asarray(want), **F32)


@ENVS
def test_world_loss_and_ac_loss_match_reference(env):
    """One update from the reference's weights, batch and key. The world
    loss: its metrics, its detached states and its gradients over every
    world-model leaf. Then ac_loss through the UPDATED world model: its
    metrics, the new return scale, and the actor's and the critic's
    gradients (the reference differentiates argnums (0, 1) only). The world
    model gets no gradient from ac_loss: its tensors' ``.grad`` stays None and
    it holds the reference's world-step-only values, though (continuous
    actions) the actor's loss does reach it through the dynamics."""
    ref, _, probe = _reference(env)
    ours = _ours(ref)
    try:
        cfg = ref._algo_config
        batch = _batch(ref, 1)
        key = jax.random.PRNGKey(5)
        out, found = probe(*_state(ref), {k: jnp.asarray(v) for k, v in batch.items()}, key)
        ((_, waux), wgrads), ((_, aaux), (agrads, cgrads)) = found
        draws = _update_draws(key, ref)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, aux = tdv3.world_loss(ours.params, tb, draws["world"], ours._algo_config)
        for got, want in zip(aux["states"], waux["states"]):
            assert not got.requires_grad
            np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
        np.testing.assert_allclose(_np(loss), np.asarray(waux["model_loss"]), **F32)
        m, grads = ours.train_step(batch, draws)
        assert float(waux["kl_dyn"]) > cfg.free_bits  # the KL's gradients are live
        for k in ("model_loss", "recon_loss", "reward_loss", "kl_dyn"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(waux[k]), **F32, err_msg=k)
        for k in ("actor_loss", "critic_loss", "imagined_return", "actor_entropy"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(aaux[k]), **F32, err_msg=k)
        np.testing.assert_allclose(_np(ours.return_scale), np.asarray(aaux["return_scale"]), **F32)
        want = [jax.tree_util.tree_leaves(t) for t in (wgrads, agrads, cgrads)]
        assert len(grads) == sum(map(len, want))
        for i, (g, w) in enumerate(zip(grads, want[0] + want[1] + want[2])):
            np.testing.assert_allclose(_np(g), np.asarray(w), **GRADS, err_msg=f"gradient {i}")
        _assert_stepped(ours.params, out[0], want[0], cfg.lr, "world model after the update")
        for p in tree_leaves(ours.params) + tree_leaves(ours.actor_params) + tree_leaves(ours.critic_params):
            assert p.grad is None
        if not ours.discrete:
            total, _ = tdv3.ac_loss(ours.actor_params, ours.critic_params, ours.params, ours.critic_ema,
                                    tuple(_t(np.asarray(x)) for x in waux["states"]), ours.return_scale, draws,
                                    ours._algo_config, False, ours.act_dim)
            reach = torch.autograd.grad(total, tree_leaves(ours.params), allow_unused=True)
            assert any(g is not None and float(g.abs().max()) > 0 for g in reach)
    finally:
        ours.cleanup()


@ENVS
def test_imagine_and_lambda_returns_match_reference(env):
    """imagine's features [H+1, N, feat] and entropies from the world loss's
    states, and lambda_returns on random rewards, continues and values."""
    ref, fns, _ = _reference(env)
    ours = _ours(ref)
    try:
        cfg = ref._algo_config
        rng = np.random.default_rng(3)
        N, D, Z = 12, cfg.deter_size, cfg.latent_groups * cfg.latent_classes
        h0 = rng.normal(size=(N, D)).astype(np.float32)
        z0 = np.eye(cfg.latent_classes, dtype=np.float32)[rng.integers(cfg.latent_classes, size=(N, cfg.latent_groups))]
        z0 = z0.reshape(N, Z)
        key = jax.random.PRNGKey(8)
        jfeat, jents = fns["imagine"](ref.params, ref.actor_params, jnp.asarray(h0), jnp.asarray(z0), key)
        feat, ents = tdv3.imagine(ours.params, ours.actor_params, _t(h0), _t(z0),
                                  _imagine_draws(key, N, cfg, ref.act_dim, ref.discrete), ours._algo_config,
                                  ours.discrete, ours.act_dim)
        np.testing.assert_allclose(_np(feat), np.asarray(jfeat), **F32)
        np.testing.assert_allclose(_np(ents), np.asarray(jents), **F32)
        H = cfg.imagine_horizon
        r, c, v = rng.normal(size=(H, N)), rng.uniform(0, 1, (H, N)), rng.normal(size=(H + 1, N))
        r, c, v = (x.astype(np.float32) for x in (r, c, v))
        want = fns["lambda_returns"](jnp.asarray(r), jnp.asarray(c), jnp.asarray(v))
        got = tdv3.lambda_returns(_t(r), _t(c), _t(v), cfg.gamma, cfg.lambda_)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    finally:
        ours.cleanup()


@ENVS
def test_three_updates_match_reference(env):
    """Three full updates from the reference's weights with its batches and
    draws: the metrics; the world model, actor, critic and critic EMA; the
    three Adam states' first moments and counts; the return scale — the
    first within F32, the second and third within TRAJ."""
    ref, _, probe = _reference(env)
    ours = _ours(ref)
    try:
        state = _state(ref)
        for step in range(3):
            batch = _batch(ref, 10 + step)
            key = jax.random.PRNGKey(30 + step)
            (*state, jm), _ = probe(*state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
            m = ours.update(batch, _update_draws(key, ref))
            tol = F32 if step == 0 else TRAJ
            for k in jm:
                np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), **tol, err_msg=f"{k} at {step}")
            for name, want in zip(("params", "actor_params", "critic_params", "critic_ema"), state[:4]):
                _assert_tree(getattr(ours, name), want, tol, f"{name} after {step}")
            for name, want in zip(("model", "actor", "critic"), state[4:7]):
                adam = _adam_mu(want)
                assert ours.opt[name].count == int(adam.count) == step + 1
                for a, b in zip(ours.opt[name].mu, jax.tree_util.tree_leaves(adam.mu)):
                    np.testing.assert_allclose(_np(a), np.asarray(b), **tol, err_msg=f"{name} mu at {step}")
                for a, b in zip(ours.opt[name].nu, jax.tree_util.tree_leaves(adam.nu)):
                    np.testing.assert_allclose(_np(a), np.asarray(b), **tol, err_msg=f"{name} nu at {step}")
            np.testing.assert_allclose(_np(ours.return_scale), np.asarray(state[7]), **tol)
        assert float(state[7]) != 1.0  # the percentile scale moved
        assert ours._updates == 3
    finally:
        ours.cleanup()


def test_sequence_replay_sample_matches_reference():
    """The ring buffer's samples element for element, before the ring is
    full and after it wraps (windows across the physical wrap point)."""
    rng = np.random.default_rng(0)
    ours, ref = tdv3._SequenceReplay(50, 3, 2, 7), jdv3._SequenceReplay(50, 3, 2, 7)
    for i in range(120):
        row = (rng.normal(size=3).astype(np.float32), rng.normal(size=2).astype(np.float32), float(rng.normal()),
               bool(rng.random() < 0.1), i % 17 == 0)
        ours.add(*row)
        ref.add(*row)
        if i in (30, 119):
            for _ in range(3):
                got, want = ours.sample(4, 12), ref.sample(4, 12)
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                assert np.all(got["is_first"][:, 0] == 1.0)
    assert len(ours) == len(ref) == 50


# -- the reference's smoke and learning tests ---------------------------------------------


def test_dreamerv3_pendulum_smoke_and_checkpoint():
    """tests/test_rllib_dreamerv3.py's case: its config and checks, the
    transient carry of compute_single_action, and the checkpoint round trip
    (the reference's keys and the generator's state) into a second build."""
    from ray_tpu_torch.rllib import DreamerV3Config

    cfg = (
        DreamerV3Config()
        .environment("Pendulum-v1")
        .training(
            learning_starts=200, rollout_steps_per_iter=250, train_intensity=25,
            batch_size=4, batch_length=12, deter_size=64, model_hiddens=(64,),
            latent_groups=4, latent_classes=8, imagine_horizon=8,
        )
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo, algo2 = cfg.build(), cfg.build()
    try:
        for _ in range(2):
            r = algo.step()
        for key in ("model_loss", "recon_loss", "reward_loss", "actor_loss", "critic_loss"):
            assert np.isfinite(r[key]), key
        carry = [c.clone() for c in algo._carry]
        a = algo.compute_single_action(np.zeros(3, np.float32))
        assert a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0
        assert all(torch.equal(x, y) for x, y in zip(algo._carry, carry))
        ckpt = algo.save_checkpoint()
        data = ckpt.to_dict()
        assert set(data) == {"params", "actor", "critic", "critic_ema", "return_scale", "timesteps", "updates", "rng"}
        w0 = algo.params["reward"][0]["w"].detach().clone()
        algo.load_checkpoint(ckpt)
        assert torch.equal(algo.params["reward"][0]["w"].detach(), w0)
        algo2.load_checkpoint(ckpt)
        for name in ("params", "actor_params", "critic_params", "critic_ema"):
            for x, y in zip(tree_leaves(getattr(algo, name)), tree_leaves(getattr(algo2, name))):
                assert torch.equal(x.detach(), y.detach()), name
        assert float(algo2.return_scale) == float(algo.return_scale) != 1.0
        assert algo2._updates == algo._updates > 0 and algo2._timesteps_total == 500
        assert torch.equal(torch.rand(4, generator=algo._gen), torch.rand(4, generator=algo2._gen))
    finally:
        algo.cleanup()
        algo2.cleanup()


def test_dreamerv3_discrete_smoke():
    from ray_tpu_torch.rllib import DreamerV3Config

    cfg = (
        DreamerV3Config()
        .environment("CartPole-v1")
        .training(
            learning_starts=200, rollout_steps_per_iter=250, train_intensity=25,
            batch_size=4, batch_length=12, deter_size=64, model_hiddens=(64,),
            latent_groups=4, latent_classes=8, imagine_horizon=8,
        )
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        for _ in range(2):
            r = algo.step()
        assert np.isfinite(r["model_loss"]) and np.isfinite(r["actor_loss"])
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
        assert algo.compute_single_action(np.zeros(4, np.float32), explore=True) in (0, 1)
    finally:
        algo.cleanup()


class Reach1D:
    """tests/test_rllib_dreamerv3.py's env on the port's spaces: move to the
    target; obs [pos, target], action in [-1, 1], pos += 0.2 * a, reward
    -|pos - target|, 20-step episodes. Random policy averages about -18 per
    episode; a good policy -5."""

    observation_space = Box(-2, 2, (2,), np.float32)
    action_space = Box(-1, 1, (1,), np.float32)

    def __init__(self, config=None):
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = float(self._rng.uniform(-1, 1))
        self.target = float(self._rng.uniform(-1, 1))
        self.t = 0
        return np.array([self.pos, self.target], np.float32), {}

    def step(self, a):
        self.pos = float(np.clip(self.pos + 0.2 * float(np.asarray(a).ravel()[0]), -2, 2))
        self.t += 1
        r = -abs(self.pos - self.target)
        return np.array([self.pos, self.target], np.float32), r, False, self.t >= 20, {}

    def close(self):
        pass


def test_dreamerv3_evaluation():
    """tests/test_rllib_dreamerv3.py's case: two greedy episodes with a
    persistent carry, and the live carry, observation and episode flag
    intact after them."""
    from ray_tpu_torch.rllib import DreamerV3Config

    cfg = (
        DreamerV3Config()
        .environment(Reach1D)
        .training(
            learning_starts=100, rollout_steps_per_iter=150, train_intensity=50,
            batch_size=4, batch_length=12, deter_size=64, model_hiddens=(64,),
            latent_groups=4, latent_classes=8, imagine_horizon=8,
        )
        .evaluation(evaluation_interval=1, evaluation_duration=2)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        real_eval = algo._evaluate_local
        seen = {}

        def checked(duration, by_episodes):
            seen["before"] = ([c.clone() for c in algo._carry], algo._obs.copy(), algo._ep_first)
            out = real_eval(duration, by_episodes)
            seen["after"] = ([c.clone() for c in algo._carry], algo._obs.copy(), algo._ep_first)
            return out

        algo._evaluate_local = checked
        r = algo.train()
        ev = r["evaluation"]
        assert ev["episodes_this_iter"] == 2
        assert ev["episode_len_mean"] == 20
        assert np.isfinite(ev["episode_reward_mean"])
        (c0, o0, f0), (c1, o1, f1) = seen["before"], seen["after"]
        assert all(torch.equal(x, y) for x, y in zip(c0, c1)) and np.array_equal(o0, o1) and f0 == f1
        # Eval must not corrupt the training rollout's live RSSM carry.
        r2 = algo.train()
        assert np.isfinite(r2["model_loss"])
    finally:
        algo.cleanup()


def test_dreamerv3_learns_reach1d():
    """tests/test_rllib_dreamerv3.py's case: its config and bar (> -8 within
    25 iterations); the run stops once the bar is met."""
    from ray_tpu_torch.rllib import DreamerV3Config

    cfg = (
        DreamerV3Config()
        .environment(Reach1D)
        .training(
            learning_starts=300, rollout_steps_per_iter=400, train_intensity=10,
            batch_size=8, batch_length=12, deter_size=64, model_hiddens=(64,),
            latent_groups=4, latent_classes=8, imagine_horizon=10,
            entropy_coeff=1e-3,
        )
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    best = -1e9
    try:
        for _ in range(25):
            r = algo.step()
            m = r.get("episode_reward_mean")
            if m is not None and np.isfinite(m):
                best = max(best, m)
            if best > -8:
                break
        # Random policy sits near -18; the world-model-driven actor must
        # clearly beat it.
        assert best > -8, f"DreamerV3 failed to learn Reach1D (best={best})"
        assert np.isfinite(r["model_loss"])
    finally:
        algo.cleanup()
