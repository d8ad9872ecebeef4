"""The port's lighter RLlib algorithms on the CPU, held to ``ray_tpu.rllib``:
MARWIL and BC, the slate env and SlateQ, QMIX, and the LinUCB/LinTS bandits
(no cluster: none of them starts an actor).

- MARWIL's loss and gradients from the reference's weights
  (``rl_module_params_from_jax``) with beta 0 and 2 (with beta 0 the value
  head's gradient is zeros, not missing, in both), and three learner updates
  (MARWIL and BC) from the same weights and batches.
- ``SlateRecEnv`` step for step against the reference's from one seed.
- SlateQ's ``per_item``, ``greedy_slate_value`` (slates index for index,
  ties broken by the lower index as ``jax.lax.top_k`` breaks them) and three
  updates through its two Adams, from the reference's weights
  (``slateq_params_from_jax``); the reference's functions are taken from its
  jitted update's closure.
- QMIX's mixer, loss and gradients (a hypernet output pinned at 0, where
  ``jnp.abs``'s derivative is +1 and ``torch.abs``'s 0: the port takes the
  reference's), three train steps, and its first iteration from
  the reference's weights (``qmix_params_from_jax``): the replay buffer
  element for element (both packages draw epsilon with numpy).
- ``_LinearArm``'s Sherman-Morrison updates, UCB scores and Thompson draws,
  LinUCB/LinTS iterations and the checkpoint round trip against the
  reference's, bit for bit (numpy on both sides).
- The reference tests' learning bars on the port (BC 45/50, MARWIL 40/50,
  QMIX 7.5, SlateQ 24, LinUCB and LinTS 0.8), each stopping once met.

Tolerances (f32 on the CPU, both sides): a loss, its metrics and one update
rtol 1e-5 / atol 1e-6; gradients rtol 1e-4 / atol 1e-6; weights after three
updates rtol 1e-4 / atol 1e-6. ~25 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium as gym
import ray_tpu.rllib.algorithms.marwil.marwil as jmarwil
import ray_tpu.rllib.algorithms.qmix.qmix as jqmix
from ray_tpu.rllib import BanditLinTS as JBanditLinTS
from ray_tpu.rllib import BanditLinUCB as JBanditLinUCB
from ray_tpu.rllib import QMIXConfig as JQMIXConfig
from ray_tpu.rllib import SlateQConfig as JSlateQConfig
from ray_tpu.rllib.algorithms.bandits.bandits import _LinearArm as JLinearArm
from ray_tpu.rllib.core import learner as jlearner
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.env.multi_agent_env import MultiAgentEnv as JMultiAgentEnv
from ray_tpu.rllib.env.recsys import SlateRecEnv as JSlateRecEnv
from ray_tpu.rllib.policy.sample_batch import ACTIONS, OBS, VALUE_TARGETS
from ray_tpu_torch.rllib import (
    BanditLinTS,
    BanditLinUCB,
    BCConfig,
    MARWILConfig,
    MultiAgentEnv,
    QMIXConfig,
    SlateQConfig,
)
from ray_tpu_torch.rllib.algorithms.bandits.bandits import _LinearArm
from ray_tpu_torch.rllib.algorithms.marwil import marwil as tmarwil
from ray_tpu_torch.rllib.algorithms.qmix import qmix as tqmix
from ray_tpu_torch.rllib.algorithms.slateq import slateq as tslateq
from ray_tpu_torch.rllib.core.learner import Learner, to_device
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, copy_into, rl_module_params_from_jax, tree_leaves
from ray_tpu_torch.rllib.env import Box, Discrete, SlateRecEnv
from ray_tpu_torch.rllib.offline import JsonWriter
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from torch_rllib_reference import reference_grads

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-6)


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
    """Writable numpy copies of a JAX tree."""
    return jax.tree_util.tree_map(np.array, tree)


def _assert_tree(got, want, tol, what):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=f"{what} leaf {i}")


def _assert_metrics(got: dict, want: dict, tol, what):
    for k in want:
        np.testing.assert_allclose(float(_np(got[k])), float(want[k]), **tol, err_msg=f"{what}: {k}")


# -- MARWIL and BC -------------------------------------------------------------------


SPEC = dict(obs_dim=4, action_dim=2, discrete=True, hiddens=(64, 64))


def _marwil_batch(seed, n=256):
    rng = np.random.default_rng(seed)
    return {
        OBS: rng.uniform(-1, 1, (n, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, n),
        VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    }


@pytest.mark.parametrize("beta", [0.0, 2.0])
def test_marwil_loss_and_gradients_match_reference(beta):
    jspec, tspec = jrm.RLModuleSpec(**SPEC), RLModuleSpec(**SPEC)
    params = jrm.init_params(jax.random.PRNGKey(0), jspec)
    batch = _marwil_batch(1)
    # vf_coeff 1 with beta 0: the gate, not the coefficient, drops the value term.
    cfg = {"beta": beta, "vf_coeff": 1.0, "entropy_coeff": 0.01}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_total, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmarwil.marwil_loss(p, jb, jspec, cfg), has_aux=True))(params)
    module = rl_module_params_from_jax(_host(params), tspec, device="cpu")
    leaves = tree_leaves(module.param_tree())
    total, aux = tmarwil.marwil_loss(module, to_device(batch, torch.device("cpu")), tspec, cfg)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(_np(total), np.asarray(j_total), **F32)
    _assert_metrics(aux, j_aux, F32, f"beta {beta}")
    _assert_tree(list(grads), j_grads, GRADS, f"beta {beta} gradients")
    tree = module.param_tree()
    value_head = {id(t) for t in tree_leaves(tree["vf"]) + tree_leaves(tree["vf_out"])}
    vf_grads = [g for p, g in zip(leaves, grads) if id(p) in value_head]
    assert len(vf_grads) == 6
    j_vf = jax.tree_util.tree_leaves({"vf": j_grads["vf"], "vf_out": j_grads["vf_out"]})
    if beta == 0.0:
        # Gated off: a gradient of zeros (autograd returned it; none is None).
        assert all(not torch.any(g) for g in vf_grads)
        assert all(not np.any(np.asarray(g)) for g in j_vf)
    else:
        assert all(torch.any(g) for g in vf_grads)


@pytest.mark.parametrize("algo", ["marwil", "bc"])
def test_three_learner_updates_match_reference(algo):
    """Three updates of the learner (Adam, global-norm clip 40) from the
    reference's weights, on the same batches."""
    cfg = {"beta": 2.0, "vf_coeff": 1.0, "entropy_coeff": 0.0} if algo == "marwil" else \
        {"beta": 0.0, "vf_coeff": 0.0, "entropy_coeff": 0.0}
    jspec, tspec = jrm.RLModuleSpec(**SPEC), RLModuleSpec(**SPEC)
    ref = jlearner.Learner(jspec, jmarwil.marwil_loss, lr=5e-3, grad_clip=40.0, seed=0)
    ours = Learner(tspec, tmarwil.marwil_loss, lr=5e-3, grad_clip=40.0, device="cpu")
    ours.set_weights(ref.get_weights())
    for i in range(3):
        batch = SampleBatch(_marwil_batch(10 + i, n=512))
        want, got = ref.update(batch, cfg), ours.update(batch, cfg)
        _assert_metrics(got, want, F32 if i == 0 else TRAJ, f"{algo} update {i}")
        _assert_tree(ours.module.param_tree(), ref.params, F32 if i == 0 else TRAJ, f"{algo} weights after {i + 1}")


# -- the slate env and SlateQ --------------------------------------------------------


def test_slate_env_matches_reference_step_for_step():
    ours, ref = SlateRecEnv({"seed": 3}), JSlateRecEnv({"seed": 3})
    assert ours.observation_dim == ref.observation_dim == 6 + 10 * 7
    np.testing.assert_array_equal(ours.reset(seed=5)[0], ref.reset(seed=5)[0])
    rng = np.random.default_rng(0)
    ends = clicks = 0
    for t in range(100):
        slate = rng.choice(10, 2, replace=False)
        s1, s2 = ours.step(slate), ref.step(slate)
        np.testing.assert_array_equal(s1[0], s2[0])
        assert s1[1:] == s2[1:], t
        clicks += s1[4]["clicked"] >= 0
        if s1[2]:
            ends += 1
            np.testing.assert_array_equal(ours.reset()[0], ref.reset()[0])  # the next draws of the stream
    assert ends == 2 and clicks > 10


def _slate_batch(seed, B=64):
    rng = np.random.default_rng(seed)
    return {
        "user": rng.normal(size=(B, 6)).astype(np.float32),
        "docs": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "next_user": rng.normal(size=(B, 6)).astype(np.float32),
        "next_docs": rng.normal(size=(B, 10, 7)).astype(np.float32),
        "slate": np.stack([rng.choice(10, 2, replace=False) for _ in range(B)]).astype(np.int32),
        "clicked": rng.integers(-1, 2, B).astype(np.int32),
        "reward": rng.uniform(0, 2, B).astype(np.float32),
        "done": (rng.random(B) < 0.1).astype(np.float32),
    }


def _closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.fixture(scope="module")
def slateq_pair():
    """The reference's SlateQ and the port's (on the CPU) from the
    reference's weights, with ``choice_lr`` apart from ``lr`` (two Adams)."""
    ref = JSlateQConfig().environment(JSlateRecEnv).training(lr=1e-3, choice_lr=3e-3).debugging(seed=0).build()
    ours = SlateQConfig().environment(SlateRecEnv).training(lr=1e-3, choice_lr=3e-3).debugging(seed=0) \
        .resources(device="cpu").build()
    copy_into(ours.params, tslateq.slateq_params_from_jax(_host(ref.params), device="cpu"))
    copy_into(ours.target_params, tslateq.slateq_params_from_jax(_host(ref.target_params), device="cpu"))
    yield ref, ours
    ref.cleanup()
    ours.cleanup()


def test_slateq_per_item_and_greedy_slates_match_reference(slateq_pair):
    ref, ours = slateq_pair
    gsv = _closure(ref._update, "greedy_slate_value")
    per_item = _closure(gsv, "per_item")
    b = _slate_batch(0)
    user, docs = jnp.asarray(b["user"]), jnp.asarray(b["docs"])
    tu, td = torch.from_numpy(b["user"]), torch.from_numpy(b["docs"])
    for head in ("q", "choice"):
        np.testing.assert_allclose(_np(tslateq.per_item(ours.params[head], tu, td)),
                                   np.asarray(per_item(ref.params[head], user, docs)), **F32)
    j_val, j_top = gsv(ref.params, user, docs)
    val, top = tslateq.greedy_slate_value(ours.params, tu, td, ours.K, ours.no_click_mass)
    np.testing.assert_allclose(_np(val), np.asarray(j_val), **F32)
    np.testing.assert_array_equal(_np(top), np.asarray(j_top))
    np.testing.assert_array_equal(ours.greedy_slates(b["user"], b["docs"]), np.asarray(ref._greedy(ref.params, user,
                                                                                                    docs)))
    # Ties: a q head that is one constant (negative: score = q; positive with a
    # constant affinity: score = exp(v) q) ties every candidate; both seat
    # the lowest indices first.
    for q_bias, v_bias in ((-0.5, 0.0), (0.5, 0.1)):
        heads = {"q": [dict(layer) for layer in _host(ref.params["q"])],
                 "choice": [dict(layer) for layer in _host(ref.params["choice"])]}
        for name, bias in (("q", q_bias), ("choice", v_bias)):
            heads[name][-1] = {"w": np.zeros_like(heads[name][-1]["w"]), "b": np.full_like(heads[name][-1]["b"], bias)}
        j_top = np.asarray(gsv(jax.tree_util.tree_map(jnp.asarray, heads), user, docs)[1])
        t_heads = tslateq.slateq_params_from_jax(heads, device="cpu")
        top = _np(tslateq.greedy_slate_value(t_heads, tu, td, ours.K, ours.no_click_mass)[1])
        np.testing.assert_array_equal(top, j_top)
        np.testing.assert_array_equal(top, np.tile([0, 1], (len(top), 1)))


def test_slateq_three_updates_match_reference(slateq_pair):
    ref, ours = slateq_pair
    for i in range(3):
        b = _slate_batch(20 + i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if i == 0:
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            _, _, q_grads, choice_grads = ours.loss_and_grads(tb)
            j_grads = reference_grads(ref._update, ref.params, ref.target_params, ref.opt_state, jb)
            _assert_tree(q_grads, j_grads["q"], GRADS, "q gradients")
            _assert_tree(choice_grads, j_grads["choice"], GRADS, "choice gradients")
        ref.params, ref.opt_state, want = ref._update(ref.params, ref.target_params, ref.opt_state, jb)
        got = ours.update(b)
        _assert_metrics(got, want, F32 if i == 0 else TRAJ, f"update {i}")
        _assert_tree(ours.params, ref.params, F32 if i == 0 else TRAJ, f"weights after {i + 1}")
    # Each head has its own Adam: a moment of the choice head's is the choice
    # chain's alone.
    assert ours.opt["q"].count == ours.opt["choice"].count == 3
    assert ours.opt["choice"].lr == 3e-3 and ours.opt["q"].lr == 1e-3


# -- QMIX ----------------------------------------------------------------------------


class TwoStepGame:
    """The cooperative matrix game of tests/test_rllib_multiagent.py: agent 0's
    first action picks the payoff matrix of the second step; the optimum (8)
    needs a coordinated (1, 1)."""

    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._state = 0

    def _obs(self):
        o = np.zeros(3, np.float32)
        o[self._state] = 1.0
        return {a: o.copy() for a in self.possible_agents}

    def reset(self, *, seed=None):
        self._state = 0
        return self._obs(), {}

    def step(self, action_dict):
        if self._state == 0:
            self._state = 1 if action_dict["a0"] == 0 else 2
            return self._obs(), {a: 0.0 for a in self.possible_agents}, {"__all__": False}, {"__all__": False}, {}
        if self._state == 1:
            r = 7.0
        else:
            r = float(np.array([[0.0, 1.0], [1.0, 8.0]])[action_dict["a0"], action_dict["a1"]])
        return self._obs(), {a: r / 2 for a in self.possible_agents}, {"__all__": True}, {"__all__": False}, {}

    def close(self):
        pass


class PortTwoStep(TwoStepGame, MultiAgentEnv):
    observation_space = Box(0.0, 1.0, (3,), np.float32)
    action_space = Discrete(2)


class RefTwoStep(TwoStepGame, JMultiAgentEnv):
    observation_space = gym.spaces.Box(0.0, 1.0, (3,), np.float32)
    action_space = gym.spaces.Discrete(2)


QMIX_TRAINING = dict(lr=3e-3, train_batch_size=64, learning_starts=128, target_network_update_freq=40,
                     rollout_steps_per_iter=400, epsilon_timesteps=3000, final_epsilon=0.05, gamma=0.99)


def _qmix_pair(**training):
    ref = JQMIXConfig().environment(RefTwoStep).training(**training).debugging(seed=0).build()
    ours = QMIXConfig().environment(PortTwoStep).training(**training).debugging(seed=0).resources(device="cpu").build()
    copy_into(ours.params, tqmix.qmix_params_from_jax(_host(ref.params), device="cpu"))
    copy_into(ours.target, tqmix.qmix_params_from_jax(_host(ref.target), device="cpu"))
    return ref, ours


def _qmix_batch(seed, B=64):
    rng = np.random.default_rng(seed)
    obs = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, 2))]
    next_obs = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, 2))]
    return {
        "obs": obs, "next_obs": next_obs,
        "state": obs.reshape(B, -1), "next_state": next_obs.reshape(B, -1),
        "actions": rng.integers(0, 2, (B, 2)),
        "rewards": rng.choice([0.0, 1.0, 7.0, 8.0], B).astype(np.float32),
        "dones": (rng.random(B) < 0.5).astype(np.float32),
    }


def test_qmix_mixer_loss_gradients_and_train_steps_match_reference():
    ref, ours = _qmix_pair(**QMIX_TRAINING)
    try:
        # Agent 0's column block of hyper_w1's output pinned at 0, where |.|
        # is not differentiable.
        E = ours._algo_config.mixing_embed_dim
        params = _host(ref.params)
        params["hyper_w1"][-1]["w"][:, :E] = 0.0
        params["hyper_w1"][-1]["b"][:E] = 0.0
        ref.params = jax.tree_util.tree_map(jnp.asarray, params)
        copy_into(ours.params, tqmix.qmix_params_from_jax(params, device="cpu"))
        b = _qmix_batch(0)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        q_taken = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
        np.testing.assert_allclose(_np(tqmix.mixer(ours.params, torch.from_numpy(q_taken), tb["state"])),
                                   np.asarray(jqmix._mixer(ref.params, jnp.asarray(q_taken), jb["state"])), **F32)
        loss_fn = _closure(ref._train_step, "loss_fn")
        (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(ref.params, ref.target, jb)
        loss, aux = tqmix.qmix_loss(ours.params, ours.target, tb, gamma=0.99)
        grads = torch.autograd.grad(loss, tree_leaves(ours.params))
        np.testing.assert_allclose(_np(loss), np.asarray(j_loss), **F32)
        _assert_metrics(aux, j_aux, F32, "qmix loss")
        _assert_tree(list(grads), j_grads, GRADS, "qmix gradients")
        # jnp.abs's derivative at 0 is +1 (torch.abs's is 0): the pinned
        # outputs' bias still gets a gradient, the reference's.
        g_b1 = grads[[id(p) for p in tree_leaves(ours.params)].index(id(ours.params["hyper_w1"][-1]["b"]))]
        assert torch.all(g_b1[:E] != 0)
        np.testing.assert_allclose(_np(g_b1[:E]), np.asarray(j_grads["hyper_w1"][-1]["b"])[:E], **GRADS)
        for i in range(3):
            b = _qmix_batch(10 + i)
            ref.params, ref.opt_state, want = ref._train_step(ref.params, ref.target, ref.opt_state,
                                                              {k: jnp.asarray(v) for k, v in b.items()})
            got = ours.train_step(b)
            _assert_metrics(got, want, F32 if i == 0 else TRAJ, f"train step {i}")
            _assert_tree(ours.params, ref.params, F32 if i == 0 else TRAJ, f"weights after {i + 1}")
    finally:
        ref.cleanup()
        ours.cleanup()


def test_qmix_first_iteration_replay_matches_reference():
    """From the reference's weights, one iteration (400 steps, 137 updates
    from step 128) fills the port's replay buffer as the reference's, element
    for element: the epsilon draws are numpy on both sides, and the greedy
    actions come from the same Q values."""
    ref, ours = _qmix_pair(**QMIX_TRAINING)
    try:
        r_ref, r_ours = ref.step(), ours.step()
        n = len(ref.buffer)
        assert n == len(ours.buffer) == 400 and ref._updates == ours._updates == 137
        for k in ("obs", "next_obs", "state", "next_state", "actions", "rewards", "dones"):
            np.testing.assert_array_equal(ours.buffer._cols[k][:n], ref.buffer._cols[k][:n], err_msg=k)
        assert r_ours["episode_reward_mean"] == r_ref["episode_reward_mean"]
        assert r_ours["epsilon"] == r_ref["epsilon"]
    finally:
        ref.cleanup()
        ours.cleanup()


# -- the bandits ---------------------------------------------------------------------


class _ContextBandit:
    """tests/test_cluster_launcher.py's 2-arm contextual bandit: arm 0 pays
    when ctx[0] > 0, else arm 1."""

    def __init__(self, config=None):
        self._rng = np.random.default_rng(0)
        self._ctx = None

    def _next(self):
        self._ctx = self._rng.uniform(-1, 1, 2).astype(np.float32)
        return self._ctx

    def reset(self, *, seed=None, options=None):
        return self._next(), {}

    def step(self, action):
        good = 0 if self._ctx[0] > 0 else 1
        return self._next(), 1.0 if int(action) == good else 0.0, True, False, {}

    def close(self):
        pass


class PortBandit(_ContextBandit):
    observation_space = Box(-1, 1, (2,), np.float32)
    action_space = Discrete(2)


class RefBandit(_ContextBandit):
    observation_space = gym.spaces.Box(-1, 1, (2,), np.float32)
    action_space = gym.spaces.Discrete(2)


def test_linear_arm_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    ours, ref = _LinearArm(3, 0.5), JLinearArm(3, 0.5)
    for _ in range(50):
        x, r = rng.normal(size=3), float(rng.normal())
        ours.update(x, r)
        ref.update(x, r)
    for name in ("A_inv", "b", "theta"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    x = rng.normal(size=3)
    assert ours.ucb(x, 1.5) == ref.ucb(x, 1.5)
    draws = [ours.thompson(x, np.random.default_rng(s), 0.7) for s in range(5)]
    assert draws == [ref.thompson(x, np.random.default_rng(s), 0.7) for s in range(5)]


@pytest.mark.parametrize("cls, jcls", [(BanditLinUCB, JBanditLinUCB), (BanditLinTS, JBanditLinTS)])
def test_bandits_match_reference_and_learn(cls, jcls):
    """Two iterations as the reference's, bit for bit; then its learning
    test's bars (> 0.8 mean reward within 5 iterations of 200 steps), its
    greedy actions and the checkpoint round trip."""
    cfg = cls.get_default_config().environment(PortBandit)
    cfg.steps_per_iter = 200
    jcfg = jcls.get_default_config().environment(RefBandit)
    jcfg.steps_per_iter = 200
    ours, ref = cfg.build(), jcfg.build()
    try:
        for _ in range(2):
            got, want = ours.step(), ref.step()
            for k in ("mean_reward", "cumulative_reward", "arm_pulls", "episode_reward_mean", "timesteps_total"):
                assert got[k] == want[k], k
        for a, b in zip(ours.arms, ref.arms):
            np.testing.assert_array_equal(a.A_inv, b.A_inv)
            np.testing.assert_array_equal(a.theta, b.theta)
        r = got
        for _ in range(3):
            if r["mean_reward"] > 0.8:
                break
            r = ours.step()
        assert r["mean_reward"] > 0.8, r
        assert ours.compute_single_action(np.array([0.9, 0.0], np.float32)) == 0
        assert ours.compute_single_action(np.array([-0.9, 0.0], np.float32)) == 1
        ckpt = ours.save_checkpoint()
        other = cfg.build()
        other.load_checkpoint(ckpt)
        assert other._timesteps_total == ours._timesteps_total
        for a, b in zip(other.arms, ours.arms):
            np.testing.assert_array_equal(a.A_inv, b.A_inv)
            np.testing.assert_array_equal(a.theta, b.theta)
            assert a.n == b.n
        other.cleanup()
    finally:
        ours.cleanup()
        ref.cleanup()


# -- the reference tests' learning bars on the port ------------------------------------


def _offline(tmp_path, obs, actions, rewards, dones):
    w = JsonWriter(str(tmp_path))
    w.write(SampleBatch({"obs": obs, "actions": actions, "rewards": rewards, "dones": dones}))
    w.close()
    return str(tmp_path)


def _expert_matches(algo, probe) -> int:
    return sum(int(algo.compute_single_action(o) == int(o[0] > 0)) for o in probe)


def test_bc_imitates_expert(tmp_path):
    """tests/test_rllib.py's BC case: the expert picks 1 iff obs[0] > 0; 45
    of 50 probes within 60 iterations (checked every 10)."""
    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1, size=(2000, 4)).astype(np.float32)
    path = _offline(tmp_path, obs, (obs[:, 0] > 0).astype(np.int64), np.ones(2000, np.float32),
                    np.arange(2000) % 100 == 99)
    cfg = (BCConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
           .training(lr=5e-3, train_batch_size=512).debugging(seed=0).resources(device="cpu"))
    cfg.offline_data(input_=path)
    algo = cfg.build()
    try:
        probe = rng.uniform(-1, 1, size=(50, 4)).astype(np.float32)
        first = algo.step()["bc_logp"]
        for it in range(2, 61):
            r = algo.step()
            if it % 10 == 0 and _expert_matches(algo, probe) >= 45:
                break
        assert r["bc_logp"] > first, (first, r["bc_logp"])
        correct = _expert_matches(algo, probe)
        assert correct >= 45, f"BC policy only matched {correct}/50 expert actions"
    finally:
        algo.cleanup()


def test_marwil_prefers_high_return_actions(tmp_path):
    """tests/test_rllib.py's MARWIL case: half expert (reward 1), half
    anti-expert (reward 0) one-step episodes, beta 2; 40 of 50 probes within
    80 iterations (checked every 10)."""
    rng = np.random.default_rng(1)
    n = 3000
    obs = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    expert_a = (obs[:, 0] > 0).astype(np.int64)
    follow = rng.uniform(size=n) < 0.5
    path = _offline(tmp_path, obs, np.where(follow, expert_a, 1 - expert_a),
                    np.where(follow, 1.0, 0.0).astype(np.float32), np.ones(n, bool))
    cfg = (MARWILConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
           .training(lr=5e-3, train_batch_size=1024, beta=2.0).debugging(seed=0).resources(device="cpu"))
    cfg.offline_data(input_=path)
    algo = cfg.build()
    try:
        probe = rng.uniform(-1, 1, size=(50, 4)).astype(np.float32)
        for it in range(1, 81):
            algo.step()
            if it % 10 == 0 and _expert_matches(algo, probe) >= 40:
                break
        correct = _expert_matches(algo, probe)
        assert correct >= 40, f"MARWIL matched expert on only {correct}/50"
    finally:
        algo.cleanup()


def test_qmix_learns_two_step_game():
    """tests/test_rllib_multiagent.py's QMIX case: a best mean reward of 7.5
    within 15 iterations, then the greedy joint policy takes the (1, *)
    branch."""
    algo = QMIXConfig().environment(PortTwoStep).training(**QMIX_TRAINING).debugging(seed=0) \
        .resources(device="cpu").build()
    best = -1e9
    try:
        for _ in range(15):
            r = algo.step()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 7.5:
                break
        assert best >= 7.5, f"QMIX failed to coordinate (best={best})"
        obs, _ = PortTwoStep().reset()
        assert algo.compute_actions(obs)["a0"] == 1
        ckpt = algo.save_checkpoint()
        algo.load_checkpoint(ckpt)
        assert algo._updates == ckpt.to_dict()["updates"]
    finally:
        algo.cleanup()


def test_slateq_learns_interest_evolution():
    """tests/test_rllib_slateq.py's case: a best mean session reward of 24
    (random slates score ~17.6) within 25 iterations; a greedy slate of K
    distinct candidates; the checkpoint round trip."""
    cfg = (SlateQConfig().environment(SlateRecEnv)
           .training(rollout_steps_per_iter=400, learning_starts=400, train_intensity=2, epsilon_timesteps=4000)
           .debugging(seed=0).resources(device="cpu"))
    algo = cfg.build()
    best = -1e9
    try:
        for _ in range(25):
            erm = algo.step().get("episode_reward_mean")
            if erm == erm:  # not NaN
                best = max(best, erm)
            if best >= 24:
                break
        assert best >= 24, f"SlateQ failed to beat random slates (best={best})"
        obs, _ = algo.env.reset(seed=7)
        slate = algo.compute_single_action(obs)
        assert len(set(int(i) for i in slate)) == algo.K
        assert all(0 <= int(i) < algo.C for i in slate)
        other = cfg.build()
        other.load_checkpoint(algo.save_checkpoint())
        assert other._timesteps_total == algo._timesteps_total and other._updates == algo._updates
        _assert_tree(other.params, [_np(t) for t in tree_leaves(algo.params)], dict(rtol=0, atol=0), "restored weights")
        other.cleanup()
    finally:
        algo.cleanup()
