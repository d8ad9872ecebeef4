"""The port's RLlib layers on the CPU, against the JAX package's, without a
cluster.

- ``RLModule`` through ``rl_module_params_from_jax``: the forward, greedy
  ``sample_actions``, the logp of sampled actions and
  ``action_logp_and_entropy``, for an MLP (discrete and continuous) and the
  conv torso on a 10 x 10 x 3 image (NHWC flatten order), within 1e-5.
- ``pack_weights`` equal to the reference's packed vector bit for bit, and
  ``unpack_weights`` round-tripping (``tests/test_podracer.py``'s cases).
- One learner update after another on one batch, from the same weights: the
  loss, the metrics (``grad_norm`` before the clip), the gradients and the
  new weights within f32 bars of the JAX learner's, for PPO (Adam, the clip
  active), IMPALA and APPO (V-trace), and SGD.
- ``vtrace`` against the reference's ``lax.scan`` on random inputs with
  terminals and fragment cuts; ``compute_gae`` and the minibatch order.
- ``dt_forward``'s logits and one DT AdamW step against the reference
  (``dt_params_from_jax``; the attention is the flash kernels' plain version).
- The port's CartPole-v1 against gymnasium's, step for step, alone and in
  ``VectorEnv``.
- The clusterless cases of ``tests/test_rllib.py`` and the cases of
  ``tests/test_rllib_policy.py`` on the port (the policy on the CPU).
- The off-policy estimators: IS and WIS equal to the reference's, DM and DR
  within f32 bars of it (the FQE model started from the reference's weights,
  ``fqe_params_from_jax``), and ``tests/test_rllib_ope.py``'s cases on the
  port at their own bars.
- Multi-card learners and a learner mesh over more than one rank raise,
  naming their ROADMAP item; an NCCL weight group and framework names raise.

~60 s here, most of it the JAX side (eager ops and compiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.appo.appo import appo_loss as j_appo_loss
from ray_tpu.rllib.algorithms.impala.impala import impala_loss as j_impala_loss
from ray_tpu.rllib.algorithms.ppo.ppo import ppo_loss as j_ppo_loss
from ray_tpu.rllib.core import learner as jl
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu.rllib.policy import sample_batch as jsb
from ray_tpu.rllib.utils.vtrace import vtrace as j_vtrace
from ray_tpu_torch.rllib.algorithms.appo.appo import appo_loss
from ray_tpu_torch.rllib.algorithms.impala.impala import impala_loss
from ray_tpu_torch.rllib.algorithms.ppo.ppo import ppo_loss
from ray_tpu_torch.rllib.core import learner as tl
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.policy import Policy, SampleBatch
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VALUE_TARGETS,
    VF_PREDS,
    compute_gae,
)
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rllib.utils.vtrace import vtrace

F32 = dict(rtol=1e-5, atol=1e-5)  # f32 on the CPU, both sides


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's forwards and updates are small: torch's intra-op pool
    over every core, beside the suite's other test processes, slowed the
    estimators' fits many times over. One thread for the module, restored
    after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SPECS = {  # name: RLModuleSpec kwargs (the same for both packages)
    "mlp-discrete": dict(obs_dim=4, action_dim=3, discrete=True),
    "mlp-continuous": dict(obs_dim=6, action_dim=2, discrete=False),
    "conv-discrete": dict(obs_dim=300, action_dim=4, discrete=True, hiddens=(32, 32), obs_shape=(10, 10, 3),
                          conv_filters=((16, 3, 2), (32, 3, 2))),
}


def _both(name, seed=0):
    """The reference's params (seeded) and the port's module holding them."""
    jspec, tspec = jrm.RLModuleSpec(**SPECS[name]), trm.RLModuleSpec(**SPECS[name])
    params = jrm.init_params(jax.random.PRNGKey(seed), jspec)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return jspec, params, tspec, trm.rl_module_params_from_jax(np_params, tspec, device="cpu")


def _obs(spec, n, seed):
    return np.random.default_rng(seed).normal(size=(n, spec.obs_dim)).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **bars):
    np.testing.assert_allclose(_np(got), _np(want), **(bars or F32))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rl_module_matches_reference(name):
    jspec, params, tspec, module = _both(name)
    obs = _obs(tspec, 16, 1)
    x = torch.from_numpy(obs)
    pi, v = module(x)
    jpi, jv = jrm.forward(params, jnp.asarray(obs), jspec)
    _close(pi, jpi)
    _close(v, jv)
    # Greedy sampling is deterministic: the same actions, logp and values.
    a, logp, val = module.sample_actions(x, None, explore=False)
    ja, jlogp, jval = jrm.sample_actions(params, jnp.asarray(obs), jax.random.PRNGKey(0), jspec, explore=False)
    _close(a, ja)
    _close(logp, jlogp)
    _close(val, jval)
    # Exploring: the port's own draws, scored by the reference's module.
    a, logp, _ = module.sample_actions(x, torch.Generator().manual_seed(3), explore=True)
    jlogp, jent, jval = jrm.action_logp_and_entropy(params, jnp.asarray(obs), jnp.asarray(_np(a)), jspec)
    _close(logp, jlogp)
    tlogp, tent, tval = module.action_logp_and_entropy(x, a)
    _close(tlogp, jlogp)
    _close(tent, jent)
    _close(tval, jval)
    # get_params gives back the reference's tree, leaf for leaf.
    for got, want in zip(trm.tree_leaves(module.get_params()), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_conv_torso_flattens_in_nhwc_order():
    """A permutation of the conv output's channels changes the logits: the
    first dense layer reads NHWC-ordered features, as the reference's."""
    jspec, params, tspec, module = _both("conv-discrete")
    flat = module._conv_torso(module.pi_conv, torch.from_numpy(_obs(tspec, 2, 5)))
    ref = jrm._conv_torso(params["pi_conv"], jnp.asarray(_obs(tspec, 2, 5)), jspec, jnp.tanh)
    _close(flat, ref)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pack_weights_bit_equal_to_reference(name):
    _, params, _, module = _both(name, seed=4)
    packed = tl.pack_weights(module)
    want = np.asarray(jl.pack_weights(params))
    assert packed.dtype == torch.float32 and packed.shape == want.shape
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(tl.pack_weights(module.get_params()).numpy(), want)
    rebuilt = tl.unpack_weights(packed, module.get_params())
    for got, leaf in zip(trm.tree_leaves(rebuilt), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_pack_unpack_roundtrip():
    """tests/test_podracer.py's case on the port."""
    params = {"dense": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.full((3,), -1.5)},
              "head": torch.ones(4)}
    flat = tl.pack_weights(params)
    assert flat.shape == (13,) and flat.dtype == torch.float32
    rebuilt = tl.unpack_weights(flat.numpy(), params)
    for a, b in zip(trm.tree_leaves(params), trm.tree_leaves(rebuilt)):
        assert torch.equal(a, b)
    jparams = {"dense": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.full((3,), -1.5)}, "head": jnp.ones(4)}
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jl.pack_weights(jparams)))


def test_unpack_size_mismatch_raises():
    with pytest.raises(ValueError, match="disagree on the module spec"):
        tl.unpack_weights(torch.zeros(5), {"w": torch.zeros(3, 3)})


# -- learner updates ----------------------------------------------------------


def _rollout_batch(jspec, params, n, seed, frags=4):
    """A batch shaped like the rollout workers' output: actions sampled from
    the reference module, behaviour logp off the current one by noise (so
    some PPO ratios leave the clip range), GAE over ``frags`` fragments."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, jspec.obs_dim)).astype(np.float32)
    actions, logp, values = jrm.sample_actions(params, jnp.asarray(obs), jax.random.PRNGKey(seed), jspec, True)
    parts = []
    for idx in np.array_split(np.arange(n), frags):
        frag = SampleBatch({
            OBS: obs[idx], ACTIONS: np.asarray(actions)[idx],
            REWARDS: rng.normal(1.0, 0.5, len(idx)).astype(np.float32),
            DONES: rng.random(len(idx)) < 0.05,
            LOGPS: (np.asarray(logp)[idx] + rng.normal(0, 0.3, len(idx))).astype(np.float32),
            VF_PREDS: np.asarray(values)[idx],
        })
        parts.append(compute_gae(frag, float(rng.normal()), 0.99, 0.95))
    return SampleBatch.concat_samples(parts)


ALGOS = {  # name: (spec, port loss, reference loss, lr, grad_clip, optimizer, loss_cfg)
    "ppo": ("mlp-discrete", ppo_loss, j_ppo_loss, 3e-4, 0.5, "adam",
            dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.01)),
    "ppo-continuous": ("mlp-continuous", ppo_loss, j_ppo_loss, 3e-4, 0.5, "adam",
                       dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.0)),
    "ppo-conv-sgd": ("conv-discrete", ppo_loss, j_ppo_loss, 1e-2, None, "sgd",
                     dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.01)),
    "impala": ("mlp-discrete", impala_loss, j_impala_loss, 5e-4, 40.0, "adam",
               dict(gamma=0.99, rho_bar=1.0, c_bar=1.0, vf_loss_coeff=0.5, entropy_coeff=0.01)),
    "appo": ("mlp-discrete", appo_loss, j_appo_loss, 5e-4, 40.0, "adam",
             dict(gamma=0.99, rho_bar=1.0, c_bar=1.0, clip_param=0.2, vf_loss_coeff=0.5, entropy_coeff=0.01,
                  kl_coeff=0.2)),
}


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_learner_update_matches_reference(algo):
    name, loss, jloss, lr, clip, opt, cfg = ALGOS[algo]
    jspec, tspec = jrm.RLModuleSpec(**SPECS[name]), trm.RLModuleSpec(**SPECS[name])
    ref = jl.Learner(jspec, jloss, lr=lr, grad_clip=clip, seed=2, optimizer=opt)
    ours = tl.Learner(tspec, loss, lr=lr, grad_clip=clip, seed=7, optimizer=opt, device="cpu")
    ours.set_weights(ref.get_weights())
    batch = _rollout_batch(jspec, ref.params, 256, seed=3)
    # The gradients of the first update, before any step.
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: jloss(p, jb, jspec, cfg)[0])(ref.params)
    tloss, _, tgrads = ours.compute_grads(batch, cfg)
    by_name = dict(zip([id(p) for p in ours.opt.params], tgrads))
    tgrad_tree = trm.tree_map(lambda p: by_name[id(p)], ours.module.param_tree())
    for got, want in zip(trm.tree_leaves(tgrad_tree), jax.tree_util.tree_leaves(jgrads)):
        _close(got, want, rtol=1e-4, atol=1e-6)
    for step in range(3):
        jm = ref.update(batch, cfg)
        tm = ours.update(batch, cfg)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=f"step {step} {k}")
        if algo == "ppo" and step == 0:
            assert jm["grad_norm"] > clip, "the clip should be active on this batch"
        for got, want in zip(trm.tree_leaves(ours.get_weights()), jax.tree_util.tree_leaves(ref.get_weights())):
            _close(got, want, rtol=1e-5, atol=1e-6)


def test_optax_clip_has_no_epsilon():
    """optax's clip scales by max_norm / g_norm exactly (clip_grad_norm_ would
    add 1e-6 to the norm): a gradient at twice the bar lands on it."""
    p = torch.zeros(3, requires_grad=True)
    opt = tl.OptaxChain([p], lr=1.0, grad_clip=1.0, optimizer="sgd")
    g = torch.tensor([2.0, 0.0, 0.0])
    opt.step([g], tl.global_norm([g]))
    assert p.tolist() == [-1.0, 0.0, 0.0]


# -- V-trace, GAE, minibatches --------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 300, 2000])
def test_vtrace_matches_reference(n):
    rng = np.random.default_rng(n)
    values = rng.normal(size=n).astype(np.float32)
    args = dict(
        next_values=rng.normal(size=n).astype(np.float32),
        logp=rng.normal(-0.7, 0.4, n).astype(np.float32),
        behavior_logp=rng.normal(-0.7, 0.4, n).astype(np.float32),
        rewards=rng.normal(1.0, 1.0, n).astype(np.float32),
        nonterminal=(rng.random(n) > 0.05).astype(np.float32),
        cuts=(rng.random(n) < 0.02).astype(np.float32),
    )
    args["cuts"][-1] = 1.0
    hp = dict(gamma=0.99, rho_bar=1.0, c_bar=0.9)
    got = vtrace(torch.from_numpy(values), *(torch.from_numpy(v) for v in args.values()), **hp)
    want = j_vtrace(jnp.asarray(values), *(jnp.asarray(v) for v in args.values()), **hp)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=2e-5)


def test_compute_gae_and_minibatch_order_match_reference():
    rng = np.random.default_rng(0)
    cols = {REWARDS: rng.normal(size=64).astype(np.float32), DONES: rng.random(64) < 0.1,
            VF_PREDS: rng.normal(size=64).astype(np.float32), OBS: rng.normal(size=(64, 4)).astype(np.float32)}
    ours = compute_gae(SampleBatch({k: v.copy() for k, v in cols.items()}), 0.3, 0.97, 0.9)
    ref = jsb.compute_gae(jsb.SampleBatch({k: v.copy() for k, v in cols.items()}), 0.3, 0.97, 0.9)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    for got, want in zip(ours.minibatches(16, seed=5), ref.minibatches(16, seed=5)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# -- the Decision Transformer --------------------------------------------------


def _dt_inputs(B=8, K=20, obs_dim=4, n_actions=2, seed=0):
    rng = np.random.default_rng(seed)
    act = rng.integers(0, n_actions, (B, K))
    mask = np.ones((B, K), np.float32)
    mask[:, : K // 4] = 0.0  # the windows' unfilled heads
    return (rng.normal(size=(B, K, 1)).astype(np.float32) * 50, rng.normal(size=(B, K, obs_dim)).astype(np.float32),
            np.eye(n_actions, dtype=np.float32)[act], np.tile(np.arange(K, dtype=np.int32), (B, 1)) + 3,
            act.astype(np.int64), mask)


def test_dt_forward_and_adamw_step_match_reference():
    import optax

    from ray_tpu.rllib.algorithms.dt import dt as jdt
    from ray_tpu_torch.rllib.algorithms.dt import dt as tdt

    jparams = jdt.init_dt_params(jax.random.PRNGKey(0), 4, 2, 64, 2, 2, 220)
    params = tdt.dt_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rtg, obs, act_oh, ts, act, mask = _dt_inputs()
    logits = tdt.dt_forward(params, *(torch.from_numpy(a) for a in (rtg, obs, act_oh, ts)), 2)
    jlogits = jax.jit(jdt.dt_forward, static_argnums=5)(jparams, *(jnp.asarray(a) for a in (rtg, obs, act_oh, ts)), 2)
    _close(logits, jlogits, rtol=1e-4, atol=1e-5)

    def jloss(p):
        logp = jax.nn.log_softmax(jdt.dt_forward(p, *(jnp.asarray(a) for a in (rtg, obs, act_oh, ts)), 2))
        nll = -jnp.take_along_axis(logp, jnp.asarray(act)[..., None], axis=-1)[..., 0]
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    tx = optax.adamw(1e-3)
    state = tx.init(jparams)
    opt = tl.OptaxChain(trm.tree_leaves(params), 1e-3, weight_decay=1e-4)
    jstep = jax.jit(jax.value_and_grad(jloss))
    for step in range(2):
        jl_, jgrads = jstep(jparams)
        loss = tdt.dt_loss(params, *(torch.from_numpy(a) for a in (rtg, obs, act_oh, ts, act, mask)), 2)
        grads = torch.autograd.grad(loss, opt.params)
        np.testing.assert_allclose(loss.item(), float(jl_), rtol=1e-5)
        for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            _close(g, w, rtol=1e-4, atol=1e-6)
        opt.step(grads)
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        # Adam moves an element by up to lr whatever its gradient's size, so
        # where a gradient sits near the others' rounding the two f32 runs
        # part by a share of one step: the bar is 5% of lr (1e-3). The key
        # bias (qkv's b, its middle third) has a gradient of exactly 0 in
        # exact arithmetic (softmax is shift-invariant along the keys): Adam's
        # step on its rounding noise may go either way, so it is held to 2 lr.
        for got, want in zip(trm.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
            got, want = _np(got), np.asarray(want)
            if got.shape == (3 * 64,):
                _close(got[64:128], want[64:128], rtol=0, atol=2e-3)
                got, want = np.delete(got, np.s_[64:128]), np.delete(want, np.s_[64:128])
            _close(got, want, rtol=1e-5, atol=5e-5)


# -- the port's CartPole and spaces ---------------------------------------------


def test_cartpole_matches_gymnasium():
    import gymnasium as gym

    from ray_tpu_torch.rllib.env import make

    ours, ref = make("CartPole-v1"), gym.make("CartPole-v1")
    rng = np.random.default_rng(0)
    steps = truncated = 0
    for ep in range(6):
        o, _ = ours.reset(seed=ep)
        r, _ = ref.reset(seed=ep)
        np.testing.assert_array_equal(o, r)
        while True:
            a = int(rng.integers(2)) if ep % 2 else int(o[2] + 0.5 * o[3] > 0)  # random, or the PD expert
            got, want = ours.step(a), ref.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:4] == want[1:4] and type(got[1]) is type(want[1])
            o, steps = got[0], steps + 1
            if got[2] or got[3]:
                break
        truncated += got[3]
    assert steps > 1000 and truncated == 3  # the expert's episodes run into the 500-step limit


def test_vector_env_matches_reference():
    from ray_tpu.rllib.env.vector_env import VectorEnv as JVectorEnv
    from ray_tpu_torch.rllib.env.vector_env import VectorEnv

    ours, ref = VectorEnv("CartPole-v1", 3, seed=11), JVectorEnv("CartPole-v1", 3, seed=11)
    np.testing.assert_array_equal(ours.current_obs(), ref.current_obs())
    rng = np.random.default_rng(1)
    for _ in range(300):
        a = rng.integers(0, 2, 3)
        got, want = ours.step(a), ref.step(a)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ours.eps_ids(), ref.eps_ids())
    assert ours.pop_episode_stats() == ref.pop_episode_stats()


def test_other_env_ids_need_gymnasium(monkeypatch):
    import sys

    from ray_tpu_torch.rllib.env import make

    assert make("Acrobot-v1").observation_space.shape == (6,)  # gymnasium's, here
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="'Acrobot-v1' needs the 'gymnasium' package"):
        make("Acrobot-v1")
    assert make("CartPole-v1").action_space.n == 2
    assert make("Pendulum-v1").observation_space.shape == (3,)  # the port's own


def test_spaces_match_gymnasium():
    import gymnasium as gym

    d, gd = Discrete(3), gym.spaces.Discrete(3)
    for x in (0, 2, 3, -1, np.int64(1), np.array(1), np.array([1]), 1.0, np.int8(2)):
        assert d.contains(x) == gd.contains(x), x
    b = Box(-1.0, 2.0, shape=(2, 3))
    gb = gym.spaces.Box(-1.0, 2.0, shape=(2, 3), dtype=np.float32)
    assert b.shape == gb.shape and b.dtype == gb.dtype
    np.testing.assert_array_equal(b.low, gb.low)
    assert b.contains(b.sample())
    for low, high in ((-1.0, 2.0), (-np.inf, np.inf), (0.0, np.inf), (-np.inf, 0.0)):
        ours, ref = Box(low, high, (3,), seed=4), gym.spaces.Box(low, high, (3,), np.float32, seed=4)
        np.testing.assert_array_equal(ours.sample(), ref.sample())
    ours, ref = Discrete(5, seed=2), gym.spaces.Discrete(5, seed=2)
    assert [ours.sample() for _ in range(8)] == [ref.sample() for _ in range(8)]
    spec = trm.RLModuleSpec.from_spaces(Box(0, 1, (84, 84, 4)), Discrete(6))
    assert spec == trm.RLModuleSpec.from_spaces(gym.spaces.Box(0, 1, (84, 84, 4)), gym.spaces.Discrete(6))
    assert spec.conv_filters == ((16, 8, 4), (32, 4, 2), (64, 3, 1)) and spec.action_dim == 6


# -- tests/test_rllib.py's clusterless cases on the port ------------------------------


def test_sample_batch_basics():
    b = SampleBatch({"a": np.arange(10), "b": np.arange(10) * 2.0})
    assert b.count == 10
    cat = SampleBatch.concat_samples([b, b])
    assert cat.count == 20
    sh = b.shuffle(seed=0)
    assert sorted(sh["a"]) == list(range(10))
    mbs = list(cat.minibatches(8, seed=1))
    assert all(mb.count == 8 for mb in mbs)


def test_gae_matches_reference_impl():
    rng = np.random.default_rng(0)
    n = 50
    batch = SampleBatch({
        REWARDS: rng.normal(size=n).astype(np.float32),
        DONES: (rng.random(n) < 0.1).astype(np.float32),
        VF_PREDS: rng.normal(size=n).astype(np.float32),
    })
    last_v = 0.3
    gamma, lam = 0.95, 0.9
    out = compute_gae(SampleBatch(dict(batch)), last_v, gamma, lam)
    rewards, dones, values = batch[REWARDS], batch[DONES], batch[VF_PREDS]
    vals_ext = np.append(values, last_v)
    adv = np.zeros(n)
    for t in range(n):
        acc, coef = 0.0, 1.0
        for k in range(t, n):
            nonterm = 1.0 - dones[k]
            delta = rewards[k] + gamma * vals_ext[k + 1] * nonterm - values[k]
            acc += coef * delta
            if dones[k]:
                break
            coef *= gamma * lam
        adv[t] = acc
    np.testing.assert_allclose(out[ADVANTAGES], adv, atol=1e-4)
    np.testing.assert_allclose(out[VALUE_TARGETS], adv + values, atol=1e-4)


def test_replay_buffer_ring():
    buf = ReplayBuffer(capacity=100, seed=0)
    for i in range(5):
        buf.add(SampleBatch({"x": np.full(30, i)}))
    assert len(buf) == 100
    s = buf.sample(64)
    assert s.count == 64
    assert set(np.unique(s["x"])).issubset({1, 2, 3, 4})  # 0s evicted


def test_prioritized_replay_updates():
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, seed=0)
    buf.add(SampleBatch({"x": np.arange(64, dtype=np.float32)}))
    s = buf.sample(16)
    assert "weights" in s
    buf.update_priorities(np.ones(16) * 5.0)
    s2 = buf.sample(32)
    assert s2.count == 32


def test_vector_env_autoreset():
    from ray_tpu_torch.rllib.env.vector_env import VectorEnv

    env = VectorEnv("CartPole-v1", 3, seed=0)
    total_done = 0
    for _ in range(300):
        _, _, dones, _ = env.step(np.zeros(3, dtype=np.int64))
        total_done += dones.sum()
    assert total_done > 0
    rewards, lens = env.pop_episode_stats()
    assert len(rewards) == total_done
    assert all(length > 0 for length in lens)
    env.close()


def test_offline_json_roundtrip(tmp_path):
    """JsonWriter/JsonReader roundtrip + return-to-go targets."""
    from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter

    w = JsonWriter(str(tmp_path))
    w.write(SampleBatch({
        "obs": np.arange(8, dtype=np.float32).reshape(4, 2),
        "actions": np.array([0, 1, 0, 1]),
        "rewards": np.array([1.0, 1.0, 1.0, 1.0], np.float32),
        "dones": np.array([False, True, False, True]),
    }))
    w.close()
    r = JsonReader(str(tmp_path), gamma=0.5)
    b = r.next()
    assert len(b) == 4
    # episode 1: returns [1 + .5, 1]; episode 2 same
    assert np.allclose(b[VALUE_TARGETS], [1.5, 1.0, 1.5, 1.0])
    mini = r.next(2)
    assert len(mini) == 2


def test_connectors_mean_std_filter():
    from ray_tpu_torch.rllib.connectors import ClipActions, ConnectorPipeline, FlattenObservations, MeanStdFilter

    rng = np.random.default_rng(0)
    data = rng.normal(loc=5.0, scale=3.0, size=(500, 4))
    f = MeanStdFilter()
    out = f(data)
    assert abs(float(np.mean(out))) < 0.2
    assert abs(float(np.std(out)) - 1.0) < 0.2
    st = f.get_state()
    f.transform(rng.normal(size=(100, 4)))
    assert f.get_state()["count"] == st["count"]
    f1, f2, fall = MeanStdFilter(), MeanStdFilter(), MeanStdFilter()
    a, b = data[:200], data[200:]
    f1(a)
    f2(b)
    fall(data)
    merged = MeanStdFilter()
    merged.merge_states([f1.get_state(), f2.get_state()])
    np.testing.assert_allclose(merged.get_state()["mean"], fall.get_state()["mean"], rtol=1e-9)
    np.testing.assert_allclose(merged.get_state()["m2"], fall.get_state()["m2"], rtol=1e-9)
    pipe = ConnectorPipeline([FlattenObservations(), MeanStdFilter()])
    assert pipe(rng.normal(size=(10, 2, 2))).shape == (10, 4)
    clip = ClipActions(low=-1.0, high=1.0)
    assert np.all(np.abs(clip(np.array([-5.0, 0.2, 9.0]))) <= 1.0)


@pytest.fixture
def fqe_from_jax(monkeypatch):
    """The port's FQE model starts from the JAX package's initial weights for
    the same seed (``fqe_params_from_jax``): the rest of the fit (the numpy
    minibatch draws, TD targets, optax's Adam) is then the same computation."""
    from ray_tpu.rllib.algorithms.sac.sac import _mlp_params as j_mlp_params
    from ray_tpu_torch.rllib.offline import estimators as te

    monkeypatch.setattr(te, "_mlp_params", lambda gen, din, hiddens, dout: te.fqe_params_from_jax(
        j_mlp_params(jax.random.PRNGKey(gen.initial_seed()), din, hiddens, dout)))


def test_offline_estimators_on_the_port(fqe_from_jax):
    """IS and WIS on logged data agree with the reference's exactly (numpy on
    both sides); DM and DR, their FQE models started from the same weights,
    within f32 summation order: v_target to rtol 1e-5 (read: ~2e-8), and the
    last fold's Q-values to rel_l2 1e-5 (read: ~1e-7)."""
    from ray_tpu.rllib.algorithms.sac.sac import _mlp_apply as j_mlp_apply
    from ray_tpu.rllib.offline import estimators as je
    from ray_tpu_torch.rllib.offline import estimators as te
    from ray_tpu_torch.rllib.policy.sample_batch import EPS_ID, NEXT_OBS

    rng = np.random.default_rng(0)
    n = 400
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    batch = SampleBatch({OBS: obs, NEXT_OBS: np.roll(obs, -1, 0), ACTIONS: rng.integers(0, 2, n),
                         REWARDS: rng.random(n).astype(np.float32), DONES: (np.arange(n) % 20 == 19),
                         EPS_ID: np.arange(n) // 20, te.ACTION_PROB: np.full(n, 0.5, np.float32)})

    def probs(o):
        p1 = 1.0 / (1.0 + np.exp(-np.asarray(o)[:, 0]))
        return np.stack([1 - p1, p1], -1)

    pol = te.AlgorithmPolicyAdapter(probs)
    for name in ("ImportanceSampling", "WeightedImportanceSampling"):
        assert getattr(te, name)(pol, 0.9).estimate(batch) == getattr(je, name)(pol, 0.9).estimate(batch)
    for name in ("DirectMethod", "DoublyRobust"):
        port = getattr(te, name)(pol, 0.9, fqe_iterations=200, device="cpu")
        ref = getattr(je, name)(pol, 0.9, fqe_iterations=200)
        got, want = port.estimate(batch)["v_target"], ref.estimate(batch)["v_target"]
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        q, q_ref = port.model._q(obs), np.asarray(j_mlp_apply(ref.model.params, obs))
        assert np.linalg.norm(q - q_ref) / np.linalg.norm(q_ref) < 1e-5, name


def _ope_logged_data(n_episodes, seed):
    """tests/test_rllib_ope.py's one-step episodes: obs ~ {0,1}; action 1 pays
    obs + 1, action 0 pays 0.5; the behaviour policy is uniform. The target
    policy (always action 1) is worth E[obs + 1] = 1.5; the behaviour 1.0."""
    from ray_tpu_torch.rllib.offline.estimators import ACTION_PROB
    from ray_tpu_torch.rllib.policy.sample_batch import EPS_ID, NEXT_OBS

    rng = np.random.default_rng(seed)
    rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS, EPS_ID, ACTION_PROB)}
    for ep in range(n_episodes):
        o = float(rng.integers(0, 2))
        a = int(rng.integers(0, 2))
        rows[OBS].append([o])
        rows[ACTIONS].append(a)
        rows[REWARDS].append(np.float32((o + 1.0) if a == 1 else 0.5))
        rows[DONES].append(np.float32(1.0))
        rows[NEXT_OBS].append([o])
        rows[EPS_ID].append(ep)
        rows[ACTION_PROB].append(np.float32(0.5))
    return SampleBatch({k: np.asarray(v) for k, v in rows.items()})


@pytest.mark.parametrize("name", ["ImportanceSampling", "WeightedImportanceSampling", "DirectMethod",
                                  "DoublyRobust"])
def test_ope_recovers_target_value(name):
    """tests/test_rllib_ope.py's known-answer cases on the port, its FQE model
    from the port's own initial draws: each estimator within the reference's
    bars of the target policy's value 1.5 (IS and WIS 0.1 on 4,000 episodes,
    DM and DR 0.15 on 2,000 with 400 FQE iterations); IS's behaviour value
    within 0.05 of 1.0."""
    from ray_tpu_torch.rllib.offline import estimators as te

    policy = te.AlgorithmPolicyAdapter(lambda obs: np.tile(np.array([[0.0, 1.0]], np.float32), (len(obs), 1)))
    if name in ("ImportanceSampling", "WeightedImportanceSampling"):
        est = getattr(te, name)(policy, gamma=1.0).estimate(_ope_logged_data(4000, 0))
        bar = 0.1
        if name == "ImportanceSampling":
            assert abs(est["v_behavior"] - 1.0) < 0.05, est
    else:
        est = getattr(te, name)(policy, gamma=1.0, fqe_iterations=400, device="cpu").estimate(
            _ope_logged_data(2000, 1))
        bar = 0.15
    assert abs(est["v_target"] - 1.5) < bar, est


def test_ope_multi_step_episodes_split_on_dones():
    """tests/test_rllib_ope.py:77 on the port: without EPS_ID, episodes split
    on DONES; a target policy equal to the behaviour is worth its value, 3."""
    from ray_tpu_torch.rllib.offline import estimators as te
    from ray_tpu_torch.rllib.policy.sample_batch import NEXT_OBS

    rng = np.random.default_rng(2)
    n = 300
    batch = SampleBatch({
        OBS: rng.normal(size=(n, 1)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, n),
        REWARDS: np.ones(n, np.float32),
        DONES: np.asarray([1.0 if (i % 3) == 2 else 0.0 for i in range(n)], np.float32),
        NEXT_OBS: rng.normal(size=(n, 1)).astype(np.float32),
        te.ACTION_PROB: np.full(n, 0.5, np.float32),
    })
    policy = te.AlgorithmPolicyAdapter(lambda obs: np.full((len(obs), 2), 0.5, np.float32))
    est = te.WeightedImportanceSampling(policy, gamma=1.0).estimate(batch)
    assert est["num_episodes"] == 100
    assert abs(est["v_target"] - 3.0) < 1e-6


# -- tests/test_rllib_policy.py on the port ----------------------------------------


@pytest.fixture(scope="module")
def spaces():
    return Box(low=-1.0, high=1.0, shape=(4,), dtype=np.float32), Discrete(3)


@pytest.fixture(scope="module")
def cont_spaces():
    return (Box(low=-1.0, high=1.0, shape=(6,), dtype=np.float32),
            Box(low=-2.0, high=2.0, shape=(2,), dtype=np.float32))


def test_compute_actions_shapes_and_fetches(spaces):
    policy = Policy.from_spaces(*spaces, device="cpu")
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    actions, state, info = policy.compute_actions(obs)
    assert actions.shape == (16,)
    assert state == []
    assert info["action_logp"].shape == (16,)
    assert info["vf_preds"].shape == (16,)
    assert np.all(actions >= 0) and np.all(actions < 3)


def test_single_action_greedy_deterministic_exploring_varies(spaces):
    policy = Policy.from_spaces(*spaces, device="cpu")
    obs = np.ones(4, np.float32)
    greedy = {policy.compute_single_action(obs, explore=False)[0] for _ in range(5)}
    assert len(greedy) == 1
    explored = {policy.compute_single_action(obs, explore=True)[0] for _ in range(30)}
    assert len(explored) > 1


def test_log_likelihoods_match_action_fetches(spaces):
    policy = Policy.from_spaces(*spaces, device="cpu")
    obs = np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32)
    actions, _, info = policy.compute_actions(obs, explore=True)
    logp = policy.compute_log_likelihoods(actions, obs)
    np.testing.assert_allclose(logp, info["action_logp"], rtol=1e-5, atol=1e-5)


def test_continuous_actions_and_logp(cont_spaces):
    policy = Policy.from_spaces(*cont_spaces, device="cpu")
    obs = np.random.default_rng(2).normal(size=(8, 6)).astype(np.float32)
    actions, _, info = policy.compute_actions(obs, explore=True)
    assert actions.shape == (8, 2)
    logp = policy.compute_log_likelihoods(actions, obs)
    np.testing.assert_allclose(logp, info["action_logp"], rtol=1e-4, atol=1e-4)
    a, _, one_info = policy.compute_single_action(obs[0], explore=False)
    assert a.shape == (2,)
    assert np.isfinite(one_info["vf_preds"])


def test_postprocess_trajectory_gae(spaces):
    policy = Policy.from_spaces(*spaces, device="cpu")
    rng = np.random.default_rng(3)
    n = 40
    batch = SampleBatch({
        REWARDS: rng.normal(size=n).astype(np.float32),
        DONES: (rng.random(n) < 0.1).astype(np.float32),
        VF_PREDS: rng.normal(size=n).astype(np.float32),
    })
    out = policy.postprocess_trajectory(batch, last_value=0.5)
    assert np.isfinite(out[ADVANTAGES]).all()
    np.testing.assert_allclose(out[VALUE_TARGETS], out[ADVANTAGES] + out[VF_PREDS], rtol=1e-5)


def test_weights_roundtrip_and_checkpoint(tmp_path, spaces):
    policy = Policy.from_spaces(*spaces, device="cpu")
    obs = np.random.default_rng(4).normal(size=(4, 4)).astype(np.float32)
    ref_actions, _, ref_info = policy.compute_actions(obs, explore=False)
    orig = policy.get_weights()
    policy.set_weights(trm.tree_map(lambda x: x + 0.5, orig))
    _, _, bump_info = policy.compute_actions(obs, explore=False)
    assert not np.allclose(bump_info["vf_preds"], ref_info["vf_preds"])
    policy.set_weights(orig)
    path = str(tmp_path / "ckpt")
    policy.export_checkpoint(path)
    restored = Policy.from_checkpoint(path, device="cpu")
    got_actions, _, got_info = restored.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(got_actions, ref_actions)
    np.testing.assert_allclose(got_info["vf_preds"], ref_info["vf_preds"], rtol=1e-6)


def test_policy_applies_observation_filter(tmp_path, spaces):
    from ray_tpu_torch.rllib.connectors import MeanStdFilter

    f = MeanStdFilter()
    rng = np.random.default_rng(5)
    f(rng.normal(loc=100.0, scale=3.0, size=(256, 4)))
    policy = Policy.from_spaces(*spaces, device="cpu")
    obs = rng.normal(loc=100.0, scale=3.0, size=(8, 4)).astype(np.float32)
    _, _, raw_info = policy.compute_actions(obs, explore=False)
    policy._obs_filter_state = f.get_state()
    _, _, filt_info = policy.compute_actions(obs, explore=False)
    assert not np.allclose(filt_info["vf_preds"], raw_info["vf_preds"])
    byhand = np.asarray(f.transform(obs), np.float32)
    _, _, ref_info = Policy(policy.spec, policy.params, device="cpu").compute_actions(byhand, explore=False)
    np.testing.assert_allclose(filt_info["vf_preds"], ref_info["vf_preds"], rtol=1e-5)
    path = str(tmp_path / "fckpt")
    policy.export_checkpoint(path)
    restored = Policy.from_checkpoint(path, device="cpu")
    _, _, rest_info = restored.compute_actions(obs, explore=False)
    np.testing.assert_allclose(rest_info["vf_preds"], filt_info["vf_preds"], rtol=1e-6)


# -- what is not ported raises, naming its ROADMAP item ----------------------------


def test_unported_paths_raise_naming_their_roadmap_item():
    from ray_tpu_torch.rllib import PPOConfig

    spec = trm.RLModuleSpec(**SPECS["mlp-discrete"])
    with pytest.raises(NotImplementedError, match="ROADMAP 5b"):
        tl.LearnerGroup(spec, ppo_loss, num_learners=2, num_gpus_per_learner=1, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP 5b"):
        tl.LearnerGroup(spec, ppo_loss, num_learners=2, num_gpus_per_learner=1, grad_sync="device_allreduce",
                        device="cuda")
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        tl.LearnerGroup(spec, ppo_loss, num_learners=1, device="cuda")
    # A learner mesh over more than one rank of a process group (A9f); on one
    # rank it is the same update.
    import torch.distributed as dist

    assert tl.Learner(spec, ppo_loss, use_mesh=True, device="cpu").module.device.type == "cpu"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda group=None: 2)
        with pytest.raises(NotImplementedError, match="ROADMAP A9f"):
            tl.Learner(spec, ppo_loss, use_mesh=True, device="cpu")
    with pytest.raises(ValueError, match="grad_sync"):
        tl.LearnerGroup(spec, ppo_loss, grad_sync="nccl", device="cpu")
    with pytest.raises(ValueError, match="never NCCL"):
        PPOConfig().training(weight_sync="device_broadcast", weight_sync_backend="nccl")
    with pytest.raises(ValueError, match="runs on torch"):
        PPOConfig().framework("jax")
