"""The port's policy-gradient families on the CPU, held to ``ray_tpu.rllib``:
PG, A2C, A3C and DD-PPO.

- ``pg_loss`` and ``a2c_loss``: the loss, its metrics and gradients from the
  same weights on the same GAE-postprocessed batch, then two learner updates
  (the clip active) against the JAX learner's.
- A3C: a worker's A2C gradient on its fragment (the port's ``_A3CWorker``
  against the reference's, both built in this process) and the driver's
  apply step (``Learner.apply_gradients`` against optax's clip + adam on the
  same gradients, three steps).
- DD-PPO: two workers in lockstep over a gloo group, their weight digests
  and weights bit-equal after each round.
- A2C learning CartPole at ``tests/test_rllib_algorithms.py``'s bar; PG, A2C
  with microbatches and A3C running an iteration with finite losses, A3C's
  checkpoint round trip.

Rollouts sample with the port's own torch generators (ROADMAP C12), so the
algorithms are held to the reference on a shared batch, not on a trajectory.
Tolerances (f32 on the CPU, both sides): losses and metrics rtol 1e-5 (1e-4
after a learner update), gradients rtol 1e-4 / atol 1e-6, weights rtol 1e-5 /
atol 1e-6. One port cluster for the module (lazily booted), torch pinned to
one thread; ~35 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.algorithms.a2c.a2c import a2c_loss as j_a2c_loss
from ray_tpu.rllib.algorithms.pg.pg import pg_loss as j_pg_loss
from ray_tpu.rllib.core import learner as jl
from ray_tpu.rllib.core import rl_module as jrm
from ray_tpu_torch.rllib.algorithms.a2c.a2c import a2c_loss
from ray_tpu_torch.rllib.algorithms.pg.pg import pg_loss
from ray_tpu_torch.rllib.core import learner as tl
from ray_tpu_torch.rllib.core import rl_module as trm
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
METRICS = dict(rtol=1e-4, atol=1e-6)
SPEC = dict(obs_dim=4, action_dim=2, discrete=True)


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


def _batch(jspec, params, n, seed, lambda_):
    """A rollout-shaped batch: actions sampled from the reference module,
    GAE (``lambda_``) over four fragments."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, jspec.obs_dim)).astype(np.float32)
    actions, logp, values = jrm.sample_actions(params, jnp.asarray(obs), jax.random.PRNGKey(seed), jspec, True)
    parts = []
    for idx in np.array_split(np.arange(n), 4):
        frag = SampleBatch({OBS: obs[idx], ACTIONS: np.asarray(actions)[idx],
                            REWARDS: rng.normal(1.0, 0.5, len(idx)).astype(np.float32),
                            DONES: rng.random(len(idx)) < 0.05, LOGPS: np.asarray(logp)[idx],
                            VF_PREDS: np.asarray(values)[idx]})
        parts.append(compute_gae(frag, float(rng.normal()), 0.99, lambda_))
    return SampleBatch.concat_samples(parts)


def _grad_tree(learner, grads):
    """The learner's gradients (in parameter order) as the params tree."""
    by_id = dict(zip([id(p) for p in learner.opt.params], grads))
    return trm.tree_map(lambda p: by_id[id(p)], learner.module.param_tree())


LOSSES = {  # name: (port loss, reference loss, lambda_, loss_cfg, grad_clip: active on the test batch)
    "pg": (pg_loss, j_pg_loss, 1.0, {"entropy_coeff": 0.01}, 0.1),
    "a2c": (a2c_loss, j_a2c_loss, 0.95, {"vf_loss_coeff": 0.5, "entropy_coeff": 0.01}, 0.5),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_grads_and_updates_match_reference(name):
    loss, jloss, lambda_, cfg, clip = LOSSES[name]
    jspec, tspec = jrm.RLModuleSpec(**SPEC), trm.RLModuleSpec(**SPEC)
    ref = jl.Learner(jspec, jloss, lr=4e-3, grad_clip=clip, seed=2)
    ours = tl.Learner(tspec, loss, lr=4e-3, grad_clip=clip, seed=9, device="cpu")
    ours.set_weights(ref.get_weights())
    batch = _batch(jspec, ref.params, 256, 3, lambda_)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jval, jm), jgrads = jax.value_and_grad(lambda p: jloss(p, jb, jspec, cfg), has_aux=True)(ref.params)
    tval, tm, tgrads = ours.compute_grads(batch, cfg)
    np.testing.assert_allclose(_np(tval), _np(jval), **F32)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), **F32, err_msg=k)
    for got, want in zip(trm.tree_leaves(_grad_tree(ours, tgrads)), jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(_np(got), _np(want), **GRADS)
    for step in range(2):
        jmet, tmet = ref.update(batch, cfg), ours.update(batch, cfg)
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            np.testing.assert_allclose(tmet[k], jmet[k], **METRICS, err_msg=f"step {step} {k}")
        if step == 0:
            assert jmet["grad_norm"] > clip, "the clip should be active on this batch"
        for got, want in zip(trm.tree_leaves(ours.get_weights()), jax.tree_util.tree_leaves(ref.get_weights())):
            np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_a3c_worker_gradient_and_apply_step_match_reference():
    """A3C's two halves on the same fragment and weights: the worker's A2C
    gradient, and the driver's optimizer step applying it (tests/
    test_rllib_new_families.py's lr and grad_clip, the clip active)."""
    from ray_tpu.rllib.algorithms.a3c.a3c import _A3CWorker as JWorker
    from ray_tpu_torch.rllib.algorithms.a3c.a3c import _A3CWorker as TWorker

    jspec, tspec = jrm.RLModuleSpec(**SPEC), trm.RLModuleSpec(**SPEC)
    loss_cfg = {"vf_loss_coeff": 0.5, "entropy_coeff": 0.005}
    params = jrm.init_params(jax.random.PRNGKey(5), jspec)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    ref = JWorker("CartPole-v1", jspec, 0, 2, loss_cfg=loss_cfg)
    ours = TWorker("CartPole-v1", tspec, 0, 2, loss_cfg=loss_cfg)
    ref.set_weights(np_params)
    ours.set_weights(np_params)
    driver = tl.Learner(tspec, a2c_loss, lr=2e-3, grad_clip=1.0, seed=0, device="cpu")
    driver.set_weights(np_params)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(2e-3))
    opt_state = tx.init(params)
    for step in range(3):
        batch = _batch(jspec, params, 64, 10 + step, 0.95)
        jgrads, jm = ref._grads_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
        tgrads, tm = ours.compute_grads(batch)
        for k in jm:
            np.testing.assert_allclose(tm[k], float(jm[k]), **F32, err_msg=f"step {step} {k}")
        for got, want in zip(trm.tree_leaves(tgrads), jax.tree_util.tree_leaves(jgrads)):
            np.testing.assert_allclose(got, _np(want), **GRADS)
        if step == 0:
            assert float(optax.global_norm(jgrads)) > 1.0, "the clip should be active"
        # The driver applies the reference's gradient on both sides.
        updates, opt_state = tx.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        driver.apply_gradients(jax.tree_util.tree_map(np.asarray, jgrads))
        for got, want in zip(trm.tree_leaves(driver.get_weights()), jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(got, _np(want), **F32)
        ref.set_weights(jax.tree_util.tree_map(np.asarray, params))
        ours.set_weights(driver.get_weights())
    ours.stop()
    ref.stop()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def test_ddppo_workers_stay_in_lockstep(cluster):
    """Two DD-PPO workers, each sampling and learning on its own, allreduce
    every minibatch's gradients over a gloo group: their weights stay
    bit-equal round after round (the digest training_step checks, and the
    full checksums)."""
    from ray_tpu_torch.rllib import DDPPOConfig
    from ray_tpu_torch.rllib.core.learner import weights_checksum

    cfg = (DDPPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2, num_envs_per_worker=2, rollout_fragment_length=32)
           .training(lr=1e-3, entropy_coeff=0.005, num_sgd_iter=2, sgd_minibatch_size=32)
           .resources(device="cpu").debugging(seed=0))
    assert cfg.collective_backend == "gloo"
    algo = cfg.build()
    try:
        before = weights_checksum(algo.get_policy_weights())
        for _ in range(2):
            r = algo.step()
            assert np.isfinite(r["total_loss"]) and r["num_env_steps_sampled_this_iter"] == 128
            digests = rt.get([w.weights_digest.remote() for w in algo.workers])
            assert digests[0] == digests[1], digests
            sums = [weights_checksum(w) for w in rt.get([w.get_weights.remote() for w in algo.workers])]
            assert sums[0] == sums[1]
        assert sums[0] != before  # the rounds moved the weights
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.cleanup()


def test_a2c_learns_cartpole(cluster):
    """tests/test_rllib_algorithms.py's case: its config, bar and budget."""
    from ray_tpu_torch.rllib import A2CConfig

    cfg = (
        A2CConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, num_envs_per_worker=8)
        .training(lr=2e-3, train_batch_size=2000, entropy_coeff=0.005, grad_clip=1.0)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(40):
            r = algo.step()
            best = max(best, r["episode_reward_mean"])
            if best >= 100:
                break
        assert best >= 100, f"A2C failed to improve on CartPole (best={best})"
    finally:
        algo.cleanup()


@pytest.mark.parametrize("algo_name", ["PG", "A2C-microbatch", "A3C"])
def test_iteration_runs_with_finite_loss(cluster, algo_name):
    import ray_tpu_torch.rllib as trl

    name, _, micro = algo_name.partition("-")
    cfg = (getattr(trl, f"{name}Config")().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2, num_envs_per_worker=2)
           .resources(device="cpu").debugging(seed=0))
    if name == "A3C":
        cfg.training(grads_per_step=4).rollouts(rollout_fragment_length=20)
    else:
        cfg.training(train_batch_size=200, **({"microbatch_size": 50} if micro else {}))
    algo = cfg.build()
    try:
        r = algo.step()
        assert np.isfinite(r["total_loss"]), r
        assert r["timesteps_total"] > 0
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
        if name == "A3C":
            ckpt = algo.save_checkpoint()
            algo.step()
            algo.load_checkpoint(ckpt)
            for a, b in zip(trm.tree_leaves(algo.get_policy_weights()), trm.tree_leaves(ckpt.to_dict()["weights"])):
                np.testing.assert_array_equal(a, b)
    finally:
        algo.cleanup()
