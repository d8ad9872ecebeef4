"""The port's RLlib algorithms learn, on the CPU, where the JAX package's own
tests assert a reward, with the reference's bars and data.

- ``test_ppo_learns_cartpole`` and ``test_ppo_checkpoint_restore``
  (``tests/test_rllib.py``): PPO on the port's CartPole-v1, two rollout
  worker actors, the learner in this process (``device="cpu"``).
- ``test_appo_learns_cartpole`` (``tests/test_rllib_algorithms.py``).
- ``test_dt_imitates_expert_cartpole`` (``tests/test_rllib_algorithms.py``):
  the Decision Transformer on scripted-expert data written with the port's
  ``JsonWriter``; its attention is the flash kernels' plain version here.
- ``test_algorithm_get_policy_end_to_end`` (``tests/test_rllib_policy.py``).
- A learner actor holding the fake GPU of ``init(num_gpus=1)`` computes on
  the CPU what the in-process learner does (within f32 rounding); two gloo
  learners allreduce their gradients and stay equal.
- Worker fault tolerance (``tests/test_rllib.py``): a killed rollout worker
  is replaced.

Rollouts sample with the port's own torch generators, so episodes differ from
the reference's draw for draw (ROADMAP C12); the bars are the reference's.
One port cluster for the module; ~70 s here.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.core import rl_module as trm


@pytest.fixture(scope="module")
def cluster():
    # The learners here run on the CPU in this process: their matmuls are a
    # few hundred rows, and torch's intra-op thread pool beside the rollout
    # workers' processes made some updates ~15x slower. One thread for the
    # module, restored after.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rt.init(num_cpus=6, num_gpus=1, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()
    torch.set_num_threads(threads)


def test_ppo_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, num_envs_per_worker=4)
        .training(lr=3e-4, train_batch_size=2048, sgd_minibatch_size=256, num_sgd_iter=8, entropy_coeff=0.01)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    best = 0.0
    try:
        for _ in range(20):
            r = algo.step()
            best = max(best, r["episode_reward_mean"])
            if best >= 120:
                break
        assert best >= 120, f"PPO failed to learn CartPole (best={best})"
        a = algo.compute_single_action(np.zeros(4, np.float32))
        assert a in (0, 1)
    finally:
        algo.cleanup()


def test_ppo_checkpoint_restore(cluster):
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=1, num_envs_per_worker=2)
        .training(train_batch_size=256, sgd_minibatch_size=64, num_sgd_iter=2)
        .resources(device="cpu")
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    algo.step()
    ckpt = algo.save_checkpoint()
    w_before = algo.get_policy_weights()
    algo.step()  # weights move on
    assert not np.array_equal(trm.tree_leaves(algo.get_policy_weights())[0], trm.tree_leaves(w_before)[0])
    algo.load_checkpoint(ckpt)
    w_after = algo.get_policy_weights()
    flat_b = np.concatenate([np.ravel(x) for x in trm.tree_leaves(w_before)])
    flat_a = np.concatenate([np.ravel(x) for x in trm.tree_leaves(w_after)])
    np.testing.assert_allclose(flat_b, flat_a)
    algo.cleanup()


def test_appo_learns_cartpole(cluster):
    from ray_tpu_torch.rllib import APPOConfig

    cfg = (
        APPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=2, num_envs_per_worker=4)
        .training(lr=1e-3, train_batch_size=2048, entropy_coeff=0.01, num_sgd_iter=2, kl_coeff=0.0)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    best = 0.0
    try:
        for _ in range(40):
            r = algo.step()
            best = max(best, r["episode_reward_mean"])
            if best >= 100:
                break
        assert best >= 100, f"APPO failed to learn CartPole (best={best})"
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.cleanup()


def write_expert_data(path: str, episodes: int = 25) -> None:
    """The reference test's scripted-expert CartPole data (a PD controller,
    ~200 reward an episode), through the port's env and JsonWriter."""
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

    env = make("CartPole-v1")
    writer = JsonWriter(path)
    rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
    for ep in range(episodes):
        obs, _ = env.reset(seed=ep)
        for _ in range(200):
            a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0  # PD controller, ~200 reward
            nobs, r, term, trunc, _ = env.step(a)
            rows[OBS].append(np.asarray(obs, np.float32))
            rows[ACTIONS].append(np.int64(a))
            rows[REWARDS].append(np.float32(r))
            rows[DONES].append(np.float32(term or trunc))
            obs = nobs
            rows[NEXT_OBS].append(np.asarray(obs, np.float32))
            if term or trunc:
                break
        rows[DONES][-1] = np.float32(1.0)  # close the final episode
    writer.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    writer.close()
    env.close()


def test_dt_imitates_expert_cartpole(cluster, tmp_path):
    """Decision Transformer: offline sequence modeling on scripted-expert
    CartPole data; conditioned on the dataset's best return it should act
    near-expert (random play scores ~22)."""
    from ray_tpu_torch.rllib import DTConfig

    write_expert_data(str(tmp_path / "dt_data"))
    cfg = (
        DTConfig()
        .environment("CartPole-v1")
        .training(lr=1e-3, train_batch_size=64, context_length=20, updates_per_iter=150, eval_episodes=3,
                  max_ep_len=200)
        .resources(device="cpu")
        .debugging(seed=0)
        .offline_data(str(tmp_path / "dt_data"))
    )
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(4):
            r = algo.step()
            best = max(best, r["episode_reward_mean"])
            if best >= 120:
                break
        assert best >= 120, f"DT failed to imitate the expert (best={best})"
        with pytest.raises(NotImplementedError, match="return conditioning"):
            algo.compute_single_action(np.zeros(4, np.float32))
    finally:
        algo.cleanup()


def test_algorithm_get_policy_end_to_end(cluster):
    """algo.get_policy() hands back a Policy whose greedy actions match
    Algorithm.compute_single_action."""
    from ray_tpu_torch.rllib import PPOConfig

    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=1, num_envs_per_worker=2)
        .training(train_batch_size=400, num_sgd_iter=2)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    algo.setup(cfg.to_dict())
    try:
        algo.step()
        policy = algo.get_policy()
        for obs in (np.zeros(4, np.float32), np.ones(4, np.float32)):
            a_algo = algo.compute_single_action(obs, explore=False)
            a_pol, _, _ = policy.compute_single_action(obs, explore=False)
            assert a_algo == a_pol
        assert policy.config["gamma"] == pytest.approx(cfg.gamma)
    finally:
        algo.cleanup()


def test_learner_actors(cluster):
    """One learner actor holding the (fake) GPU resource equals the
    in-process learner update for update; two gloo learners allreduce their
    gradients and hold equal weights after every update."""
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
    from ray_tpu_torch.rllib.policy.sample_batch import (
        ACTIONS, ADVANTAGES, LOGPS, OBS, VALUE_TARGETS, VF_PREDS, SampleBatch,
    )

    spec = trm.RLModuleSpec(obs_dim=4, action_dim=2, discrete=True)
    rng = np.random.default_rng(0)
    n = 128
    batch = SampleBatch({OBS: rng.normal(size=(n, 4)).astype(np.float32), ACTIONS: rng.integers(0, 2, n),
                         LOGPS: np.full(n, -0.69, np.float32), VF_PREDS: rng.normal(size=n).astype(np.float32),
                         ADVANTAGES: rng.normal(size=n).astype(np.float32),
                         VALUE_TARGETS: rng.normal(size=n).astype(np.float32)})
    cfg = dict(clip_param=0.2, vf_clip_param=10.0, vf_loss_coeff=0.5, entropy_coeff=0.01)
    local = Learner(spec, ppo_loss, 3e-4, 0.5, 0, device="cpu")
    one = LearnerGroup(spec, ppo_loss, lr=3e-4, grad_clip=0.5, num_learners=1, num_gpus_per_learner=1, device="cpu")
    two = LearnerGroup(spec, ppo_loss, lr=3e-4, grad_clip=0.5, num_learners=2, device="cpu")
    try:
        info = one.device_info()
        assert info[0]["device"] == "cpu" and info[0]["pid"] != local_pid()
        # The same program on the same device, in two processes whose torch
        # thread pools may sum in another order: equal within f32 rounding.
        for _ in range(2):
            want = local.update(batch, cfg)
            got = one.update(batch, cfg)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
            m = two.update(batch, cfg)
            assert np.isfinite(m["total_loss"])
        for a, b in zip(trm.tree_leaves(one.get_weights()), trm.tree_leaves(local.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        w0, w1 = rt.get([a.get_weights.remote() for a in two._actors])
        for a, b in zip(trm.tree_leaves(w0), trm.tree_leaves(w1)):
            np.testing.assert_array_equal(a, b)
    finally:
        one.stop()
        two.stop()


def local_pid() -> int:
    import os

    return os.getpid()


def test_rollout_worker_fault_tolerance(cluster):
    import time

    from ray_tpu_torch.rllib.algorithms.ppo.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import Learner
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.evaluation.rollout_worker import WorkerSet

    probe = make("CartPole-v1")
    spec = trm.RLModuleSpec.from_spaces(probe.observation_space, probe.action_space)
    ws = WorkerSet("CartPole-v1", spec, num_workers=2, num_envs_per_worker=1)
    learner = Learner(spec, ppo_loss, device="cpu")
    ws.sync_weights(learner.get_weights())
    batches = ws.sample(16)
    assert len(batches) == 2
    rt.kill(ws._workers[0])
    saw_degraded = False
    for _ in range(20):
        batches = ws.sample(8)
        assert len(batches) >= 1
        if len(batches) < 2:
            saw_degraded = True
            break
        time.sleep(0.2)
    assert saw_degraded, "kill never landed"
    ws.sync_weights(learner.get_weights())
    batches = ws.sample(8)
    assert len(batches) == 2
    ws.stop()
