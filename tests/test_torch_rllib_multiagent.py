"""The port's multi-agent env, MADDPG and Ape-X DDPG on the CPU, held to
``ray_tpu.rllib``.

- ``MultiAgentEnv``/``make_multi_agent`` and ``make_vector_env``'s detection
  (by class, as the reference's): the same slots, observations, rewards and
  ends.
- MADDPG: one update from the reference's stacked weights (the loss, the
  gradients, each subtree clipped by its own global norm on a batch where
  only the critic's exceeds 0.5, the Adam steps at their two learning rates,
  the targets), its first 200 env steps from the reference's weights
  (numpy noise on both sides), learning the cooperative spread at the
  reference test's bar, and the checkpoint round trip.
- Ape-X DDPG: the per-worker sigma ladder and one explorer fragment from the
  reference's weights and seed (no cluster); two learner steps from the
  reference's weights through a shard (importance weights uniform, then
  not), held to the reference's jitted step, the priorities sent back
  included; then the reference's smoke test with the explorers' weights
  bit-equal to the learner's after a sync. The learner-step and smoke cases
  share the file's one port cluster.

Tolerances (f32 on the CPU, both sides): losses rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6, weights after the update rtol 1e-5 /
atol 1e-6, env trajectories rtol 1e-5 / atol 1e-5 (policy forwards in
either package's f32 order feed the env).
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib.env.multi_agent_env import MultiAgentEnv as JMultiAgentEnv
from ray_tpu_torch.rllib.algorithms.maddpg import maddpg as tmaddpg
from ray_tpu_torch.rllib.core.rl_module import copy_into, tree_leaves
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv as TMultiAgentEnv
from torch_rllib_reference import reference_grads

F32 = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
TRAJ = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spread(base, box):
    """tests/test_rllib_r2d2_maddpg.py's Spread1D on ``base`` (either
    package's MultiAgentEnv) with ``box`` spaces: two agents on a line must
    cover goals at -0.5/+0.5 without colliding; the shared min-assignment
    reward makes it cooperative."""

    class Spread1D(base):
        possible_agents = ["agent_0", "agent_1"]

        def __init__(self, config=None):
            self._obs_space = box(-2, 2, (4,), np.float32)
            self._act_space = box(-1, 1, (1,), np.float32)
            self.goals = np.array([-0.5, 0.5], np.float32)
            self.t = 0
            self._rng = np.random.default_rng(0)

        @property
        def observation_space(self):
            return self._obs_space

        @property
        def action_space(self):
            return self._act_space

        def reset(self, *, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self.pos = self._rng.uniform(-1, 1, 2).astype(np.float32)
            self.t = 0
            return self._obs(), {}

        def _obs(self):
            return {
                "agent_0": np.array([self.pos[0], self.pos[1], *self.goals], np.float32),
                "agent_1": np.array([self.pos[1], self.pos[0], *self.goals], np.float32),
            }

        def step(self, actions):
            self.pos[0] = np.clip(self.pos[0] + 0.1 * float(actions["agent_0"][0]), -2, 2)
            self.pos[1] = np.clip(self.pos[1] + 0.1 * float(actions["agent_1"][0]), -2, 2)
            self.t += 1
            d1 = abs(self.pos[0] - self.goals[0]) + abs(self.pos[1] - self.goals[1])
            d2 = abs(self.pos[0] - self.goals[1]) + abs(self.pos[1] - self.goals[0])
            r = -min(d1, d2)
            if abs(self.pos[0] - self.pos[1]) < 0.1:
                r -= 1.0
            done = self.t >= 25
            return (
                self._obs(),
                {"agent_0": r / 2, "agent_1": r / 2},
                {"__all__": done},
                {"__all__": False},
                {},
            )

    return Spread1D


JSpread = _spread(JMultiAgentEnv, gym.spaces.Box)
TSpread = _spread(TMultiAgentEnv, Box)


# -- the multi-agent env -------------------------------------------------------------------


def test_make_multi_agent_and_vector_env_match_reference():
    """make_multi_agent("CartPole-v1") (independent copies, each auto-resets)
    through make_vector_env: slot-flattened stepping, the same observations,
    rewards, ends and episode stats as the reference's."""
    from ray_tpu.rllib.env.multi_agent_env import make_multi_agent as jmake
    from ray_tpu.rllib.env.vector_env import make_vector_env as jvec
    from ray_tpu_torch.rllib.env.multi_agent_env import make_multi_agent as tmake
    from ray_tpu_torch.rllib.env.vector_env import MultiAgentVectorEnv, make_vector_env as tvec

    ours = tvec(tmake("CartPole-v1", 3), 2, {}, 0, seed=4)
    ref = jvec(jmake("CartPole-v1", 3), 2, {}, 0, seed=4)
    assert isinstance(ours, MultiAgentVectorEnv) and ours.num_envs == ref.num_envs == 6
    assert ours.agents == ref.agents == ["agent_0", "agent_1", "agent_2"]
    np.testing.assert_array_equal(ours.current_obs(), ref.current_obs())
    rng = np.random.default_rng(0)
    for _ in range(120):
        a = rng.integers(0, 2, 6)
        (o1, r1, d1, i1), (o2, r2, d2, i2) = ours.step(a), ref.step(a)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        for x, y in zip(i1, i2):
            assert x["terminated"] == y["terminated"] and x["truncated"] == y["truncated"]
            if "final_observation" in y:
                np.testing.assert_array_equal(x["final_observation"], y["final_observation"])
        np.testing.assert_array_equal(ours.eps_ids(), ref.eps_ids())
    assert ours.pop_episode_stats() == ref.pop_episode_stats()
    # A config's num_agents, and the per-agent reset seeds.
    env, jenv = tmake("CartPole-v1")({"num_agents": 2}), jmake("CartPole-v1")({"num_agents": 2})
    (o1, _), (o2, _) = env.reset(seed=9), jenv.reset(seed=9)
    assert list(o1) == list(o2) == ["agent_0", "agent_1"]
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])


def test_make_vector_env_detects_a_multi_agent_env_by_class():
    """As the reference: a MultiAgentEnv subclass is slot-flattened; an env
    that merely lists possible_agents is a plain single-agent env."""
    from ray_tpu.rllib.env.vector_env import make_vector_env as jvec
    from ray_tpu_torch.rllib.env.vector_env import MultiAgentVectorEnv, VectorEnv, make_vector_env as tvec

    class Listed:
        possible_agents = ["a", "b"]
        observation_space = Box(-1.0, 1.0, (2,))
        action_space = Box(-1.0, 1.0, (1,))

        def __init__(self, config=None):
            pass

        def reset(self, *, seed=None):
            return np.zeros(2, np.float32), {}

        def step(self, action):
            return np.zeros(2, np.float32), 0.0, False, False, {}

        def close(self):
            pass

    assert type(tvec(Listed, 1)) is VectorEnv and type(jvec(Listed, 1)).__name__ == "VectorEnv"
    assert isinstance(tvec(TSpread, 1), MultiAgentVectorEnv)
    assert type(jvec(JSpread, 1)).__name__ == "MultiAgentVectorEnv"


# -- MADDPG -----------------------------------------------------------------------------------


def _maddpg_pair(**training):
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    ref = jrl.MADDPGConfig().environment(JSpread).training(**training).debugging(seed=0).build()
    ours = trl.MADDPGConfig().environment(TSpread).training(**training).resources(device="cpu").debugging(seed=0).build()
    copy_into(ours.params, tmaddpg.maddpg_params_from_jax(_host(ref.params), device="cpu"))
    copy_into(ours.target_params, tmaddpg.maddpg_params_from_jax(_host(ref.target_params), device="cpu"))
    return ref, ours


def _global_norm(tree):
    return float(np.sqrt(sum(float(np.sum(np.square(np.asarray(x)))) for x in jax.tree_util.tree_leaves(tree))))


def test_maddpg_update_matches_reference_with_per_subtree_clips():
    """One update from the reference's stacked weights on a batch whose
    critic gradient norm exceeds 0.5 and whose actor norm does not: the
    metrics, the gradients, the weights after optax.multi_transform (each
    subtree clipped by its own norm, Adam at lr and critic_lr), the targets.
    One clip over all parameters would scale the actor's step too: the
    test's batch tells the two apart."""
    ref, ours = _maddpg_pair(critic_lr=3e-3, tau=0.05)
    try:
        rng = np.random.default_rng(1)
        B = 64
        batch = {"obs": rng.uniform(-1, 1, (B, 2, 4)).astype(np.float32),
                 "actions": rng.uniform(-1, 1, (B, 2, 1)).astype(np.float32),
                 "rewards": rng.normal(-1.0, 0.5, (B, 2)).astype(np.float32),
                 "dones": (rng.random(B) < 0.1).astype(np.float32),
                 "next_obs": rng.uniform(-1, 1, (B, 2, 4)).astype(np.float32)}
        jgrads = reference_grads(ref._update_fn, ref.params, ref.target_params, ref.opt_state, batch)
        actor_norm, critic_norm = _global_norm(jgrads["actor"]), _global_norm(jgrads["critic"])
        assert actor_norm < 0.5 < critic_norm, (actor_norm, critic_norm)
        new_p, new_t, _, aux = ref._update_fn(ref.params, ref.target_params, ref.opt_state, batch)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        total, taux, ga, gc = ours.loss_and_grads(tb)
        np.testing.assert_allclose(_np(total), _np(aux["total_loss"]), **F32)
        for k in taux:
            np.testing.assert_allclose(_np(taux[k]), _np(aux[k]), **F32, err_msg=k)
        for g, want in zip(ga + gc, jax.tree_util.tree_leaves(jgrads["actor"]) + jax.tree_util.tree_leaves(jgrads["critic"])):
            np.testing.assert_allclose(_np(g), _np(want), **GRADS)
        # The joint clip's actor step, for contrast: scaled by 0.5 / (global norm of both).
        joint = 0.5 / np.hypot(actor_norm, critic_norm)
        assert joint < 0.9
        m = ours.update(batch)
        np.testing.assert_allclose(_np(m["total_loss"]), _np(aux["total_loss"]), **F32)
        for name in ("actor", "critic"):
            for got, want in zip(tree_leaves(ours.params[name]), jax.tree_util.tree_leaves(new_p[name])):
                np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=name)
            for got, want in zip(tree_leaves(ours.target_params[name]), jax.tree_util.tree_leaves(new_t[name])):
                np.testing.assert_allclose(_np(got), _np(want), **F32, err_msg=name)
        # Adam's first moment after one step is 0.1 g: the actor's unclipped,
        # the critic's scaled by 0.5 / its own norm.
        mu_a = np.concatenate([_np(x).ravel() for x in ours.opt["actor"].mu])
        mu_c = np.concatenate([_np(x).ravel() for x in ours.opt["critic"].mu])
        np.testing.assert_allclose(mu_a, 0.1 * np.concatenate([_np(g).ravel() for g in ga]), **GRADS)
        np.testing.assert_allclose(mu_c, 0.1 * (0.5 / critic_norm) * np.concatenate([_np(g).ravel() for g in gc]),
                                   **GRADS)
    finally:
        ref.cleanup()
        ours.cleanup()


def test_maddpg_first_200_steps_match_reference():
    """From the reference's weights: the same 200 transitions (actors on the
    device, numpy noise seeded alike), within TRAJ."""
    ref, ours = _maddpg_pair(rollout_steps_per_iter=200)
    try:
        rm, om = ref.step(), ours.step()
        assert ours._timesteps_total == ref._timesteps_total == 200 and len(ours.buffer) == 200
        for k in ref.buffer._data:
            np.testing.assert_allclose(ours.buffer._data[k][:200], ref.buffer._data[k][:200], **TRAJ, err_msg=k)
        np.testing.assert_allclose(om["episode_reward_mean"], rm["episode_reward_mean"], **TRAJ)
        assert ours._updates == ref._updates == 0
    finally:
        ref.cleanup()
        ours.cleanup()


def test_maddpg_learns_cooperative_spread():
    """tests/test_rllib_r2d2_maddpg.py's case: its config, budget and bar."""
    from ray_tpu_torch.rllib import MADDPGConfig

    cfg = (MADDPGConfig().environment(TSpread)
           .training(rollout_steps_per_iter=500, learning_starts=500, train_batch_size=128, exploration_noise=0.3)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    best = -1e9
    try:
        for _ in range(24):
            r = algo.step()
            best = max(best, r["episode_reward_mean"])
            if best > -6:
                break
        assert best > -8, f"MADDPG failed to learn (best={best})"
        acts = algo.compute_actions(algo.env._obs())
        assert set(acts) == {"agent_0", "agent_1"}
    finally:
        algo.cleanup()


def test_maddpg_checkpoint_roundtrip():
    from ray_tpu_torch.rllib import MADDPGConfig

    cfg = (MADDPGConfig().environment(TSpread).training(rollout_steps_per_iter=300, learning_starts=200)
           .resources(device="cpu").debugging(seed=0))
    algo, algo2 = cfg.build(), cfg.build()
    try:
        algo.step()
        assert algo._updates > 0
        algo2.load_checkpoint(algo.save_checkpoint())
        assert algo2._timesteps_total == algo._timesteps_total == 300
        for name in ("params", "target_params"):
            for a, b in zip(tree_leaves(getattr(algo, name)), tree_leaves(getattr(algo2, name))):
                assert torch.equal(a.detach(), b.detach()), name
        for k in ("actor", "critic"):
            s1, s2 = algo.opt[k].state_dict(), algo2.opt[k].state_dict()
            assert s1["count"] == s2["count"] == algo._updates
            for a, b in zip(s1["mu"] + s1["nu"], s2["mu"] + s2["nu"]):
                np.testing.assert_array_equal(a, b)
        obs = algo.env._obs()
        for k, v in algo.compute_actions(obs).items():
            np.testing.assert_array_equal(v, algo2.compute_actions(obs)[k])
    finally:
        algo.cleanup()
        algo2.cleanup()


# -- Ape-X DDPG ------------------------------------------------------------------------------


def test_apex_ddpg_sigma_ladder_and_explorer_match_reference():
    """sigma_i = 0.4^(1 + 7 i / max(N - 1, 1)) per worker, and an explorer's
    fragment from the reference's weights and seed: the same transitions
    within TRAJ (the policy forward is each package's; the noise numpy)."""
    from ray_tpu.rllib.algorithms.apex_ddpg.apex_ddpg import _ApexDDPGWorker as JWorker
    from ray_tpu.rllib.algorithms.ddpg.ddpg import init_ddpg_params
    from ray_tpu_torch.rllib.algorithms.apex_ddpg.apex_ddpg import _ApexDDPGWorker as TWorker

    params = _host(init_ddpg_params(jax.random.PRNGKey(8), 3, 1, (16, 16), False))
    scale, offset = np.array([2.0], np.float32), np.array([0.0], np.float32)
    for n in (1, 2, 4):
        for i in range(n):
            ours = TWorker("Pendulum-v1", {}, (16, 16), scale, offset, i, n, 2, 3)
            ref = JWorker("Pendulum-v1", {}, (16, 16), scale, offset, i, n, 2, 3)
            assert ours.sigma == ref.sigma == 0.4 ** (1 + 7 * i / max(n - 1, 1))
            if n == 4 and i in (0, 3):
                ours.set_weights(params)
                ref.set_weights(params)
                (got, grews, gn), (want, wrews, wn) = ours.sample(60), ref.sample(60)
                assert gn == wn == 120 and grews == wrews == []
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], **TRAJ, err_msg=k)
            ours.stop()
            ref.stop()


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def _reference_apex_learner(jcfg, seed):
    """The reference ApexDDPG's learner as its ``setup`` builds it (weights,
    targets, the two Adams, the jitted step), without its explorers and
    shards, which would need the JAX package's cluster."""
    import optax
    from ray_tpu.rllib.algorithms.apex_ddpg.apex_ddpg import ApexDDPG as JApexDDPG
    from ray_tpu.rllib.algorithms.ddpg.ddpg import init_ddpg_params

    ref = object.__new__(JApexDDPG)
    ref.params = init_ddpg_params(jax.random.PRNGKey(seed), 3, 1, jcfg.model_hiddens, jcfg.twin_q)
    ref.target = jax.tree_util.tree_map(lambda x: x, ref.params)
    ref._critic_keys = tuple(k for k in ("q1", "q2") if k in ref.params)
    ref.actor_tx, ref.critic_tx = optax.adam(jcfg.lr), optax.adam(jcfg.lr)
    ref.opt_state = {"actor": ref.actor_tx.init(ref.params["actor"]),
                     "critic": ref.critic_tx.init({k: ref.params[k] for k in ref._critic_keys})}
    ref._build_train_step(jcfg)
    return ref


@pytest.mark.parametrize("twin_q", [False, True], ids=["ddpg", "twin_q"])
def test_apex_ddpg_learner_step_matches_reference(cluster, twin_q):
    """Two learner steps through ``ApexDDPG._train_once`` (a batch from the
    port's shard, the step, the priorities back to the shard) held to the
    reference's jitted ``train_step`` on the same batches: the TD errors sent
    back as priorities, both losses, the weights, the targets and both Adam
    states. The second batch's importance weights are non-uniform (the first
    step's priorities), so a loss that drops or squares the weights, or
    weights only q1, parts from the reference."""
    import jax.numpy as jnp
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl
    from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import ddpg_params_from_jax

    training = dict(lr=1e-3, tau=0.05, twin_q=twin_q, train_batch_size=32, model_hiddens=(16, 16))
    ref = _reference_apex_learner(jrl.ApexDDPGConfig().training(**training), seed=5)
    ours = (trl.ApexDDPGConfig().environment("Pendulum-v1").rollouts(num_rollout_workers=1)
            .training(num_replay_shards=1, **training).resources(device="cpu").debugging(seed=0).build())
    real_shard = ours.shards[0]
    try:
        copy_into(ours.params, ddpg_params_from_jax(_host(ref.params), device="cpu"))
        copy_into(ours.target, ddpg_params_from_jax(_host(ref.target), device="cpu"))
        rng = np.random.default_rng(3)
        n = 200
        rows = {"obs": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
                "rewards": rng.normal(-2.0, 1.0, n).astype(np.float32),
                "dones": (rng.random(n) < 0.1).astype(np.float32),
                "next_obs": rng.uniform(-1, 1, (n, 3)).astype(np.float32)}
        assert rt.get(real_shard.add.remote(rows)) == n
        batches, sent = [], []
        real_step = ours.train_step

        def recorded_step(batch, update_actor, noise=None):
            batches.append(batch)
            return real_step(batch, update_actor, noise)

        class RecordedShard:
            sample_with_idx = real_shard.sample_with_idx

            class update_priorities:
                @staticmethod
                def remote(idx, td_error):
                    sent.append((np.asarray(idx), np.asarray(td_error)))
                    return real_shard.update_priorities.remote(idx, td_error)

        ours.train_step, ours.shards = recorded_step, [RecordedShard]
        p, t, o = ref.params, ref.target, ref.opt_state
        for step in range(2):
            m = ours._train_once()
            batch = batches[-1]
            w = np.asarray(batch["weights"])
            assert (np.ptp(w) > 0.1) == (step == 1), w  # uniform until the first priorities land
            p, t, o, td, jm = ref._train_step(p, t, o, {k: jnp.asarray(v) for k, v in batch.items()})
            np.testing.assert_allclose(sent[-1][1], np.asarray(td), **F32)
            assert len(sent) == step + 1 and sent[-1][1].shape == (32,)
            for k in ("critic_loss", "actor_loss"):
                np.testing.assert_allclose(m[k], float(jm[k]), **F32, err_msg=k)
            for name, got, want in (("params", ours.params, p), ("target", ours.target, t)):
                for k in want:
                    for x, y in zip(tree_leaves(got[k]), jax.tree_util.tree_leaves(want[k])):
                        np.testing.assert_allclose(_np(x), _np(y), **F32, err_msg=f"{name} {k} step {step}")
            for name in ("actor", "critic"):
                state = o[name][0]
                for mine, theirs in ((ours.opt[name].mu, state.mu), (ours.opt[name].nu, state.nu)):
                    np.testing.assert_allclose(np.concatenate([_np(x).ravel() for x in mine]),
                                               np.concatenate([np.asarray(x).ravel() for x in
                                                               jax.tree_util.tree_leaves(theirs)]),
                                               **GRADS, err_msg=f"{name} moments step {step}")
        assert ours._updates == 2 and ours.opt["critic"].count == ours.opt["actor"].count == 2
    finally:
        ours.shards = [real_shard]
        ours.cleanup()


def test_apex_ddpg_pendulum_smoke(cluster):
    """tests/test_rllib_new_families.py's case and checks; the explorers hold
    the learner's weights bit for bit after a sync; the checkpoint round
    trip."""
    from ray_tpu_torch.rllib import ApexDDPGConfig
    from ray_tpu_torch.rllib.core.learner import weights_checksum

    cfg = (ApexDDPGConfig().environment("Pendulum-v1").rollouts(num_rollout_workers=2)
           .training(lr=1e-3, train_batch_size=64, learning_starts=300, rollout_fragment_length=50,
                     train_rounds_per_iter=3, updates_per_round=2, model_hiddens=(32, 32))
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build()
    try:
        for _ in range(2):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert r["replay_size"] > 0 and algo._updates == 8  # rounds 3-6 of 100 rows, 2 updates each
        a = algo.compute_single_action(np.zeros(3, np.float32))
        assert -2.0 <= float(np.asarray(a).ravel()[0]) <= 2.0
        algo.sync_worker_weights()
        want = weights_checksum(algo.params)
        assert rt.get([w.weights_checksum.remote() for w in algo.workers]) == [want, want]
        ckpt = algo.save_checkpoint()
        before = [x.detach().clone() for x in tree_leaves(algo.params)]
        algo.step()
        algo.load_checkpoint(ckpt)
        for x, y in zip(tree_leaves(algo.params), before):
            assert torch.equal(x.detach(), y)
        assert algo._updates == 8
        assert rt.get([w.weights_checksum.remote() for w in algo.workers]) == [want, want]
    finally:
        algo.cleanup()
