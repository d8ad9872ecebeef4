"""Ape-X DDPG — distributed prioritized replay for continuous control.

Reference: rllib/algorithms/apex_ddpg/apex_ddpg.py (Horgan et al. 2018
applied to DDPG): the Ape-X architecture of apex_dqn — many exploration
actors on a per-worker noise ladder feeding actor-sharded prioritized
replay, a central learner pushing priorities back and broadcasting weights
periodically — with DDPG's deterministic-policy TD learner instead of the
Q-network. The exploration ladder uses per-worker Gaussian ACTION noise
(sigma_i = 0.4^(1 + 7 i/(N-1)), the continuous analog of the epsilon
ladder apex_dqn.py:48 uses).

The learner is DDPG's (``DDPG.train_step``: the critic TD loss weighted by
the shards' importance weights, the actor update through the updated critic,
Polyak targets) on the config's device (the card by default); its TD errors
go back to the owning shard as fresh priorities. The explorers are CPU
actors pinned to the host (their policy forward in torch on the CPU, their
noise numpy); the shards are Ape-X DQN's ``_ReplayShard``.
"""

from __future__ import annotations

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.apex_dqn.apex_dqn import _ReplayShard
from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import DDPG, DDPGConfig
from ray_tpu_torch.rllib.algorithms.off_policy import mlp_apply, true_transition
from ray_tpu_torch.rllib.core.learner import weights_checksum
from ray_tpu_torch.rllib.core.rl_module import host_tree, tree_map
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    NEXT_OBS,
    OBS,
    REWARDS,
)


class _ApexDDPGWorker:
    """Exploration actor: deterministic policy + fixed per-worker Gaussian
    action noise against the latest broadcast weights, its forward on the
    CPU."""

    def __init__(self, env, env_config, hiddens, act_scale, act_offset,
                 worker_index, num_workers, num_envs, seed):
        from ray_tpu_torch.rllib.env.vector_env import VectorEnv
        from ray_tpu_torch.rllib.evaluation.rollout_worker import _in_actor_process

        # Rollouts stay off the card, one intra-op thread (rollout_worker.py);
        # an actor's process is pinned to the host.
        torch.set_num_threads(1)
        if _in_actor_process():
            from ray_tpu_torch._private.serialization import pin_to_host

            pin_to_host()
        self.env = VectorEnv(env, num_envs, env_config, worker_index, seed=seed + worker_index)
        self.params = None
        self._act_scale = np.asarray(act_scale, np.float32)
        self._act_offset = np.asarray(act_offset, np.float32)
        denom = max(num_workers - 1, 1)
        self.sigma = 0.4 ** (1 + 7 * worker_index / denom)
        self._rng = np.random.default_rng(seed * 9973 + worker_index)

    def set_weights(self, weights):
        self.params = tree_map(lambda x: torch.tensor(np.asarray(x), dtype=torch.float32), weights)
        return True

    def weights_checksum(self) -> str:
        """SHA-256 of the held weights, packed (``learner.weights_checksum``)."""
        return weights_checksum(self.params)

    def _policy(self, obs):
        with torch.no_grad():
            return torch.tanh(mlp_apply(self.params["actor"], torch.from_numpy(obs))).numpy()

    def sample(self, n_steps: int):
        cols = {OBS: [], ACTIONS: [], REWARDS: [], DONES: [], NEXT_OBS: []}
        for _ in range(n_steps):
            obs = self.env.current_obs().astype(np.float32).reshape(self.env.num_envs, -1)
            a = self._policy(obs)
            a = np.clip(a + self._rng.normal(0, self.sigma, a.shape), -1, 1).astype(np.float32)
            _, rewards, dones, infos = self.env.step(a * self._act_scale + self._act_offset)
            next_obs, terminateds = true_transition(self.env, dones, infos)
            cols[OBS].append(obs)
            cols[ACTIONS].append(a)
            cols[REWARDS].append(rewards)
            cols[DONES].append(terminateds)
            cols[NEXT_OBS].append(next_obs)
        out = {k: np.concatenate(v) for k, v in cols.items()}
        rews, _ = self.env.pop_episode_stats()
        return out, rews, len(out[OBS])

    def stop(self):
        self.env.close()
        return True


class ApexDDPGConfig(DDPGConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDDPG)
        self.num_rollout_workers = 2
        self.num_replay_shards = 2
        self.rollout_fragment_length = 50
        self.weight_sync_period_updates = 16
        self.train_rounds_per_iter = 8
        self.updates_per_round = 4
        self.learning_starts = 500

    def training(self, *, num_replay_shards=None, rollout_fragment_length=None,
                 weight_sync_period_updates=None, train_rounds_per_iter=None,
                 updates_per_round=None, **kwargs) -> "ApexDDPGConfig":
        super().training(**kwargs)
        for name, val in (
            ("num_replay_shards", num_replay_shards),
            ("rollout_fragment_length", rollout_fragment_length),
            ("weight_sync_period_updates", weight_sync_period_updates),
            ("train_rounds_per_iter", train_rounds_per_iter),
            ("updates_per_round", updates_per_round),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class ApexDDPG(DDPG):
    """DDPG's learner (``DDPG.train_step`` with the shards' importance
    weights, the actor stepped every update) fed by the explorers and the
    shards; the step, the checkpoint and the reward window are
    ``OffPolicyTraining``'s."""

    @classmethod
    def get_default_config(cls) -> ApexDDPGConfig:
        return ApexDDPGConfig(cls)

    def setup(self, config: dict) -> None:
        # Re-setup (Trainable.__init__ already ran setup once) must not leak
        # the previous actor fleet's CPU reservations.
        self.cleanup()
        cfg: ApexDDPGConfig = self._algo_config
        self._setup_learner(cfg)  # no card and no device="cpu": raise before any actor starts
        n_workers = max(cfg.num_rollout_workers, 1)
        worker_cls = ray_tpu_torch.remote(num_cpus=1)(_ApexDDPGWorker)
        self.workers = [
            worker_cls.remote(
                cfg.env, dict(cfg.env_config), cfg.model_hiddens,
                self._act_scale, self._act_offset,
                i, n_workers, max(cfg.num_envs_per_worker, 1), cfg.seed,
            )
            for i in range(n_workers)
        ]
        shard_cls = ray_tpu_torch.remote(num_cpus=0.1)(_ReplayShard)
        shard_cap = max(1, cfg.replay_buffer_capacity // max(cfg.num_replay_shards, 1))
        self.shards = [
            shard_cls.remote(shard_cap, cfg.seed + 31 * i) for i in range(cfg.num_replay_shards)
        ]
        self._shard_sizes = {i: 0 for i in range(len(self.shards))}
        self.sync_worker_weights()
        self._last_sync = 0
        self._add_rr = 0
        self._sample_rr = 0
        self._replay_size = 0
        self._episode_reward_window: list = []

    def _target_noise(self, n: int):
        """None: the reference's Ape-X learner never smooths its targets."""
        return None

    def sync_worker_weights(self):
        weights = host_tree(self.params)
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers], timeout=300)

    def training_step(self) -> dict:
        cfg: ApexDDPGConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.train_rounds_per_iter):
            refs = [w.sample.remote(cfg.rollout_fragment_length) for w in self.workers]
            add_refs, add_shards = [], []
            for cols, rews, count in ray_tpu_torch.get(refs, timeout=600):
                shard_i = self._add_rr % len(self.shards)
                self._add_rr += 1
                add_refs.append(self.shards[shard_i].add.remote(cols))
                add_shards.append(shard_i)
                self._timesteps_total += count
                self._episode_reward_window += rews
            for size, shard in zip(ray_tpu_torch.get(add_refs, timeout=300), add_shards):
                self._shard_sizes[shard] = size
            self._replay_size = sum(self._shard_sizes.values())
            self._episode_reward_window = self._episode_reward_window[-100:]
            if self._replay_size < cfg.learning_starts:
                continue
            for _ in range(cfg.updates_per_round):
                metrics = self._train_once() or metrics
            if self._updates - self._last_sync >= cfg.weight_sync_period_updates:
                self._last_sync = self._updates
                self.sync_worker_weights()
        metrics["replay_size"] = self._replay_size
        return metrics

    def _train_once(self):
        """One learner step on a batch from the next shard; its TD errors go
        back to that shard as priorities. The TD errors and the losses come
        to the host in one read."""
        cfg: ApexDDPGConfig = self._algo_config
        shard = self.shards[self._sample_rr % len(self.shards)]
        self._sample_rr += 1
        res = ray_tpu_torch.get(shard.sample_with_idx.remote(cfg.train_batch_size), timeout=300)
        if res is None:
            return None
        batch, idx = res
        m, td_error = self.train_step(batch, True)
        host = torch.cat([td_error, m["critic_loss"][None], m["actor_loss"][None]]).cpu().numpy()
        shard.update_priorities.remote(idx, host[:-2])
        self._updates += 1
        return {"critic_loss": float(host[-2]), "actor_loss": float(host[-1])}

    def compute_single_action(self, obs, explore: bool = False):
        """The deterministic policy's action (no noise: the learner does not
        explore)."""
        return self._env_action(self._policy(np.asarray(obs, np.float32).reshape(1, -1))[0])

    def load_checkpoint(self, checkpoint) -> None:
        super().load_checkpoint(checkpoint)
        self.sync_worker_weights()

    def cleanup(self) -> None:
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.get(w.stop.remote(), timeout=10)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        for s in getattr(self, "shards", []):
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
        self.workers = []
        self.shards = []
        eval_ws = getattr(self, "_eval_workers", None)
        if eval_ws is not None:
            eval_ws.stop()
            self._eval_workers = None
