"""Ape-X DQN — distributed prioritized experience replay.

Reference: rllib/algorithms/apex_dqn/apex_dqn.py (Horgan et al. 2018): many
rollout-worker actors explore with a per-worker epsilon ladder and feed
actor-sharded prioritized replay buffers; the learner samples shards
round-robin, trains the double-Q TD loss, pushes updated priorities back to
the owning shard, and broadcasts weights periodically. The replay memory
therefore scales horizontally with shard actors instead of living in the
learner process.

The explorers and the shards are CPU actors; the learner, its target copy
and the TD targets live on the config's device (the card by default).
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNConfig, dqn_loss, q_forward, td_errors, td_targets
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModule, _device
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer


class _ApexWorker:
    """Rollout actor: explores with its own fixed epsilon (Ape-X ladder
    eps_i = 0.4^(1 + 7 i/(N-1))) against the latest broadcast weights, its
    Q forward on the CPU."""

    def __init__(self, env, env_config, spec, worker_index, num_workers, num_envs, seed):
        import torch

        from ray_tpu_torch.rllib.env.vector_env import VectorEnv

        # Rollouts stay off the card, one intra-op thread (rollout_worker.py).
        torch.set_num_threads(1)
        self.spec = spec
        self.env = VectorEnv(env, num_envs, env_config, worker_index, seed=seed + worker_index)
        self._module = RLModule(spec, device="cpu").requires_grad_(False)
        self.params = None
        denom = max(num_workers - 1, 1)
        self.epsilon = 0.4 ** (1 + 7 * worker_index / denom)
        self._rng = np.random.default_rng(seed * 9973 + worker_index)

    def set_weights(self, weights):
        self._module.load_params(weights)
        self.params = weights
        return True

    def sample(self, n_steps: int):
        import torch

        cols = {OBS: [], ACTIONS: [], REWARDS: [], DONES: [], NEXT_OBS: []}
        for _ in range(n_steps):
            obs = self.env.current_obs().astype(np.float32)
            with torch.no_grad():
                actions = q_forward(self._module, torch.from_numpy(obs)).argmax(-1).numpy()
            mask = self._rng.random(len(actions)) < self.epsilon
            actions = np.where(
                mask, self._rng.integers(0, self.spec.action_dim, len(actions)), actions
            )
            next_obs, rewards, dones, _ = self.env.step(actions)
            cols[OBS].append(obs)
            cols[ACTIONS].append(actions)
            cols[REWARDS].append(rewards)
            cols[DONES].append(dones.astype(np.float32))
            cols[NEXT_OBS].append(next_obs.astype(np.float32))
        out = {k: np.concatenate(v) for k, v in cols.items()}
        rews, _lens = self.env.pop_episode_stats()
        return out, rews, len(out[OBS])

    def stop(self):
        self.env.close()
        return True


class _ReplayShard:
    """One shard of the distributed prioritized replay memory."""

    def __init__(self, capacity: int, seed: int):
        self.buf = PrioritizedReplayBuffer(capacity, seed=seed)

    def add(self, cols: dict):
        self.buf.add(SampleBatch({k: np.asarray(v) for k, v in cols.items()}))
        return len(self.buf)

    def sample_with_idx(self, n: int):
        if len(self.buf) < n:
            return None
        out, idx = self.buf.sample_with_indices(n)
        return dict(out), idx

    def update_priorities(self, idx, td_errors):
        # Addressed by explicit indices: other learner rounds may have
        # sampled in between (the implicit last-idx protocol doesn't
        # survive interleaving).
        self.buf.update_priorities_at(idx, td_errors)
        return True

    def size(self) -> int:
        return len(self.buf)


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDQN)
        self.num_rollout_workers = 2
        self.num_replay_shards = 2
        self.rollout_fragment_length = 50
        self.weight_sync_period_updates = 16
        self.train_rounds_per_iter = 8
        self.updates_per_round = 4

    def training(self, *, num_replay_shards=None, rollout_fragment_length=None,
                 weight_sync_period_updates=None, train_rounds_per_iter=None,
                 updates_per_round=None, **kwargs) -> "ApexDQNConfig":
        if "epsilon_timesteps" in kwargs or "final_epsilon" in kwargs:
            # Ape-X never anneals: workers use the fixed per-worker ladder
            # eps_i = 0.4^(1+7i/(N-1)). Accepting a schedule silently would
            # imply annealing that doesn't happen.
            import warnings

            warnings.warn(
                "ApexDQN ignores epsilon schedule fields (epsilon_timesteps/"
                "final_epsilon): exploration uses the fixed per-worker "
                "epsilon ladder", stacklevel=2,
            )
            kwargs.pop("epsilon_timesteps", None)
            kwargs.pop("final_epsilon", None)
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


class ApexDQN(Algorithm):
    @classmethod
    def get_default_config(cls) -> ApexDQNConfig:
        return ApexDQNConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: ApexDQNConfig = self._algo_config
        # Re-setup (Trainable.__init__ already ran setup once) must not leak
        # the previous actor fleet's CPU reservations.
        self.cleanup()
        _device(cfg.device)  # no card and no device="cpu": raise before any actor starts
        self.module_spec = self._spec_from_env(cfg)
        assert self.module_spec.discrete, "ApexDQN requires a discrete action space"
        self.learner = Learner(
            self.module_spec, dqn_loss, lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed, device=cfg.device
        )
        self.target = RLModule(self.module_spec, device=self.learner.device).requires_grad_(False)
        self.target.load_params(self.learner.module.param_tree())

        n_workers = max(cfg.num_rollout_workers, 1)
        worker_cls = ray_tpu_torch.remote(num_cpus=getattr(cfg, "num_cpus_per_worker", None) or 1)(_ApexWorker)
        self.workers = [
            worker_cls.remote(
                cfg.env, dict(cfg.env_config), self.module_spec,
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
        weights = self.learner.get_weights()
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers], timeout=300)
        self._timesteps_total = 0
        self._updates = 0
        self._last_sync = 0
        self._add_rr = 0
        self._sample_rr = 0
        self._replay_size = 0
        self._episode_reward_window: list = []

    @property
    def target_params(self) -> dict:
        return self.target.get_params()

    def training_step(self) -> dict:
        cfg: ApexDQNConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.train_rounds_per_iter):
            # Fan the rollout actors out; route each fragment to a shard.
            refs = [w.sample.remote(cfg.rollout_fragment_length) for w in self.workers]
            add_refs = []
            add_shards = []
            for cols, rews, count in ray_tpu_torch.get(refs, timeout=600):
                shard_i = self._add_rr % len(self.shards)
                self._add_rr += 1
                add_refs.append(self.shards[shard_i].add.remote(cols))
                add_shards.append(shard_i)
                self._timesteps_total += count
                self._episode_reward_window += rews
            # shard.add returns the shard's new size; track the latest per
            # shard instead of a second size() fan-out every round.
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
                weights = self.learner.get_weights()
                ray_tpu_torch.get(
                    [w.set_weights.remote(weights) for w in self.workers], timeout=300
                )
        metrics["replay_size"] = self._replay_size
        return metrics

    def _train_once(self):
        cfg: ApexDQNConfig = self._algo_config
        shard = self.shards[self._sample_rr % len(self.shards)]
        self._sample_rr += 1
        res = ray_tpu_torch.get(shard.sample_with_idx.remote(cfg.train_batch_size), timeout=300)
        if res is None:
            return None
        batch, idx = res
        td_target = td_targets(self.learner.module, self.target, batch, cfg.gamma, cfg.double_q)
        train_batch = {OBS: batch[OBS], ACTIONS: batch[ACTIONS], "td_target": td_target,
                       "weights": batch["weights"]}
        metrics = self.learner.update(train_batch, {})
        shard.update_priorities.remote(idx, td_errors(self.learner.module, batch, td_target))
        self._updates += 1
        if self._updates % cfg.target_network_update_freq == 0:
            self.target.load_params(self.learner.module.param_tree())
        return metrics

    def step(self) -> dict:
        import time

        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = (
            float(np.mean(self._episode_reward_window))
            if self._episode_reward_window
            else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def compute_single_action(self, obs, explore: bool = False):
        """Greedy argmax-Q (evaluation / external callers); exploration is
        the rollout workers' per-worker epsilon, not reproduced here."""
        import torch

        from ray_tpu_torch.rllib.core.learner import full_f32

        module = self.learner.module
        with torch.no_grad(), full_f32(module.device):
            q = q_forward(module, torch.from_numpy(np.asarray(obs, np.float32)[None]).to(module.device))
        return int(q.argmax(-1)[0])

    def get_policy_weights(self):
        return self.learner.get_weights()

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "weights": self.learner.get_weights(),
            "target": self.target_params,
            "timesteps": self._timesteps_total,
            "updates": self._updates,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner.set_weights(data["weights"])
        self.target.load_params(data["target"])
        self._timesteps_total = data.get("timesteps", 0)
        self._updates = data.get("updates", 0)
        weights = self.learner.get_weights()
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers], timeout=300)

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
