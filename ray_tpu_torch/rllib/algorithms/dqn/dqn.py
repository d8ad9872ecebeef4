"""DQN — deep Q-learning with target network + prioritized replay.

Reference: rllib/algorithms/dqn/dqn.py (+ dqn_torch_policy loss): epsilon-
greedy rollouts into a replay buffer, double-Q TD targets against a
periodically-synced target network, one TD update per train step.

The learner, its target copy and the acting forward live on the config's
device (the card by default). Acting uses the LIVE parameters on every env
step, as the reference does (intra-iteration updates steer exploration): one
small forward whose argmax is taken on the device, and only the integer
actions come back. The TD targets are computed on the device too; the
exploration and replay draws stay numpy (``np.random.default_rng``), so from
the same weights the port steps the reference's trajectory until an argmax tie
parts them. Every forward and update runs in full f32 (``full_f32``): argmax-
driven trajectories and TD targets are sensitive to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, full_f32
from ray_tpu_torch.rllib.core.rl_module import RLModule, _device
from ray_tpu_torch.rllib.env.vector_env import VectorEnv
from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    NEXT_OBS,
    OBS,
    REWARDS,
    SampleBatch,
)
from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer


def q_forward(module, obs):
    """The pi head doubles as the Q head for DQN (logits == Q-values)."""
    q, _ = module(obs)
    return q


def dqn_loss(module, batch, spec, cfg):
    """Importance-weighted squared TD error against ``batch["td_target"]``."""
    q = q_forward(module, batch[OBS])
    q_taken = q.gather(1, batch[ACTIONS].long()[:, None])[:, 0]
    td_error = q_taken - batch["td_target"]
    weights = batch.get("weights", torch.ones_like(td_error))
    loss = torch.mean(weights * torch.square(td_error) * 0.5)
    return loss, {"td_error_abs": td_error.abs().mean(), "q_mean": q_taken.mean()}


def _on(x: np.ndarray, dev: torch.device, dtype=None) -> torch.Tensor:
    """A host column as a tensor on ``dev`` (a read-only store array is
    copied first)."""
    return torch.from_numpy(np.require(x, dtype=dtype, requirements="W")).to(dev)


@torch.no_grad()
def td_targets(online, target, batch, gamma: float, double_q: bool) -> torch.Tensor:
    """``r + gamma (1 - done) Q_target(s', a*)`` on the learner's device: a*
    is the online network's argmax with ``double_q``, the target's own max
    otherwise."""
    dev = online.device
    next_obs = _on(batch[NEXT_OBS], dev)
    with full_f32(dev):
        q_next_target = q_forward(target, next_obs)
        if double_q:
            best = q_forward(online, next_obs).argmax(-1)
            q_next = q_next_target.gather(1, best[:, None])[:, 0]
        else:
            q_next = q_next_target.max(-1).values
    return _on(batch[REWARDS], dev) + gamma * (1.0 - _on(batch[DONES], dev)) * q_next


@torch.no_grad()
def td_errors(module, batch, td_target) -> np.ndarray:
    """``Q(s, a) - td_target`` after the update, on the host: the new
    priorities."""
    dev = module.device
    with full_f32(dev):
        q = q_forward(module, _on(batch[OBS], dev))
    actions = _on(batch[ACTIONS], dev, np.int64)
    return (q.gather(1, actions[:, None])[:, 0] - td_target).cpu().numpy()


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.num_rollout_workers = 0  # DQN collects in-process by default
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.learning_starts = 1000
        self.target_network_update_freq = 500
        self.rollout_steps_per_iter = 1000
        self.train_intensity = 4  # updates per env step / batch ratio
        self.epsilon_timesteps = 10_000
        self.initial_epsilon = 1.0
        self.final_epsilon = 0.02
        self.double_q = True
        self.prioritized_replay = True

    def training(self, *, replay_buffer_capacity=None, learning_starts=None,
                 target_network_update_freq=None, epsilon_timesteps=None,
                 final_epsilon=None, double_q=None, prioritized_replay=None,
                 rollout_steps_per_iter=None, train_intensity=None, **kwargs) -> "DQNConfig":
        super().training(**kwargs)
        for name, val in (
            ("replay_buffer_capacity", replay_buffer_capacity),
            ("learning_starts", learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("epsilon_timesteps", epsilon_timesteps),
            ("final_epsilon", final_epsilon),
            ("double_q", double_q),
            ("prioritized_replay", prioritized_replay),
            ("rollout_steps_per_iter", rollout_steps_per_iter),
            ("train_intensity", train_intensity),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class DQN(Algorithm):
    @classmethod
    def get_default_config(cls) -> DQNConfig:
        return DQNConfig(cls)

    def setup(self, config: dict) -> None:
        cfg: DQNConfig = self._algo_config
        _device(cfg.device)  # no card and no device="cpu": raise first
        self.module_spec = self._spec_from_env(cfg)
        assert self.module_spec.discrete, "DQN requires a discrete action space"
        self.env = VectorEnv(cfg.env, max(cfg.num_envs_per_worker, 1), cfg.env_config, 0, seed=cfg.seed)
        self.learner = Learner(self.module_spec, dqn_loss, lr=cfg.lr, grad_clip=cfg.grad_clip, seed=cfg.seed,
                               device=cfg.device)
        self.target = RLModule(self.module_spec, device=self.learner.device).requires_grad_(False)
        self.target.load_params(self.learner.module.param_tree())
        buf_cls = PrioritizedReplayBuffer if cfg.prioritized_replay else ReplayBuffer
        self.buffer = buf_cls(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._timesteps_total = 0
        self._updates = 0
        self._episode_reward_window: list = []
        self._rng = np.random.default_rng(cfg.seed)

    @property
    def target_params(self) -> dict:
        """The target network's weights (a numpy tree)."""
        return self.target.get_params()

    def _epsilon(self) -> float:
        cfg = self._algo_config
        frac = min(1.0, self._timesteps_total / max(cfg.epsilon_timesteps, 1))
        return cfg.initial_epsilon + frac * (cfg.final_epsilon - cfg.initial_epsilon)

    @torch.no_grad()
    def _greedy(self, obs: np.ndarray) -> np.ndarray:
        """The live network's argmax actions for a host batch of
        observations: the argmax on the device, the integers back."""
        module = self.learner.module
        with full_f32(module.device):
            q = q_forward(module, torch.from_numpy(obs).to(module.device))
        return q.argmax(-1).cpu().numpy()

    def training_step(self) -> dict:
        cfg: DQNConfig = self._algo_config
        metrics: dict = {}
        for _ in range(cfg.rollout_steps_per_iter):
            obs = self.env.current_obs().astype(np.float32)
            # Live params: intra-iteration learner updates steer exploration.
            actions = self._greedy(obs)
            eps_mask = self._rng.random(len(actions)) < self._epsilon()
            random_actions = self._rng.integers(0, self.module_spec.action_dim, len(actions))
            actions = np.where(eps_mask, random_actions, actions)
            next_obs, rewards, dones, _ = self.env.step(actions)
            self.buffer.add(SampleBatch({
                OBS: obs, ACTIONS: actions, REWARDS: rewards,
                DONES: dones.astype(np.float32), NEXT_OBS: next_obs.astype(np.float32),
            }))
            self._timesteps_total += len(actions)
            if self._timesteps_total >= cfg.learning_starts and self._timesteps_total % max(1, cfg.train_intensity) == 0:
                metrics = self._train_once()
        stats_r, _ = self.env.pop_episode_stats()
        self._episode_reward_window += stats_r
        self._episode_reward_window = self._episode_reward_window[-100:]
        metrics["epsilon"] = self._epsilon()
        return metrics

    def _train_once(self) -> dict:
        cfg: DQNConfig = self._algo_config
        batch = self.buffer.sample(cfg.train_batch_size)
        td_target = td_targets(self.learner.module, self.target, batch, cfg.gamma, cfg.double_q)
        train_batch = {OBS: batch[OBS], ACTIONS: batch[ACTIONS], "td_target": td_target}
        if "weights" in batch:
            train_batch["weights"] = batch["weights"]
        metrics = self.learner.update(train_batch, {})
        if isinstance(self.buffer, PrioritizedReplayBuffer):
            self.buffer.update_priorities(td_errors(self.learner.module, batch, td_target))
        self._updates += 1
        if self._updates % cfg.target_network_update_freq == 0:
            self.target.load_params(self.learner.module.param_tree())
        return metrics

    def step(self) -> dict:
        import time

        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = (
            float(np.mean(self._episode_reward_window)) if self._episode_reward_window else float("nan")
        )
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def get_policy_weights(self):
        return self.learner.get_weights()

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "weights": self.learner.get_weights(),
            "target": self.target_params,
            "timesteps": self._timesteps_total,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        self.learner.set_weights(data["weights"])
        self.target.load_params(data["target"])
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        self.env.close()

    def compute_single_action(self, obs, explore: bool = False):
        if explore and self._rng.random() < self._epsilon():
            # Epsilon-greedy for external/inverted-control callers
            # (ExternalEnv serves actions through this entry point).
            return int(self._rng.integers(0, self.module_spec.action_dim))
        return int(self._greedy(np.asarray(obs, np.float32)[None])[0])
