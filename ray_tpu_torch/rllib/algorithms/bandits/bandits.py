"""Contextual bandits — LinUCB and LinTS.

Reference: rllib/algorithms/bandit/ (bandit.py, policy/online linear
regression): one linear model per arm over the observation context, updated
in closed form (Sherman-Morrison), with UCB or Thompson-sampling
exploration. Environments are ordinary gym envs whose episodes are one step
long (the reference's bandit envs behave the same way); rollouts happen
in-process — there is nothing to parallelize in a closed-form update.

Numpy on the host, as in the JAX package: the arms' updates are a few
dimension-sized rank-one steps, so they take no ``device`` and launch nothing
on the card. The env is built as the reference builds it (an id through the
port's ``make``, or a class or factory called with an ``EnvContext``); its
action space is a discrete one, the port's ``spaces.Discrete`` or any space
that reads like it (``n`` and no bounds), so no gymnasium is needed.
"""

from __future__ import annotations

import time

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import _is_discrete
from ray_tpu_torch.rllib.env.vector_env import EnvContext, _make_env


class _LinearArm:
    """Online ridge regression for one arm: A = I*lambda + sum x x^T,
    b = sum r x; theta = A^-1 b. A^-1 maintained by Sherman-Morrison."""

    def __init__(self, dim: int, lam: float = 1.0):
        self.A_inv = np.eye(dim) / lam
        self.b = np.zeros(dim)
        self.theta = np.zeros(dim)
        self.n = 0

    def update(self, x: np.ndarray, reward: float):
        Ax = self.A_inv @ x
        self.A_inv -= np.outer(Ax, Ax) / (1.0 + x @ Ax)
        self.b += reward * x
        self.theta = self.A_inv @ self.b
        self.n += 1

    def ucb(self, x: np.ndarray, alpha: float) -> float:
        return float(x @ self.theta + alpha * np.sqrt(max(x @ self.A_inv @ x, 0.0)))

    def thompson(self, x: np.ndarray, rng: np.random.Generator, scale: float) -> float:
        # Sherman-Morrison drift can leave A_inv slightly asymmetric;
        # symmetrize + jitter keeps the sampler's covariance valid.
        cov = scale * self.A_inv
        cov = (cov + cov.T) / 2.0 + 1e-9 * np.eye(cov.shape[0])
        theta_s = rng.multivariate_normal(self.theta, cov)
        return float(x @ theta_s)


class BanditConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinUCB)
        self.num_rollout_workers = 0
        self.exploration = "ucb"  # "ucb" | "thompson"
        self.ucb_alpha = 1.0
        self.ts_scale = 1.0
        self.ridge_lambda = 1.0
        self.steps_per_iter = 100

    def training(self, *, exploration=None, ucb_alpha=None, ts_scale=None,
                 ridge_lambda=None, steps_per_iter=None, **kwargs) -> "BanditConfig":
        super().training(**kwargs)
        for name, val in (
            ("exploration", exploration), ("ucb_alpha", ucb_alpha),
            ("ts_scale", ts_scale), ("ridge_lambda", ridge_lambda),
            ("steps_per_iter", steps_per_iter),
        ):
            if val is not None:
                setattr(self, name, val)
        return self


class BanditLinUCB(Algorithm):
    """LinUCB (reference: BanditLinUCB)."""

    _exploration = "ucb"

    @classmethod
    def get_default_config(cls) -> BanditConfig:
        cfg = BanditConfig(cls)
        cfg.exploration = cls._exploration
        return cfg

    def setup(self, config: dict) -> None:
        cfg: BanditConfig = self._algo_config
        self.env = _make_env(cfg.env, EnvContext(dict(cfg.env_config), 0, 0))
        if not _is_discrete(self.env.action_space):
            raise ValueError(f"bandits need discrete arms, not {self.env.action_space!r}")
        self.n_arms = int(self.env.action_space.n)
        self.dim = int(np.prod(self.env.observation_space.shape))
        self.arms = [_LinearArm(self.dim, cfg.ridge_lambda) for _ in range(self.n_arms)]
        self._rng = np.random.default_rng(cfg.seed)
        self._obs, _ = self.env.reset(seed=cfg.seed)
        self._timesteps_total = 0
        self._episode_reward_window: list = []
        self._cumulative_reward = 0.0

    def _score(self, x: np.ndarray) -> np.ndarray:
        cfg: BanditConfig = self._algo_config
        if cfg.exploration == "thompson":
            return np.asarray([a.thompson(x, self._rng, cfg.ts_scale) for a in self.arms])
        return np.asarray([a.ucb(x, cfg.ucb_alpha) for a in self.arms])

    def training_step(self) -> dict:
        cfg: BanditConfig = self._algo_config
        rewards = []
        for _ in range(cfg.steps_per_iter):
            x = np.asarray(self._obs, np.float64).reshape(-1)
            arm = int(np.argmax(self._score(x)))
            obs, r, term, trunc, _ = self.env.step(arm)
            self.arms[arm].update(x, float(r))
            rewards.append(float(r))
            self._cumulative_reward += float(r)
            self._timesteps_total += 1
            if term or trunc:
                obs, _ = self.env.reset()
            self._obs = obs
        self._episode_reward_window += rewards
        self._episode_reward_window = self._episode_reward_window[-1000:]
        return {
            "mean_reward": float(np.mean(rewards)),
            "cumulative_reward": self._cumulative_reward,
            "arm_pulls": [a.n for a in self.arms],
        }

    def step(self) -> dict:
        t0 = time.time()
        result = self.training_step()
        result["episode_reward_mean"] = float(np.mean(self._episode_reward_window))
        result["timesteps_total"] = self._timesteps_total
        result["time_this_iter_s"] = time.time() - t0
        return result

    def compute_single_action(self, obs, explore: bool = False):
        x = np.asarray(obs, np.float64).reshape(-1)
        if explore:
            return int(np.argmax(self._score(x)))
        return int(np.argmax([x @ a.theta for a in self.arms]))

    def save_checkpoint(self):
        from ray_tpu_torch.air.checkpoint import Checkpoint

        return Checkpoint.from_dict({
            "arms": [(a.A_inv, a.b, a.theta, a.n) for a in self.arms],
            "timesteps": self._timesteps_total,
        })

    def load_checkpoint(self, checkpoint) -> None:
        data = checkpoint.to_dict()
        for arm, (A_inv, b, theta, n) in zip(self.arms, data["arms"]):
            arm.A_inv, arm.b, arm.theta, arm.n = np.asarray(A_inv), np.asarray(b), np.asarray(theta), n
        self._timesteps_total = data.get("timesteps", 0)

    def cleanup(self) -> None:
        env = getattr(self, "env", None)
        if env is not None:
            env.close()


class BanditLinTS(BanditLinUCB):
    """Linear Thompson sampling (reference: BanditLinTS)."""

    _exploration = "thompson"
