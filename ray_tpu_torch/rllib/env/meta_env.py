"""Meta-RL task environments.

Reference: the MAML/MBMPO envs in rllib/env/apis/task_settable_env.py
(TaskSettableEnv: sample_tasks/set_task/get_task) and the point-navigation
envs the reference's MAML tuned examples use. A task-settable env exposes a
family of MDPs sharing dynamics/observation structure; meta-learners train
for fast adaptation ACROSS the family rather than performance on one member.

The envs step in numpy on the host, on the port's own spaces (the card's
machine need not have gymnasium). PointGoalEnv also exposes ``reward_fn`` and
``transition_fn`` on tensors, so model-based algorithms (MBMPO) run imagined
rollouts on the device without a host round trip.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.env.spaces import Box


class TaskSettableEnv:
    """Protocol: an env whose MDP is switchable among a task family
    (reference: rllib/env/apis/task_settable_env.py)."""

    metadata = {"render_modes": []}

    def sample_tasks(self, n_tasks: int) -> List:
        raise NotImplementedError

    def set_task(self, task) -> None:
        raise NotImplementedError

    def get_task(self):
        raise NotImplementedError

    def close(self) -> None:
        pass


class PointGoalEnv(TaskSettableEnv):
    """2-D point navigation; the task is the (hidden) goal position.

    The goal is NOT in the observation — a fixed policy cannot know where to
    go, so pre-adaptation return is capped and any post-adaptation gain is
    attributable to adaptation from task rollouts. Episodes run a fixed
    ``horizon`` (no early termination: uniform batch shapes keep the
    meta-update stackable over tasks).
    """

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.horizon = int(config.get("horizon", 20))
        self.goal_radius = float(config.get("goal_radius", 1.0))
        self.step_size = float(config.get("step_size", 0.15))
        self._seed = int(config.get("seed", 0))
        self._rng = np.random.default_rng(self._seed)
        self.observation_space = Box(-np.inf, np.inf, (2,), np.float32)
        self.action_space = Box(-1.0, 1.0, (2,), np.float32)
        self._goal = np.array([self.goal_radius, 0.0], np.float32)
        self._pos = np.zeros(2, np.float32)
        self._t = 0

    # -- task API ---------------------------------------------------------
    def sample_tasks(self, n_tasks: int) -> List[np.ndarray]:
        angles = self._rng.uniform(0, 2 * np.pi, n_tasks)
        return [
            np.array([np.cos(a), np.sin(a)], np.float32) * self.goal_radius
            for a in angles
        ]

    def set_task(self, task) -> None:
        self._goal = np.asarray(task, np.float32)

    def get_task(self):
        return self._goal

    # -- gym API ----------------------------------------------------------
    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pos = np.zeros(2, np.float32)
        self._t = 0
        return self._pos.copy(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self._pos = self._pos + self.step_size * a
        self._t += 1
        reward = -float(np.linalg.norm(self._pos - self._goal))
        truncated = self._t >= self.horizon
        return self._pos.copy(), reward, False, truncated, {}

    # -- dynamics on tensors (for imagined rollouts on the device) ---------
    @property
    def step_scale(self) -> float:
        return self.step_size

    @staticmethod
    def reward_fn(obs, action, next_obs, task):
        """Per-step reward as a function of the TRANSITION, on tensors — the
        analog of the reference MBMPO envs' ``reward(obs, act, obs_next)``
        (rllib/algorithms/mbmpo/mbmpo.py requires envs expose it)."""
        return -torch.linalg.vector_norm(next_obs - task, dim=-1)

    @staticmethod
    def transition_fn(obs, action, step_size: float = 0.15):
        """True dynamics on tensors (used by tests to validate learned models)."""
        return obs + step_size * torch.clamp(action, -1.0, 1.0)
