"""CartPole-v1 in numpy, the port's own.

The card's machine need not have gymnasium, so ``make("CartPole-v1")``
builds this env everywhere. Its dynamics, reward, termination and seeding are
copied from gymnasium 1.2.2's ``envs/classic_control/cartpole.py``
(``CartPoleEnv``) and its ``gym.make`` wrappers: the time limit of 500 steps
(``TimeLimit``) and the refusal to step before a reset (``OrderEnforcing``).
The same seed gives the same observations, rewards and ends as gymnasium's.
The optional pygame rendering is left out.

The copied part is under gymnasium's licence:

    The MIT License

    Copyright (c) 2016 OpenAI
    Copyright (c) 2022 Farama Foundation

    Permission is hereby granted, free of charge, to any person obtaining a copy
    of this software and associated documentation files (the "Software"), to deal
    in the Software without restriction, including without limitation the rights
    to use, copy, modify, merge, publish, distribute, sublicense, and/or sell
    copies of the Software, and to permit persons to whom the Software is
    furnished to do so, subject to the following conditions:

    The above copyright notice and this permission notice shall be included in
    all copies or substantial portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS OR
    IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF MERCHANTABILITY,
    FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT. IN NO EVENT SHALL THE
    AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY CLAIM, DAMAGES OR OTHER
    LIABILITY, WHETHER IN AN ACTION OF CONTRACT, TORT OR OTHERWISE, ARISING FROM,
    OUT OF OR IN CONNECTION WITH THE SOFTWARE OR THE USE OR OTHER DEALINGS IN
    THE SOFTWARE.
"""

from __future__ import annotations

import math

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Box, Discrete


class CartPoleEnv:
    """Classic cart-pole system implemented by Rich Sutton et al. (the
    gymnasium env's docstring has the full description): a pole on a cart
    moving along a frictionless track; action 0 pushes the cart left, 1
    right; +1 reward every step; the episode ends when the pole leans past
    12 degrees or the cart leaves [-2.4, 2.4], and is truncated after
    ``max_episode_steps``."""

    def __init__(self, sutton_barto_reward: bool = False, max_episode_steps: int | None = 500):
        self._sutton_barto_reward = sutton_barto_reward
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # actually half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.kinematics_integrator = "euler"
        # Angle at which to fail the episode
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        # Angle limit set to 2 * theta_threshold_radians so failing observation
        # is still within bounds.
        high = np.array([self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf], dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: np.ndarray | None = None
        self.steps_beyond_terminated = None
        self._np_random: np.random.Generator | None = None
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps: int | None = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(None)))
        return self._np_random

    def step(self, action):
        if self._elapsed_steps is None:
            raise RuntimeError("Cannot call env.step() before calling env.reset()")
        assert self.action_space.contains(action), f"{action!r} ({type(action)}) invalid"
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        # For the interested reader:
        # https://coneural.org/florian/papers/05_cart_pole.pdf
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        if self.kinematics_integrator == "euler":
            x = x + self.tau * x_dot
            x_dot = x_dot + self.tau * xacc
            theta = theta + self.tau * theta_dot
            theta_dot = theta_dot + self.tau * thetaacc
        else:  # semi-implicit euler
            x_dot = x_dot + self.tau * xacc
            x = x + self.tau * x_dot
            theta_dot = theta_dot + self.tau * thetaacc
            theta = theta + self.tau * theta_dot
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 0.0 if self._sutton_barto_reward else 1.0
        elif self.steps_beyond_terminated is None:
            # Pole just fell!
            self.steps_beyond_terminated = 0
            reward = -1.0 if self._sutton_barto_reward else 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = -1.0 if self._sutton_barto_reward else 0.0
        # The time limit gymnasium's make() wraps the env in (TimeLimit).
        self._elapsed_steps += 1
        truncated = self._max_episode_steps is not None and self._elapsed_steps >= self._max_episode_steps
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        low, high = -0.05, 0.05
        if options is not None:
            low = options.get("low", low)
            high = options.get("high", high)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def close(self):
        pass


def _pendulum():
    from ray_tpu_torch.rllib.env.pendulum import PendulumEnv

    return PendulumEnv(max_episode_steps=200)


ENV_IDS = {"CartPole-v1": lambda: CartPoleEnv(max_episode_steps=500), "Pendulum-v1": _pendulum}


def make(env_id: str):
    """The env for a gymnasium id. ``CartPole-v1`` and ``Pendulum-v1``
    (``env/pendulum.py``) are always the port's own; any other id goes to
    ``gymnasium.make`` (imported here), which raises ``ImportError`` naming
    the package and the id where gymnasium is absent."""
    if env_id in ENV_IDS:
        return ENV_IDS[env_id]()
    try:
        import gymnasium as gym
    except ImportError as e:
        raise ImportError(
            f"env {env_id!r} needs the 'gymnasium' package, which is not installed "
            f"(the port carries its own {sorted(ENV_IDS)} only)"
        ) from e
    return gym.make(env_id)
