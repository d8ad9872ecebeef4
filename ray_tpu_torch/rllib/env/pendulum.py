"""Pendulum-v1 in numpy, the port's own.

The card's machine need not have gymnasium, so ``make("Pendulum-v1")``
builds this env everywhere. Its dynamics, reward, observation, reset draw and
seeding are copied from gymnasium 1.2.2's
``envs/classic_control/pendulum.py`` (``PendulumEnv``) and its ``gym.make``
wrappers: the time limit of 200 steps (``TimeLimit``) and the refusal to step
before a reset (``OrderEnforcing``). The same seed gives the same
observations, rewards and ends as gymnasium's. The optional pygame rendering
is left out.

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

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Box

DEFAULT_X = np.pi
DEFAULT_Y = 1.0


def verify_number_and_cast(x) -> float:
    """Verify parameter is a single number and cast to a float."""
    try:
        x = float(x)
    except (ValueError, TypeError) as e:
        raise ValueError(f"An option ({x}) could not be converted to a float.") from e
    return x


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv:
    """The inverted pendulum swing-up (the gymnasium env's docstring has the
    full description): a pendulum on a fixed pivot, started at a random
    angle in [-pi, pi] and angular velocity in [-1, 1]; the action is the
    torque on its free end in [-2, 2]; the observation is ``(cos theta,
    sin theta, theta_dot)``; the reward is ``-(theta^2 + 0.1 theta_dot^2 +
    0.001 torque^2)`` with theta normalised to [-pi, pi]; the episode never
    terminates and is truncated after ``max_episode_steps``."""

    def __init__(self, g: float = 10.0, max_episode_steps: int | None = 200):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741 - gymnasium's name
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(low=-self.max_torque, high=self.max_torque, shape=(1,), dtype=np.float32)
        self.observation_space = Box(low=-high, high=high, dtype=np.float32)
        self.state: np.ndarray | None = None
        self.last_u = None
        self._np_random: np.random.Generator | None = None
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps: int | None = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(None)))
        return self._np_random

    def step(self, u):
        if self._elapsed_steps is None:
            raise RuntimeError("Cannot call env.step() before calling env.reset()")
        th, thdot = self.state  # th := theta
        g = self.g
        m = self.m
        l = self.l  # noqa: E741
        dt = self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        self.last_u = u  # for rendering
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        # The time limit gymnasium's make() wraps the env in (TimeLimit).
        self._elapsed_steps += 1
        truncated = self._max_episode_steps is not None and self._elapsed_steps >= self._max_episode_steps
        return self._get_obs(), -costs, False, truncated, {}

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        if options is None:
            high = np.array([DEFAULT_X, DEFAULT_Y])
        else:
            # Note that if you use custom reset bounds, it may lead to out-of-bound
            # state/observations.
            x = options.get("x_init") if "x_init" in options else DEFAULT_X
            y = options.get("y_init") if "y_init" in options else DEFAULT_Y
            x = verify_number_and_cast(x)
            y = verify_number_and_cast(y)
            high = np.array([x, y])
        low = -high  # We enforce symmetric limits.
        self.state = self.np_random.uniform(low=low, high=high)
        self.last_u = None
        self._elapsed_steps = 0
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def close(self):
        pass
