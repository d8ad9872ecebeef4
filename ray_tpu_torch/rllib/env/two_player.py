"""Two-player simultaneous-move environments for self-play training.

Reference: the reference's AlphaStar (rllib/algorithms/alpha_star/) trains
on multi-agent competitive envs through the MultiAgentEnv API; its league
machinery only needs "two policies act simultaneously, zero-sum payoff,
win-rates are measurable". This module provides that minimal protocol plus
a repeated matrix game (rock-paper-scissors by default) — the standard
testbed for league/exploitability dynamics (OpenSpiel uses the same).

Protocol (simpler than MultiAgentEnv on purpose — both sides step in one
call, which is what simultaneous-move matchmaking needs):
    obs_a, obs_b = env.reset()
    obs_a, obs_b, r_a, r_b, done = env.step(act_a, act_b)
r_a == -r_b (zero-sum).

The JAX package's ``rllib/env/two_player.py`` as it is, on the port's own
spaces (``env/spaces.py``); ``scripted_biased_policy`` draws from the same
``default_rng`` stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Box, Discrete

# Rock-paper-scissors payoff for the row player: entry [i, j] is row's
# reward when row plays i and column plays j.
RPS_PAYOFF = np.array(
    [
        [0.0, -1.0, 1.0],
        [1.0, 0.0, -1.0],
        [-1.0, 1.0, 0.0],
    ],
    np.float32,
)


class TwoPlayerMatrixEnv:
    """Repeated simultaneous matrix game. Observation (per player) is the
    one-hot of [my last action, opponent's last action] (zeros on the first
    round) — enough memory for best-responding against non-uniform
    opponents while keeping the game small."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.payoff = np.asarray(config.get("payoff", RPS_PAYOFF), np.float32)
        assert self.payoff.shape[0] == self.payoff.shape[1]
        self.n_actions = self.payoff.shape[0]
        self.rounds = int(config.get("rounds", 32))
        self.observation_space = Box(0.0, 1.0, (2 * self.n_actions,), np.float32)
        self.action_space = Discrete(self.n_actions)
        self._t = 0
        self._last = (None, None)

    def _obs(self, mine, theirs) -> np.ndarray:
        o = np.zeros(2 * self.n_actions, np.float32)
        if mine is not None:
            o[mine] = 1.0
        if theirs is not None:
            o[self.n_actions + theirs] = 1.0
        return o

    def reset(self):
        self._t = 0
        self._last = (None, None)
        return self._obs(None, None), self._obs(None, None)

    def step(self, act_a: int, act_b: int):
        r_a = float(self.payoff[act_a, act_b])
        self._t += 1
        self._last = (act_a, act_b)
        done = self._t >= self.rounds
        return (
            self._obs(act_a, act_b),
            self._obs(act_b, act_a),
            r_a,
            -r_a,
            done,
        )

    def close(self):
        pass


def scripted_biased_policy(n_actions: int, favorite: int, p: float = 0.7, seed: int = 0):
    """A fixed stochastic policy playing `favorite` with probability p —
    the exploitable opponent league tests anchor on."""
    rng = np.random.default_rng(seed)

    def act(_obs) -> int:
        if rng.random() < p:
            return favorite
        return int(rng.integers(0, n_actions))

    return act
