"""Two-player zero-sum board-game envs for tree-search self-play.

Reference: the reference's LeelaChessZero (rllib/algorithms/leela_chess_zero/
leela_chess_zero.py) binds AlphaZero-style MCTS self-play to chess via a
MultiAgentEnv wrapper around python-chess. The algorithm only needs a
board protocol: alternating moves, legal-action masks, state clone/restore
for search simulations, terminal outcome from the mover's perspective.
This module defines that protocol plus TicTacToe (the in-tree test board —
chess itself needs an external move-generator the image doesn't carry; any
env implementing BoardGameEnv plugs into the same algorithm).

The JAX package's ``rllib/env/board_env.py`` as it is, on the port's own
spaces (``env/spaces.py``), so it needs no gymnasium.

Protocol:
    obs = env.reset() -> observation from the CURRENT player's perspective
    obs, reward, done = env.step(action)
        reward is from the perspective of the player WHO JUST MOVED
        (+1 win, 0 draw/ongoing); after step, obs flips to the next player.
    env.legal_actions() -> bool mask [n_actions]
    env.get_state() / env.set_state(s) -> search simulation support
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.env.spaces import Box, Discrete

_WIN_LINES = [
    (0, 1, 2), (3, 4, 5), (6, 7, 8),
    (0, 3, 6), (1, 4, 7), (2, 5, 8),
    (0, 4, 8), (2, 4, 6),
]


class BoardGameEnv:
    """Protocol base; see module docstring."""

    observation_space: Box
    action_space: Discrete

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        raise NotImplementedError

    def legal_actions(self) -> np.ndarray:
        raise NotImplementedError

    def observe(self) -> np.ndarray:
        """Current position from the current player's perspective (search
        needs to re-observe after set_state)."""
        raise NotImplementedError

    def get_state(self):
        raise NotImplementedError

    def set_state(self, state) -> None:
        raise NotImplementedError

    def close(self):
        pass


class TicTacToeEnv(BoardGameEnv):
    """3x3 tic-tac-toe. Observation: 9 cells from the current player's
    perspective (+1 mine, -1 opponent's, 0 empty)."""

    def __init__(self, config: Optional[dict] = None):
        self.observation_space = Box(-1.0, 1.0, (9,), np.float32)
        self.action_space = Discrete(9)
        self._board = np.zeros(9, np.int8)  # +1 = player0, -1 = player1
        self._player = 1  # +1 moves first

    def _obs(self) -> np.ndarray:
        return (self._board * self._player).astype(np.float32)

    def reset(self) -> np.ndarray:
        self._board = np.zeros(9, np.int8)
        self._player = 1
        return self._obs()

    def legal_actions(self) -> np.ndarray:
        return self._board == 0

    def observe(self) -> np.ndarray:
        return self._obs()

    def step(self, action: int):
        assert self._board[action] == 0, f"illegal move {action}"
        self._board[action] = self._player
        mover = self._player
        for a, b, c in _WIN_LINES:
            if self._board[a] == self._board[b] == self._board[c] == mover:
                self._player = -mover
                return self._obs(), 1.0, True
        self._player = -mover
        if not (self._board == 0).any():
            return self._obs(), 0.0, True  # draw
        return self._obs(), 0.0, False

    def get_state(self):
        return (self._board.copy(), self._player)

    def set_state(self, state) -> None:
        board, player = state
        self._board = board.copy()
        self._player = player
