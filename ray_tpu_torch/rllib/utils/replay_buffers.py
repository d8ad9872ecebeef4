"""Replay buffers (reference: rllib/utils/replay_buffers/replay_buffer.py and
prioritized_replay_buffer.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO replay buffer over SampleBatch rows."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: dict = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch):
        n = batch.count
        if not self._cols:
            for k, v in batch.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], dtype=v.dtype)
        start = self._next
        first = min(n, self.capacity - start)
        for k, v in batch.items():
            self._cols[k][start : start + first] = v[:first]
            if first < n:
                self._cols[k][: n - first] = v[first:]
        self._next = (start + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_replay_buffer.py) with importance-sampling weights."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6, beta: float = 0.4, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, dtype=np.float64)
        self._max_priority = 1.0
        self._last_idx: Optional[np.ndarray] = None

    def add(self, batch: SampleBatch):
        n = batch.count
        start = self._next
        super().add(batch)
        first = min(n, self.capacity - start)
        self._priorities[start : start + first] = self._max_priority
        if first < n:
            self._priorities[: n - first] = self._max_priority

    def sample(self, num_items: int) -> SampleBatch:
        prios = self._priorities[: self._size] ** self.alpha
        probs = prios / prios.sum()
        idx = self._rng.choice(self._size, num_items, p=probs)
        weights = (self._size * probs[idx]) ** (-self.beta)
        weights = weights / weights.max()
        self._last_idx = idx
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, td_errors: np.ndarray, eps: float = 1e-6):
        assert self._last_idx is not None
        self.update_priorities_at(self._last_idx, td_errors, eps)

    # Explicit-index variants: distributed consumers (Ape-X replay shards)
    # interleave sampling rounds, so the implicit last-sample protocol above
    # cannot be relied on across calls.
    def sample_with_indices(self, num_items: int):
        out = self.sample(num_items)
        return out, np.asarray(self._last_idx)

    def update_priorities_at(self, idx: np.ndarray, td_errors: np.ndarray, eps: float = 1e-6):
        prios = np.abs(np.asarray(td_errors)) + eps
        self._priorities[np.asarray(idx)] = prios
        self._max_priority = max(self._max_priority, float(prios.max()))


class ColumnReplayBuffer:
    """Flat columnar ring buffer for dict transitions: arrays are allocated
    lazily from the first item's shapes/dtypes, writes wrap around, sampling
    is uniform. Shared by MADDPG and SlateQ (their transitions are nested
    fixed-shape dicts rather than SampleBatch rows)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._data: dict | None = None
        self._n = 0
        self._pos = 0
        self._rng = np.random.default_rng(seed)

    def add(self, item: dict):
        if self._data is None:
            self._data = {
                k: np.zeros((self.capacity,) + np.asarray(v).shape, np.asarray(v).dtype)
                for k, v in item.items()
            }
        for k, v in item.items():
            self._data[k][self._pos] = v
        self._pos = (self._pos + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def __len__(self):
        return self._n

    def sample(self, n: int) -> dict:
        if self._n == 0:
            raise ValueError(
                "ColumnReplayBuffer.sample() on an empty buffer; add() at "
                "least one item first (callers usually gate on learning_starts)"
            )
        idx = self._rng.integers(0, self._n, n)
        return {k: v[idx] for k, v in self._data.items()}
