"""``Box`` and ``Discrete`` spaces of the port's own.

The JAX package takes its spaces from gymnasium, which the card's machine
need not have. These two carry what the port reads of a space (``shape``,
``dtype``, ``low``/``high``, ``n``) and what its envs call (``contains``,
``sample``, ``seed``), with gymnasium's semantics. Code that reads a space
(``RLModuleSpec.from_spaces``) duck-types it, so gymnasium's own spaces
work there too.
"""

from __future__ import annotations

import numpy as np


class Space:
    def __init__(self, shape, dtype, seed=None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._np_random = None
        if seed is not None:
            self.seed(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed()
        return self._np_random

    def seed(self, seed: int | None = None):
        self._np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        return [seed]


class Discrete(Space):
    """{start, ..., start + n - 1} (gymnasium.spaces.Discrete)."""

    def __init__(self, n: int, seed=None, start: int = 0):
        assert int(n) > 0, "n must be positive"
        self.n = np.int64(n)
        self.start = np.int64(start)
        super().__init__((), np.int64, seed)

    def contains(self, x) -> bool:
        if isinstance(x, int):
            as_np = self.dtype.type(x)
        elif isinstance(x, (np.generic, np.ndarray)) and np.issubdtype(x.dtype, np.integer) and x.shape == ():
            as_np = x
        else:
            return False
        return bool(self.start <= as_np < self.start + self.n) and np.can_cast(as_np.dtype, self.dtype)

    def sample(self):
        return self.start + self.np_random.integers(self.n)

    def __repr__(self) -> str:
        return f"Discrete({self.n})" if self.start == 0 else f"Discrete({self.n}, start={self.start})"


class Box(Space):
    """A box in R^n, each coordinate bounded by [low, high] (gymnasium.spaces.Box)."""

    def __init__(self, low, high, shape=None, dtype=np.float32, seed=None):
        dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.low = np.broadcast_to(np.asarray(low, dtype), shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype), shape).copy()
        super().__init__(shape, dtype, seed)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high))

    def sample(self):
        """gymnasium's draw for a float box: uniform where bounded on both
        sides, exponential from the one bound where bounded on one, normal
        where unbounded (the same draws for the same seed)."""
        below, above = self.low > -np.inf, self.high < np.inf
        sample = np.empty(self.shape)
        unbounded, upp, low_b, both = ~below & ~above, ~below & above, below & ~above, below & above
        sample[unbounded] = self.np_random.normal(size=unbounded[unbounded].shape)
        sample[low_b] = self.np_random.exponential(size=low_b[low_b].shape) + self.low[low_b]
        sample[upp] = -self.np_random.exponential(size=upp[upp].shape) + self.high[upp]
        sample[both] = self.np_random.uniform(low=self.low[both], high=self.high[both], size=both[both].shape)
        return sample.astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"
