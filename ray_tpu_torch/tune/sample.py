"""Search-space domains (analog of reference python/ray/tune/search/sample.py
— Categorical/Float/Integer domains with .uniform/.loguniform/.quantized
samplers — and tune.grid_search / tune.sample_from markers).

A param_space dict may contain, at any nesting depth:
- Domain instances (``tune.choice/uniform/loguniform/randint/qrandint/...``)
- ``tune.grid_search([...])`` markers — expanded as a cross-product
- ``tune.sample_from(lambda spec: ...)`` — resolved last, sees sampled values
- plain values — passed through
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Sequence


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)

    def __repr__(self):
        return f"choice({self.categories!r})"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: float | None = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(round(v / self.q) * self.q, 10)
        return min(max(v, self.lower), self.upper)

    def __repr__(self):
        kind = "loguniform" if self.log else "uniform"
        return f"{kind}({self.lower}, {self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False, q: int = 1):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng):
        if self.log:
            v = int(math.exp(rng.uniform(math.log(max(self.lower, 1)), math.log(self.upper))))
        else:
            v = rng.randint(self.lower, self.upper - 1) if self.upper > self.lower else self.lower
        if self.q > 1:
            v = int(round(v / self.q) * self.q)
        return min(max(v, self.lower), self.upper - 1 if self.upper > self.lower else self.lower)

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class GridSearch:
    """Marker for exhaustive expansion (``tune.grid_search``)."""

    def __init__(self, values: Sequence):
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values!r})"


class SampleFrom:
    """Lazily-evaluated callable domain (``tune.sample_from``). The callable
    receives a ``spec`` object with attribute ``config`` = the partially
    resolved config dict."""

    def __init__(self, func: Callable):
        self.func = func


# -- public constructors (tune.choice etc.) ---------------------------------

def choice(categories: Sequence) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def randn(mean: float = 0.0, sd: float = 1.0) -> "SampleFrom":
    return SampleFrom(lambda spec, m=mean, s=sd: random.gauss(m, s))


def grid_search(values: Sequence) -> GridSearch:
    return GridSearch(values)


def sample_from(func: Callable) -> SampleFrom:
    return SampleFrom(func)


# -- resolution --------------------------------------------------------------

class _Spec:
    def __init__(self, config):
        self.config = config


def grid_axes(space: dict, prefix: tuple = ()) -> list[tuple[tuple, list]]:
    """Collect (key-path, values) for every GridSearch in the space."""
    axes = []
    for k, v in space.items():
        if isinstance(v, GridSearch):
            axes.append((prefix + (k,), v.values))
        elif isinstance(v, dict):
            axes.extend(grid_axes(v, prefix + (k,)))
    return axes


def resolve(space: dict, rng: random.Random, grid_assignment: dict | None = None) -> dict:
    """Materialise one concrete config: apply grid assignment, sample Domains,
    then evaluate SampleFrom callables against the partially-built config."""
    grid_assignment = grid_assignment or {}
    deferred: list[tuple[tuple, SampleFrom]] = []

    def build(node: dict, prefix: tuple) -> dict:
        out = {}
        for k, v in node.items():
            path = prefix + (k,)
            if path in grid_assignment:
                out[k] = grid_assignment[path]
            elif isinstance(v, GridSearch):
                out[k] = v.values[0]
            elif isinstance(v, Domain):
                out[k] = v.sample(rng)
            elif isinstance(v, SampleFrom):
                out[k] = None
                deferred.append((path, v))
            elif isinstance(v, dict):
                out[k] = build(v, path)
            else:
                out[k] = v
        return out

    config = build(space, ())
    for path, sf in deferred:
        node = config
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = sf.func(_Spec(config))
    return config
