"""Aggregation functions (reference: python/ray/data/aggregate.py —
AggregateFn with init/accumulate/merge/finalize protocol)."""

from __future__ import annotations

import math
from typing import Any, Callable, Optional


class AggregateFn:
    def __init__(
        self,
        init: Callable[[Any], Any],
        accumulate: Callable[[Any, dict], Any],
        merge: Callable[[Any, Any], Any],
        finalize: Callable[[Any], Any] = lambda a: a,
        name: str = "agg",
    ):
        self.init = init
        self.accumulate = accumulate
        self.merge = merge
        self.finalize = finalize
        self.name = name


def _val(row, on):
    v = row[on]
    return v.item() if hasattr(v, "item") else v


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda k: 0,
            accumulate=lambda a, row: a + 1,
            merge=lambda a, b: a + b,
            name="count()",
        )


class Sum(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda k: 0,
            accumulate=lambda a, row: a + _val(row, on),
            merge=lambda a, b: a + b,
            name=f"sum({on})",
        )


class Min(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda k: None,
            accumulate=lambda a, row: _val(row, on) if a is None else min(a, _val(row, on)),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            name=f"min({on})",
        )


class Max(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda k: None,
            accumulate=lambda a, row: _val(row, on) if a is None else max(a, _val(row, on)),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"max({on})",
        )


class Mean(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda k: (0.0, 0),
            accumulate=lambda a, row: (a[0] + _val(row, on), a[1] + 1),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[0] / a[1] if a[1] else float("nan"),
            name=f"mean({on})",
        )


class Std(AggregateFn):
    """Welford/Chan parallel variance (reference: aggregate.py Std)."""

    def __init__(self, on: str, ddof: int = 1):
        def accumulate(a, row):
            count, mean, m2 = a
            x = _val(row, on)
            count += 1
            delta = x - mean
            mean += delta / count
            m2 += delta * (x - mean)
            return (count, mean, m2)

        def merge(a, b):
            (na, ma, m2a), (nb, mb, m2b) = a, b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            delta = mb - ma
            return (n, ma + delta * nb / n, m2a + m2b + delta * delta * na * nb / n)

        super().__init__(
            init=lambda k: (0, 0.0, 0.0),
            accumulate=accumulate,
            merge=merge,
            finalize=lambda a: math.sqrt(a[2] / (a[0] - ddof)) if a[0] > ddof else float("nan"),
            name=f"std({on})",
        )


class AbsMax(AggregateFn):
    def __init__(self, on: str):
        super().__init__(
            init=lambda k: 0,
            accumulate=lambda a, row: max(a, abs(_val(row, on))),
            merge=lambda a, b: max(a, b),
            name=f"abs_max({on})",
        )
