"""Plain-int hot-path counters for the continuous-batching LLM engine.

The port's copy of ``ray_tpu/serve/llm/stats.py``. Same pattern as
``rpc.WIRE`` / ``lease_manager.LEASE_STATS``: the scheduler
loop bumps plain ints (no instrument lock per decode step); a flush-time
collector in ``_private/self_metrics.py`` folds them into the
``ray_tpu_serve_llm_*`` instruments. Gauge-shaped state (running sequences,
admission queue depth, KV-block utilization) is NOT mirrored here — the
collector computes it at flush time by summing over ``ENGINES``, the
registry of engines whose scheduler loop is still running, so several
engines in one process fold into one honest series and the gauges drop to
zero when the last engine exits instead of freezing at their final values.
"""

from __future__ import annotations

import weakref

# Engines register here at construction; the scheduler loop's exit (stop or
# crash) withdraws them. WeakSet so an abandoned engine can't pin itself.
ENGINES: "weakref.WeakSet" = weakref.WeakSet()


class _LLMStats:
    __slots__ = (
        "admitted",
        "finished",
        "cancelled",
        "preemptions",
        "prefix_hit_blocks",
        "prefix_miss_blocks",
        "evicted_blocks",
        # Disaggregated serving: completed prefill→decode KV
        # handoffs counted on the IMPORTING (decode) side, exports sealed on
        # the prefill side, and cluster-prefix-tier import attempts by
        # outcome (hit = payload landed, miss = no registry row / local
        # cache already covered it, error = row existed but the fetch
        # failed: holder dead, payload evicted, or mailbox timeout).
        "handoffs",
        "handoff_exports",
        "prefix_import_hits",
        "prefix_import_misses",
        "prefix_import_errors",
    )

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)


LLM = _LLMStats()
