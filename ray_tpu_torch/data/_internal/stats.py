"""Per-operator execution statistics.

Analog of the reference's DatasetStats (python/ray/data/_internal/
stats.py:117): every executed operator records wall time, task count and
output blocks/rows/bytes; ``Dataset.stats()`` renders the per-op summary
the reference prints after execution, and the raw objects are exposed for
programmatic access (dashboards, tests).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class OpStats:
    name: str
    start: float | None = None
    end: float | None = None
    num_tasks: int = 0
    blocks: int = 0
    rows: int = 0
    size_bytes: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        if self.start is None:
            return 0.0
        return (self.end or time.perf_counter()) - self.start

    def mark_start(self):
        if self.start is None:
            self.start = time.perf_counter()

    def record_output(self, meta):
        self.end = time.perf_counter()
        self.blocks += 1
        rows = max(0, getattr(meta, "num_rows", 0) or 0)
        size = max(0, getattr(meta, "size_bytes", 0) or 0)
        self.rows += rows
        self.size_bytes += size
        # Runtime metrics: per-op rows/bytes/blocks flow to /metrics under
        # the ray_tpu_data_* family (one inc per block, not per row).
        try:
            from ray_tpu_torch._private import self_metrics

            inst = self_metrics.instruments()
            tags = {"op": self.name}
            inst["data_blocks"].inc(tags=tags)
            if rows:
                inst["data_rows"].inc(rows, tags=tags)
            if size:
                inst["data_bytes"].inc(size, tags=tags)
        except Exception:
            pass

    def line(self, index: int) -> str:
        return (
            f"Operator {index} {self.name}: {self.num_tasks} tasks, "
            f"{self.blocks} blocks, {self.rows} rows, {self.size_bytes} bytes "
            f"in {self.wall_s:.2f}s"
        )


class DatasetStats:
    def __init__(self, op_stats: list[OpStats] | None = None):
        self.op_stats = op_stats or []

    def summary_string(self, totals: str = "") -> str:
        lines = [s.line(i + 1) for i, s in enumerate(self.op_stats)]
        if totals:
            lines.append(totals)
        return "\n".join(lines) if lines else "Dataset: not executed"
