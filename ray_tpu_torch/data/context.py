"""DataContext — execution configuration (reference: python/ray/data/context.py)."""

from __future__ import annotations

import threading
from typing import Optional


class DataContext:
    _instance: Optional["DataContext"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.default_parallelism: Optional[int] = None
        self.target_max_block_size: int = 128 * 1024 * 1024
        self.max_tasks_in_flight: Optional[int] = None
        self.preserve_order: bool = True
        # Push-based (3-stage map/merge/reduce) shuffle. Default off, like
        # the reference's RAY_DATA_PUSH_BASED_SHUFFLE: its reduced reducer
        # fan-in wins on wide multi-node shuffles, while the extra merge
        # tasks are overhead on a single host.
        self.use_push_based_shuffle: Optional[bool] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DataContext()
            return cls._instance
