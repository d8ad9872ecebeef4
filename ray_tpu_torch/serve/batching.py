"""@serve.batch — transparent request batching.

Reference: python/ray/serve/batching.py — queued requests are flushed to the
wrapped method as a list when the batch fills or the wait timeout expires.
On the card, batching is how single-request traffic reaches batch sizes the
tensor cores use well; pair it with a predictor padded to fixed batch shapes.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

# Guards lazy per-instance queue creation. Module-level (as in multiplex.py)
# so a deployment class whose method carries @serve.batch stays picklable: a
# closure-captured lock would be serialized by value with the class.
_QUEUES_LOCK = threading.Lock()


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._items: List[tuple] = []
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Timer] = None

    def submit(self, instance, item) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._items.append((instance, item, fut))
            if len(self._items) >= self._max:
                flush_now = True
            elif self._flusher is None:
                self._flusher = threading.Timer(self._wait, self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if flush_now:
            self._flush()
        return fut

    def _flush(self):
        with self._lock:
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            items, self._items = self._items, []
        if not items:
            return
        instance = items[0][0]
        batch = [item for _, item, _ in items]
        futures = [fut for _, _, fut in items]
        try:
            if instance is not None:
                results = self._fn(instance, batch)
            else:
                results = self._fn(batch)
            if len(results) != len(batch):
                raise ValueError(
                    f"@serve.batch function returned {len(results)} results "
                    f"for a batch of {len(batch)}"
                )
            for fut, res in zip(futures, results):
                fut.set_result(res)
        except Exception as e:
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01):
    """Decorator: calls with single items are batched into list calls."""

    def wrap(fn):
        # One queue per bound instance (keyed by id) — a single shared queue
        # would flush instance B's items through instance A's method.
        queues: dict = {}

        def queue_for(instance) -> _BatchQueue:
            # Resolved through the module at call time: a global read here
            # would be pickled by value with the class.
            from ray_tpu_torch.serve import batching as _b

            key = id(instance)
            with _b._QUEUES_LOCK:
                q = queues.get(key)
                if q is None:
                    q = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
                    queues[key] = q
                return q

        @functools.wraps(fn)
        def wrapper(*args):
            if len(args) == 2:  # bound method: (self, item)
                instance, item = args
            else:
                instance, item = None, args[0]
            return queue_for(instance).submit(instance, item).result(timeout=60)

        wrapper._batch_queues = queues
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
