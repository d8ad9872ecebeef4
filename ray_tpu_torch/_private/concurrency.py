"""Thread-affinity contracts for the port's concurrency model.

From ``ray_tpu/_private/concurrency.py`` (the port imports nothing of
``ray_tpu``): the two markers the port's code carries, with the same switch.
(``@loop_only`` is not copied: the port has no event-loop code yet.)

- ``@any_thread`` — designed to be safe from every thread role; the
  documented cross-thread entry points (``LLMEngine.submit``/``cancel``).
- ``@blocking``   — blocks the calling thread (lock/event waits). Must never
  run on an event-loop thread: anything that waits on loop progress
  deadlocks.

With ``RAY_TPU_DEBUG_AFFINITY=1`` set **before import** the markers install
a cheap runtime assert; without it they return the function unchanged (zero
overhead on the hot path) and only tag it with ``__graftlint_affinity__``,
the attribute the JAX package's static checker reads.
"""

from __future__ import annotations

import asyncio
import functools
import os

DEBUG_AFFINITY = os.environ.get("RAY_TPU_DEBUG_AFFINITY") == "1"


def _on_loop_thread() -> bool:
    """True iff the current thread has a RUNNING asyncio loop — i.e. we are
    executing a loop callback or a coroutine step (``get_running_loop`` is
    set for the whole ``run_forever``, including sync callbacks)."""
    try:
        asyncio.get_running_loop()
        return True
    except RuntimeError:
        return False


def any_thread(fn):
    """Contract: ``fn`` is a documented cross-thread entry point."""
    fn.__graftlint_affinity__ = "any_thread"
    return fn


def blocking(fn):
    """Contract: ``fn`` blocks the calling thread and must never run on an
    event-loop thread."""
    if not DEBUG_AFFINITY:
        fn.__graftlint_affinity__ = "blocking"
        return fn

    @functools.wraps(fn)
    def _guarded(*args, **kwargs):
        assert not _on_loop_thread(), (
            f"{fn.__qualname__} is @blocking (stalls the calling thread) but "
            "was called on an event-loop thread; move it off-loop with "
            "run_in_executor (RAY_TPU_DEBUG_AFFINITY=1)"
        )
        return fn(*args, **kwargs)

    _guarded.__graftlint_affinity__ = "blocking"
    return _guarded
