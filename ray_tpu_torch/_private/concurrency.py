"""Thread-affinity contracts for the runtime's concurrency model.

A copy of ``ray_tpu/_private/concurrency.py`` (the port imports nothing of
``ray_tpu``), with the same switch. The process has a small, fixed set of
thread roles:

- the **IO loop thread** (``rpc.EventLoopThread``): every socket, every RPC
  handler, every asyncio primitive lives here;
- **user threads**: the driver's threads calling the public sync API
  (``get``/``put``/``wait``/``.remote``), and ``LLMEngine``'s callers;
- the **task-exec thread** (worker processes: the MAIN thread, see
  ``worker_main._MainThreadExecutor``) running user task bodies;
- assorted daemon helpers (log resubscribe, task-event flush, raylet watch).

- ``@loop_only``  — may ONLY run on a thread with a running asyncio event
  loop (i.e. as loop callbacks / from coroutines). Calling it from any other
  thread without a ``call_soon_threadsafe``/``run_coroutine_threadsafe`` hop
  is a bug even when it happens to work today.
- ``@any_thread`` — designed to be safe from every thread role; the
  documented cross-thread entry points (they hop internally when needed).
- ``@blocking``   — blocks the calling thread (lock/event waits, blocking
  RPC round trips). Must NEVER run on the IO loop thread: every socket in
  the process stalls, and anything that waits on loop progress deadlocks.

With ``RAY_TPU_DEBUG_AFFINITY=1`` set **before import** the markers install
a cheap runtime assert; without it they return the function unchanged (zero
overhead on the hot path) and only tag it with ``__graftlint_affinity__``,
the attribute the JAX package's static checker reads. The variable keeps the
JAX package's name: it carries no state, and one switch turns the asserts on
in both runtimes.
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


def loop_only(fn):
    """Contract: ``fn`` runs only on an event-loop thread."""
    if not DEBUG_AFFINITY:
        fn.__graftlint_affinity__ = "loop_only"
        return fn

    @functools.wraps(fn)
    def _guarded(*args, **kwargs):
        assert _on_loop_thread(), (
            f"{fn.__qualname__} is @loop_only but was called from a thread "
            "with no running event loop; hop via call_soon_threadsafe / "
            "run_coroutine_threadsafe (RAY_TPU_DEBUG_AFFINITY=1)"
        )
        return fn(*args, **kwargs)

    _guarded.__graftlint_affinity__ = "loop_only"
    return _guarded


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
