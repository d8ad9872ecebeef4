"""Process-global core-worker handle (analog of the reference's global_worker
in python/ray/_private/worker.py:408)."""

from __future__ import annotations

import threading

import contextlib

_lock = threading.Lock()
_core_worker = None
# Thread-local override: the client server executes driver work on behalf of
# thin clients inside a process whose global slot may hold something else (or
# nothing) — e.g. serialization registering deserialized ObjectRefs must bind
# them to the SERVER's driver core worker.
_tls = threading.local()


def set_core_worker(cw) -> None:
    global _core_worker
    with _lock:
        _core_worker = cw


@contextlib.contextmanager
def override(cw):
    prev = getattr(_tls, "cw", None)
    _tls.cw = cw
    try:
        yield
    finally:
        _tls.cw = prev


def get_core_worker():
    cw = getattr(_tls, "cw", None) or _core_worker
    if cw is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first."
        )
    return cw


def get_core_worker_if_initialized():
    return getattr(_tls, "cw", None) or _core_worker
