"""ctypes binding for the native scheduler core (_native/sched_core.cc).

Analog of the reference's C++ scheduling substrate
(src/ray/raylet/scheduling/cluster_resource_scheduler.cc + fixed_point.h):
the raylet delegates per-task resource acquire/release, bundle pools, and
placement scoring here. Arithmetic is integer milli-units, so thousands of
fractional acquire/release cycles stay exact (float dicts drift).

The library is built with g++ into ``_native/build/`` on first use.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_native"
)
_SRC = os.path.join(_NATIVE_DIR, "sched_core.cc")
_SO = os.path.join(_NATIVE_DIR, "build", "libsched_core.so")

_lib = None
_lib_lock = threading.Lock()


def _build_native() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = _SO + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except Exception as e:
        logger.warning("native sched core build failed (%s)", e)
        return None


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build_native()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            logger.warning("native sched core load failed (%s)", e)
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.sc_create.restype = ctypes.c_int
        lib.sc_destroy.argtypes = [ctypes.c_int]
        lib.sc_intern.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.sc_intern.restype = ctypes.c_uint32
        lib.sc_node_upsert.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p, f64p]
        lib.sc_node_remove.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.sc_try_acquire.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p]
        lib.sc_try_acquire.restype = ctypes.c_int
        lib.sc_release.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p]
        lib.sc_pool_upsert.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p]
        lib.sc_pool_remove.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.sc_pool_exists.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.sc_pool_exists.restype = ctypes.c_int
        lib.sc_pool_try_acquire.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p]
        lib.sc_pool_try_acquire.restype = ctypes.c_int
        lib.sc_pool_release.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u32p, f64p]
        lib.sc_node_avail.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
        lib.sc_node_avail.restype = ctypes.c_double
        lib.sc_pool_avail.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint32]
        lib.sc_pool_avail.restype = ctypes.c_double
        lib.sc_cluster_feasibility.argtypes = [ctypes.c_int, ctypes.c_int, u32p, f64p]
        lib.sc_cluster_feasibility.restype = ctypes.c_int
        lib.sc_best_node.argtypes = [
            ctypes.c_int, ctypes.c_int, u32p, f64p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.sc_best_node.restype = ctypes.c_int
        _lib = lib
        return _lib


HYBRID, SPREAD = 0, 1


class _NativeSchedCore:
    def __init__(self, lib):
        self._lib = lib
        self._h = lib.sc_create()
        self._interned: dict[str, int] = {}

    def _vec(self, resources: dict):
        n = len(resources)
        idx = (ctypes.c_uint32 * n)()
        vals = (ctypes.c_double * n)()
        for i, (name, v) in enumerate(resources.items()):
            j = self._interned.get(name)
            if j is None:
                j = self._lib.sc_intern(self._h, name.encode())
                self._interned[name] = j
            idx[i] = j
            vals[i] = float(v)
        return n, idx, vals

    def node_upsert(self, node_id: str, total: dict, avail: dict):
        keys = {**total, **avail}
        n, idx, _ = self._vec(keys)
        tot = (ctypes.c_double * n)(*[float(total.get(k, 0)) for k in keys])
        av = (ctypes.c_double * n)(*[float(avail.get(k, 0)) for k in keys])
        self._lib.sc_node_upsert(self._h, node_id.encode(), n, idx, tot, av)

    def node_remove(self, node_id: str):
        self._lib.sc_node_remove(self._h, node_id.encode())

    def try_acquire(self, node_id: str, demand: dict) -> bool:
        n, idx, vals = self._vec(demand)
        return bool(self._lib.sc_try_acquire(self._h, node_id.encode(), n, idx, vals))

    def release(self, node_id: str, demand: dict):
        n, idx, vals = self._vec(demand)
        self._lib.sc_release(self._h, node_id.encode(), n, idx, vals)

    def pool_upsert(self, pool_key: str, caps: dict):
        n, idx, vals = self._vec(caps)
        self._lib.sc_pool_upsert(self._h, pool_key.encode(), n, idx, vals)

    def pool_remove(self, pool_key: str):
        self._lib.sc_pool_remove(self._h, pool_key.encode())

    def pool_exists(self, pool_key: str) -> bool:
        return bool(self._lib.sc_pool_exists(self._h, pool_key.encode()))

    def pool_try_acquire(self, pool_key: str, demand: dict) -> bool:
        n, idx, vals = self._vec(demand)
        return bool(self._lib.sc_pool_try_acquire(self._h, pool_key.encode(), n, idx, vals))

    def pool_release(self, pool_key: str, demand: dict):
        n, idx, vals = self._vec(demand)
        self._lib.sc_pool_release(self._h, pool_key.encode(), n, idx, vals)

    def node_avail(self, node_id: str, name: str) -> float:
        j = self._interned.get(name)
        if j is None:
            j = self._lib.sc_intern(self._h, name.encode())
            self._interned[name] = j
        return float(self._lib.sc_node_avail(self._h, node_id.encode(), j))

    def node_fits(self, node_id: str, demand: dict) -> bool:
        """Non-mutating fits-now check against a (possibly mirrored) node's
        availability — the locality-preference probe. Built over per-key
        node_avail so the native ABI stays unchanged."""
        return all(
            v <= 0 or self.node_avail(node_id, k) >= v - 1e-9
            for k, v in demand.items()
        )

    def pool_avail(self, pool_key: str, name: str) -> float:
        j = self._interned.get(name)
        if j is None:
            j = self._lib.sc_intern(self._h, name.encode())
            self._interned[name] = j
        return float(self._lib.sc_pool_avail(self._h, pool_key.encode(), j))

    def cluster_feasibility(self, demand: dict) -> int:
        n, idx, vals = self._vec(demand)
        return int(self._lib.sc_cluster_feasibility(self._h, n, idx, vals))

    def best_node(self, demand: dict, strategy: int, local_node: str) -> str | None:
        n, idx, vals = self._vec(demand)
        out = ctypes.create_string_buffer(128)
        ok = self._lib.sc_best_node(
            self._h, n, idx, vals, strategy, local_node.encode(), out, 128
        )
        return out.value.decode() if ok else None

    def close(self):
        self._lib.sc_destroy(self._h)


def create_sched_core():
    """The native core, built with g++ on first use; raises when it cannot
    be built or loaded."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(
            f"the native scheduler core ({_SRC}) could not be built or loaded"
        )
    return _NativeSchedCore(lib)
