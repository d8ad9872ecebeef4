"""ctypes binding for the native shm object index (shm_index.cc).

Daemon (raylet) publishes object states; clients resolve local sealed
objects with atomic loads — no RPC on the local-get fast path. Returns None
from ``create/attach`` when the native library is unavailable; all callers
treat a missing index as "always miss" and use the RPC path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "_native"
)
_SRC = os.path.join(_NATIVE_DIR, "shm_index.cc")
_SO = os.path.join(_NATIVE_DIR, "build", "libshm_index.so")

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            have_so = os.path.exists(_SO)
            # Rebuild only when the source exists and is newer; a prebuilt
            # .so without the .cc (wheel packaging) is used as-is.
            stale = (
                os.path.exists(_SRC)
                and (not have_so or os.path.getmtime(_SO) < os.path.getmtime(_SRC))
            )
            if stale:
                tmp = _SO + f".tmp{os.getpid()}"
                cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp, "-lrt", "-lpthread"]
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
            elif not have_so:
                logger.warning("no shm index source or prebuilt library; RPC-only gets")
                return None
        except Exception as e:
            logger.warning("native shm index build failed (%s); RPC-only gets", e)
            return None
        lib = ctypes.CDLL(_SO)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.idx_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.idx_create.restype = ctypes.c_int
        lib.idx_attach.argtypes = [ctypes.c_char_p]
        lib.idx_attach.restype = ctypes.c_int
        lib.idx_put.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.idx_put.restype = ctypes.c_int
        lib.idx_seal.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.idx_seal.restype = ctypes.c_int
        lib.idx_remove.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.idx_remove.restype = ctypes.c_int
        lib.idx_readers.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.idx_readers.restype = ctypes.c_uint32
        lib.idx_get_pinned.argtypes = [ctypes.c_int, ctypes.c_char_p, u64p, u64p, u32p, u64p]
        lib.idx_get_pinned.restype = ctypes.c_int
        lib.idx_release.argtypes = [ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32]
        lib.idx_release.restype = ctypes.c_int
        lib.idx_close.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.idx_close.restype = ctypes.c_int
        _lib = lib
        return _lib


def _key(object_id_hex: str) -> bytes:
    return bytes.fromhex(object_id_hex)


class ShmIndex:
    def __init__(self, lib, handle: int, name: str, owner: bool):
        self._lib = lib
        self._h = handle
        self.name = name
        self.owner = owner
        self._closed = False

    # -- daemon side ----------------------------------------------------
    def put(self, object_id_hex: str, offset: int, size: int) -> bool:
        return self._lib.idx_put(self._h, _key(object_id_hex), offset, size) == 0

    def seal(self, object_id_hex: str) -> bool:
        return self._lib.idx_seal(self._h, _key(object_id_hex)) == 0

    def remove(self, object_id_hex: str) -> int:
        """0 = removed (free now), 1 = busy (defer free), -1 = not found."""
        return self._lib.idx_remove(self._h, _key(object_id_hex))

    def readers(self, object_id_hex: str) -> int:
        return self._lib.idx_readers(self._h, _key(object_id_hex))

    # -- client side ----------------------------------------------------
    def get_pinned(self, object_id_hex: str) -> tuple[int, int, tuple] | None:
        """(offset, size, pin_token) on hit; None on miss. Pass the token to
        ``release`` exactly once."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        ver = ctypes.c_uint32()
        slot = ctypes.c_uint64()
        hit = self._lib.idx_get_pinned(
            self._h,
            _key(object_id_hex),
            ctypes.byref(off),
            ctypes.byref(size),
            ctypes.byref(ver),
            ctypes.byref(slot),
        )
        if not hit:
            return None
        return off.value, size.value, (slot.value, ver.value)

    def release(self, token: tuple):
        if self._closed:  # a pinned view collected after the client closed
            return
        slot, version = token
        self._lib.idx_release(self._h, slot, version)

    def close(self, unlink: bool = False):
        if self._closed:
            return
        self._closed = True
        self._lib.idx_close(self._h, 1 if unlink else 0)


def create_index(name: str, nslots: int = 65536) -> ShmIndex | None:
    lib = _load_lib()
    if lib is None:
        return None
    h = lib.idx_create(name.encode(), nslots)
    if h < 0:
        logger.warning("idx_create(%s) failed; RPC-only gets", name)
        return None
    return ShmIndex(lib, h, name, owner=True)


def attach_index(name: str) -> ShmIndex | None:
    lib = _load_lib()
    if lib is None:
        return None
    h = lib.idx_attach(name.encode())
    if h < 0:
        return None
    return ShmIndex(lib, h, name, owner=False)
