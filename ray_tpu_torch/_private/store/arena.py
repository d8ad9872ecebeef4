"""ctypes binding for the native shm arena (ray_tpu_torch/_native/shm_arena.cc).

The native library is built on demand with g++ and cached next to the source.
A pure-Python fallback over ``multiprocessing.shared_memory`` keeps the store
functional if no compiler is available (e.g. stripped containers).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "_native")
_SRC = os.path.join(_NATIVE_DIR, "shm_arena.cc")
_SO = os.path.join(_NATIVE_DIR, "build", "libshm_arena.so")

_lib = None
_lib_lock = threading.Lock()


def _build_native() -> str | None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = _SO + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp, "-lrt", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except Exception as e:
        logger.warning("native shm arena build failed (%s); using Python fallback", e)
        return None


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = _build_native()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.arena_create.restype = ctypes.c_int
        lib.arena_attach.argtypes = [ctypes.c_char_p]
        lib.arena_attach.restype = ctypes.c_int
        lib.arena_capacity.argtypes = [ctypes.c_int]
        lib.arena_capacity.restype = ctypes.c_uint64
        lib.arena_base.argtypes = [ctypes.c_int]
        lib.arena_base.restype = ctypes.c_void_p
        lib.arena_alloc.argtypes = [ctypes.c_int, ctypes.c_uint64]
        lib.arena_alloc.restype = ctypes.c_uint64
        lib.arena_free.argtypes = [ctypes.c_int, ctypes.c_uint64]
        lib.arena_free.restype = ctypes.c_int
        lib.arena_used.argtypes = [ctypes.c_int]
        lib.arena_used.restype = ctypes.c_uint64
        lib.arena_largest_free.argtypes = [ctypes.c_int]
        lib.arena_largest_free.restype = ctypes.c_uint64
        lib.arena_close.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.arena_close.restype = ctypes.c_int
        _lib = lib
        return _lib


UINT64_MAX = (1 << 64) - 1


class NativeArena:
    """Owner-or-attacher view of the node's shared-memory arena."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native arena unavailable")
        self._lib = lib
        self.name = name
        if create:
            self.handle = lib.arena_create(name.encode(), capacity)
        else:
            self.handle = lib.arena_attach(name.encode())
        if self.handle < 0:
            raise RuntimeError(f"arena_{'create' if create else 'attach'}({name}) failed")
        self.capacity = lib.arena_capacity(self.handle)
        base = lib.arena_base(self.handle)
        self._buf = (ctypes.c_char * self.capacity).from_address(base)
        self.view = memoryview(self._buf).cast("B")
        self.is_owner = create
        self._closed = False

    def alloc(self, size: int) -> int | None:
        off = self._lib.arena_alloc(self.handle, size)
        return None if off == UINT64_MAX else off

    def free(self, offset: int):
        self._lib.arena_free(self.handle, offset)

    def used(self) -> int:
        return self._lib.arena_used(self.handle)

    def largest_free(self) -> int:
        return self._lib.arena_largest_free(self.handle)

    def read(self, offset: int, size: int) -> memoryview:
        return self.view[offset : offset + size]

    def write(self, offset: int, data) -> None:
        size = len(data)
        self.view[offset : offset + size] = data

    def close(self, unlink: bool = False):
        if self._closed:
            return
        self._closed = True
        view, self.view = self.view, None
        buf, self._buf = self._buf, None
        if view is not None:
            view.release()
        del buf
        self._lib.arena_close(self.handle, 1 if unlink else 0)


class PyArena:
    """Fallback arena over multiprocessing.shared_memory (same interface)."""

    def __init__(self, name: str, capacity: int = 0, create: bool = False):
        from multiprocessing import shared_memory

        if create:
            try:
                shared_memory.SharedMemory(name=name, create=False).unlink()
            except FileNotFoundError:
                pass
            self._shm = shared_memory.SharedMemory(name=name, create=True, size=capacity)
        else:
            self._shm = shared_memory.SharedMemory(name=name, create=False)
        # Keep the segment alive even if the resource tracker complains.
        self.name = name
        self.capacity = self._shm.size
        self.view = self._shm.buf
        self.is_owner = create
        self._free: dict[int, int] = {0: self.capacity}
        self._alloc: dict[int, int] = {}
        self._used = 0
        self._lock = threading.Lock()
        self._closed = False

    def alloc(self, size: int) -> int | None:
        need = (size + 63) & ~63
        with self._lock:
            for off in sorted(self._free):
                blk = self._free[off]
                if blk >= need:
                    del self._free[off]
                    if blk > need:
                        self._free[off + need] = blk - need
                    self._alloc[off] = need
                    self._used += need
                    return off
        return None

    def free(self, offset: int):
        with self._lock:
            size = self._alloc.pop(offset, None)
            if size is None:
                return
            self._used -= size
            self._free[offset] = size
            # coalesce
            offs = sorted(self._free)
            merged: dict[int, int] = {}
            for off in offs:
                sz = self._free[off]
                if merged:
                    last = max(merged)
                    if last + merged[last] == off:
                        merged[last] += sz
                        continue
                merged[off] = sz
            self._free = merged

    def used(self) -> int:
        return self._used

    def largest_free(self) -> int:
        with self._lock:
            return max(self._free.values(), default=0)

    def read(self, offset: int, size: int) -> memoryview:
        return self.view[offset : offset + size]

    def write(self, offset: int, data) -> None:
        self.view[offset : offset + len(data)] = data

    def close(self, unlink: bool = False):
        if self._closed:
            return
        self._closed = True
        self.view = None
        try:
            self._shm.close()
            if unlink:
                self._shm.unlink()
        except Exception:
            pass


def create_arena(name: str, capacity: int):
    try:
        return NativeArena(name, capacity, create=True)
    except Exception:
        return PyArena(name, capacity, create=True)


def attach_arena(name: str):
    try:
        return NativeArena(name, create=False)
    except Exception:
        return PyArena(name, create=False)
