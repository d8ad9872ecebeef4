"""Build the port's CUDA kernels and load them with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (``extern "C"`` functions
taking pointers, ints, a float and the stream), so they build with ``nvcc``
alone, in seconds, with no PyTorch headers and no ``ninja``. Each ``.cu``
compiles to an object in its own ``nvcc`` process, all started together, and
the objects link into one shared library:

    ray_tpu_torch/_build/libray_tpu_torch_kernels.so

The library is rebuilt only when the sources or flags change (their SHA-256
is kept beside it). The build happens at the first CUDA call, never at
import. A failed build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libray_tpu_torch_kernels.so"
# -Xptxas -v prints each kernel's registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every extern "C" function of csrc/*.cu (tests/test_torch_build.py holds this
# table to the sources): pointers and the stream as c_void_p (a plain int
# would be cut to 32 bits), ints as c_int. Each returns a cudaError_t, except
# where _RESTYPES says otherwise.
_SIGNATURES = {
    # q, k, v, out, lse | is_bf16, B, H, Tq, Tk, D | scale | causal, window | stream
    "rtt_flash_fwd": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    # q, k, v, dout, lse, delta, dk, dv | ...
    "rtt_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    # q, k, v, dout, lse, delta, dq | ...
    "rtt_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F] + [_I] * 2 + [_P],
    # D, info[5]: registers, shared memory, blocks per SM, threads, local bytes
    "rtt_flash_fwd_info": [_I, _P],
    # kernel (0 dK/dV, 1 dQ), D, info[5]
    "rtt_flash_bwd_info": [_I, _I, _P],
    "rtt_error_string": [_I],
}
_RESTYPES = {"rtt_error_string": ctypes.c_char_p}


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: Path
    log: str  # nvcc's output for this build ("" when the library was cached)
    seconds: float  # wall time of the build (0.0 when cached)

    def check(self, code: int, what: str) -> None:
        """Raise if an entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib.rtt_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

    def info(self, kernel: str, D: int) -> dict[str, int]:
        """Resources of a bf16 kernel ("flash_fwd", "flash_bwd_dkv" or
        "flash_bwd_dq") at head width D on the current device: registers per
        thread, shared memory per block, blocks per SM, threads per block and
        local (spilled) bytes per thread."""
        out = (ctypes.c_int * 5)()
        if kernel == "flash_fwd":
            code = self.lib.rtt_flash_fwd_info(D, out)
        else:
            code = self.lib.rtt_flash_bwd_info(("flash_bwd_dkv", "flash_bwd_dq").index(kernel), D, out)
        self.check(code, f"{kernel} info")
        return dict(zip(("regs", "smem_bytes", "blocks_per_sm", "threads", "local_bytes"), out))


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or at /usr/local/cuda/bin): cannot build the CUDA kernels")
    return nvcc


def _compile(csrc: Path, out: Path) -> str:
    """Compile every source in `csrc` in parallel and link them into `out`.
    Returns nvcc's combined output; raises with it if any step fails."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in sorted(csrc.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *(str(obj) for _, obj, _ in procs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees the old or the new file
    return "\n".join(logs)


def edited_copy(dst: Path, edits=()) -> Path:
    """Copy the kernel sources into `dst` (made if missing), applying `edits`:
    (file, old, new) replacements, each `old` found exactly once in its
    file. Returns `dst`, ready for build_and_load."""
    dst.mkdir(parents=True, exist_ok=True)
    texts = {src.name: src.read_text() for src in CSRC.iterdir() if src.suffix in (".cu", ".cuh")}
    for file, old, new in edits:
        if texts[file].count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {file} exactly once")
        texts[file] = texts[file].replace(old, new)
    for name, text in texts.items():
        (dst / name).write_text(text)
    return dst


@functools.cache
def load_kernels() -> Kernels:
    """Build (if the sources changed) and load the kernel library."""
    return build_and_load(CSRC, BUILD_DIR)


def build_and_load(csrc: Path, build_dir: Path) -> Kernels:
    """Build the sources in `csrc` into `build_dir` (unless the library there
    was built from the same sources and flags) and load the library."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    digest = _digest(csrc)
    log, seconds = "", 0.0
    if not (lib_path.exists() and stamp.exists() and stamp.read_text() == digest):
        t0 = time.perf_counter()
        log = _compile(csrc, lib_path)
        seconds = time.perf_counter() - t0
        stamp.write_text(digest)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return Kernels(lib=lib, path=lib_path, log=log, seconds=seconds)
