"""The bf16 CUDA kernels (forward, dK/dV, dQ) and the f32 ones on the CPU,
under an emulation of the CUDA features they use, against their plain
versions.

The kernels run for real only on a card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``). Here g++ compiles the same sources, ``ops/csrc``, with
``tests/cuda_emulation/`` in place of the CUDA headers and of
``ptx_sm90.cuh``: each block's threads run as fibers on one host thread,
the barriers are barriers, and ldmatrix, mma.sync (m16n8k16 bf16, m16n8k8
tf32) and the shuffles exchange values through per-warp buffers by the PTX
ISA's fragment layouts; cvt.rna.tf32.f32 rounds as the card does, an mma
reads only a tf32 operand's top 19 bits and rounds its sum toward zero;
cp.async copies at once.
So this checks what the kernels compute (fragment layouts, swizzled
addresses, the diagonal split and its masks, tile bounds, ragged tails, the
online softmax, the no-LSE variant, rows with no visible key, the f32
kernels' 3xTF32 split and permuted contraction), not their timing or memory
ordering. The bars are the card's, ``attention.MATCH_TOL``.
Skips where there is no g++ that builds C++20.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as A

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"


def _emulated_sources(dst: Path) -> None:
    """ops/csrc as plain C++: launches become emu_launch calls, the dynamic
    shared memory the emulation's buffer, and ptx_sm90.cuh its emulation."""
    for src in _build.CSRC.iterdir():
        if src.suffix not in (".cu", ".cuh"):
            continue
        text = re.sub(r"(\w+)<<<", r"emu_launch(\1, ", src.read_text()).replace(">>>(", ", ")
        text = text.replace("extern __shared__ __align__(128) unsigned char smem[];", "unsigned char* smem = emu_smem;")
        (dst / src.name).write_text(text)
    shutil.copy(EMULATION / "ptx_sm90.cuh", dst / "ptx_sm90.cuh")
    (dst / "cuda_bf16.h").write_text('#include "cuda_runtime.h"\n')  # the rest of CUDA's headers
    shutil.copy(EMULATION / "cuda_runtime.h", dst / "cuda_runtime.h")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    src = tmp_path_factory.mktemp("emulated_csrc")
    _emulated_sources(src)
    objs, procs = [], []
    for cu in sorted(src.glob("*.cu")):
        obj = cu.with_suffix(".o")
        cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-fPIC", "-pthread", "-w", f"-I{src}", "-c", str(cu), "-o", str(obj)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    if any(p.returncode for p in procs):
        if any("barrier" in log and "No such file" in log for log in logs):
            pytest.skip("needs a C++20 standard library (<barrier>)")
        raise RuntimeError("g++ failed on the emulated kernels:\n" + "\n".join(logs))
    so = src / "libemulated.so"
    subprocess.run([gxx, "-shared", "-pthread", *objs, "-o", str(so)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _build._RESTYPES.get(name, ctypes.c_int)
    return lib


_CASES = [
    (1, 130, 130, 1, 128, True, 0),  # D 128, a ragged tail of 2 rows and keys
    (1, 200, 200, 2, 64, True, 0),  # two heads, [B, T, H, D] strides
    (1, 96, 256, 1, 64, True, 0),  # Tq < Tk: bottom-right offset 160
    (1, 256, 96, 1, 32, True, 0),  # Tq > Tk: rows with no visible key give 0 and LSE -inf
    (1, 300, 300, 1, 32, True, 70),  # sliding window: its left edge masked, tiles behind it skipped
    (1, 150, 190, 1, 64, False, 0),  # non-causal, ragged in both lengths
    (1, 200, 90, 1, 64, True, 0),  # Tq > Tk by 110, no multiple of 16: a warp whose rows are part blind
]
CASES = pytest.mark.parametrize("B,Tq,Tk,H,D,causal,window", _CASES)
# The f32 kernels also at the Decision Transformer's shape (the f32 path's
# user: T 60 inside one tile, D 32, two heads), at batch 2; and on rows of
# 1024 keys (and, for dK/dV, columns of 1024 queries), where a sum kept in the
# tensor cores' accumulator (which rounds toward zero) drifts to the f32 bar
# or past it.
_F32_CASES = _CASES + [(2, 60, 60, 2, 32, True, 0), (1, 64, 1024, 1, 128, False, 0)]
F32_CASES = pytest.mark.parametrize("B,Tq,Tk,H,D,causal,window", _F32_CASES)
# dK/dV sums the other way, over queries: each key of a column of 1024 rows.
F32_DKV_CASES = pytest.mark.parametrize("B,Tq,Tk,H,D,causal,window", _F32_CASES + [(1, 1024, 64, 1, 128, False, 0)])


def _case(dtype, B, Tq, Tk, H, D, causal, window):
    """Inputs, the plain results (out, lse, dq, dk, dv) and Delta."""
    rng = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(B, Tq, H, D, generator=rng).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Tk, H, D, generator=rng).to(dtype) for _ in range(2))
    scale = D**-0.5
    out_ref, lse_ref = A._plain_flash_fwd(q, k, v, causal, scale, window)
    dq_ref, dk_ref, dv_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    want = {"out": out_ref, "lse": lse_ref, "dq": dq_ref, "dk": dk_ref, "dv": dv_ref}
    sizes = (int(dtype == torch.bfloat16), B, H, Tq, Tk, D, scale, int(causal), window, None)  # is_bf16, ..., stream
    return (q, k, v, dout), want, delta, sizes


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _assert_close(got, want, dtype):
    for name, x in got.items():
        over = A.over_tolerance(A.mismatch(x, want[name]), dtype)
        assert not over, f"{name}: {over}"


def _forward_and_dkv(lib, dtype, B, Tq, Tk, H, D, causal, window):
    (q, k, v, dout), want, delta, sizes = _case(dtype, B, Tq, Tk, H, D, causal, window)
    out, out_no_lse, lse = torch.empty_like(q), torch.empty_like(q), torch.empty(B, H, Tq)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    assert lib.rtt_flash_fwd(*map(_ptr, (q, k, v, out, lse)), *sizes) == 0
    assert lib.rtt_flash_fwd(*map(_ptr, (q, k, v, out_no_lse, None)), *sizes) == 0
    assert lib.rtt_flash_bwd_dkv(*map(_ptr, (q, k, v, dout, want["lse"], delta, dk, dv)), *sizes) == 0
    assert torch.equal(out, out_no_lse), "the output depends on whether LSE is written"
    _assert_close({"out": out, "lse": lse, "dk": dk, "dv": dv}, want, dtype)


def _dq(lib, dtype, B, Tq, Tk, H, D, causal, window):
    (q, k, v, dout), want, delta, sizes = _case(dtype, B, Tq, Tk, H, D, causal, window)
    dq = torch.full_like(q, float("nan"))  # every row must be written, the ones that see no key with 0
    assert lib.rtt_flash_bwd_dq(*map(_ptr, (q, k, v, dout, want["lse"], delta, dq)), *sizes) == 0
    assert torch.isfinite(dq.float()).all()
    _assert_close({"dq": dq}, want, dtype)


@CASES
def test_emulated_bf16_kernels_match_plain(lib, B, Tq, Tk, H, D, causal, window):
    _forward_and_dkv(lib, torch.bfloat16, B, Tq, Tk, H, D, causal, window)


@CASES
def test_emulated_bf16_dq_matches_plain(lib, B, Tq, Tk, H, D, causal, window):
    _dq(lib, torch.bfloat16, B, Tq, Tk, H, D, causal, window)


@F32_DKV_CASES
def test_emulated_f32_kernels_match_plain(lib, B, Tq, Tk, H, D, causal, window):
    """The f32 forward and dK/dV (3xTF32 on mma.sync)."""
    _forward_and_dkv(lib, torch.float32, B, Tq, Tk, H, D, causal, window)


@F32_CASES
def test_emulated_f32_dq_matches_plain(lib, B, Tq, Tk, H, D, causal, window):
    """The f32 dQ (3xTF32 on mma.sync)."""
    _dq(lib, torch.float32, B, Tq, Tk, H, D, causal, window)
