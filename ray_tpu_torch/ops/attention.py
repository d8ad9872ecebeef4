"""Flash attention for the port: hand-written CUDA kernels for Hopper.

Counterpart of ``ray_tpu/ops/attention.py``. The three Pallas TPU kernels
there become three CUDA C++ kernels for sm_90a:

- ``csrc/flash_fwd.cu``: the forward (``_flash_kernel``), with optional LSE.
- ``csrc/flash_bwd.cu``: dK/dV (``_flash_bwd_dkv_kernel``) and dQ
  (``_flash_bwd_dq_kernel``).

``flash_attention`` keeps the JAX package's ``[B, T, H, D]`` layout and
masks: causal aligned bottom-right (query row i sees keys <= i + Tk - Tq) and
an optional sliding window (row i sees keys in (i - window, i]). A
``torch.autograd.Function`` takes the place of the ``_pallas_flash``
custom_vjp; its forward saves the LSE and its backward runs the two backward
kernels.

Dispatch is by device only: on a CUDA tensor each wrapper launches its kernel
(or raises), on a CPU tensor it runs the kernel's plain PyTorch version
beside it. So the CPU tests drive the same Function as the card. Each wrapper
counts its launches (``launch_counts``), so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import math

import torch

# Launches of each CUDA kernel since the last reset_launch_counts().
flash_fwd_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_launches = 0

HEAD_DIMS = (32, 64, 128)  # head widths the kernels are built for
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_bwd_dkv_launches, flash_bwd_dq_launches
    flash_fwd_launches = flash_bwd_dkv_launches = flash_bwd_dq_launches = 0


def launch_counts() -> dict[str, int]:
    return {
        "flash_fwd": flash_fwd_launches,
        "flash_bwd_dkv": flash_bwd_dkv_launches,
        "flash_bwd_dq": flash_bwd_dq_launches,
    }


# --- plain versions -----------------------------------------------------------


def _visible(Tq: int, Tk: int, causal: bool, window: int, device) -> torch.Tensor | None:
    """[Tq, Tk] bool mask of the keys each query row sees (None: all)."""
    if not causal:
        return None
    q_pos = (Tk - Tq) + torch.arange(Tq, device=device)[:, None]
    k_pos = torch.arange(Tk, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    return mask


def _scores(q, k, causal, sm_scale, window, bias=None):
    """f32 scores [B, H, Tq, Tk], masked to -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias
    mask = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    return s


def _probs(s, lse):
    """P = exp(S - lse); a row with no visible key (lse = -inf) gives 0."""
    return torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])


def _plain_flash_fwd(q, k, v, causal: bool, sm_scale: float, window: int, bias=None):
    """Plain version of the forward kernel: (out [B,Tq,H,D] in q's dtype,
    lse [B,H,Tq] f32). Mirrors ray_tpu's ``_xla_attention`` in f32, plus the
    LSE; a fully masked row gives 0 where the reference gives NaN."""
    s = _scores(q, k, causal, sm_scale, window, bias)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", _probs(s, lse), v.float())
    return out.to(q.dtype).contiguous(), lse


def _plain_flash_bwd(q, k, v, out, lse, dout, causal: bool, sm_scale: float, window: int):
    """Plain version of the two backward kernels: (dq, dk, dv) with P rebuilt
    from the LSE, in f32, each cast to its input's dtype."""
    p = _probs(_scores(q, k, causal, sm_scale, window), lse)
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)  # [B, H, Tq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return tuple(g.to(x.dtype).contiguous() for g, x in ((dq, q), (dk, k), (dv, v)))


# --- CUDA kernels -------------------------------------------------------------


def _check_cuda(q, k, v, *more):
    """Validate what the kernels take; returns (B, H, Tq, Tk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] tensors")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the CUDA kernels (supported: {HEAD_DIMS})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported by the CUDA kernels (supported: {_DTYPES})")
    if min(B, H, Tq, Tk) < 1 or B * H > 65535:
        raise ValueError(f"unsupported sizes B={B} H={H} Tq={Tq} Tk={Tk}")
    for t in (q, k, v, *more):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("all inputs must be on one CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("inputs must be contiguous and 16-byte aligned")
    return B, H, Tq, Tk, D


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, window: int, save_lse: bool):
    """Launch the forward kernel: (out, lse or None)."""
    global flash_fwd_launches
    from ray_tpu_torch.ops._build import load_kernels

    B, H, Tq, Tk, D = _check_cuda(q, k, v)
    kernels = load_kernels()
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) if save_lse else None
    with torch.cuda.device(q.device):
        code = kernels.lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if save_lse else None,
            int(q.dtype == torch.bfloat16), B, H, Tq, Tk, D, float(sm_scale),
            int(causal), int(window), _stream(q))
    kernels.check(code, "flash_fwd")
    flash_fwd_launches += 1
    return out, lse


def _check_rows(lse, delta, B, H, Tq, device):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Tq) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be a contiguous f32 [B, H, Tq] tensor on q's device")


def _bwd_args(q, k, v, dout, lse, delta, causal, sm_scale, window):
    B, H, Tq, Tk, D = _check_cuda(q, k, v, dout)
    _check_rows(lse, delta, B, H, Tq, q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr())
    rest = (int(q.dtype == torch.bfloat16), B, H, Tq, Tk, D, float(sm_scale), int(causal), int(window), _stream(q))
    return ins, rest


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, window: int):
    """Launch the dK/dV kernel: (dk, dv). ``delta`` = rowsum(dO * O), f32 [B, H, Tq]."""
    global flash_bwd_dkv_launches
    from ray_tpu_torch.ops._build import load_kernels

    ins, rest = _bwd_args(q, k, v, dout, lse, delta, causal, sm_scale, window)
    kernels = load_kernels()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = kernels.lib.rtt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *rest)
    kernels.check(code, "flash_bwd_dkv")
    flash_bwd_dkv_launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, sm_scale: float, window: int):
    """Launch the dQ kernel: dq."""
    global flash_bwd_dq_launches
    from ray_tpu_torch.ops._build import load_kernels

    ins, rest = _bwd_args(q, k, v, dout, lse, delta, causal, sm_scale, window)
    kernels = load_kernels()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = kernels.lib.rtt_flash_bwd_dq(*ins, dq.data_ptr(), *rest)
    kernels.check(code, "flash_bwd_dq")
    flash_bwd_dq_launches += 1
    return dq


def flash_bwd_cuda(q, k, v, out, lse, dout, causal: bool, sm_scale: float, window: int):
    """The backward on the card: Delta in torch, then the dK/dV and dQ
    kernels (which check their own inputs). Returns (dq, dk, dv)."""
    if out.shape != dout.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} differ in shape")
    # Delta = rowsum(dO * O) in f32, as the TPU path computes it before its launch.
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, sm_scale, window)
    dq = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, sm_scale, window)
    return dq, dk, dv


# --- kernel against plain ----------------------------------------------------

# How far a kernel's result may lie from its plain version on the same inputs.
# Both bars scale with the plain result's typical element, not its largest:
# in a causal output row 0 is v[0] itself, so a bar scaled by the largest
# element is about the size of the typical one and lets a wrong kernel pass.
#   rel_l2: ||kernel - plain||_2 / ||plain||_2
#   elem:   max over elements of |kernel - plain| / (|plain| + rms(plain))
# bf16: the kernels round P and dS to bf16 before their products and round
# their outputs to bf16, while the plain versions keep f32 throughout; and an
# element far larger in scale than the tensor's rms (dK, dV of the first keys,
# which every later query sees) can cancel to near zero and keep an error of
# its own scale, so `elem` reads up to ~20x bf16's rounding step. f32:
# summation order only. The bars sit ~4x above the sound kernels' readings on
# the card and ~4x below those of planted faults (a skipped key or query tile,
# a window off by one, an accumulator not rescaled; ``ops/plant_faults.py``).
MATCH_TOL = {
    torch.bfloat16: {"rel_l2": 1e-2, "elem": 2e-1},
    torch.float32: {"rel_l2": 1e-5, "elem": 1e-4},
}


def mismatch(got, want) -> dict[str, float]:
    """Distance of a kernel's result from its plain version: ``rel_l2``,
    ``elem`` (as for MATCH_TOL) and ``max_abs``. Equal infinities (the LSE of
    a row with no visible key) agree; a NaN makes every reading NaN."""
    got, want = got.float(), want.float()
    diff = torch.where(got == want, 0.0, (got - want).abs())
    want = torch.where(torch.isinf(want), 0.0, want)
    rms = want.square().mean().sqrt()
    tiny = torch.finfo(torch.float32).tiny
    return {
        "rel_l2": (diff.norm() / want.norm().clamp_min(tiny)).item(),
        "elem": (diff / (want.abs() + rms).clamp_min(tiny)).max().item(),
        "max_abs": diff.max().item(),
    }


def over_tolerance(m: dict[str, float], dtype) -> list[str]:
    """The bars of MATCH_TOL[dtype] that the readings `m` exceed (NaN exceeds all)."""
    return [f"{k} {m[k]:.3e} > {tol:.0e}" for k, tol in MATCH_TOL[dtype].items() if not m[k] <= tol]


# --- dispatch and autograd ----------------------------------------------------


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on CUDA or CPU tensors, not {t.device.type}")


def _flash_fwd(q, k, v, causal, sm_scale, window, save_lse):
    if _on_cuda(q):
        return flash_fwd_cuda(q, k, v, causal, sm_scale, window, save_lse)
    out, lse = _plain_flash_fwd(q, k, v, causal, sm_scale, window)
    return out, (lse if save_lse else None)


def _flash_bwd(q, k, v, out, lse, dout, causal, sm_scale, window):
    if _on_cuda(q):
        return flash_bwd_cuda(q, k, v, out, lse, dout, causal, sm_scale, window)
    return _plain_flash_bwd(q, k, v, out, lse, dout, causal, sm_scale, window)


class _FlashAttention(torch.autograd.Function):
    """The ``_pallas_flash`` custom_vjp: forward with LSE, two-kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        out, lse = _flash_fwd(q, k, v, causal, sm_scale, window, save_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.window = causal, sm_scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.sm_scale, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: float | None = None, bias=None, window: int = 0):
    """Multi-head attention, [B, T, H, D] layout.

    The CUDA kernels on a CUDA tensor, their plain versions on a CPU one.
    ``window`` > 0 (requires causal) is sliding-window attention: row i
    attends keys (i - window, i], and the kernels skip key tiles outside it.
    A ``bias`` ([B or 1, H or 1, Tq, Tk], added to the scaled scores) is not
    taken by the kernels: with one, every device runs plain PyTorch, as the
    JAX package sends it to XLA.
    """
    if window and not causal:
        raise ValueError("sliding window requires causal=True")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if bias is not None:
        return _plain_flash_fwd(q, k, v, causal, sm_scale, window, bias)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, sm_scale, window)
    # Primal only: no gradient will be taken, so skip the LSE write.
    return _flash_fwd(q, k, v, causal, sm_scale, window, save_lse=False)[0]
