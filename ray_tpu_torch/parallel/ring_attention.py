"""Ring attention: context parallelism over the ``sp`` mesh axis.

Counterpart of ``ray_tpu/parallel/ring_attention.py``. Q, K and V are
sharded over the sequence across the ``sp`` axis; each rank attends its
local Q chunk to a K/V chunk that travels around the ring of ``sp`` ranks
(``dist.batch_isend_irecv`` to the next rank, from the previous), and the
per-chunk flash outputs combine through their log-sum-exp, so the result is
exact (Liu et al., Ring Attention).

As in the JAX package:

- **Double buffering.** The transfer of the next K/V chunk is posted before
  the attention of the current one and waited on after it, so the link and
  the card work at once.
- **The flash kernel per chunk.** On a CUDA tensor each (Q chunk, K chunk)
  pair runs the forward kernel with its LSE (``flash_fwd_cuda``). Chunks are
  size-aligned, so the causal relation has three cases, decided on the host
  from the ranks' offsets: K after Q (fully masked: zeros and an empty LSE,
  no launch), the diagonal (causal), K before Q (not masked).
- **A ring-level gradient.** The backward makes a second ring pass with
  plain einsums per chunk (not the backward kernels), rotating the dK/dV
  accumulators with their K/V chunks so each chunk's gradients are home
  after the full cycle.

On a CPU tensor each chunk runs ``_xla_chunk``, the chunk's plain version.
An empty row's LSE is the reference's finite ``-1e30`` in ``_xla_chunk`` and
``-inf`` from the kernel; ``_combine`` and the backward treat both as empty.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ray_tpu_torch.ops import attention as A

_NEG_INF = -1e30  # the reference's finite stand-in for -inf


def _empty(lse):
    """Rows with no visible key: an LSE of -1e30 (plain chunk) or -inf (kernel)."""
    return ~(lse > _NEG_INF)


def _xla_chunk(q, k, v, q_start: int, k_start: int, causal: bool, sm_scale: float):
    """One Q-chunk x K-chunk block in plain PyTorch: the chunk's normalized
    output [B, Tq, H, D] (f32) and log-sum-exp [B, H, Tq] (f32; -1e30 on an
    empty row)."""
    qf = q.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * sm_scale
    if causal:
        Tq, Tc = q.shape[1], k.shape[1]
        q_pos = q_start + torch.arange(Tq, device=q.device)[:, None]
        k_pos = k_start + torch.arange(Tc, device=q.device)[None, :]
        s = torch.where((q_pos >= k_pos)[None, None], s, _NEG_INF)
    m = s.amax(dim=-1)  # [B, H, Tq]
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= _NEG_INF, 0.0, p)
    l = p.sum(dim=-1)  # [B, H, Tq]
    masked = l == 0.0
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / torch.where(masked, 1.0, l).transpose(1, 2)[..., None]
    lse = torch.where(masked, _NEG_INF, m + torch.log(torch.where(masked, 1.0, l)))
    return out, lse


def _flash_chunk(q, k, v, q_start, k_start: int, sm_scale: float, fwd=A.flash_fwd_cuda):
    """The forward kernel (``fwd``) for one chunk pair: (out f32, lse f32).
    ``q_start`` None: not causal, every chunk is a full block. Otherwise the
    chunks are size-aligned: K strictly after Q is fully masked (zeros and a
    -inf LSE, no launch), the diagonal is causal, K before Q is unmasked."""
    B, Tq, H, D = q.shape
    if q_start is not None and k_start > q_start:
        return (torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device),
                torch.full((B, H, Tq), -math.inf, dtype=torch.float32, device=q.device))
    out, lse = fwd(q, k, v, q_start is not None and k_start == q_start, sm_scale, 0, True)
    return out.float(), lse


def _combine(acc, lse_run, out_c, lse_c):
    """Merge one chunk's output into the running result by LSE weighting:
    out = sum_c out_c * exp(lse_c - lse_global), exactly."""
    new_lse = torch.logaddexp(lse_run, lse_c)
    safe = torch.where(_empty(new_lse), 0.0, new_lse)
    w_old = torch.where(_empty(lse_run), 0.0, torch.exp(lse_run - safe))
    w_new = torch.where(_empty(lse_c), 0.0, torch.exp(lse_c - safe))
    acc = acc * w_old.transpose(1, 2)[..., None] + out_c * w_new.transpose(1, 2)[..., None]
    return acc, new_lse


class _Ring:
    """This rank's place on the ring of one mesh axis: ``n`` ranks, index
    ``idx``; ``shift`` posts sends to the next rank and receives from the
    previous, returning the receive buffers and a wait function."""

    def __init__(self, group, n: int, idx: int):
        self.group, self.n, self.idx = group, n, idx

    def shift(self, *tensors):
        bufs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
        ops = []
        for t, buf in zip(tensors, bufs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), group=self.group, group_peer=(self.idx + 1) % self.n))
            ops.append(dist.P2POp(dist.irecv, buf, group=self.group, group_peer=(self.idx - 1) % self.n))
        works = dist.batch_isend_irecv(ops)

        def wait():
            for w in works:
                w.wait()
            return bufs

        return wait


def _ring_forward(q, k, v, ring: _Ring, causal: bool, sm_scale: float, impl: str):
    B, Tq, H, D = q.shape
    q_start = ring.idx * Tq

    def chunk(kc, vc, k_start):
        if impl == "cuda":
            return _flash_chunk(q, kc, vc, q_start if causal else None, k_start, sm_scale)
        return _xla_chunk(q, kc, vc, q_start, k_start, causal, sm_scale)

    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    lse_run = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for i in range(ring.n):
        # Double buffering: the next chunk leaves before this one is attended.
        pending = ring.shift(kc, vc) if i < ring.n - 1 else None
        out_c, lse_c = chunk(kc, vc, ((ring.idx - i) % ring.n) * Tq)
        acc, lse_run = _combine(acc, lse_run, out_c, lse_c)
        if pending is not None:
            kc, vc = pending()
    return acc.to(q.dtype), lse_run


def _ring_backward(q, k, v, out, lse, dout, ring: _Ring, causal: bool, sm_scale: float):
    """Second ring pass, plain einsums per chunk: dK/dV accumulators rotate
    with their K/V chunks and are home after n rotations."""
    B, Tq, H, D = q.shape
    q_start = ring.idx * Tq
    qf, doutf = q.float(), dout.float()
    delta = (doutf * out.float()).sum(-1).transpose(1, 2)  # [B, H, Tq]
    row_empty = _empty(lse)[..., None]  # fully masked rows contribute nothing
    lse_safe = torch.where(_empty(lse), 0.0, lse)
    dq = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    kc, vc = k, v
    for i in range(ring.n):
        pending = ring.shift(kc, vc) if i < ring.n - 1 else None
        k_start = ((ring.idx - i) % ring.n) * Tq
        kf, vf = kc.float(), vc.float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
        hidden = row_empty
        if causal:
            q_pos = q_start + torch.arange(Tq, device=q.device)[:, None]
            k_pos = k_start + torch.arange(Tq, device=q.device)[None, :]
            hidden = hidden | (q_pos < k_pos)[None, None]
        p = torch.where(hidden, 0.0, torch.exp(s - lse_safe[..., None]))
        dp = torch.einsum("bqhd,bkhd->bhqk", doutf, vf)
        ds = p * (dp - delta[..., None]) * sm_scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kf)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, doutf)
        if ring.n > 1:
            # Rotate the gradients with their chunks; after n steps they are home.
            dk, dv = ring.shift(dk, dv)()
        if pending is not None:
            kc, vc = pending()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring-level custom VJP of the reference (``_ring_attn_local``)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, sm_scale, impl):
        out, lse = _ring_forward(q, k, v, ring, causal, sm_scale, impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.sm_scale = ring, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, ctx.ring, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def seq_sharded(x, mesh, axis_name: str):
    """``x`` [B, T, H, D] as a DTensor whose dim 1 is sharded over
    ``axis_name``, keeping shards of the batch and heads on other mesh
    dimensions (anything else gathered); a plain tensor, which every rank
    passes whole, is sharded over ``axis_name`` only, by taking this rank's
    chunk (so a gradient reaches that chunk of it)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ray_tpu_torch.parallel.mesh import placements_keeping

    if not isinstance(x, DTensor):
        n, idx = mesh.shape[axis_name], mesh.index(axis_name)
        placements = [Shard(1) if name == axis_name else Replicate() for name in mesh.dim_names]
        chunk = x.narrow(1, idx * (x.shape[1] // n), x.shape[1] // n)
        return DTensor.from_local(chunk, mesh.device_mesh, placements, run_check=False, shape=x.shape,
                                  stride=x.stride())
    placements = placements_keeping(x, mesh, (0, 2), **{axis_name: Shard(1)})
    return x.redistribute(mesh.device_mesh, placements) if list(x.placements) != placements else x


def sp_axis(mesh, axis_name: str, T: int):
    """(group, n, idx) of ``axis_name``; T must split evenly over it."""
    n = mesh.shape[axis_name]
    if T % n:
        raise ValueError(f"sequence length {T} does not split evenly over {axis_name}={n}")
    return mesh.group(axis_name), n, mesh.index(axis_name)


def ring_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = False,
                   sm_scale: float | None = None, impl: str = "auto"):
    """Exact attention over sequence-sharded Q/K/V.

    q, k, v: [B, T, H, D] DTensors sharded over ``axis_name`` on dim 1 (other
    mesh dimensions may shard the batch or heads), or plain tensors, which
    every rank passes whole and which are distributed so. Returns a DTensor
    of q's placements. Differentiable (a ring-level autograd Function).

    impl: "cuda" (the forward kernel per chunk), "plain" (``_xla_chunk``) or
    "auto" (the kernel on CUDA tensors, the plain chunk on CPU ones).
    """
    from torch.distributed.tensor import DTensor

    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    group, n, idx = sp_axis(mesh, axis_name, q.shape[1])
    q, k, v = (seq_sharded(x, mesh, axis_name) for x in (q, k, v))
    q_loc, k_loc, v_loc = (x.to_local().contiguous() for x in (q, k, v))
    on_cuda = q_loc.device.type == "cuda"
    if impl == "auto":
        impl = "cuda" if on_cuda else "plain"
    if impl == "cuda":
        if not on_cuda:
            raise ValueError("impl='cuda' runs the flash kernel and needs CUDA tensors; use impl='plain' on the CPU")
        try:
            A._check_cuda(q_loc, k_loc, v_loc)
        except (ValueError, TypeError) as e:
            raise ValueError(f"impl='cuda': the per-rank chunk is outside the kernel's limits ({e}); "
                             "use impl='plain'") from None
    elif impl != "plain":
        raise ValueError(f"impl must be 'auto', 'cuda' or 'plain', not {impl!r}")
    out = _RingAttention.apply(q_loc, k_loc, v_loc, _Ring(group, n, idx), causal, sm_scale, impl)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False, shape=q.shape, stride=q.stride())
