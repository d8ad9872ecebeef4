"""Ulysses (DeepSpeed-style) sequence parallelism by all_to_all.

Counterpart of ``ray_tpu/parallel/ulysses.py``: inputs are sequence-sharded
[B, T/n, H, D] over the ``sp`` axis; an all_to_all re-shards them to
head-sharded [B, T, H/n, D], each rank runs full-sequence attention for its
heads (the port's ``flash_attention``: on the card the forward, dK/dV and dQ
kernels), and a second all_to_all restores sequence sharding. Both
all_to_alls are ``torch.distributed.nn.functional.all_to_all_single``, which
is differentiable, and lay pieces out as the reference's tiled
``lax.all_to_all`` does: rank j receives head group j, and the received
sequence pieces concatenate in rank order.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel.ring_attention import seq_sharded, sp_axis


def _all_to_all(x, group):
    """x [n, ...]: piece j goes to rank j; returns [n, ...] with piece j from rank j."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def _seq_to_heads(x, n: int, group):
    """[B, T/n, H, D] -> [B, T, H/n, D]: split the heads, gather the sequence."""
    B, Tl, H, D = x.shape
    pieces = x.reshape(B, Tl, n, H // n, D).permute(2, 0, 1, 3, 4)  # [n, B, Tl, H/n, D]
    got = _all_to_all(pieces, group)  # got[j]: rank j's sequence chunk of my heads
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Tl, H // n, D)


def _heads_to_seq(x, n: int, group):
    """[B, T, H/n, D] -> [B, T/n, H, D]: split the sequence, gather the heads."""
    B, T, Hl, D = x.shape
    pieces = x.reshape(B, n, T // n, Hl, D).permute(1, 0, 2, 3, 4)  # [n, B, T/n, H/n, D]
    got = _all_to_all(pieces, group)  # got[j]: head group j of my sequence chunk
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hl, D)


def ulysses_attention(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = False,
                      sm_scale: float | None = None):
    """Exact attention over sequence-sharded inputs by head re-sharding.

    q, k, v: [B, T, H, D] sharded on T over ``axis_name`` (DTensors, or plain
    tensors every rank passes whole); H must be divisible by the axis size.
    Returns a DTensor of q's placements.
    """
    from torch.distributed.tensor import DTensor

    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    group, n, _ = sp_axis(mesh, axis_name, q.shape[1])
    q, k, v = (seq_sharded(x, mesh, axis_name) for x in (q, k, v))
    q_loc, k_loc, v_loc = (x.to_local().contiguous() for x in (q, k, v))
    H = q_loc.shape[2]
    if H % n:
        raise ValueError(f"heads ({H}) must be divisible by sp axis size ({n})")
    if n > 1:
        q_loc, k_loc, v_loc = (_seq_to_heads(x, n, group) for x in (q_loc, k_loc, v_loc))
    out = flash_attention(q_loc, k_loc, v_loc, causal=causal, sm_scale=sm_scale)
    if n > 1:
        out = _heads_to_seq(out, n, group)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False, shape=q.shape, stride=q.stride())
