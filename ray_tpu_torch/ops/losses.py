"""Loss ops for the port.

``fused_lm_loss``: next-token cross-entropy fused with the LM-head matmul,
computed over row chunks so the full ``[N, V]`` f32 logits tensor is never
held: the forward keeps one ``[chunk, V]`` tile live and saves only the
per-row log-sum-exp; the backward recomputes each tile and rebuilds the
softmax from the saved LSE:

    forward:  logits = x_c @ head;  lse = logsumexp(logits);  nll_c = lse - logits[target]
    backward: p = exp(logits - lse);  p[target] -= 1;
              dx_c = (g p) @ head^T;  dhead += x_c^T @ (g p)

Counterpart of ``ray_tpu/ops/losses.py``, where this is an XLA scan, not a
Pallas kernel; here it is plain PyTorch in a ``torch.autograd.Function``.
Products take the model-dtype operands in f32, which is exact for bf16
inputs and gives the reference's "bf16 in, f32 accumulate" numbers.
"""

from __future__ import annotations

import torch


def _pick_chunk(n: int, want: int) -> int:
    """Largest divisor of n that is <= want."""
    want = max(1, min(want, n))
    for c in range(want, 0, -1):
        if n % c == 0:
            return c
    return n


def _chunk_logits(xb, head32):
    return xb.float() @ head32  # [c, V] f32


class _FusedLMLossSum(torch.autograd.Function):
    """Sum of per-token NLL. x: [N, D] (model dtype), head: [D, V] (same
    dtype), targets: [N] int64. Returns an f32 scalar."""

    @staticmethod
    def forward(ctx, x, head, targets, chunk):
        head32 = head.float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for s in range(0, x.shape[0], chunk):
            logits = _chunk_logits(x[s : s + chunk], head32)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, targets[s : s + chunk, None])[:, 0]
            total = total + (lse - tgt).sum()
            lses.append(lse)
        ctx.save_for_backward(x, head, targets, torch.cat(lses))
        ctx.chunk = chunk
        return total

    @staticmethod
    def backward(ctx, g):
        x, head, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        head32 = head.float()
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32, device=x.device)
        for s in range(0, x.shape[0], chunk):
            xb = x[s : s + chunk]
            logits = _chunk_logits(xb, head32)
            p = torch.exp(logits - lse[s : s + chunk, None])  # softmax, rebuilt from the saved lse
            p[torch.arange(p.shape[0], device=p.device), targets[s : s + chunk]] -= 1.0
            pg = (p * g).to(x.dtype)
            dx[s : s + chunk] = (pg.float() @ head32.T).to(x.dtype)
            dhead += xb.float().T @ pg.float()
        return dx, dhead.to(head.dtype), None, None


def fused_lm_loss(x, head, targets, *, chunk_size: int = 512):
    """Mean cross-entropy LM loss fused with the head projection.

    x: [B, T, D] or [N, D] final hidden states; head: [D, V]; targets:
    [B, T] or [N] integer. Equal (f32 accumulation, logsumexp-stable) to
    gathering ``log_softmax(x @ head)``, without ever holding [N, V].
    """
    return fused_lm_loss_sum(x, head, targets, chunk_size=chunk_size) / targets.numel()


def fused_lm_loss_sum(x, head, targets, *, chunk_size: int = 512):
    """The sum over tokens of ``fused_lm_loss``'s per-token NLL (f32 scalar):
    a sharded loss adds each rank's sum before dividing by the global count."""
    if x.dim() == 3:
        B, T, D = x.shape
        x = x.reshape(B * T, D)
        targets = targets.reshape(B * T)
    chunk = _pick_chunk(x.shape[0], chunk_size)
    return _FusedLMLossSum.apply(x, head.to(x.dtype), targets.long(), chunk)
