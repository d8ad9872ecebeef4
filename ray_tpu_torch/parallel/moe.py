"""Mixture-of-experts: Switch-style top-k routing with a static capacity.

Counterpart of ``ray_tpu/parallel/moe.py`` on one card: the same routing
(softmax gate, first-maximum argmax, a static capacity per (row, expert),
overflow tokens dropped), the same one-hot dispatch and combine tensors
``[B, T, E, C]`` and the same four einsums, the same tanh-form GELU, and the
same Switch load-balancing aux loss. The einsums are cuBLAS batched products:
the JAX package computes them outside any Pallas kernel, and so does this
module. Expert parallelism over a mesh axis waits for the port's device mesh
(ROADMAP A9b).

One difference, on purpose: a token's position in its expert's queue is
counted in integers. The JAX package counts it with a cumsum in the
probabilities' dtype, which in bf16 is exact only up to 256, so past 256
tokens of one row on one expert two tokens share a slot there and their
inputs are summed. Here every token gets its own slot; the two agree
wherever the reference's count is exact (every f32 run, and bf16 up to 256).

With the profiler on, each part runs inside a ``moe/...`` range (``route``,
``dispatch``, ``experts``, ``combine``), so a trace can give each its own
device time.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function


def span(name: str):
    """A profiler range named ``name`` while the profiler runs; nothing (not
    even the range's own dispatch) otherwise."""
    return record_function(name) if torch.autograd._profiler_enabled() else contextlib.nullcontext()


def top_k_routing(gate_logits, num_experts: int, capacity: int, k: int = 1):
    """gate_logits [B, T, E] -> (dispatch [B, T, E, C] one-hot, combine
    [B, T, E, C] weights), both in the logits' dtype. ``num_experts`` is E
    (the logits' last dimension; kept for the reference's signature).

    Each of k rounds sends every token to its largest remaining probability
    (the first one on ties), at the next free slot of that expert's queue in
    its row; a token past ``capacity`` is dropped (combine weight 0).
    """
    B, T, E = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    combine = torch.zeros((B, T, E, capacity), dtype=probs.dtype, device=probs.device)
    dispatch = torch.zeros((B, T, E, capacity), dtype=torch.bool, device=probs.device)
    remaining = probs
    for _ in range(k):
        expert = remaining.argmax(dim=-1)  # [B, T]
        hot = F.one_hot(expert, E)  # [B, T, E] integers
        onehot = hot.to(probs.dtype)
        gate = (remaining * onehot).sum(-1)  # [B, T]
        # Position in the expert's queue, exact at any T; -1 where unrouted.
        pos = (torch.cumsum(hot, dim=1) * hot - 1).amax(-1)  # [B, T]
        in_cap = pos < capacity
        slot = F.one_hot(pos.clamp(0, capacity - 1), capacity).to(probs.dtype)  # [B, T, C]
        contrib = onehot[..., None] * slot[:, :, None, :] * (gate * in_cap)[..., None, None]
        combine = combine + contrib
        dispatch = dispatch | (contrib > 0)
        remaining = remaining * (1.0 - onehot)
    return dispatch.to(probs.dtype), combine


def moe_layer(params, x, *, capacity_factor: float = 1.25, k: int = 1):
    """params: {"gate": [D, E], "wi": [E, D, F], "wo": [E, F, D]} in x's
    dtype; x [B, T, D]. Returns (out [B, T, D], aux), aux the Switch
    load-balancing loss E * mean_b sum_e f_be p_be (an f32 scalar), where
    f_be is row b's share of the whole batch's routed tokens going to e and
    p_be row b's mean gate probability of e."""
    B, T, D = x.shape
    E = params["gate"].shape[-1]
    capacity = max(1, int(capacity_factor * T * k / E))
    with span("moe/route"):
        logits = x @ params["gate"]  # [B, T, E]
        dispatch, combine = top_k_routing(logits, E, capacity, k)
    with span("moe/dispatch"):
        expert_in = torch.einsum("btec,btd->ebcd", dispatch, x)  # [E, B, C, D]
    with span("moe/experts"):
        h = F.gelu(torch.einsum("ebcd,edf->ebcf", expert_in, params["wi"]), approximate="tanh")
        expert_out = torch.einsum("ebcf,efd->ebcd", h, params["wo"])
    with span("moe/combine"):
        out = torch.einsum("btec,ebcd->btd", combine, expert_out)
    with span("moe/route"):
        # Counts in f32, exact at any batch size.
        counts = dispatch.float()
        frac_tokens = counts.sum(dim=(1, 3)) / counts.sum().clamp(min=1.0)  # [B, E]
        frac_probs = torch.softmax(logits.float(), dim=-1).mean(dim=1)  # [B, E]
        aux = E * (frac_tokens * frac_probs).sum(-1).mean()
    return out, aux


def init_moe_params(d_model: int, d_ff: int, num_experts: int, seed: int = 0, *, dtype=torch.float32,
                    device="cuda") -> dict:
    """Random expert parameters from ``seed`` at the JAX package's scales
    (gate and wi N(0, 1/d_model), wo N(0, 1/d_ff)); the numbers differ from
    ``jax.random``'s."""
    from ray_tpu_torch.models.transformer import _device

    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return {
        "gate": normal((d_model, num_experts), d_model**-0.5),
        "wi": normal((num_experts, d_model, d_ff), d_model**-0.5),
        "wo": normal((num_experts, d_ff, d_model), d_ff**-0.5),
    }
