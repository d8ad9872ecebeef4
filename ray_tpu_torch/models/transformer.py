"""Flagship model: decoder-only transformer (Llama family), dense path.

Counterpart of ``ray_tpu/models/transformer.py``: the same parameter layout
(a dict with the layer weights stacked ``[L, ...]``, stored f32 and cast to
the activation dtype at every matmul), the same RMSNorm, split-halves rotary
embedding, GQA head repeat, SwiGLU MLP, loss and AdamW step, so one set of
weights (``params_from_jax``) gives both packages the same function.

Eager PyTorch on tensors: the layer loop is a Python loop over the stack,
``remat`` is ``torch.utils.checkpoint`` per layer, and attention goes through
the port's CUDA flash kernels (``ray_tpu_torch.ops.attention``). Entry points
take ``device="cuda"`` by default and raise when there is no card, unless the
caller passes ``device="cpu"``.

Not in this package yet: mixture-of-experts (``num_experts > 0``), ring and
Ulysses attention (``attn_impl`` other than ``"auto"``, or a ``mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.losses import fused_lm_loss


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16  # activations
    param_dtype: Any = torch.float32  # stored weights
    num_experts: int = 0  # only 0 (dense) is ported
    expert_capacity_factor: float = 1.25
    remat: bool = True  # recompute each layer in the backward (torch.utils.checkpoint)
    tie_embeddings: bool = False
    # Accepted for parity with the JAX config; it unrolls the JAX layer scan
    # and has no effect in eager PyTorch, where the layer loop is Python.
    scan_unroll: int = 1
    sliding_window: int = 0  # > 0: row i attends keys (i - sliding_window, i]
    # Fuse the LM head into a chunked cross-entropy in loss_fn
    # (ops/losses.fused_lm_loss) so the [B*T, V] f32 logits are never held.
    fused_loss: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _check_supported(cfg: TransformerConfig, mesh=None, attn_impl: str = "auto") -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError("mixture-of-experts (num_experts > 0) is not ported yet")
    if mesh is not None or attn_impl != "auto":
        raise NotImplementedError("meshes and ring/Ulysses attention are not ported yet")


def _param_shapes(cfg: TransformerConfig) -> dict:
    D, H, KV, Dh, Fd, L, V = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers, cfg.vocab_size,
    )
    shapes = {
        "embed": (V, D),
        "layers": {
            "attn_norm": (L, D),
            "wq": (L, D, H * Dh),
            "wk": (L, D, KV * Dh),
            "wv": (L, D, KV * Dh),
            "wo": (L, H * Dh, D),
            "mlp_norm": (L, D),
            "wi": (L, D, Fd),
            "wg": (L, D, Fd),
            "wo_mlp": (L, Fd, D),
        },
        "norm_f": (D,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed``, in the JAX package's layout and
    scales (norm weights 1, projections N(0, 1) scaled as there). The numbers
    differ from ``jax.random``'s; use ``params_from_jax`` to share weights."""
    _check_supported(cfg)
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = D**-0.5
    scales = {
        "embed": 1.0, "wq": s, "wk": s, "wv": s, "wo": s * (2 * L) ** -0.5,
        "wi": s, "wg": s, "wo_mlp": Fd**-0.5 * (2 * L) ** -0.5, "lm_head": s,
    }

    def make(name, shape):
        if name in ("attn_norm", "mlp_norm", "norm_f"):
            t = torch.ones(shape, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) * scales[name]
        return t.to(cfg.param_dtype).requires_grad_()

    shapes = _param_shapes(cfg)
    params = {n: make(n, sh) for n, sh in shapes.items() if n != "layers"}
    params["layers"] = {n: make(n, sh) for n, sh in shapes["layers"].items()}
    return params


def params_from_jax(np_params: dict, cfg: TransformerConfig, *, device="cuda") -> dict:
    """The port's parameters from the JAX package's ``init_params`` pytree,
    given as numpy arrays (``jax.tree.map(np.asarray, params)``)."""
    _check_supported(cfg)
    dev = _device(device)
    shapes = _param_shapes(cfg)

    def convert(name, arr, shape):
        arr = np.asarray(arr)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        return torch.tensor(arr, dtype=cfg.param_dtype, device=dev).requires_grad_()

    if set(np_params) != set(shapes) or set(np_params["layers"]) != set(shapes["layers"]):
        raise ValueError(f"parameter names {sorted(np_params)} do not match the dense layout of cfg")
    params = {n: convert(n, np_params[n], sh) for n, sh in shapes.items() if n != "layers"}
    params["layers"] = {n: convert(n, np_params["layers"][n], sh) for n, sh in shapes["layers"].items()}
    return params


def param_leaves(params: dict) -> list[torch.Tensor]:
    """Every parameter tensor, in a fixed order (for optimizers)."""
    return [params[n] for n in sorted(params) if n != "layers"] + [
        params["layers"][n] for n in sorted(params["layers"])
    ]


def num_params(params: dict) -> int:
    return sum(p.numel() for p in param_leaves(params))


def adamw(params: dict, learning_rate: float = 1e-3) -> torch.optim.AdamW:
    """The counterpart of ``optax.adamw(learning_rate)`` with optax's
    defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every leaf
    (torch's own default weight decay is 0.01)."""
    return torch.optim.AdamW(
        param_leaves(params), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def _rms_norm(x, weight, eps):
    # Variance in f32, normalise, cast back, then scale in the activation dtype.
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _rope_tables(positions, Dh: int, theta: float):
    """cos/sin rotation tables [B, T, Dh/2] (f32) for integer positions
    [B, T] (B may be 1 to broadcast), built once per step and shared by every
    layer."""
    freqs = theta ** (-torch.arange(0, Dh // 2, dtype=torch.float32, device=positions.device) / (Dh // 2))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return torch.cos(angles), torch.sin(angles)


def _rope_apply(x, cos, sin):
    # x: [B, T, H, Dh]; rotate the two halves of Dh (not interleaved pairs).
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _attention_block(lp, x, cos, sin, cfg: TransformerConfig):
    B, T, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"].to(h.dtype)).reshape(B, T, H, Dh)
    k = (h @ lp["wk"].to(h.dtype)).reshape(B, T, KV, Dh)
    v = (h @ lp["wv"].to(h.dtype)).reshape(B, T, KV, Dh)
    q = _rope_apply(q, cos, sin)
    k = _rope_apply(k, cos, sin)
    if KV != H:  # GQA: each kv head serves H/KV consecutive query heads (jnp.repeat)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return x + o.reshape(B, T, H * Dh) @ lp["wo"].to(o.dtype)


def _mlp_block(lp, x, cfg: TransformerConfig):
    h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["wg"].to(h.dtype))
    up = h @ lp["wi"].to(h.dtype)
    return x + (gate * up) @ lp["wo_mlp"].to(h.dtype)


def _layer(lp, x, cos, sin, cfg: TransformerConfig):
    return _mlp_block(lp, _attention_block(lp, x, cos, sin, cfg), cfg)


def forward_hidden(params: dict, tokens, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """tokens [B, T] integer -> (final hidden [B, T, D], moe aux = 0.0)."""
    _check_supported(cfg, mesh, attn_impl)
    T = tokens.shape[1]
    x = params["embed"].to(cfg.dtype)[tokens]
    cos, sin = _rope_tables(torch.arange(T, device=x.device)[None], cfg.head_dim, cfg.rope_theta)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in layers.items()}
        if cfg.remat:
            x = checkpoint(_layer, lp, x, cos, sin, cfg, use_reentrant=False)
        else:
            x = _layer(lp, x, cos, sin, cfg)
    return _rms_norm(x, params["norm_f"], cfg.norm_eps), 0.0


def _head(params):
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def forward(params: dict, tokens, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """tokens [B, T] integer -> (logits [B, T, V] f32, moe aux)."""
    x, aux = forward_hidden(params, tokens, cfg, mesh, attn_impl)
    return (x @ _head(params).to(x.dtype)).float(), aux


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """batch: {"tokens": [B, T+1]} next-token LM loss (f32 scalar)."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    if cfg.fused_loss:
        x, aux = forward_hidden(params, inputs, cfg, mesh, attn_impl)
        return fused_lm_loss(x, _head(params), targets) + 0.01 * aux
    logits, aux = forward(params, inputs, cfg, mesh, attn_impl)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return nll.mean() + 0.01 * aux


def make_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer, mesh=None,
                    attn_impl: str = "auto", *, device="cuda"):
    """Returns train_step(params, batch) -> loss (a detached f32 scalar).

    Unlike the JAX step, which returns new params and optimizer state, this
    one updates both IN PLACE: ``optimizer`` (e.g. ``adamw(params)``) must
    hold the tensors of ``params``. ``batch["tokens"]`` ([B, T+1]) is moved
    to ``device`` first.
    """
    _check_supported(cfg, mesh, attn_impl)
    dev = _device(device)

    def train_step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, {"tokens": batch["tokens"].to(dev)}, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
