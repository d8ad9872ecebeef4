"""Flagship model: decoder-only transformer (Llama family), dense path.

Counterpart of ``ray_tpu/models/transformer.py``: the same parameter layout
(a dict with the layer weights stacked ``[L, ...]``, stored f32 and cast to
the activation dtype at every matmul), the same RMSNorm, split-halves rotary
embedding, GQA head repeat, SwiGLU MLP, loss and AdamW step, so one set of
weights (``params_from_jax``) gives both packages the same function.

Eager PyTorch on tensors: the layer loop is a Python loop over the stack,
``remat`` is ``torch.utils.checkpoint`` per layer, and attention goes through
the port's CUDA flash kernels (``ray_tpu_torch.ops.attention``). With
``num_experts > 0`` the MLP is a top-1 mixture of experts
(``ray_tpu_torch.parallel.moe``), and the loss adds 0.01 times its aux loss
summed over layers. Entry points take ``device="cuda"`` by default and raise
when there is no card, unless the caller passes ``device="cpu"``.

With a ``mesh`` (``parallel/mesh.py``) the parameters are DTensors placed by
``param_logical_axes`` (``shard_params``), the tokens are sharded over
(dp, fsdp) on the batch and over sp on the sequence, and the same code runs
on DTensors, whose ops insert the collectives (module notes at
``_attend``). Attention takes plain tensors: with ``attn_impl="ring"`` or
``"ulysses"`` and ``sp`` > 1 it is ``parallel/ring_attention.py`` or
``parallel/ulysses.py``; otherwise the flash kernels run on each rank's
batch and heads over the whole sequence (``local_map``), as does the fused
loss on each rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.losses import fused_lm_loss, fused_lm_loss_sum
from ray_tpu_torch.parallel.moe import moe_layer, span


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
    num_experts: int = 0  # 0: dense SwiGLU MLP; > 0: top-1 mixture of experts
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
        },
        "norm_f": (D,),
    }
    if cfg.num_experts > 0:
        E = cfg.num_experts
        # wg_e is kept for the JAX package's layout; no path reads it.
        shapes["layers"].update({"gate": (L, D, E), "wi_e": (L, E, D, Fd), "wg_e": (L, E, D, Fd),
                                 "wo_e": (L, E, Fd, D)})
    else:
        shapes["layers"].update({"wi": (L, D, Fd), "wg": (L, D, Fd), "wo_mlp": (L, Fd, D)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def init_params(cfg: TransformerConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed``, in the JAX package's layout and
    scales (norm weights 1, projections N(0, 1) scaled as there). The numbers
    differ from ``jax.random``'s; use ``params_from_jax`` to share weights."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    s = D**-0.5
    out_scale = Fd**-0.5 * (2 * L) ** -0.5
    scales = {
        "embed": 1.0, "wq": s, "wk": s, "wv": s, "wo": s * (2 * L) ** -0.5,
        "wi": s, "wg": s, "wo_mlp": out_scale, "lm_head": s,
        "gate": s, "wi_e": s, "wg_e": s, "wo_e": out_scale,
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
    dev = _device(device)
    shapes = _param_shapes(cfg)

    def convert(name, arr, shape):
        arr = np.asarray(arr)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        return torch.tensor(arr, dtype=cfg.param_dtype, device=dev).requires_grad_()

    if set(np_params) != set(shapes) or set(np_params["layers"]) != set(shapes["layers"]):
        raise ValueError(f"parameter names {sorted(np_params)} do not match the layout of cfg")
    params = {n: convert(n, np_params[n], sh) for n, sh in shapes.items() if n != "layers"}
    params["layers"] = {n: convert(n, np_params["layers"][n], sh) for n, sh in shapes["layers"].items()}
    return params


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """Per-leaf logical axis names (mapped to mesh axes by
    parallel/mesh.logical_to_spec); the JAX package's."""
    layers = {
        "attn_norm": ("layers", None),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv"),
        "wv": ("layers", "embed", "kv"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", None),
    }
    if cfg.num_experts > 0:
        layers.update({
            "gate": ("layers", "embed", None),
            "wi_e": ("layers", "expert", "embed", "mlp"),
            "wg_e": ("layers", "expert", "embed", "mlp"),
            "wo_e": ("layers", "expert", "mlp", "embed"),
        })
    else:
        layers.update({
            "wi": ("layers", "embed", "mlp"),
            "wg": ("layers", "embed", "mlp"),
            "wo_mlp": ("layers", "mlp", "embed"),
        })
    axes = {"embed": ("vocab", "embed"), "layers": layers, "norm_f": (None,)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def shard_params(params: dict, cfg: TransformerConfig, mesh) -> dict:
    """``params`` (every rank passing the same values) as DTensors on
    ``mesh``, each laid out by its ``param_logical_axes`` through
    ``logical_to_spec``; leaves that require grad still do."""
    from ray_tpu_torch.parallel.mesh import logical_to_spec, shard_pytree

    axes = param_logical_axes(cfg)

    def spec(path, _leaf):
        node = axes
        for key in path:
            node = node[key]
        return logical_to_spec(node)

    return shard_pytree(params, mesh, spec)


def _placed(t, mesh, logical: tuple, src_data_rank: int | None = 0):
    """``t`` laid out on ``mesh`` by its logical axes: a DTensor is
    redistributed (if it is laid out otherwise); a plain tensor, passed whole
    by every rank, is distributed (from rank 0's values, or with
    ``src_data_rank=None`` from each rank's own, without communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ray_tpu_torch.parallel.mesh import logical_to_spec, spec_to_placements

    placements = spec_to_placements(logical_to_spec(logical), mesh, t.dim())
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == placements else t.redistribute(t.device_mesh, placements)
    return distribute_tensor(t, mesh.device_mesh, placements, src_data_rank=src_data_rank)


def place_batch(tokens, mesh):
    """A token batch [B, ...] (every rank passing the same; rank 0's are
    scattered) as a DTensor sharded over (dp, fsdp) on the batch."""
    return _placed(tokens, mesh, ("batch",) + (None,) * (tokens.dim() - 1))


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


def _attend(q, k, v, cfg: TransformerConfig, mesh, attn_impl: str):
    """The attention choice of the JAX package: ring or Ulysses attention
    over ``sp`` when asked for and ``sp`` > 1, else the flash kernels. On
    DTensors the flash kernels run in ``local_map`` on each rank's batch and
    heads, over the whole sequence (gathered over ``sp``): the kernels never
    see a DTensor."""
    sp = mesh.shape["sp"] if mesh is not None else 1
    if attn_impl in ("ring", "ulysses") and sp > 1:
        if cfg.sliding_window:
            raise NotImplementedError(f"sliding_window + {attn_impl} attention not supported")
        if attn_impl == "ring":
            from ray_tpu_torch.parallel.ring_attention import ring_attention

            return ring_attention(q, k, v, mesh, causal=True)
        from ray_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, mesh, causal=True)
    attend = lambda q, k, v: flash_attention(q, k, v, causal=True, window=cfg.sliding_window)  # noqa: E731
    if mesh is None:
        return attend(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import placements_keeping

    whole_seq = placements_keeping(q, mesh, (0, 2))
    return local_map(lambda *t: attend(*(x.contiguous() for x in t)), out_placements=whole_seq,
                     in_placements=(whole_seq,) * 3,
                     device_mesh=mesh.device_mesh, redistribute_inputs=True)(q, k, v)


def _attention_block(lp, x, cos, sin, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
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
    o = _attend(q, k, v, cfg, mesh, attn_impl)
    return x + o.reshape(B, T, H * Dh) @ lp["wo"].to(o.dtype)


def _moe_mlp(lp, h, capacity_factor: float, mesh=None):
    """The one expert call of the training block and of KV-cache decode
    (they differ only in capacity: training drops tokens past it, inference
    runs lossless). Returns (out, aux)."""
    with span("moe/weight_casts"):
        params = {"gate": lp["gate"].to(h.dtype), "wi": lp["wi_e"].to(h.dtype), "wo": lp["wo_e"].to(h.dtype)}
    return moe_layer(params, h, capacity_factor=capacity_factor, mesh=mesh)


def _mlp_block(lp, x, cfg: TransformerConfig, mesh=None):
    """(x + MLP(norm(x)), the layer's moe aux: 0.0 for the dense MLP)."""
    h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.num_experts > 0:
        # The experts are single GELU MLPs; wg_e takes no part.
        out, aux = _moe_mlp(lp, h, cfg.expert_capacity_factor, mesh)
        return x + out, aux
    gate = F.silu(h @ lp["wg"].to(h.dtype))
    up = h @ lp["wi"].to(h.dtype)
    return x + (gate * up) @ lp["wo_mlp"].to(h.dtype), 0.0


def _layer(lp, x, cos, sin, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    return _mlp_block(lp, _attention_block(lp, x, cos, sin, cfg, mesh, attn_impl), cfg, mesh)


def _whole_layers(w, mesh):
    """A stacked [L, ...] weight gathered over ``pp`` once per step, so that
    each layer's ``w[i]`` is a local slice (DTensor would gather the whole
    stack again for every layer's select)."""
    from torch.distributed.tensor import Replicate

    if mesh.shape["pp"] == 1:
        return w
    placements = [Replicate() if n == "pp" else p for n, p in zip(mesh.dim_names, w.placements)]
    return w.redistribute(w.device_mesh, placements)


def forward_hidden(params: dict, tokens, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """tokens [B, T] integer -> (final hidden [B, T, D], moe aux summed over
    layers: an f32 scalar, or 0.0 for the dense MLP). With a ``mesh`` the
    params are DTensors (``shard_params``), the tokens a DTensor or a plain
    tensor every rank passes whole, and the results DTensors."""
    T = tokens.shape[1]
    layers = params["layers"]
    if mesh is not None:
        tokens = _placed(tokens, mesh, ("batch", "seq"))
        layers = {n: _whole_layers(w, mesh) for n, w in layers.items()}
    x = params["embed"].to(cfg.dtype)[tokens]
    cos, sin = _rope_tables(torch.arange(T, device=x.device)[None], cfg.head_dim, cfg.rope_theta)
    if mesh is not None:
        # Tables for the global positions, sharded over sp as q and k are.
        cos, sin = (_placed(t, mesh, (None, "seq", None), src_data_rank=None) for t in (cos, sin))
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = {n: w[i] for n, w in layers.items()}
        if cfg.remat:
            x, a = checkpoint(_layer, lp, x, cos, sin, cfg, mesh, attn_impl, use_reentrant=False)
        else:
            x, a = _layer(lp, x, cos, sin, cfg, mesh, attn_impl)
        aux = aux + a
    return _rms_norm(x, params["norm_f"], cfg.norm_eps), aux


def _head(params):
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def forward(params: dict, tokens, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """tokens [B, T] integer -> (logits [B, T, V] f32, moe aux)."""
    x, aux = forward_hidden(params, tokens, cfg, mesh, attn_impl)
    return (x @ _head(params).to(x.dtype)).float(), aux


def _sharded_fused_loss(x, head, targets, mesh):
    """fused_lm_loss over DTensors: each rank's rows against the whole head
    (gathered over tp and fsdp). Each rank's sum is one element of a vector
    sharded over the row axes, whose DTensor sum is the total; the head's
    gradient from each rank's rows is a partial sum over those axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.parallel.mesh import placements_keeping

    rows = placements_keeping(x, mesh, (0, 1))
    whole = [Replicate()] * len(rows)
    sums = local_map(lambda *a: fused_lm_loss_sum(*a).reshape(1),
                     out_placements=[Shard(0) if isinstance(p, Shard) else Replicate() for p in rows],
                     in_placements=(rows, whole, rows),
                     in_grad_placements=(rows, [Partial() if isinstance(p, Shard) else Replicate() for p in rows],
                                         rows),
                     device_mesh=mesh.device_mesh, redistribute_inputs=True,
                     )(x, head, _placed(targets, mesh, ("batch", "seq")))
    return sums.sum() / targets.numel()


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, mesh=None, attn_impl: str = "auto"):
    """batch: {"tokens": [B, T+1]} next-token LM loss (f32 scalar). With a
    ``mesh``, the tokens are a DTensor or a plain tensor every rank passes
    whole, and the loss is a plain scalar, the same on every rank."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    if cfg.fused_loss:
        x, aux = forward_hidden(params, inputs, cfg, mesh, attn_impl)
        if mesh is None:
            return fused_lm_loss(x, _head(params), targets) + 0.01 * aux
        loss = _sharded_fused_loss(x, _head(params), targets, mesh) + 0.01 * aux
    else:
        logits, aux = forward(params, inputs, cfg, mesh, attn_impl)
        if mesh is not None:
            targets = _placed(targets, mesh, ("batch", "seq"))
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        loss = nll.mean() + 0.01 * aux
    return loss if mesh is None else loss.full_tensor()


def make_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer, mesh=None,
                    attn_impl: str = "auto", *, device="cuda"):
    """Returns train_step(params, batch) -> loss (a detached f32 scalar).

    Unlike the JAX step, which returns new params and optimizer state, this
    one updates both IN PLACE: ``optimizer`` (e.g. ``adamw(params)``) must
    hold the tensors of ``params``. ``batch["tokens"]`` ([B, T+1]) is moved
    to ``device`` first. A leaf the loss does not reach (``wg_e``) gets a
    zero gradient, as under ``jax.grad``, so the optimizer still steps it
    (AdamW's weight decay) where torch would skip a leaf without one.

    With a ``mesh``: ``params`` are ``shard_params``'s DTensors, the batch
    is sharded over (dp, fsdp) (a plain batch is rank 0's, scattered), each
    gradient is laid out as its parameter (the sums over the data axes) and
    the optimizer steps the DTensors; ``attn_impl`` as in ``forward``.
    """
    dev = _device(device)
    leaves = [p for group in optimizer.param_groups for p in group["params"]]

    def train_step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        tokens = batch["tokens"]
        if mesh is None:
            tokens = tokens.to(dev)
        elif not hasattr(tokens, "placements"):
            tokens = place_batch(tokens.to(dev), mesh)
        loss = loss_fn(params, {"tokens": tokens}, cfg, mesh, attn_impl)
        loss.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif mesh is not None and tuple(p.grad.placements) != tuple(p.placements):
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        optimizer.step()
        return loss.detach()

    return train_step
