"""ViT-B/16-class vision transformer: counterpart of ``ray_tpu/models/vit.py``.

The same function as the flax module: a patch convolution, a zero-initialised
class token, a learned position embedding ``[1, patches + 1, D]``, pre-norm
blocks (LayerNorm with eps 1e-6 in f32, attention, LayerNorm, a tanh-GELU
MLP), a final LayerNorm and a linear head on the class token. Dense layers
and the patch convolution compute in ``dtype`` (bf16 by default) on f32
parameters, cast at each call as flax does; norms and the head run in f32.
Attention is the port's ``flash_attention(causal=False)``: the CUDA forward
kernel on the card.

Images are ``[B, H, W, 3]``, the JAX package's layout; the convolution reads
them as NCHW in channels-last memory. The position embedding's length is
fixed by ``image_size`` at construction (flax sizes it at ``init``).
``vit_params_from_jax`` turns the flax ``variables`` into a state dict.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.transformer import _device
from ray_tpu_torch.ops.attention import flash_attention

LN_EPS = 1e-6  # flax LayerNorm's default


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(layer: nn.LayerNorm, x):
    """flax ``nn.LayerNorm(dtype=jnp.float32)``: computed and returned in f32."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, LN_EPS)


class ViTAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: Any = torch.bfloat16):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, T, D = x.shape
        H = self.num_heads
        # Split q | k | v along the features first, then into heads.
        q, k, v = (t.reshape(B, T, H, D // H).contiguous() for t in _dense(self.qkv, x, self.dtype).split(D, -1))
        o = flash_attention(q, k, v, causal=False)
        return _dense(self.proj, o.reshape(B, T, D), self.dtype)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dtype: Any = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim)
        self.attn = ViTAttention(dim, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        x = x + self.attn(_layer_norm(self.norm1, x))
        y = F.gelu(_dense(self.fc1, _layer_norm(self.norm2, x), self.dtype), approximate="tanh")
        return x + _dense(self.fc2, y, self.dtype)


class ViT(nn.Module):
    def __init__(self, num_classes: int = 1000, patch_size: int = 16, hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, dtype: Any = torch.bfloat16, image_size: int = 224,
                 *, device="cuda"):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of patch_size {patch_size}")
        self.patch_size, self.image_size, self.dtype = patch_size, image_size, dtype
        n = (image_size // patch_size) ** 2
        with _device(device):
            self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
            self.cls = nn.Parameter(torch.zeros(1, 1, hidden_dim))
            self.pos_embed = nn.Parameter(torch.randn(1, n + 1, hidden_dim) * 0.02)
            self.blocks = nn.ModuleList(ViTBlock(hidden_dim, num_heads, mlp_dim, dtype) for _ in range(num_layers))
            self.norm = nn.LayerNorm(hidden_dim)
            self.head = nn.Linear(hidden_dim, num_classes)

    def forward(self, images):
        """images [B, H, W, 3] -> logits [B, num_classes] (f32)."""
        if images.shape[1:3] != (self.image_size, self.image_size):
            raise ValueError(f"images {tuple(images.shape)}: this ViT was built for {self.image_size}^2")
        w = self.patch_embed
        x = F.conv2d(images.permute(0, 3, 1, 2).to(self.dtype), w.weight.to(self.dtype), w.bias.to(self.dtype),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, patches, D], patches in row-major order
        B, _, D = x.shape
        x = torch.cat([self.cls.to(x.dtype).expand(B, 1, D), x], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return self.head(_layer_norm(self.norm, x)[:, 0])


def ViT_B16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, **kw)


def ViT_Tiny(num_classes: int = 10, **kw) -> ViT:
    """Small variant for tests."""
    return ViT(num_classes=num_classes, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=8, **kw)


def vit_params_from_jax(variables: dict) -> dict:
    """A state dict for ``ViT`` from the flax module's ``variables``
    (``{"params": ...}``, numpy arrays): Dense kernels [in, out] become
    Linear weights [out, in], the HWIO patch kernel becomes OIHW."""
    p = variables["params"]
    sd = {}

    def dense(prefix, d):
        sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(d["bias"])

    def norm(prefix, d):
        sd[f"{prefix}.weight"] = np.asarray(d["scale"])
        sd[f"{prefix}.bias"] = np.asarray(d["bias"])

    sd["patch_embed.weight"] = np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.bias"] = np.asarray(p["patch_embed"]["bias"])
    sd["cls"], sd["pos_embed"] = np.asarray(p["cls"]), np.asarray(p["pos_embed"])
    n_layers = sum(name.startswith("block_") for name in p)
    for i in range(n_layers):
        b, pre = p[f"block_{i}"], f"blocks.{i}"
        norm(f"{pre}.norm1", b["LayerNorm_0"])
        norm(f"{pre}.norm2", b["LayerNorm_1"])
        dense(f"{pre}.attn.qkv", b["ViTAttention_0"]["qkv"])
        dense(f"{pre}.attn.proj", b["ViTAttention_0"]["proj"])
        dense(f"{pre}.fc1", b["Dense_0"])
        dense(f"{pre}.fc2", b["Dense_1"])
    norm("norm", p["LayerNorm_0"])
    dense("head", p["head"])
    return {n: torch.tensor(np.ascontiguousarray(v)) for n, v in sd.items()}
