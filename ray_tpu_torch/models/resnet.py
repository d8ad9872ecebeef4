"""ResNet v1.5: counterpart of ``ray_tpu/models/resnet.py``.

The same function as the flax module, layer for layer: a 7x7/2 stem padded
(3, 3), a 3x3/2 max-pool, stages of basic (ResNet-18/34) or bottleneck
(ResNet-50/101) blocks with the stride on the 3x3 convolution and a 1x1
projection where the shape changes, the last BatchNorm of each block
zero-initialised, a global mean and a linear head. Convolutions compute in
``dtype`` (bf16 by default) on f32 weights; BatchNorm, the residual sums and
the head run in f32, as in the flax module.

What differs from PyTorch's habits, and is matched here:

- flax ``padding="SAME"`` pads (0, 1), not (1, 1), for a 3x3 stride-2 window
  on an even input; the convolutions and the max-pool (which pads with -inf)
  pad as flax does (``_same_pad``).
- flax ``BatchNorm(momentum=0.9)`` keeps 0.9 of the running statistics per
  step (torch's ``momentum=0.1``), and updates the running variance with the
  BIASED batch variance, E[x^2] - E[x]^2; training mode here does the same.
- The flax module's ``axis_name="dp"`` averages the batch statistics across
  data-parallel replicas; on one card the batch is the whole batch. Across
  ranks waits (ROADMAP A9f).

Images are ``[B, H, W, 3]``, the JAX package's layout; convolutions read them
as NCHW in channels-last memory. ``resnet_params_from_jax`` turns the flax
``variables`` (``params`` and ``batch_stats``) into a state dict.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.transformer import _device

BN_MOMENTUM = 0.9  # flax: the share of the running statistics kept per step
BN_EPS = 1e-5


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of one spatial dimension."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_hw(x, k: int, stride: int, value: float = 0.0):
    """x [B, C, H, W] padded as "SAME" would, or None when the padding is
    symmetric (then the caller passes it to the op itself)."""
    (ht, hb), (wl, wr) = _same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride)
    if ht == hb and wl == wr:
        return None, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False, dtype=...)`` with "SAME" padding or an
    explicit symmetric ``padding``; weight [out, in, k, k]."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int | None = None,
                 dtype: Any = torch.bfloat16):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k) * (cin * k * k) ** -0.5)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding is not None:
            pad = self.padding
        else:
            padded, pad = _pad_hw(x, self.k, self.stride)
            x = x if padded is None else padded
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)``
    over the channels of [B, C, H, W]: f32 in and out."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, BN_EPS)
        mean = x.mean(dim=(0, 2, 3))
        var = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class _Block(nn.Module):
    """conv -> norm (-> relu) for each stage of the block, the last without
    relu; plus the input, through a 1x1 projection where the shape changes;
    then relu."""

    expansion = 1

    def __init__(self, convs: list, cin: int, stride: int, dtype: Any):
        super().__init__()
        cout = convs[-1].weight.shape[0]
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList([BatchNorm(c.weight.shape[0]) for c in convs[:-1]]
                                   + [BatchNorm(cout, zero_scale=True)])
        if stride != 1 or cin != cout:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(cout)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x):
        y = x
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < len(self.convs) - 1:
                y = F.relu(y)
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNetBlock(_Block):
    def __init__(self, cin: int, filters: int, stride: int = 1, dtype: Any = torch.bfloat16):
        super().__init__([Conv(cin, filters, 3, stride, dtype=dtype), Conv(filters, filters, 3, dtype=dtype)],
                         cin, stride, dtype)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype: Any = torch.bfloat16):
        super().__init__([Conv(cin, filters, 1, dtype=dtype), Conv(filters, filters, 3, stride, dtype=dtype),
                          Conv(filters, filters * 4, 1, dtype=dtype)], cin, stride, dtype)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls: type, num_classes: int = 1000, num_filters: int = 64,
                 dtype: Any = torch.bfloat16, *, device="cuda"):
        super().__init__()
        with _device(device):
            self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
            self.bn_init = BatchNorm(num_filters)
            blocks, cin = [], num_filters
            for i, n in enumerate(stage_sizes):
                for j in range(n):
                    filters = num_filters * 2**i
                    blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1, dtype))
                    cin = filters * block_cls.expansion
            self.blocks = nn.ModuleList(blocks)
            self.head = nn.Linear(cin, num_classes)

    def forward(self, images):
        """images [B, H, W, 3] -> logits [B, num_classes] (f32). ``train()``
        mode normalises with the batch's statistics and updates the running
        ones; ``eval()`` mode uses the running statistics."""
        x = F.relu(self.bn_init(self.conv_init(images.permute(0, 3, 1, 2))))
        padded, pad = _pad_hw(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x if padded is None else padded, 3, 2, padding=pad)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)


def resnet_params_from_jax(variables: dict) -> dict:
    """A state dict for ``ResNet`` from the flax module's ``variables``
    (``params`` and ``batch_stats``, numpy arrays): HWIO kernels become
    OIHW, the head's [in, out] kernel a Linear weight [out, in]."""
    sd = {}
    torch_name = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}

    def module(name: str) -> str:
        """flax module name -> the port's attribute path."""
        if "_" in name and name.rsplit("_", 1)[0] in ("ResNetBlock", "BottleneckBlock"):
            return f"blocks.{name.rsplit('_', 1)[1]}"
        kind, _, idx = name.rpartition("_")
        return {"Conv": f"convs.{idx}", "BatchNorm": f"norms.{idx}"}.get(kind, name)

    def walk(tree, path):
        for name, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [module(name)])
                continue
            v = np.asarray(v)
            if name == "kernel":
                sd[".".join(path + ["weight"])] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            else:
                sd[".".join(path + [torch_name[name]])] = v

    walk(variables["params"], [])
    walk(variables.get("batch_stats", {}), [])
    return {n: torch.tensor(np.ascontiguousarray(v)) for n, v in sd.items()}
