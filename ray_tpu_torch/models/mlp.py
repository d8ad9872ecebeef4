"""MNIST-class MLP: counterpart of ``ray_tpu/models/mlp.py``.

Parameters are a dict ``{"w0", "b0", "w1", ...}`` with the JAX package's
layout (``w{i}`` [fan_in, fan_out], ``b{i}`` [fan_out]) and scales (weights
N(0, 1/fan_in), biases 0), so ``mlp_params_from_jax`` carries one set of
weights over unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.transformer import _device


def init_mlp(sizes=(784, 256, 128, 10), seed: int = 0, *, dtype=torch.float32, device="cuda") -> dict:
    """Random parameters from ``seed``; the numbers differ from ``jax.random``'s."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((fan_in, fan_out), generator=gen, device=dev) * fan_in**-0.5
        params[f"w{i}"] = w.to(dtype).requires_grad_()
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=dtype, device=dev, requires_grad=True)
    return params


def mlp_params_from_jax(np_params: dict, *, device="cuda") -> dict:
    """The port's parameters from the JAX ``init_mlp`` dict, given as numpy
    arrays (``jax.tree.map(np.asarray, params)``)."""
    dev = _device(device)
    return {n: torch.tensor(np.asarray(v), device=dev).requires_grad_() for n, v in np_params.items()}


def mlp_forward(params: dict, x):
    """x [B, fan_in] -> logits [B, classes]: dense layers with ReLU between."""
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.relu(x)
    return x


def mlp_loss(params: dict, batch: dict):
    """batch {"x": [B, fan_in], "y": [B] integer} -> (mean NLL, accuracy)."""
    logits = mlp_forward(params, batch["x"])
    y = batch["y"].long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return nll, acc
