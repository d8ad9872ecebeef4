"""ray_tpu_torch's model zoo (MLP, ViT, ResNet) against the JAX package's.

One set of weights (the JAX or flax ``init``, carried over by each
``*_params_from_jax``) and one batch, both made from seeds, go through both
packages, f32 on the CPU (~25 s). The flax BatchNorm scales, biases and
running statistics are redrawn from a numpy seed before the comparison: at
initialisation every block's last scale is 0, which would hide the residual
branch.

Tolerances: 1e-5 (absolute and relative) on logits, losses and running
statistics, where only the summation order differs; 1e-4 of each leaf's
largest element on gradients, the bar of ``tests/test_torch_transformer.py``.
ResNet in train mode: logits 2e-4 absolute (logits up to ~4), gradients
1e-3 of each leaf's largest element. Each of its 20 BatchNorms divides by a
standard deviation taken over as few as 4 samples (the last stage is 1x1),
which amplifies rounding: the flax run and the port's both lie ~5e-5 (logits)
and ~1.6e-4 (gradients) from a float64 run of the port on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu.models import resnet as jres
from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.models import vit as tvit

CLOSE = dict(rtol=1e-5, atol=1e-5)


def _grads_close(got: dict, want: dict, what: str, bar: float = 1e-4):
    assert set(got) == set(want), what
    for name, g in got.items():
        w = np.asarray(want[name])
        assert np.abs(g - w).max() / (np.abs(w).max() + 1e-12) < bar, f"{what} {name}"


def test_mlp_matches_jax():
    """Logits, NLL, accuracy and every gradient of ``mlp_loss``."""
    params_j = jmlp.init_mlp(jax.random.PRNGKey(0), sizes=(64, 32, 16, 10))
    params_t = tmlp.mlp_params_from_jax(jax.tree.map(np.asarray, params_j), device="cpu")
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((16, 64)).astype(np.float32), rng.integers(0, 10, 16).astype(np.int32)
    (nll_j, acc_j), grads_j = jax.value_and_grad(jmlp.mlp_loss, has_aux=True)(
        params_j, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    nll_t, acc_t = tmlp.mlp_loss(params_t, {"x": torch.tensor(x), "y": torch.tensor(y)})
    nll_t.backward()
    np.testing.assert_allclose(nll_t.item(), float(nll_j), **CLOSE)
    assert acc_t.item() == float(acc_j)
    with torch.no_grad():
        logits = tmlp.mlp_forward(params_t, torch.tensor(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jmlp.mlp_forward(params_j, jnp.asarray(x))), **CLOSE)
    _grads_close({n: p.grad.numpy() for n, p in params_t.items()}, grads_j, "mlp grad")
    fresh = tmlp.init_mlp((64, 32, 10), device="cpu")
    assert {n: tuple(p.shape) for n, p in fresh.items()} == {"w0": (64, 32), "b0": (32,), "w1": (32, 10), "b1": (10,)}


def test_vit_tiny_matches_flax():
    """ViT_Tiny (patch 8 on 32x32 images: 16 patches + the class token,
    head_dim 16) in f32: logits, with attention through the port's
    flash_attention(causal=False)."""
    model_j = jvit.ViT_Tiny(dtype=jnp.float32)
    images = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    variables = jax.jit(model_j.init)(jax.random.PRNGKey(0), jnp.asarray(images))
    rng = np.random.default_rng(2)
    # Redraw the class token (zero at init) so that its path is tested.
    variables = jax.tree.map(np.asarray, variables)
    variables["params"]["cls"] = rng.standard_normal((1, 1, 64)).astype(np.float32)
    want = jax.jit(model_j.apply)(variables, jnp.asarray(images))
    model_t = tvit.ViT_Tiny(dtype=torch.float32, image_size=32, device="cpu")
    model_t.load_state_dict(tvit.vit_params_from_jax(variables))
    with torch.no_grad():
        got = model_t(torch.tensor(images))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    assert tvit.ViT_B16(device="cpu").pos_embed.shape == (1, 197, 768)


@pytest.fixture(scope="module")
def resnet18():
    """flax ResNet18 (10 classes, f32, no cross-replica axis) with its
    BatchNorm parameters and statistics redrawn, and a batch of 32x32 images:
    the stride-2 windows meet even sizes 16, 8, 4 and 2, where flax pads
    (0, 1)."""
    model = jres.ResNet18(num_classes=10, dtype=jnp.float32, axis_name=None)
    images = np.random.default_rng(3).standard_normal((4, 32, 32, 3)).astype(np.float32)
    init = jax.jit(model.init, static_argnames="train")
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jnp.asarray(images), train=False))
    rng = np.random.default_rng(4)

    def redraw(tree, kind):
        for name, v in tree.items():
            if isinstance(v, dict):
                redraw(v, kind)
            elif kind == "stats":
                tree[name] = (rng.uniform(0.5, 1.5, v.shape) if name == "var" else rng.normal(0, 0.2, v.shape)
                              ).astype(np.float32)
            elif name in ("scale", "bias") and v.ndim == 1 and len(tree) == 2:  # a BatchNorm
                tree[name] = ((1.0 if name == "scale" else 0.0) + rng.normal(0, 0.3, v.shape)).astype(np.float32)

    redraw(variables["params"], "params")
    redraw(variables["batch_stats"], "stats")
    return model, variables, images


def _port_resnet(variables):
    model = tres.ResNet18(num_classes=10, dtype=torch.float32, device="cpu")
    model.load_state_dict(tres.resnet_params_from_jax(variables))
    return model


def test_resnet18_eval_matches_flax(resnet18):
    model_j, variables, images = resnet18
    want = jax.jit(model_j.apply, static_argnames="train")(variables, jnp.asarray(images), train=False)
    model_t = _port_resnet(variables).eval()
    with torch.no_grad():
        got = model_t(torch.tensor(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


def test_resnet18_train_step_matches_flax(resnet18):
    """Train mode: logits from the batch's statistics, the updated running
    statistics (momentum 0.9, biased variance), and every parameter's
    gradient of a random projection of the logits."""
    model_j, variables, images = resnet18

    def apply(params):
        return model_j.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(images),
                             train=True, mutable=["batch_stats"])

    # A random cotangent: the gradient of the logits' plain sum would cancel
    # in the last BatchNorm's backward, which subtracts the batch mean.
    cot = np.random.default_rng(5).standard_normal((len(images), 10)).astype(np.float32)

    @jax.jit
    def forward_and_grads(params):
        (logits, new_vars), vjp = jax.vjp(apply, params)
        return logits, new_vars, vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, new_vars)))[0]

    want, new_vars, grads_j = forward_and_grads(variables["params"])
    model_t = _port_resnet(variables).train()
    got = model_t(torch.tensor(images))
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-4)
    stats = tres.resnet_params_from_jax({"params": {}, "batch_stats": jax.tree.map(np.asarray, new_vars)["batch_stats"]})
    buffers = dict(model_t.named_buffers())
    assert set(stats) == set(buffers)
    for name, want_stat in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(), err_msg=name, **CLOSE)
    grads_t = {n: p.grad.numpy() for n, p in model_t.named_parameters()}
    _grads_close(grads_t, {n: t.numpy() for n, t in tres.resnet_params_from_jax({"params": jax.tree.map(
        np.asarray, grads_j)}).items()}, "resnet grad", bar=1e-3)
