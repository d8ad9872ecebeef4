"""ray_tpu_torch fused_lm_loss against the JAX package's fused_lm_loss.

Same seeded numpy inputs, f32 on the CPU. Tolerances: 1e-5 relative on the
loss (only the summation order differs) and 1e-4 relative to the largest
element on dx and dhead, the bar the JAX package's own attention tests use
for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.losses import fused_lm_loss as jax_fused_lm_loss
from ray_tpu_torch.ops.losses import _pick_chunk, fused_lm_loss

GRAD_RTOL = 1e-4


@pytest.mark.parametrize("batched", [False, True], ids=["flat", "batched"])  # x [N, D] or [B, T, D]
@pytest.mark.parametrize("chunk", [64, 128, 1000])  # 1000: no divisor of N -> _pick_chunk
def test_fused_lm_loss_matches_jax(chunk, batched):
    N, D, V = 256, 64, 512
    rng = np.random.default_rng(0)
    shape = (2, N // 2) if batched else (N,)
    x = rng.standard_normal((*shape, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, size=shape)

    f = lambda x, h: jax_fused_lm_loss(x, h, jnp.asarray(targets, jnp.int32), chunk_size=chunk)
    want, (dx_want, dh_want) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))

    xt, ht = torch.tensor(x, requires_grad=True), torch.tensor(head, requires_grad=True)
    loss = fused_lm_loss(xt, ht, torch.tensor(targets), chunk_size=chunk)
    loss.backward()

    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for name, got, ref in (("dx", xt.grad, dx_want), ("dhead", ht.grad, dh_want)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape, name
        rel = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
        assert rel < GRAD_RTOL, f"{name}: relative error {rel}"


def test_pick_chunk():
    assert _pick_chunk(256, 1000) == 256
    assert _pick_chunk(256, 100) == 64
    assert _pick_chunk(7, 4) == 1
