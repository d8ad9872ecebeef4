"""ray_tpu_torch flash attention against the JAX package's Pallas kernels.

The same seeded numpy inputs go through the port (on the CPU: the plain
versions inside the same autograd.Function the card runs) and through the
Pallas kernels in interpret mode: ``_pallas_flash_with_lse`` for the output
and LSE, ``jax.grad`` of ``flash_attention(force_pallas=True)`` for the
gradients (the VJP forward and ``_pallas_bwd_impl``'s dkv/dq kernels).

Tolerances are the JAX package's own for f32 on the CPU: 1e-5 absolute on
outputs and LSE (only the summation order differs), 1e-4 relative to the
largest gradient element on gradients.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jax_attn
from ray_tpu_torch.ops import attention as torch_attn

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-4


def _inputs(seed, B, Tq, Tk, H, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    w = rng.standard_normal((B, Tq, H, D)).astype(np.float32)  # output cotangent
    return q, k, v, w


def _torch_grads(q, k, v, w, **kw):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = torch_attn.flash_attention(qt, kt, vt, **kw)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _assert_grads_close(got, want, what):
    for name, a, b in zip("qkv", got, want):
        rel = float(np.abs(a - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-9))
        assert rel < GRAD_RTOL, f"{what} d{name}: relative error {rel}"


@pytest.mark.parametrize(
    "Tq,Tk,causal,window,D",
    [
        (128, 128, False, 0, 32),
        (256, 256, True, 0, 64),
        (128, 256, True, 0, 32),  # Tq < Tk: bottom-right causal alignment
        (256, 256, True, 96, 32),  # sliding window across several key tiles
    ],
)
def test_flash_attention_matches_pallas(Tq, Tk, causal, window, D):
    B, H = 2, 2
    scale = 1.0 / np.sqrt(D)
    q, k, v, w = _inputs(0, B, Tq, Tk, H, D)

    out_ref, lse_ref = jax_attn._pallas_flash_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale, 64, 64,
        interpret=True, save_lse=True, window=window,
    )
    out, lse = torch_attn._flash_fwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal, scale, window, save_lse=True
    )
    assert lse.shape == (B, H, Tq)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0, atol=OUT_ATOL)

    def loss(q, k, v):
        o = jax_attn.flash_attention(
            q, k, v, causal=causal, sm_scale=scale, window=window,
            force_pallas=True, interpret=True, block_q=64, block_k=64,
        )
        return (o * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out_t, got = _torch_grads(q, k, v, w, causal=causal, sm_scale=scale, window=window)
    np.testing.assert_allclose(out_t, np.asarray(out_ref), rtol=0, atol=OUT_ATOL)
    _assert_grads_close(got, want, f"Tq={Tq} Tk={Tk} causal={causal} window={window}")


def test_flash_attention_ragged_length_matches_public_api():
    """T = 100 is no multiple of any tile: the JAX package sends it to XLA,
    the port's kernels mask the tail in-kernel; both must give the same."""
    B, T, H, D = 1, 100, 2, 32
    q, k, v, w = _inputs(1, B, T, T, H, D)

    def loss(q, k, v):
        return (jax_attn.flash_attention(q, k, v, causal=True) * jnp.asarray(w)).sum()

    out_ref = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, got = _torch_grads(q, k, v, w, causal=True)
    np.testing.assert_allclose(out, np.asarray(out_ref), rtol=0, atol=OUT_ATOL)
    _assert_grads_close(got, want, "T=100")


def test_flash_attention_bias_goes_to_plain_torch():
    """A bias is not taken by the kernels; the plain path must equal the
    JAX package's XLA attention with the same bias, gradients included."""
    B, T, H, D = 1, 64, 2, 32
    q, k, v, w = _inputs(2, B, T, T, H, D)
    bias = np.random.default_rng(3).standard_normal((1, H, T, T)).astype(np.float32)

    def loss(q, k, v):
        o = jax_attn.flash_attention(q, k, v, causal=True, bias=jnp.asarray(bias))
        return (o * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    torch_attn.reset_launch_counts()
    _, got = _torch_grads(q, k, v, w, causal=True, bias=torch.tensor(bias))
    _assert_grads_close(got, want, "bias")
    assert torch_attn.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def test_flash_attention_rejects_window_without_causal():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="causal"):
        torch_attn.flash_attention(q, q, q, window=4)


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; they never run the plain
    version themselves."""
    q = torch.zeros(1, 64, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        torch_attn.flash_fwd_cuda(q, q, q, True, 0.1, 0, save_lse=True)
    q = torch.zeros(1, 64, 1, 48)
    with pytest.raises(ValueError, match="head_dim"):
        torch_attn.flash_fwd_cuda(q, q, q, True, 0.1, 0, save_lse=True)


def test_mismatch_scales_with_the_typical_element():
    """The kernel-vs-plain readings: a 5% error everywhere fails the bf16
    bars; one element off by 5% of the rms passes them; equal infinities (an
    empty row's LSE) agree; a NaN fails every bar."""
    want = torch.tensor(np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32))
    assert torch_attn.over_tolerance(torch_attn.mismatch(want * 1.05, want), torch.bfloat16)
    one = want.clone()
    one[0, 0] += 0.05 * want.square().mean().sqrt()
    assert not torch_attn.over_tolerance(torch_attn.mismatch(one, want), torch.bfloat16)
    lse = torch.tensor([-math.inf, 1.0, 2.0])
    assert torch_attn.mismatch(lse, lse) == {"rel_l2": 0.0, "elem": 0.0, "max_abs": 0.0}
    nan = torch_attn.mismatch(want * math.nan, want)
    assert len(torch_attn.over_tolerance(nan, torch.float32)) == 2


def test_planted_faults_each_edit_one_line_of_the_sources():
    """ops/plant_faults.py edits copies of the kernel sources; each edit must
    still find its text exactly once (the sources are only read here)."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.plant_faults import CASES, FAULTS, OUTPUTS

    for name, (file, old, new, case, broken) in FAULTS.items():
        assert (_build.CSRC / file).read_text().count(old) == 1, name
        assert old != new and case in CASES and set(broken) <= set(OUTPUTS), name
