"""The port's CUDA flash-attention kernels against their plain versions, on
the card. Marked ``gpu``: each test skips, with its reason, where there is no
CUDA device. On a machine with one:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

(``--noconftest``: the suite's conftest imports JAX, which the port and this
file do not need.)

Tolerances: the port's own kernel-vs-plain bars, ``attention.MATCH_TOL``
(relative L2 error, and each element's error against its own size plus the
result's rms; their reasons stand beside them), the same ones chip_smoke.py
holds the kernels to.
"""

import pytest
import torch

from ray_tpu_torch.ops import attention as A

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _close(got, want, dtype, what):
    m = A.mismatch(got, want)
    assert not A.over_tolerance(m, dtype), f"{what}: {A.over_tolerance(m, dtype)} ({m})"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "B,Tq,Tk,H,D,causal,window",
    [
        (2, 256, 256, 4, 128, True, 0),
        (2, 128, 256, 2, 64, True, 0),  # Tq < Tk
        (1, 256, 256, 2, 32, True, 96),  # sliding window
        (2, 192, 192, 2, 64, False, 0),  # non-causal
        (1, 100, 100, 2, 128, True, 0),  # ragged tail, masked in the kernel
    ],
)
def test_kernels_match_plain(cuda, dtype, B, Tq, Tk, H, D, causal, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, Tq, H, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Tk, H, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Tk, H, D, generator=g, device=cuda).to(dtype)
    dout = torch.randn(B, Tq, H, D, generator=g, device=cuda).to(dtype)
    scale = D**-0.5

    out_ref, lse_ref = A._plain_flash_fwd(q, k, v, causal, scale, window)
    out, lse = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=True)
    torch.cuda.synchronize()
    _close(out, out_ref, dtype, "out")
    _close(lse, lse_ref, dtype, "lse")

    grads_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
    grads = A.flash_bwd_cuda(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        _close(got, want, dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_no_grad_forward_skips_lse_and_matches_plain(cuda, dtype):
    """Without a gradient, flash_attention launches the forward kernel with no
    LSE output; its result must still be the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 200, 4, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    A.reset_launch_counts()
    with torch.no_grad():
        out = A.flash_attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize()
    assert A.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    _close(out, A._plain_flash_fwd(q, k, v, True, 64**-0.5, 64)[0], dtype, "out")
    with_lse, _ = A.flash_fwd_cuda(q, k, v, True, 64**-0.5, 64, save_lse=True)
    assert torch.equal(out, with_lse)


@pytest.mark.gpu
def test_autograd_counts_each_kernel_once(cuda):
    q, k, v = (torch.randn(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True) for _ in range(3))
    A.reset_launch_counts()
    A.flash_attention(q, k, v, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    assert A.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_is_deterministic(cuda, dtype):
    """Each gradient element is written by one block, with no atomics: two
    backward runs on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, dout = (torch.randn(2, 320, 4, 128, generator=g, device=cuda).to(dtype) for _ in range(4))
    out, lse = A._plain_flash_fwd(q, k, v, True, 128**-0.5, 0)
    first = A.flash_bwd_cuda(q, k, v, out, lse, dout, True, 128**-0.5, 0)
    second = A.flash_bwd_cuda(q, k, v, out, lse, dout, True, 128**-0.5, 0)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{name} differs between two runs"
