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
        (2, 197, 197, 12, 64, False, 0),  # ViT-B/16: 196 patches + the class token, non-causal
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


@pytest.mark.gpu
def test_engine_on_the_card_matches_dense_generate(cuda):
    """The serving path on the card, f32: the continuous-batching engine's
    greedy tokens (paged cache, chunked prefill, a shared two-block prefix
    served from the prefix cache, a pool small enough to preempt) equal
    dense generate()'s on the same prompts."""
    from ray_tpu_torch.models import generate as tg
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                               max_seq_len=64, dtype=torch.float32, remat=False)
    params = tt.init_params(cfg, seed=0, device=cuda)
    g = torch.Generator().manual_seed(3)
    system = torch.randint(0, 128, (8,), generator=g).tolist()
    prompts = [system + torch.randint(0, 128, (int(n),), generator=g).tolist() for n in (3, 12, 1, 9)]
    eng = LLMEngine(params, cfg, num_slots=2, block_size=4, max_model_len=40, num_blocks=13, prefill_chunk=4)
    try:
        outs = [r.result(timeout=60) for r in [eng.submit(p, max_new_tokens=20) for p in prompts]]
        assert eng.stats()["preemptions"] >= 1
        assert eng.stats()["prefix_hit_blocks"] >= 2
    finally:
        eng.shutdown()
    for p, out in zip(prompts, outs):
        assert out == tg.generate(params, torch.tensor([p], device=cuda), cfg, max_new_tokens=20)[0].tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ring_chunks_match_the_plain_chunk(cuda, dtype):
    """Ring attention's chunk function on the forward kernel (with its LSE)
    against ``_xla_chunk``, the chunk's plain version, at sp = 4's offsets
    for the third rank: K after Q is masked and launches nothing, the
    diagonal runs causal, a chunk below it and the non-causal ring run the
    kernel without a mask."""
    from ray_tpu_torch.parallel import ring_attention as R

    g = torch.Generator(device=cuda).manual_seed(2)
    Tc = 256
    q, k, v = (torch.randn(2, Tc, 4, 128, generator=g, device=cuda).to(dtype) for _ in range(3))
    scale = 128**-0.5
    q_start = 2 * Tc
    for k_start, causal, launches in [(3 * Tc, True, 0), (2 * Tc, True, 1), (0, True, 1), (3 * Tc, False, 1)]:
        A.reset_launch_counts()
        out, lse = R._flash_chunk(q, k, v, q_start if causal else None, k_start, scale)
        torch.cuda.synchronize()
        assert A.launch_counts()["flash_fwd"] == launches, (k_start, causal)
        want_out, want_lse = R._xla_chunk(q, k, v, q_start, k_start, causal, scale)
        assert out.dtype == torch.float32 and torch.equal(R._empty(lse), R._empty(want_lse))
        if launches:
            _close(out, want_out, dtype, f"out k_start={k_start} causal={causal}")
            _close(lse, want_lse, dtype, f"lse k_start={k_start} causal={causal}")
        else:
            assert not out.any() and R._empty(lse).all()


@pytest.mark.gpu
def test_nccl_group_of_one_allreduces_on_the_card(cuda):
    """A world-1 NCCL group (ray_tpu_torch.util.collective, backend "nccl"):
    the allreduce runs through NCCL on the card and its result stays there."""
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="nccl", group_name="gpu-test")
    try:
        x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
        out = col.allreduce(x, "gpu-test")
        torch.cuda.synchronize()
        assert out.device.type == "cuda" and torch.equal(out, x)
        assert torch.equal(col.allgather(x, "gpu-test")[0], x)
    finally:
        col.destroy_collective_group("gpu-test")


@pytest.mark.gpu
def test_cuda_device_object_resolves_in_a_second_actor(cuda):
    """A CUDA tensor held under tensor_transport= by one actor is resolved
    by another over a shared group: the same bits, still on the card."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import collective as col

    @rt.remote(tensor_transport="collective", num_gpus=0.25)
    class Holder:
        def init_collective(self, world, rank, backend, group):
            col.init_collective_group(world, rank, backend=backend, group_name=group)

        def make(self):
            g = torch.Generator(device="cuda").manual_seed(4)
            return torch.randn(1 << 20, generator=g, device="cuda").to(torch.bfloat16)

    @rt.remote(num_gpus=0.25)
    class Consumer:
        def init_collective(self, world, rank, backend, group):
            col.init_collective_group(world, rank, backend=backend, group_name=group)

        def take(self, refs):
            v = rt.get(refs[0])
            g = torch.Generator(device="cuda").manual_seed(4)
            want = torch.randn(1 << 20, generator=g, device="cuda").to(torch.bfloat16)
            return str(v.device), torch.equal(v, want)

    rt.init(num_cpus=2, num_gpus=1)
    try:
        h, c = Holder.remote(), Consumer.remote()
        col.create_collective_group([h, c], backend="cpu", group_name="pair")
        ref = h.make.remote()
        device, equal = rt.get(c.take.remote([ref]), timeout=120)
        assert device.startswith("cuda") and equal
    finally:
        rt.shutdown()
