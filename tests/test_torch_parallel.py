"""ray_tpu_torch's parallelism strategies against the JAX package's.

Counterparts of ``tests/test_parallel.py``: the mesh and its sharding rules,
ring and Ulysses attention, the GPipe pipeline and the expert-parallel MoE
layer. The port runs on one module-scoped pool of 4 gloo ranks
(``RankPool``, spawned once, ports from binding port 0; no process group in
the test process); the JAX side runs here on the first 4 of the conftest's
8 virtual CPU devices. Inputs come from numpy seeds. Tolerances are the
reference tests' own: attention outputs atol 2e-5, ring gradients atol 2e-4
and rtol 1e-3, pipeline outputs atol 1e-5; the MoE layer 1e-5 (as
``test_torch_moe.py``). About 55 s on an 8-core CPU host, most of it the
ring gradients at T 512, JAX's compiles and the pool's start.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_parallel_ranks as ranks
from ray_tpu.ops.attention import _xla_attention
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.ring_attention import ring_attention as j_ring
from ray_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from ray_tpu_torch.ops import attention as A
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import ring_attention as tring
from ray_tpu_torch.parallel.multichip import RankPool

N = 4  # ranks in the pool, and JAX devices on the reference's meshes


@pytest.fixture(scope="module")
def pool():
    with RankPool(N) as p:
        yield p


def _jax_mesh(**axes):
    return jmesh.create_mesh(jmesh.MeshConfig(**axes), devices=jax.devices()[:N])


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3)]


def test_mesh_resolve():
    for cls in (jmesh.MeshConfig, tmesh.MeshConfig):
        assert cls(dp=2, tp=-1).resolve(8) == {"pp": 1, "dp": 2, "fsdp": 1, "sp": 1, "ep": 1, "tp": 4}
        with pytest.raises(ValueError, match="at most one"):
            cls(dp=-1, tp=-1).resolve(8)
        with pytest.raises(ValueError, match="does not cover"):
            cls(dp=3).resolve(8)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER and tmesh.DEFAULT_RULES == jmesh.DEFAULT_RULES


def test_create_mesh_axes(pool):
    """Every name reads (1 where absent), the DeviceMesh holds the live axes
    only, ranks lie in AXIS_ORDER with tp innermost (the JAX mesh's device
    order), and each axis's group has its size."""
    got = pool.run(ranks.mesh_layout, {"dp": 2, "tp": 2})
    jm = _jax_mesh(dp=2, tp=2)
    assert dict(jm.shape) == got[0][0]
    assert got[0][0] == {"pp": 1, "dp": 2, "fsdp": 1, "sp": 1, "ep": 1, "tp": 2}
    for r, (_, index, groups, grid, names) in enumerate(got):
        assert names == ("dp", "tp") and grid == [[0, 1], [2, 3]]
        assert index == {"dp": r // 2, "tp": r % 2} and groups == {"dp": 2, "tp": 2}
        dev = jax.devices()[r]
        assert index == {a: int(np.argwhere(jm.devices == dev)[0][jm.axis_names.index(a)]) for a in index}
    one = pool.run(ranks.mesh_layout, {"sp": 4})[3]
    assert one[0]["sp"] == 4 and one[1] == {"sp": 3} and one[4] == ("sp",)


def test_logical_to_spec_and_placements(pool):
    """The same specs as the JAX package's, and each rank's shard of a
    tensor laid out by them equals the JAX device's shard of the same array
    under the same spec (dims over two axes nest dp outside fsdp)."""
    for logical in [("batch", "seq", "embed"), ("vocab", "embed"), ("layers", "expert", "embed", "mlp"), (None,)]:
        assert tuple(tmesh.logical_to_spec(logical)) == tuple(jmesh.logical_to_spec(logical))
    spec = tmesh.logical_to_spec(("batch", "seq", "embed"))
    assert spec[0] == ("dp", "fsdp") and spec[1] == "sp"
    rng = np.random.default_rng(0)
    cases = [(("batch", "seq"), rng.standard_normal((8, 6)).astype(np.float32)),
             (("vocab", "embed"), rng.standard_normal((8, 4)).astype(np.float32)),
             (("layers", "embed", "heads"), rng.standard_normal((4, 4, 8)).astype(np.float32)),
             (("layers", "expert", "embed", "mlp"), rng.standard_normal((2, 4, 4, 4)).astype(np.float32))]
    for axes in ({"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}, {"pp": 2, "ep": 2}):
        got = pool.run(ranks.local_shards, axes, cases)
        jm = _jax_mesh(**axes)
        for i, (logical, arr) in enumerate(cases):
            index = NamedSharding(jm, jmesh.logical_to_spec(logical)).devices_indices_map(arr.shape)
            for r in range(N):
                np.testing.assert_array_equal(got[r][i], arr[index[jax.devices()[r]]], err_msg=f"{axes} {logical} rank {r}")


def test_placements_refuse_axes_out_of_order():
    class FakeMesh:
        shape = {"pp": 1, "dp": 2, "fsdp": 2, "sp": 1, "ep": 1, "tp": 1}
        dim_names = ("dp", "fsdp")

    with pytest.raises(ValueError, match="out of mesh order"):
        tmesh.spec_to_placements(tmesh.PartitionSpec(("fsdp", "dp")), FakeMesh(), 1)
    with pytest.raises(ValueError, match="shards two dims"):
        tmesh.spec_to_placements(tmesh.PartitionSpec("dp", "dp"), FakeMesh(), 2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_exact(pool, causal):
    q, k, v = _qkv(0, 2, 64, 4, 16)
    want = np.asarray(j_ring(*map(jnp.asarray, (q, k, v)), _jax_mesh(sp=4), causal=causal))
    np.testing.assert_allclose(want, np.asarray(_xla_attention(q, k, v, causal, 16**-0.5)), atol=2e-5)
    for axes in ({"sp": 4}, {"sp": 2, "dp": 2}):
        for got in pool.run(ranks.attention, "ring", axes, q, k, v, causal):
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(axes))


def test_ring_refuses_the_kernel_on_the_cpu(pool):
    assert "impl='plain'" in pool.run(ranks.ring_impl_error, {"sp": 4})[0]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match_reference(pool, causal):
    """The ring-level gradient (a second ring pass) against jax.grad of
    plain attention, at the reference test's shape."""
    B, T, H, D = 1, 512, 2, 128
    q, k, v = _qkv(1, B, T, H, D)
    sc = 1.0 / math.sqrt(D)
    want = jax.grad(lambda q, k, v: _xla_attention(q, k, v, causal, sc).sum(), argnums=(0, 1, 2))(q, k, v)
    out, grads = pool.run(ranks.attention, "ring", {"sp": 4}, q, k, v, causal, True)[1]
    np.testing.assert_allclose(out, np.asarray(_xla_attention(q, k, v, causal, sc)), atol=2e-5)
    for name, g, w in zip("qkv", grads, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=1e-3, err_msg=f"d{name}")


def test_ring_chunk_cases_match_the_plain_chunk():
    """The kernel chunk's three cases (its plain forward standing in for
    the kernel) against ``_xla_chunk`` at sp = 4's offsets; the masked case
    launches nothing and gives a -inf LSE where ``_xla_chunk`` gives -1e30,
    and ``_combine`` takes either as empty: a fully masked row (causal,
    rank 0, every chunk after the first) leaves the result as it was."""
    q, k, v = (torch.tensor(x) for x in _qkv(2, 2, 16, 2, 32))
    sc = 32**-0.5
    plain = lambda *a: A._plain_flash_fwd(*a[:6])  # noqa: E731 — the kernel's signature, save_lse dropped
    calls = []
    counted = lambda *a: calls.append(a[3]) or plain(*a)  # noqa: E731
    for q_start, k_start in [(16, 32), (16, 16), (16, 0)]:  # masked, diagonal, below
        out, lse = tring._flash_chunk(q, k, v, q_start, k_start, sc, fwd=counted)
        want_out, want_lse = tring._xla_chunk(q, k, v, q_start, k_start, True, sc)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=2e-6)
        assert torch.equal(tring._empty(lse), tring._empty(want_lse))
        np.testing.assert_allclose(lse[~tring._empty(lse)].numpy(), want_lse[~tring._empty(want_lse)].numpy(),
                                   atol=2e-6)
    assert calls == [True, False]  # the diagonal causal, below it not; the masked case no call
    out, lse = tring._flash_chunk(q, k, v, None, 48, sc, fwd=counted)  # not causal: always a full block
    np.testing.assert_allclose(out.numpy(), tring._xla_chunk(q, k, v, 0, 48, False, sc)[0].numpy(), atol=2e-6)

    acc, run = tring._xla_chunk(q, k, v, 0, 0, True, sc)
    for masked in (tring._flash_chunk(q, k, v, 0, 16, sc, fwd=counted), tring._xla_chunk(q, k, v, 0, 16, True, sc)):
        got, got_lse = tring._combine(acc, run, *masked)
        assert torch.equal(got, acc) and torch.equal(got_lse, run)
    empty = torch.full_like(run, -math.inf)
    got, got_lse = tring._combine(torch.zeros_like(acc), empty, torch.zeros_like(acc), empty)
    assert not got.isnan().any() and torch.equal(got, torch.zeros_like(acc)) and tring._empty(got_lse).all()


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_exact(pool, causal):
    q, k, v = _qkv(3, 2, 64, 4, 16)
    want = np.asarray(j_ulysses(*map(jnp.asarray, (q, k, v)), _jax_mesh(sp=4), causal=causal))
    for axes in ({"sp": 4}, {"sp": 2, "dp": 2}):
        for got in pool.run(ranks.attention, "ulysses", axes, q, k, v, causal):
            np.testing.assert_allclose(got, want, atol=2e-5, err_msg=str(axes))


def _stages(seed, n_stages=4, d=8):
    return (np.random.default_rng(seed).standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)


def _jax_pipeline(ws, x, M):
    from ray_tpu.parallel.pipeline import pipeline_apply

    return pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(x), _jax_mesh(pp=4),
                          num_microbatches=M)


def _sequential(ws, x):
    for w in ws:
        x = np.tanh(x @ w)
    return x


def test_pipeline_matches_sequential(pool):
    ws = _stages(1)
    x = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    want = np.asarray(_jax_pipeline(ws, x, 4))
    np.testing.assert_allclose(want, _sequential(ws, x), atol=1e-5)
    for got in pool.run(ranks.pipeline, {"pp": 4}, ws, x, 4):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_pipeline_microbatches_exceed_stages(pool):
    ws = _stages(3)
    for M in (8, 16):
        x = np.random.default_rng(M).standard_normal((M * 2, 8)).astype(np.float32)
        want = np.asarray(_jax_pipeline(ws, x, M))
        for got in pool.run(ranks.pipeline, {"pp": 4}, ws, x, M):
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_pipeline_non_divisible_batch_asserts(pool):
    ws = _stages(4)
    x = np.random.default_rng(5).standard_normal((10, 8)).astype(np.float32)  # 10 % 4 != 0
    with pytest.raises(AssertionError, match="not divisible"):
        _jax_pipeline(ws, x, 4)
    for got in pool.run(ranks.pipeline, {"pp": 4}, ws, x, 4):
        assert got == "AssertionError: batch 10 not divisible by microbatches 4"


def test_pipeline_gradients_match_jax(pool):
    """The reverse schedule's gradients (stacked weights and input) against
    jax.grad of the reference pipeline and of the sequential stages."""
    ws = _stages(6)
    x = np.random.default_rng(7).standard_normal((16, 8)).astype(np.float32)

    def seq(ws, x):
        for i in range(ws.shape[0]):
            x = jnp.tanh(x @ ws[i])
        return x.sum()

    want = jax.grad(lambda w, x: _jax_pipeline(w, x, 8).sum(), argnums=(0, 1))(ws, x)
    want_seq = jax.grad(seq, argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    for a, b in zip(want, want_seq):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    for y, g_ws, g_x in pool.run(ranks.pipeline, {"pp": 4}, ws, x, 8, True):
        np.testing.assert_allclose(y, _sequential(ws, x), atol=1e-5)
        np.testing.assert_allclose(g_ws, np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(g_x, np.asarray(want[1]), atol=1e-5)


def test_moe_expert_parallel_sharding(pool):
    """Experts sharded over ep = 4: the layer (routing over each rank's rows,
    all_to_all to the experts and back) equals the meshless layer, and both
    the JAX package's layer under its ep-sharded experts."""
    from jax.sharding import PartitionSpec as P

    from ray_tpu.parallel.moe import moe_layer as j_moe
    from ray_tpu_torch.parallel.moe import moe_layer as t_moe

    rng = np.random.default_rng(0)
    D, F, E = 16, 32, 4
    params = {"gate": (rng.standard_normal((D, E)) * D**-0.5).astype(np.float32),
              "wi": (rng.standard_normal((E, D, F)) * D**-0.5).astype(np.float32),
              "wo": (rng.standard_normal((E, F, D)) * F**-0.5).astype(np.float32)}
    x = rng.standard_normal((4, 32, D)).astype(np.float32)
    jm = _jax_mesh(ep=4)
    placed = {n: jax.device_put(p, NamedSharding(jm, P("ep") if p.ndim == 3 else P())) for n, p in params.items()}
    out_j, aux_j = jax.jit(lambda p, x: j_moe(p, x, capacity_factor=2.0))(placed, jnp.asarray(x))
    with torch.no_grad():
        out_t, aux_t = t_moe({n: torch.tensor(p) for n, p in params.items()}, torch.tensor(x), capacity_factor=2.0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    for out, aux, wi in pool.run(ranks.moe_expert_parallel, {"ep": 4}, params, x, 2.0):
        assert wi == "(Shard(dim=0),)"
        np.testing.assert_allclose(out, out_t.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, aux_t.item(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux, float(aux_j), rtol=1e-5, atol=1e-6)
