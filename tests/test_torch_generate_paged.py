"""ray_tpu_torch's paged KV-cache decode against its dense path and against
the JAX package's paged functions.

The same weights (``params_from_jax``) and seeded tokens, f32 on the CPU:
chunked prefill through ``paged_decode_chunk`` with a shuffled block table,
then decode steps; a multi-slot batch with an inactive slot; ``valid_to``
write routing to the null block; a sliding window; a mixture-of-experts
model. Tolerances are the JAX package's own (``tests/test_generate.py``):
logits rtol 2e-4, atol 2e-5; cache rows at written positions 1e-5. Greedy
tokens must be identical.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import transformer as tt

jg = importlib.import_module("ray_tpu.models.generate")


class _JaxPaged:
    """The JAX package's paged functions under jit (one compile per shape, as
    its engine runs them), for the helpers that take either module."""

    init_paged_cache = staticmethod(jg.init_paged_cache)
    paged_decode_chunk = staticmethod(jax.jit(jg.paged_decode_chunk, static_argnames=("cfg",)))
    paged_decode_step = staticmethod(jax.jit(jg.paged_decode_step, static_argnames=("cfg",)))


jp = _JaxPaged()

SMALL = dict(vocab_size=128, d_model=48, n_layers=2, n_heads=4, d_ff=64, max_seq_len=64, remat=False)
LOGITS = dict(rtol=2e-4, atol=2e-5)
CACHE = dict(rtol=1e-5, atol=1e-5)
BS = 4  # block size


@pytest.fixture(scope="module")
def models():
    """Builds each (kv_heads, window, experts) model once for the module: (JAX cfg,
    JAX params, port cfg, port params)."""
    built = {}

    def get(kv_heads=2, window=0, num_experts=0):
        if (kv_heads, window, num_experts) not in built:
            kw = dict(SMALL, n_kv_heads=kv_heads, sliding_window=window, num_experts=num_experts)
            cfg_j = jt.TransformerConfig(dtype=jnp.float32, **kw)
            cfg_t = tt.TransformerConfig(dtype=torch.float32, **kw)
            params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
            params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
            built[kv_heads, window, num_experts] = (cfg_j, params_j, cfg_t, params_t)
        return built[kv_heads, window, num_experts]

    return get


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(0, 128, size=n).tolist()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arr(mod, x):
    return jnp.asarray(x, jnp.int32) if mod is jp else torch.tensor(x)


def _paged_prefill(mod, params, toks, cache, table, cfg, chunk=4):
    """Chunked prefill of one sequence, as the engine does it: fixed [1,
    chunk] shape, the padded final chunk write-masked through valid_to."""
    T, logits, p = len(toks), None, 0
    while p < T:
        piece = toks[p : p + chunk]
        logits, cache = mod.paged_decode_chunk(
            params, _arr(mod, [piece + [0] * (chunk - len(piece))]), cache, _arr(mod, [table]),
            _arr(mod, [p]), cfg, valid_to=_arr(mod, [T]))
        p += len(piece)
    return logits[:, (T - 1) % chunk], cache


@pytest.mark.parametrize("kv_heads,num_experts", [(4, 0), (2, 0), (2, 4)], ids=["mha", "gqa", "gqa-moe"])
def test_paged_greedy_decode_matches_dense_and_jax(models, kv_heads, num_experts):
    """With experts too: the padded final prefill chunk's rows take expert
    slots of their own (lossless routing), so paged equals dense."""
    cfg_j, params_j, cfg_t, params_t = models(kv_heads, num_experts=num_experts)
    toks, table, n_new = _tokens(1, 7), [5, 2, 7, 1], 6  # fragmented, out of order, never block 0
    pj = jp.init_paged_cache(cfg_j, num_blocks=9, block_size=BS)
    pt = tg.init_paged_cache(cfg_t, num_blocks=9, block_size=BS, device="cpu")
    lj, pj = _paged_prefill(jp, params_j, toks, pj, table, cfg_j)
    lt, pt = _paged_prefill(tg, params_t, toks, pt, table, cfg_t)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    # Dense reference of the port.
    dlogits, dcache, dpos = tg.prefill(params_t, torch.tensor([toks]), tg.init_cache(cfg_t, 1, 32, device="cpu"),
                                       cfg_t)
    np.testing.assert_allclose(_np(lt), _np(dlogits), **LOGITS)
    got, want, cur, pos = [], [], int(lt.argmax()), len(toks)
    dense_cur = int(dlogits.argmax())
    for _ in range(n_new):
        got.append(cur)
        want.append(dense_cur)
        lj, pj = jp.paged_decode_step(params_j, _arr(jp, [cur]), pj, _arr(jp, [table]), _arr(jp, [pos]), cfg_j)
        lt, pt = tg.paged_decode_step(params_t, _arr(tg, [cur]), pt, _arr(tg, [table]), _arr(tg, [pos]), cfg_t)
        np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
        dlogits, dcache = tg.decode_step(params_t, torch.tensor([dense_cur]), dcache, dpos, cfg_t)
        dpos = dpos + 1
        cur, dense_cur, pos = int(lt.argmax()), int(dlogits.argmax()), pos + 1
    assert got == want
    n = len(toks) + n_new - 1  # positions written
    for name in ("k", "v"):
        rows_t = _np(pt[name])[:, table].reshape(cfg_t.n_layers, -1, kv_heads, cfg_t.head_dim)[:, :n]
        rows_j = _np(pj[name])[:, table].reshape(cfg_t.n_layers, -1, kv_heads, cfg_t.head_dim)[:, :n]
        np.testing.assert_allclose(rows_t, rows_j, **CACHE)
        np.testing.assert_allclose(rows_t, _np(dcache[name])[:, 0, :n], **CACHE)


def test_paged_multi_slot_batch_with_an_inactive_slot(models):
    """Slots at different positions plus an INACTIVE slot (token 0, pos 0,
    all-zero table) in one step: each active slot matches JAX and its own
    dense decode; the inactive slot stays finite."""
    cfg_j, params_j, cfg_t, params_t = models()
    seqs = [_tokens(2, 5), _tokens(3, 9)]
    tables = [[6, 2, 4], [1, 5, 3], [0, 0, 0]]
    pj = jp.init_paged_cache(cfg_j, num_blocks=8, block_size=BS)
    pt = tg.init_paged_cache(cfg_t, num_blocks=8, block_size=BS, device="cpu")
    last = []
    for slot, toks in enumerate(seqs):
        _, pj = _paged_prefill(jp, params_j, toks, pj, tables[slot], cfg_j)
        lt, pt = _paged_prefill(tg, params_t, toks, pt, tables[slot], cfg_t)
        last.append(int(lt.argmax()))
    step_tok, step_pos = last + [0], [len(seqs[0]), len(seqs[1]), 0]
    lj, _ = jp.paged_decode_step(params_j, _arr(jp, step_tok), pj, _arr(jp, tables), _arr(jp, step_pos), cfg_j)
    lt, _ = tg.paged_decode_step(params_t, _arr(tg, step_tok), pt, _arr(tg, tables), _arr(tg, step_pos), cfg_t)
    assert torch.isfinite(lt).all(), "the inactive slot leaked non-finite values"
    np.testing.assert_allclose(_np(lt)[:2], _np(lj)[:2], **LOGITS)
    for slot, toks in enumerate(seqs):
        _, dcache, dpos = tg.prefill(params_t, torch.tensor([toks]), tg.init_cache(cfg_t, 1, 16, device="cpu"),
                                     cfg_t)
        ref, _ = tg.decode_step(params_t, torch.tensor([last[slot]]), dcache, dpos, cfg_t)
        np.testing.assert_allclose(_np(lt)[slot], _np(ref)[0], **LOGITS)


def test_paged_valid_to_routes_padded_writes_to_the_null_block(models):
    """A padded chunk writes its real rows where JAX does and its padding
    rows only into block 0: every other block keeps its earlier state."""
    cfg_j, params_j, cfg_t, params_t = models(kv_heads=4)
    table, toks = [1, 2, 3], [7, 3, 9, 1, 5]  # 5 real tokens, chunk 8: 3 padded rows
    fed = toks + [0] * 3
    pj = jp.init_paged_cache(cfg_j, num_blocks=6, block_size=BS)
    pt = tg.init_paged_cache(cfg_t, num_blocks=6, block_size=BS, device="cpu")
    pt["k"][:, 4:] = 1.0  # a block outside the table, already holding rows
    _, pj = jp.paged_decode_chunk(params_j, _arr(jp, [fed]), pj, _arr(jp, [table]), _arr(jp, [0]), cfg_j,
                                  valid_to=_arr(jp, [5]))
    _, pt = tg.paged_decode_chunk(params_t, _arr(tg, [fed]), pt, _arr(tg, [table]), _arr(tg, [0]), cfg_t,
                                  valid_to=_arr(tg, [5]))
    k = _np(pt["k"])
    # Positions 5..7 are rows 1..3 of block 2, block 3 is beyond: untouched.
    assert not k[:, 2, 1:].any() and not k[:, 3].any()
    assert (k[:, 4:] == 1.0).all()
    assert k[:, 0].any()  # the padding rows landed in the null block
    for name in ("k", "v"):  # the real rows: blocks 1 and 2, as JAX writes them
        np.testing.assert_allclose(_np(pt[name])[:, 1:3], _np(pj[name])[:, 1:3], **CACHE)


def test_paged_chunk_matches_dense_chunk_and_jax_with_window(models):
    cfg_j, params_j, cfg_t, params_t = models(window=6)
    toks, extra, table = _tokens(4, 6), [_tokens(5, 3)], [3, 1, 2, 4]
    _, dcache, dpos = tg.prefill(params_t, torch.tensor([toks]), tg.init_cache(cfg_t, 1, 16, device="cpu"), cfg_t)
    dense, _ = tg.decode_chunk(params_t, torch.tensor(extra), dcache, dpos, cfg_t)
    pj = jp.init_paged_cache(cfg_j, num_blocks=5, block_size=BS)
    pt = tg.init_paged_cache(cfg_t, num_blocks=5, block_size=BS, device="cpu")
    _, pj = _paged_prefill(jp, params_j, toks, pj, table, cfg_j, chunk=3)
    _, pt = _paged_prefill(tg, params_t, toks, pt, table, cfg_t, chunk=3)
    lj, _ = jp.paged_decode_chunk(params_j, _arr(jp, extra), pj, _arr(jp, [table]), _arr(jp, [6]), cfg_j)
    lt, _ = tg.paged_decode_chunk(params_t, _arr(tg, extra), pt, _arr(tg, [table]), _arr(tg, [6]), cfg_t)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    np.testing.assert_allclose(_np(lt), _np(dense), **LOGITS)
    assert (_np(lt).argmax(-1) == _np(dense).argmax(-1)).all()
