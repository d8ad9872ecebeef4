"""ray_tpu_torch's dense KV-cache inference against the JAX package's.

One set of weights (the JAX ``init_params``, carried over by
``params_from_jax``) and one seeded prompt go through both packages, f32 on
the CPU: ``prefill`` (ragged, with a zero-length row), ``decode_step`` /
``decode_chunk`` (aligned and per-row positions, and a write clamped at the
cache's end), ``prefill_chunked``, ``generate`` and ``speculative_generate``.

Tolerances are the JAX package's own (``tests/test_generate.py``): logits
rtol 2e-4, atol 2e-5; cache rows at written positions 1e-5. Greedy tokens
must be identical.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import transformer as tt

# ray_tpu.models exports a function named ``generate`` over its submodule's name.
_jg = importlib.import_module("ray_tpu.models.generate")


class _JaxGenerate:
    """The JAX package's functions, the cache-passing ones under jit (one
    compile per shape, not one per call)."""

    init_cache = staticmethod(_jg.init_cache)
    generate = staticmethod(_jg.generate)
    speculative_generate = staticmethod(_jg.speculative_generate)
    prefill = staticmethod(jax.jit(_jg.prefill, static_argnames=("cfg",)))
    decode_chunk = staticmethod(jax.jit(_jg.decode_chunk, static_argnames=("cfg",)))
    decode_step = staticmethod(jax.jit(_jg.decode_step, static_argnames=("cfg",)))
    prefill_chunked = staticmethod(jax.jit(_jg.prefill_chunked, static_argnames=("cfg", "chunk")))


jg = _JaxGenerate()

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, d_ff=96, max_seq_len=64, remat=False)
LOGITS = dict(rtol=2e-4, atol=2e-5)
CACHE = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass
class Model:
    cfg_j: jt.TransformerConfig
    cfg_t: tt.TransformerConfig
    params_j: dict
    params_t: dict


@pytest.fixture(scope="module")
def models():
    """Builds each (kv_heads, tie, window, layers, seed) model once for the module."""
    built = {}

    def get(kv_heads=4, tie=False, window=0, n_layers=2, seed=0, d_ff=96):
        key = (kv_heads, tie, window, n_layers, seed, d_ff)
        if key not in built:
            kw = dict(SMALL, n_kv_heads=kv_heads, tie_embeddings=tie, sliding_window=window,
                      n_layers=n_layers, d_ff=d_ff)
            cfg_j = jt.TransformerConfig(dtype=jnp.float32, **kw)
            cfg_t = tt.TransformerConfig(dtype=torch.float32, **kw)
            params_j = jt.init_params(jax.random.PRNGKey(seed), cfg_j)
            params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
            built[key] = Model(cfg_j, cfg_t, params_j, params_t)
        return built[key]

    return get


def _tokens(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _caches(m: Model, B, S):
    return jg.init_cache(m.cfg_j, B, S), tg.init_cache(m.cfg_t, B, S, device="cpu")


@pytest.mark.parametrize("kv_heads,tie", [(4, False), (2, False), (2, True)], ids=["mha", "gqa", "gqa-tied"])
def test_prefill_matches_jax_ragged_with_empty_row(models, kv_heads, tie):
    m = models(kv_heads, tie)
    prompt = _tokens(1, (3, 9))
    lens = np.array([0, 5, 9], np.int32)  # a zero-length row is taken as length 1
    cj, ct = _caches(m, 3, 16)
    lj, cj, pj = jg.prefill(m.params_j, jnp.asarray(prompt), cj, m.cfg_j, prompt_lens=jnp.asarray(lens))
    lt, ct2, pt = tg.prefill(m.params_t, torch.tensor(prompt), ct, m.cfg_t, prompt_lens=torch.tensor(lens))
    assert ct2 is ct  # written in place
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    np.testing.assert_array_equal(_np(pt), _np(pj))
    assert _np(pt).tolist() == [1, 5, 9]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name])[:, :, :9], _np(cj[name])[:, :, :9], **CACHE)
        assert not _np(ct[name])[:, :, 9:].any()  # beyond the prompt: untouched zeros
    # Unragged: same logits as JAX, and as each row alone.
    lj, _, _ = jg.prefill(m.params_j, jnp.asarray(prompt), _caches(m, 3, 16)[0], m.cfg_j)
    lt, _, _ = tg.prefill(m.params_t, torch.tensor(prompt), _caches(m, 3, 16)[1], m.cfg_t)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)


@pytest.mark.parametrize("per_row", [False, True], ids=["aligned", "per-row"])
def test_decode_step_and_chunk_match_jax(models, per_row):
    m = models(kv_heads=2)
    prompt, extra, nxt = _tokens(2, (2, 6)), _tokens(3, (2, 3)), _tokens(4, (2,))
    lens = np.array([4, 6], np.int32) if per_row else None
    cj, ct = _caches(m, 2, 16)
    _, cj, pj = jg.prefill(m.params_j, jnp.asarray(prompt), cj, m.cfg_j,
                           prompt_lens=None if lens is None else jnp.asarray(lens))
    _, ct, pt = tg.prefill(m.params_t, torch.tensor(prompt), ct, m.cfg_t,
                           prompt_lens=None if lens is None else torch.tensor(lens))
    pos_j, pos_t = (pj, pt) if per_row else (jnp.int32(6), 6)
    lj, cj = jg.decode_chunk(m.params_j, jnp.asarray(extra), cj, pos_j, m.cfg_j)
    lt, ct = tg.decode_chunk(m.params_t, torch.tensor(extra), ct, pos_t, m.cfg_t)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    pos_j, pos_t = pos_j + 3, (pt + 3 if per_row else 9)
    lj, cj = jg.decode_step(m.params_j, jnp.asarray(nxt), cj, pos_j, m.cfg_j)
    lt, ct = tg.decode_step(m.params_t, torch.tensor(nxt), ct, pos_t, m.cfg_t)
    assert lt.shape == (2, m.cfg_t.vocab_size) and lt.dtype == torch.float32
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    end = 10  # every row written so far lies below this position
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name])[:, :, :end], _np(cj[name])[:, :, :end], **CACHE)


def test_decode_write_is_clamped_at_the_cache_end(models):
    """lax.dynamic_update_slice clamps the start so that all q rows land in
    the cache; the port writes the same rows, for scalar and per-row pos."""
    m = models(kv_heads=2)
    prompt, extra = _tokens(5, (2, 8)), _tokens(6, (2, 3))
    for pos in (11, np.array([11, 10], np.int32)):
        cj, ct = _caches(m, 2, 12)
        _, cj, _ = jg.prefill(m.params_j, jnp.asarray(prompt), cj, m.cfg_j)
        _, ct, _ = tg.prefill(m.params_t, torch.tensor(prompt), ct, m.cfg_t)
        lj, cj = jg.decode_chunk(m.params_j, jnp.asarray(extra), cj, jnp.asarray(pos), m.cfg_j)
        lt, ct = tg.decode_chunk(m.params_t, torch.tensor(extra), ct, torch.as_tensor(pos), m.cfg_t)
        np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(ct[name]), _np(cj[name]), **CACHE)
        assert _np(ct["k"])[:, :, 9:].any()  # rows 9..11 written, the start clamped to S - q


def test_prefill_chunked_matches_jax_and_rejects_ragged_chunks(models):
    m = models()
    prompt = _tokens(7, (2, 12))
    cj, ct = _caches(m, 2, 16)
    lj, cj, pj = jg.prefill_chunked(m.params_j, jnp.asarray(prompt), cj, m.cfg_j, chunk=4)
    lt, ct, pt = tg.prefill_chunked(m.params_t, torch.tensor(prompt), ct, m.cfg_t, chunk=4)
    np.testing.assert_allclose(_np(lt), _np(lj), **LOGITS)
    np.testing.assert_array_equal(_np(pt), _np(pj))
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(ct[name])[:, :, :12], _np(cj[name])[:, :, :12], **CACHE)
    one, _, _ = tg.prefill(m.params_t, torch.tensor(prompt), _caches(m, 2, 16)[1], m.cfg_t)
    np.testing.assert_allclose(_np(lt), _np(one), **LOGITS)
    with pytest.raises(ValueError, match="divisible"):
        tg.prefill_chunked(m.params_t, torch.tensor(prompt), _caches(m, 2, 16)[1], m.cfg_t, chunk=5)


@pytest.mark.parametrize(
    "kv_heads,tie,window",
    [(4, False, 0), (2, False, 0), (4, True, 0), (2, True, 8)],
    ids=["mha", "gqa", "mha-tied", "gqa-tied-window8"],
)
def test_greedy_generate_matches_jax(models, kv_heads, tie, window):
    m = models(kv_heads, tie, window)
    prompt = _tokens(8, (2, 7))
    want = _np(jg.generate(m.params_j, jnp.asarray(prompt), m.cfg_j, max_new_tokens=10, temperature=0.0))
    got = tg.generate(m.params_t, torch.tensor(prompt), m.cfg_t, max_new_tokens=10, temperature=0.0)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(_np(got), want)


def test_greedy_generate_ragged_matches_jax_and_solo_rows(models):
    m = models(kv_heads=2)
    rows = [_tokens(10 + i, (n,)) for i, n in enumerate((3, 7, 5))]
    padded = np.stack([np.pad(r, (0, 7 - len(r)), constant_values=99) for r in rows])
    lens = np.array([len(r) for r in rows], np.int32)
    want = _np(jg.generate(m.params_j, jnp.asarray(padded), m.cfg_j, max_new_tokens=6,
                           prompt_lens=jnp.asarray(lens)))
    got = _np(tg.generate(m.params_t, torch.tensor(padded), m.cfg_t, max_new_tokens=6,
                          prompt_lens=torch.tensor(lens)))
    np.testing.assert_array_equal(got, want)
    for i, r in enumerate(rows):
        solo = _np(tg.generate(m.params_t, torch.tensor(r[None]), m.cfg_t, max_new_tokens=6))[0]
        np.testing.assert_array_equal(got[i], solo, err_msg=f"row {i}")


def test_speculative_greedy_is_exact(models):
    """Greedy speculative decoding gives the port's generate() tokens, JAX's
    tokens, and JAX's number of target passes; a perfect draft collapses
    the passes to ceil((max_new - 1) / (k + 1))."""
    m, d = models(kv_heads=2), models(n_layers=1, seed=9, d_ff=64)
    prompt = _tokens(11, (2, 6))
    want = _np(tg.generate(m.params_t, torch.tensor(prompt), m.cfg_t, max_new_tokens=12))
    np.testing.assert_array_equal(
        want, _np(jg.generate(m.params_j, jnp.asarray(prompt), m.cfg_j, max_new_tokens=12)))
    got, rounds = tg.speculative_generate(m.params_t, d.params_t, torch.tensor(prompt), m.cfg_t, d.cfg_t,
                                          max_new_tokens=12, k=3)
    got_j, rounds_j = jg.speculative_generate(m.params_j, d.params_j, jnp.asarray(prompt), m.cfg_j, d.cfg_j,
                                              max_new_tokens=12, k=3)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got_j), want)
    assert rounds == int(rounds_j) and 1 <= rounds <= 12
    got2, rounds2 = tg.speculative_generate(m.params_t, m.params_t, torch.tensor(prompt), m.cfg_t, m.cfg_t,
                                            max_new_tokens=12, k=3)
    np.testing.assert_array_equal(_np(got2), want)
    assert rounds2 <= 4, rounds2


def test_speculative_sampling_perfect_draft_accepts_everything(models):
    """With the target as its own draft, p == q: every proposal is accepted
    (u * q < p for u < 1), so the passes collapse as in the greedy case;
    the draws are reproducible from the seed and in the vocabulary."""
    m = models(kv_heads=2)
    prompt = torch.tensor(_tokens(12, (2, 6)))
    runs = [tg.speculative_generate(m.params_t, m.params_t, prompt, m.cfg_t, m.cfg_t, max_new_tokens=12, k=3,
                                    temperature=0.8, top_p=0.9, key=seed) for seed in (3, 3, 4)]
    (a, rounds), (b, _), (c, _) = runs
    assert rounds <= 4, rounds
    np.testing.assert_array_equal(_np(a), _np(b))
    assert not np.array_equal(_np(a), _np(c))
    assert ((_np(a) >= 0) & (_np(a) < m.cfg_t.vocab_size)).all()


def test_sampling_is_seeded_and_respects_top_k(models):
    m = models()
    prompt = torch.tensor(_tokens(13, (2, 4)))
    kw = dict(max_new_tokens=6, temperature=0.8, top_k=16)
    a = _np(tg.generate(m.params_t, prompt, m.cfg_t, key=7, **kw))
    b = _np(tg.generate(m.params_t, prompt, m.cfg_t, key=torch.Generator().manual_seed(7), **kw))
    c = _np(tg.generate(m.params_t, prompt, m.cfg_t, key=8, **kw))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < m.cfg_t.vocab_size)).all()
    # top_k = 1 leaves one candidate: sampling is greedy.
    greedy = _np(tg.generate(m.params_t, prompt, m.cfg_t, max_new_tokens=6))
    np.testing.assert_array_equal(_np(tg.generate(m.params_t, prompt, m.cfg_t, max_new_tokens=6,
                                                  temperature=0.8, top_k=1, key=5)), greedy)
    # Every draw lies in its row's top k.
    logits = torch.tensor(np.random.default_rng(0).normal(size=(256, 128)), dtype=torch.float32)
    draws = tg._sample(logits, torch.Generator().manual_seed(0), 1.5, 5)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (top5 == draws[:, None]).any(-1).all()


def _jax_draws(monkeypatch, schedule):
    """Route the port's two draw points through the JAX function's own key
    schedule, an iterable of ("cat" | "uni", key) in the order the JAX code
    draws: ``_categorical`` becomes ``jax.random.categorical`` over the log
    of the port's probabilities (as the JAX code samples its processed
    distributions), ``_uniform`` becomes ``jax.random.uniform``. With equal
    distributions the port's draws then equal JAX's."""
    stream = iter(schedule)

    def key(kind):
        want, k = next(stream)
        assert want == kind, f"the port drew {kind!r} where JAX draws {want!r}"
        return k

    def categorical(probs, gen):
        logp = jnp.log(jnp.asarray(probs.numpy()) + 1e-30)
        return torch.tensor(np.asarray(jax.random.categorical(key("cat"), logp, axis=-1))).long()

    def uniform(shape, gen, device):
        return torch.tensor(np.asarray(jax.random.uniform(key("uni"), shape)))

    monkeypatch.setattr(tg, "_categorical", categorical)
    monkeypatch.setattr(tg, "_uniform", uniform)


def _speculative_key_schedule(key, k):
    """JAX ``speculative_generate``'s draws: the first token, then per round
    k + 1 draft tokens, the k acceptance uniforms and the bonus token."""
    key, k0 = jax.random.split(key)
    yield "cat", k0
    while True:
        key, kd, ka, kb = jax.random.split(key, 4)
        for kk in jax.random.split(kd, k + 1):
            yield "cat", kk
        yield "uni", ka
        yield "cat", kb


def _tied_logits(seed, shape=(64, 128)):
    """Logits on a 0.5 grid: many rows have ties at the top-k and top-p cutoffs."""
    return np.round(np.random.default_rng(seed).normal(0, 2, shape) * 2) / 2


@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.7])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.5, 0.05])
def test_processed_probs_match_jax(temperature, top_p):
    """Temperature and the nucleus cutoff: the same kept set as JAX (exact
    zeros; ties at the cutoff all kept) and the same renormalized values."""
    for logits in (np.random.default_rng(21).normal(0, 3, (64, 128)), _tied_logits(22)):
        logits = logits.astype(np.float32)
        want = np.asarray(_jg._processed_probs(jnp.asarray(logits), temperature, top_p))
        got = tg._processed_probs(torch.tensor(logits), temperature, top_p).numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, **LOGITS)


def test_processed_probs_keep_every_tie_at_the_cutoff():
    # probs a > b = b = b > c...: a top_p that ends inside the run of b's keeps all three b's.
    logits = np.array([[2.0, 1.0, 1.0, 1.0, 0.0, -1.0]], np.float32)
    probs = np.exp(logits) / np.exp(logits).sum()
    top_p = float(probs[0, 0] + probs[0, 1] / 2)
    want = np.asarray(_jg._processed_probs(jnp.asarray(logits), 1.0, top_p))
    got = tg._processed_probs(torch.tensor(logits), 1.0, top_p).numpy()
    assert (got[0, :4] > 0).all() and (got[0, 4:] == 0).all()
    np.testing.assert_allclose(got, want, **LOGITS)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.8, 1), (0.8, 5), (1.5, 16)])
def test_truncated_logits_give_jax_samples(temperature, top_k):
    """JAX's ``_sample`` draws argmax(truncated logits + Gumbel(key)); the
    port's truncated logits, with the same Gumbel noise, give the same draw
    for every row and key, and keep exactly the entries at or above the k-th
    largest (ties kept)."""
    logits = _tied_logits(23).astype(np.float32)
    got = tg._truncated_logits(torch.tensor(logits), temperature, top_k).numpy()
    scaled = logits / np.float32(temperature)
    keep = scaled >= np.sort(scaled, axis=-1)[:, -top_k][:, None] if top_k else np.ones_like(scaled, bool)
    np.testing.assert_array_equal(np.isfinite(got), keep)
    np.testing.assert_array_equal(got[keep], scaled[keep])
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(_jg._sample(jnp.asarray(logits), key, temperature, top_k))
        noise = np.asarray(jax.random.gumbel(key, logits.shape))
        np.testing.assert_array_equal((got + noise).argmax(-1), want)


def test_accept_reject_matches_its_definition():
    """One round's verdict against a per-row reading of the rule, for fixed
    u and q: full acceptance (resid = p_k), rejection at 0 and mid-round
    (resid = norm(max(p_r - q_r, 0))), and a degenerate residual (p_r ==
    q_r, resid = p_r)."""
    rng = np.random.default_rng(24)
    B, k, V = 6, 3, 16
    ps = rng.dirichlet(np.ones(V), (B, k + 1)).astype(np.float32)
    qs = rng.dirichlet(np.ones(V), (B, k)).astype(np.float32)
    drafts = rng.integers(0, V, (B, k))
    u = rng.uniform(size=(B, k)).astype(np.float32)
    qs[0], u[0] = ps[0, :k], 0.999  # p == q: every proposal accepted
    u[1, 0] = 1.0  # u * q < p fails at 0 whenever p <= q there
    ps[1, 0, drafts[1, 0]] = qs[1, 0, drafts[1, 0]] / 2
    u[2] = [0.0, 1.0, 0.0]  # accepted once, then rejected
    ps[2, 1, drafts[2, 1]] = qs[2, 1, drafts[2, 1]] / 2
    u[3] = [1.0, 0.0, 0.0]  # rejected at 0 with p_0 == q_0: a zero residual
    ps[3, 0] = qs[3, 0]
    accepted, resid = tg._accept_reject(*(torch.tensor(a) for a in (ps, qs, drafts, u)))
    for b in range(B):
        r = 0
        while r < k and u[b, r] * qs[b, r, drafts[b, r]] < ps[b, r, drafts[b, r]]:
            r += 1
        left = np.maximum(ps[b, r] - qs[b, r], 0) if r < k else ps[b, k]
        want = left / left.sum() if left.sum() > 1e-30 else ps[b, r]
        assert int(accepted[b]) == r, b
        np.testing.assert_allclose(resid[b].numpy(), want, rtol=1e-6, atol=1e-7, err_msg=f"row {b}")
    assert accepted.tolist()[:4] == [3, 0, 1, 0]


@pytest.mark.parametrize("top_k", [0, 16])
def test_sampled_generate_matches_jax_on_its_key_schedule(models, monkeypatch, top_k):
    """Drawn from JAX's own keys, the port's sampled tokens equal JAX
    ``generate``'s: the truncation and the distribution drawn from agree."""
    m = models(kv_heads=2)
    prompt = _tokens(15, (2, 5))
    kw = dict(max_new_tokens=10, temperature=0.8, top_k=top_k)
    key = jax.random.PRNGKey(31)
    want = _np(jg.generate(m.params_j, jnp.asarray(prompt), m.cfg_j, key=key, **kw))
    _jax_draws(monkeypatch, (("cat", kk) for kk in jax.random.split(key, kw["max_new_tokens"])))
    got = _np(tg.generate(m.params_t, torch.tensor(prompt), m.cfg_t, **kw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_p", [1.0, 0.8])
def test_speculative_sampling_matches_jax_on_its_key_schedule(models, monkeypatch, top_p):
    """A draft unlike the target, drawn from JAX's own keys: the port's tokens
    and target passes equal JAX ``speculative_generate``'s, so its
    acceptances, residuals and bonus draws agree round by round."""
    m, d = models(kv_heads=2), models(n_layers=1, seed=9, d_ff=64)
    prompt = _tokens(16, (2, 6))
    kw = dict(max_new_tokens=12, k=3, temperature=0.9, top_p=top_p)
    key = jax.random.PRNGKey(32)
    want, rounds_j = jg.speculative_generate(m.params_j, d.params_j, jnp.asarray(prompt), m.cfg_j, d.cfg_j,
                                             key=key, **kw)
    _jax_draws(monkeypatch, _speculative_key_schedule(key, kw["k"]))
    got, rounds = tg.speculative_generate(m.params_t, d.params_t, torch.tensor(prompt), m.cfg_t, d.cfg_t, **kw)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert rounds == int(rounds_j)
    assert rounds > 3, "every proposal was accepted: the rejection branch went untested"


def test_inference_builds_no_autograd_graph(models):
    """The port's params require grad (they are training leaves); the cache
    and logits of the inference paths must not."""
    m = models()
    assert m.params_t["embed"].requires_grad
    cache = tg.init_cache(m.cfg_t, 1, 8, device="cpu")
    logits, cache, _ = tg.prefill(m.params_t, torch.tensor(_tokens(14, (1, 4))), cache, m.cfg_t)
    logits2, cache = tg.decode_step(m.params_t, torch.tensor([3]), cache, 4, m.cfg_t)
    for t in (logits, logits2, cache["k"], cache["v"]):
        assert not t.requires_grad and t.grad_fn is None


def test_mixture_of_experts_raises(models):
    m = models()
    moe = dataclasses.replace(m.cfg_t, num_experts=4)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tg.init_cache(moe, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tg.init_paged_cache(moe, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tg._mlp({}, torch.zeros(1, 1, 64), moe)
