"""ray_tpu_torch's continuous-batching LLMEngine against the JAX package's.

Both engines run the JAX engine test's tiny model (``MODEL``, f32, on the
CPU) with the same weights (``params_from_jax``) and the same requests.
Tokens, greedy and seeded sampling, must be identical: the port samples on
the host with the JAX engine's counter-based numpy stream, so equal logits
give equal draws. Where the schedule must be the same step for step
(``stats()`` counts under a small pool), both schedulers are driven by hand
on the test thread, their threads stopped, as the JAX engine's own white-box
tests do.

A mixture-of-experts model runs the same schedule against both engines.

Every threaded engine is shut down in ``finally``; every ``result()`` has a
timeout of 60 s or less.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu.serve.llm import block_hashes as jax_block_hashes
from ray_tpu.serve.llm import prefix_route_hint as jax_route_hint
from ray_tpu_torch.models import generate as tg
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve.llm import LLMEngine, block_hashes, prefix_route_hint
from ray_tpu_torch.serve.llm.engine import ReplicaDrainingError
from ray_tpu_torch.serve.llm.stats import ENGINES

# tests/test_serve_llm_engine.py's MODEL
MODEL = dict(vocab_size=128, d_model=48, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=64,
             remat=False)
GEOMETRY = dict(num_slots=3, block_size=4, max_model_len=32, prefill_chunk=4)
SHARED_STATS = ("num_blocks", "free_blocks", "cached_blocks", "running", "waiting", "admitted", "finished",
                "cancelled", "preemptions", "prefix_hit_blocks", "prefix_miss_blocks", "evicted_blocks")


@pytest.fixture(scope="module")
def model():
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, **MODEL)
    cfg_t = tt.TransformerConfig(dtype=torch.float32, **MODEL)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    return params_j, cfg_j, params_t, cfg_t


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 128, n).tolist()


def _by_hand(engine_cls, params, cfg, **kw):
    """An engine whose scheduler thread is stopped, driven by ``_run``."""
    eng = engine_cls(params, cfg, **kw)
    eng.shutdown()  # idle: the loop's exit sweep has nothing to finish
    eng._crashed = None  # white-box: re-open submits
    return eng


def _run(eng, iterations=None, trace=None):
    """The scheduler loop's body on this thread: `iterations` times, or until
    no request is running or waiting. ``trace`` collects the counts after
    every iteration."""
    n = 0
    while (any(r is not None for r in eng._slots) or eng._waiting) and (iterations is None or n < iterations):
        eng._sweep_cancelled()
        eng._admit()
        eng._prefill_tick()
        eng._decode_tick()
        n += 1
        if trace is not None:
            trace.append(_stats(eng))


def _stats(eng):
    s = eng.stats()
    return {k: s[k] for k in SHARED_STATS}


REQUESTS = [  # prompt seed, prompt length, max_new_tokens, sampling
    (1, 7, 6, {}),
    (2, 5, 8, dict(temperature=0.9, top_k=16, seed=7)),
    (3, 11, 5, {}),
    (4, 6, 7, dict(temperature=0.7, seed=123)),
    (5, 9, 6, dict(temperature=1.1, top_k=4, seed=2**40 + 5)),
]


@pytest.mark.parametrize("serial_batch", [False, True], ids=["continuous", "serial"])
def test_schedule_matches_jax_engine_step_for_step(model, serial_batch):
    """Three requests, then two more submitted mid-decode: every token and the
    scheduler's counts equal the JAX engine's after each phase; greedy tokens
    equal the port's dense generate(). ``serial_batch`` (admit only into an
    idle engine, decode only once no slot is prefilling) follows the same
    schedule as JAX's."""
    params_j, cfg_j, params_t, cfg_t = model
    kw = dict(GEOMETRY, serial_batch=serial_batch)
    engines = [_by_hand(JaxEngine, params_j, cfg_j, **kw), _by_hand(LLMEngine, params_t, cfg_t, **kw)]
    outs = []
    for eng in engines:
        trace = []
        reqs = [eng.submit(_prompt(s, n), max_new_tokens=m, **kw) for s, n, m, kw in REQUESTS[:3]]
        _run(eng, iterations=6, trace=trace)
        reqs += [eng.submit(_prompt(s, n), max_new_tokens=m, **kw) for s, n, m, kw in REQUESTS[3:]]
        mid = _stats(eng)
        _run(eng, trace=trace)
        outs.append(([r.result(timeout=5) for r in reqs], mid, _stats(eng), trace))
    (tok_j, mid_j, end_j, trace_j), (tok_t, mid_t, end_t, trace_t) = outs
    assert tok_t == tok_j
    assert mid_t == mid_j and end_t == end_j
    assert trace_t == trace_j  # the same admissions and finishes, iteration by iteration
    assert end_t["admitted"] == 5 and end_t["finished"] == 5
    for (s, n, m, kw), toks in zip(REQUESTS, tok_t):
        assert len(toks) == m
        if not kw:
            dense = tg.generate(params_t, torch.tensor([_prompt(s, n)]), cfg_t, max_new_tokens=m)
            assert toks == dense[0].tolist()


def test_threaded_engines_give_the_same_tokens(model):
    """The scheduler threads, requests streamed mid-decode, greedy and
    sampled: the port's tokens equal the JAX engine's, and resumed requests
    continue bit-identically."""
    params_j, cfg_j, params_t, cfg_t = model
    results = []
    for cls, params, cfg in ((JaxEngine, params_j, cfg_j), (LLMEngine, params_t, cfg_t)):
        eng = cls(params, cfg, **GEOMETRY)
        try:
            reqs = [eng.submit(_prompt(s, n), max_new_tokens=m, **kw) for s, n, m, kw in REQUESTS[:3]]
            firsts = [next(iter(r)) for r in reqs]  # decode underway
            reqs2 = [eng.submit(_prompt(s, n), max_new_tokens=m, **kw) for s, n, m, kw in REQUESTS[3:]]
            outs = [[f] + r.result(timeout=60) for f, r in zip(firsts, reqs)]
            outs += [r.result(timeout=60) for r in reqs2]
            s, n, m, kw = REQUESTS[1]
            resumed = eng.submit(_prompt(s, n), max_new_tokens=m, resume_tokens=outs[1][:3], **kw).result(60)
            results.append((outs, resumed))
        finally:
            eng.shutdown()
    (outs_j, resumed_j), (outs_t, resumed_t) = results
    assert outs_t == outs_j
    assert resumed_t == resumed_j == outs_t[1][3:]


def test_prefix_hits_evictions_and_preemptions_match_jax(model):
    """A small pool: shared-prefix admissions hit the prefix cache, two long
    concurrent requests force a preemption, later prompts evict refs-0 cached
    blocks. Counts after each phase, tokens, and the final block accounting
    equal the JAX engine's."""
    params_j, cfg_j, params_t, cfg_t = model
    kw = dict(num_slots=2, block_size=4, max_model_len=32, num_blocks=13, prefill_chunk=4)
    system = [5, 9, 3, 7, 1, 2, 8, 4]  # two full blocks
    phases = [
        [(system + [11, 13], 4)],
        [(system + [17], 4)],
        [([3] * 6, 20), ([9] * 6, 20)],  # 14 blocks wanted, 12 usable: preemption
        [(_prompt(7, 9), 4)],
        [(_prompt(8, 9), 4)],
        [(_prompt(9, 9), 4)],
    ]
    traces = []
    for cls, params, cfg in ((JaxEngine, params_j, cfg_j), (LLMEngine, params_t, cfg_t)):
        eng, trace = _by_hand(cls, params, cfg, **kw), []
        for phase in phases:
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in phase]
            _run(eng)
            trace.append(([r.result(timeout=5) for r in reqs], _stats(eng)))
        traces.append(trace)
    assert traces[1] == traces[0]
    end = traces[1][-1][1]
    assert end["prefix_hit_blocks"] >= 2 and end["preemptions"] >= 1 and end["evicted_blocks"] >= 1, end
    assert end["free_blocks"] + end["cached_blocks"] == end["num_blocks"]  # no block leaked


def test_moe_engine_matches_jax_engine_and_generate():
    """A mixture-of-experts model (4 experts) behind the engine: chunked
    prefill with padded final chunks, a shared prefix and a pool small
    enough to preempt. Greedy tokens equal the JAX engine's and the port's
    dense generate()'s: lossless routing keeps padding rows and other slots
    from taking a token's expert slot."""
    kw_model = dict(MODEL, num_experts=4)
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, **kw_model)
    cfg_t = tt.TransformerConfig(dtype=torch.float32, **kw_model)
    params_j = jt.init_params(jax.random.PRNGKey(1), cfg_j)
    params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    system = _prompt(11, 8)  # two full blocks
    prompts = [(system + _prompt(12, 3), 6), (system + _prompt(13, 5), 14), ([4] * 7, 14), (_prompt(14, 6), 5)]
    kw = dict(num_slots=2, block_size=4, max_model_len=32, num_blocks=9, prefill_chunk=4)
    outs = []
    for cls, params, cfg in ((JaxEngine, params_j, cfg_j), (LLMEngine, params_t, cfg_t)):
        eng = _by_hand(cls, params, cfg, **kw)
        reqs = [eng.submit(*prompts[0])]
        _run(eng)  # the first request's prefix blocks enter the cache
        reqs += [eng.submit(p, max_new_tokens=m) for p, m in prompts[1:]]
        _run(eng)
        outs.append(([r.result(timeout=5) for r in reqs], _stats(eng)))
    assert outs[1] == outs[0]
    stats = outs[1][1]
    assert stats["preemptions"] >= 1 and stats["prefix_hit_blocks"] >= 2, stats
    for (prompt, m), toks in zip(prompts, outs[1][0]):
        assert toks == tg.generate(params_t, torch.tensor([prompt]), cfg_t, max_new_tokens=m)[0].tolist()


def test_cancel_frees_blocks(model):
    _, _, params_t, cfg_t = model
    eng = LLMEngine(params_t, cfg_t, num_slots=2, block_size=4, max_model_len=64, prefill_chunk=4)
    try:
        req = eng.submit([2] * 5, max_new_tokens=50)
        it = iter(req)
        next(it)  # decode underway
        eng.cancel(req)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = eng.stats()
            if s["running"] == 0 and s["free_blocks"] + s["cached_blocks"] == s["num_blocks"]:
                break
            time.sleep(0.01)
        else:
            pytest.fail(f"blocks not freed after cancel: {eng.stats()}")
        assert eng.stats()["cancelled"] == 1
        assert len(list(it)) < 50  # the stream ended early
    finally:
        eng.shutdown()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_submit_after_a_scheduler_crash_raises(model):
    _, _, params_t, cfg_t = model
    eng = LLMEngine(params_t, cfg_t, num_slots=1, block_size=4, max_model_len=32, prefill_chunk=4)
    try:
        def boom(*_a, **_k):
            raise RuntimeError("boom")

        eng._prefill_fn = boom
        req = eng.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(RuntimeError, match="boom"):
            req.result(timeout=30)
        eng._thread.join(timeout=10)
        assert not eng._thread.is_alive()
        assert eng not in ENGINES
        with pytest.raises(RuntimeError, match="scheduler died"):
            eng.submit([4, 5, 6], max_new_tokens=2)
        with pytest.raises(RuntimeError):
            eng.check_health()
    finally:
        eng.shutdown()


def test_drain_refuses_new_submits_and_finishes_running(model):
    _, _, params_t, cfg_t = model
    eng = LLMEngine(params_t, cfg_t, **GEOMETRY)
    try:
        assert eng in ENGINES
        prompt = _prompt(5, 6)
        req = eng.submit(prompt, max_new_tokens=6)
        eng.drain()
        with pytest.raises(ReplicaDrainingError, match="draining"):
            eng.submit(prompt, max_new_tokens=2)
        assert len(req.result(timeout=60)) == 6
        s = eng.stats()
        assert s["draining"] and s["free_blocks"] + s["cached_blocks"] == s["num_blocks"]
    finally:
        eng.shutdown()
    assert eng not in ENGINES
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1, 2, 3], max_new_tokens=2)


def test_block_hashes_and_route_hint_match_jax():
    for n, bs in ((0, 4), (3, 4), (8, 4), (21, 4), (40, 16)):
        toks = _prompt(n, n)
        assert block_hashes(toks, bs) == jax_block_hashes(toks, bs)
        assert prefix_route_hint(toks, bs) == jax_route_hint(toks, bs)
    assert prefix_route_hint([1, 2, 3], 4) == ""


def test_role_and_cluster_prefix_options(model):
    """The disaggregation options as the JAX engine has them: an unknown role
    is refused; a bare ``role="prefill"`` engine (no core worker, so nothing
    to seal a handoff with) decodes its own requests, and a bare
    ``cluster_prefix=True`` engine has no registry to publish to or probe;
    both give the JAX engine's tokens under the same options, with no handoff
    and no import counted; ``stats()`` has the JAX engine's keys."""
    params_j, cfg_j, params_t, cfg_t = model
    for engine_cls, params, cfg in ((LLMEngine, params_t, cfg_t), (JaxEngine, params_j, cfg_j)):
        with pytest.raises(ValueError, match="role"):
            engine_cls(params, cfg, role="other")
    prompts = [(_prompt(40 + i, 5 + 3 * i), {} if i % 2 else dict(temperature=0.8, top_k=8, seed=i)) for i in range(3)]
    for opts in (dict(role="prefill"), dict(role="decode"), dict(cluster_prefix=True)):
        outs, handoffs, stats = [], [], []
        for engine_cls, params, cfg in ((LLMEngine, params_t, cfg_t), (JaxEngine, params_j, cfg_j)):
            eng = engine_cls(params, cfg, **GEOMETRY, **opts)
            try:
                reqs = [eng.submit(p, max_new_tokens=6, **kw) for p, kw in prompts]
                outs.append([r.result(timeout=60) for r in reqs])
                handoffs.append([r.handoff for r in reqs])
                stats.append(eng.stats())
            finally:
                eng.shutdown()
        assert outs[0] == outs[1], opts
        assert handoffs == [[None] * 3, [None] * 3], opts
        assert set(stats[0]) == set(stats[1]), set(stats[0]) ^ set(stats[1])
        for key in ("role", "handoffs", "handoff_exports", "handoff_failed", "prefix_import_hits",
                    "prefix_import_misses", "prefix_import_errors", "published_prefixes", "pending_exports",
                    "finished"):
            assert stats[0][key] == stats[1][key], (opts, key, stats)
        assert stats[0]["finished"] == 3 and stats[0]["handoff_exports"] == 0


def test_engine_cache_builds_no_autograd_graph(model):
    """The params require grad; the scheduler thread runs under no_grad, so
    after a request no cache tensor requires grad or carries a graph."""
    _, _, params_t, cfg_t = model
    assert params_t["embed"].requires_grad
    eng = LLMEngine(params_t, cfg_t, **GEOMETRY)
    try:
        assert len(eng.submit(_prompt(6, 9), max_new_tokens=4).result(timeout=60)) == 4
        for t in eng._cache.values():
            assert not t.requires_grad and t.grad_fn is None
        assert eng._cache["k"].device == params_t["embed"].device
    finally:
        eng.shutdown()
