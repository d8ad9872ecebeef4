"""The port's prefill/decode disaggregation and cluster KV prefix tier, against
the JAX package's ``LLMEngine``.

``tests/test_serve_disagg.py``'s tier-1 cases on the port, in one port
cluster (``init(num_gpus=1)`` fakes a GPU node; each replica asks for a
quarter of it and runs the model with ``device="cpu"``), weights
``params_from_jax`` of the JAX ``init_params(PRNGKey(0))``:

- **Handoff, end to end over a real serve instance** (controller, proxy, one
  prefill and two decode replicas from ``disaggregated_llm_app``): a prompt
  prefilled on one pool and decoded on the other gives the same tokens as a
  monolithic port engine and as the JAX engine, greedy and seeded-sampled,
  and the tokens provably rode a handoff (counters and the flight
  recorder's ``llm_kv_handoff``). The decode pool's class is
  ``LLMDeployment`` with each decode step held 10 ms (tokens unchanged) and
  a ``pid`` method, so the kill case can SIGKILL the serving decode
  replica's process (``os.kill``) after a fixed 4 tokens and the proxy
  still migrates the stream mid-way: the client's tokens stay exact.
- **Cluster prefix tier lifecycle, on engines in the driver** (the driver's
  core worker is holder and importer): publish -> import bit-exact, the
  imported blocks equal to the JAX engine's cache blocks for the same prompt
  within 1e-5 (f32); the sealed copy survives the holder's pool churn; a
  freed payload is a typed miss and the importer retracts the stale row; the
  LRU cap retracts; the GCS ``llmprefix/`` rows return to baseline after
  shutdown.

~40 s here.
"""

import json
import os
import signal
import time
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import transformer as jt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import serve
from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve._private.common import CONTROLLER_NAME, PREFIX_HINT_HEADER
from ray_tpu_torch.serve.api import Deployment
from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine, disaggregated_llm_app, prefix_route_hint
from ray_tpu_torch.serve.llm import kv_transfer
from ray_tpu_torch.serve.llm.engine import block_hashes

# tests/test_serve_disagg.py's MODEL, ENGINE and SYSTEM
MODEL = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=48, max_seq_len=64, remat=False)
ENGINE = dict(num_slots=4, block_size=4, max_model_len=64, prefill_chunk=4)
SYSTEM = list(range(3, 3 + 16))  # 4 full blocks shared across prompts


class PacedLLM(LLMDeployment):
    """The decode pool's class here: each decode step held STEP_DELAY_S, so a
    kill after a fixed token count lands while the stream is live."""

    STEP_DELAY_S = 0.01

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        step = self.engine._decode_fn

        def paced(*a):
            time.sleep(self.STEP_DELAY_S)
            return step(*a)

        self.engine._decode_fn = paced

    def pid(self):
        return os.getpid()


@pytest.fixture(scope="module")
def weights():
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, **MODEL)
    cfg_t = tt.TransformerConfig(dtype=torch.float32, **MODEL)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    return params_j, cfg_j, tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu"), cfg_t


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=6, num_gpus=1, object_store_memory=96 * 1024 * 1024)
    try:
        serve.start()
        yield
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()


@pytest.fixture(scope="module")
def disagg_app(cluster, weights):
    app = disaggregated_llm_app(dict(MODEL, dtype="float32"), dict(ENGINE), name="llm", prefill_replicas=1,
                                decode_replicas=2, cluster_prefix=True, ray_actor_options={"num_gpus": 0.25},
                                device="cpu", params=weights[2])
    d = app.deployment
    app.deployment = Deployment(PacedLLM, d.name, d.config, d.route_prefix)
    serve.run(app)


def _jax_oracle(weights, prompt, n, **sampling):
    eng = JaxEngine(weights[0], weights[1], **ENGINE)
    try:
        return eng.submit(prompt, max_new_tokens=n, **sampling).result(60)
    finally:
        eng.shutdown()


def _mono(weights, prompt, n, **sampling):
    """The port's monolithic engine in the driver (no cluster features)."""
    eng = LLMEngine(weights[2], weights[3], **ENGINE)
    try:
        return eng.submit(prompt, max_new_tokens=n, **sampling).result(60)
    finally:
        eng.shutdown()


def _replicas(dep):
    controller = rt.get_actor(CONTROLLER_NAME)
    table = rt.get(controller.get_routing_table.remote(-2, 0.1))["table"]
    return [r["actor_name"] for r in table.get(dep, {}).get("replicas", [])]


def _call(name, method):
    return rt.get(rt.get_actor(name).handle_request.remote(method, (), {}), timeout=15)


def _replica_stats(dep):
    out = []
    for name in _replicas(dep):
        try:
            out.append(_call(name, "get_stats"))
        except Exception:
            pass  # a replica just killed
    return out


def _stream_sse(url, body, headers, kill_after=None):
    """One SSE stream; (tokens, whether [DONE] arrived). ``kill_after``:
    (n, pid) SIGKILLs pid once n tokens have arrived."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers=headers)
    resp = urllib.request.urlopen(req, timeout=120)
    toks, buf = [], b""
    while True:
        chunk = resp.read(64)
        if not chunk:
            return toks, False
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            payload = event[len(b"data: "):]
            if payload == b"[DONE]":
                return toks, True
            toks.append(json.loads(payload)["token"])
            if kill_after is not None and len(toks) == kill_after[0]:
                os.kill(kill_after[1], signal.SIGKILL)


def _flight_events(kind, since_wall):
    procs = flight_recorder.collect_dir(rt._global_node.session_dir)
    return [ev for proc in procs for ev in proc["events"] if ev["type"] == kind and ev["ts"] >= since_wall - 2.0]


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {msg}")


def _wait_kv_restored(deps=("llm", "llm--prefill")):
    """Every live replica's KV pool back to full once idle."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        stats = [s for dep in deps for s in _replica_stats(dep)]
        if stats and all(s["free_blocks"] + s["cached_blocks"] == s["num_blocks"] for s in stats):
            return
        time.sleep(0.25)
    pytest.fail(f"replicas leaked KV blocks: {stats}")


def _run_handoff(weights, prompt, n, sampling, kill=False):
    """One stream through the disaggregated app: its tokens equal the JAX
    engine's and the port's monolithic engine's, and they rode a
    prefill->decode handoff (counters, flight event); with ``kill``, the
    serving decode replica is SIGKILLed after 4 tokens and the stream
    migrates."""
    expect = _jax_oracle(weights, prompt, n, **sampling)
    assert _mono(weights, prompt, n, **sampling) == expect
    host, port = serve.http_address()
    t_wall0 = time.time()
    handoffs0 = sum(s["handoffs"] for s in _replica_stats("llm"))
    exports0 = sum(s["handoff_exports"] for s in _replica_stats("llm--prefill"))
    hint = prefix_route_hint(prompt, ENGINE["block_size"])
    assert hint
    kill_after = None
    if kill:
        _wait(lambda: len(_replicas("llm")) == 2, 180, "both decode replicas")
        actors = _replicas("llm")
        # The prefix hint pins the decode pick, so the victim is known before the request.
        kill_after = (4, _call(actors[zlib.crc32(hint.encode()) % len(actors)], "pid"))
    toks, done = _stream_sse(f"http://{host}:{port}/llm", dict(tokens=prompt, max_new_tokens=n, **sampling),
                             {PREFIX_HINT_HEADER: hint}, kill_after)
    assert done, "stream ended without [DONE]"
    assert toks == expect, (toks, expect)
    assert sum(s["handoff_exports"] for s in _replica_stats("llm--prefill")) > exports0
    if not kill:
        assert sum(s["handoffs"] for s in _replica_stats("llm")) > handoffs0
    assert _flight_events("llm_kv_handoff", t_wall0), "no handoff recorded"
    if kill:
        assert _flight_events("llm_migrate", t_wall0), "no migration"
    _wait_kv_restored()


def test_handoff_byte_identical_greedy(disagg_app, weights):
    _run_handoff(weights, prompt=[3, 1, 4, 1, 5, 9, 2, 6], n=24, sampling={})


def test_handoff_byte_identical_seeded_sampling(disagg_app, weights):
    _run_handoff(weights, prompt=[2, 7, 1, 8, 2, 8, 1, 8], n=24, sampling=dict(temperature=0.9, top_k=16, seed=11))


def test_handoff_decode_kill_midstream_greedy(disagg_app, weights):
    """The serving decode replica is SIGKILLed after the client's 4th token:
    the proxy migrates the stream to the other decode replica (re-prefill and
    teacher-forced resume; the sealed import died with the victim) and the
    client still sees the uninterrupted sequence."""
    _run_handoff(weights, prompt=[1, 6, 1, 8, 0, 3, 3, 9], n=24, sampling={}, kill=True)


# ---------------------------------------------------------------------------
# cluster prefix tier lifecycle (engines in the driver)
# ---------------------------------------------------------------------------


def _mk_engine(weights, **overrides):
    return LLMEngine(weights[2], weights[3], **dict(ENGINE, **overrides))


def _cw():
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker()


def _row(h):
    return kv_transfer.lookup_prefix_row(_cw(), h)


def test_prefix_import_bit_identical_and_local_seed(cluster, weights):
    """Engine A publishes the shared prefix; engine B's registry probe
    imports it, B's tokens equal the JAX engine's, and the imported blocks in
    B's pool equal the JAX engine's cache blocks for the same prompt. The
    import seeds B's LOCAL prefix cache, so its next same-prefix prompt never
    probes the registry again."""
    a = _mk_engine(weights, cluster_prefix=True)
    b = _mk_engine(weights, cluster_prefix=True)
    ref = JaxEngine(weights[0], weights[1], **ENGINE)
    try:
        prompt_b = SYSTEM + [33, 35, 37, 39, 41, 43, 45, 47]
        expect = ref.submit(prompt_b, max_new_tokens=6).result(60)
        a.submit(SYSTEM + [20, 22, 24, 26, 28, 30, 32, 34], max_new_tokens=4).result(60)
        shared = block_hashes(SYSTEM, ENGINE["block_size"])
        _wait(lambda: _row(shared[-1]) is not None, msg="published prefix row")
        out = b.submit(prompt_b, max_new_tokens=6).result(60)
        assert out == expect, (out, expect)
        st = b.stats()
        assert st["prefix_import_hits"] == 1 and st["prefix_import_errors"] == 0, st
        for h in shared:  # the imported blocks, in B's pool, against the JAX engine's
            for name in ("k", "v"):
                got = b._cache[name][:, b._prefix[h].bid].numpy()
                want = np.asarray(ref._cache[name][:, ref._prefix[h].bid])
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        expect2 = ref.submit(SYSTEM + [49, 51, 53, 55], max_new_tokens=4).result(60)
        assert b.submit(SYSTEM + [49, 51, 53, 55], max_new_tokens=4).result(60) == expect2
        assert b.stats()["prefix_import_hits"] == 1, b.stats()
    finally:
        a.shutdown()
        b.shutdown()
        ref.shutdown()


def test_sealed_copy_survives_holder_pool_churn(cluster, weights):
    """The published payload is a SEALED COPY: the holder recycling every
    pool block it was built from cannot tear a later import."""
    a = _mk_engine(weights, cluster_prefix=True)
    b = _mk_engine(weights, cluster_prefix=True)
    try:
        a.submit(SYSTEM + [2, 4, 6, 8], max_new_tokens=2).result(60)
        shared = block_hashes(SYSTEM, ENGINE["block_size"])[-1]
        _wait(lambda: _row(shared) is not None, msg="published prefix row")
        rng = np.random.default_rng(9)
        for _ in range(12):  # distinct unshared prompts overwrite the holder's pool
            a.submit(rng.integers(32, 64, 32).tolist(), max_new_tokens=2).result(60)
        expect = _jax_oracle(weights, SYSTEM + [11, 13, 15, 17], 6)
        assert b.submit(SYSTEM + [11, 13, 15, 17], max_new_tokens=6).result(60) == expect
        assert b.stats()["prefix_import_hits"] == 1, b.stats()
    finally:
        a.shutdown()
        b.shutdown()


def test_freed_payload_is_typed_miss_and_importer_retracts(cluster, weights):
    """The payload died under a still-present row: the importer gets the
    typed miss, recomputes (tokens still exact) and retracts the stale row."""
    a = _mk_engine(weights, cluster_prefix=True)
    b = _mk_engine(weights, cluster_prefix=True)
    try:
        prompt_a = SYSTEM + [20, 22, 24, 26, 28, 30, 32, 34]
        a.submit(prompt_a, max_new_tokens=2).result(60)
        deep = block_hashes(prompt_a, ENGINE["block_size"])[4]
        shared = block_hashes(SYSTEM, ENGINE["block_size"])[-1]
        _wait(lambda: _row(deep) is not None, msg="published prefix row")
        oid = _row(shared)["oid"]
        _cw()._device_manager().free(oid)
        expect = _jax_oracle(weights, SYSTEM + [33, 35, 37, 39], 6)
        assert b.submit(SYSTEM + [33, 35, 37, 39], max_new_tokens=6).result(60) == expect
        st = b.stats()
        assert st["prefix_import_errors"] == 1 and st["prefix_import_hits"] == 0, st
        _wait(lambda: (_row(shared) or {}).get("oid") != oid, msg="stale row retraction")
    finally:
        a.shutdown()
        b.shutdown()


def test_lru_cap_retracts_evicted_rows(cluster, weights):
    a = _mk_engine(weights, cluster_prefix=True, cluster_prefix_max=1)
    try:
        p1 = [10] * 4 + list(range(36, 48))
        p2 = [11] * 4 + list(range(36, 48))
        a.submit(p1, max_new_tokens=2).result(60)
        h1 = block_hashes(p1, ENGINE["block_size"])[-2]
        _wait(lambda: _row(h1) is not None, msg="first prefix row")
        a.submit(p2, max_new_tokens=2).result(60)
        h2 = block_hashes(p2, ENGINE["block_size"])[-2]
        _wait(lambda: _row(h2) is not None, msg="second prefix row")
        _wait(lambda: _row(h1) is None, msg="evicted prefix row retraction")
        assert a.stats()["published_prefixes"] == 1, a.stats()
    finally:
        a.shutdown()


def test_gcs_rows_return_to_baseline_after_shutdown(cluster, weights):
    def row_count():
        return len(_cw().gcs.call("kv_keys", {"prefix": kv_transfer.PREFIX_ROW}, timeout=10).get("keys", []))

    baseline = row_count()
    a = _mk_engine(weights, cluster_prefix=True)
    b = _mk_engine(weights, cluster_prefix=True)
    try:
        rng = np.random.default_rng(3)
        for eng in (a, b):
            for _ in range(2):
                eng.submit(rng.integers(0, 64, 24).tolist(), max_new_tokens=2).result(60)
        _wait(lambda: row_count() > baseline, msg="published rows")
    finally:
        a.shutdown()
        b.shutdown()
    _wait(lambda: row_count() <= baseline, msg="rows retracted on shutdown")
