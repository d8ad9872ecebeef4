"""The port's ``LLMDeployment`` behind ``serve.run`` and HTTP, against the
JAX package's ``LLMEngine``.

``tests/test_serve_llm.py``'s two cases on the port: its tiny model (f32) in
a replica that asks for half a card (``init(num_gpus=1)`` fakes a GPU node
here; the model runs with ``device="cpu"``), the weights ``params_from_jax``
of the JAX ``init_params(PRNGKey(0))``. Greedy and seeded-sampling tokens,
over SSE and buffered, must equal an in-process JAX ``LLMEngine``'s on the
same weights, geometry and prompts exactly; so must concurrent streams. A
client that disconnects mid-stream frees its decode slot and KV blocks.

The module boots one port cluster (a controller, a proxy and one replica);
~25 s here.
"""

import concurrent.futures
import http.client
import json
import socket
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import transformer as jt
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve.llm import LLMDeployment

# tests/test_serve_llm.py's TinyLM
MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=64, max_seq_len=32, remat=False)
ENGINE = dict(num_slots=4, block_size=4, max_model_len=32, prefill_chunk=4)


@pytest.fixture(scope="module")
def llm():
    cfg_j = jt.TransformerConfig(dtype=jnp.float32, **MODEL)
    cfg_t = tt.TransformerConfig(dtype=torch.float32, **MODEL)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = tt.params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=128 * 1024 * 1024)
    try:
        serve.start()
        app = serve.deployment(ray_actor_options={"num_gpus": 0.5})(LLMDeployment).bind(
            model_config=dict(MODEL, dtype="float32"), engine_config=ENGINE, params=params_t, device="cpu")
        handle = serve.run(app, route_prefix="/llm")
        oracle = JaxEngine(params_j, cfg_j, **ENGINE)
        try:
            yield handle, oracle
        finally:
            oracle.shutdown()
    finally:
        serve.shutdown()
        rt.shutdown()


def _url():
    host, port = serve.http_address()
    return f"http://{host}:{port}/llm"


def _sse(body):
    """POST one SSE request; (tokens, whether [DONE] arrived)."""
    req = urllib.request.Request(_url(), data=json.dumps(body).encode())
    resp = urllib.request.urlopen(req, timeout=60)
    assert resp.headers.get("Content-Type") == "text/event-stream"
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


def _buffered(body):
    req = urllib.request.Request(_url(), data=json.dumps(dict(body, stream=False)).encode())
    return json.loads(urllib.request.urlopen(req, timeout=60).read())["tokens"]


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], rng.integers(3, 14)).tolist() for _ in range(n)]


def test_llm_deployment_generates(llm):
    """Greedy: SSE and buffered tokens equal the JAX engine's; the same
    prompt twice gives the same continuation."""
    handle, oracle = llm
    for prompt in [[1, 2, 3]] + _prompts(3, 0):
        want = oracle.submit(prompt, max_new_tokens=8).result(60)
        toks, done = _sse({"tokens": prompt, "max_new_tokens": 8})
        assert done and toks == want, (prompt, toks, want)
        assert _buffered({"tokens": prompt, "max_new_tokens": 8}) == want
    assert all(0 <= t < MODEL["vocab_size"] for t in want)
    st = rt.get(handle.get_stats.remote(), timeout=30)
    assert st["role"] == "both" and st["finished"] == 8 and st["running"] == 0


def test_llm_deployment_seeded_sampling(llm):
    """Seeded sampling (temperature, top-k): the port's counter-based draws
    equal the JAX engine's over SSE and buffered; a seed reproduces, and the
    draws vary with it."""
    _, oracle = llm
    prompt = [1, 2, 3]
    outs = {}
    for seed in (7, 8):
        kw = dict(temperature=0.8, top_k=16, seed=seed)
        want = oracle.submit(prompt, max_new_tokens=12, **kw).result(60)
        toks, done = _sse(dict(tokens=prompt, max_new_tokens=12, **kw))
        assert done and toks == want, (seed, toks, want)
        assert _buffered(dict(tokens=prompt, max_new_tokens=12, **kw)) == want
        outs[seed] = toks
    assert _sse(dict(tokens=prompt, max_new_tokens=12, temperature=0.8, top_k=16, seed=7))[0] == outs[7]
    assert outs[7] != outs[8]


def test_llm_concurrent_streams_equal_the_jax_engine(llm):
    """Six streams at once over four slots (greedy and sampled mixed): each
    stream's tokens equal the JAX engine's for its request."""
    _, oracle = llm
    reqs = [dict(tokens=p, max_new_tokens=6 + i, **({"temperature": 0.9, "top_k": 8, "seed": i} if i % 2 else {}))
            for i, p in enumerate(_prompts(6, 1))]
    want = [oracle.submit(r["tokens"], **{k: v for k, v in r.items() if k != "tokens"}).result(60) for r in reqs]
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        got = list(pool.map(_sse, reqs))
    assert [toks for toks, _ in got] == want
    assert all(done for _, done in got)


def test_llm_client_disconnect_frees_slot_and_blocks(llm):
    """A client that closes its connection mid-stream: the engine cancels
    the request, and the replica's free and cached blocks return to the whole
    pool with nothing running."""
    handle, _ = llm
    before = rt.get(handle.get_stats.remote(), timeout=30)
    host, port = serve.http_address()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("POST", "/llm", body=json.dumps({"tokens": [5, 6, 7], "max_new_tokens": 28}).encode())
    resp = conn.getresponse()
    assert resp.read(12).startswith(b"data: ")
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = rt.get(handle.get_stats.remote(), timeout=30)
        if st["cancelled"] == before["cancelled"] + 1 and st["running"] == 0:
            break
        time.sleep(0.1)
    assert st["cancelled"] == before["cancelled"] + 1, st
    assert st["running"] == 0 and st["free_blocks"] + st["cached_blocks"] == st["num_blocks"], st
