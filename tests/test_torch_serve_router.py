"""The port's Serve router and proxy ASGI app against the JAX package's, with
no cluster.

Each case of ``tests/test_serve_disagg_router.py`` runs once per package: a
bare ``Router(None)`` with a hand-fed table, and ``ProxyASGIApp`` driven
directly with fake replica actors (the package's ``get`` patched to pass a
fake actor's return value through). Both packages must pass the reference's
own assertions: draining exclusion in every policy (round-robin, model
affinity, the prefix pin and its least-depth spill), the drain TTL, parking
while every replica drains, the drain refusal that never burns the bounded
reassign, the prefill handoff's body rewrite, the recompute fallback, and
non-LLM posts skipping the prefill leg. A last case feeds one seeded
sequence of assigns, releases and drain marks to both routers and holds
their picks equal, one for one.

No process is started; a few seconds here (the TTL cases sleep).
"""

import asyncio
import importlib
import json
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _bare_router(pkg, table):
    r = _mod(pkg, "serve._private.router").Router(None)
    r._table = table
    return r


def _replicas(names, max_q=8):
    return [{"actor_name": n, "max_concurrent_queries": max_q} for n in names]


# ---------------------------------------------------------------------------
# router: draining exclusion in every policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_draining_excluded_from_round_robin_and_model_affinity(pkg):
    router = _bare_router(pkg, {"dep": {"route_prefix": "/dep", "replicas": _replicas(["a", "b", "c"])}})
    router.mark_draining("b")
    picks = set()
    for _ in range(9):
        rep = router.assign_replica("dep", timeout_s=1)
        picks.add(rep["actor_name"])
        router.release(rep, deployment="dep")
    assert picks == {"a", "c"}
    for mid in ("m0", "m1", "m2", "m3", "m4"):
        rep = router.assign_replica("dep", timeout_s=1, model_id=mid)
        assert rep["actor_name"] != "b"
        router.release(rep, deployment="dep")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_draining_excluded_from_prefix_pin_and_spill(pkg):
    router = _bare_router(pkg, {"dep": {"route_prefix": "/dep", "replicas": _replicas(["a", "b", "c"], max_q=2)}})
    hint = next(h for h in (f"hint{i}" for i in range(64)) if zlib.crc32(h.encode()) % 3 == 1)
    assert router.assign_replica("dep", prefix_hint=hint)["actor_name"] == "b"
    router.release(router._table["dep"]["replicas"][1], deployment="dep")
    router.mark_draining("b")
    seen, held = set(), []
    for _ in range(4):  # 2 slots each on a and c
        rep = router.assign_replica("dep", timeout_s=1, prefix_hint=hint)
        seen.add(rep["actor_name"])
        held.append(rep)
    assert seen == {"a", "c"}  # the pin moved off b, the spill filled a AND c
    for rep in held:
        router.release(rep, deployment="dep")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_draining_ttl_expires_and_replica_returns(pkg):
    router = _bare_router(pkg, {"dep": {"route_prefix": "/dep", "replicas": _replicas(["a", "b"])}})
    router.mark_draining("a", ttl_s=0.2)
    assert router.is_draining("a")
    for _ in range(4):
        rep = router.assign_replica("dep", timeout_s=1)
        assert rep["actor_name"] == "b"
        router.release(rep, deployment="dep")
    time.sleep(0.25)
    assert not router.is_draining("a")
    picks = set()
    for _ in range(4):
        rep = router.assign_replica("dep", timeout_s=1)
        picks.add(rep["actor_name"])
        router.release(rep, deployment="dep")
    assert picks == {"a", "b"}  # back in rotation after the TTL


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_draining_parks_until_one_recovers(pkg):
    router = _bare_router(pkg, {"dep": {"route_prefix": "/dep", "replicas": _replicas(["a", "b"])}})
    router.mark_draining("a", ttl_s=0.3)
    router.mark_draining("b", ttl_s=10.0)
    got = {}

    def assign():
        got["r"] = router.assign_replica("dep", timeout_s=5)

    t = threading.Thread(target=assign)
    t.start()
    t.join(timeout=5)
    assert got["r"]["actor_name"] == "a"


# ---------------------------------------------------------------------------
# proxy: fake-actor harness (no cluster)
# ---------------------------------------------------------------------------


class _FakeActor:
    """Stands in for a replica handle: ``handle_http_request.remote`` runs the
    behavior synchronously and the patched ``get`` passes its return value
    straight through."""

    def __init__(self, fn):
        self.handle_http_request = SimpleNamespace(remote=fn)


def _drive(app, path, body):
    """One POST through the proxy ASGI app; returns (status, body bytes)."""

    async def go():
        sent = {"status": None, "chunks": []}
        delivered = [False]

        async def receive():
            if not delivered[0]:
                delivered[0] = True
                return {"type": "http.request", "body": body, "more_body": False}
            return {"type": "http.disconnect"}

        async def send(ev):
            if ev["type"] == "http.response.start":
                sent["status"] = ev["status"]
            elif ev["type"] == "http.response.body":
                sent["chunks"].append(ev.get("body", b""))

        scope = {"type": "http", "method": "POST", "path": path, "query_string": b"", "headers": []}
        await app(scope, receive, send)
        return sent["status"], b"".join(sent["chunks"])

    return asyncio.run(go())


@pytest.fixture(params=PACKAGES)
def proxy_env(request, monkeypatch):
    """(package, router, actors, pool, exceptions) with the package's get
    passing through and handle_for resolving into ``actors``."""
    pkg = request.param
    monkeypatch.setattr(importlib.import_module(pkg), "get", lambda ref, timeout=None: ref)
    actors: dict = {}
    router = _bare_router(pkg, {})
    router.handle_for = lambda replica: actors[replica["actor_name"]]
    router.invalidate_handle = lambda replica: None
    pool = ThreadPoolExecutor(max_workers=2)
    app = _mod(pkg, "serve._private.asgi").ProxyASGIApp(router, pool)
    yield router, actors, app, _mod(pkg, "exceptions")
    pool.shutdown(wait=False)


def test_drain_refusal_never_burns_the_reassign_retry(proxy_env):
    """A draining replica (refusal), THEN a corpse, and the request still
    lands on the healthy survivor; the refusal burns no retry."""
    router, actors, app, exc = proxy_env
    router._table = {"dep": {"route_prefix": "/dep", "replicas": _replicas(["r0", "r1", "r2"])}}
    router._rr["dep"] = 0
    calls = []

    def refuse(*a):
        calls.append("r0")
        raise exc.ReplicaDrainingError(replica_id="r0")

    def die(*a):
        calls.append("r2")
        raise exc.ActorDiedError("r2 died")

    def ok(*a):
        calls.append("r1")
        return {"pong": True}

    actors.update({"r0": _FakeActor(refuse), "r1": _FakeActor(ok), "r2": _FakeActor(die)})
    status, out = _drive(app, "/dep", b"{}")
    assert status == 200 and json.loads(out) == {"pong": True}
    assert calls == ["r0", "r2", "r1"]
    assert router.is_draining("r0") and not router.is_draining("r1")
    assert all(v == 0 for v in router._inflight.values()), router._inflight


def test_prefill_handoff_rewrites_decode_body(proxy_env):
    router, actors, app, _ = proxy_env
    router._table = {
        "llm": {"route_prefix": "/llm", "replicas": _replicas(["dec0"])},
        "llm--prefill": {"route_prefix": None, "replicas": _replicas(["pre0"])},
    }
    desc = {"oid": "ab" * 14, "addr": ["n", 1], "nbytes": 128, "kv_pos": 4, "blocks": 1, "block_size": 4}
    orig = {"tokens": [1, 2, 3, 4], "max_new_tokens": 3, "stream": False, "seed": 7}
    seen = {}

    def prefill(method, path, query, body, *rest):
        seen["prefill_body"] = json.loads(body)
        return {"__llm_handoff__": {"kv_import": desc, "resume_tokens": [42], "body": dict(orig)}}

    def decode(method, path, query, body, *rest):
        seen["decode_body"] = json.loads(body)
        return {"tokens": [42, 5, 6]}

    actors.update({"pre0": _FakeActor(prefill), "dec0": _FakeActor(decode)})
    status, out = _drive(app, "/llm", json.dumps(orig).encode())
    assert status == 200 and json.loads(out) == {"tokens": [42, 5, 6]}
    assert seen["prefill_body"] == orig
    assert seen["decode_body"] == dict(orig, resume_tokens=[42], kv_import=desc, echo_resume=True)
    assert all(v == 0 for v in router._inflight.values()), router._inflight


def test_prefill_pool_failure_falls_back_to_decode_recompute(proxy_env):
    router, actors, app, exc = proxy_env
    router._table = {
        "llm": {"route_prefix": "/llm", "replicas": _replicas(["dec0"])},
        "llm--prefill": {"route_prefix": None, "replicas": _replicas(["pre0", "pre1"])},
    }
    router._rr["llm--prefill"] = 0
    orig = {"tokens": [9, 8, 7], "stream": False}
    seen = {}

    def pre_die(*a):
        raise exc.ActorDiedError("pre0 died")

    def pre_drain(*a):
        raise exc.ReplicaDrainingError(replica_id="pre1")

    def decode(method, path, query, body, *rest):
        seen["decode_body"] = json.loads(body)
        return {"tokens": [1]}

    actors.update({"pre0": _FakeActor(pre_die), "pre1": _FakeActor(pre_drain), "dec0": _FakeActor(decode)})
    status, out = _drive(app, "/llm", json.dumps(orig).encode())
    assert status == 200 and json.loads(out) == {"tokens": [1]}
    assert seen["decode_body"] == orig  # the untouched original body
    assert all(v == 0 for v in router._inflight.values()), router._inflight


def test_non_llm_posts_skip_the_prefill_leg(proxy_env):
    router, actors, app, _ = proxy_env
    router._table = {
        "llm": {"route_prefix": "/llm", "replicas": _replicas(["dec0"])},
        "llm--prefill": {"route_prefix": None, "replicas": _replicas(["pre0"])},
    }
    prefill_calls, bodies = [], []

    def prefill(*a):  # pragma: no cover - must never run
        prefill_calls.append(1)
        return {}

    def decode(method, path, query, body, *rest):
        bodies.append(json.loads(body))
        return {"ok": True}

    actors.update({"pre0": _FakeActor(prefill), "dec0": _FakeActor(decode)})
    for body in ({"not_llm": 1}, {"tokens": [1], "resume_tokens": [2], "stream": False}):
        status, out = _drive(app, "/llm", json.dumps(body).encode())
        assert status == 200 and json.loads(out) == {"ok": True}
    assert prefill_calls == []
    assert bodies == [{"not_llm": 1}, {"tokens": [1], "resume_tokens": [2], "stream": False}]


def test_seeded_sequence_same_picks_in_both_packages():
    """One seeded sequence of assigns (round-robin, model ids, prefix hints,
    exclusions), releases and drain marks against both routers: every pick
    equal, one for one, and the same in-flight counts at the end."""
    table = {"dep": {"route_prefix": "/dep", "replicas": _replicas(["a", "b", "c", "d"], max_q=3)}}
    routers = [_bare_router(pkg, {k: dict(v) for k, v in table.items()}) for pkg in PACKAGES]
    rng = np.random.default_rng(5)
    held = [[] for _ in routers]
    picks = [[] for _ in routers]
    for _ in range(200):
        op = rng.integers(0, 10)
        arg = f"x{rng.integers(0, 7)}"
        name = "abcd"[rng.integers(0, 4)]
        if op < 2 and held[0]:
            j = int(rng.integers(0, len(held[0])))
            for r, h in zip(routers, held):
                r.release(h.pop(j), deployment="dep")
            continue
        if op == 2:
            for r in routers:
                r.mark_draining(name, ttl_s=1e6)
            continue
        if op == 3:
            for r in routers:
                r._draining.pop(name, None)
            continue
        kw = {4: {"model_id": arg}, 5: {"prefix_hint": arg}, 6: {"exclude": [name]}}.get(int(op), {})
        for r, h, p in zip(routers, held, picks):
            try:
                rep = r.assign_replica("dep", timeout_s=0, **kw)
            except TimeoutError:
                p.append(None)
                continue
            h.append(rep)
            p.append(rep["actor_name"])
    assert picks[0] == picks[1]
    assert sum(x is not None for x in picks[0]) > 30
    assert routers[0]._inflight == routers[1]._inflight
