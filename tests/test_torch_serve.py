"""The port's Serve plane (``ray_tpu_torch.serve``) on the CPU.

The counterparts of the cases of ``tests/test_serve.py``,
``test_serve_asgi.py``, ``test_serve_drain.py`` and ``test_serve_scaling.py``
that need no chaos plane, with the reference's own assertions: deployments
and handles, HTTP routing by longest prefix, ``StreamingResponse`` (and a
client that disconnects mid-stream), ``@serve.batch``, multiplexing,
composition, user config, a rolling update, ``serve.ingress`` ASGI apps and
the envelope's status, drain-before-retire on a white-box controller, and a
killed replica reconciled. The HTTP server (``asgi.ASGIServer``, the
standard library's asyncio streams in place of the JAX package's aiohttp
adapter) is also driven alone: buffered and chunked responses, a chunked
request body, ``Expect: 100-continue`` and keep-alive.

The module boots one port cluster with a serve instance (module fixture);
~60 s here.
"""

import asyncio
import http.client
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.serve._private.common import CONTROLLER_NAME, DeploymentConfig, DeploymentInfo, ReplicaInfo


@pytest.fixture(scope="module")
def serve_instance():
    rt.init(num_cpus=8, object_store_memory=128 * 1024 * 1024)
    serve.start()
    yield
    serve.shutdown()
    rt.shutdown()


def _url(path):
    host, port = serve.http_address()
    return f"http://{host}:{port}{path}"


def _http(path, payload=None, method=None, headers=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(_url(path), data=data, method=method or ("POST" if data else "GET"),
                                 headers=headers or {})
    return urllib.request.urlopen(req, timeout=30).read().decode()


def _get(url, data=None, method=None):
    req = urllib.request.Request(url, data=data, method=method)
    try:
        resp = urllib.request.urlopen(req, timeout=30)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# test_serve.py's cases
# ---------------------------------------------------------------------------


def test_deploy_and_handle(serve_instance):
    @serve.deployment(num_replicas=2)
    class Adder:
        def __init__(self, inc):
            self.inc = inc

        def __call__(self, request):
            return {"v": request.json()["v"] + self.inc}

        def add(self, x):
            return x + self.inc

    handle = serve.run(Adder.bind(10), route_prefix="/adder")
    try:
        assert rt.get(handle.add.remote(5)) == 15
        assert serve.status()["Adder"]["num_replicas"] == 2
        assert json.loads(_http("/adder", {"v": 1})) == {"v": 11}
    finally:
        serve.delete("Adder")


def test_function_deployment_routing_and_404(serve_instance):
    """HTTP routing by prefix: the longest matching route prefix wins, a
    sub-path reaches its deployment, an unknown path is a 404, and
    ``/-/routes`` lists the table."""

    @serve.deployment
    def outer(request):
        return "outer:" + request.path

    @serve.deployment
    def inner(request):
        return "inner:" + request.sub_path

    serve.run(outer.bind(), name="outer", route_prefix="/ping")
    serve.run(inner.bind(), name="inner", route_prefix="/ping/deep")
    try:
        assert _http("/ping") == "outer:/ping"
        assert _http("/ping/x") == "outer:/ping/x"
        assert _http("/ping/deep/y") == "inner:/y"
        assert json.loads(_http("/-/routes")) == {"outer": "/ping", "inner": "/ping/deep"}
        with pytest.raises(urllib.error.HTTPError) as err:
            _http("/nonexistent-route")
        assert err.value.code == 404
    finally:
        serve.delete("outer")
        serve.delete("inner")


def test_scale_up_down(serve_instance):
    @serve.deployment(num_replicas=1)
    class S:
        def __call__(self, request):
            return "ok"

        def who(self):
            return os.getpid()

    h = serve.run(S.bind(), route_prefix="/scale")
    try:
        assert serve.status()["S"]["num_replicas"] == 1
        serve.run(S.options(num_replicas=3).bind(), route_prefix="/scale")
        _wait(lambda: serve.status()["S"]["num_replicas"] == 3, msg="3 replicas")
        assert len({rt.get(h.who.remote()) for _ in range(12)}) >= 2  # requests spread over replicas
        serve.run(S.options(num_replicas=1).bind(), route_prefix="/scale")
        _wait(lambda: serve.status()["S"]["num_replicas"] == 1, msg="1 replica")
    finally:
        serve.delete("S")


def test_rolling_update_new_version(serve_instance):
    @serve.deployment(version="1")
    class V:
        def __call__(self, request):
            return "v1"

    serve.run(V.bind(), route_prefix="/v")
    assert _http("/v") == "v1"

    @serve.deployment(version="2")
    class V:  # noqa: F811 — redeployment with the same name, a new version
        def __call__(self, request):
            return "v2"

    serve.run(V.bind(), route_prefix="/v")
    try:
        deadline, streak = time.time() + 30, 0
        while time.time() < deadline and streak < 5:
            streak = streak + 1 if _http("/v") == "v2" else 0
            time.sleep(0.1)
        assert streak >= 5, "rollout to v2 did not complete"
    finally:
        serve.delete("V")
    _wait(lambda: "V" not in serve.status(), msg="V deleted")


def test_user_config_reconfigure(serve_instance):
    @serve.deployment(user_config={"threshold": 5})
    class C:
        def __init__(self):
            self.threshold = None

        def reconfigure(self, cfg):
            self.threshold = cfg["threshold"]

        def __call__(self, request):
            return {"threshold": self.threshold}

    serve.run(C.bind(), route_prefix="/cfg")
    try:
        assert json.loads(_http("/cfg")) == {"threshold": 5}
    finally:
        serve.delete("C")


def test_batching():
    calls = []

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    def process(items):
        calls.append(len(items))
        return [i * 2 for i in items]

    results = [None] * 8

    def call(i):
        results[i] = process(i)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [i * 2 for i in range(8)]
    assert max(calls) > 1  # actually batched


def test_batching_in_a_replica(serve_instance):
    """@serve.batch on a deployment method: concurrent handle calls reach
    the method as lists (the replica admits max_concurrency requests)."""

    @serve.deployment(max_concurrent_queries=8)
    class Doubler:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def double(self, items):
            self.sizes.append(len(items))
            return [x * 2 for x in items]

        def __call__(self, x):
            return self.double(x)

        def batch_sizes(self):
            return self.sizes

    h = serve.run(Doubler.bind(), route_prefix=None)
    try:
        assert sorted(rt.get([h.remote(i) for i in range(8)], timeout=60)) == [i * 2 for i in range(8)]
        assert max(rt.get(h.batch_sizes.remote())) > 1
    finally:
        serve.delete("Doubler")


def test_deployment_composition(serve_instance):
    @serve.deployment
    class Doubler:
        def double(self, x):
            return x * 2

    @serve.deployment
    class Ingress:
        def __init__(self, doubler):
            self.doubler = doubler

        def __call__(self, request):
            return rt.get(self.doubler.double.remote(request.json()["v"]))

        def compute(self, x):
            return rt.get(self.doubler.double.remote(x)) + 1

    h = serve.run(Ingress.bind(Doubler.bind()), route_prefix="/compose")
    try:
        assert rt.get(h.compute.remote(5), timeout=60) == 11
        assert json.loads(_http("/compose", {"v": 4})) == 8
        st = serve.status()
        assert "Doubler" in st and "Ingress" in st
    finally:
        serve.delete("Ingress")
        serve.delete("Doubler")


def test_multiplexing(serve_instance):
    @serve.deployment(num_replicas=2)
    class MultiModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id.split("-")[1])}

        def __call__(self, request):
            model = self.get_model(serve.get_multiplexed_model_id())
            return {"result": request.json()["v"] * model["scale"]}

        def predict(self, v):
            model = self.get_model(serve.get_multiplexed_model_id())
            return v * model["scale"]

        def num_loads(self):
            return len(self.loads)

    h = serve.run(MultiModel.bind(), route_prefix="/multi")
    try:
        for _ in range(4):
            assert rt.get(h.options(multiplexed_model_id="m-3").predict.remote(2)) == 6
        assert rt.get(h.options(multiplexed_model_id="m-5").predict.remote(2)) == 10
        out = json.loads(_http("/multi", {"v": 4}, headers={"serve_multiplexed_model_id": "m-2"}))
        assert out == {"result": 8}
        assert sum(rt.get(h.num_loads.remote()) for _ in range(2)) <= 4
    finally:
        serve.delete("MultiModel")


def test_streaming_response(serve_instance):
    @serve.deployment
    class Streamer:
        def __call__(self, request):
            def gen():
                for i in range(5):
                    yield f"tok{i} "

            return serve.StreamingResponse(gen(), content_type="text/plain")

    @serve.deployment
    class BareGen:
        def __call__(self, request):
            yield {"n": 1}
            yield {"n": 2}

    serve.run(Streamer.bind(), name="streamer", route_prefix="/stream")
    serve.run(BareGen.bind(), name="baregen", route_prefix="/baregen")
    try:
        with urllib.request.urlopen(_url("/stream"), timeout=60) as resp:
            assert resp.headers.get("Content-Type", "").startswith("text/plain")
            assert resp.headers.get("Transfer-Encoding") == "chunked"
            assert resp.read().decode() == "tok0 tok1 tok2 tok3 tok4 "
        with urllib.request.urlopen(_url("/baregen"), timeout=60) as resp:
            lines = [line for line in resp.read().decode().splitlines() if line]
        assert [json.loads(line)["n"] for line in lines] == [1, 2]
    finally:
        serve.delete("Streamer")
        serve.delete("BareGen")


def test_streaming_client_disconnect_cancels_the_stream(serve_instance):
    """A client that goes away mid-stream: the server sees EOF, cancels the
    proxy's pump, the pump cancels the replica's stream, and the
    StreamingResponse's on_disconnect fires once — while the endless
    generator is parked between tokens."""

    @serve.deployment
    class Ticker:
        def __init__(self):
            self.cancels = 0

        def __call__(self, request):
            def gen():
                i = 0
                while True:
                    yield f"data: {i}\n\n"
                    i += 1
                    time.sleep(0.05)

            return serve.StreamingResponse(gen(), content_type="text/event-stream", on_disconnect=self._cancelled)

        def _cancelled(self):
            self.cancels += 1

        def num_cancels(self):
            return self.cancels

    h = serve.run(Ticker.bind(), route_prefix="/tick")
    try:
        host, port = serve.http_address()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/tick", body=b"{}")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read(16).startswith(b"data: 0")
        conn.sock.shutdown(socket.SHUT_RDWR)
        conn.close()
        _wait(lambda: rt.get(h.num_cancels.remote(), timeout=30) == 1, msg="on_disconnect")
        time.sleep(0.5)
        assert rt.get(h.num_cancels.remote(), timeout=30) == 1  # exactly once
    finally:
        serve.delete("Ticker")


# ---------------------------------------------------------------------------
# test_serve_asgi.py's cases
# ---------------------------------------------------------------------------


async def echo_app(scope, receive, send):
    """ASGI-3 echo: reports method/path/root_path/query/body, status 201."""
    if scope["type"] != "http":
        return
    body = b""
    while True:
        msg = await receive()
        if msg["type"] == "http.request":
            body += msg.get("body", b"")
            if not msg.get("more_body", False):
                break
        else:
            break
    payload = json.dumps({"method": scope["method"], "path": scope["path"], "root_path": scope.get("root_path", ""),
                          "query": scope["query_string"].decode(), "body": body.decode()}).encode()
    await send({"type": "http.response.start", "status": 201,
                "headers": [(b"content-type", b"application/json"), (b"x-custom", b"yes")]})
    await send({"type": "http.response.body", "body": payload, "more_body": False})


async def chunked_app(scope, receive, send):
    """Streams three chunks with more_body=True."""
    if scope["type"] != "http":
        return
    await receive()
    await send({"type": "http.response.start", "status": 200, "headers": [(b"content-type", b"text/plain")]})
    for part in (b"alpha-", b"beta-", b"gamma"):
        await send({"type": "http.response.body", "body": part, "more_body": True})
    await send({"type": "http.response.body", "body": b"", "more_body": False})


@pytest.fixture()
def asgi_server():
    from ray_tpu_torch.serve._private.asgi import ASGIServer

    started = threading.Event()
    holder = {}

    async def dispatch(scope, receive, send):
        if scope.get("path", "").startswith("/chunked"):
            await chunked_app(scope, receive, send)
        else:
            await echo_app(scope, receive, send)

    def serve_thread():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        server = ASGIServer(dispatch, "127.0.0.1", 0)
        loop.run_until_complete(server.start())
        holder["port"], holder["loop"], holder["server"] = server.port, loop, server
        started.set()
        loop.run_forever()

    t = threading.Thread(target=serve_thread, daemon=True)
    t.start()
    assert started.wait(10)
    yield holder["port"]
    asyncio.run_coroutine_threadsafe(holder["server"].close(), holder["loop"]).result(10)
    holder["loop"].call_soon_threadsafe(holder["loop"].stop)


def test_adapter_buffered_response(asgi_server):
    status, headers, body = _get(f"http://127.0.0.1:{asgi_server}/a/b?x=1&y=", data=b"ping", method="POST")
    assert status == 201
    assert headers.get("x-custom") == "yes"
    assert headers.get("content-length") == str(len(body))
    out = json.loads(body)
    assert (out["method"], out["path"], out["query"], out["body"]) == ("POST", "/a/b", "x=1&y=", "ping")


def test_adapter_streamed_response(asgi_server):
    status, headers, body = _get(f"http://127.0.0.1:{asgi_server}/chunked")
    assert status == 200
    assert headers.get("transfer-encoding") == "chunked"
    assert body == b"alpha-beta-gamma"


def test_adapter_keep_alive_chunked_body_and_continue(asgi_server):
    """One connection carries three requests: a Content-Length body, a
    chunked request body behind ``Expect: 100-continue``, and a streamed
    response; a percent-encoded path arrives decoded."""
    conn = http.client.HTTPConnection("127.0.0.1", asgi_server, timeout=30)
    conn.request("POST", "/one", body=b"first")
    r1 = conn.getresponse()
    assert r1.status == 201 and json.loads(r1.read())["body"] == "first"
    sock = conn.sock
    conn.request("POST", "/two%20words", body=iter([b"sec", b"ond"]), encode_chunked=True,
                 headers={"Transfer-Encoding": "chunked", "Expect": "100-continue"})
    r2 = conn.getresponse()
    out = json.loads(r2.read())
    assert (r2.status, out["body"], out["path"]) == (201, "second", "/two words")
    conn.request("GET", "/chunked")
    r3 = conn.getresponse()
    assert r3.read() == b"alpha-beta-gamma"
    assert conn.sock is sock  # the same connection throughout
    conn.close()


def test_ingress_asgi_app(serve_instance):
    @serve.deployment
    @serve.ingress(echo_app)
    class EchoSvc:
        pass

    serve.run(EchoSvc.bind(), route_prefix="/svc")
    try:
        status, headers, body = _get(_url("/svc/sub/route?k=v"), data=b"hello", method="POST")
        assert status == 201
        assert headers.get("x-custom") == "yes"
        out = json.loads(body)
        assert (out["path"], out["root_path"], out["body"], out["query"]) == ("/sub/route", "/svc", "hello", "k=v")
        _, _, body = _get(_url("/svc?tag=a&tag=b&z=1"))
        assert json.loads(body)["query"] == "tag=a&tag=b&z=1"  # wire-exact
    finally:
        serve.delete("EchoSvc")


def test_ingress_streaming_asgi_app(serve_instance):
    @serve.deployment
    @serve.ingress(chunked_app)
    class ChunkSvc:
        pass

    serve.run(ChunkSvc.bind(), route_prefix="/chunks")
    try:
        status, _, body = _get(_url("/chunks"))
        assert status == 200 and body == b"alpha-beta-gamma"
    finally:
        serve.delete("ChunkSvc")


def test_http_response_envelope_status(serve_instance):
    @serve.deployment
    def teapot(request):
        return {"__serve_http_response__": True, "status": 418,
                "headers": {"x-kind": "teapot", "content-type": "text/plain"}, "body": "short and stout"}

    serve.run(teapot.bind(), route_prefix="/teapot")
    try:
        status, headers, body = _get(_url("/teapot"))
        assert (status, headers.get("x-kind"), body) == (418, "teapot", b"short and stout")
    finally:
        serve.delete("teapot")


# ---------------------------------------------------------------------------
# test_serve_drain.py's cases (a white-box controller in the driver)
# ---------------------------------------------------------------------------


class SlowCallable:
    """Deployment body whose requests take long enough to straddle a drain."""

    def __call__(self, x, delay=0.0):
        if delay:
            time.sleep(delay)
        return x


def _make_controller(name, drain_timeout_s=30.0):
    import cloudpickle

    from ray_tpu_torch.serve._private.controller import ServeController

    controller = ServeController()
    controller.deploy([DeploymentInfo(
        name=name, app_name="t", import_spec=cloudpickle.dumps((SlowCallable, (), {})),
        config=DeploymentConfig(num_replicas=1, version="v1", drain_timeout_s=drain_timeout_s,
                                health_check_period_s=0.5, health_check_timeout_s=5.0),
    )])
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if controller._replicas.get(name):
            return controller
        time.sleep(0.1)
    controller.graceful_shutdown()
    raise TimeoutError("replicas never came up")


def _retired(handle):
    try:
        rt.get(handle.drain_status.remote(), timeout=2)
        return False
    except Exception:
        return True


def test_retire_raced_deliberate_stop_is_noop(serve_instance):
    controller = _make_controller("drainnoop", drain_timeout_s=0.0)
    try:
        rinfo = controller._replicas["drainnoop"][0]
        ghost = ReplicaInfo(replica_id="gone1234", deployment_name="drainnoop", actor_name="SERVE_REPLICA::ghost",
                            max_concurrent_queries=10, version="v1")
        epoch_before = controller._epoch
        controller._retire_unhealthy_replica("drainnoop", ghost)
        assert controller._epoch == epoch_before
        assert controller._replicas["drainnoop"] == [rinfo]
        handle = controller._replica_handles[rinfo.replica_id]
        assert rt.get(handle.handle_request.remote("__call__", (7,), {}), timeout=60) == 7
    finally:
        controller.graceful_shutdown()


def test_health_failure_mid_drain_retires_immediately(serve_instance):
    controller = _make_controller("drainhealth", drain_timeout_s=60.0)
    try:
        rinfo = controller._replicas["drainhealth"][0]
        handle = controller._replica_handles[rinfo.replica_id]
        busy_ref = handle.handle_request.remote("__call__", (1,), {"delay": 20.0})
        time.sleep(0.3)
        controller._stop_replica("drainhealth", rinfo)
        _wait(lambda: rinfo.replica_id in controller._draining, 10, "the drain to start")
        _wait(lambda: rt.get(handle.drain_status.remote(), timeout=30)["draining"], 15, "the replica to drain")
        st = rt.get(handle.drain_status.remote(), timeout=30)
        assert st["draining"] is True and st["ongoing"] == 1, st
        controller._retire_unhealthy_replica("drainhealth", rinfo)  # health failure outranks the drain
        assert rinfo.replica_id not in controller._draining
        _wait(lambda: _retired(handle), 30, "the kill to land")
        with pytest.raises(Exception):
            rt.get(busy_ref, timeout=30)
    finally:
        controller.graceful_shutdown()


def test_idle_replica_drains_clean_and_retires(serve_instance):
    controller = _make_controller("drainidle", drain_timeout_s=30.0)
    try:
        rinfo = controller._replicas["drainidle"][0]
        handle = controller._replica_handles[rinfo.replica_id]
        controller._stop_replica("drainidle", rinfo)
        _wait(lambda: rinfo.replica_id not in controller._draining and _retired(handle), 30, "a clean retire")
        assert rinfo not in controller._replicas.get("drainidle", [])
    finally:
        controller.graceful_shutdown()


def test_drain_status_excludes_abandoned_pumps():
    import cloudpickle

    from ray_tpu_torch.serve._private.replica import Replica

    r = Replica(cloudpickle.dumps((SlowCallable, (), {})))

    class FakePump:
        def __init__(self, age_s):
            self.last_pump = time.time() - age_s
            self.cancels = 0

        def cancel(self):
            self.cancels += 1

    orphan, live = FakePump(60.0), FakePump(0.0)
    r._streams = {"1": orphan, "2": live}
    assert r.drain_status()["streams"] == 2
    r.drain()
    assert r.drain_status()["streams"] == 1
    assert orphan.cancels == 0 and live.cancels == 0
    assert set(r._streams) == {"1", "2"}


# ---------------------------------------------------------------------------
# test_serve_scaling.py's replica-death case
# ---------------------------------------------------------------------------


def test_replica_failure_is_reconciled(serve_instance):
    from ray_tpu_torch.exceptions import ActorDiedError, TaskError

    @serve.deployment(num_replicas=2)
    class Fragile:
        def __call__(self, request):
            return "alive"

        def pid(self):
            return os.getpid()

    h = serve.run(Fragile.bind(), route_prefix="/fragile")
    try:
        assert len({rt.get(h.pid.remote()) for _ in range(10)}) == 2
        controller = rt.get_actor(CONTROLLER_NAME)
        table = rt.get(controller.get_routing_table.remote(-1, 1.0))["table"]
        names = [r["actor_name"] for r in table["Fragile"]["replicas"]]
        assert len(names) == 2
        rt.kill(rt.get_actor(names[0]))
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                assert rt.get(h.remote(None), timeout=30) == "alive"
            except (ActorDiedError, TaskError, TimeoutError):
                pass  # transient, racing the dead replica's removal
            st = serve.status().get("Fragile", {})
            table = rt.get(controller.get_routing_table.remote(-1, 1.0))["table"]
            now = {r["actor_name"] for r in table.get("Fragile", {}).get("replicas", [])}
            if st.get("num_replicas") == 2 and now != set(names):
                break
            time.sleep(0.3)
        else:
            raise AssertionError("killed replica was never replaced")
        for _ in range(5):
            assert rt.get(h.remote(None), timeout=30) == "alive"
    finally:
        serve.delete("Fragile")
