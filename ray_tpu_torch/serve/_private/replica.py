"""Replica actor (reference: python/ray/serve/_private/replica.py:384
RayServeReplica, handle_request at :639).

Each replica is a dedicated actor process wrapping the user callable. On a
GPU node a replica takes a card (or a fraction of one, ``num_gpus=0.5``) and
holds its model there; queue depth is reported to the controller for
autoscaling.
"""

from __future__ import annotations

import pickle
import queue as _queue
import threading
import time


class _StreamPump:
    """Runs one response stream's generator on a dedicated thread,
    prefetching into a bounded queue. The replica's RPC surface only ever
    drains the queue with a short timeout, so a producer that stalls inside
    its generator cannot head-of-line-block the replica's task slots (and a
    disconnected client's pump dies on cancel, not the 5-minute reap)."""

    def __init__(self, gen, model_id: str, on_cancel=None):
        self.gen = gen
        self.model_id = model_id
        self.on_cancel = on_cancel
        self.q: _queue.Queue = _queue.Queue(maxsize=8)  # backpressure bound
        self.cancelled = threading.Event()
        self.last_pump = time.time()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self.cancelled.is_set():
            try:
                self.q.put(item, timeout=0.25)
                return True
            except _queue.Full:
                continue
        return False

    def _run(self):
        from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id

        # The generator body runs HERE: scope the multiplexed model id to
        # this thread so concurrent requests can't bleed theirs in.
        _set_multiplexed_model_id(self.model_id)
        try:
            for item in self.gen:
                if not self._put(("chunk", _encode_chunk(item))):
                    break
            else:
                self._put(("done", None))
        except BaseException as e:  # delivered to the consumer, then re-raised
            self._put(("error", e))
        finally:
            try:
                self.gen.close()
            except Exception:
                pass

    def cancel(self):
        self.cancelled.set()
        # Producer-side teardown (StreamingResponse.on_disconnect) fires
        # HERE, synchronously: the generator thread may be parked inside
        # its producer (e.g. the LLM engine's token queue) and only
        # observes `cancelled` at its next yield — resources like decode
        # slots and KV blocks must not wait for that. dict.pop is
        # GIL-atomic, so concurrent cancel()s fire the callback once.
        cb = self.__dict__.pop("on_cancel", None)
        if cb is not None:
            try:
                cb()
            except Exception:
                pass


class Replica:
    def __init__(
        self,
        import_spec: bytes,
        user_config=None,
        deployment_name: str = "",
        replica_id: str = "",
        controller_name: str = "",
    ):
        from ray_tpu_torch.serve._private.common import HandleMarker

        cls_or_fn, init_args, init_kwargs = pickle.loads(import_spec)

        def materialize(v):
            if isinstance(v, HandleMarker):
                # Composition: a bound child deployment becomes a live handle.
                from ray_tpu_torch.serve.api import get_deployment_handle

                return get_deployment_handle(v.deployment_name)
            if isinstance(v, list):
                return [materialize(x) for x in v]
            if isinstance(v, tuple):
                return tuple(materialize(x) for x in v)
            if isinstance(v, dict):
                return {k: materialize(x) for k, x in v.items()}
            return v

        init_args = tuple(materialize(a) for a in init_args)
        init_kwargs = {k: materialize(v) for k, v in init_kwargs.items()}
        if isinstance(cls_or_fn, type):
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self._callable = cls_or_fn
        self._is_function = not isinstance(cls_or_fn, type)
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._streams: dict = {}
        self._stream_counter = 0
        self._draining = False
        self._deployment_name = deployment_name
        self._replica_id = replica_id
        if user_config is not None:
            self.reconfigure(user_config)
        # Autoscaling metrics PUSH (reference: autoscaling_metrics.py —
        # replicas report their own queue depth). A dedicated daemon thread,
        # NOT an actor method: actor calls share the request thread pool, so
        # a polled metric could only run when a slot freed — biased low by
        # construction.
        if deployment_name and controller_name:
            self._metrics_stop = threading.Event()

            def _push_loop():
                import ray_tpu_torch

                controller = None
                while not self._metrics_stop.wait(1.0):
                    try:
                        if controller is None:
                            controller = ray_tpu_torch.get_actor(controller_name)
                        controller.record_metrics.remote(
                            deployment_name, replica_id, self._ongoing
                        )
                    except Exception:
                        controller = None  # controller restarting; re-resolve

            threading.Thread(
                target=_push_loop, name="replica-metrics", daemon=True
            ).start()

    def reconfigure(self, user_config):
        """Push a new user_config without restarting (reference:
        deployment_state version/user_config rolling update)."""
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def handle_request(
        self, method_name: str, args: tuple, kwargs: dict, multiplexed_model_id: str = ""
    ):
        from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id

        with self._lock:
            if self._draining:
                # Drain-before-retire: NEW requests are refused with the
                # typed error (proxy/handle reassign on it); in-flight
                # requests and live stream pumps keep running to completion.
                from ray_tpu_torch.exceptions import ReplicaDrainingError

                raise ReplicaDrainingError(
                    deployment=self._deployment_name,
                    replica_id=self._replica_id,
                )
            self._ongoing += 1
            self._total += 1
        try:
            _set_multiplexed_model_id(multiplexed_model_id)
            if self._is_function or method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            return target(*args, **kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_http_request(
        self,
        method: str,
        path: str,
        query: dict,
        body: bytes,
        headers: dict,
        multiplexed_model_id: str = "",
        route_prefix: str | None = None,
        raw_query_string: str | None = None,
    ):
        """HTTP entry: the callable gets a lightweight Request object. The
        proxy passes the multiplexed model id it already extracted for
        routing — one extraction, no divergence — the matched route
        prefix so sub-route dispatch (DAGDriver) works under any mount, and
        the raw query string so ASGI ingress apps see wire-exact bytes."""
        request = HTTPRequest(
            method=method, path=path, query=query, body=body, headers=headers,
            route_prefix=route_prefix, raw_query_string=raw_query_string,
        )
        result = self.handle_request(
            "__call__", (request,), {}, multiplexed_model_id=multiplexed_model_id
        )
        import inspect

        from ray_tpu_torch.serve.api import StreamingResponse

        if isinstance(result, StreamingResponse) or inspect.isgenerator(result):
            # Chunked/SSE responses (reference: serve streaming responses):
            # the generator stays alive here; the proxy pumps it via
            # next_stream_chunk and writes chunks to the socket as produced.
            if isinstance(result, StreamingResponse):
                gen, ctype = iter(result.iterator), result.content_type
                status = getattr(result, "status", 200)
                extra = getattr(result, "headers", None) or {}
                on_cancel = getattr(result, "on_disconnect", None)
                resume = getattr(result, "resume", None)
            else:
                gen, ctype = result, "application/octet-stream"
                status, extra = 200, {}
                on_cancel = resume = None
            with self._lock:
                self._reap_idle_streams_locked()
                self._stream_counter += 1
                sid = str(self._stream_counter)
                self._streams[sid] = _StreamPump(
                    gen, multiplexed_model_id, on_cancel=on_cancel
                )
            envelope = {
                "__serve_stream__": sid,
                "content_type": ctype,
                "status": status,
                "headers": extra,
            }
            if resume is not None:
                # Migration descriptor rides the envelope: the proxy uses
                # it to resubmit this request elsewhere if THIS replica
                # dies mid-stream. The deployment supplies kind + body; the
                # ORIGINAL routing context (method/path/headers/model id/
                # mount) is stamped here so the resumed request dispatches
                # identically — a multiplexed or sub-routed deployment must
                # not resume under different semantics.
                envelope["__serve_resume__"] = dict(
                    resume,
                    ctx={
                        "method": method,
                        "path": path,
                        "query": query,
                        "headers": headers,
                        "model_id": multiplexed_model_id,
                        "route_prefix": route_prefix,
                        "raw_query": raw_query_string,
                    },
                )
            return envelope
        return result

    def _reap_idle_streams_locked(self):
        """Backstop for proxies that died mid-stream (normal disconnects
        send cancel_stream): cancel pumps nobody drained for 5 minutes so
        generator finalizers run and state doesn't accumulate."""
        now = time.time()
        for sid, pump in list(self._streams.items()):
            if now - pump.last_pump > 300.0:
                self._streams.pop(sid, None)
                pump.cancel()

    def next_stream_chunk(self, sid: str):
        """Drain the stream's prefetch queue: block briefly for the first
        chunk (one-item latency for time-to-first-byte), then sweep whatever
        else is already buffered into the same response. Returns
        {"chunks": [bytes], "done": bool} — empty chunks + done=False means
        "nothing yet, poll again" — or None for unknown streams."""
        with self._lock:
            pump = self._streams.get(sid)
            if pump is not None:
                pump.last_pump = time.time()
        if pump is None:
            return None
        chunks: list[bytes] = []
        done = False
        error = None
        block = True
        while True:
            try:
                kind, payload = pump.q.get(timeout=0.5) if block else pump.q.get_nowait()
            except _queue.Empty:
                break
            block = False
            if kind == "chunk":
                chunks.append(payload)
            elif kind == "done":
                done = True
                break
            else:  # error
                error = payload
                break
        if error is not None and chunks:
            # Deliver what the producer yielded BEFORE it raised; the error
            # surfaces on the next poll (parity with the old per-item pump).
            pump.q.put(("error", error))
            return {"chunks": chunks, "done": False}
        if done or error is not None:
            with self._lock:
                self._streams.pop(sid, None)
        if error is not None:
            raise error
        return {"chunks": chunks, "done": done}

    def cancel_stream(self, sid: str):
        """Proxy-initiated teardown on client disconnect (reference: ASGI
        disconnect -> request cancellation): stop the pump thread now
        instead of waiting out the idle reaper."""
        with self._lock:
            pump = self._streams.pop(sid, None)
        if pump is not None:
            pump.cancel()
        return True

    def get_metrics(self) -> dict:
        """Queue stats for autoscaling (reference: autoscaling_metrics.py)."""
        with self._lock:
            return {"ongoing": self._ongoing, "total": self._total, "ts": time.time()}

    def drain(self) -> bool:
        """Enter drain mode (controller-initiated, deliberate retirement):
        refuse NEW requests with the typed ReplicaDrainingError while
        in-flight requests and live stream pumps run to completion. The
        user callable's own drain() hook (e.g. the LLM engine's
        refuse-admissions flag) is forwarded to."""
        with self._lock:
            self._draining = True
        fn = getattr(self._callable, "drain", None)
        if fn is not None and callable(fn):
            try:
                fn()
            except Exception:
                pass
        return True

    # While draining, a pump nobody polled for this long stops COUNTING
    # toward drain completion: its proxy probably died without
    # cancel_stream (a live proxy polls sub-second), and the normal 300s
    # idle reaper only runs from handle_http_request, which the drain gate
    # refuses — without this, one orphan pump rides out the whole
    # drain_timeout_s on an otherwise idle replica. The pump is NOT
    # cancelled here: a slow-but-alive consumer (proxy blocked in a big
    # send) must not be silently truncated as "complete" — if it is still
    # alive at retire, its next poll gets the typed went-away error and
    # resumable streams migrate.
    _DRAIN_IDLE_EXCLUDE_S = 10.0

    def drain_status(self) -> dict:
        """What the controller's drainer polls: retire once ongoing == 0
        and no RECENTLY-PUMPED stream remains (or drain_timeout_s
        expires)."""
        with self._lock:
            now = time.time()
            streams = (
                sum(
                    1
                    for pump in self._streams.values()
                    if now - pump.last_pump <= self._DRAIN_IDLE_EXCLUDE_S
                )
                if self._draining
                else len(self._streams)
            )
            return {
                "draining": self._draining,
                "ongoing": self._ongoing,
                "streams": streams,
            }

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True

    def prepare_for_shutdown(self):
        """Invoke the user callable's shutdown hook, if any (reference:
        replica graceful_shutdown path)."""
        stop = getattr(self, "_metrics_stop", None)
        if stop is not None:
            stop.set()  # retired replicas must not keep pushing metrics
        fn = getattr(self._callable, "prepare_for_shutdown", None) or getattr(
            self._callable, "shutdown", None
        )
        if fn is not None and callable(fn):
            fn()
        return True


class HTTPRequest:
    """Minimal request object handed to deployments from the proxy
    (stands in for the reference's starlette.requests.Request)."""

    def __init__(self, method: str, path: str, query: dict, body: bytes, headers: dict,
                 route_prefix: str | None = None, raw_query_string: str | None = None):
        self.method = method
        self.path = path
        self.query_params = query
        self.body = body
        self.headers = headers
        self.route_prefix = route_prefix
        # Wire-exact query string (duplicate keys/order intact) for ASGI
        # ingress; query_params remains the collapsed dict convenience.
        self.raw_query_string = raw_query_string

    @property
    def sub_path(self) -> str:
        """Path RELATIVE to the deployment's matched route prefix — what
        sub-route dispatch (DAGDriver) should match on, valid under any
        mount point."""
        if not self.route_prefix or self.route_prefix == "/":
            return self.path
        rest = self.path[len(self.route_prefix.rstrip("/")):]
        return rest if rest.startswith("/") else "/" + rest if rest else "/"

    def json(self):
        import json as _json

        return _json.loads(self.body or b"null")

    def text(self) -> str:
        return (self.body or b"").decode()


def _encode_chunk(item) -> bytes:
    if isinstance(item, bytes):
        return item
    if isinstance(item, str):
        return item.encode()
    import json as _json

    return (_json.dumps(item) + "\n").encode()
