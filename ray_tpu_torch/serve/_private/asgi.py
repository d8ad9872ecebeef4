"""ASGI boundary for Serve ingress.

The reference's proxy IS an ASGI application served by uvicorn
(python/ray/serve/_private/http_proxy.py:320 `HTTPProxy.__call__(scope,
receive, send)`), and replicas mount user ASGI apps (FastAPI) via
`serve.ingress` (python/ray/serve/api.py:100). This module is the port's
copy of ``ray_tpu/serve/_private/asgi.py``, the same seam with a server of the
standard library's (the port depends on no HTTP package):

- `ProxyASGIApp` — the ingress routing logic as a pure ASGI-3 callable. No
  server types anywhere in it; it speaks only scope/receive/send.
- `ASGIServer` — serves ANY ASGI-3 app over HTTP/1.1 on
  ``asyncio.start_server``: request bodies, keep-alive, chunked streaming
  (SSE) and client-disconnect cancellation. Swapping servers (e.g. to
  uvicorn) means replacing this one class; the app and everything behind it
  are untouched. (The JAX package's adapter, ``AiohttpASGIServer``, is built
  on aiohttp.)
- `run_asgi_request` — replica-side bridge: drives a user ASGI app from the
  `HTTPRequest` a replica receives, so `@serve.ingress(asgi_app)` mounts raw
  ASGI apps (what the reference does with FastAPI) on deployments.

Responses flow back as either a buffered envelope dict
(`{"__serve_http_response__": True, status, headers, body}`) or a
`StreamingResponse` whose chunks ride the replica's stream pump — both of
which `ProxyASGIApp` translates back into ASGI send events.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from urllib.parse import parse_qsl, unquote, urlencode

from ray_tpu_torch._private.concurrency import any_thread, blocking

logger = logging.getLogger(__name__)

_DISCONNECT = {"type": "http.disconnect"}


class ClientDisconnected(Exception):
    """Raised from ``send`` inside a user ASGI app once the client is gone —
    the ASGI-standard way a server stops a producer (uvicorn raises on send
    after disconnect); the app unwinds through its own finally blocks."""


def _build_scope(method, path, root_path, query_string: bytes, headers, client=None, server=None):
    """One scope-dict construction for both bridges (adapter + replica)."""
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": method,
        "scheme": "http",
        "path": path,
        # utf-8, not latin-1: `path` arrives percent-DECODED (the server's
        # request path / the replica sub_path) and may contain any unicode;
        # headers stay latin-1 per the HTTP wire format.
        "raw_path": path.encode("utf-8"),
        "root_path": root_path,
        "query_string": query_string,
        "headers": headers,
        "client": client,
        "server": server,
    }


async def _read_body(receive) -> bytes:
    """Drain `http.request` events into one body (ASGI allows chunking)."""
    parts = []
    while True:
        msg = await receive()
        if msg["type"] == "http.request":
            parts.append(msg.get("body", b""))
            if not msg.get("more_body", False):
                break
        else:  # http.disconnect
            break
    return b"".join(parts)


async def _respond_start(send, status: int, content_type: str, extra_headers: dict):
    headers = [(b"content-type", content_type.encode("latin-1"))]
    for k, v in extra_headers.items():
        if k.lower() != "content-type":
            headers.append((k.lower().encode("latin-1"), str(v).encode("latin-1")))
    await send({"type": "http.response.start", "status": status, "headers": headers})


async def _respond(send, status: int, body: bytes, content_type: str, extra_headers: dict | None = None):
    extra = dict(extra_headers or {})
    ctype = next((v for k, v in extra.items() if k.lower() == "content-type"), content_type)
    await _respond_start(send, status, ctype, extra)
    await send({"type": "http.response.body", "body": body, "more_body": False})


def _np_default(o):
    import numpy as np

    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _replica_went_away(e: BaseException) -> bool:
    """The typed this-replica-is-gone errors that justify a bounded
    reassign/migration: process death (ActorDiedError and its unavailable
    sibling) or deliberate drain (ReplicaDrainingError — possibly wrapped
    in the TaskError envelope a raising remote method rides home in).
    Anything else (app bugs, timeouts) surfaces unchanged."""
    from ray_tpu_torch.exceptions import (
        ActorDiedError,
        ActorUnavailableError,
        ReplicaDrainingError,
        TaskError,
    )

    if isinstance(e, (ActorDiedError, ActorUnavailableError, ReplicaDrainingError)):
        return True
    if isinstance(e, TaskError):
        return isinstance(e.cause, ReplicaDrainingError)
    return False


def _drain_refused(e: BaseException) -> bool:
    """The drain subset of :func:`_replica_went_away`: the replica is alive
    and healthy but REFUSED the request because it is retiring. Unlike a
    death this is a pure routing-table race — the caller marks the replica
    draining on its router (so no policy picks it again) and retries
    WITHOUT burning one of the bounded reassign/migration attempts, which
    exist to cap work wasted on crashes, not on polite refusals."""
    from ray_tpu_torch.exceptions import ReplicaDrainingError, TaskError

    if isinstance(e, ReplicaDrainingError):
        return True
    if isinstance(e, TaskError):
        return isinstance(e.cause, ReplicaDrainingError)
    return False


class _SSETokenParser:
    """Incremental parser over the SSE chunk bytes the proxy forwards:
    collects the ``data: {"token": n}`` payloads the CLIENT has already
    received — exactly the tokens a migrated request must teacher-force
    and never re-emit. Chunk boundaries are arbitrary (the replica pump
    batches), so events are split on the wire-level ``\\n\\n`` frame."""

    def __init__(self):
        self.tokens: list = []
        self._buf = b""

    def feed(self, chunk: bytes):
        self._buf += bytes(chunk)
        while b"\n\n" in self._buf:
            event, self._buf = self._buf.split(b"\n\n", 1)
            if not event.startswith(b"data: "):
                continue
            payload = event[6:]
            if payload == b"[DONE]":
                continue
            try:
                tok = json.loads(payload).get("token")
            except Exception:
                continue
            if tok is not None:
                self.tokens.append(int(tok))


class ProxyASGIApp:
    """Serve's HTTP ingress as an ASGI-3 application.

    Routes by longest prefix through the shared Router, forwards the request
    to a replica (in an executor — replica calls block on the object store),
    and pumps streaming responses chunk-by-chunk. Mirrors the reference's
    `HTTPProxy` ASGI app (http_proxy.py:320) over ray_tpu_torch's replica
    protocol.
    """

    def __init__(self, router, pool):
        self._router = router
        self._pool = pool

    async def __call__(self, scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            return  # websockets not supported
        path = scope.get("path", "/")
        if path == "/-/healthz":
            await _respond(send, 200, b"ok", "text/plain")
            return
        if path == "/-/routes":
            with self._router._lock:
                routes = {
                    name: e.get("route_prefix") for name, e in self._router._table.items()
                }
            await _respond(send, 200, json.dumps(routes).encode(), "application/json")
            return
        deployment, matched_prefix = self._router.route_and_prefix_for(path)
        if deployment is None:
            await _respond(send, 404, f"no deployment for path {path}".encode(), "text/plain")
            return
        body = await _read_body(receive)
        method = scope.get("method", "GET")
        # surrogateescape so arbitrary wire bytes survive the str hop to the
        # replica and re-encode back to the identical bytes for its scope.
        raw_query = scope.get("query_string", b"").decode("utf-8", "surrogateescape")
        query = dict(parse_qsl(raw_query, keep_blank_values=True))
        headers = {
            k.decode("latin-1"): v.decode("latin-1") for k, v in scope.get("headers", [])
        }
        loop = asyncio.get_running_loop()
        import ray_tpu_torch

        def call():
            import time as _time

            from ray_tpu_torch.serve._private.common import (
                MULTIPLEXED_MODEL_ID_HEADER,
                PREFIX_HINT_HEADER,
            )

            model_id = next(
                (v for k, v in headers.items() if k.lower() == MULTIPLEXED_MODEL_ID_HEADER),
                "",
            )
            prefix_hint = next(
                (v for k, v in headers.items() if k.lower() == PREFIX_HINT_HEADER),
                "",
            )
            # Disaggregated LLM: a paired "<name>--prefill"
            # deployment in the table means LLM generate requests run their
            # prefill leg on that pool first; the sealed-KV handoff envelope
            # rewrites the body the decode pool (this deployment) receives.
            # Any prefill-leg failure returns None and the decode pool
            # simply recomputes the prefill — never a client-visible error.
            req_body = body
            from ray_tpu_torch.serve._private.common import PREFILL_SUFFIX

            prefill_dep = deployment + PREFILL_SUFFIX
            if method == "POST" and self._router.replicas_for(prefill_dep):
                req_body = (
                    self._prefill_handoff(
                        prefill_dep, body, headers, model_id, prefix_hint,
                        path, query, matched_prefix, raw_query,
                    )
                    or body
                )
            # ONE bounded reassign on the typed went-away errors: a replica
            # that died after assignment (assign->dead race) must not 500
            # the client while healthy replicas exist. Drain refusals
            # (deliberate retirement; the routing-table removal races this
            # request by design) retry WITHOUT consuming that bound — they
            # mark the replica draining instead, capped by a deadline.
            exclude: list = []
            casualties = 0
            drain_deadline = _time.monotonic() + 30.0
            while True:
                t0 = _time.monotonic()
                replica = self._router.assign_replica(
                    deployment, model_id=model_id, prefix_hint=prefix_hint,
                    exclude=exclude,
                )
                try:
                    actor = self._router.handle_for(replica)
                    ref = actor.handle_http_request.remote(
                        method, path, query, req_body, headers, model_id,
                        matched_prefix, raw_query,
                    )
                    result = ray_tpu_torch.get(ref, timeout=120)
                except BaseException as e:
                    self._router.release(replica, deployment=deployment)
                    if _drain_refused(e) and _time.monotonic() < drain_deadline:
                        self._router.mark_draining(replica)
                        exclude.append(replica["actor_name"])
                        continue
                    casualties += 1
                    if casualties <= 1 and _replica_went_away(e):
                        self._router.invalidate_handle(replica)
                        exclude.append(replica["actor_name"])
                        continue
                    raise
                break
            if isinstance(result, dict) and "__serve_stream__" in result:
                # Streaming: the replica stays assigned (queue metrics + its
                # generator live there) until the pump finishes.
                return replica, result
            self._router.release(
                replica, deployment=deployment, duration_s=_time.monotonic() - t0
            )
            return None, result

        try:
            replica, result = await loop.run_in_executor(self._pool, call)
        except Exception as e:
            logger.exception("request to %s failed", deployment)
            await _respond(send, 500, f"{type(e).__name__}: {e}".encode(), "text/plain")
            return

        if replica is not None:
            await self._pump_stream(send, loop, deployment, replica, result)
            return

        status, payload, ctype, extra = _encode_result(result)
        await _respond(send, status, payload, ctype, extra)

    def _prefill_handoff(
        self, prefill_dep, body, headers, model_id, prefix_hint,
        path, query, matched_prefix, raw_query,
    ):
        """Prefill leg of a disaggregated LLM request (runs in the executor
        pool: blocking calls). Sends the ORIGINAL body to a prefill-pool
        replica — prefix_hint affinity steers shared prompts to the replica
        whose cache (local or imported via the cluster prefix tier) already
        holds their KV — and translates the ``__llm_handoff__`` envelope it
        returns into the decode-pool body: the original request plus the
        sealed-KV descriptor, the first sampled token as resume_tokens, and
        echo_resume so the client still sees that token.

        Returns the rewritten body bytes, or None for ANY miss — body not
        an LLM generate, already a resume/handoff, prefill pool saturated,
        dead, draining, or unable to seal — in which case the caller sends
        the original body to the decode pool and it recomputes the prefill.
        The handoff is an optimization, never a point of failure."""
        import ray_tpu_torch

        try:
            parsed = json.loads(body or b"{}")
        except Exception:
            return None
        if not isinstance(parsed, dict) or "tokens" not in parsed:
            return None
        if parsed.get("resume_tokens") or parsed.get("kv_import"):
            return None  # mid-migration/handoff already — decode directly
        exclude: list = []
        casualties = 0
        drain_deadline = time.monotonic() + 30.0
        while True:
            try:
                replica = self._router.assign_replica(
                    prefill_dep, timeout_s=10.0, model_id=model_id,
                    prefix_hint=prefix_hint, exclude=exclude,
                )
            except TimeoutError:
                return None
            try:
                actor = self._router.handle_for(replica)
                result = ray_tpu_torch.get(
                    actor.handle_http_request.remote(
                        "POST", path, query, body, headers, model_id,
                        matched_prefix, raw_query,
                    ),
                    timeout=120,
                )
            except BaseException as e:
                self._router.release(replica, deployment=prefill_dep)
                if _drain_refused(e) and time.monotonic() < drain_deadline:
                    self._router.mark_draining(replica)
                    exclude.append(replica["actor_name"])
                    continue
                casualties += 1
                if casualties <= 1 and _replica_went_away(e):
                    self._router.invalidate_handle(replica)
                    exclude.append(replica["actor_name"])
                    continue
                logger.warning(
                    "prefill leg of %s failed (%s); decode pool recomputes",
                    prefill_dep, type(e).__name__,
                )
                return None
            self._router.release(replica, deployment=prefill_dep)
            break
        env = result.get("__llm_handoff__") if isinstance(result, dict) else None
        if env is None:
            return None  # engine decoded locally (could not seal)
        body2 = dict(env.get("body") or {})
        body2["resume_tokens"] = list(env.get("resume_tokens") or ())
        body2["kv_import"] = env["kv_import"]
        body2["echo_resume"] = True
        return json.dumps(body2).encode()

    # Mid-stream migrations per request: one covers the common single
    # replica death; the second covers dying onto a second casualty during
    # a rolling restart. Beyond that the stream aborts honestly.
    _MAX_MIGRATIONS = 2

    async def _pump_stream(self, send, loop, deployment, replica, envelope):
        import ray_tpu_torch

        sid = envelope["__serve_stream__"]
        resume = envelope.get("__serve_resume__")
        parser = (
            _SSETokenParser() if resume and resume.get("kind") == "sse_tokens" else None
        )
        await _respond_start(
            send,
            int(envelope.get("status", 200)),
            envelope.get("content_type", "application/octet-stream"),
            envelope.get("headers") or {},
        )
        actor = self._router.handle_for(replica)
        finished = False
        migrations = 0
        dead: list = []
        # Slot-accounting ownership: the dead replica is released at the
        # START of a migration, so a failed migration must not let the
        # finally below release it a second time (release() clamps at 0,
        # but a double decrement would steal a count from another stream
        # still assigned to the same replica).
        held = True
        try:
            while True:
                try:
                    batch = await loop.run_in_executor(
                        self._pool,
                        lambda: ray_tpu_torch.get(
                            actor.next_stream_chunk.remote(sid), timeout=120
                        ),
                    )
                except Exception as e:
                    if (
                        parser is None
                        or migrations >= self._MAX_MIGRATIONS
                        or not _replica_went_away(e)
                    ):
                        raise
                    # Typed replica death mid-stream: MIGRATE. Resubmit the
                    # original request to another replica with the tokens
                    # the client already received teacher-forced back in —
                    # the engine continues bit-identically from there and
                    # re-emits nothing.
                    migrations += 1
                    dead.append(replica["actor_name"])
                    self._router.release(replica, deployment=deployment)
                    self._router.invalidate_handle(replica)
                    held = False
                    replica, actor, sid = await loop.run_in_executor(
                        self._pool,
                        lambda: self._migrate_stream(deployment, resume, parser, dead),
                    )
                    held = True
                    continue
                if batch is None:
                    finished = True
                    break
                for chunk in batch["chunks"]:
                    if parser is not None:
                        parser.feed(chunk)
                    await send({"type": "http.response.body", "body": chunk, "more_body": True})
                if batch["done"]:
                    finished = True
                    break
        except Exception:
            logger.exception("stream from %s aborted", deployment)
        finally:
            if not finished:
                # Client disconnect / pump error: tear the stream down now
                # rather than leaving its generator to the replica's
                # 5-minute idle reaper.
                try:
                    actor.cancel_stream.remote(sid)
                except Exception:
                    pass
            if held:
                self._router.release(replica, deployment=deployment)
        await send({"type": "http.response.body", "body": b"", "more_body": False})

    def _migrate_stream(self, deployment, resume, parser, dead):
        """Resubmit a broken stream's request to a live replica with
        ``resume_tokens=`` (runs in the executor pool: blocking calls).
        Returns (replica, actor, sid) of the resumed stream. The migration
        TARGET can itself be mid-death/drain (stale table during a rolling
        restart) — that is the same went-away race as everywhere else, so
        it is excluded and the resubmit retried within a bound rather than
        aborting a stream healthy replicas could still serve."""
        import ray_tpu_torch
        from ray_tpu_torch._private import flight_recorder, self_metrics

        body2 = dict(resume.get("body") or {})
        body2["resume_tokens"] = parser.tokens
        body2["stream"] = True
        payload = json.dumps(body2).encode()
        # Replay the ORIGINAL request's routing context (stamped by the
        # replica into the resume descriptor) — only the body changes. The
        # dead replica is excluded, so prefix affinity is moot, but model
        # affinity still steers multiplexed deployments to a warm replica.
        ctx = resume.get("ctx") or {}
        casualties = 0
        drain_deadline = time.monotonic() + 30.0
        while True:
            replica = self._router.assign_replica(
                deployment, model_id=ctx.get("model_id", ""), exclude=dead
            )
            try:
                actor = self._router.handle_for(replica)
                env2 = ray_tpu_torch.get(
                    actor.handle_http_request.remote(
                        ctx.get("method", "POST"),
                        ctx.get("path", "/"),
                        ctx.get("query", {}),
                        payload,
                        ctx.get("headers", {}),
                        ctx.get("model_id", ""),
                        ctx.get("route_prefix"),
                        ctx.get("raw_query"),
                    ),
                    timeout=120,
                )
                if not (isinstance(env2, dict) and "__serve_stream__" in env2):
                    raise RuntimeError(
                        f"migration resubmit did not return a stream: {type(env2)}"
                    )
            except BaseException as e:
                self._router.release(replica, deployment=deployment)
                # A draining target refused: not a casualty (the bound is
                # for crashes) — mark it, exclude it, keep looking.
                if _drain_refused(e) and time.monotonic() < drain_deadline:
                    self._router.mark_draining(replica)
                    dead.append(replica["actor_name"])
                    continue
                casualties += 1
                if casualties <= self._MAX_MIGRATIONS and _replica_went_away(e):
                    self._router.invalidate_handle(replica)
                    dead.append(replica["actor_name"])
                    continue
                raise
            break
        flight_recorder.record(
            "llm_migrate", f"{deployment[:20]}:n{len(parser.tokens)}"
        )
        try:
            self_metrics.instruments()["serve_migrations"].inc(
                tags={"deployment": deployment}
            )
        except Exception:
            pass
        logger.warning(
            "migrated stream of %s to %s after replica death "
            "(%d tokens teacher-forced)",
            deployment, replica["actor_name"], len(parser.tokens),
        )
        return replica, actor, env2["__serve_stream__"]


def _encode_result(result):
    """Replica return value -> (status, payload bytes, content_type, extra_headers)."""
    if isinstance(result, dict) and result.get("__serve_http_response__"):
        body = result.get("body", b"")
        if isinstance(body, str):
            body = body.encode()
        headers = dict(result.get("headers") or {})
        ctype = next(
            (v for k, v in headers.items() if k.lower() == "content-type"),
            "application/octet-stream",
        )
        headers = {k: v for k, v in headers.items() if k.lower() != "content-type"}
        return int(result.get("status", 200)), body, ctype, headers
    if isinstance(result, bytes):
        return 200, result, "application/octet-stream", None
    if isinstance(result, str):
        return 200, result.encode(), "text/plain; charset=utf-8", None
    return 200, json.dumps(result, default=_np_default).encode(), "application/json", None


class _BadRequest(Exception):
    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status


class _Connection:
    """One client connection's read side: a byte buffer over the stream, so
    the disconnect watcher can read ahead while an app runs without losing
    the bytes of a pipelined next request."""

    def __init__(self, reader: asyncio.StreamReader):
        self.reader = reader
        self.buf = bytearray()
        self.eof = False

    async def fill(self) -> bool:
        data = await self.reader.read(1 << 16)
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def read_until(self, sep: bytes, limit: int) -> bytes | None:
        """Bytes up to ``sep`` (consumed, not returned); None at a clean EOF
        before any byte."""
        while True:
            i = self.buf.find(sep)
            if i >= 0:
                out = bytes(self.buf[:i])
                del self.buf[: i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise _BadRequest(431, "request head too large")
            if not await self.fill():
                if self.buf:
                    raise _BadRequest(400, "connection closed mid-request")
                return None

    async def read_exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self.fill():
                raise _BadRequest(400, "connection closed mid-body")
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


_REASONS = {200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 418: "I'm a teapot", 431: "Request Header Fields Too Large",
            500: "Internal Server Error"}


def _status_line(status: int) -> bytes:
    return f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n".encode("latin-1")


class ASGIServer:
    """Serve any ASGI-3 application over HTTP/1.1 on the standard library's
    ``asyncio.start_server``.

    The seam the reference gets from uvicorn: this class is the ONLY place
    that speaks the wire protocol. `await start()` on the serving loop binds
    the socket; `.port` is the actual bound port. It handles request bodies
    by ``Content-Length`` or chunked transfer (and ``Expect: 100-continue``),
    keep-alive, buffered responses (``Content-Length``) and streamed ones
    (chunked transfer, one chunk per ``http.response.body`` event, flushed as
    sent — SSE rides this), and a client that goes away: while the app runs,
    a watcher reads the connection, and EOF cancels the app's task at
    whatever await it is parked on (the uvicorn behavior the proxy's stream
    pump relies on to cancel the replica's stream).
    """

    _MAX_HEAD_BYTES = 64 * 1024
    _MAX_BODY_BYTES = 1 << 30
    # Bytes of a pipelined next request the watcher buffers while an app runs.
    _MAX_READ_AHEAD = 1 << 20

    def __init__(self, app, host: str = "127.0.0.1", port: int = 0):
        self._app = app
        self._host = host
        self._want_port = port
        self.port: int | None = None
        self._server = None

    async def start(self):
        self._server = await asyncio.start_server(self._serve_connection, self._host, self._want_port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _serve_connection(self, reader, writer):
        conn = _Connection(reader)
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    req = await self._read_request(conn, writer)
                except _BadRequest as e:
                    await self._write_simple(writer, e.status, str(e).encode(), keep_alive=False)
                    return
                if req is None:
                    return
                if not await self._serve_request(conn, writer, peer, *req):
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, conn: _Connection, writer):
        head = await conn.read_until(b"\r\n\r\n", self._MAX_HEAD_BYTES)
        if head is None:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ", 2)
        except ValueError:
            raise _BadRequest(400, f"malformed request line {lines[0][:80]!r}") from None
        headers = []
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep:
                raise _BadRequest(400, f"malformed header line {line[:80]!r}")
            headers.append((name.strip().lower(), value.strip()))
        hmap = {k: v for k, v in headers}
        if hmap.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if "chunked" in hmap.get("transfer-encoding", "").lower():
            parts, total = [], 0
            while True:
                size_line = await conn.read_until(b"\r\n", self._MAX_HEAD_BYTES)
                if size_line is None:
                    raise _BadRequest(400, "connection closed mid-body")
                try:
                    size = int(size_line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise _BadRequest(400, "malformed chunk size") from None
                if size == 0:
                    while await conn.read_until(b"\r\n", self._MAX_HEAD_BYTES):
                        pass  # trailers, up to the empty line
                    break
                total += size
                if total > self._MAX_BODY_BYTES:
                    raise _BadRequest(413, "request body too large")
                parts.append(await conn.read_exactly(size))
                await conn.read_exactly(2)  # the chunk's CRLF
            body = b"".join(parts)
        else:
            try:
                n = int(hmap.get("content-length", "0") or 0)
            except ValueError:
                raise _BadRequest(400, "malformed Content-Length") from None
            if n > self._MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            body = await conn.read_exactly(n) if n else b""
        conn_hdr = hmap.get("connection", "").lower()
        keep_alive = "close" not in conn_hdr if version == "HTTP/1.1" else "keep-alive" in conn_hdr
        return method, target, version, headers, body, keep_alive

    async def _serve_request(self, conn, writer, peer, method, target, version, headers, body, keep_alive) -> bool:
        """Run the app on one request; True when the connection stays open."""
        raw_path, _, query = target.partition("?")
        scope = _build_scope(
            method,
            unquote(raw_path),
            "",
            query.encode("latin-1"),
            [(k.encode("latin-1"), v.encode("latin-1")) for k, v in headers],
            client=peer,
            server=(self._host, self.port),
        )
        delivered = [False]
        # Set when the final http.response.body lands; a second receive()
        # blocks until then (a live client is NOT "disconnected" — apps that
        # race response-writing against a disconnect listener must not see
        # an instant disconnect).
        response_done = asyncio.Event()

        async def receive():
            if not delivered[0]:
                delivered[0] = True
                return {"type": "http.request", "body": body, "more_body": False}
            await response_done.wait()
            return dict(_DISCONNECT)

        state = {"status": 200, "headers": [], "started": False}

        def head(extra: list) -> bytes:
            lines = [_status_line(state["status"])]
            for k, v in state["headers"] + extra:
                lines.append(k + b": " + v + b"\r\n")
            if not keep_alive:
                lines.append(b"connection: close\r\n")
            return b"".join(lines) + b"\r\n"

        async def send(event):
            if event["type"] == "http.response.start":
                state["status"] = int(event["status"])
                state["headers"] = [
                    (k.lower(), v)
                    for k, v in event.get("headers", [])
                    if k.lower() not in (b"content-length", b"transfer-encoding", b"connection")
                ]
                return
            if event["type"] != "http.response.body" or response_done.is_set():
                return
            chunk = event.get("body", b"")
            more = event.get("more_body", False)
            if not state["started"]:
                state["started"] = True
                if not more:
                    writer.write(head([(b"content-length", str(len(chunk)).encode())]) + chunk)
                    response_done.set()
                    await writer.drain()
                    return
                writer.write(head([(b"transfer-encoding", b"chunked")]))
            if chunk:
                writer.write(b"%x\r\n" % len(chunk) + chunk + b"\r\n")
            if not more:
                writer.write(b"0\r\n\r\n")
                response_done.set()
            await writer.drain()

        task = asyncio.ensure_future(self._app(scope, receive, send))
        watcher = asyncio.ensure_future(self._watch_disconnect(conn, task))
        try:
            await task
        except asyncio.CancelledError:
            if not conn.eof:
                raise  # the server itself is going down
            return False  # the client went away mid-response
        except Exception:
            logger.exception("ASGI app failed on %s %s", method, raw_path)
            if not state["started"]:
                await self._write_simple(writer, 500, b"ASGI app failed", keep_alive=False)
            return False
        finally:
            # Wait the watcher out: its read must end before the next
            # request's read starts on the same stream.
            watcher.cancel()
            try:
                await watcher
            except (asyncio.CancelledError, Exception):
                pass
        if not state["started"]:
            await self._write_simple(writer, 500, b"ASGI app sent no response", keep_alive)
        elif not response_done.is_set():
            writer.write(b"0\r\n\r\n")  # a streamed response the app left open
            await writer.drain()
        return keep_alive and not conn.eof

    async def _watch_disconnect(self, conn: _Connection, task):
        """Read the connection while the app runs: EOF means the client is
        gone, and the app's task is cancelled."""
        while len(conn.buf) < self._MAX_READ_AHEAD:
            if not await conn.fill():
                task.cancel()
                return

    @staticmethod
    async def _write_simple(writer, status: int, body: bytes, keep_alive: bool):
        writer.write(
            _status_line(status)
            + b"content-type: text/plain\r\ncontent-length: "
            + str(len(body)).encode()
            + (b"\r\n" if keep_alive else b"\r\nconnection: close\r\n")
            + b"\r\n"
            + body
        )
        try:
            await writer.drain()
        except ConnectionError:
            pass


_ingress_loop_lock = threading.Lock()
_ingress_loop = None


def _get_ingress_loop():
    """One persistent event loop thread per process for all serve.ingress
    apps — loop-bound app state (connection pools, caches) survives across
    requests and no thread/loop is created per request."""
    global _ingress_loop
    with _ingress_loop_lock:
        if _ingress_loop is None or not _ingress_loop[1].is_alive():
            loop = asyncio.new_event_loop()
            thread = threading.Thread(
                target=lambda: (asyncio.set_event_loop(loop), loop.run_forever()),
                name="asgi-ingress",
                daemon=True,
            )
            thread.start()
            _ingress_loop = (loop, thread)
        return _ingress_loop[0]


class _AppBridge:
    """send/receive pair driving a user ASGI app from sync replica code.

    - ``send`` events land in a BOUNDED queue drained by the caller (fast
      producers park in ``send`` — uvicorn-style backpressure); once
      ``closed`` is set (client gone or response fully consumed) further
      sends raise ClientDisconnected so the app stops producing — the leak
      guard for infinite SSE producers whose client went away.
    - app completion is signalled via the ``done`` flag + ``error`` holder
      (never a queue put, which could block the shared ingress loop on a
      full queue); a sentinel wake is best-effort with put_nowait.
    - a second ``receive`` blocks until ``closed``, then reports
      http.disconnect — never an instant disconnect while the response is
      still being consumed (spec: disconnect means the client is GONE).
    """

    # Bounded: a fast producer with a slow client parks in ``send`` instead
    # of buffering the whole response in replica memory (uvicorn's
    # backpressure, expressed as a poll so the shared ingress loop is never
    # blocked by one stream).
    _MAX_BUFFERED_EVENTS = 256

    def __init__(self, body: bytes):
        import queue as _queue

        self.out: _queue.Queue = _queue.Queue(maxsize=self._MAX_BUFFERED_EVENTS)
        self.closed = threading.Event()
        self.done = threading.Event()
        self.error: BaseException | None = None
        self._body = body
        self._delivered = False

    @any_thread
    def finish(self, error: BaseException | None):
        """Mark the app coroutine finished. Usually runs on the shared
        ingress loop (future done-callback), so it must never block: flag
        first, then a best-effort wake. @any_thread, not @loop_only: when
        the app coroutine finishes before ``add_done_callback`` registers,
        the callback fires synchronously on the REPLICA thread instead
        (audited: the run_coroutine_threadsafe result is
        never ``.result()``-ed anywhere the ingress loop could reach)."""
        import queue as _queue

        self.error = error
        self.done.set()
        try:
            self.out.put_nowait({"type": "__app_done__"})
        except _queue.Full:
            pass  # consumer will drain the queue and then see the flag

    async def receive(self):
        if not self._delivered:
            self._delivered = True
            return {"type": "http.request", "body": self._body, "more_body": False}
        await asyncio.get_running_loop().run_in_executor(None, self.closed.wait)
        return dict(_DISCONNECT)

    async def send(self, event):
        import queue as _queue

        while True:
            if self.closed.is_set():
                raise ClientDisconnected()
            try:
                self.out.put_nowait(event)
                return
            except _queue.Full:
                await asyncio.sleep(0.02)


def _next_event(bridge: _AppBridge, deadline_s: float):
    """Next send event from the bridge, or None once the app has finished
    and the queue is drained. Raises the app's error (after in-order
    delivery of everything it sent first) or TimeoutError on a stalled app."""
    import queue as _queue

    end = time.monotonic() + deadline_s
    while True:
        try:
            ev = bridge.out.get(timeout=0.1)
        except _queue.Empty:
            if bridge.done.is_set():
                if bridge.error is not None:
                    raise bridge.error
                return None
            if time.monotonic() > end:
                raise TimeoutError("ASGI app produced no event within deadline")
            continue
        if ev["type"] == "__app_done__":
            if bridge.error is not None:
                raise bridge.error
            return None
        return ev


@blocking
def run_asgi_request(asgi_app, request):
    """Drive a user ASGI app with a replica `HTTPRequest`, sync->async bridge.

    Replica side of `serve.ingress` (reference mounts FastAPI apps this way,
    python/ray/serve/api.py:100; here any ASGI-3 callable). The app runs on
    the shared per-process ingress loop; its send events are collected from
    a queue. Buffered responses return the envelope dict `_encode_result`
    understands; streaming responses (more_body=True) return a
    `StreamingResponse` whose generator drains the queue as the app
    produces chunks — riding the replica's existing stream pump.

    Scope mapping: the deployment's matched route prefix becomes ASGI
    `root_path` and the app sees the sub-path, so apps behave identically
    under any mount point (starlette mount semantics). The query string is
    the raw wire bytes the proxy saw (duplicate keys and ordering intact).
    """
    from ray_tpu_torch.serve.api import StreamingResponse

    raw_query = getattr(request, "raw_query_string", None)
    if raw_query is None:
        raw_query = urlencode(request.query_params or {})
    scope = _build_scope(
        request.method,
        request.sub_path,
        (request.route_prefix or "").rstrip("/"),
        raw_query.encode("utf-8", "surrogateescape"),
        [
            (k.lower().encode("latin-1"), str(v).encode("latin-1"))
            for k, v in (request.headers or {}).items()
        ],
    )
    bridge = _AppBridge(request.body or b"")
    fut = asyncio.run_coroutine_threadsafe(
        asgi_app(scope, bridge.receive, bridge.send), _get_ingress_loop()
    )

    def _on_done(f):
        try:
            exc = f.exception()
        except asyncio.CancelledError:
            exc = None
        if isinstance(exc, ClientDisconnected):
            exc = None
        bridge.finish(exc)

    fut.add_done_callback(_on_done)

    status, headers = 200, {}
    chunks: list[bytes] = []
    streaming = False
    try:
        while True:
            ev = _next_event(bridge, 120.0)
            if ev is None:
                break
            if ev["type"] == "http.response.start":
                status = ev["status"]
                headers = {
                    k.decode("latin-1"): v.decode("latin-1")
                    for k, v in ev.get("headers", [])
                }
            elif ev["type"] == "http.response.body":
                chunk = ev.get("body", b"")
                if ev.get("more_body", False):
                    streaming = True  # the generator owns bridge closure

                    def gen(first=chunk):
                        try:
                            if first:
                                yield first
                            while True:
                                e2 = _next_event(bridge, 300.0)
                                if e2 is None:
                                    return
                                if e2["type"] == "http.response.body":
                                    b2 = e2.get("body", b"")
                                    if b2:
                                        yield b2
                                    if not e2.get("more_body", False):
                                        return
                        finally:
                            # Normal end, client disconnect (GeneratorExit
                            # via the stream pump's close), or error: stop
                            # the producer and unblock its receive().
                            bridge.closed.set()

                    ctype = next(
                        (v for k, v in headers.items() if k.lower() == "content-type"),
                        "application/octet-stream",
                    )
                    return StreamingResponse(
                        gen(),
                        content_type=ctype,
                        status=status,
                        headers={
                            k: v for k, v in headers.items() if k.lower() != "content-type"
                        },
                    )
                chunks.append(chunk)
                break  # complete buffered response
    finally:
        # Buffered response consumed, app finished, or collection failed:
        # post-response sends raise and a parked disconnect-listener
        # receive() resolves. The streaming path closes from its generator.
        if not streaming:
            bridge.closed.set()
    return {
        "__serve_http_response__": True,
        "status": status,
        "headers": headers,
        "body": b"".join(chunks),
    }
