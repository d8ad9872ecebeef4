"""Async RPC layer.

Analog of the reference's gRPC server/client wrappers
(src/ray/rpc/grpc_server.h:73, src/ray/rpc/client_call.h:181): length-prefixed
msgpack frames over asyncio TCP/Unix sockets, with a method-dispatch server,
retrying clients, and one background IO event loop per process (the analog of
the reference's instrumented_io_context, src/ray/common/asio/).

Wire format: 4-byte big-endian length, then a msgpack array
``[type, seq, method, payload]`` where type is REQUEST/RESPONSE/ERROR/PUSH.
Payloads are msgpack-native structures; rich Python objects are serialized by
the caller (see serialization.py) before they enter the RPC layer.

Raw frames (transfer hot path): a multi-MiB object chunk riding the msgpack
envelope costs an encode of the ``bytes`` payload plus a ``bytes(...)`` copy
on each side. A RAW frame instead sets the top bit of the length prefix and
carries a fixed binary header (kind, seq, object-id, start offset) followed
by the payload bytes written straight from an arena ``memoryview``; the
receive side hands the payload to a synchronous sink as a ``memoryview``
into the read buffer, so it lands at its arena destination with a single
copy and no intermediate Python ``bytes`` object. Raw support is negotiated
per transfer session (``push_begin``/``fetch_object_chunk`` payload keys);
peers that never advertise it keep the msgpack path, and a torn connection
mid-raw-frame tears the whole connection exactly like a torn msgpack frame
(the length prefix scopes both), so the stream can never desynchronize.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import random
import struct
import threading
import time
import traceback
from typing import Any, Awaitable, Callable

import msgpack

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private.concurrency import any_thread, blocking, loop_only

logger = logging.getLogger(__name__)

REQUEST, RESPONSE, ERROR, PUSH = 0, 1, 2, 3

_MAX_FRAME = 1 << 31

# ---- raw frames ----
# Length prefix with the top bit set marks a raw frame; the low 31 bits are
# the byte count of header+id+payload. A pre-raw peer that is mistakenly sent
# one fails fast with "frame too large" and resets the connection — raw is
# only ever sent after the receiver advertised it, so this is a bug trap,
# not a compatibility channel.
RAW_FLAG = 0x80000000
# kind u8, flags u8 (reserved), oid_len u16, seq u32, start u64.
_RAW_HDR = struct.Struct("<BBHIQ")
RAW_CHUNK = 1  # client -> server: object chunk into an open push session
RAW_RESP = 2   # server -> client: chunk payload answering a pending request


class RawFrame:
    """A decoded raw frame. ``payload`` is a memoryview into the connection
    read buffer: valid ONLY until the consumer yields control back to the
    frame stream (it is released on generator resume), so raw sinks/handlers
    must consume it synchronously (one arena memcpy, no awaits)."""

    __slots__ = ("kind", "seq", "oid", "start", "payload")

    def __init__(self, kind, seq, oid, start, payload):
        self.kind = kind
        self.seq = seq
        self.oid = oid
        self.start = start
        self.payload = payload


class RawResult:
    """Returned by an rpc_ handler to answer with a raw frame instead of a
    msgpack RESPONSE. ``payload`` is written straight to the socket (an arena
    memoryview stays zero-copy); ``on_sent`` runs after the transport has
    taken the bytes — use it to release an object pin."""

    __slots__ = ("oid", "start", "payload", "on_sent")

    def __init__(self, oid: str, start: int, payload, on_sent=None):
        self.oid = oid
        self.start = start
        self.payload = payload
        self.on_sent = on_sent


def _pack_raw_header(kind: int, seq: int, oid_b: bytes, start: int, payload_len: int) -> bytes:
    n = _RAW_HDR.size + len(oid_b) + payload_len
    return (
        (RAW_FLAG | n).to_bytes(4, "big")
        + _RAW_HDR.pack(kind, 0, len(oid_b), seq, start)
        + oid_b
    )


class _WireStats:
    """Plain-int wire counters for the frame pump. Every reader/writer runs
    on the one IO loop thread, so bare ``+=`` is race-free there; the rare
    off-loop increments (connect bookkeeping) can at worst lose an event,
    never corrupt. Folded into ``ray_tpu_rpc_*`` instruments at metrics-flush
    cadence (self_metrics._collect_wire_stats) — an instrument lock per
    frame would tax the dispatch hot path."""

    __slots__ = (
        "frames_out", "bytes_out", "frames_in", "bytes_in",
        "connects", "resets", "hwm_stalls",
    )

    def __init__(self):
        self.frames_out = 0
        self.bytes_out = 0
        self.frames_in = 0
        self.bytes_in = 0
        self.connects = 0
        self.resets = 0
        self.hwm_stalls = 0


WIRE = _WireStats()


def schema(**fields):
    """Declare a wire schema for an ``rpc_`` handler (N4 analog of the
    reference's protobuf message types: the transport is schemaless msgpack,
    so required-field/type validation happens at dispatch).

    Field spec: name=type (required), name=(type, ...) for alternatives,
    name=None for required-any; prefix the name with ``_`` is not supported —
    mark OPTIONAL fields by wrapping the spec in a list: name=[type].
    Unknown payload keys are allowed (forward compatibility, like proto3).
    """

    def deco(fn):
        fn._rpc_schema = fields
        return fn

    return deco


def validate_payload(payload, fields) -> str | None:
    """Returns a problem description, or None if the payload conforms."""
    if not isinstance(payload, dict):
        return f"payload must be a map, got {type(payload).__name__}"
    for name, spec in fields.items():
        optional = isinstance(spec, list)
        if optional:
            spec = spec[0] if spec else None
        if name not in payload:
            if optional:
                continue
            return f"missing required field {name!r}"
        if spec is None:
            continue
        value = payload[name]
        if optional and value is None:
            continue
        if not isinstance(value, spec):
            want = getattr(spec, "__name__", spec)
            return f"field {name!r} must be {want}, got {type(value).__name__}"
    return None


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


def _set_nodelay(writer: "asyncio.StreamWriter"):
    """Request/response frames are small; Nagle coalescing only adds
    latency (the reference's gRPC channels disable it too)."""
    import socket as _socket

    sock = writer.get_extra_info("socket")
    if sock is not None and sock.family in (_socket.AF_INET, _socket.AF_INET6):
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass


def _pack(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    WIRE.frames_out += 1
    WIRE.bytes_out += len(body) + 4
    return len(body).to_bytes(4, "big") + body


_READ_CHUNK = 256 * 1024
# Responses are written without awaiting drain() unless the socket buffer
# has actually backed up: drain is a scheduling point per frame, and the
# transport already buffers — only genuine backpressure should suspend.
_WRITE_HIGH_WATER = 1 << 20


async def _frame_stream(reader: asyncio.StreamReader):
    """Yield decoded frames, draining every COMPLETE frame per socket read.

    The hot dispatch path: readexactly(4)+readexactly(n) costs two loop
    wakeups per frame; one buffered read() serves however many frames
    arrived, which is what makes pipelined task/result streams cheap."""
    buf = bytearray()
    pos = 0
    while True:
        avail = len(buf) - pos
        if avail >= 4:
            length = int.from_bytes(buf[pos : pos + 4], "big")
            if length & RAW_FLAG:
                # Raw frame: fixed header + object id + payload, no msgpack.
                n = length & ~RAW_FLAG
                if n < _RAW_HDR.size or n > _MAX_FRAME:
                    raise RpcError(f"bad raw frame length: {n}")
                if avail >= 4 + n:
                    kind, _flags, oid_len, seq, rstart = _RAW_HDR.unpack_from(
                        buf, pos + 4
                    )
                    if _RAW_HDR.size + oid_len > n:
                        raise RpcError("raw frame header overruns frame")
                    id_at = pos + 4 + _RAW_HDR.size
                    oid = bytes(buf[id_at : id_at + oid_len]).decode()
                    pos += 4 + n
                    WIRE.frames_in += 1
                    WIRE.bytes_in += n + 4
                    # The payload memoryview aliases the read buffer: hand it
                    # out for the duration of ONE consumer step and release
                    # it on resume, so the buffer can compact/grow again.
                    mv = memoryview(buf)
                    payload = mv[id_at + oid_len : pos]
                    try:
                        yield RawFrame(kind, seq, oid, rstart, payload)
                    finally:
                        payload.release()
                        mv.release()
                    continue
            elif length > _MAX_FRAME:
                raise RpcError(f"frame too large: {length}")
            elif avail >= 4 + length:
                start = pos + 4
                frame = msgpack.unpackb(bytes(buf[start : start + length]), raw=False)
                pos = start + length
                WIRE.frames_in += 1
                WIRE.bytes_in += length + 4
                yield frame
                continue
        if pos:
            del buf[:pos]  # compact consumed bytes before growing
            pos = 0
        chunk = await reader.read(_READ_CHUNK)
        if not chunk:
            raise asyncio.IncompleteReadError(bytes(buf), None)
        buf += chunk


# Jitter source for acall retry backoff (per-process random).
_BACKOFF_RNG = random.Random()


def retry_backoff_s(attempt: int, base_s: float, max_s: float, rng=None) -> float:
    """Capped exponential backoff with jitter for acall retries: attempt 1
    waits ~base, doubling per attempt up to max, each scaled by a uniform
    [0.5, 1.0) jitter factor so a fleet of retriers against one recovering
    peer decorrelates instead of hammering in lockstep."""
    r = (rng or _BACKOFF_RNG).random()
    return min(max_s, base_s * (1 << max(0, attempt - 1))) * (0.5 + 0.5 * r)


def _drain_if_needed(writer: asyncio.StreamWriter):
    """Awaitable-or-None: drain only under real backpressure."""
    try:
        if writer.transport.get_write_buffer_size() > _WRITE_HIGH_WATER:
            WIRE.hwm_stalls += 1
            flight_recorder.record("rpc_hwm_stall")
            return writer.drain()
    except Exception:
        pass
    return None


class EventLoopThread:
    """One background asyncio loop per process; all sockets live here.

    Analog of the per-process instrumented_io_context event loop in the
    reference (src/ray/common/asio/instrumented_io_context.h:27), including
    per-handler call stats for debugging.
    """

    _instance: "EventLoopThread | None" = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name="ray_tpu_io", daemon=True
        )
        self.handler_stats: dict[str, list] = collections.defaultdict(
            lambda: [0, 0.0]
        )  # name -> [count, total_s]
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    @classmethod
    def get(cls) -> "EventLoopThread":
        with cls._instance_lock:
            if cls._instance is None or not cls._instance._thread.is_alive():
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._instance_lock:
            inst, cls._instance = cls._instance, None
        if inst is not None:
            inst.loop.call_soon_threadsafe(inst.loop.stop)

    @blocking
    def run(self, coro: Awaitable, timeout: float | None = None):
        """Run a coroutine on the IO loop from any other thread, blocking.
        @blocking: calling this FROM the loop thread deadlocks it (the loop
        would wait on a future only the loop can complete)."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    @any_thread
    def spawn(self, coro: Awaitable) -> "asyncio.Future":
        return asyncio.run_coroutine_threadsafe(coro, self.loop)


Handler = Callable[[dict], Awaitable[Any]]


class RpcServer:
    """Method-dispatch RPC server. Register async handlers by name."""

    def __init__(self, name: str = "server"):
        self.name = name
        self._handlers: dict[str, Handler] = {}
        self._schemas: dict[str, dict] = {}
        self._server: asyncio.Server | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self.address: tuple[str, int] | str | None = None
        self._io = EventLoopThread.get()
        # Raw-frame sink: a SYNCHRONOUS callable (frame: RawFrame) -> dict,
        # invoked inline on the connection loop before the read buffer moves
        # (the payload memoryview dies when the frame stream resumes).
        self._raw_handler: Callable[[RawFrame], dict] | None = None

    def register(self, method: str, handler: Handler):
        self._handlers[method] = handler

    @any_thread
    def set_raw_handler(self, handler: Callable[[RawFrame], dict]):
        self._raw_handler = handler

    def register_all(self, obj, prefix: str = ""):
        """Register every ``rpc_<name>`` coroutine method of obj as <name>."""
        for attr in dir(obj):
            if attr.startswith("rpc_"):
                handler = getattr(obj, attr)
                self._handlers[prefix + attr[4:]] = handler
                schema = getattr(handler, "_rpc_schema", None)
                if schema is not None:
                    self._schemas[prefix + attr[4:]] = schema

    async def _serve_conn(self, reader, writer):
        _set_nodelay(writer)
        self._conns.add(writer)
        try:
            async for frame in _frame_stream(reader):
                if type(frame) is RawFrame:
                    # Handled INLINE (not ensure_future): the payload view is
                    # only valid until the stream resumes, and the arena
                    # write is a synchronous memcpy anyway.
                    handler = self._raw_handler
                    try:
                        if handler is None:
                            result = {"ok": False, "error": "no raw handler"}
                        else:
                            result = handler(frame)
                    except Exception as e:  # noqa: BLE001
                        result = {"ok": False, "error": repr(e)}
                    self._send_resp(
                        writer, "raw_chunk",
                        [_pack([RESPONSE, frame.seq, "raw_chunk", result])],
                    )
                    pending = _drain_if_needed(writer)
                    if pending is not None:
                        await pending
                    continue
                mtype, seq, method, payload = frame
                if mtype == REQUEST:
                    asyncio.ensure_future(
                        self._dispatch(writer, seq, method, payload)
                    )
                elif mtype == PUSH:
                    asyncio.ensure_future(self._dispatch(None, seq, method, payload))
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError, OSError):
            return
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    @loop_only
    def _send_resp(self, writer, method: str, parts) -> bool:
        """Response write seam: every server->client frame funnels here."""
        for p in parts:
            writer.write(p)
        return True

    async def _dispatch(self, writer, seq, method, payload):
        start = time.monotonic()
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r} on {self.name}")
            schema = self._schemas.get(method)
            if schema is not None:
                problem = validate_payload(payload, schema)
                if problem:
                    raise RpcError(f"schema violation in {method!r}: {problem}")
            result = await handler(payload)
            if isinstance(result, RawResult):
                # Negotiated raw response: header + payload straight to the
                # socket, no msgpack encode / bytes copy of the chunk. The
                # transport owns the bytes once write() returns, so on_sent
                # (typically an object-pin release) is safe immediately after.
                try:
                    if writer is not None:
                        oid_b = result.oid.encode()
                        self._send_resp(
                            writer, method,
                            [
                                _pack_raw_header(
                                    RAW_RESP, seq, oid_b, result.start,
                                    len(result.payload),
                                ),
                                result.payload,
                            ],
                        )
                        WIRE.frames_out += 1
                        WIRE.bytes_out += (
                            4 + _RAW_HDR.size + len(oid_b) + len(result.payload)
                        )
                        pending = _drain_if_needed(writer)
                        if pending is not None:
                            await pending
                finally:
                    if result.on_sent is not None:
                        result.on_sent()
            elif writer is not None:
                self._send_resp(writer, method, [_pack([RESPONSE, seq, method, result])])
                pending = _drain_if_needed(writer)
                if pending is not None:
                    await pending
        except (ConnectionResetError, BrokenPipeError):
            pass  # peer went away mid-response (routine at shutdown)
        except Exception as e:
            if writer is not None:
                err = {"error": repr(e), "traceback": traceback.format_exc()}
                try:
                    writer.write(_pack([ERROR, seq, method, err]))
                    await writer.drain()
                except Exception:
                    pass
            else:
                logger.exception("push handler %s failed", method)
        finally:
            stats = self._io.handler_stats[f"{self.name}.{method}"]
            stats[0] += 1
            stats[1] += time.monotonic() - start

    async def _start_tcp(self, host: str, port: int):
        self._server = await asyncio.start_server(self._serve_conn, host, port)
        sock = self._server.sockets[0]
        self.address = sock.getsockname()[:2]

    async def _start_unix(self, path: str):
        self._server = await asyncio.start_unix_server(self._serve_conn, path)
        self.address = path

    def start(self, host: str = "127.0.0.1", port: int = 0):
        self._io.run(self._start_tcp(host, port))
        return self.address

    def start_unix(self, path: str):
        self._io.run(self._start_unix(path))
        return self.address

    def stop(self):
        async def _stop():
            if self._server is not None:
                self._server.close()
            for w in list(self._conns):
                try:
                    w.close()
                except Exception:
                    pass

        try:
            self._io.run(_stop(), timeout=5)
        except Exception:
            pass


class RpcClient:
    """Retrying RPC client; safe to call from any thread or from the IO loop."""

    def __init__(self, address, label: str = "", connect_timeout: float | None = None):
        from ray_tpu_torch._private.config import get_config

        cfg = get_config()
        self.address = address
        self.label = label or str(address)
        self._io = EventLoopThread.get()
        self._connect_timeout = connect_timeout or cfg.rpc_connect_timeout_s
        self._retries = cfg.rpc_retries
        self._backoff_base_s = cfg.rpc_retry_backoff_base_ms / 1000.0
        self._backoff_max_s = cfg.rpc_retry_backoff_max_ms / 1000.0
        self._lock = asyncio.Lock()
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        # seq -> synchronous sink for a negotiated raw response: called with
        # the RawFrame while its payload view is valid (scatter straight into
        # the arena), its return value resolves the pending future.
        self._raw_sinks: dict[int, Callable[[RawFrame], Any]] = {}
        self._seq = 0
        self._push_handler: Callable[[str, dict], None] | None = None
        self._closed = False

    # ---- connection management (runs on IO loop) ----

    async def _ensure_connected(self):
        if self._writer is not None and not self._writer.is_closing():
            return
        deadline = time.monotonic() + self._connect_timeout
        last_err = None
        while time.monotonic() < deadline:
            try:
                if isinstance(self.address, str):
                    reader, writer = await asyncio.open_unix_connection(self.address)
                else:
                    reader, writer = await asyncio.open_connection(*self.address)
                _set_nodelay(writer)
                self._writer = writer
                self._reader_task = asyncio.ensure_future(self._read_loop(reader))
                WIRE.connects += 1
                flight_recorder.record("rpc_connect", self.label)
                return
            except OSError as e:
                last_err = e
                await asyncio.sleep(0.05)
        raise ConnectionLost(f"cannot connect to {self.label}: {last_err}")

    async def _read_loop(self, reader):
        try:
            async for frame in _frame_stream(reader):
                if type(frame) is RawFrame:
                    sink = self._raw_sinks.pop(frame.seq, None)
                    fut = self._pending.pop(frame.seq, None)
                    try:
                        result = sink(frame) if sink is not None else None
                    except Exception as e:  # noqa: BLE001
                        if fut is not None and not fut.done():
                            fut.set_exception(
                                RpcError(f"{self.label}: raw sink failed: {e!r}")
                            )
                    else:
                        if fut is not None and not fut.done():
                            fut.set_result(
                                result
                                if result is not None
                                else {"ok": True, "len": len(frame.payload)}
                            )
                    continue
                mtype, seq, method, payload = frame
                if mtype in (RESPONSE, ERROR):
                    fut = self._pending.pop(seq, None)
                    self._raw_sinks.pop(seq, None)  # peer answered in msgpack
                    if fut is not None and not fut.done():
                        if mtype == RESPONSE:
                            fut.set_result(payload)
                        else:
                            fut.set_exception(
                                RpcError(
                                    f"{self.label}.{method}: {payload['error']}\n"
                                    + payload.get("traceback", "")
                                )
                            )
                elif mtype == PUSH and self._push_handler is not None:
                    try:
                        self._push_handler(method, payload)
                    except Exception:
                        logger.exception("push handler failed")
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass
        finally:
            self._writer = None
            if not self._closed:
                WIRE.resets += 1
                flight_recorder.record("rpc_reset", self.label)
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionLost(f"connection to {self.label} lost"))
            self._pending.clear()
            self._raw_sinks.clear()

    @loop_only
    def _send_frames(self, method: str, parts) -> bool:
        """Client send seam: every outbound frame funnels here."""
        for p in parts:
            self._writer.write(p)
        return True

    async def astart_call(
        self, method: str, payload: dict | None = None, raw_sink=None
    ) -> "asyncio.Future":
        """Send a request; return the response future without awaiting it.

        Lets callers pipeline ordered calls: the send happens under the client
        lock (FIFO), so two astart_call()s issued in order hit the wire in
        order (the analog of the reference's SequentialActorSubmitQueue).

        ``raw_sink``: synchronous callable invoked with the RawFrame if the
        peer answers this request with a raw frame (negotiated transfer
        path); its return value resolves the future. A msgpack answer simply
        resolves the future as usual (the sink is dropped) — that IS the
        mixed-version fallback.
        """
        async with self._lock:
            await self._ensure_connected()
            self._seq += 1
            seq = self._seq
            fut = asyncio.get_event_loop().create_future()
            fut._rtpu_seq = seq  # lets acall unregister on per-attempt timeout
            self._pending[seq] = fut
            if raw_sink is not None:
                self._raw_sinks[seq] = raw_sink
            try:
                self._send_frames(method, [_pack([REQUEST, seq, method, payload or {}])])
            except ConnectionLost:
                # Injected partition: unregister the stillborn attempt so a
                # late frame can never resolve it, then surface the loss.
                self._pending.pop(seq, None)
                self._raw_sinks.pop(seq, None)
                raise
            pending = _drain_if_needed(self._writer)
            if pending is not None:
                await pending
        return fut

    async def astart_raw(
        self, kind: int, oid: str, start: int, payload
    ) -> "asyncio.Future":
        """Send a raw frame (header + payload bytes, no msgpack); return the
        future for the receiver's ack. ``payload`` is any buffer — an arena
        memoryview goes to the socket without an intermediate ``bytes``
        (the transport copies only what it cannot send immediately). Only
        valid after the peer advertised raw support for this session."""
        async with self._lock:
            await self._ensure_connected()
            self._seq += 1
            seq = self._seq
            fut = asyncio.get_event_loop().create_future()
            fut._rtpu_seq = seq
            self._pending[seq] = fut
            oid_b = oid.encode()
            try:
                self._send_frames(
                    "raw_chunk",
                    [_pack_raw_header(kind, seq, oid_b, start, len(payload)), payload],
                )
            except ConnectionLost:
                self._pending.pop(seq, None)
                raise
            WIRE.frames_out += 1
            WIRE.bytes_out += 4 + _RAW_HDR.size + len(oid_b) + len(payload)
            pending = _drain_if_needed(self._writer)
            if pending is not None:
                await pending
        return fut

    @loop_only
    def send_nowait(self, method: str, payload: dict | None = None):
        """LOOP-THREAD-ONLY fast path: write the request frame synchronously
        when the connection is up and no other sender holds the client lock;
        returns the response future, or None (caller falls back to acall).

        Saves the task-scheduling loop iteration astart_call costs per send —
        measurable on the sync dispatch ping-pong. Write ordering is
        preserved: every writer (here and astart_call) runs on the one IO
        loop, and the lock.locked() guard keeps us from interleaving with a
        sender that is mid-connect under the lock."""
        if (
            self._closed
            or self._writer is None
            or self._writer.is_closing()
            or self._lock.locked()
        ):
            return None
        try:
            if self._writer.transport.get_write_buffer_size() > _WRITE_HIGH_WATER:
                # Genuine backpressure (stalled peer): fall back to the
                # acall path, which awaits drain — an unchecked write here
                # would grow the socket buffer without bound.
                WIRE.hwm_stalls += 1
                flight_recorder.record("rpc_hwm_stall", self.label)
                return None
        except Exception:
            pass
        self._seq += 1
        seq = self._seq
        fut = asyncio.get_event_loop().create_future()
        fut._rtpu_seq = seq  # lets ack-timeout callers unregister the entry
        self._pending[seq] = fut
        try:
            self._send_frames(method, [_pack([REQUEST, seq, method, payload or {}])])
        except ConnectionLost:
            # Injected partition: behave like the cold-connection case —
            # the caller falls back to acall, which raises/retries cleanly.
            self._pending.pop(seq, None)
            return None
        return fut

    async def acall(
        self,
        method: str,
        payload: dict | None = None,
        timeout: float | None = None,
        retries: int | None = None,
        raw_sink=None,
    ):
        """Async call from the IO loop.

        ``timeout`` is PER ATTEMPT and TimeoutError is retried, so the worst
        case block is ``(retries+1) * timeout`` plus backoff. Callers that
        need a total bound pass ``retries=0`` (single attempt, safe only when
        dropping the message is acceptable) or wrap in an outer wait_for.
        """
        payload = payload or {}
        max_retries = self._retries if retries is None else retries
        attempt = 0
        while True:
            fut = None
            try:
                fut = await self.astart_call(method, payload, raw_sink=raw_sink)
                if timeout is not None:
                    return await asyncio.wait_for(fut, timeout)
                return await fut
            except (ConnectionLost, asyncio.TimeoutError):
                # Unregister the abandoned attempt. CRITICAL for raw sinks: a
                # LATE raw response must never invoke a sink whose caller has
                # moved on — the sink writes memory (arena scatter), and its
                # destination may have been freed/reused by then. With the
                # entry popped, the late frame resolves nothing and is
                # dropped on the floor.
                if fut is not None:
                    seq = getattr(fut, "_rtpu_seq", None)
                    if seq is not None:
                        self._pending.pop(seq, None)
                        self._raw_sinks.pop(seq, None)
                attempt += 1
                if self._closed or attempt > max_retries:
                    raise
                # Capped exponential backoff with seeded jitter: a
                # partitioned/recovering peer is probed at a decaying rate
                # instead of hammered at the fixed-pause full rate
                # (retries=0 callers never reach this sleep).
                await asyncio.sleep(
                    retry_backoff_s(attempt, self._backoff_base_s, self._backoff_max_s)
                )

    async def apush(self, method: str, payload: dict | None = None):
        async with self._lock:
            await self._ensure_connected()
            self._seq += 1
            self._send_frames(method, [_pack([PUSH, self._seq, method, payload or {}])])
            pending = _drain_if_needed(self._writer)
            if pending is not None:
                await pending

    @staticmethod
    def pack_push_frame(method: str, payload: dict) -> bytes:
        """Encode a one-way PUSH frame for apush_packed. seq is fixed at 0:
        PUSH dispatch never consults it (no response to pair), so the same
        bytes are valid on every connection."""
        return _pack([PUSH, 0, method, payload])

    async def apush_packed(self, method: str, frame: bytes):
        """One-way push of a PRE-PACKED frame (see pack_push_frame). The
        group-broadcast fan-out encodes each multi-MiB chunk frame ONCE and
        writes the same bytes down every member connection — K-1 msgpack
        encodes saved per chunk is most of the fan-out's CPU at scale.
        ``method`` is passed for the send seam only; the wire bytes are
        ``frame`` verbatim."""
        async with self._lock:
            await self._ensure_connected()
            self._seq += 1
            self._send_frames(method, [frame])
            pending = _drain_if_needed(self._writer)
            if pending is not None:
                await pending

    # ---- blocking API (from user threads) ----

    @blocking
    def call(
        self,
        method: str,
        payload: dict | None = None,
        timeout: float | None = None,
        retries: int | None = None,
    ):
        return self._io.run(self.acall(method, payload, timeout=timeout, retries=retries))

    @blocking
    def push(self, method: str, payload: dict | None = None):
        return self._io.run(self.apush(method, payload))

    @any_thread
    def set_push_handler(self, handler: Callable[[str, dict], None]):
        self._push_handler = handler

    @any_thread
    def close(self):
        self._closed = True

        async def _close():
            if self._writer is not None:
                try:
                    self._writer.close()
                except Exception:
                    pass
            if self._reader_task is not None:
                self._reader_task.cancel()

        # Never block the IO loop on itself: from the loop thread just
        # schedule the close; from any other thread wait briefly.
        if threading.current_thread() is self._io._thread:
            asyncio.ensure_future(_close())
            return
        try:
            self._io.run(_close(), timeout=2)
        except Exception:
            pass
