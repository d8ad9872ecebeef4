"""Channel — the compiled-graph data plane.

A ``Channel`` is a single-producer single-consumer bounded ring of slots
carved out of the node's existing shm arena (the same segment the object
store uses; see ``_private/store/arena.py``). The compiled-DAG executor
(``ray_tpu_torch/dag/compiled.py``) allocates one channel per DAG edge so repeated
dispatch over a static graph moves values through shared memory with ZERO
raylet RPCs, zero task specs and zero ObjectRef allocations per iteration —
the analog of the reference lineage's accelerated-DAG channels
(python/ray/experimental/channel/).

Wire/memory protocol (see README.md in this package for the full story):

- ring header (64 bytes at the channel's arena offset): ``write_count`` u64,
  ``read_count`` u64, ``closed`` u64. Counts are monotonic; slot index is
  ``seq % num_slots``. The count bump is the publication point: the producer
  fills the slot COMPLETELY before bumping ``write_count`` (x86-TSO store
  ordering; the consumer never reads a slot at/past ``write_count``).
- slot: u32 payload length then a msgpack envelope ``[kind, data, hop]``
  (kind 0 = value, 1 = error, 2 = device descriptor; ``data`` =
  serialization.py bytes — for kind 2 a serialized ``DeviceObjectMeta``
  whose PAYLOAD moves out-of-band, see device_envelope.py; ``hop`` =
  optional hop-timing stamp dict). Length ``0xFFFFFFFF`` marks an OVERSIZE
  payload delivered out-of-band through the reader's side-channel (chunked
  ``channel_data`` RPCs, the compiled analog of the chunked push path).
- doorbell: after bumping ``write_count`` the producer fires a one-way
  ``channel_doorbell`` push frame at the READER's RPC server (the existing
  worker-to-worker pipe); the handler sets the reader's gate event. The
  doorbell is a latency optimization, not a correctness requirement — a
  blocked reader also re-polls the ring, backing off exponentially from
  ``_POLL_BASE_S`` up to the ``channel_poll_interval_ms`` config cap.
- cross-node fallback: when producer and consumer do not share the arena the
  ring is skipped entirely and every envelope rides the chunked
  ``channel_data`` path, with ``channel_query`` polls for backpressure.

Robustness: ``closed`` (set at teardown) makes blocked readers/writers raise
``ChannelClosedError`` instead of hanging; a ``channel_poison`` RPC plants a
sticky error envelope at a reader so actor death propagates a typed error
through every downstream channel; writes past the ring capacity
(``max_buffered_results`` slots) block the producer; reads honor a timeout.
"""

from __future__ import annotations

import logging
import struct
import threading
import time

import msgpack

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private.concurrency import any_thread, blocking
from ray_tpu_torch.exceptions import RayTpuError

logger = logging.getLogger(__name__)


class _ChannelStats:
    """Plain-int channel counters — compiled iterations are the hottest
    loop in the runtime (built to shed per-iteration overhead), so writes
    must not pay an instrument lock or tag-dict per envelope. Folded into
    ray_tpu_channel_* instruments at metrics-flush cadence
    (self_metrics collector), like rpc.WIRE and lease_manager.LEASE_STATS.
    last_occupancy is the ring depth observed at the most recent sampled
    write (process-wide: a per-channel gauge tag would accumulate one stale
    series per torn-down channel forever)."""

    __slots__ = ("writes", "backpressure", "last_occupancy")

    def __init__(self):
        self.writes = 0
        self.backpressure = 0
        self.last_occupancy = 0


CHANNEL_STATS = _ChannelStats()


class _PipelineStats:
    """Plain-int pipeline counters fed by the resident loops (one stage
    iteration = one microbatch through that stage) and the descriptor
    resolver; folded into ``ray_tpu_pipeline_*`` instruments at metrics
    flush (same pattern as CHANNEL_STATS above). ``resolve_samples`` is a
    bounded deque of resolve latencies (seconds) drained into the
    ``ray_tpu_pipeline_resolve_latency_s`` histogram by the flush-time
    collector, so the hot path appends a float instead of paying the
    instrument lock per microbatch."""

    __slots__ = ("microbatches", "stall_ns", "resolve_samples")

    def __init__(self):
        import collections

        self.microbatches = 0
        self.stall_ns = 0
        self.resolve_samples = collections.deque(maxlen=512)


PIPELINE_STATS = _PipelineStats()

HEADER_SIZE = 64
_OFF_WRITE = 0
_OFF_READ = 8
_OFF_CLOSED = 16
_SIDE_MARKER = 0xFFFFFFFF
# Idle re-poll backoff: first miss waits _POLL_BASE_S, then doubles per idle
# round up to the channel_poll_interval_ms config cap. The doorbell (gate
# event) short-circuits any wait, so the cap bounds only doorbell LOSS
# recovery, and sustained idle converges to one wakeup per cap interval
# instead of 20/s per blocked reader on a 1-CPU box.
_POLL_BASE_S = 0.005
_FULL_POLL_S = 0.002
_CHUNK_BYTES = 512 * 1024

# Envelope kinds.
KIND_VALUE = 0
KIND_ERROR = 1
# Device-payload descriptor: the slot carries a ~300B DeviceObjectMeta; the
# payload itself moved out-of-band (p2p direct mailbox / collective pull /
# host fallback — experimental/channel/device_envelope.py).
KIND_DEVICE = 2


class ChannelError(RayTpuError):
    """Base error for the compiled-graph channel plane."""


class ChannelClosedError(ChannelError):
    """The channel was closed (teardown) or the endpoint is stopping."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    """A channel read/write did not complete within its timeout."""


def make_descriptor(
    cid: str,
    *,
    arena: str | None,
    offset: int,
    num_slots: int,
    slot_size: int,
    reader_addr,
    label: str = "",
) -> dict:
    """Wire-form channel descriptor shared by both endpoints."""
    return {
        "cid": cid,
        "arena": arena,  # None => remote (no shared segment) — RPC fallback
        "offset": offset,
        "num_slots": num_slots,
        "slot_size": slot_size,
        "reader_addr": list(reader_addr),
        "label": label,
    }


def ring_bytes(num_slots: int, slot_size: int) -> int:
    return HEADER_SIZE + num_slots * slot_size


class _Gate:
    """Reader-side meeting point between the IO loop (doorbell / side-channel
    / poison RPC handlers) and the blocked reader thread. All state behind
    one private lock; methods never block."""

    def __init__(self):
        from ray_tpu_torch._private.ids import BoundedIdSet

        self.event = threading.Event()
        self.lock = threading.Lock()
        self.parts: dict[int, dict] = {}  # seq -> {chunk_idx: bytes}
        self.done: dict[int, bytes] = {}  # seq -> assembled envelope bytes
        self.sticky: bytes | None = None  # poison envelope (actor death)
        self.closed = False
        # Recently-completed seqs: ``channel_data`` chunks are
        # at-least-once under connection blips (and chaos dup injection);
        # a duplicate arriving after its envelope completed — or after
        # pop() consumed it — used to re-open a forever-partial
        # reassembly, leaking memory AND inflating queued(), which is the
        # remote-mode writer's backpressure credit: enough duplicates and
        # the producer throttles on phantom queue depth. Tombstoned seqs
        # drop silently instead.
        self._completed = BoundedIdSet(cap=512)

    @any_thread
    def add_chunk(self, seq: int, idx: int, total: int, data: bytes):
        with self.lock:
            if seq in self._completed or seq in self.done:
                return  # duplicate of an already-assembled envelope
            parts = self.parts.setdefault(seq, {})
            parts[idx] = data
            if len(parts) == total:
                self.parts.pop(seq)
                self.done[seq] = b"".join(parts[i] for i in range(total))
                self._completed.add(seq)
        self.event.set()

    @any_thread
    def pop(self, seq: int) -> bytes | None:
        with self.lock:
            return self.done.pop(seq, None)

    @any_thread
    def queued(self) -> int:
        with self.lock:
            return len(self.done) + len(self.parts)

    @any_thread
    def poison(self, env: bytes):
        with self.lock:
            self.sticky = env
        self.event.set()

    @any_thread
    def close(self):
        self.closed = True
        self.event.set()


class ChannelRegistry:
    """Per-process registry of channel reader gates (one per CoreWorker).
    The ``rpc_channel_*`` handlers on CoreWorker dispatch into it."""

    def __init__(self):
        import collections

        self._gates: dict[str, _Gate] = {}
        self._lock = threading.Lock()
        # Torn-down channel ids: a doorbell / chunk frame still in flight at
        # teardown must not resurrect a gate nobody will ever drop again
        # (long-lived workers join many compiled DAGs). Bounded FIFO — cids
        # are random per-DAG, collisions across the horizon don't matter.
        self._dropped = collections.deque(maxlen=4096)
        self._dropped_set: set[str] = set()

    @any_thread
    def gate(self, cid: str) -> _Gate:
        with self._lock:
            gate = self._gates.get(cid)
            if gate is None:
                gate = self._gates[cid] = _Gate()
                if cid in self._dropped_set:
                    gate.closed = True  # late frame for a torn-down channel
            return gate

    @any_thread
    def gate_if_live(self, cid: str) -> _Gate | None:
        """RPC-handler entry: None for torn-down channels so late frames
        are dropped instead of recreating state."""
        with self._lock:
            if cid in self._dropped_set:
                return None
            gate = self._gates.get(cid)
            if gate is None:
                gate = self._gates[cid] = _Gate()
            return gate

    @any_thread
    def ring_doorbell(self, cid: str):
        gate = self.gate_if_live(cid)
        if gate is not None:
            gate.event.set()

    @any_thread
    def drop(self, cids) -> None:
        with self._lock:
            for cid in cids:
                gate = self._gates.pop(cid, None)
                if gate is not None:
                    gate.close()
                if cid not in self._dropped_set:
                    if len(self._dropped) == self._dropped.maxlen:
                        self._dropped_set.discard(self._dropped[0])
                    self._dropped.append(cid)
                    self._dropped_set.add(cid)


def pack_envelope(kind: int, data: bytes, hop: dict | None = None) -> bytes:
    return msgpack.packb([kind, data, hop], use_bin_type=True)


def unpack_envelope(env: bytes) -> tuple[int, bytes, dict | None]:
    kind, data, hop = msgpack.unpackb(env, raw=False)
    return kind, data, hop


class _Endpoint:
    """State shared by both channel endpoints: descriptor fields, the arena
    view when this process shares the ring's segment, and the gate."""

    def __init__(self, desc: dict, cw):
        self.desc = desc
        self.cw = cw
        self.cid = desc["cid"]
        self.label = desc.get("label") or self.cid[:8]
        self.num_slots = int(desc["num_slots"])
        self.slot_size = int(desc["slot_size"])
        self.slot_cap = self.slot_size - 4
        self.base = int(desc["offset"])
        arena = cw.store.arena
        self.shm = bool(desc.get("arena")) and getattr(arena, "name", None) == desc["arena"]
        self._view = arena.view if self.shm else None
        self.gate = cw.channels.gate(self.cid)
        # Fallback re-poll cap (doorbell loss recovery); see _POLL_BASE_S.
        self._poll_cap_s = max(
            _POLL_BASE_S,
            getattr(cw.cfg, "channel_poll_interval_ms", 50) / 1000.0,
        )

    # ---- ring header accessors (shm mode only) ----

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._view, self.base + off)[0]

    def _set_u64(self, off: int, value: int):
        struct.pack_into("<Q", self._view, self.base + off, value)

    def _closed(self) -> bool:
        if self.gate.closed:
            return True
        return self.shm and self._u64(_OFF_CLOSED) != 0

    def _slot_off(self, seq: int) -> int:
        return self.base + HEADER_SIZE + (seq % self.num_slots) * self.slot_size

    def _reader_client(self):
        return self.cw._owner_client(tuple(self.desc["reader_addr"]))

    def _check_closed(self, stop) -> None:
        if self._closed() or (stop is not None and stop.is_set()):
            raise ChannelClosedError(f"channel {self.label} is closed")


class ChannelWriter(_Endpoint):
    """The producing endpoint. Single producer per channel by contract (the
    one exception — the driver poisoning a dead producer's consumers — goes
    through the reader's gate, never the ring, so the contract holds)."""

    def __init__(self, desc: dict, cw):
        super().__init__(desc, cw)
        self._next_seq = self._u64(_OFF_WRITE) if self.shm else 0
        # Remote-mode credit: envelopes sent since the reader's queue depth
        # was last observed. A query RPC is only paid when the local credit
        # is exhausted (bounded-credit, like the push path's admission),
        # not per write.
        self._inflight = 0
        # Device payloads published through this writer whose holder pin is
        # released by RING ADVANCE instead of a consumer frame: (seq, oid)
        # FIFO, reaped by device_envelope.emit once the consumer's
        # read_count proves the slot was popped AND its resolution is over
        # (the consumer pops seq+1 only after fully processing seq, so
        # everything <= read_count - 2 is done). shm mode only.
        self.payload_fifo = None  # lazily a deque on first device emit

    @any_thread
    def next_seq(self) -> int:
        """The sequence number the NEXT write() will publish under. Stable
        between a call here and the following write (single producer, one
        writing thread): device_envelope.emit uses it to key the eager
        out-of-band payload push to the slot it belongs to."""
        return self._u64(_OFF_WRITE) if self.shm else self._next_seq

    @blocking
    def write(self, kind: int, data: bytes, hop: dict | None = None,
              timeout: float | None = None, stop=None,
              doorbell: bool = True) -> None:
        """Publish one envelope; blocks while the ring is full (backpressure)
        up to ``timeout`` (None = forever). Raises ChannelClosedError if the
        channel closes (teardown / stop event) while blocked.
        ``doorbell=False`` skips the wakeup frame — device emits send the
        payload frame right after the slot publish and ITS deposit rings
        the reader's gate (one frame on the wire instead of two)."""
        env = pack_envelope(kind, data, hop)
        deadline = None if timeout is None else time.monotonic() + timeout
        if self.shm:
            self._write_shm(env, deadline, stop, doorbell)
        else:
            self._write_remote(env, deadline, stop)
        # Plain-int accounting per write; the flight event and occupancy
        # probe are 1-in-64 sampled (channel_block fires unsampled — it is
        # rare and is the signal that matters).
        writes = CHANNEL_STATS.writes = CHANNEL_STATS.writes + 1
        if writes & 63 == 0:
            flight_recorder.record("channel_write", f"{self.label}:n={writes}")
            if self.shm:
                CHANNEL_STATS.last_occupancy = (
                    self._u64(_OFF_WRITE) - self._u64(_OFF_READ)
                )

    @blocking
    def wait_writable(self, timeout: float | None = None, stop=None) -> None:
        """Block until the next write() cannot block on backpressure.
        Multi-channel producers (the driver's execute() fan-out) reserve
        space on EVERY channel first so a full ring discovered halfway
        through a batch of writes cannot leave the channels desynchronized
        (space only grows between this check and the write: the channel is
        single-producer and the one consumer only drains)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if self.shm:
            while self._u64(_OFF_WRITE) - self._u64(_OFF_READ) >= self.num_slots:
                self._wait_tick(deadline, stop, _FULL_POLL_S)
            self._check_closed(stop)
        else:
            self._remote_credit_wait(deadline, stop)

    def _wait_tick(self, deadline, stop, interval: float):
        self._check_closed(stop)
        if deadline is not None and time.monotonic() >= deadline:
            raise ChannelTimeoutError(
                f"write to channel {self.label} timed out (ring full: "
                f"{self.num_slots} results buffered and unconsumed)"
            )
        time.sleep(interval)

    def _write_shm(self, env: bytes, deadline, stop, doorbell: bool = True):
        if self._u64(_OFF_WRITE) - self._u64(_OFF_READ) >= self.num_slots:
            # Backpressure entry (once per blocked write, not per poll tick).
            flight_recorder.record("channel_block", self.label)
            CHANNEL_STATS.backpressure += 1
        while self._u64(_OFF_WRITE) - self._u64(_OFF_READ) >= self.num_slots:
            self._wait_tick(deadline, stop, _FULL_POLL_S)
        self._check_closed(stop)
        seq = self._u64(_OFF_WRITE)
        off = self._slot_off(seq)
        if len(env) <= self.slot_cap:
            struct.pack_into("<I", self._view, off, len(env))
            self._view[off + 4 : off + 4 + len(env)] = env
        else:
            # Oversize: ship the envelope through the reader's side-channel
            # (chunked, acked), then publish a marker slot.
            self._send_chunks(seq, env)
            struct.pack_into("<I", self._view, off, _SIDE_MARKER)
        # Publication point: slot contents are fully written before the
        # count bump makes them visible to the consumer.
        self._set_u64(_OFF_WRITE, seq + 1)
        self._next_seq = seq + 1
        if doorbell:
            self._doorbell()

    def _write_remote(self, env: bytes, deadline, stop):
        self._remote_credit_wait(deadline, stop)
        seq = self._next_seq
        self._send_chunks(seq, env)
        self._next_seq = seq + 1
        self._inflight += 1

    def _remote_credit_wait(self, deadline, stop):
        """Honor the num_slots bound without a query RPC per write: only
        when the local credit runs out is the reader's actual queue depth
        fetched (consumption shrinks it); bounded-credit, like the push
        path's admission control."""
        self._check_closed(stop)
        if self._inflight < self.num_slots:
            return
        client = self._reader_client()
        while True:
            try:
                resp = client.call("channel_query", {"cid": self.cid}, timeout=10)
            except Exception as e:
                raise ChannelClosedError(
                    f"reader of channel {self.label} unreachable: {e!r}"
                ) from None
            if resp.get("closed"):
                raise ChannelClosedError(f"channel {self.label} is closed")
            self._inflight = resp.get("queued", 0)
            if self._inflight < self.num_slots:
                return
            self._wait_tick(deadline, stop, 0.01)

    def _send_chunks(self, seq: int, env: bytes):
        """Chunked, acked delivery of one envelope into the reader's gate —
        the compiled-graph ride on the chunked push-path shape (bounded
        frames, receiver reassembles, last chunk completes the record)."""
        client = self._reader_client()
        total = max(1, (len(env) + _CHUNK_BYTES - 1) // _CHUNK_BYTES)
        try:
            for i in range(total):
                resp = client.call(
                    "channel_data",
                    {
                        "cid": self.cid,
                        "seq": seq,
                        "idx": i,
                        "total": total,
                        "data": env[i * _CHUNK_BYTES : (i + 1) * _CHUNK_BYTES],
                    },
                    timeout=30,
                )
        except Exception as e:
            raise ChannelClosedError(
                f"side-channel delivery on {self.label} failed: {e!r}"
            ) from None
        if resp.get("closed"):
            raise ChannelClosedError(f"channel {self.label} is closed")

    def _doorbell(self):
        """One-way wakeup frame at the reader; loss is benign (readers
        re-poll the ring, backing off to the channel_poll_interval_ms cap)."""
        try:
            client = self._reader_client()
            fut = self.cw._io.spawn(
                client.apush("channel_doorbell", {"cid": self.cid})
            )
            fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        except Exception:
            pass


class ChannelReader(_Endpoint):
    """The consuming endpoint (single consumer per channel)."""

    def __init__(self, desc: dict, cw):
        super().__init__(desc, cw)
        self._next_seq = self._u64(_OFF_READ) if self.shm else 0
        # Sequence number of the most recently consumed envelope — the key
        # device_envelope.resolve uses to find the eager-pushed payload for
        # a KIND_DEVICE slot.
        self.last_seq = -1

    @blocking
    def read(self, timeout: float | None = None, stop=None) -> tuple[int, bytes, dict | None]:
        """Block until the next envelope is available; returns
        ``(kind, data, hop)``. Honors ``timeout`` (ChannelTimeoutError),
        channel close and the caller's stop event (ChannelClosedError), and
        sticky poison (returns the planted error envelope). A doorbell (the
        gate event) wakes the wait immediately; the fallback re-poll backs
        off exponentially from _POLL_BASE_S to the channel_poll_interval_ms
        cap while idle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        idle = 0
        while True:
            env = self._try_consume()
            if env is not None:
                return unpack_envelope(env)
            if self.gate.sticky is not None:
                return unpack_envelope(self.gate.sticky)
            self._check_closed(stop)
            if deadline is not None and time.monotonic() >= deadline:
                raise ChannelTimeoutError(f"read on channel {self.label} timed out")
            self.gate.event.clear()
            # Re-check between clear and wait: a doorbell landing in that
            # window must not be lost for a full poll interval.
            env = self._try_consume()
            if env is not None:
                return unpack_envelope(env)
            if self.gate.sticky is not None:
                return unpack_envelope(self.gate.sticky)
            poll = min(_POLL_BASE_S * (1 << min(idle, 16)), self._poll_cap_s)
            idle += 1
            remaining = None if deadline is None else deadline - time.monotonic()
            self.gate.event.wait(
                poll if remaining is None else max(0.0, min(poll, remaining))
            )

    def _try_consume(self) -> bytes | None:
        if self.shm:
            seq = self._u64(_OFF_READ)
            if self._u64(_OFF_WRITE) <= seq:
                return None
            off = self._slot_off(seq)
            length = struct.unpack_from("<I", self._view, off)[0]
            if length == _SIDE_MARKER:
                env = self.gate.pop(seq)
                if env is None:
                    return None  # side-channel chunks still in flight
            else:
                env = bytes(self._view[off + 4 : off + 4 + length])
            self._set_u64(_OFF_READ, seq + 1)
            self._next_seq = seq + 1
            self.last_seq = seq
            return env
        env = self.gate.pop(self._next_seq)
        if env is not None:
            self.last_seq = self._next_seq
            self._next_seq += 1
        return env
