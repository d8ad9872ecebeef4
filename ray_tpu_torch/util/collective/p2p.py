"""Point-to-point transfer plane for collective groups and channel payloads.

From ``ray_tpu/util/collective/p2p.py``; the wire, keys, trees, roster and
counters are the JAX package's, and tensors take the place of jax.Arrays.

Analog of the reference's ``ray.util.collective`` ``send``/``recv``
(python/ray/util/collective/collective.py:531/594): a 2-party transfer
between two ranks of an initialized group, OUT OF BAND with respect to the
shm object store — this is the wire the device-object plane
(experimental/device_object/) rides for actor-to-actor tensor handoff.

Two rendezvous mechanisms share this seam:

- **GCS-KV mailbox** (``mailbox_send``/``mailbox_recv``): the JAX
  package's group-rank path. The sender posts the serialized value under a
  single-use tagged key in the group's GCS KV; the receiver polls it down
  and deletes it. Needs no peer address. Here only a group broadcast's
  fan-out takes it, for a rank with no registered address.
- **Direct mailbox** (``direct_send``/``direct_recv`` + ``P2PInbox``): a
  group's send/recv (``group_send``/``group_recv``) and the descriptor
  channel plane (experimental/channel/device_envelope.py) ride it. The
  sender pushes chunked one-way ``p2p_data`` frames straight at the
  consumer core worker's RPC server (no GCS round trips, no polling); the
  receiver waits on its process-local inbox. Keys are caller-scoped
  (``chdev/<cid>/<seq>`` for channel slots), delivery is at-most-once —
  channel readers fall back to a pull (resolve.py) on a missed grace
  window, a group's recv raises its typed timeout.

Tensors serialize through ``_private/serialization``: a CUDA tensor leaves
as host bytes (one device-to-host copy, which completes before the bytes
are read) and lands back on ``cuda:<index>`` at the receiver, bit for bit.

Both host mailboxes are the wire for device payloads too: a correctness
stand-in for a device-to-device path (CUDA IPC between processes on one
card, NCCL send/recv across cards). The seams are ``NcclCollectiveGroup.
send/recv`` and ``direct_send/direct_recv`` — swap in the device path there
without touching any caller.
"""

from __future__ import annotations

import threading
import time

from ray_tpu_torch._private.concurrency import any_thread, blocking, loop_only
from ray_tpu_torch.util.collective.types import ReduceOp

_POLL_S = 0.003
# Direct-mailbox chunk size: one-way frames on the existing worker pipe,
# bounded like the chunked object-push path.
_DIRECT_CHUNK_BYTES = 512 * 1024
# Unclaimed inbox entries (consumer died / tore down between the eager push
# and the read) are swept after this age so a long-lived worker's inbox
# cannot grow without bound on lost readers.
_INBOX_SWEEP_AGE_S = 180.0


def host_array(value):
    """A contiguous numpy array of ``value``'s elements for the chunk-wise
    tree combine: a tensor (CPU or CUDA) through one copy to the host,
    anything else through ``np.ascontiguousarray``. A tensor dtype numpy
    cannot add (bfloat16, the float8 kinds) raises: the combine would have
    to round differently from the tensor's own arithmetic."""
    import numpy as np

    from ray_tpu_torch._private import serialization

    if serialization.is_tensor(value):
        host, dtype = serialization.tensor_to_numpy(value)
        if host.dtype.kind == "u" and dtype not in ("uint8",):
            raise TypeError(f"a tree reduce of {dtype} tensors is not supported; reduce in float32")
        return np.ascontiguousarray(host)
    return np.ascontiguousarray(value)


def mailbox_key(group_name: str, src_rank: int, dst_rank: int, tag: str) -> str:
    """Public so senders can janitor abandoned transfers (a recv that timed
    out or died never deletes the key; without cleanup the serialized
    payload would sit in the GCS KV forever)."""
    return f"collective/{group_name}/p2p/{src_rank}->{dst_rank}/{tag}"


_key = mailbox_key


@blocking
def mailbox_send(gcs, group_name: str, src_rank: int, dst_rank: int, tag: str, value) -> int:
    """Serialize ``value`` and post it for ``dst_rank``; returns byte size.
    Single-use: the receiver deletes the key after pickup."""
    from ray_tpu_torch._private import serialization

    data = serialization.dumps(value)
    gcs.call(
        "kv_put",
        {"key": _key(group_name, src_rank, dst_rank, tag), "value": data},
    )
    return len(data)


@blocking
def mailbox_recv(gcs, group_name: str, src_rank: int, dst_rank: int, tag: str, timeout: float = 120.0):
    """Block until the tagged value from ``src_rank`` arrives; deserializes
    (device arrays reassemble with their original sharding) and deletes the
    mailbox key."""
    from ray_tpu_torch._private import serialization

    key = _key(group_name, src_rank, dst_rank, tag)
    deadline = time.monotonic() + timeout
    while True:
        resp = gcs.call("kv_get", {"key": key})
        if resp.get("found"):
            gcs.call("kv_del", {"key": key})
            return serialization.loads(resp["value"])
        if time.monotonic() > deadline:
            from ray_tpu_torch.exceptions import CollectiveTimeoutError

            raise CollectiveTimeoutError(
                f"p2p recv on group {group_name!r} tag {tag!r} from rank "
                f"{src_rank} timed out after {timeout}s",
                group=group_name, ranks=[src_rank], tag=tag,
            )
        time.sleep(_POLL_S)


@blocking
def group_send(gcs, group_name: str, src_rank: int, dst_rank: int, tag: str, value, addr=None,
               counts=None) -> int:
    """A group's 2-party send, over the direct mailbox at ``addr`` (the
    destination member's registered core-worker address: 512 KiB one-way
    frames, no GCS round trips). The JAX package's groups take the GCS-KV
    mailbox; the port moves device payloads of hundreds of MB this way,
    which the KV (and its write-ahead log) must not carry. A destination
    with no registered address raises ``CollectiveError`` naming its rank.
    ``counts`` (a Counter kept by the group) numbers the sends of each
    (dst, tag): the inbox drops a key it has completed, so the n-th send of
    a reused tag takes key n, which the n-th receive waits on. Returns the
    serialized byte size."""
    from ray_tpu_torch._private import serialization, worker_context
    from ray_tpu_torch.exceptions import CollectiveError

    cw = worker_context.get_core_worker_if_initialized()
    if addr is None or cw is None:
        raise CollectiveError(
            f"p2p send on group {group_name!r} tag {tag!r}: rank {dst_rank} has no registered "
            f"address" if cw is not None else
            f"p2p send on group {group_name!r} tag {tag!r}: this process has no core worker"
        )
    seq = _next(counts, ("send", dst_rank, tag))
    data = serialization.dumps(value)
    direct_send(cw, tuple(addr), f"{_key(group_name, src_rank, dst_rank, tag)}/{seq}", data)
    return len(data)


def _next(counts, key) -> int:
    if counts is None:
        return 0
    n = counts[key]
    counts[key] = n + 1
    return n


@blocking
def group_recv(gcs, group_name: str, src_rank: int, dst_rank: int, tag: str, timeout: float = 120.0,
               counts=None):
    """The receiving side of :func:`group_send` (``counts`` numbers the
    receives of each (src, tag) as the sender numbers its sends): waits on
    this process's direct inbox. Raises the typed timeout naming the group,
    the source rank and the tag."""
    from ray_tpu_torch._private import serialization, worker_context
    from ray_tpu_torch.exceptions import CollectiveError, CollectiveTimeoutError

    cw = worker_context.get_core_worker_if_initialized()
    if cw is None:
        raise CollectiveError(f"p2p recv on group {group_name!r} tag {tag!r}: this process has no core worker")
    key = f"{_key(group_name, src_rank, dst_rank, tag)}/{_next(counts, ('recv', src_rank, tag))}"
    data = direct_recv(cw, key, timeout)
    if data is None:
        raise CollectiveTimeoutError(
            f"p2p recv on group {group_name!r} tag {tag!r} from rank "
            f"{src_rank} timed out after {timeout}s",
            group=group_name, ranks=[src_rank], tag=tag,
        )
    return serialization.loads(data)


# ---------------------------------------------------------------------------
# Direct mailbox (address-directed, no GCS round trips)
# ---------------------------------------------------------------------------


class P2PInbox:
    """Per-process landing zone for ``p2p_data`` frames (one per core
    worker; the ``rpc_p2p_data`` handler deposits into it). Chunked frames
    reassemble here; a waiter blocks on a per-key event. All state behind
    one lock; methods never block — deposit runs on the IO loop."""

    def __init__(self):
        from ray_tpu_torch._private.ids import BoundedIdSet

        self._lock = threading.Lock()
        self._parts: dict[str, dict] = {}    # key -> {idx: bytes}
        self._parts_ts: dict[str, float] = {}  # key -> first-chunk monotonic ts
        self._done: dict[str, tuple] = {}    # key -> (bytes, monotonic ts)
        self._waiters: dict[str, threading.Event] = {}
        self._deposits = 0
        # Recently-COMPLETED keys: delivery of p2p_data frames is
        # at-least-once under connection blips (and chaos dup injection),
        # and a duplicate chunk arriving AFTER its payload completed used
        # to re-open a partial reassembly that could never complete
        # (leaked until the age sweep) — or, for a single-chunk payload,
        # resurrect a consumed ``_done`` entry, breaking the at-most-once
        # take() contract. Tombstoned keys drop silently.
        self._completed = BoundedIdSet(cap=1024)

    @any_thread
    def deposit(self, key: str, idx: int, total: int, data: bytes) -> bool:
        """Returns True when the payload is COMPLETE (all chunks landed).
        Idempotent under duplicated/reordered chunks: a repeat of a
        still-assembling chunk overwrites in place, and any chunk of an
        already-completed key is dropped."""
        complete = False
        with self._lock:
            if key in self._completed or key in self._done:
                self._deposits += 1
                return False  # duplicate of a completed payload
            parts = self._parts.get(key)
            if parts is None:
                parts = self._parts[key] = {}
                self._parts_ts[key] = time.monotonic()
            parts[idx] = data
            if len(parts) == total:
                self._completed.add(key)
                self._parts.pop(key)
                self._parts_ts.pop(key, None)
                self._done[key] = (
                    data if total == 1 else b"".join(parts[i] for i in range(total)),
                    time.monotonic(),
                )
                waiter = self._waiters.get(key)
                if waiter is not None:
                    waiter.set()
                complete = True
            self._deposits += 1
            sweep = self._deposits & 255 == 0
        if sweep:
            self.sweep()
        return complete

    @any_thread
    def take(self, key: str) -> bytes | None:
        with self._lock:
            entry = self._done.pop(key, None)
            return None if entry is None else entry[0]

    @any_thread
    def _waiter(self, key: str) -> threading.Event:
        with self._lock:
            if key in self._done:
                ev = threading.Event()
                ev.set()
                return ev
            ev = self._waiters.get(key)
            if ev is None:
                ev = self._waiters[key] = threading.Event()
            return ev

    @any_thread
    def _drop_waiter(self, key: str) -> None:
        with self._lock:
            self._waiters.pop(key, None)

    @any_thread
    def completed(self, key: str) -> bool:
        """True once every chunk of ``key`` has landed — stays true after a
        take() (the tombstone remembers), which is exactly the delivery
        acknowledgement ``p2p_ack`` needs: 'the payload reached this
        process', not 'it is still unclaimed'."""
        with self._lock:
            return key in self._completed or key in self._done

    @blocking
    def wait_complete(self, key: str, timeout: float) -> bool:
        """Block (bounded) until ``key``'s payload has fully landed. Used by
        the ``p2p_ack`` RPC: the ack rides the same connection as the data
        frames, but handlers are dispatched as tasks, so a bounded wait
        covers the (rare) reorder instead of trusting scheduling order."""
        deadline = time.monotonic() + timeout
        ev = self._waiter(key)
        try:
            while True:
                if self.completed(key):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                ev.wait(min(0.05, remaining))
                ev.clear()
        finally:
            self._drop_waiter(key)

    @any_thread
    def purge_prefix(self, prefix: str) -> int:
        """Drop every entry/partial under a key prefix (channel teardown:
        cids are dead, nobody will ever take these payloads)."""
        with self._lock:
            victims = [k for k in self._done if k.startswith(prefix)]
            for k in victims:
                del self._done[k]
            for k in [k for k in self._parts if k.startswith(prefix)]:
                del self._parts[k]
                self._parts_ts.pop(k, None)
                victims.append(k)
            return len(victims)

    @any_thread
    def sweep(self, max_age_s: float = _INBOX_SWEEP_AGE_S) -> int:
        """Age out unclaimed payloads AND stale partial reassemblies (a
        producer that died mid-push leaves chunks that will never
        complete — lost writers must not leak any more than lost
        readers)."""
        cutoff = time.monotonic() - max_age_s
        with self._lock:
            victims = [k for k, (_, ts) in self._done.items() if ts < cutoff]
            for k in victims:
                del self._done[k]
            stale = [k for k, ts in self._parts_ts.items() if ts < cutoff]
            for k in stale:
                self._parts.pop(k, None)
                del self._parts_ts[k]
            return len(victims) + len(stale)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._done),
                "partials": len(self._parts),
                "bytes": sum(len(d) for d, _ in self._done.values()),
            }


@any_thread
def direct_send(cw, addr: tuple, key: str, data: bytes) -> None:
    """Push serialized payload bytes at ``addr``'s inbox under ``key`` as
    chunked ONE-WAY frames on the existing worker pipe (fire-and-forget,
    like the channel doorbell): zero round trips on the hot path. Loss is
    recoverable — the consumer's grace window expires and it falls back to
    the pull path (resolve.py), where the holder still pins the payload."""
    client = cw._owner_client(tuple(addr))
    total = max(1, (len(data) + _DIRECT_CHUNK_BYTES - 1) // _DIRECT_CHUNK_BYTES)

    async def _push_all():
        try:
            for i in range(total):
                await client.apush(
                    "p2p_data",
                    {
                        "key": key,
                        "idx": i,
                        "total": total,
                        "data": data[
                            i * _DIRECT_CHUNK_BYTES : (i + 1) * _DIRECT_CHUNK_BYTES
                        ],
                    },
                )
        except Exception:
            pass  # consumer unreachable: its grace window handles it

    cw._io.spawn(_push_all())


# ---------------------------------------------------------------------------
# Modeled egress link (bench-only)
# ---------------------------------------------------------------------------

# When set, every outbound payload chunk on the group plane (root fan-out,
# relay forwards, reduce up-pushes) serializes through ONE per-process
# asyncio.Lock and sleeps bytes/bandwidth: loopback has no per-NIC
# budget, so an unthrottled A/B
# cannot show what a relay tree buys — the modeled link is the honest
# stand-in for the per-host egress bandwidth the tree divides on a real
# fleet. Off (None) outside the bench.
_EGRESS_BPS: float | None = None
_EGRESS_LOCK = None  # created lazily on the IO loop


@any_thread
def set_modeled_egress(mib_per_s: float | None) -> None:
    """Install (or clear, with None) the modeled per-process egress link."""
    global _EGRESS_BPS
    _EGRESS_BPS = None if not mib_per_s else float(mib_per_s) * 1024 * 1024


async def _gate_egress(nbytes: int) -> None:
    global _EGRESS_LOCK
    bps = _EGRESS_BPS
    if not bps:
        return
    import asyncio

    if _EGRESS_LOCK is None:
        _EGRESS_LOCK = asyncio.Lock()
    async with _EGRESS_LOCK:
        await asyncio.sleep(nbytes / bps)


# ---------------------------------------------------------------------------
# Binomial relay tree
# ---------------------------------------------------------------------------


def _binomial_children(pos: int, n: int) -> list[int]:
    """Child POSITIONS of ``pos`` in the binomial broadcast tree over ``n``
    positions rooted at 0: ``pos + 2**k`` for every power of two strictly
    greater than ``pos`` (depth ceil(log2 n), root degree floor(log2 n) —
    the classic recursive-doubling shape, so the root writes O(log K)
    streams instead of K)."""
    kids = []
    step = 1
    while step <= pos:
        step <<= 1
    while pos + step < n:
        kids.append(pos + step)
        step <<= 1
    return kids


class RelayTable:
    """Per-process cut-through relay sessions for TREE group broadcasts
    (one per core worker; ``rpc_p2p_data`` feeds it when a chunk frame
    carries a ``relay`` spec). Each landed chunk is forwarded to this
    member's own tree children the moment the contiguous prefix reaches it
    — the ``push_manager.stream_from_session`` watermark pattern, NOT
    store-and-forward, so the next hop starts before this one finishes.
    All state lives on the IO loop (deposits and forwarder tasks alike):
    no lock. The inbox keeps its own copy for the local take()."""

    def __init__(self):
        from ray_tpu_torch._private.ids import BoundedIdSet

        self._sessions: dict[str, _RelaySession] = {}
        # Delivery is at-least-once under connection blips (and chaos dup
        # injection): a duplicate chunk landing after the session finished
        # must not resurrect it.
        self._finished = BoundedIdSet(cap=512)

    @loop_only
    def feed(self, cw, key: str, idx: int, total: int, data: bytes, relay: dict) -> None:
        st = self._sessions.get(key)
        if st is None:
            if key in self._finished:
                return
            st = self._sessions[key] = _RelaySession(key, int(total), relay)
            st.start(cw, self)
        st.chunks[idx] = data
        while st.contig in st.chunks:
            st.contig += 1
        st.event.set()

    @loop_only
    def finish(self, key: str) -> None:
        if self._sessions.pop(key, None) is not None:
            self._finished.add(key)

    def stats(self) -> dict:
        return {"sessions": len(self._sessions)}


class _RelaySession:
    """One in-flight relay: the chunks as they land, the contiguous-prefix
    watermark, and a forwarder task per tree child racing it."""

    __slots__ = ("key", "total", "relay", "chunks", "contig", "event",
                 "pending", "bytes_forwarded", "forwarders", "watchdog")

    def __init__(self, key: str, total: int, relay: dict):
        import asyncio

        self.key = key
        self.total = total
        self.relay = relay
        self.chunks: dict[int, bytes] = {}
        self.contig = 0
        self.event = asyncio.Event()
        self.pending = len(relay.get("children") or [])
        self.bytes_forwarded = 0
        self.forwarders: list = []
        self.watchdog = None

    def start(self, cw, table: RelayTable) -> None:
        import asyncio

        for child in self.relay.get("children") or []:
            self.forwarders.append(
                asyncio.ensure_future(_relay_forward(cw, table, self, child))
            )
        self.watchdog = asyncio.ensure_future(_relay_watchdog(table, self))


async def _relay_forward(cw, table: RelayTable, st: _RelaySession, child: dict) -> None:
    """Forward every chunk of ``st`` to ONE tree child as it becomes
    contiguous. A dead child is swallowed on purpose: the ROOT's per-rank
    ack round is what detects the orphaned subtree and re-delivers it
    directly (flat fallback) — a relay has no policy of its own."""
    try:
        client = cw._owner_client(tuple(child["addr"]))
        sub = child.get("children") or []
        relay = {"rank": child["rank"], "children": sub} if sub else None
        for idx in range(st.total):
            while st.contig <= idx:
                st.event.clear()
                await st.event.wait()
            data = st.chunks[idx]
            payload = {"key": st.key, "idx": idx, "total": st.total, "data": data}
            if relay is not None:
                payload["relay"] = relay
            await _gate_egress(len(data))
            await client.apush("p2p_data", payload)
            st.bytes_forwarded += len(data)
            COLL.relay_bytes += len(data)
        COLL.relay_forwards += 1
    except Exception:
        pass
    finally:
        st.pending -= 1
        if st.pending <= 0:
            _relay_finish(table, st)


async def _relay_watchdog(table: RelayTable, st: _RelaySession) -> None:
    """A relay whose payload never completes (root died mid-push) must not
    park its forwarders and chunks forever."""
    import asyncio

    await asyncio.sleep(_INBOX_SWEEP_AGE_S)
    for t in st.forwarders:
        if not t.done():
            t.cancel()
    _relay_finish(table, st)


def _relay_finish(table: RelayTable, st: _RelaySession) -> None:
    if table._sessions.get(st.key) is not st:
        return  # already recorded (forwarder finallys race the watchdog)
    if st.watchdog is not None and not st.watchdog.done():
        st.watchdog.cancel()
    try:
        from ray_tpu_torch._private import flight_recorder

        parts = st.key.split("/", 2)  # collbcast/<group>/<tag>
        group = parts[1] if len(parts) == 3 else ""
        tag = parts[2] if len(parts) == 3 else st.key
        flight_recorder.record(
            "coll_relay",
            f"{tag[:12]}:{group}:{st.relay.get('rank')}:"
            f"{len(st.relay.get('children') or [])}:{st.bytes_forwarded}",
        )
    except Exception:
        pass
    table.finish(st.key)


class ChunkStreams:
    """Landing pads for tree-REDUCE partial streams (``collred/`` keys).
    Unlike :class:`P2PInbox`, chunks are consumed ONE AT A TIME by the
    member combining them into its own slice (cut-through combine at every
    relay hop) — nothing ever reassembles into a full payload. Combiners
    run on executor threads while deposits land on the IO loop, so state
    sits behind a lock with per-key events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chunks: dict[str, dict[int, bytes]] = {}
        self._events: dict[str, threading.Event] = {}
        self._ts: dict[str, float] = {}
        self._deposits = 0

    @any_thread
    def deposit(self, key: str, idx: int, data: bytes) -> None:
        with self._lock:
            self._chunks.setdefault(key, {})[idx] = data
            self._ts[key] = time.monotonic()
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = threading.Event()
            self._deposits += 1
            sweep = self._deposits & 255 == 0
        ev.set()
        if sweep:
            self.sweep()

    @blocking
    def wait_chunk(self, key: str, idx: int, deadline: float) -> bytes | None:
        """Pop chunk ``idx`` of stream ``key`` (each chunk is consumed
        exactly once), or None once ``deadline`` passes."""
        while True:
            with self._lock:
                ev = self._events.get(key)
                if ev is None:
                    ev = self._events[key] = threading.Event()
                ev.clear()  # before the check: a deposit between check and
                # wait must leave the event set
                d = self._chunks.get(key)
                if d is not None and idx in d:
                    return d.pop(idx)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            ev.wait(min(0.05, remaining))

    @any_thread
    def purge(self, key: str) -> None:
        with self._lock:
            self._chunks.pop(key, None)
            self._events.pop(key, None)
            self._ts.pop(key, None)

    @any_thread
    def sweep(self, max_age_s: float = _INBOX_SWEEP_AGE_S) -> int:
        """Age out streams nobody is combining (a reduce that raised on
        this member leaves its children's later chunks behind)."""
        cutoff = time.monotonic() - max_age_s
        with self._lock:
            stale = [k for k, ts in self._ts.items() if ts < cutoff]
            for k in stale:
                self._chunks.pop(k, None)
                self._events.pop(k, None)
                del self._ts[k]
            return len(stale)

    def stats(self) -> dict:
        with self._lock:
            return {
                "streams": len(self._chunks),
                "chunks": sum(len(d) for d in self._chunks.values()),
            }


# ---------------------------------------------------------------------------
# Group broadcast (ONE group op fanning a payload to every member)
# ---------------------------------------------------------------------------

# Per-member budget for the delivery acknowledgement round trip. The ack is
# what turns the fire-and-forget chunk frames into a delivery receipt: it
# rides the same FIFO connection as the data, so by the time the member
# answers, its inbox either has the payload or never will.
_BCAST_ACK_S = 10.0


class _CollStats:
    """Plain-int hot-path counters for the group-collective plane, folded
    into ``ray_tpu_collective_*`` instruments by self_metrics at flush time
    (same pattern as DEVOBJ_STATS — no instrument lock on the send path)."""

    __slots__ = (
        "bcast_sends",        # group broadcasts fanned out by this process
        "bcast_send_bytes",   # serialized payload bytes × delivered ranks
        "bcast_recvs",        # descriptor resolves served from a broadcast
        "bcast_fallbacks",    # per-rank deliveries that fell back to the GCS mailbox
        "bcast_failed_ranks", # ranks a broadcast could not deliver to
        "timeouts",           # typed collective timeouts raised here
        "tree_sends",         # broadcasts that rode the binomial relay tree
        "bcast_retries",      # ranks re-delivered directly after a relay failure
        "root_egress_bytes",  # payload bytes THIS process pushed as broadcast root
        "relay_forwards",     # relay legs completed here (all chunks to one child)
        "relay_bytes",        # payload bytes forwarded mid-tree by this process
        "reduce_sends",       # tree-reduce participations by this process
        "reduce_bytes",       # partial-combine bytes pushed up the tree
        "allreduces",         # allreduce participations (reduce + down-broadcast)
        "reducescatters",     # reduce-scatter participations (reduce + shard fan-out)
        "scatter_bytes",      # serialized shard bytes the root pushed to members
        "host_sync_fallbacks",  # group members that resolved a broadcast payload
                                # via the pull path (off the fast path: the
                                # elastic-roster degradation signal)
        "member_changes",     # roster epoch advances published by this process
    )

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        """Every counter's current value."""
        return {name: getattr(self, name) for name in self.__slots__}


COLL = _CollStats()


def bcast_key(group_name: str, tag: str) -> str:
    """Inbox key of a group-broadcast payload. Deterministic from (group,
    tag) and deliberately RANK-FREE: inboxes are per-process, so every
    member gets the same key — which is what lets the fan-out encode each
    chunk frame once and write identical bytes to every connection.
    Device-object broadcasts use the object id as the tag, so one broadcast
    per object id (the inbox tombstones a repeated key as a duplicate)."""
    return f"collbcast/{group_name}/{tag}"


def member_addr_key(group_name: str, rank: int) -> str:
    return f"collective/{group_name}/addr/{rank}"


def register_member_addr(gcs, group_name: str, rank: int, addr) -> None:
    """Publish this member's core-worker RPC address so a group broadcast
    can push payload frames straight at its inbox (no GCS mailbox on the
    fan-out path). Best-effort: a member without a row just gets the
    mailbox fallback."""
    import json

    try:
        gcs.call(
            "kv_put",
            {"key": member_addr_key(group_name, rank), "value": json.dumps(list(addr)).encode()},
        )
    except Exception:
        pass


def unregister_member_addr(gcs, group_name: str, rank: int) -> None:
    try:
        gcs.call("kv_del", {"key": member_addr_key(group_name, rank)})
    except Exception:
        pass


@blocking
def fetch_member_addrs(gcs, group_name: str, world_size: int, ranks=None) -> dict:
    """{rank: (host, port)} for every member that registered an address.
    Callers key their cache on the ROSTER EPOCH (``fetch_roster_epoch``)
    and drop it on any roster bump — membership is elastic, and a member
    that re-registered at the same coordinator epoch has a NEW address
    under the same rank row.

    ``ranks`` (optional) restricts the lookup to a roster snapshot's
    member set; default is ``range(world_size)`` (static-world callers).
    The lookups are batched CONCURRENTLY on the IO loop
    (the serial per-rank round scaled the fetch O(K) in GCS RTTs), and a
    GCS transport error PROPAGATES: a partitioned GCS must surface as a
    failure the caller can see, not read as "nobody registered" — which
    silently degraded every rank to the mailbox fallback. Only a per-row
    decode problem skips that one rank (it keeps the fallback path)."""
    import asyncio
    import json

    from ray_tpu_torch._private.rpc import EventLoopThread

    ranks = list(ranks) if ranks is not None else list(range(world_size))
    keys = [member_addr_key(group_name, rank) for rank in ranks]

    async def _fetch_all():
        return await asyncio.gather(*(gcs.acall("kv_get", {"key": k}) for k in keys))

    responses = EventLoopThread.get().run(_fetch_all(), timeout=30.0)
    addrs: dict = {}
    for rank, resp in zip(ranks, responses):
        if not resp.get("found"):
            continue
        try:
            addrs[rank] = tuple(json.loads(bytes(resp["value"]).decode()))
        except Exception:
            continue  # malformed row: that rank keeps the mailbox fallback
    return addrs


# ---------------------------------------------------------------------------
# Epochal roster (elastic membership)
# ---------------------------------------------------------------------------

# The roster makes the per-member address rows AUTHORITATIVE: the member set
# of a group at any moment is `collective/<group>/roster/<epoch>` where
# <epoch> is the value of `collective/<group>/repoch`. Members join / leave /
# re-register by publishing the updated set at epoch+1 and bumping the
# counter; every verb snapshots the roster at send time and builds its
# topology over the CURRENT epoch. Mid-operation death is handled by retry
# (survivors keep their payload, rejoiners are re-pushed at their fresh
# address, the dead rank is left out of the next epoch) — NOT by a fence:
# two members racing an epoch bump can disagree for one verb, which then
# fails typed and the caller's next attempt sees the settled roster.

# Bounded back-window for the stale-row sweep: epochs advance one at a time,
# so sweeping this many predecessors on every bump keeps the KV at O(1) rows
# per group without a scan API.
_ROSTER_SWEEP_WINDOW = 16


def roster_epoch_key(group_name: str) -> str:
    return f"collective/{group_name}/repoch"


def roster_key(group_name: str, epoch: int) -> str:
    return f"collective/{group_name}/roster/{epoch}"


@blocking
def fetch_roster_epoch(gcs, group_name: str) -> int:
    """Latest roster epoch; 0 = no roster published (static-world group).
    The counter row is a fast-path HINT, not the truth: epoch rows are
    claimed put-if-absent (publish_roster), so the row sequence is the
    linearization point and a slow winner's counter write can land late
    (lag below a newer claim, whose sweep may already have deleted the
    hinted row). The frontier is found by scanning the live roster rows
    (one kv_keys prefix call — the GCS serves it atomically); the counter
    only covers the no-rows-but-counter-lingers case."""
    try:
        prefix = f"collective/{group_name}/roster/"
        keys = gcs.call("kv_keys", {"prefix": prefix}).get("keys", [])
        epochs = [int(k[len(prefix):]) for k in keys if k[len(prefix):].isdigit()]
        resp = gcs.call("kv_get", {"key": roster_epoch_key(group_name)})
        hinted = int(bytes(resp["value"]).decode()) if resp.get("found") else 0
        return max(epochs + [hinted])
    except Exception:
        return 0


@blocking
def fetch_roster(gcs, group_name: str) -> dict | None:
    """Snapshot the current roster: ``{"epoch", "ranks", "world_size"}``,
    or None when the group never published one (pre-elastic callers).

    A None here must MEAN no roster — a joiner that misreads a live group
    as roster-less derives a singleton member set and breaks the epoch
    chain (every claim must derive from its predecessor row). So a torn
    read — the frontier row swept by a newer claim between the scan and
    the get — is retried against the new frontier, and None is returned
    only when the scan itself shows no live rows."""
    import json

    prefix = f"collective/{group_name}/roster/"
    for attempt in range(4):
        try:
            keys = gcs.call("kv_keys", {"prefix": prefix}).get("keys", [])
        except Exception:
            return None
        epochs = [int(k[len(prefix):]) for k in keys if k[len(prefix):].isdigit()]
        if not epochs:
            # Live rows only — the counter hint is deliberately NOT
            # consulted: a lingering counter (destroy raced a publish)
            # naming no live row must read as "no roster", not wedge
            # every reader on a phantom epoch.
            return None
        epoch = max(epochs)
        try:
            resp = gcs.call("kv_get", {"key": roster_key(group_name, epoch)})
            if not resp.get("found"):
                continue  # swept mid-read: frontier moved, re-scan
            doc = json.loads(bytes(resp["value"]).decode())
            ranks = sorted(int(r) for r in doc.get("ranks", []))
            return {
                "epoch": epoch,
                "ranks": ranks,
                "world_size": int(doc.get("world_size") or ((max(ranks) + 1) if ranks else 0)),
            }
        except Exception:
            return None
    return None


def _record_member_change(group_name: str, reason: str, rank, epoch: int, nranks: int) -> None:
    try:
        from ray_tpu_torch._private import flight_recorder

        flight_recorder.record(
            "coll_member_change",
            f"{group_name}:{reason}:r{'' if rank is None else rank}:e{epoch}:n{nranks}",
        )
    except Exception:
        pass


@blocking
def publish_roster(gcs, group_name: str, ranks, world_size: int | None = None,
                   reason: str = "advance", rank: int | None = None,
                   base_epoch: int | None = None) -> int | None:
    """CLAIM roster epoch ``base_epoch + 1`` with the given member set,
    bump the counter hint, and sweep the stale predecessor rows (satellite
    of the epoch advance: dead-epoch ``roster/<e>`` rows must not pile up
    in the KV). Returns the claimed epoch, or **None when the claim lost**
    the race.

    The row is written put-if-absent and ONLY at base+1, which makes the
    roster a derivation CHAIN: the winner of epoch e+1 provably derived
    its set from row e (it read row e, and nobody else claimed e+1 in
    between). A rank present in row e can therefore only disappear via an
    explicit leave/evict, never a stale-read overwrite — the lost-update
    hole where a gang joiner's stale read used to erase an already
    verified peer. A None return means ``ranks`` was derived from a row
    that is no longer the frontier; the caller must RE-READ and RE-DERIVE
    (roster_join/roster_leave loop exactly that)."""
    import json

    ranks = sorted(set(int(r) for r in ranks))
    world = int(world_size) if world_size else ((max(ranks) + 1) if ranks else 0)
    if base_epoch is None:
        base_epoch = fetch_roster_epoch(gcs, group_name)
    epoch = int(base_epoch) + 1
    doc = json.dumps({"ranks": ranks, "world_size": world}).encode()
    resp = gcs.call(
        "kv_put",
        {"key": roster_key(group_name, epoch), "value": doc, "overwrite": False},
    )
    if not resp.get("added"):
        return None
    # Counter hint: never drag it BACKWARD below a later winner's write
    # (the frontier scan heals any regression that slips through the
    # read-check window).
    try:
        resp = gcs.call("kv_get", {"key": roster_epoch_key(group_name)})
        hinted = int(bytes(resp["value"]).decode()) if resp.get("found") else 0
    except Exception:
        hinted = 0
    if epoch > hinted:
        gcs.call("kv_put", {"key": roster_epoch_key(group_name), "value": str(epoch).encode()})
    # Hygiene sweep, LAGGED by a full window: rows in (epoch-W, epoch) must
    # stay — deleting an immediate predecessor re-opens its key for a
    # put-if-absent claim, letting a stale joiner "win" on a dead fork
    # below the frontier (its membership would never enter the chain). A
    # claimant would have to be W epochs stale within one read-claim
    # round trip to fork past the lag.
    for old in range(max(1, epoch - 2 * _ROSTER_SWEEP_WINDOW),
                     max(1, epoch - _ROSTER_SWEEP_WINDOW + 1)):
        try:
            gcs.call("kv_del", {"key": roster_key(group_name, old)})
        except Exception:
            pass
    COLL.member_changes += 1
    _record_member_change(group_name, reason, rank, epoch, len(ranks))
    return epoch


@blocking
def roster_join(gcs, group_name: str, rank: int, world_size: int | None = None,
                attempts: int = 24) -> int:
    """Add ``rank`` to the roster (join, or RE-REGISTER when the rank is
    already listed — a respawned member at a new address must still bump
    the epoch so every peer's address cache drops). Each attempt reads the
    frontier row, unions itself in, and claims DIRECTLY on top of the row
    it derived from (publish_roster, put-if-absent at base+1) — a won
    claim therefore provably contains this rank AND every rank of the
    predecessor row, so no verify pass is needed and no racing joiner can
    erase an already returned peer. A lost claim means the frontier moved:
    re-read, re-derive, retry — convergent because one claimant wins every
    epoch (worst case: a K-member gang join takes K rounds)."""
    rank = int(rank)
    epoch = 0
    for attempt in range(attempts):
        cur = fetch_roster(gcs, group_name)
        ranks = set(cur["ranks"]) if cur else set()
        rejoin = rank in ranks
        ranks.add(rank)
        world = max(world_size or 0, (cur["world_size"] if cur else 0), rank + 1)
        # base is the epoch this derivation OBSERVED — never a re-probed
        # frontier (a fresh probe can see a row this read never did, and
        # claiming on top of an unread row drops its members from the
        # chain). A None read observed epoch 0: claim row 1 or lose and
        # re-derive.
        base = cur["epoch"] if cur else 0
        epoch = publish_roster(
            gcs, group_name, ranks, world,
            reason="rejoin" if rejoin else "join", rank=rank, base_epoch=base,
        )
        if epoch is not None:
            return epoch
        time.sleep(0.005 * (attempt + 1))
    import logging

    logging.getLogger(__name__).warning(
        "roster join for group %r rank %s lost every claim attempt "
        "(pathological churn); membership not asserted", group_name, rank,
    )
    return fetch_roster_epoch(gcs, group_name)


@blocking
def roster_leave(gcs, group_name: str, rank: int, reason: str = "leave") -> int | None:
    """Drop ``rank`` from the roster (voluntary leave, or a verb evicting a
    member it could not deliver to — ``reason="death"``) and delete its now
    orphaned address row. No-op (None) when the group has no roster or the
    rank is already gone. Claims on top of the row it derived from
    (publish_roster base+1); a lost claim re-reads and re-derives so a
    racing join is never erased."""
    for attempt in range(12):
        cur = fetch_roster(gcs, group_name)
        if cur is None or int(rank) not in cur["ranks"]:
            return None
        ranks = [r for r in cur["ranks"] if r != int(rank)]
        epoch = publish_roster(
            gcs, group_name, ranks, cur["world_size"], reason=reason,
            rank=int(rank), base_epoch=cur["epoch"],
        )
        if epoch is not None:
            unregister_member_addr(gcs, group_name, int(rank))
            return epoch
        time.sleep(0.005 * (attempt + 1))
    return None


@blocking
def sweep_group_kv(gcs, group_name: str, world_size: int = 0) -> int:
    """Teardown sweep: delete EVERY collective KV row of ``group_name`` —
    the roster-epoch counter, the roster back-window, and all member
    address rows — so a destroyed group leaves the KV at baseline. Returns
    the number of delete calls issued (best-effort; a partitioned GCS
    sweeps on the next destroy)."""
    n = 0
    try:
        cur = fetch_roster(gcs, group_name)
        epoch = fetch_roster_epoch(gcs, group_name)
        world = max(
            world_size, cur["world_size"] if cur else 0,
            (max(cur["ranks"]) + 1) if cur and cur["ranks"] else 0,
        )
        keys = [roster_epoch_key(group_name)]
        keys += [roster_key(group_name, e)
                 for e in range(max(1, epoch - 2 * _ROSTER_SWEEP_WINDOW), epoch + 1)]
        keys += [member_addr_key(group_name, r) for r in range(world)]
        for key in keys:
            try:
                gcs.call("kv_del", {"key": key})
                n += 1
            except Exception:
                pass
    except Exception:
        pass
    return n


@blocking
def group_bcast_send(
    cw,
    gcs,
    group_name: str,
    src_rank: int,
    world_size: int,
    tag: str,
    value,
    member_addrs: dict | None = None,
    timeout: float = 30.0,
    mailbox_fallback: bool = True,
    topology: str = "tree",
    roster: dict | None = None,
) -> dict:
    """Fan ``value`` to every OTHER rank of the group as ONE group
    operation: one serialize, each chunk frame ENCODED ONCE
    (``RpcClient.pack_push_frame`` — the rank-free inbox key is what makes
    the bytes identical), every rank confirmed by a ``p2p_ack`` round trip.
    Ranks without a registered address fall back to the GCS-KV mailbox
    under the same logical tag. Never raises for a dead member: the result
    names it so the caller owns the policy —
    ``{"ok_ranks": [...], "fallback_ranks": [...], "failed": {rank: reason},
    "bytes": payload_bytes, "topology": ..., "root_egress_bytes": ...,
    "retried_ranks": [...], "rejoined_ranks": [...], "evicted_ranks": [...],
    "roster_epoch": ...}``.

    ``roster`` is the elastic-membership snapshot (``fetch_roster``): when
    present, the target set is the CURRENT epoch's member ranks (not
    ``range(world_size)``), a rank that fails its first delivery is
    re-fetched from the address registry and retried once at its fresh
    address (it may have RE-REGISTERED mid-operation — survivors +
    rejoiners, not a frozen world), and ranks that still cannot be reached
    are EVICTED: the roster advances one epoch without them, so the next
    verb builds its topology over the survivors instead of failing forever
    against a corpse. When ``roster=None`` and no member_addrs are passed,
    the snapshot is taken here.

    ``topology="tree"`` (default, ≥2 addressed ranks): the root pushes
    chunk frames only to its BINOMIAL-TREE children, each frame carrying
    the child's relay spec; mid-tree members forward every chunk to their
    own children the moment it lands (cut-through — :class:`RelayTable`),
    so root egress is O(log K) streams instead of K. The per-member
    contract is unchanged: the root still acks EVERY rank directly, and
    any rank whose ack fails (a dead relay orphans its whole subtree) is
    retried DIRECTLY with a flat resend — one dead relay costs one named
    failure plus re-delivered orphans, not K/2 failed members. A rank
    still failing after the direct retry is named with its orphaned
    subtree. ``topology="flat"`` is the flat fan-out (every rank pushed
    from the root), kept for an A/B and as the retry primitive.

    This is the cpu-backend group op behind device_object.broadcast(); on
    the card the same seam would map to an NCCL broadcast (nccl_group.py)."""
    import asyncio

    from ray_tpu_torch._private import serialization
    from ray_tpu_torch._private.rpc import RpcClient

    data = serialization.dumps(value)
    if member_addrs is None:
        if roster is None:
            roster = fetch_roster(gcs, group_name)
        member_addrs = fetch_member_addrs(
            gcs, group_name, world_size,
            ranks=roster["ranks"] if roster else None,
        )
    else:
        member_addrs = dict(member_addrs)
    total = max(1, (len(data) + _DIRECT_CHUNK_BYTES - 1) // _DIRECT_CHUNK_BYTES)
    if roster is not None:
        targets = [r for r in roster["ranks"] if r != src_rank]
    else:
        targets = [r for r in range(world_size) if r != src_rank]
    addressed = [r for r in targets if r in member_addrs]
    use_tree = topology == "tree" and len(addressed) >= 2
    result = {
        "ok_ranks": [], "fallback_ranks": [], "failed": {}, "bytes": len(data),
        "topology": "tree" if use_tree else "flat",
        "root_egress_bytes": 0, "retried_ranks": [], "rejoined_ranks": [],
        "evicted_ranks": [],
        "roster_epoch": roster["epoch"] if roster else 0,
    }
    key = bcast_key(group_name, tag)
    chunks = [
        data[i * _DIRECT_CHUNK_BYTES : (i + 1) * _DIRECT_CHUNK_BYTES]
        for i in range(total)
    ]
    frames = [
        RpcClient.pack_push_frame(
            "p2p_data",
            {"key": key, "idx": i, "total": total, "data": chunks[i]},
        )
        for i in range(total)
    ]

    # Tree positions: [root] + addressed ranks in rank order — every rank
    # appears exactly once, so parent/child is a pure function of the
    # (group, membership) pair. ``subtree`` maps each rank to its
    # descendant ranks for the orphan annotation on failures.
    subtree: dict[int, list[int]] = {}
    root_specs: list[dict] = []
    if use_tree:
        order = [src_rank] + sorted(addressed)

        def _spec(pos: int) -> dict:
            rank = order[pos]
            kids = [_spec(c) for c in _binomial_children(pos, len(order))]
            desc: list[int] = []
            for k in kids:
                desc.append(k["rank"])
                desc.extend(subtree[k["rank"]])
            subtree[rank] = sorted(desc)
            return {"rank": rank, "addr": list(member_addrs[rank]), "children": kids}

        root_specs = [_spec(c) for c in _binomial_children(0, len(order))]
        result["root_children"] = sorted(s["rank"] for s in root_specs)

    # Ack wait scales with the caller's budget (clamped by the server at
    # 30s): a slow-but-healthy member still reassembling a large payload
    # must not be branded a failed rank by a fixed small bound.
    ack_wait = max(_BCAST_ACK_S, min(30.0, timeout))

    async def _push_direct(rank: int):
        client = cw._owner_client(tuple(member_addrs[rank]))
        for i, frame in enumerate(frames):
            await _gate_egress(len(chunks[i]))
            await client.apush_packed("p2p_data", frame)
        result["root_egress_bytes"] += len(data)

    async def _ack(rank: int, wait: float):
        client = cw._owner_client(tuple(member_addrs[rank]))
        resp = await client.acall(
            "p2p_ack", {"key": key, "timeout": wait},
            timeout=wait + 5.0, retries=0,
        )
        if not resp.get("ok"):
            raise RuntimeError("p2p_ack reported the payload never landed")

    async def _deliver(rank: int):
        await _push_direct(rank)
        await _ack(rank, ack_wait)

    async def _deliver_tree_child(spec: dict):
        client = cw._owner_client(tuple(spec["addr"]))
        if spec["children"]:
            relay = {"rank": spec["rank"], "children": spec["children"]}
            # Relay spec rides EVERY chunk frame: whichever lands first
            # opens the session, so loss/reorder of any one frame cannot
            # stall the whole subtree.
            for i in range(total):
                await _gate_egress(len(chunks[i]))
                await client.apush(
                    "p2p_data",
                    {"key": key, "idx": i, "total": total,
                     "data": chunks[i], "relay": relay},
                )
        else:
            for i, frame in enumerate(frames):
                await _gate_egress(len(chunks[i]))
                await client.apush_packed("p2p_data", frame)
        result["root_egress_bytes"] += len(data)
        await _ack(spec["rank"], ack_wait)

    async def _fan_out():
        tasks: dict = {}
        if use_tree:
            for spec in root_specs:
                tasks[spec["rank"]] = asyncio.ensure_future(
                    asyncio.wait_for(_deliver_tree_child(spec), timeout)
                )
            for rank in addressed:
                if rank not in tasks:  # delivered by a relay: ack only
                    tasks[rank] = asyncio.ensure_future(
                        asyncio.wait_for(_ack(rank, ack_wait), timeout)
                    )
        else:
            for rank in addressed:
                tasks[rank] = asyncio.ensure_future(
                    asyncio.wait_for(_deliver(rank), timeout)
                )
        if tasks:
            await asyncio.wait(tasks.values())
        outcomes = {rank: t.exception() for rank, t in tasks.items()}
        if use_tree:
            round1 = [r for r, e in outcomes.items() if e is not None]
            if round1:
                # Orphan recovery: a failed ack means the rank is dead OR a
                # relay above it died — re-deliver DIRECTLY (flat resend;
                # duplicate chunks overwrite partials in the inbox) so one
                # dead relay doesn't fail its whole healthy subtree.
                retry_ack = max(5.0, min(ack_wait, 10.0))

                async def _retry(rank: int):
                    await _push_direct(rank)
                    await _ack(rank, retry_ack)

                rtasks = {
                    r: asyncio.ensure_future(
                        asyncio.wait_for(_retry(r), retry_ack + 10.0)
                    )
                    for r in round1
                }
                await asyncio.wait(rtasks.values())
                for r, t in rtasks.items():
                    if t.exception() is None:
                        outcomes[r] = None
                        result["retried_ranks"].append(r)
                        COLL.bcast_retries += 1
        return outcomes

    # Outer bound is a backstop over the per-member wait_for; each member's
    # delivery is already clamped to ``timeout`` individually (plus the
    # bounded retry round in tree mode).
    outer = timeout + 15.0 + (20.0 if use_tree else 0.0)
    outcomes = cw._io.run(_fan_out(), timeout=outer) if targets else {}

    # Elastic round: a rank that failed delivery may have RE-REGISTERED at
    # a fresh address mid-operation (its replacement actor joined under the
    # same rank). Re-read its address row — bypassing every cache — and
    # retry once directly. This is the "survivors + rejoiners" half of the
    # epochal contract; the eviction below is the other half.
    if roster is not None:
        lost = [r for r in addressed if outcomes.get(r) is not None]
        if lost:
            try:
                fresh = fetch_member_addrs(gcs, group_name, world_size, ranks=lost)
            except Exception:
                fresh = {}
            rejoiners = [
                r for r in lost if fresh.get(r) and fresh[r] != member_addrs.get(r)
            ]
            if rejoiners:
                member_addrs.update({r: fresh[r] for r in rejoiners})
                rejoin_ack = max(5.0, min(ack_wait, 10.0))

                async def _rejoin_round():
                    tasks = {
                        r: asyncio.ensure_future(
                            asyncio.wait_for(_deliver(r), rejoin_ack + 10.0)
                        )
                        for r in rejoiners
                    }
                    await asyncio.wait(tasks.values())
                    return {r: t.exception() for r, t in tasks.items()}

                try:
                    redone = cw._io.run(_rejoin_round(), timeout=rejoin_ack + 20.0)
                except Exception:
                    redone = {}
                for r, exc in redone.items():
                    if exc is None:
                        outcomes[r] = None
                        result["rejoined_ranks"].append(r)

    for rank in targets:
        if rank not in member_addrs:
            # Never registered an address (old-style member): the GCS
            # mailbox is its normal path, not a failure — but ONLY for
            # callers whose receivers actually poll it
            # (bcast_recv_payload). The device-object descriptor path
            # resolves from the direct inbox alone, so there a mailbox
            # drop would be dead weight in the KV and a false "delivered"
            # — it reports the rank failed instead.
            if not mailbox_fallback:
                result["failed"][rank] = "no registered member address"
                COLL.bcast_failed_ranks += 1
                continue
            try:
                mailbox_send(gcs, group_name, src_rank, rank, f"bcast/{tag}", value)
                _schedule_bcast_janitor(cw, gcs, mailbox_key(group_name, src_rank, rank, f"bcast/{tag}"))
                result["fallback_ranks"].append(rank)
                COLL.bcast_fallbacks += 1
            except Exception as e:
                result["failed"][rank] = repr(e)
                COLL.bcast_failed_ranks += 1
            continue
        exc = outcomes.get(rank)
        if exc is None:
            result["ok_ranks"].append(rank)
        else:
            # A REGISTERED member we could not deliver to is dead, severed,
            # or wedged — a GCS mailbox drop would "succeed" against a
            # corpse (the KV is alive either way), so the honest outcome is
            # a named failure the caller can act on.
            reason = repr(exc)
            orphans = subtree.get(rank) or []
            if orphans:
                recovered = sorted(set(orphans) & set(result["retried_ranks"]))
                reason += (
                    f" [tree relay: orphaned subtree ranks {orphans}"
                    + (f"; re-delivered directly: {recovered}" if recovered else "")
                    + "]"
                )
            result["failed"][rank] = reason
            COLL.bcast_failed_ranks += 1
    result["retried_ranks"].sort()
    if roster is not None and result["failed"]:
        # Eviction: advance the epoch without the members this op could not
        # reach — the NEXT verb topologizes over the survivors instead of
        # failing forever against a corpse. A live member evicted by a
        # transient stall is not stranded: its next re-register (or the
        # sync loop's respawn) rejoins at epoch+1. One batch publish, not
        # one bump per corpse.
        dead = sorted(set(result["failed"]) & set(roster["ranks"]))
        if dead:
            try:
                # Claim on top of the row the survivor set derives from;
                # a lost claim (concurrent join/leave moved the frontier)
                # re-reads and re-derives so a racing rejoiner is never
                # erased by this eviction.
                cur = roster
                for attempt in range(6):
                    survivors = [r for r in cur["ranks"] if r not in set(dead)]
                    if set(survivors) == set(cur["ranks"]):
                        break  # every dead rank already evicted elsewhere
                    ep = publish_roster(
                        gcs, group_name, survivors, cur["world_size"],
                        reason="death", rank=dead[0], base_epoch=cur["epoch"],
                    )
                    if ep is not None:
                        break
                    time.sleep(0.005 * (attempt + 1))
                    cur = fetch_roster(gcs, group_name)
                    if cur is None:
                        break
                for r in dead:
                    unregister_member_addr(gcs, group_name, r)
                result["evicted_ranks"] = dead
            except Exception:
                pass  # GCS hiccup: the next verb's snapshot retries
    COLL.bcast_sends += 1
    if use_tree:
        COLL.tree_sends += 1
    COLL.root_egress_bytes += result["root_egress_bytes"]
    COLL.bcast_send_bytes += len(data) * (
        len(result["ok_ranks"]) + len(result["fallback_ranks"])
    )
    return result


async def sweep_stale_group_rows(gcs, group_name: str) -> int:
    """GCS hygiene for one group: delete dead-epoch ``roster/<e>`` and
    coordinator ``coord/<e>`` rows behind the current epochs, plus orphaned
    ``addr/<rank>`` rows of ranks no longer in the roster (a SIGKILLed
    member never unregisters itself). Runs on the IO loop; called on every
    roster advance (inline, via publish_roster's back-window) and from the
    mailbox janitors. Best-effort: a partitioned GCS sweeps next time."""
    import json

    n = 0
    try:
        resp = await gcs.acall("kv_get", {"key": roster_epoch_key(group_name)})
        epoch = int(bytes(resp["value"]).decode()) if resp.get("found") else 0
        # Lagged like publish_roster's inline sweep: rows within a window
        # of the frontier must stay, or their freed keys become claimable
        # forks for a stale put-if-absent join.
        for old in range(max(1, epoch - 2 * _ROSTER_SWEEP_WINDOW),
                         max(1, epoch - _ROSTER_SWEEP_WINDOW + 1)):
            await gcs.acall("kv_del", {"key": roster_key(group_name, old)})
            n += 1
        # nccl_group's TCPStore rendezvous epochs (a separate counter:
        # one per world re-formation, not per membership change).
        resp = await gcs.acall("kv_get", {"key": f"collective/{group_name}/epoch"})
        cepoch = int(bytes(resp["value"]).decode()) if resp.get("found") else 0
        for old in range(max(1, cepoch - _ROSTER_SWEEP_WINDOW), cepoch):
            await gcs.acall("kv_del", {"key": f"collective/{group_name}/coord/{old}"})
            n += 1
        if epoch:
            resp = await gcs.acall("kv_get", {"key": roster_key(group_name, epoch)})
            if resp.get("found"):
                doc = json.loads(bytes(resp["value"]).decode())
                ranks = set(int(r) for r in doc.get("ranks", []))
                world = int(doc.get("world_size") or 0)
                for r in range(world):
                    if r not in ranks:
                        await gcs.acall(
                            "kv_del", {"key": member_addr_key(group_name, r)}
                        )
                        n += 1
    except Exception:
        pass
    return n


def _schedule_bcast_janitor(cw, gcs, key: str, delay_s: float = 180.0) -> None:
    """A mailbox-fallback payload a dead/slow member never claims must not
    sit in the GCS KV forever. The sweep also runs the
    per-group stale-row janitor: a group leaning on the mailbox fallback is
    exactly the kind whose dead-epoch roster/coord/addr rows accumulate."""
    # mailbox_key layout: collective/<group>/p2p/<src>-><dst>/<tag>
    parts = key.split("/")
    group_name = parts[1] if len(parts) > 2 and parts[0] == "collective" else None

    async def _sweep():
        import asyncio

        await asyncio.sleep(delay_s)
        try:
            await gcs.acall("kv_del", {"key": key})
        except Exception:
            pass
        if group_name:
            await sweep_stale_group_rows(gcs, group_name)

    try:
        cw._io.spawn(_sweep())
    except Exception:
        pass


@blocking
def group_bcast_recv(cw, gcs, group_name: str, src_rank: int, my_rank: int, tag: str, timeout: float = 120.0, abort_check=None):
    """Member-side receive of a group broadcast: watch BOTH landing zones —
    the direct mailbox (steady state: the payload is already here, or
    arrives whenever the sender's chunk pushes finish) and the GCS mailbox
    (the sender's fallback for members it could not dial) — until the
    deadline; typed timeout naming group/rank/tag otherwise. Interleaved
    on purpose: a receiver that blocks before the sender starts (normal
    collective ordering) must catch a direct delivery landing at ANY point
    in the window, not just the first second. ``abort_check`` (optional)
    turns a concurrent ``destroy_collective_group`` into an IMMEDIATE typed
    CollectiveError instead of a full-timeout park — a destroyed group's
    payload is never coming."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.exceptions import CollectiveError, CollectiveTimeoutError

    deadline = time.monotonic() + timeout
    key = bcast_key(group_name, tag)
    gcs_key = mailbox_key(group_name, src_rank, my_rank, f"bcast/{tag}")
    while True:
        if abort_check is not None and abort_check():
            raise CollectiveError(
                f"group {group_name!r} was destroyed while rank {my_rank} "
                f"waited for broadcast tag {tag!r} from rank {src_rank}"
            )
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            COLL.timeouts += 1
            raise CollectiveTimeoutError(
                f"group broadcast recv on {group_name!r} tag {tag!r}: nothing "
                f"from rank {src_rank} within {timeout}s (direct mailbox and "
                "GCS fallback both empty)",
                group=group_name, ranks=[src_rank], tag=tag,
            )
        data = direct_recv(cw, key, timeout=min(0.25, remaining))
        if data is not None:
            COLL.bcast_recvs += 1
            return serialization.loads(data)
        try:
            resp = gcs.call("kv_get", {"key": gcs_key})
            if resp.get("found"):
                gcs.call("kv_del", {"key": gcs_key})
                COLL.bcast_recvs += 1
                return serialization.loads(resp["value"])
        except Exception:
            pass  # GCS hiccup: the direct-path wait keeps the clock


@blocking
def direct_recv(cw, key: str, timeout: float, abort_check=None) -> bytes | None:
    """Wait for a direct-mailbox payload under ``key``. Returns the bytes,
    or None when ``timeout`` expires (caller falls back to the pull path)
    or ``abort_check()`` goes true (teardown / poison: caller surfaces its
    own typed error). Steady state returns without sleeping — for channel
    payloads the deposit itself is what woke the reader, so the bytes are
    already here by the time the consumer resolves the slot."""
    inbox = cw.p2p_inbox
    deadline = time.monotonic() + timeout
    ev = inbox._waiter(key)
    try:
        while True:
            data = inbox.take(key)
            if data is not None:
                return data
            if abort_check is not None and abort_check():
                return None
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            ev.wait(min(0.05, remaining))
            ev.clear()
    finally:
        inbox._drop_waiter(key)


# ---------------------------------------------------------------------------
# Group reduce / allreduce (chunk-wise combine at every relay hop)
# ---------------------------------------------------------------------------


def reduce_key(group_name: str, tag: str, src_rank: int) -> str:
    """Stream key for ONE member's partial chunks flowing up the reduce
    tree. Rank-scoped (unlike :func:`bcast_key`): a parent combining k
    children must tell their streams apart. The ``collred/`` prefix routes
    these frames into :class:`ChunkStreams` instead of the inbox."""
    return f"collred/{group_name}/{tag}/{src_rank}"


async def _push_reduce_chunk(client, key: str, idx: int, total: int, data: bytes):
    await _gate_egress(len(data))
    await client.apush(
        "p2p_data", {"key": key, "idx": idx, "total": total, "data": data}
    )


@blocking
def group_reduce_send(
    cw,
    gcs,
    group_name: str,
    my_rank: int,
    world_size: int,
    tag: str,
    value,
    op: ReduceOp = ReduceOp.SUM,
    dst_rank: int = 0,
    member_addrs: dict | None = None,
    timeout: float = 60.0,
    roster: dict | None = None,
):
    """One member's share of a TREE reduce toward ``dst_rank``: wait per
    chunk index for each tree child's combined partial, merge it into this
    rank's own slice ELEMENTWISE, and push the result to the parent the
    moment it's ready (cut-through combine — a chunk flows up while later
    chunks are still arriving below). Every rank of the group must call
    this with the same (tag, op, dst_rank); chunks travel as dense
    ``dtype`` bytes (NOT serialized objects) so relay hops can combine
    without a deserialize round trip.

    Returns the reduced ``np.ndarray`` on ``dst_rank``, None elsewhere.
    MEAN sums up the tree and divides ONCE at the root (matching
    ``np.stack(...).mean(axis=0)`` bit-for-bit on exact inputs). Requires
    every member to have a registered address — callers (cpu_group) fall
    back to the GCS ring otherwise. A silent child raises a typed
    CollectiveTimeoutError NAMING it; a shape/dtype disagreement surfaces
    as a CollectiveError naming both ranks.

    ``roster`` (elastic membership): the tree spans the CURRENT epoch's
    member ranks, not ``range(world_size)`` — every participant must
    snapshot the same epoch (they rendezvous through the per-rank stream
    keys, so a disagreement surfaces as the typed child timeout and the
    caller retries against the settled roster; a partial reduce is poison,
    so there is no in-op rejoin round here, unlike broadcast)."""
    import numpy as np

    from ray_tpu_torch.exceptions import CollectiveError, CollectiveTimeoutError

    member_ranks = sorted(roster["ranks"]) if roster else list(range(world_size))
    if roster is not None and (my_rank not in member_ranks or dst_rank not in member_ranks):
        raise CollectiveError(
            f"tree reduce on group {group_name!r}: rank {my_rank} -> "
            f"{dst_rank} not in roster epoch {roster['epoch']} "
            f"(members {member_ranks}) — re-register before reducing"
        )
    if member_addrs is None:
        member_addrs = fetch_member_addrs(gcs, group_name, world_size, ranks=member_ranks)
    missing = [r for r in member_ranks if r != my_rank and r not in member_addrs]
    if missing:
        raise CollectiveError(
            f"tree reduce on group {group_name!r} needs a registered address "
            f"for every member; missing ranks {missing}"
        )
    arr = host_array(value)
    combine = {
        ReduceOp.SUM: np.add,
        ReduceOp.PRODUCT: np.multiply,
        ReduceOp.MIN: np.minimum,
        ReduceOp.MAX: np.maximum,
        ReduceOp.MEAN: np.add,  # summed at every hop; the root divides once
    }[op]
    # Same deterministic shape as the broadcast tree, rooted at dst_rank —
    # a pure function of the (group, roster-epoch) pair, so every member's
    # snapshot of the same epoch yields the same tree.
    order = [dst_rank] + sorted(r for r in member_ranks if r != dst_rank)
    pos = order.index(my_rank)
    kid_ranks = [order[c] for c in _binomial_children(pos, len(order))]
    parent_client = None
    if pos:
        parent_rank = order[pos - (1 << (pos.bit_length() - 1))]
        parent_client = cw._owner_client(tuple(member_addrs[parent_rank]))
    data = arr.tobytes()
    # Chunk on element boundaries so every chunk is a dense dtype slice.
    itemsize = max(1, arr.dtype.itemsize)
    chunk_bytes = max(itemsize, (_DIRECT_CHUNK_BYTES // itemsize) * itemsize)
    total = max(1, (len(data) + chunk_bytes - 1) // chunk_bytes)
    deadline = time.monotonic() + timeout
    streams = cw.p2p_streams
    up_key = reduce_key(group_name, tag, my_rank)
    out_parts: list = []
    try:
        for idx in range(total):
            own = np.frombuffer(
                data[idx * chunk_bytes : (idx + 1) * chunk_bytes], dtype=arr.dtype
            )
            acc = own
            for kr in kid_ranks:
                chunk = streams.wait_chunk(reduce_key(group_name, tag, kr), idx, deadline)
                if chunk is None:
                    COLL.timeouts += 1
                    raise CollectiveTimeoutError(
                        f"tree reduce on group {group_name!r} tag {tag!r} "
                        f"(rank {my_rank}): no chunk {idx}/{total} from child "
                        f"rank {kr} within {timeout}s",
                        group=group_name, ranks=[kr], tag=tag,
                    )
                if len(chunk) != own.nbytes:
                    raise CollectiveError(
                        f"tree reduce on group {group_name!r} tag {tag!r}: "
                        f"chunk {idx} from rank {kr} is {len(chunk)} bytes, "
                        f"rank {my_rank} expects {own.nbytes} — members "
                        "disagree on shape/dtype"
                    )
                acc = combine(acc, np.frombuffer(chunk, dtype=arr.dtype))
            if parent_client is None:
                out_parts.append(acc)
            else:
                payload = acc.tobytes()
                cw._io.run(
                    _push_reduce_chunk(parent_client, up_key, idx, total, payload),
                    timeout=30.0,
                )
                COLL.reduce_bytes += len(payload)
    finally:
        for kr in kid_ranks:
            streams.purge(reduce_key(group_name, tag, kr))
    COLL.reduce_sends += 1
    if parent_client is not None:
        return None
    out = np.concatenate(out_parts) if len(out_parts) > 1 else out_parts[0]
    out = np.array(out).reshape(arr.shape)
    if op is ReduceOp.MEAN:
        out = out / len(order)
    return out


@blocking
def group_allreduce(
    cw,
    gcs,
    group_name: str,
    my_rank: int,
    world_size: int,
    tag: str,
    value,
    op: ReduceOp = ReduceOp.SUM,
    member_addrs: dict | None = None,
    timeout: float = 60.0,
    finalize=None,
    roster: dict | None = None,
):
    """Tree allreduce: reduce up to the root (lowest roster rank; rank 0 in
    a static world), then tree-broadcast the combined result back down —
    every rank returns the same reduced value after 2·depth hops instead of
    a K-wide ring epoch. ``finalize`` (optional) runs ON THE ROOT before
    the down-broadcast (e.g. back to a tensor on its device), so placement is
    decided once and every rank receives the finalized payload — placement
    parity with ``broadcast``. Raises CollectiveBroadcastError if the
    down-broadcast misses a rank (an allreduce is all-or-nothing: a member
    without the result would silently diverge). ``roster`` restricts the
    whole op to the current epoch's member set."""
    from ray_tpu_torch.exceptions import CollectiveBroadcastError

    root = min(roster["ranks"]) if roster and roster["ranks"] else 0
    red = group_reduce_send(
        cw, gcs, group_name, my_rank, world_size, tag, value,
        op=op, dst_rank=root, member_addrs=member_addrs, timeout=timeout,
        roster=roster,
    )
    COLL.allreduces += 1
    down_tag = f"allred/{tag}"
    if my_rank == root:
        out = finalize(red) if finalize is not None else red
        res = group_bcast_send(
            cw, gcs, group_name, root, world_size, down_tag, out,
            member_addrs=member_addrs, timeout=timeout, mailbox_fallback=False,
            roster=roster,
        )
        if res["failed"]:
            raise CollectiveBroadcastError(
                f"allreduce down-broadcast on group {group_name!r} failed for "
                f"ranks {sorted(res['failed'])}",
                group=group_name, failed=res["failed"], info=res,
            )
        return out
    return group_bcast_recv(cw, gcs, group_name, root, my_rank, down_tag, timeout)


def scatter_key(group_name: str, tag: str, dst_rank: str | int) -> str:
    """Inbox key of ONE member's reduce-scatter shard. Rank-scoped like
    :func:`reduce_key` (every member gets a DIFFERENT shard, so there is no
    shared-frame encoding to exploit, unlike broadcast)."""
    return f"collscat/{group_name}/{tag}/{dst_rank}"


@blocking
def group_reducescatter(
    cw,
    gcs,
    group_name: str,
    my_rank: int,
    world_size: int,
    tag: str,
    value,
    op: ReduceOp = ReduceOp.SUM,
    member_addrs: dict | None = None,
    timeout: float = 60.0,
    finalize=None,
    roster: dict | None = None,
):
    """Tree reduce-scatter: combine every member's tensor up the binomial
    tree to the root (lowest roster rank), which slices axis 0 into one
    shard per member and pushes each member ITS shard over the direct
    mailbox — each rank moves the full tensor up at most once and receives
    exactly 1/K of the result, vs the GCS ring where every rank posts the
    full tensor to the KV and downloads K of them. Semantics match the ring
    ``reducescatter``: the leading dimension must equal the member count,
    and the rank at sorted-roster position ``i`` returns reduced slice
    ``i``. ``finalize`` (optional) runs per-shard ON THE ROOT before the
    fan-out, so placement is decided once (allreduce's contract). The shard
    frames are fire-and-forget; a lost one surfaces as a typed
    CollectiveTimeoutError on the receiver NAMING the root. ``roster``
    restricts the op to the current epoch's member set."""
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.exceptions import CollectiveError, CollectiveTimeoutError

    member_ranks = sorted(roster["ranks"]) if roster else list(range(world_size))
    k = len(member_ranks)
    shape0 = getattr(value, "shape", (None,))[0] if hasattr(value, "shape") else None
    if shape0 != k:
        raise CollectiveError(
            f"reducescatter on group {group_name!r} needs leading dimension "
            f"== member count {k}, got shape {getattr(value, 'shape', '?')}"
        )
    root = member_ranks[0]
    red = group_reduce_send(
        cw, gcs, group_name, my_rank, world_size, tag, value,
        op=op, dst_rank=root, member_addrs=member_addrs, timeout=timeout,
        roster=roster,
    )
    COLL.reducescatters += 1
    if my_rank != root:
        data = direct_recv(cw, scatter_key(group_name, tag, my_rank), timeout=timeout)
        if data is None:
            COLL.timeouts += 1
            raise CollectiveTimeoutError(
                f"reducescatter on group {group_name!r} tag {tag!r}: rank "
                f"{my_rank} received no shard from root rank {root} within "
                f"{timeout}s",
                group=group_name, ranks=[root], tag=tag,
            )
        return serialization.loads(data)
    if member_addrs is None:
        member_addrs = fetch_member_addrs(gcs, group_name, world_size, ranks=member_ranks)
    shards = [red[pos] for pos in range(k)]
    if finalize is not None:
        shards = [finalize(s) for s in shards]
    for pos, rank in enumerate(member_ranks):
        if rank == root:
            continue
        data = serialization.dumps(shards[pos])
        direct_send(cw, tuple(member_addrs[rank]), scatter_key(group_name, tag, rank), data)
        COLL.scatter_bytes += len(data)
    return shards[0]  # root is position 0: the lowest roster rank
