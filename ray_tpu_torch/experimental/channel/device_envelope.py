"""Device-payload envelopes (``KIND_DEVICE``) — the descriptor channel plane.

From ``ray_tpu/experimental/channel/device_envelope.py``, carrying tensors.

A channel slot is 64 KiB by default and the compiled-graph hot loop moves
msgpack bytes through it; a device-resident tensor does not belong there
(serializing it through the ring is a host copy per hop — on the card a
device-to-host copy per microbatch). Instead the slot carries a compact
``DeviceObjectMeta`` descriptor (~300 B, fits any ring slot) and the
payload moves OUT OF BAND:

- **emit** (producer): register the array as a transient channel payload
  with the process's DeviceObjectManager (this process is the holder; pins
  = number of consumers). On an shm edge the ``KIND_DEVICE`` envelope slot
  is published FIRST with the doorbell suppressed, then the serialized
  payload is eager-pushed at the remote reader's p2p direct mailbox keyed
  ``chdev/<cid>/<seq>`` (one-way frames on the existing worker pipe) and
  the deposit's completion rings the reader's gate — one frame both
  delivers the bytes and wakes the reader, and because the slot was
  already visible when the gate rang, the wakeup can never beat the
  publication. (Publishing in the other order would let the deposit's
  wakeup fire before the slot exists, putting the reader back to sleep
  for up to a full poll cap.) Remote-mode edges go payload-first: the
  envelope's own chunked delivery is the wakeup there.
- **resolve** (consumer): same-process holder → the LIVE array, zero
  copies; remote holder → take the eager payload from the inbox (steady
  state: already there); missed grace window → fall back to the pull
  path (``resolve.resolve_meta``: shared collective group p2p, else host
  fallback), which also surfaces the typed ``DeviceObjectLostError``
  naming the holder when the producing stage is dead. A sticky poison
  envelope (``ActorDiedError`` planted by the compiled DAG's monitor) or
  the loop's stop event aborts the wait immediately.
- **release**: after resolving, the consumer drops its pin on the holder
  (locally, or a one-way ``devobj_release`` frame) — the last pin frees
  the device buffers. Lost release frames are reclaimed when the creating
  loop / DAG tears down (``reclaim_scope``), so no device buffer leaks
  across teardown.

On this CPU testbed the out-of-band wire is the host p2p mailbox — a
correctness stand-in, exactly like the device-object plane's collective
path (see p2p.py): the claim the counters certify is zero payload traffic
through the shm OBJECT STORE and zero host-fallback transfers, and the
seam to swap in a device-to-device hop is ``p2p.direct_send``/``direct_recv``.
"""

from __future__ import annotations

import logging
import time

from ray_tpu_torch._private import flight_recorder, serialization
from ray_tpu_torch._private.concurrency import any_thread, blocking
from ray_tpu_torch.exceptions import DeviceObjectLostError
from ray_tpu_torch.experimental.channel.channel import (
    _OFF_READ,
    KIND_DEVICE,
    PIPELINE_STATS,
    unpack_envelope,
)

logger = logging.getLogger(__name__)

# How long a consumer waits for the eager-pushed payload before falling
# back to the pull path. Steady state never waits (the payload frame is
# pushed right behind the slot publish, and its deposit is what wakes the
# reader); the window only matters when the push frame was lost or the
# producer died mid-hop — and poison / stop aborts it early.
_EAGER_GRACE_S = 5.0


def payload_key(cid: str, seq: int) -> str:
    """Inbox key for the eager payload of channel ``cid``'s slot ``seq``.
    Derivable by both endpoints without widening the descriptor."""
    return f"chdev/{cid}/{seq}"


@blocking
def emit(cw, value, writers, scope: str, hop=None, stop=None, timeout=None):
    """Publish ``value`` (a tensor) as a device descriptor through every
    ``ChannelWriter`` in ``writers`` (they all carry the same iteration's
    result — a stage's output fan-out or one driver-input projection).

    Steady-state wire cost per shm edge is ONE one-way frame: the payload
    push lands right after the slot publish and its deposit rings the
    reader's gate (no separate doorbell), and the holder pin is released by
    RING ADVANCE — once the consumer's read_count shows slot ``seq`` popped
    and a LATER slot popped too, its resolution is over (the SPSC loop pops
    seq+1 only after fully processing seq), so the producer reaps the pin
    locally instead of the consumer paying a release frame."""
    import collections

    from ray_tpu_torch.experimental.device_object.manager import DEVOBJ_STATS

    mgr = cw._device_manager()
    own_addr = tuple(cw.address)
    # Everything fallible happens BEFORE the first slot write: once slots
    # start publishing, a mid-loop failure would leave this iteration
    # half-fanned-out and the caller's error-envelope conversion would
    # desynchronize iteration pairing.
    meta = mgr.create_channel_payload(value, pins=len(writers), scope=scope)
    try:
        env_bytes = serialization.serialize(meta).to_bytes()
        wire = None
        if any(not w.shm or tuple(w.desc["reader_addr"]) != own_addr
               for w in writers):
            wire = serialization.dumps(value)
    except BaseException:
        mgr.free(meta.object_id)
        raise
    for w in writers:
        local = tuple(w.desc["reader_addr"]) == own_addr
        if w.shm:
            seq = w.next_seq()
            w.write(KIND_DEVICE, env_bytes, hop, timeout=timeout, stop=stop,
                    doorbell=local)
            if not local:
                p2p_direct_send(
                    cw, tuple(w.desc["reader_addr"]), payload_key(w.cid, seq), wire
                )
                DEVOBJ_STATS.chan_sends += 1
                flight_recorder.record(
                    "chan_devobj_send", f"{w.cid[:8]}:{seq}:{meta.nbytes}"
                )
            if w.payload_fifo is None:
                w.payload_fifo = collections.deque()
            w.payload_fifo.append((seq, meta.object_id))
            _reap(mgr, w)
        else:
            # Remote-mode (no shared arena): payload first — the envelope's
            # own chunked delivery is the wakeup — and the consumer releases
            # the pin with a frame (no ring header to prove consumption).
            seq = w.next_seq()
            p2p_direct_send(
                cw, tuple(w.desc["reader_addr"]), payload_key(w.cid, seq), wire
            )
            DEVOBJ_STATS.chan_sends += 1
            flight_recorder.record(
                "chan_devobj_send", f"{w.cid[:8]}:{seq}:{meta.nbytes}"
            )
            w.write(KIND_DEVICE, env_bytes, hop, timeout=timeout, stop=stop)
    return meta


def _reap(mgr, writer) -> None:
    """Release pins for every payload whose slot the consumer has provably
    finished with: read_count - 2 is the newest seq whose RESOLUTION is
    guaranteed complete (read_count - 1 may still be mid-resolve)."""
    fifo = writer.payload_fifo
    if not fifo:
        return
    done_until = writer._u64(_OFF_READ) - 2
    while fifo and fifo[0][0] <= done_until:
        _seq, oid = fifo.popleft()
        mgr.release_pin(oid)


def p2p_direct_send(cw, addr, key, data):
    from ray_tpu_torch.util.collective.p2p import direct_send

    direct_send(cw, addr, key, data)


@blocking
def resolve(cw, env_data: bytes, *, cid: str, seq: int, gate=None, stop=None,
            deadline=None, consumer_release: bool = False):
    """Turn a ``KIND_DEVICE`` envelope back into the live value. Raises the
    typed loss/death error on failure (the caller turns it into an error
    envelope or surfaces it to ``get()``). ``consumer_release`` is True
    only for remote-mode (no shared arena) channels — shm consumers never
    pay a release frame; the producer reaps the pin off ring advance."""
    from ray_tpu_torch.experimental.device_object.manager import DEVOBJ_STATS
    from ray_tpu_torch.experimental.device_object.resolve import resolve_meta
    from ray_tpu_torch.util.collective.p2p import direct_recv

    t0 = time.monotonic()
    meta = serialization.deserialize(env_data)
    if tuple(meta.holder_addr) == tuple(cw.address):
        # Same process (stage chained onto itself, or a driver round trip):
        # the live array, zero payload copies. The producer-side ring reap
        # releases the pin.
        value = resolve_meta(cw, meta, deadline)
        if consumer_release:
            release(cw, meta)
        _account(cid, seq, "local", t0)
        return value

    def aborted() -> bool:
        if stop is not None and stop.is_set():
            return True
        return gate is not None and (gate.sticky is not None or gate.closed)

    grace = _EAGER_GRACE_S
    if deadline is not None:
        grace = max(0.0, min(grace, deadline - time.monotonic()))
    data = direct_recv(cw, payload_key(cid, seq), grace, abort_check=aborted)
    if data is not None:
        value = serialization.loads(data)
        if consumer_release:
            release(cw, meta)
        DEVOBJ_STATS.chan_recvs += 1
        _account(cid, seq, "inbox", t0)
        return value
    if aborted():
        # Teardown or poison while waiting: surface the planted typed error
        # (ActorDiedError naming the dead stage) over a generic loss.
        if gate is not None and gate.sticky is not None:
            _kind, err_data, _hop = unpack_envelope(gate.sticky)
            err = serialization.deserialize(err_data)
            if isinstance(err, BaseException):
                raise err
        raise DeviceObjectLostError(meta.object_id, holder=meta.holder_label())
    # Grace expired with the producer possibly alive (lost frame, slow IO
    # loop): the pull path still finds the pinned payload on the holder —
    # and surfaces the typed loss naming the holder when it is dead.
    value = resolve_meta(cw, meta, deadline)
    if consumer_release:
        release(cw, meta)
    _account(cid, seq, "pull", t0)
    return value


def _account(cid: str, seq: int, path: str, t0: float) -> None:
    dt = time.monotonic() - t0
    PIPELINE_STATS.resolve_samples.append(dt)
    flight_recorder.record("chan_devobj_recv", f"{cid[:8]}:{seq}:{path}")


@any_thread
def release(cw, meta) -> None:
    """Drop this consumer's pin on the holder. Local holders release
    synchronously; remote ones get a one-way frame (off the hot path —
    a lost frame is reclaimed at loop/DAG teardown via reclaim_scope)."""
    from ray_tpu_torch.experimental.device_object.manager import active_manager

    if tuple(meta.holder_addr) == tuple(cw.address):
        mgr = active_manager()
        if mgr is not None:
            mgr.release_pin(meta.object_id)
        return
    client = cw._owner_client(tuple(meta.holder_addr))

    async def _push():
        try:
            await client.apush("devobj_release", {"object_id": meta.object_id})
        except Exception:
            pass

    cw._io.spawn(_push())
