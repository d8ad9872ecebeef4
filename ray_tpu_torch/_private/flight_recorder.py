"""Flight recorder — an always-on, crash-surviving ring of runtime events.

Analog of the reference's debug-state dumpers (``ray timeline`` +
the GCS task-event plane + the per-component DebugString() dumps stitched into
``debug_state.txt``): every runtime process keeps a fixed-size ring of typed,
monotonic-stamped events covering the hot paths that logs cannot afford to
narrate — lease grant/reuse/release, task ship/exec/complete/fail, RPC
connect/reset/write-HWM stall, store seal/evict/spill, channel
write/block/poison/close, actor restarts.

The ring lives in an **mmap'd per-process file** under
``<session_dir>/flight/`` rather than process memory: a worker SIGKILLed by
the memory monitor (or the kernel) leaves its final events in the file, so
the postmortem actually works — no signal handler can run under SIGKILL, and a purely in-memory
ring would die with the process.
Every ``record()`` writes straight through the mapping (two ``pack_into``
calls + a dict-free tuple), cheap enough to leave on in production; disable
with ``RAY_TPU_TORCH_FLIGHT_RECORDER=0``.

Collection:

- ``CoreWorker.rpc_debug_dump`` returns the calling process's own ring;
- ``Raylet.rpc_debug_dump`` returns every ring on the node (it scans the
  flight dir, which covers processes that are already dead);
- ``GlobalState.flight_recorder_dump`` (state.py) fans out over alive
  raylets and merges rings cluster-wide ordered by stamp.

Slot format (fixed ``SLOT_SIZE`` bytes): ``<d``monotonic seconds, ``<H``
event-type code, ``<H`` detail length, then the utf-8 detail. The header
carries a (monotonic, wall) anchor pair taken at attach so readers convert
stamps to wall-clock without trusting the dead process's clock discipline.
"""

from __future__ import annotations

import collections
import mmap
import os
import struct
import threading
import time

from ray_tpu_torch._private.concurrency import any_thread

MAGIC = 0x464C5431  # "FLT1"
VERSION = 1
HEADER_SIZE = 256
SLOT_SIZE = 96
_DETAIL_MAX = SLOT_SIZE - 12  # 8 (f64 ts) + 2 (code) + 2 (len)

# Header layout: magic u32, version u32, slots u32, slot_size u32, pid u32,
# pad u32, write_count u64, anchor_mono f64, anchor_wall f64, role 64s,
# ident 64s.
_HDR = struct.Struct("<IIIIIIQdd64s64s")
# Precompiled slot/count structs: record() is the hot path, and a dynamic
# format string would re-parse per call.
_SLOT_HDR = struct.Struct("<dHH")
_COUNT = struct.Struct("<Q")
_COUNT_OFF = 24

# Typed events. Codes are wire format — append only, never renumber.
EVENT_TYPES = (
    "mark",            # 0: free-form marker
    "lease_grant",     # 1
    "lease_reuse",     # 2
    "lease_release",   # 3
    "lease_revoked",   # 4
    "task_ship",       # 5
    "task_exec",       # 6
    "task_done",       # 7
    "task_fail",       # 8
    "rpc_connect",     # 9
    "rpc_reset",       # 10
    "rpc_hwm_stall",   # 11
    "store_seal",      # 12
    "store_evict",     # 13
    "store_spill",     # 14
    "store_restore",   # 15
    "channel_write",   # 16
    "channel_block",   # 17
    "channel_poison",  # 18
    "channel_close",   # 19
    "actor_restart",   # 20
    "worker_death",    # 21
    "fatal_signal",    # 22
    "exit",            # 23
    # Device object plane (experimental/device_object/).
    "devobj_create",   # 24
    "devobj_transfer", # 25
    "devobj_spill",    # 26
    "devobj_restore",  # 27
    "devobj_free",     # 28
    # Transfer plane (pull_manager.py / push_manager.py).
    "transfer_pull",   # 29: pull sealed (detail oid:bytes:sources:frame)
    "transfer_push",   # 30: outbound push committed (detail oid:bytes:frame)
    "transfer_relay",  # 31: cut-through relay began forwarding pre-seal
    "admission_stall", # 32: pull queued on pull_admission_budget_bytes
    "pull_source_demoted",  # 33: pull source errored; ranked last
    # Continuous-batching LLM serving engine (serve/llm/).
    "llm_admit",       # 34: prompt admitted into a decode slot (detail rid:T:hit:slot)
    "llm_preempt",     # 35: sequence preempted for KV blocks (recompute on readmit)
    "llm_prefix_hit",  # 36: admission reused prefix-cache blocks (detail rid:Nblk)
    "llm_evict",       # 37: refs-0 prefix-cache block evicted under pressure
    # Descriptor channel plane (device payloads through channel slots).
    "chan_devobj_send",  # 38: channel payload eager-pushed out of band (detail cid:seq:bytes)
    "chan_devobj_recv",  # 39: descriptor slot resolved to the live value (detail cid:seq:path)
    # Self-healing serving.
    "llm_migrate",     # 40: mid-stream LLM request migrated to another replica (detail deployment:ntok)
    "replica_drain",   # 41: serve replica drain begin/done (detail replica_id:phase)
    # Group collectives on the device-object plane.
    "coll_broadcast",  # 42: holder fanned a device object to a group (detail oid:group:ok/targets:bytes)
    # Relay-tree collectives.
    "coll_relay",      # 43: this member relayed a tree-broadcast payload to its children (detail tag:group:rank:children:bytes)
    "coll_reduce",     # 44: holder fed a device object into a group reduce/allreduce (detail oid:group:mode:rank:replaced)
    # Elastic collective groups.
    "coll_member_change",  # 45: roster epoch advanced — join/rejoin/leave/death/advance (detail group:reason:rank:epoch:nmembers)
    # Control-plane scale hardening.
    "locality_hit",    # 46: placement chose a node already holding the task's reference args (detail task:node)
    "gcs_overload",    # 47: GCS task-event ring dropped oldest entries under fan-in (detail dropped:total)
    # Disaggregated LLM serving.
    "llm_kv_handoff",  # 48: prefill→decode sealed-KV import landed on the decode side (detail oid:blocks:bytes:src->dst; ':failed:' arm on fetch error)
    "llm_prefix_import",  # 49: cluster-prefix-tier KV import (detail oid:blocks:bytes:src->dst; ':error:' arm when the row's payload is gone)
)
_CODE = {name: i for i, name in enumerate(EVENT_TYPES)}


def flight_dir(session_dir: str) -> str:
    """Where this session's rings live. Both attach() and the raylet's
    node-wide scan derive the path from session_dir through this one
    function."""
    return os.path.join(session_dir, "flight")


class FlightRecorder:
    """One per process. ``record()`` is safe from any thread (RLock: a
    signal handler recording mid-record on the same thread must not
    deadlock); everything writes through the mmap so the bytes survive
    SIGKILL."""

    def __init__(self, path: str, slots: int, role: str, ident: str):
        self.path = path
        self.slots = slots
        self.role = role
        self.ident = ident
        self._lock = threading.RLock()
        self._count = 0
        self._anchor_mono = time.monotonic()
        self._anchor_wall = time.time()
        size = HEADER_SIZE + slots * SLOT_SIZE
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._write_header()
        # Hot-path locals (avoid attr lookups per record).
        self._mono = time.monotonic

    def _write_header(self):
        _HDR.pack_into(
            self._mm, 0,
            MAGIC, VERSION, self.slots, SLOT_SIZE, os.getpid(), 0,
            self._count, self._anchor_mono, self._anchor_wall,
            self.role.encode()[:64], self.ident.encode()[:64],
        )

    def set_role(self, role: str):
        with self._lock:
            self.role = role
            self._write_header()

    @any_thread
    def record(self, code: int, detail: str = ""):
        self.record_at(self._mono(), code, detail)

    @any_thread
    def record_at(self, mono: float, code: int, detail: str = ""):
        """Record with an explicit stamp (pre-attach replay keeps the
        original event times this way)."""
        data = detail.encode("utf-8", "replace")[:_DETAIL_MAX] if detail else b""
        mm = self._mm
        try:
            with self._lock:
                off = HEADER_SIZE + (self._count % self.slots) * SLOT_SIZE
                _SLOT_HDR.pack_into(mm, off, mono, code, len(data))
                if data:
                    mm[off + 12 : off + 12 + len(data)] = data
                self._count += 1
                # Publish AFTER the slot is fully written (a crash between
                # the two leaves the previous consistent count).
                _COUNT.pack_into(mm, _COUNT_OFF, self._count)
        except (ValueError, OSError):
            # A racing re-home (shutdown/init cycle) closed this mapping
            # while we held a stale reference: drop the event, never fail
            # the caller's runtime path over telemetry.
            pass

    def dump(self) -> list[dict]:
        try:
            with self._lock:
                return _read_events(
                    self._mm, self.slots, self._count,
                    self._anchor_mono, self._anchor_wall,
                )
        except (ValueError, OSError):
            return []  # mapping closed by a racing re-home

    def meta(self) -> dict:
        return {"pid": os.getpid(), "role": self.role, "ident": self.ident}

    def close(self):
        with self._lock:
            try:
                self._mm.flush()
                self._mm.close()
            except (ValueError, OSError):
                pass


def _read_events(buf, slots: int, count: int, anchor_mono: float, anchor_wall: float) -> list[dict]:
    """Decode the ring oldest-first. ``ts`` is wall-clock reconstructed from
    the writer's (monotonic, wall) anchor so rings from different processes
    merge on a comparable axis."""
    out = []
    start = 0 if count <= slots else count - slots
    for seq in range(start, count):
        off = HEADER_SIZE + (seq % slots) * SLOT_SIZE
        mono, code, dlen = struct.unpack_from("<dHH", buf, off)
        detail = bytes(buf[off + 12 : off + 12 + min(dlen, _DETAIL_MAX)]).decode(
            "utf-8", "replace"
        )
        out.append(
            {
                "seq": seq,
                "mono": mono,
                "ts": anchor_wall + (mono - anchor_mono),
                "type": EVENT_TYPES[code] if code < len(EVENT_TYPES) else f"type_{code}",
                "detail": detail,
            }
        )
    return out


def parse_file(path: str) -> dict | None:
    """Read a flight file written by any process (alive or dead). Returns
    {"pid", "role", "ident", "events": [...]}, or None if the file is not a
    valid ring (truncated header, wrong magic)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < HEADER_SIZE:
        return None
    (magic, _ver, slots, slot_size, pid, _pad, count, anchor_mono,
     anchor_wall, role, ident) = _HDR.unpack_from(data, 0)
    if magic != MAGIC or slot_size != SLOT_SIZE or slots <= 0:
        return None
    if len(data) < HEADER_SIZE + slots * SLOT_SIZE:
        return None
    return {
        "pid": pid,
        "role": role.rstrip(b"\x00").decode("utf-8", "replace"),
        "ident": ident.rstrip(b"\x00").decode("utf-8", "replace"),
        "events": _read_events(data, slots, count, anchor_mono, anchor_wall),
    }


def collect_dir(session_dir: str) -> list[dict]:
    """Parse every ring in the session's flight dir — this is what makes the
    postmortem work: a SIGKILLed worker can't answer an RPC, but its mmap
    file is still here with the final events."""
    d = flight_dir(session_dir)
    out = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for name in names:
        if not name.startswith("flight-"):
            continue
        parsed = parse_file(os.path.join(d, name))
        if parsed is not None:
            out.append(parsed)
    return out


def merge_events(processes: list[dict]) -> list[dict]:
    """Flatten per-process dumps into one stream ordered by stamp. Events
    gain pid/role (and node_id when the collector attached one — pids alone
    collide across nodes/containers) so interleavings stay attributable."""
    merged = []
    for proc in processes:
        pid, role = proc.get("pid"), proc.get("role")
        node_id = proc.get("node_id")
        for ev in proc.get("events", []):
            out = {**ev, "pid": pid, "role": role}
            if node_id is not None:
                out["node_id"] = node_id
            merged.append(out)
    merged.sort(key=lambda e: e["ts"])
    return merged


# ---------------------------------------------------------------------------
# Process-global recorder
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_recorder: FlightRecorder | None = None
# Events recorded before attach() (the GCS boots before the raylet knows the
# session dir) buffer here and replay into the ring at attach.
_pre_attach: collections.deque = collections.deque(maxlen=1024)
_enabled: bool | None = None
_atexit_registered = False


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RAY_TPU_TORCH_FLIGHT_RECORDER", "1") != "0"
    return _enabled


def set_enabled(on: bool):
    """Runtime toggle (used by the overhead A/B bench; normal operation
    leaves the recorder on)."""
    global _enabled
    _enabled = bool(on)


def attach(session_dir: str, role: str, ident: str = "") -> None:
    """Bind this process's ring to a session. First caller wins the file;
    a later attach for the SAME session only refines the role label (the
    head process hosts gcs+raylet+driver), while a NEW session re-homes the
    ring (test suites init/shutdown repeatedly in one process)."""
    global _recorder
    if not enabled():
        return
    from ray_tpu_torch._private.config import get_config

    path = os.path.join(flight_dir(session_dir), f"flight-{os.getpid()}-{role}.bin")
    with _lock:
        if _recorder is not None:
            if os.path.dirname(_recorder.path) == flight_dir(session_dir):
                if role not in _recorder.role:
                    _recorder.set_role(f"{_recorder.role}+{role}")
                return
            _recorder.close()
            _recorder = None
        try:
            rec = FlightRecorder(
                path, max(16, get_config().flight_ring_slots), role, ident
            )
        except OSError:
            return
        while _pre_attach:
            code, detail, mono = _pre_attach.popleft()
            rec.record_at(mono, code, detail)  # keep the original stamps
        _recorder = rec
    global _atexit_registered
    if not _atexit_registered:
        # Once per process: a re-homing attach must not stack registrations,
        # or the final ring ends in N duplicate 'exit' markers and muddies
        # the where-does-the-ring-end postmortem signal.
        _atexit_registered = True
        import atexit

        atexit.register(_at_exit)


def _at_exit():
    rec = _recorder
    if rec is not None:
        try:
            rec.record(_CODE["exit"], "")
            rec._mm.flush()
        except (ValueError, OSError):
            pass


@any_thread
def record(etype: str, detail: str = ""):
    """The one hot-path entry point. Cost when attached: one encode, two
    pack_into, an RLock round trip — leave it on. Never blocks (the RLock
    only guards two pack_into calls), so it is safe from the IO loop, the
    exec thread, and signal handlers alike."""
    if not enabled():
        return
    rec = _recorder
    code = _CODE[etype]
    if rec is None:
        _pre_attach.append((code, detail, time.monotonic()))
        # Re-check: an attach() that published between our None-read and
        # the append already drained the buffer — without this drain the
        # event would sit invisible until (wrongly) replayed into the NEXT
        # session's ring.
        if _recorder is not None:
            _drain_pre_attach()
        return
    rec.record(code, detail)


def _drain_pre_attach():
    with _lock:
        rec = _recorder
        if rec is None:
            return
        while _pre_attach:
            code, detail, mono = _pre_attach.popleft()
            rec.record_at(mono, code, detail)


@any_thread
def dump() -> dict | None:
    """This process's ring as a parse_file()-shaped dict (None when the
    recorder is disabled or unattached)."""
    rec = _recorder
    if rec is None:
        return None
    return {**rec.meta(), "events": rec.dump()}


def install_signal_dump(signums) -> None:
    """Chain a handler that records a fatal_signal event (and flushes the
    mapping) before the previous disposition runs. SIGKILL needs no handler
    — the mmap file already holds everything."""
    import signal as _signal

    for signum in signums:
        prev = _signal.getsignal(signum)

        def _handler(num, frame, _prev=prev):
            try:
                record("fatal_signal", _signal.Signals(num).name)
                rec = _recorder
                if rec is not None:
                    rec._mm.flush()
            except Exception:
                pass
            if callable(_prev):
                _prev(num, frame)
            elif _prev == _signal.SIG_DFL:
                _signal.signal(num, _signal.SIG_DFL)
                _signal.raise_signal(num)

        try:
            _signal.signal(signum, _handler)
        except (ValueError, OSError):
            pass  # not the main thread / unsupported signal


def _reset_for_tests():
    """Drop the process-global recorder (unit tests re-attach per tmpdir)."""
    global _recorder
    with _lock:
        if _recorder is not None:
            _recorder.close()
        _recorder = None
        _pre_attach.clear()
