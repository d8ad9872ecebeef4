"""Continuous-batching LLM engine on the paged KV cache.

Counterpart of ``ray_tpu/serve/llm/engine.py``, with the same scheduler, on
``ray_tpu_torch.models.generate``'s paged decode path:

- **slots**: a fixed number of decode lanes (static [num_slots] shapes); a
  sequence occupies a slot from admission to completion, and a new prompt is
  admitted the moment a slot and enough KV blocks free up, mid-decode.
- **paged KV cache**: ``init_paged_cache`` block pool on the parameters'
  device, with per-sequence block tables and a host-side free list. Block 0
  is the reserved null block.
- **chunked prefill interleaved with decode**: at most one fixed-shape
  prefill chunk runs per scheduler iteration between decode steps.
- **prefix cache**: full blocks of the ORIGINAL prompt are registered under a
  chain hash (``block_hashes``); a request whose prompt shares leading
  blocks reuses them by refcount and skips that part of prefill. refs-0
  blocks stay cached and are evicted LRU under allocation pressure.
- **preemption**: when the pool runs dry mid-decode the youngest running
  sequence is preempted RECOMPUTE-style: its blocks are released, and on
  re-admission its emitted tokens are teacher-forced through prefill
  (nothing is re-emitted; the request's RNG stream is untouched).
- **streaming**: each request carries a queue the scheduler feeds token by
  token; ``LLMRequest`` iterates it.

Sampling stays on the host in numpy with the JAX engine's counter-based
``default_rng((seed, position))``, so the sampled tokens equal the JAX
engine's whenever the logits agree. Each tick copies its logits to the host.

``serial_batch=True`` degrades the scheduler to batch-at-a-time (admit only
into an idle engine, decode only after every admitted prompt finished
prefill): the baseline arm for comparing schedules.

Concurrency contract: all cache/free-list/slot state is owned by the
scheduler thread, which runs under ``torch.no_grad()`` (grad mode is per
thread); ``submit``/``cancel`` only touch the wait queue under ``_lock`` and
set the wake event (``@any_thread``); consumers block only on per-request
queues.

Not in the port yet (each needs a copy of runtime pieces the port does not
have): prefill/decode disaggregation (``role`` other than ``"both"``,
``kv_import``), the cluster prefix tier (``cluster_prefix=True``), which
needs the core worker and object store, the flight recorder's events and
the ``self_metrics`` instruments.
"""

from __future__ import annotations

import hashlib
import itertools
import queue as _queue
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._private.concurrency import any_thread, blocking
from ray_tpu_torch.exceptions import ReplicaDrainingError
from ray_tpu_torch.serve.llm.stats import ENGINES

# Terminal error of a deliberate engine teardown: requests that die with it
# raise ReplicaDrainingError (a caller may resubmit elsewhere); every other
# error string is a plain RuntimeError.
SHUTDOWN_ERROR = "engine shutdown"


def _request_error(val: str) -> Exception:
    if val == SHUTDOWN_ERROR:
        return ReplicaDrainingError("llm engine shut down mid-request (replica retiring)")
    return RuntimeError(val)


class LLMRequest:
    """One generation request: scheduler-fed token queue + terminal state.

    Iterate it for streaming (``for tok in req``), or ``result()`` to
    collect every token. The scheduler owns all ``_sched``-prefixed fields.
    """

    def __init__(self, rid, prompt, max_new_tokens, temperature, top_k, seed):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # Counter-based sampling stream: token i is drawn from
        # default_rng((seed, i)), so a resumed or preempted request continues
        # bit-identically.
        self.seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.cancelled = threading.Event()
        self.error: Optional[str] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self._q: _queue.Queue = _queue.Queue()
        self._finished = False  # scheduler-side guard: one terminal event
        # --- scheduler-owned ---
        self._sched_generated: list[int] = []
        self._sched_state = "waiting"  # waiting | prefill | decode | done
        self._sched_slot: Optional[int] = None
        self._sched_table: list[int] = []
        self._sched_pos = 0
        self._sched_target = 0
        self._sched_cached_bids: set[int] = set()
        self._sched_registered_bids: set[int] = set()
        self._sched_hashes: list[bytes] = []
        self._sched_admit_seq = -1

    @property
    def num_generated(self) -> int:
        return len(self._sched_generated)

    @blocking
    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:  # error
                raise _request_error(val)

    @blocking
    def result(self, timeout: float = 120.0) -> list[int]:
        """Collect the full completion (raises on engine-side error)."""
        out: list[int] = []
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"request {self.id} not finished in {timeout}s")
            try:
                kind, val = self._q.get(timeout=min(remaining, 1.0))
            except _queue.Empty:
                continue
            if kind == "token":
                out.append(val)
            elif kind == "done":
                return out
            else:
                raise _request_error(val)


def block_hashes(tokens, block_size: int) -> list[bytes]:
    """Chain hash per FULL block: h_i = sha1(h_{i-1} || tokens of block i).
    The KV rows of block i depend (causally) on every token up to its end,
    so the chain is exactly the reuse key."""
    out: list[bytes] = []
    h = b""
    for i in range(len(tokens) // block_size):
        blk = np.asarray(tokens[i * block_size : (i + 1) * block_size], dtype=">u4").tobytes()
        h = hashlib.sha1(h + blk).digest()
        out.append(h)
    return out


def prefix_route_hint(tokens, block_size: int = 16) -> str:
    """Router affinity hint for cache-aware routing: the hash of the FIRST
    full block (shared system prompts share it; suffixes don't disturb it).
    Empty string when the prompt doesn't fill one block."""
    hs = block_hashes(list(tokens)[:block_size], block_size)
    return hs[0].hex() if hs else ""


def _compiled_fns(cfg):
    """The engine's two device steps, as plain callables on ``cfg`` (eager
    PyTorch compiles nothing; the name follows the JAX engine's jitted pair):
    a paged decode step over every slot, and a prefill chunk that projects
    only its one needed row through the head."""
    from ray_tpu_torch.models.generate import _logits, _paged_decode_chunk_hidden, paged_decode_step

    def decode_step(p, t, c, bt, pos):
        return paged_decode_step(p, t, c, bt, pos, cfg)

    @torch.no_grad()
    def prefill_chunk_row(p, t, c, bt, pos, vt, row):
        # Only the prompt's last real token, on its final chunk, is sampled
        # from: project that row instead of paying the [1, q, V] head matmul.
        x, c = _paged_decode_chunk_hidden(p, t, c, bt, pos, cfg, valid_to=vt)
        return _logits(p, x[:, row]), c

    return decode_step, prefill_chunk_row


class _PrefixEntry:
    __slots__ = ("bid", "refs", "stamp")

    def __init__(self, bid: int, refs: int, stamp: float):
        self.bid = bid
        self.refs = refs
        self.stamp = stamp


class LLMEngine:
    def __init__(
        self,
        params,
        cfg,
        *,
        num_slots: int = 8,
        block_size: int = 16,
        max_model_len: Optional[int] = None,
        num_blocks: Optional[int] = None,
        prefill_chunk: int = 32,
        serial_batch: bool = False,
        role: str = "both",
        cluster_prefix: bool = False,
    ):
        from ray_tpu_torch.models.generate import init_paged_cache

        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be both|prefill|decode, got {role!r}")
        if role != "both":
            raise NotImplementedError(
                f"role={role!r}: prefill/decode disaggregation (the KV handoff) needs the port's copy of "
                "the core worker and object store, which does not exist yet"
            )
        if cluster_prefix:
            raise NotImplementedError(
                "cluster_prefix=True: the cluster prefix tier (kv_transfer) needs the port's copy of the "
                "core worker, GCS KV and object store, which does not exist yet"
            )
        self.params = params
        self.cfg = cfg
        self.role = role
        self.num_slots = int(num_slots)
        self.block_size = int(block_size)
        self.max_model_len = int(max_model_len or cfg.max_seq_len)
        self.n_max = -(-self.max_model_len // self.block_size)  # blocks/seq
        # Default pool: every slot can run to max_model_len (+1 null block),
        # preemption-free unless the caller sizes the pool down.
        self.num_blocks = int(num_blocks or self.num_slots * self.n_max + 1)
        self.prefill_chunk = int(prefill_chunk)
        self.serial_batch = bool(serial_batch)
        self.device = params["embed"].device
        self._cache = init_paged_cache(cfg, self.num_blocks, self.block_size, device=self.device)
        # Block 0 is the reserved null block — never handed out.
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._prefix: dict[bytes, _PrefixEntry] = {}
        self._bid_hash: dict[int, bytes] = {}
        # Evictable (refs-0) prefix entries in LRU order: insertion order IS
        # recency (pushed on the refs 1->0 transition, popped from the front).
        self._lru: "OrderedDict[bytes, None]" = OrderedDict()
        self._slots: list[Optional[LLMRequest]] = [None] * self.num_slots
        self._waiting: deque[LLMRequest] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._crashed: Optional[str] = None  # set under _lock by the crash sweep
        self._draining = False  # drain-before-retire: refuse NEW submits only
        self._rid = itertools.count()
        self._admit_seq = itertools.count()
        # Per-engine counters, read by stats().
        self._counts = {
            "admitted": 0,
            "finished": 0,
            "cancelled": 0,
            "preemptions": 0,
            "prefix_hit_blocks": 0,
            "prefix_miss_blocks": 0,
            "evicted_blocks": 0,
        }
        self._decode_fn, self._prefill_fn = _compiled_fns(cfg)
        self._thread = threading.Thread(target=self._loop, name="llm-engine", daemon=True)
        # Live-engine registry: _loop's exit (stop OR crash) withdraws it.
        ENGINES.add(self)
        self._thread.start()

    # ------------------------------------------------------------------
    # public surface (any thread)
    # ------------------------------------------------------------------

    @any_thread
    def submit(
        self,
        tokens,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        resume_tokens=None,
        kv_import=None,
    ) -> LLMRequest:
        """``resume_tokens``: tokens this request ALREADY emitted elsewhere.
        They are teacher-forced through chunked prefill like recompute
        preemption and never re-emitted: the stream continues from position
        len(resume_tokens), bit-identically under the counter-based RNG.

        ``kv_import`` (a prefill replica's sealed-KV handoff) is not ported
        and raises NotImplementedError."""
        if kv_import is not None:
            raise NotImplementedError(
                "kv_import: the prefill->decode KV handoff needs the port's copy of the object store, "
                "which does not exist yet"
            )
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("empty prompt")
        resume = [int(t) for t in (resume_tokens or ())]
        if len(resume) > int(max_new_tokens):
            raise ValueError(f"resume_tokens ({len(resume)}) exceeds max_new_tokens ({max_new_tokens})")
        if len(tokens) + int(max_new_tokens) > self.max_model_len:
            raise ValueError(
                f"prompt ({len(tokens)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_model_len {self.max_model_len}"
            )
        # A request whose full extent can never be backed by the pool would
        # park at the admission FIFO head forever: reject it here.
        max_blocks = (len(tokens) + int(max_new_tokens) - 1) // self.block_size + 1
        if max_blocks > self.num_blocks - 1:
            raise ValueError(
                f"request needs up to {max_blocks} KV blocks but the pool "
                f"only has {self.num_blocks - 1}; raise num_blocks"
            )
        req = LLMRequest(f"llm-{next(self._rid)}", tokens, max_new_tokens, temperature, top_k, seed)
        req._sched_generated = resume
        # Reuse applies to blocks fully inside tokens[:-1]: at least one
        # prompt token always runs through prefill so admission has logits
        # to sample the first output from.
        n_hashable = (len(tokens) - 1) // self.block_size
        req._sched_hashes = block_hashes(tokens, self.block_size)[:n_hashable]
        if len(resume) >= int(max_new_tokens):
            # Already complete on arrival: nothing to generate.
            req._finished = True
            req._sched_state = "done"
            req.t_done = time.monotonic()
            req._q.put(("done", "complete"))
            return req
        with self._lock:
            # A stopped scheduler can never serve this request: fail the
            # submit. The crash handler and the shutdown drain set _crashed
            # and sweep _waiting under this same lock.
            if self._crashed is not None:
                raise RuntimeError(self._crashed)
            if self._draining:
                raise ReplicaDrainingError(
                    "llm engine is draining (replica retiring); resubmit on another replica"
                )
            self._waiting.append(req)
        self._wake.set()
        return req

    @any_thread
    def cancel(self, req: LLMRequest):
        """Client disconnect: mark the request; the scheduler frees its slot
        and KV blocks on its next iteration."""
        req.cancelled.set()
        self._wake.set()

    @any_thread
    def drain(self):
        """Drain-before-retire: refuse NEW submits; everything already
        accepted decodes to completion."""
        with self._lock:
            self._draining = True

    @any_thread
    def stats(self) -> dict:
        """Best-effort snapshot (plain-int reads) for tests and benches."""
        return {
            "num_blocks": self.num_blocks - 1,
            "free_blocks": len(self._free),
            "cached_blocks": len(self._prefix),
            "running": sum(r is not None for r in self._slots),
            "waiting": len(self._waiting),
            "draining": self._draining,
            "role": self.role,
            **self._counts,
        }

    @any_thread
    def shutdown(self, timeout: float = 10.0):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)

    def check_health(self) -> bool:
        if not self._thread.is_alive() and not self._stop.is_set():
            raise RuntimeError("llm engine scheduler thread died")
        return True

    # ------------------------------------------------------------------
    # scheduler (one dedicated thread owns everything below)
    # ------------------------------------------------------------------

    @blocking
    def _loop(self):
        try:
            with torch.no_grad():  # grad mode is per thread: the caller's does not reach here
                while not self._stop.is_set():
                    self._sweep_cancelled()
                    self._admit()
                    busy = self._prefill_tick()
                    busy = self._decode_tick() or busy
                    if not busy:
                        if any(r is not None for r in self._slots) or self._waiting:
                            self._wake.wait(0.02)
                        else:
                            # Fully idle: every transition that could make work
                            # (submit/cancel/shutdown) sets _wake.
                            self._wake.wait()
                        self._wake.clear()
        except BaseException as e:  # noqa: BLE001 — fail every consumer loudly
            msg = f"llm engine scheduler died: {type(e).__name__}: {e}"
            with self._lock:
                self._crashed = msg
                pending = list(self._slots) + list(self._waiting)
            for req in pending:
                if req is not None:
                    self._finish(req, error=msg)
            raise
        finally:
            ENGINES.discard(self)
            with self._lock:
                if self._crashed is None:
                    self._crashed = "llm engine is shut down"
                pending = list(self._slots) + list(self._waiting)
            for req in pending:
                if req is not None:
                    self._finish(req, error=SHUTDOWN_ERROR)

    def _sweep_cancelled(self):
        for req in self._slots:
            if req is not None and req.cancelled.is_set():
                self._finish(req, cancelled=True)
        with self._lock:
            stale = [r for r in self._waiting if r.cancelled.is_set()]
            for r in stale:
                self._waiting.remove(r)
        for r in stale:
            self._finish(r, cancelled=True)

    # --- block pool ---

    def _alloc_block(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        while self._lru:
            victim_hash, _ = self._lru.popitem(last=False)  # oldest refs-0
            victim = self._prefix.get(victim_hash)
            if victim is None or victim.refs > 0:
                continue  # stale LRU entry
            del self._prefix[victim_hash]
            self._bid_hash.pop(victim.bid, None)
            self._counts["evicted_blocks"] += 1
            return victim.bid
        return None

    def _release_blocks(self, req: LLMRequest):
        now = time.monotonic()
        shared = req._sched_cached_bids | req._sched_registered_bids
        for bid in req._sched_table:
            if bid in shared:
                h = self._bid_hash.get(bid)
                e = self._prefix.get(h) if h is not None else None
                if e is not None:
                    e.refs -= 1
                    e.stamp = now
                    if e.refs <= 0:  # now evictable: most-recent LRU slot
                        self._lru.pop(h, None)
                        self._lru[h] = None
                else:  # registration raced an eviction; treat as private
                    self._free.append(bid)
            else:
                self._free.append(bid)
        req._sched_table = []
        req._sched_cached_bids = set()
        req._sched_registered_bids = set()

    # --- admission ---

    def _admit(self):
        if self.serial_batch and any(r is not None for r in self._slots):
            return
        while True:
            try:
                slot = self._slots.index(None)
            except ValueError:
                return
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting[0]
            # Teacher-forced target: the prompt plus anything already emitted
            # before a preemption.
            target = len(req.prompt) + len(req._sched_generated)
            cached = 0
            for h in req._sched_hashes:
                if h not in self._prefix:
                    break
                cached += 1
            need = (target - 1) // self.block_size + 1 - cached
            # Evictable supply EXCLUDES the refs-0 entries this request is
            # about to take as cached hits.
            hit_hashes = set(req._sched_hashes[:cached])
            evictable = len(self._lru) - sum(1 for h in hit_hashes if h in self._lru)
            if len(self._free) + evictable < need:
                return  # head-of-line waits for blocks (FIFO fairness)
            with self._lock:
                self._waiting.popleft()
            table: list[int] = []
            now = time.monotonic()
            for h in req._sched_hashes[:cached]:
                e = self._prefix[h]
                e.refs += 1
                e.stamp = now
                if e.refs == 1:  # left the evictable set
                    self._lru.pop(h, None)
                table.append(e.bid)
                req._sched_cached_bids.add(e.bid)
            for _ in range(need):
                bid = self._alloc_block()
                if bid is None:  # the availability check above rules this out
                    raise RuntimeError("KV block pool ran dry during admission")
                table.append(bid)
            self._counts["prefix_hit_blocks"] += cached
            self._counts["prefix_miss_blocks"] += len(req._sched_hashes) - cached
            req._sched_table = table
            req._sched_pos = cached * self.block_size
            req._sched_target = target
            req._sched_state = "prefill"
            req._sched_slot = slot
            req._sched_admit_seq = next(self._admit_seq)
            self._slots[slot] = req
            self._counts["admitted"] += 1

    def _device_ints(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # --- prefill (one fixed-shape chunk per tick, interleaved with decode) ---

    def _prefill_tick(self) -> bool:
        req = min(
            (r for r in self._slots if r is not None and r._sched_state == "prefill"),
            key=lambda r: r._sched_admit_seq,
            default=None,
        )
        if req is None:
            return False
        q = self.prefill_chunk
        pos0 = req._sched_pos
        seq = req.prompt + req._sched_generated
        piece = seq[pos0 : pos0 + q]
        fed = np.zeros((1, q), np.int64)
        fed[0, : len(piece)] = piece
        table = np.zeros((1, self.n_max), np.int64)
        table[0, : len(req._sched_table)] = req._sched_table
        # Row of the prompt's LAST real token within this chunk — only
        # meaningful (and only consumed) on the final chunk.
        row = min(max(req._sched_target - 1 - pos0, 0), q - 1)
        logits, self._cache = self._prefill_fn(
            self.params,
            self._device_ints(fed),
            self._cache,
            self._device_ints(table),
            self._device_ints(np.array([pos0], np.int64)),
            self._device_ints(np.array([req._sched_target], np.int64)),
            row,
        )
        req._sched_pos = min(pos0 + q, req._sched_target)
        self._register_prefix_blocks(req)
        if req._sched_pos >= req._sched_target:
            self._emit_token(req, logits.cpu().numpy()[0])
        return True

    def _register_prefix_blocks(self, req: LLMRequest):
        """Publish freshly WRITTEN full prompt blocks for reuse, as prefill
        progresses: a block is visible to other admissions only once its rows
        exist."""
        now = time.monotonic()
        done_blocks = req._sched_pos // self.block_size
        for i, h in enumerate(req._sched_hashes[:done_blocks]):
            bid = req._sched_table[i]
            if bid in req._sched_cached_bids or bid in req._sched_registered_bids:
                continue
            if h in self._prefix:
                continue  # another sequence published this hash first
            self._prefix[h] = _PrefixEntry(bid, refs=1, stamp=now)
            self._bid_hash[bid] = h
            req._sched_registered_bids.add(bid)

    # --- decode ---

    def _decode_tick(self) -> bool:
        if self.serial_batch and any(r is not None and r._sched_state == "prefill" for r in self._slots):
            return False  # serial baseline: the batch decodes in lockstep
        active = [r for r in self._slots if r is not None and r._sched_state == "decode"]
        if not active:
            return False
        # Every active sequence needs its next write position backed by a
        # physical block before the step; exhaustion preempts the youngest.
        for req in list(active):
            if req._sched_slot is None or self._slots[req._sched_slot] is not req:
                continue  # preempted by an earlier needy sequence this tick
            while req._sched_pos // self.block_size >= len(req._sched_table):
                bid = self._alloc_block()
                if bid is not None:
                    req._sched_table.append(bid)
                    continue
                # Youngest victim over ALL running sequences, the needy one
                # included: when req is the youngest it is the one preempted.
                running = [r for r in self._slots if r is not None]
                victim = max(running, key=lambda r: r._sched_admit_seq)
                if victim is req:
                    if len(running) == 1:
                        # Nobody else holds blocks: preempting req would just
                        # readmit it into the same dry pool forever.
                        self._finish(
                            req,
                            error="KV block pool exhausted with a single running sequence; raise num_blocks",
                        )
                    else:
                        self._preempt(req)
                    break  # req left its slot; its alloc loop is moot
                self._preempt(victim)
        # Re-derive the step batch: preemption/failure may have removed some.
        active = [
            r
            for r in self._slots
            if r is not None
            and r._sched_state == "decode"
            and r._sched_pos // self.block_size < len(r._sched_table)
        ]
        if not active:
            return True
        toks = np.zeros((self.num_slots,), np.int64)
        pos = np.zeros((self.num_slots,), np.int64)
        tables = np.zeros((self.num_slots, self.n_max), np.int64)
        for req in active:
            s = req._sched_slot
            toks[s] = req._sched_generated[-1]
            pos[s] = req._sched_pos
            tables[s, : len(req._sched_table)] = req._sched_table
        logits, self._cache = self._decode_fn(
            self.params, self._device_ints(toks), self._cache, self._device_ints(tables), self._device_ints(pos)
        )
        logits = logits.cpu().numpy()
        for req in active:
            req._sched_pos += 1
            self._emit_token(req, logits[req._sched_slot])
        return True

    def _sample(self, req: LLMRequest, row: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(row.argmax())
        logits = row.astype(np.float64) / req.temperature
        if req.top_k > 0:
            kth = np.sort(logits)[-req.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        # Counter-based draw: (seed, position) fully determines the token.
        rng = np.random.default_rng((req.seed, len(req._sched_generated)))
        return int(rng.choice(len(p), p=p))

    def _emit_token(self, req: LLMRequest, logits_row: np.ndarray):
        tok = self._sample(req, logits_row)
        req._sched_generated.append(tok)
        req._sched_state = "decode"
        if req.t_first is None:
            req.t_first = time.monotonic()
        req._q.put(("token", tok))
        if len(req._sched_generated) >= req.max_new_tokens:
            self._finish(req)

    # --- terminal transitions ---

    def _preempt(self, victim: LLMRequest):
        self._counts["preemptions"] += 1
        self._release_blocks(victim)
        if victim._sched_slot is not None:
            self._slots[victim._sched_slot] = None
        victim._sched_slot = None
        victim._sched_state = "waiting"
        victim._sched_pos = 0
        with self._lock:
            self._waiting.appendleft(victim)  # resume first: FIFO-ish fairness

    def _finish(self, req: LLMRequest, error: str | None = None, cancelled=False):
        if req._finished:
            return
        req._finished = True
        self._release_blocks(req)
        if req._sched_slot is not None and self._slots[req._sched_slot] is req:
            self._slots[req._sched_slot] = None
        req._sched_slot = None
        req._sched_state = "done"
        req.t_done = time.monotonic()
        if cancelled:
            self._counts["cancelled"] += 1
            req._q.put(("done", "cancelled"))
        elif error is not None:
            self._counts["finished"] += 1
            req.error = error
            req._q.put(("error", error))
        else:
            self._counts["finished"] += 1
            req._q.put(("done", "complete"))
