"""Raylet — per-node daemon.

Analog of the reference's raylet process (src/ray/raylet/main.cc:109,
NodeManager node_manager.h:117): hosts

- the node's shared-memory object store daemon (StoreCore; reference runs
  plasma inside the raylet too, plasma/store_runner.h)
- the worker pool: spawns/pools Python worker processes
  (worker_pool.cc:426 StartWorkerProcess, :1150 PopWorker)
- the two-level scheduler: cluster-level placement with spillback to other
  raylets (cluster_task_manager.h:42) and local dispatch to leased workers
  (local_task_manager.h:58), with placement-group bundle accounting
  (placement_group_resource_manager.h)
- chunked node-to-node object transfer (object_manager.h:117, pull_manager.h:52)
- heartbeat/resource sync with GCS (ray_syncer.h:86) and worker-failure
  reporting.

CUDA cards are first-class resources here: a node's resource set is
{"CPU": n, "GPU": m, "memory": bytes, ...custom}.

Not ported yet: the per-node dashboard stats agent and C++ workers (ROADMAP
A5, what remains); a task that asks for a C++ worker raises.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field

from ray_tpu_torch._private import flight_recorder, self_metrics
from ray_tpu_torch._private.concurrency import loop_only
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import BoundedIdSet, NodeID, WorkerID
from ray_tpu_torch._private.rpc import (
    RAW_CHUNK,
    EventLoopThread,
    RawFrame,
    RawResult,
    RpcClient,
    RpcServer,
    schema,
)
from ray_tpu_torch._private.transfer_stats import TRANSFER
from ray_tpu_torch._private.store.arena import create_arena
from ray_tpu_torch._private.store.object_store import StoreCore
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger(__name__)

def _binomial_split(targets: list) -> list[tuple[dict, list]]:
    """Binomial-tree fan-out: peel a child off the front, hand it half the
    remainder as its subtree, repeat — the root contacts O(log N) children
    directly and every child does the same with its share."""
    splits = []
    rest = list(targets)
    while rest:
        child, rest = rest[0], rest[1:]
        subtree, rest = rest[: len(rest) // 2], rest[len(rest) // 2 :]
        splits.append((child, subtree))
    return splits


def rejoin_backoff_delay(attempt: int, cfg, rng) -> float:
    """Jittered exponential backoff before a re-register: full jitter over
    [0, min(max, base * 2^attempt)] — a GCS restart or mass partition-heal
    otherwise makes every raylet re-register in the same heartbeat interval
    (thundering herd on the register/republish fan-in)."""
    ceiling = min(cfg.rejoin_backoff_max_s, cfg.rejoin_backoff_base_s * (2 ** attempt))
    return rng.uniform(0, ceiling)


class OptimisticDebitLedger:
    """Self-healing bookkeeping for forward-time mirror debits.

    Spilling a task to a peer debits the peer's MIRRORED availability
    immediately, so a burst of picks spreads over fits-now peers instead of
    dogpiling the first one. Under the legacy full-view heartbeat the debit
    was provisional by construction — every reply overwrote the whole
    mirror. Delta sync ships only CHANGED rows, which opens a leak: when the
    peer acquires and releases entirely between its own heartbeats, its GCS
    row never changes, no delta ever arrives, and the debit sticks forever —
    the forwarder permanently under-estimates that peer (and locality
    preference starts refusing a perfectly idle holder).

    So every debit carries a deadline (a couple of heartbeat intervals): an
    authoritative row for the node clears its debits (the upsert already
    overwrote the mirror), and a debit that outlives its deadline is
    credited back. sched_core.release clamps at capacity and ignores
    unknown nodes, so a late credit after a real delta or a tombstone is
    harmless."""

    def __init__(self):
        self._pending: list[tuple[float, str, dict]] = []

    def note(self, node_id: str, resources: dict, interval_s: float):
        self._pending.append(
            (time.monotonic() + 2.5 * max(interval_s, 0.05), node_id, dict(resources))
        )

    def on_authoritative_rows(self, node_ids) -> None:
        """Rows in a heartbeat reply (changed or tombstoned) supersede any
        pending debit for those nodes."""
        if self._pending and node_ids:
            ids = set(node_ids)
            self._pending = [p for p in self._pending if p[1] not in ids]

    def expire(self, sched) -> None:
        """Credit back debits never confirmed by an authoritative row."""
        if not self._pending:
            return
        now = time.monotonic()
        due = [p for p in self._pending if p[0] <= now]
        if due:
            self._pending = [p for p in self._pending if p[0] > now]
            for _, nid, res in due:
                sched.release(nid, res)


def apply_heartbeat_view(resp: dict, node) -> None:
    """Fold a heartbeat reply's cluster view into ``node`` (a Raylet or a
    SimNode shell: anything with ``cluster_view``/``_view_version``/
    ``_sched``/``node_id``/``_synced_peers``).

    Three reply shapes: legacy full view under ``"nodes"``, delta-sync full
    resync (``view_full``), and a delta (changed rows + removal tombstones).
    Peers are mirrored into the local sched_core ledger — NEVER self: the
    local ledger is authoritative, and a stale heartbeat echo (a delta row
    for this node carrying pre-acquire availability) must not clobber
    in-flight acquires."""
    if "view" in resp:
        node._view_version = resp.get("view_version", 0)
        removed = resp.get("view_removed", ())
        if resp.get("view_full"):
            node.cluster_view = dict(resp["view"])
        else:
            for nid in removed:
                node.cluster_view.pop(nid, None)
            node.cluster_view.update(resp["view"])
        changed = resp["view"]
    elif "nodes" in resp:
        node.cluster_view = resp.get("nodes", {})
        changed = node.cluster_view
        removed = ()
    else:
        return
    for nid in changed:
        if nid == node.node_id:
            continue
        row = node.cluster_view.get(nid)
        if row is not None:
            node._sched.node_upsert(
                nid,
                row.get("resources_total", {}),
                row.get("resources_available", {}),
            )
    gone = node._synced_peers - set(node.cluster_view)
    for nid in gone:
        if nid != node.node_id:
            node._sched.node_remove(nid)
    node._synced_peers = set(node.cluster_view)
    debits = getattr(node, "_opt_debits", None)
    if debits is not None:
        debits.on_authoritative_rows(set(changed) | set(removed) | gone)


class ArgLocalityCache:
    """oid -> holder node ids for locality-aware placement, bounded + TTL.

    Reference args (``("r", oid, owner)``) are by construction plasma-sized
    — anything under ``max_direct_call_object_size`` ships inline — so the
    inline/reference split IS the large-arg threshold the Ray paper's
    data-locality policy keys on. Shared by Raylet and SimNode shells."""

    _MAX_ENTRIES = 4096

    def __init__(self, gcs: RpcClient, cfg):
        self.gcs = gcs
        self.cfg = cfg
        self._cache: dict[str, tuple[float, tuple]] = {}

    async def holders(self, spec: TaskSpec) -> dict[str, int]:
        """node_id -> how many of the task's reference args it holds."""
        oids = [
            a[1]
            for a in spec.args
            if isinstance(a, (list, tuple)) and len(a) >= 2 and a[0] == "r"
        ][: self.cfg.locality_max_args]
        if not oids:
            return {}
        now = time.monotonic()
        counts: dict[str, int] = {}
        missing = []
        for oid in oids:
            hit = self._cache.get(oid)
            if hit is not None and now - hit[0] < self.cfg.locality_cache_ttl_s:
                for nid in hit[1]:
                    counts[nid] = counts.get(nid, 0) + 1
            else:
                missing.append(oid)
        if missing:
            results = await asyncio.gather(
                *[
                    self.gcs.acall(
                        "get_object_locations",
                        {"object_id": oid},
                        timeout=2,
                        retries=0,
                    )
                    for oid in missing
                ],
                return_exceptions=True,
            )
            if len(self._cache) >= self._MAX_ENTRIES:
                # Bounded: evict the oldest-inserted half wholesale.
                for k in list(self._cache)[: self._MAX_ENTRIES // 2]:
                    self._cache.pop(k, None)
            for oid, resp in zip(missing, results):
                if isinstance(resp, BaseException):
                    continue  # lookup failure: schedule without this arg's hint
                nids = tuple(loc["node_id"] for loc in resp.get("locations", []))
                self._cache[oid] = (now, nids)
                for nid in nids:
                    counts[nid] = counts.get(nid, 0) + 1
        return counts


def _runtime_env_hash(runtime_env: dict | None) -> str | None:
    """Canonical hash for worker<->task runtime-env matching."""
    if not runtime_env:
        return None
    import hashlib

    return hashlib.md5(json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:16]


def _worker_key(runtime_env: dict | None, language: str = "py") -> str | None:
    """Worker-pool matching key: runtime env PLUS execution language
    (reference: worker_pool.cc keys cached workers per (language,
    runtime-env hash)). language="cpp" workers are the native runtime
    (cpp/ray_tpu_worker.cc) and never serve Python tasks, and vice versa."""
    h = _runtime_env_hash(runtime_env)
    return h if language == "py" else f"lang={language}|{h}"


@dataclass
class WorkerHandle:
    worker_id: str
    pid: int
    address: tuple | None = None
    client: RpcClient | None = None
    proc: subprocess.Popen | None = None
    state: str = "starting"  # starting | idle | busy | actor | dead
    # Workers are dedicated to one runtime env (reference: worker_pool.cc
    # caches workers per runtime-env hash); None = plain environment.
    runtime_env_hash: str | None = None
    current_task: TaskSpec | None = None
    # Creation spec of the actor living in this worker; actors hold their
    # resources for life, so these are released only on worker death.
    actor_spec: TaskSpec | None = None
    actor_id: str | None = None
    last_idle: float = field(default_factory=time.monotonic)
    # Log-pipeline attribution (reference: LogMonitor tags lines by job).
    last_job_id: str | None = None
    last_task_name: str | None = None
    # Set when the memory monitor killed this worker (OOM error surfacing).
    oom_killed: bool = False
    # When the current task was dispatched (OOM victim policy: newest first).
    dispatch_ts: float = 0.0


class Raylet:
    def __init__(
        self,
        gcs_address,
        session_dir: str,
        resources: dict | None = None,
        labels: dict | None = None,
        node_ip: str = "127.0.0.1",
        object_store_memory: int | None = None,
        exit_on_dead: bool = False,
    ):
        self.cfg = get_config()
        # When the GCS declares this node dead (a partition outlived the
        # death timeout, say): standalone raylet processes fail fast and
        # exit (the reference's suicide-on-dead, main() passes True); an
        # IN-PROCESS raylet must instead REJOIN — os._exit here would kill
        # the host process, driver and sibling nodes included.
        self._exit_on_dead = exit_on_dead
        self.node_id = NodeID.from_random().hex()
        self.session_dir = session_dir
        self.node_ip = node_ip
        os.makedirs(session_dir, exist_ok=True)
        # Always-on observability: crash-surviving event ring + ray_tpu_*
        # runtime instruments (store gauges feed from the heartbeat loop).
        flight_recorder.attach(session_dir, role="raylet", ident=self.node_id)
        self._metrics = self_metrics.instruments()

        self.arena_name = f"/rtpu_torch_{self.node_id[:12]}"
        capacity = object_store_memory or self.cfg.object_store_memory
        self.arena = create_arena(self.arena_name, capacity)
        from ray_tpu_torch._private.store.index import create_index

        # Native object index: local-get fast path for every client process
        # on this node (skipped automatically if the native build failed).
        self.object_index = create_index(self.arena_name + "_idx")
        spill_dir = self.cfg.object_spill_dir or os.path.join(session_dir, "spill", self.node_id[:8])
        self.store = StoreCore(self.arena, spill_dir, index=self.object_index)
        # Clients' lifetime pins (StoreClient.get_pinned): pid -> {hold id:
        # (object id, kind, index token)}, released by store_unhold or when
        # the process dies; an unhold that overtook its hold waits here.
        self._store_holds: dict[int, dict] = {}
        self._early_unholds: set[str] = set()

        self.resources_total = dict(resources or {"CPU": os.cpu_count() or 1})
        self.resources_total.setdefault("memory", 4 * 1024 * 1024 * 1024)
        # Resource accounting lives in the native scheduler core (C++
        # fixed-point ledger, _native/sched_core.cc — the reference keeps
        # this math in src/ray/raylet/scheduling/); resources_available is a
        # derived property over it.
        from ray_tpu_torch._private.sched_core import create_sched_core

        self._sched = create_sched_core()
        self._sched.node_upsert(self.node_id, self.resources_total, self.resources_total)
        self._res_keys: set[str] = set(self.resources_total)
        # Placement-group bundle CAPACITIES (metadata/view); live availability
        # is the core's pool state.
        self.bundles: dict[tuple, dict] = {}
        self.bundle_reserved: dict[tuple, dict] = {}
        self.labels = dict(labels or {})

        self.workers: dict[str, WorkerHandle] = {}
        # Worker ids abandoned after a zygote spawn fallback (the fork may
        # have produced an orphan that registers late) — registration under
        # these is refused and the orphan reaped.
        self._retired_worker_ids: set[str] = set()
        self.task_queue: deque[TaskSpec] = deque()
        # Specs currently being forwarded to a peer (out of the queue, the
        # forward RPC in flight): visible to rpc_locate_tasks so the owner's
        # lost-task sweep never mistakes a mid-spillback task for lost.
        self._forwarding: set[str] = set()
        # Tasks whose resources/pool/placement can't currently be satisfied
        # park here instead of rotating through task_queue (reference keeps a
        # separate infeasible queue too, cluster_task_manager.h). They are
        # spliced back whenever capacity or the cluster view changes.
        self._infeasible: deque[TaskSpec] = deque()
        # Cancelled-before-arrival tombstones (cancel racing a spillback or
        # an in-flight submit): matching specs are dropped at dispatch.
        self._cancelled_tasks = BoundedIdSet()
        self._last_progress = time.monotonic()
        self.cluster_view: dict = {}
        # Last cluster-view generation applied (delta heartbeat sync); 0
        # forces a full view on the first heartbeat.
        self._view_version = 0
        self._synced_peers: set[str] = set()
        self._peer_clients: dict[str, RpcClient] = {}
        # Rejoin thundering-herd damping: per-node seeded jitter so a fleet
        # rediscovering a restarted GCS staggers deterministically.
        import random

        self._rejoin_rng = random.Random(self.node_id)
        self._rejoin_attempts = 0
        self._inbound_pushes: dict[str, dict] = {}  # object_id -> push session
        # Commit outcomes, remembered briefly (see rpc_push_commit): a
        # sender retrying a timed-out/blipped commit must observe the REAL
        # subtree verdict, not a contains() guess that drops relay failures.
        self._commit_results: dict[str, asyncio.Future] = {}
        # Advertised in push_begin replies and honored for fetch responses;
        # flip off (config transfer_raw_frames / per-instance in tests) to
        # force the msgpack fallback on every session through this node.
        self.raw_frames_enabled = self.cfg.transfer_raw_frames
        from ray_tpu_torch._private.push_manager import PushManager

        self.push_manager = PushManager(self)
        from ray_tpu_torch._private.pull_manager import PullManager

        self.pull_manager = PullManager(self)

        self.server = RpcServer(f"raylet-{self.node_id[:8]}")
        self.server.register_all(self)
        self.server.set_raw_handler(self._on_raw_frame)
        self.server.start(node_ip, 0)
        self.address = self.server.address

        self.gcs = RpcClient(tuple(gcs_address) if isinstance(gcs_address, (list, tuple)) else gcs_address, label="gcs")
        # Locality-aware scheduling: bounded TTL cache of oid -> holder node
        # ids (one GCS location lookup per arg per TTL window).
        self._arg_locality = ArgLocalityCache(self.gcs, self.cfg)
        self._opt_debits = OptimisticDebitLedger()
        self._io = EventLoopThread.get()
        self._io.run(self._register())
        self._hb_task = self._io.spawn(self._heartbeat_loop())
        self._reap_task = self._io.spawn(self._reap_loop())
        from ray_tpu_torch._private.log_monitor import LogMonitor

        self._log_monitor_task = self._io.spawn(LogMonitor(self).run())
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor

        self._memory_monitor = MemoryMonitor(self)
        self._last_memory_check = 0.0
        self._tracing_enabled = False
        self._stopped = False
        # Direct task transport (reference: direct_task_transport.cc): lease
        # requests awaiting a worker grant, granted leases by id, and
        # owner-reported backlog per (owner, shape) for autoscaler demand.
        self._lease_futures: dict[str, asyncio.Future] = {}
        self._leases: dict[str, dict] = {}
        self._lease_demand: dict[tuple, tuple] = {}

    async def _register(self):
        await self.gcs.acall(
            "register_node",
            {
                "node_id": self.node_id,
                "address": list(self.address),
                "resources": self.resources_total,
                "labels": self.labels,
                "arena_name": self.arena_name,
            },
        )

    def _update_store_gauges(self):
        """Arena gauges piggyback on the heartbeat cadence (0.5s): O(1)
        reads, no extra loop."""
        usage = self.store.usage()
        try:
            self._metrics["store_bytes"].set(usage["used"])
            self._metrics["store_capacity"].set(usage["capacity"])
            self._metrics["store_objects"].set(usage["num_objects"])
        except Exception:
            pass
        return usage

    async def _heartbeat_loop(self):
        while True:
            try:
                hb = {
                    "node_id": self.node_id,
                    "resources_available": self.resources_available,
                    "store_usage": self._update_store_gauges(),
                    # Resource demand by shape (reference: resource load
                    # reporting in ray_syncer / autoscaler demand input).
                    "load": self._pending_load(),
                    # Occupancy: actors may hold zero resources, so the
                    # autoscaler must not treat resource-idle as idle.
                    "num_active_workers": sum(
                        1
                        for w in self.workers.values()
                        if w.state in ("busy", "actor")
                    ),
                }
                if self.cfg.heartbeat_delta_sync:
                    # Versioned delta sync: carry the last view generation
                    # seen; the reply holds only newer rows + tombstones
                    # (full view only on resync) instead of the O(N) full
                    # view every interval.
                    hb["view_version"] = self._view_version
                resp = await self.gcs.acall("heartbeat", hb)
                if resp.get("dead"):
                    if self._exit_on_dead:
                        logger.error("raylet %s: GCS declared us dead; exiting", self.node_id[:8])
                        os._exit(1)
                    # In-process node (tests): the GCS
                    # outlived a partition/stall and wrote us off. Rejoin:
                    # re-register under the same node id and republish our
                    # sealed objects (the GCS dropped our location rows at
                    # death). Actors the GCS declared dead STAY dead — the
                    # reference's node-death semantics — but the node's
                    # capacity and store contents come back.
                    logger.warning(
                        "raylet %s: GCS declared us dead; rejoining", self.node_id[:8]
                    )
                    await self._rejoin()
                    continue
                if resp.get("unknown"):
                    # GCS restarted and lost its node table: re-register and
                    # republish our sealed objects' locations.
                    logger.warning("raylet %s: GCS restarted; re-registering", self.node_id[:8])
                    await self._rejoin()
                    continue
                apply_heartbeat_view(resp, self)
                self._opt_debits.expire(self._sched)
                self._rejoin_attempts = 0  # healthy contact resets backoff
                self._tracing_enabled = bool(resp.get("tracing"))
                self._requeue_infeasible()  # cluster view refreshed
                await self._retry_pg_tasks()
                if self.task_queue:
                    await self._dispatch()  # periodic re-check (anti-starvation)
            except Exception:
                pass
            await asyncio.sleep(self.cfg.heartbeat_interval_s)

    async def _rejoin(self):
        """Re-register with the GCS (restart recovery and post-partition
        rejoin share this) and republish every sealed object's location.
        Backs off with full jitter first: every raylet discovers a GCS
        restart in the SAME heartbeat interval, and an unstaggered storm of
        register + location-republish RPCs is exactly the fan-in spike a
        freshly restarted GCS cannot afford."""
        delay = rejoin_backoff_delay(self._rejoin_attempts, self.cfg, self._rejoin_rng)
        self._rejoin_attempts += 1
        if delay > 0:
            await asyncio.sleep(delay)
        await self._register()
        for oid in self.store.object_ids():
            try:
                await self.gcs.acall(
                    "add_object_location",
                    {"object_id": oid, "node_id": self.node_id},
                )
            except Exception:
                pass

    def _pending_load(self) -> list:
        """Aggregate queued task resource shapes for the autoscaler. Parked
        infeasible tasks are the demand that matters most (they're what new
        nodes would satisfy). The scan is EXACT — a head-only sample would
        hide resource shapes concentrated in the queue tail and starve them
        of autoscaling — but cached: at most one full walk per 5s, except
        that a queue-depth change (e.g. a freshly-parked infeasible shape)
        invalidates immediately so the autoscaler never acts on stale
        demand."""
        cached = getattr(self, "_load_cache", None)
        now = time.monotonic()
        depth = (len(self._infeasible), len(self.task_queue))
        if cached is not None and now - cached[0] < 5.0 and cached[2] == depth:
            return cached[1]
        shapes: dict[tuple, int] = {}
        for spec in list(self._infeasible) + list(self.task_queue):
            key = tuple(sorted(spec.resources.items()))
            shapes[key] = shapes.get(key, 0) + 1
        # Owner-side lease backlogs (fresh ones only): under the direct task
        # transport the deep queue lives in the owner, not here.
        for (owner, key), (count, ts) in list(self._lease_demand.items()):
            if now - ts > 30.0:
                self._lease_demand.pop((owner, key), None)
            elif count > 0:
                shapes[key] = shapes.get(key, 0) + count
        load = [{"resources": dict(k), "count": c} for k, c in shapes.items()]
        self._load_cache = (now, load, depth)
        return load

    async def _retry_pg_tasks(self):
        """Re-route queued tasks that cannot run on this node: PG tasks whose
        bundle lives elsewhere, locally-infeasible tasks awaiting spillback
        (the cluster view may have been empty at submit), and strict
        node-affinity tasks targeting another node."""
        stuck = [s for s in self.task_queue if self._must_reroute(s)]
        for spec in stuck:
            self.task_queue.remove(spec)
            self._forwarding.add(spec.task_id)
            try:
                await self._queue_and_schedule(spec)
            finally:
                self._forwarding.discard(spec.task_id)

    def _must_reroute(self, spec: TaskSpec) -> bool:
        if spec.placement_group_id:
            return not self._has_pool(spec)
        strategy = spec.scheduling_strategy or "DEFAULT"
        if strategy.startswith("node:"):
            parts = strategy.split(":")
            return parts[1] != self.node_id and not (len(parts) > 2 and parts[2] == "soft")
        feasible_here = all(
            self.resources_total.get(k, 0) >= v for k, v in spec.resources.items()
        )
        return not feasible_here

    # ------------------------------------------------------------------
    # Store RPC surface (clients on this node)
    # ------------------------------------------------------------------

    async def rpc_store_create(self, req):
        object_id = req["object_id"]
        entry = self.store.objects.get(object_id)
        if entry is not None:
            # Sealed -> idempotent no-op. Unsealed -> an in-flight pull/push
            # session owns the buffer; the producer must wait for its
            # seal-or-abort rather than co-write a buffer that can be freed
            # under it (the session's abort would pop the entry and make the
            # producer's seal fail).
            return {"offset": 0, "exists": True, "sealed": entry.sealed}
        offset = await self.store.create(object_id, req["size"])
        if offset is None:
            entry = self.store.objects.get(object_id)
            return {"offset": 0, "exists": True, "sealed": entry is not None and entry.sealed}
        return {"offset": offset, "exists": False}

    @schema(object_id=str)
    async def rpc_store_wait_seal(self, req):
        """Block until the object's in-flight entry seals or aborts.

        Used by local producers that lost the create race to a pull/push
        session: sealed=True means the bytes are in the store; False means
        the session aborted (or no entry exists) and the producer should
        retry its create."""
        entry = self.store.objects.get(req["object_id"])
        if entry is None:
            return {"sealed": False}
        try:
            await asyncio.wait_for(entry.sealed_event.wait(), req.get("timeout") or 30.0)
        except asyncio.TimeoutError:
            return {"sealed": False}
        cur = self.store.objects.get(req["object_id"])
        return {"sealed": cur is entry and entry.sealed}

    async def rpc_store_seal(self, req):
        self.store.seal(req["object_id"])
        # Location registration is fire-and-forget: every reader of the GCS
        # location table polls (pull loop, reconstruction probe), so eventual
        # registration is enough — and the raylet->GCS client is FIFO, so any
        # later lookup through this raylet still observes it. Awaiting it
        # here put a full GCS round trip inside EVERY put of a plasma-sized
        # object (the put_1mib regression flagged by VERDICT r5 #8).
        async def _announce(object_id=req["object_id"]):
            # Must EVENTUALLY land (a remote pull of an unregistered object
            # polls forever, and the owner could misread a transiently
            # unregistered object as lost): retry with capped backoff until
            # the row registers, the object is deleted locally, or the
            # raylet stops. A GCS RESTART is additionally covered by the
            # heartbeat loop's full re-publication of sealed objects.
            delay = 0.2
            while not self._stopped:
                if not self.store.contains(object_id):
                    return  # freed/aborted meanwhile; nothing to announce
                try:
                    await self.gcs.acall(
                        "add_object_location",
                        {"object_id": object_id, "node_id": self.node_id},
                    )
                    return
                except Exception:
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 5.0)

        asyncio.ensure_future(_announce())
        return {"ok": True}

    async def rpc_store_abort(self, req):
        self.store.abort(req["object_id"])
        return {"ok": True}

    async def rpc_store_get(self, req):
        object_id = req["object_id"]
        timeout = req.get("timeout")
        if object_id not in self.store.objects:
            # Not local yet: race local creation (a task on this node may be
            # about to seal it) against a remote pull (reference: PullManager).
            await self._pull_object(object_id, timeout)
        offset, size = await self.store.get(object_id, timeout)
        return {"offset": offset, "size": size}

    @schema(object_id=str)
    async def rpc_store_contains(self, req):
        return {"found": self.store.contains(req["object_id"])}

    @schema(object_id=str)
    async def rpc_store_release(self, req):
        self.store.release(req["object_id"])
        return {"ok": True}

    @schema(hold=str, pid=int, object_id=str, kind=str, slot=int, version=int)
    async def rpc_store_hold(self, req):
        held = (req["object_id"], req["kind"], (req["slot"], req["version"]))
        if req["hold"] in self._early_unholds:
            self._early_unholds.discard(req["hold"])
            self._release_hold(*held)
        else:
            self._store_holds.setdefault(req["pid"], {})[req["hold"]] = held
        return {"ok": True}

    @schema(hold=str, pid=int)
    async def rpc_store_unhold(self, req):
        held = self._store_holds.get(req["pid"], {}).pop(req["hold"], None)
        if held is None:
            self._early_unholds.add(req["hold"])
        else:
            self._release_hold(*held)
        return {"ok": True}

    def _release_hold(self, object_id: str, kind: str, token: tuple):
        if kind == "idx":
            if self.store.index is not None:
                self.store.index.release(token)
        else:
            self.store.release(object_id)

    @schema(object_id=str)
    async def rpc_free_object(self, req):
        """Owner frees an object cluster-wide (ref count hit zero)."""
        object_id = req["object_id"]
        resp = await self.gcs.acall("get_object_locations", {"object_id": object_id})
        for loc in resp["locations"]:
            if loc["node_id"] == self.node_id:
                self.store.delete(object_id)
                await self.gcs.acall(
                    "remove_object_location", {"object_id": object_id, "node_id": self.node_id}
                )
            else:
                try:
                    await self._peer(loc["node_id"], loc["address"]).acall(
                        "delete_local_object", {"object_id": object_id}
                    )
                except Exception:
                    pass
        return {"ok": True}

    @schema(channel_id=str, size=int)
    async def rpc_channel_create(self, req):
        """Allocate a compiled-graph channel ring from this node's arena
        (experimental/channel/); freed by channel_free at DAG teardown."""
        offset = await self.store.channel_create(req["channel_id"], req["size"])
        return {"offset": offset, "arena": self.arena_name}

    @schema(channel_id=str)
    async def rpc_channel_free(self, req):
        return {"freed": self.store.channel_free(req["channel_id"])}

    @schema(object_id=str)
    async def rpc_delete_local_object(self, req):
        self.store.delete(req["object_id"])
        await self.gcs.acall(
            "remove_object_location", {"object_id": req["object_id"], "node_id": self.node_id}
        )
        return {"ok": True}

    # ---- node-to-node transfer (reference: object_manager.h push/pull) ----

    async def rpc_fetch_object_info(self, req):
        object_id = req["object_id"]
        if not self.store.contains(object_id):
            return {"found": False}
        offset, size = await self.store.get(object_id)
        self.store.release(object_id)
        return {"found": True, "size": size}

    @schema(object_id=str, start=int, length=int)
    async def rpc_fetch_object_chunk(self, req):
        object_id = req["object_id"]
        offset, size = await self.store.get(object_id)
        try:
            start = req["start"]
            end = min(start + req["length"], size)
            if start < 0 or end <= start:
                # Out-of-range request (stale/buggy peer): answer empty on
                # the msgpack path — the puller sees a short chunk and fails
                # over — instead of handing arena.read a negative length.
                return {"data": b""}
            if req.get("raw") and self.raw_frames_enabled:
                # Raw response: the arena view goes straight to the socket;
                # the pin transfers to on_sent, released once the transport
                # has taken the bytes.
                view = self.arena.read(offset + start, end - start)
                TRANSFER.chunks_raw_out += 1
                TRANSFER.bytes_out += end - start
                result = RawResult(
                    object_id,
                    start,
                    view,
                    on_sent=lambda: self.store.release(object_id),
                )
                offset = None  # pin now owned by on_sent
                return result
            TRANSFER.chunks_msgpack_out += 1
            TRANSFER.bytes_out += end - start
            return {"data": bytes(self.arena.read(offset + start, end - start))}
        finally:
            if offset is not None:
                self.store.release(object_id)

    # ---- push-side transfer (reference: push_manager.h:29 sender pacing,
    # pull_manager.h:52 admission control) ----

    @schema(object_id=str, size=int, relay_targets=[list])
    async def rpc_push_begin(self, req):
        """Receiver-side admission: open a push session or refuse (saturated /
        already present / no arena space). The pusher backs off and retries.

        ``relay_targets``: cut-through broadcast — this node starts relaying
        the session's bytes to the subtree AS THEY ARRIVE (push_manager.
        stream_from_session), not after seal; push_commit folds the subtree
        outcome into its reply. The reply advertises ``raw_ok`` when this
        node accepts raw chunk frames for the session."""
        from ray_tpu_torch.exceptions import ObjectStoreFullError

        object_id, size = req["object_id"], req["size"]
        entry = self.store.objects.get(object_id)
        if entry is not None:
            if entry.sealed:
                return {"accepted": False, "already": True}
            # Unsealed: an in-flight pull or rival push is filling it. NOT
            # "already" — the sender must not report success (a broadcast
            # relay would then wedge on the unsealed object); it retries
            # until the entry seals or vanishes.
            return {"accepted": False, "retry_after": 0.1}
        if object_id in self._inbound_pushes:
            return {"accepted": False, "retry_after": 0.1}
        if len(self._inbound_pushes) >= self.cfg.push_max_inbound:
            return {"accepted": False, "retry_after": 0.2}
        try:
            offset = await self.store.create(object_id, size)
        except ObjectStoreFullError:
            # No arena space even after evict/spill: back-pressure the
            # sender instead of failing its push outright.
            return {"accepted": False, "retry_after": 1.0}
        if offset is None:
            # A rival creator won during create's await: sealed -> done;
            # unsealed -> let the rival finish, sender retries.
            if self.store.contains(object_id):
                return {"accepted": False, "already": True}
            return {"accepted": False, "retry_after": 0.2}
        sess = self._inbound_pushes[object_id] = {
            "offset": offset,
            "size": size,
            "ts": time.monotonic(),
            # Contiguous-prefix watermark over received chunks: cut-through
            # relays stream [0, contig) downstream while later chunks are
            # still in flight (pipelined senders may arrive out of order).
            "chunks": {},
            "contig": 0,
            "event": asyncio.Event(),
            "aborted": False,
            "relays": [],
        }
        for child, subtree in _binomial_split(list(req.get("relay_targets") or [])):
            # (task, child, subtree): commit needs the tree shape back to
            # name the nodes a dead relay took down with it.
            sess["relays"].append(
                (
                    asyncio.ensure_future(
                        self.push_manager.stream_from_session(
                            sess, object_id, child, subtree, req.get("timeout")
                        )
                    ),
                    child,
                    subtree,
                )
            )
        return {"accepted": True, "raw_ok": self.raw_frames_enabled}

    @loop_only
    def _push_session_write(self, object_id: str, start: int, data) -> dict:
        """Land one chunk (msgpack or raw path) into its session buffer and
        advance the relay watermark. Synchronous — raw frames call this while
        their payload memoryview is still valid."""
        sess = self._inbound_pushes.get(object_id)
        if sess is None or sess["aborted"]:
            return {"ok": False, "error": "no session"}
        length = len(data)
        if start < 0 or start + length > sess["size"]:
            # Out-of-range write would corrupt the neighboring arena object.
            return {"ok": False, "error": "chunk out of range"}
        self.arena.write(sess["offset"] + start, data)
        sess["ts"] = time.monotonic()
        TRANSFER.bytes_in += length
        if start >= sess["contig"]:
            chunks = sess["chunks"]
            prev = chunks.get(start, 0)
            if length > prev:
                chunks[start] = length
            while sess["contig"] in chunks:
                sess["contig"] += chunks.pop(sess["contig"])
            sess["event"].set()
        return {"ok": True}

    @loop_only
    def _on_raw_frame(self, frame: RawFrame) -> dict:
        """Server raw sink (rpc.py): chunk payloads scatter straight into the
        session's arena block — no msgpack decode, no intermediate bytes."""
        if frame.kind == RAW_CHUNK:
            TRANSFER.chunks_raw_in += 1
            return self._push_session_write(frame.oid, frame.start, frame.payload)
        return {"ok": False, "error": f"unknown raw frame kind {frame.kind}"}

    @schema(object_id=str, start=int, data=bytes)
    async def rpc_push_chunk(self, req):
        TRANSFER.chunks_msgpack_in += 1
        return self._push_session_write(req["object_id"], req["start"], req["data"])

    @schema(object_id=str)
    async def rpc_push_commit(self, req):
        object_id = req["object_id"]
        sess = self._inbound_pushes.pop(object_id, None)
        if sess is None:
            # No live session: either a RETRIED commit (the sender's first
            # reply timed out or rode a reset connection) — serve the
            # remembered outcome, which may still be gathering its relay
            # subtree; this reply is the ONLY carrier of the cut-through
            # verdict, and a bare contains() guess would report ok while
            # dropping subtree failures — or an abort raced the commit
            # (present iff sealed earlier).
            fut = self._commit_results.get(object_id)
            if fut is not None:
                return await fut
            return {"ok": self.store.contains(object_id)}
        fut = asyncio.get_event_loop().create_future()
        self._commit_results[object_id] = fut
        try:
            result = await self._finish_commit(object_id, sess)
        except Exception as e:  # noqa: BLE001
            from ray_tpu_torch._private.push_manager import subtree_node_ids

            failed = [self.node_id]
            for _, child, subtree in sess["relays"]:
                failed.extend(subtree_node_ids(child, subtree))
            result = {"ok": False, "failed": failed, "error": repr(e)}
        fut.set_result(result)

        def _forget(oid=object_id, f=fut):
            if self._commit_results.get(oid) is f:  # never pop a successor's
                self._commit_results.pop(oid, None)

        asyncio.get_event_loop().call_later(120.0, _forget)
        return result

    async def _finish_commit(self, object_id: str, sess: dict) -> dict:
        if sess["contig"] != sess["size"]:
            # Commit without all bytes (sender bug / lost ack): refuse rather
            # than seal a hole-y object.
            self._abort_push_session(object_id, sess)
            return {"ok": False, "error": "incomplete push session"}
        self.store.seal(object_id)
        # Pin IMMEDIATELY after seal, before ANY await: a sealed, unpinned
        # object is spill/evict fair game, and the cut-through relays are
        # still reading its arena block (sess["offset"]). seal() and the
        # sealed-entry branch of get() run without suspending, so no other
        # coroutine can evict in between; awaiting the GCS announce first
        # (the original ordering) opened exactly that window.
        pinned = bool(sess["relays"])
        if pinned:
            await self.store.get(object_id)
        results = None
        try:
            try:
                await self.gcs.acall(
                    "add_object_location",
                    {"object_id": object_id, "node_id": self.node_id},
                )
            finally:
                # Drain the relays BEFORE any path can release the pin: even
                # when the announce raises, the relay tasks keep reading
                # sess["offset"], and an unpinned sealed object is evict
                # fair game — they would forward reused-block bytes and the
                # children would seal corrupt copies.
                if sess["relays"]:
                    results = await asyncio.gather(
                        *(t for t, _, _ in sess["relays"]), return_exceptions=True
                    )
            if results is None:
                return {"ok": True}
            # Cut-through subtree outcome folds into THIS reply so failures
            # propagate to the broadcast root.
        finally:
            if pinned:
                self.store.release(object_id)
        failed: list[str] = []
        for (_, child, subtree), r in zip(sess["relays"], results):
            if isinstance(r, BaseException):
                # A relay that died without reporting takes its whole
                # subtree down; name the NODES (the failed-list contract —
                # callers reconcile entries against target node ids).
                from ray_tpu_torch._private.push_manager import subtree_node_ids

                failed.extend(subtree_node_ids(child, subtree))
            elif not r.get("ok"):
                failed.extend(r.get("failed") or [child["node_id"]])
        return {"ok": not failed, "failed": failed}

    def _abort_push_session(self, object_id: str, sess: dict):
        sess["aborted"] = True
        sess["event"].set()  # wake relay waiters so they fail fast
        self.store.abort(object_id)

    @schema(object_id=str)
    async def rpc_push_abort(self, req):
        sess = self._inbound_pushes.pop(req["object_id"], None)
        if sess is not None:
            self._abort_push_session(req["object_id"], sess)
        return {"ok": True}

    def _reap_stale_push_sessions(self):
        """A sender that died between push_begin and commit/abort must not
        leak its admission slot + unsealed arena allocation forever (8 leaks
        would wedge the node's whole inbound push plane)."""
        now = time.monotonic()
        for oid, sess in list(self._inbound_pushes.items()):
            if now - sess["ts"] > 60.0:
                self._inbound_pushes.pop(oid, None)
                self._abort_push_session(oid, sess)
                logger.warning("reaped stale inbound push session for %s", oid[:8])

    @schema(object_id=str, targets=[list])
    async def rpc_broadcast_object(self, req):
        """Fan an object out to `targets` over a binomial tree: this node
        pushes to O(log N) children, each child relays to its subtree. The
        1-GiB-to-50-nodes envelope (BASELINE.md) needs this — a flat push
        loop would serialize on the root's NIC.

        The subtree rides IN the push itself (push_begin relay_targets):
        each level starts forwarding after its first received chunk
        (cut-through), so end-to-end latency is O(size + depth × chunk)
        instead of the old store-and-forward O(depth × size)."""
        object_id = req["object_id"]
        targets = list(req.get("targets", []))
        timeout = req.get("timeout", 300.0)
        if not self.store.contains(object_id):
            # contains() is sealed-only on purpose: an unsealed entry (a
            # rival inbound session that may yet be aborted) must not make
            # us skip the pull and then block forever in push's store.get.
            await self._pull_object(object_id, timeout=timeout)
        from ray_tpu_torch._private.push_manager import subtree_node_ids

        splits = _binomial_split(targets)
        results = await asyncio.gather(
            *(
                self.push_manager.push(
                    object_id,
                    child["node_id"],
                    child["address"],
                    relay_targets=subtree,
                    timeout=timeout,
                )
                for child, subtree in splits
            ),
            return_exceptions=True,
        )
        failed: list[str] = []
        for (child, subtree), r in zip(splits, results):
            if isinstance(r, BaseException):
                failed.extend(subtree_node_ids(child, subtree))
            elif not r.get("ok"):
                failed.extend(r.get("failed") or [child["node_id"]])
        return {"ok": not failed, "failed": failed}

    async def _pull_object(self, object_id: str, timeout: float | None):
        """Fetch a remote object into the local store (pull_manager.py:
        pipelined chunk requests striped across every known replica, ranked
        failover, and an aggregate admission byte budget)."""
        await self.pull_manager.pull(object_id, timeout)

    def _peer(self, node_id: str, address) -> RpcClient:
        client = self._peer_clients.get(node_id)
        if client is None:
            client = RpcClient(tuple(address), label=f"peer-{node_id[:8]}")
            self._peer_clients[node_id] = client
        return client

    # ------------------------------------------------------------------
    # Placement-group bundles (2PC; reference: placement_group_resource_manager.h)
    # ------------------------------------------------------------------

    @property
    def resources_available(self) -> dict:
        """Derived view over the scheduler core's ledger."""
        return {k: self._sched.node_avail(self.node_id, k) for k in self._res_keys}

    @staticmethod
    def _bundle_pool_key(pg_id: str, idx: int) -> str:
        return f"{pg_id}:{max(idx, 0)}"

    async def rpc_prepare_bundle(self, req):
        # 2PC prepare (reference: gcs_placement_group_scheduler.h): the
        # bundle's resources move from the main pool into a reservation.
        key = (req["pg_id"], req["bundle_index"])
        res = req["resources"]
        self._res_keys.update(res)
        if not self._sched.try_acquire(self.node_id, res):
            return {"ok": False}
        self.bundle_reserved[key] = dict(res)
        return {"ok": True}

    async def rpc_commit_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        res = self.bundle_reserved.pop(key, None)
        if res is None:
            return {"ok": False}
        self.bundles[key] = dict(res)
        self._sched.pool_upsert(self._bundle_pool_key(*key), res)
        self._requeue_infeasible()  # tasks waiting on this bundle's pool
        await self._dispatch()
        return {"ok": True}

    async def rpc_return_bundle(self, req):
        key = (req["pg_id"], req["bundle_index"])
        res = self.bundle_reserved.pop(key, None)
        committed = self.bundles.pop(key, None)
        if committed is not None:
            self._sched.pool_remove(self._bundle_pool_key(*key))
            res = committed
        if res:
            self._sched.release(self.node_id, res)
        return {"ok": True}

    # ------------------------------------------------------------------
    # Scheduling (reference: ClusterTaskManager + LocalTaskManager)
    # ------------------------------------------------------------------

    @schema(spec=dict)
    async def rpc_submit_task(self, req):
        spec = TaskSpec.from_wire(req["spec"])
        await self._queue_and_schedule(spec)
        return {"ok": True}

    @schema(task_ids=list)
    async def rpc_locate_tasks(self, req):
        """Which of these task ids does THIS raylet currently hold (queued,
        infeasible, or executing on a worker)? Owners sweep this across
        alive nodes to find tasks orphaned by server-side spillback: a spec
        forwarded to a node that died with it is held by NOBODY, and
        without the sweep the owner would wait on its returns forever
        (a node killed mid-run takes its queued tasks with it)."""
        wanted = set(req["task_ids"])
        found = [tid for tid in self._forwarding if tid in wanted]
        for q in (self.task_queue, self._infeasible):
            for spec in q:
                if spec.task_id in wanted:
                    found.append(spec.task_id)
        for w in self.workers.values():
            cur = w.current_task
            if cur is not None and cur.task_id in wanted:
                found.append(cur.task_id)
            # Leased workers execute owner-shipped specs the raylet does not
            # see; the lease manager owns THOSE tasks' failover, and the
            # owner's sweep excludes lease-path tasks entirely.
        return {"found": found}

    # ---- task cancellation (reference: node_manager.cc HandleCancelTask +
    # cluster_task_manager.cc CancelTask) ----

    @schema(task_id=str)
    async def rpc_cancel_task(self, req):
        """Cancel a task wherever this raylet can see it: dequeue if queued
        locally, forward to the executing worker if dispatched, else
        tombstone (drop on late arrival) and fan out to peers once — a
        spillback may have moved the task off this node."""
        task_id = req["task_id"]
        for q in (self.task_queue, self._infeasible):
            for spec in q:
                if spec.task_id == task_id:
                    q.remove(spec)
                    return {"found": True, "dequeued": True}
        for worker in self.workers.values():
            spec = worker.current_task
            if spec is not None and spec.task_id == task_id and worker.client is not None:
                try:
                    await worker.client.acall(
                        "cancel_exec",
                        {
                            "task_id": task_id,
                            "force": bool(req.get("force")),
                            "recursive": req.get("recursive", True),
                        },
                        timeout=10,
                    )
                except Exception:
                    pass  # worker death surfaces via the normal failure path
                return {"found": True, "dequeued": False}
        self._tombstone_cancel(task_id)
        if req.get("fanout", True):
            # Probe all peers CONCURRENTLY: sequential probes with a 10s
            # timeout each could exceed the owner's single 30s cancel
            # budget as soon as a few peers are unreachable — gather bounds
            # the whole fan-out to ~one timeout.
            peers = [
                (nid, node)
                for nid, node in list(self.cluster_view.items())
                if nid != self.node_id  # already searched locally above
            ]
            if peers:
                results = await asyncio.gather(
                    *(
                        self._peer(nid, node["address"]).acall(
                            "cancel_task", dict(req, fanout=False), timeout=10
                        )
                        for nid, node in peers
                    ),
                    return_exceptions=True,
                )
                for resp in results:
                    if isinstance(resp, dict) and resp.get("found"):
                        return resp
        return {"found": False, "dequeued": False}

    def _tombstone_cancel(self, task_id: str):
        self._cancelled_tasks.add(task_id)

    @schema(specs=list)
    async def rpc_submit_tasks(self, req):
        """Batched submission: one RPC for a burst of specs (client-side
        coalescing in core_worker._flush_submits). Dispatch runs ONCE for
        the whole batch, and the loop yields periodically so a deep burst
        can't starve heartbeats. Failures are PER SPEC — earlier specs are
        already queued and will run, so failing the whole batch client-side
        would report errors for tasks that execute anyway."""
        failed = []
        for i, wire in enumerate(req["specs"]):
            try:
                spec = TaskSpec.from_wire(wire)
                await self._queue_and_schedule(spec, dispatch=False)
            except Exception as e:  # noqa: BLE001
                failed.append({"task_id": wire.get("task_id"), "error": repr(e)})
            if i % 200 == 199:
                await asyncio.sleep(0)
        await self._dispatch()
        return {"ok": True, "failed": failed}

    async def _queue_and_schedule(self, spec: TaskSpec, dispatch: bool = True):
        if spec.placement_group_id and not self._has_pool(spec):
            # Bundle lives elsewhere: ask GCS for its node and forward there.
            resp = await self.gcs.acall(
                "get_placement_group", {"pg_id": spec.placement_group_id}
            )
            if resp.get("found"):
                idx = max(spec.placement_group_bundle_index, 0)
                bundle_nodes = resp["info"]["bundle_nodes"]
                target_node = bundle_nodes[idx] if idx < len(bundle_nodes) else None
                if target_node and target_node != self.node_id:
                    node = self.cluster_view.get(target_node)
                    if node is not None:
                        await self._peer(target_node, node["address"]).acall(
                            "submit_task", {"spec": spec.to_wire()}
                        )
                        return
            # Bundle not placed yet: queue; dispatch retries as views update.
            self.task_queue.append(spec)
            if dispatch:
                await self._dispatch()
            return
        target = self._pick_node(spec, prefer=await self._locality_prefs(spec))
        if target is not None and target != self.node_id:
            # Spillback (reference: cluster_task_manager.cc:44 + spillback reply).
            node = self.cluster_view.get(target)
            if node is not None:
                # Optimistically debit the peer's MIRRORED availability: a
                # burst of picks would otherwise all score the same stale
                # fits-now peer and dogpile it. The debit is provisional —
                # an authoritative heartbeat row overwrites it, and the
                # debit ledger credits it back if none ever arrives.
                if self._sched.try_acquire(target, spec.resources):
                    self._opt_debits.note(
                        target, spec.resources, self.cfg.heartbeat_interval_s
                    )
                self._forwarding.add(spec.task_id)
                try:
                    await self._peer(target, node["address"]).acall("submit_task", {"spec": spec.to_wire()})
                    return
                except Exception:
                    pass
                finally:
                    self._forwarding.discard(spec.task_id)
        self.task_queue.append(spec)
        if dispatch:
            await self._dispatch()

    def _has_pool(self, spec: TaskSpec) -> bool:
        """Does the pool this task draws from exist locally?"""
        if spec.placement_group_id:
            return self._sched.pool_exists(
                self._bundle_pool_key(
                    spec.placement_group_id, spec.placement_group_bundle_index
                )
            )
        return True

    def _fits_now(self, spec: TaskSpec) -> bool:
        """Non-mutating fit check (the event loop is single-threaded, so
        check-then-acquire cannot race)."""
        if spec.placement_group_id:
            key = self._bundle_pool_key(
                spec.placement_group_id, spec.placement_group_bundle_index
            )
            get = lambda k: self._sched.pool_avail(key, k)  # noqa: E731
        else:
            get = lambda k: self._sched.node_avail(self.node_id, k)  # noqa: E731
        return all(get(k) >= v - 1e-9 for k, v in spec.resources.items())

    def _acquire_for(self, spec: TaskSpec) -> bool:
        self._res_keys.update(spec.resources)
        if spec.placement_group_id:
            return self._sched.pool_try_acquire(
                self._bundle_pool_key(
                    spec.placement_group_id, spec.placement_group_bundle_index
                ),
                spec.resources,
            )
        return self._sched.try_acquire(self.node_id, spec.resources)

    def _requeue_infeasible(self):
        """Move parked tasks back into the dispatch queue (capacity or the
        cluster view changed, so their fit must be re-evaluated)."""
        if self._infeasible:
            self.task_queue.extend(self._infeasible)
            self._infeasible.clear()

    def _release_for(self, spec: TaskSpec):
        if spec.placement_group_id:
            key = self._bundle_pool_key(
                spec.placement_group_id, spec.placement_group_bundle_index
            )
            if self._sched.pool_exists(key):
                self._sched.pool_release(key, spec.resources)
        else:
            self._sched.release(self.node_id, spec.resources)
        self._requeue_infeasible()

    def _pick_node(self, spec: TaskSpec, prefer: list | None = None) -> str | None:
        """Cluster-level placement: hybrid pack-then-spread policy
        (reference: policy/hybrid_scheduling_policy.h:50), with an optional
        locality preference list (holder nodes of the task's reference args,
        best-first) tried ahead of the policy — spilling to the policy's
        least-loaded choice when every holder is saturated."""
        strategy = spec.scheduling_strategy or "DEFAULT"
        if spec.placement_group_id:
            return self.node_id if self._has_pool(spec) else self._pg_bundle_node(spec)
        if strategy.startswith("node:"):
            parts = strategy.split(":")
            node_id = parts[1]
            soft = len(parts) > 2 and parts[2] == "soft"
            if node_id == self.node_id or node_id in self.cluster_view:
                return node_id
            return self.node_id if soft else None
        from ray_tpu_torch._private.sched_core import HYBRID, SPREAD

        if prefer:
            for nid in prefer:
                if nid == self.node_id:
                    if self._fits_now(spec):
                        self._note_locality_hit(spec, nid)
                        return nid
                elif nid in self.cluster_view and self._sched.node_fits(
                    nid, spec.resources
                ):
                    self._note_locality_hit(spec, nid)
                    return nid
        # Both policies score over the core's cluster view (local ledger is
        # live; peers mirrored from heartbeats). Hybrid = pack the local node
        # while it fits now, spill to a fits-now peer, else queue wherever
        # the shape is at least feasible by totals (local preferred) —
        # reference policy/hybrid_scheduling_policy.h:50.
        policy = SPREAD if strategy == "SPREAD" else HYBRID
        return self._sched.best_node(spec.resources, policy, self.node_id)

    def _note_locality_hit(self, spec: TaskSpec, nid: str):
        flight_recorder.record("locality_hit", f"{spec.task_id[:8]}->{nid[:8]}")
        try:
            self._metrics["locality_hits"].inc()
        except Exception:
            pass

    async def _locality_prefs(self, spec: TaskSpec) -> list | None:
        """Holder nodes of the task's reference args, most-args-held first;
        None when locality doesn't apply (disabled, constrained strategy,
        single-node view, or no reference args)."""
        if not self.cfg.locality_aware_scheduling or spec.placement_group_id:
            return None
        if (spec.scheduling_strategy or "DEFAULT") != "DEFAULT":
            return None
        if len(self.cluster_view) <= 1:
            return None
        counts = await self._arg_locality.holders(spec)
        if not counts:
            return None
        return sorted(counts, key=lambda n: -counts[n])

    def _pg_bundle_node(self, spec: TaskSpec) -> str | None:
        # Bundle lives on another node; ask GCS which.
        return None  # handled by core_worker resolving bundle location up front

    def _self_view(self):
        return {
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "address": list(self.address),
        }

    async def _dispatch(self):
        """Local dispatch loop (reference: local_task_manager.cc:101).

        The inner scan is CAPPED per call: with a deep backlog (the
        100k+-queued-tasks envelope) an uncapped pass would walk the whole
        deque on every submission — O(n) per submit, O(n^2) for a burst —
        starving the event loop until the GCS health checker declares the
        node dead. Tasks that can't run yet move to self._infeasible (not
        back into the scan window), so repeated capped calls make monotonic
        progress through the queue; _requeue_infeasible() splices them back
        when capacity or the cluster view changes.
        """
        made_progress = True
        while made_progress and self.task_queue:
            made_progress = False
            for _ in range(min(len(self.task_queue), 128)):
                spec = self.task_queue.popleft()
                if spec.task_id in self._cancelled_tasks:
                    # Cancelled before it arrived here; the owner already
                    # failed it with TaskCancelledError.
                    self._cancelled_tasks.discard(spec.task_id)
                    made_progress = True
                    continue
                if self._must_reroute(spec):
                    # Wrong node for this task; the heartbeat loop re-routes it
                    # once the cluster view / PG placement catches up.
                    self._infeasible.append(spec)
                    continue
                if not self._has_pool(spec) or not self._fits_now(spec):
                    self._infeasible.append(spec)
                    continue
                spec_env_hash = _worker_key(spec.runtime_env, getattr(spec, "language", "py"))
                worker = self._pop_idle_worker(spec_env_hash)
                if worker is None:
                    # Start enough workers for the whole backlog at once
                    # (reference prestarts workers too, worker_pool.cc:426);
                    # spawning serially would add one startup latency per task.
                    starting = sum(1 for w in self.workers.values() if w.state == "starting")
                    starting_matching = sum(
                        1
                        for w in self.workers.values()
                        if w.state == "starting" and w.runtime_env_hash == spec_env_hash
                    )
                    # Workers dedicated to actors never come back to the pool;
                    # only count pool workers against the CPU-sized target.
                    pool_workers = sum(
                        1 for w in self.workers.values() if w.state in ("starting", "idle", "busy")
                    )
                    cpu_cap = max(1, int(self.resources_total.get("CPU", 1)))
                    deficit = min(
                        len(self.task_queue) + 1 - starting,
                        cpu_cap - pool_workers,
                        self.cfg.max_workers_per_node - self._num_live_workers(),
                    )
                    if deficit <= 0 and starting_matching == 0:
                        # Pool is full but no worker for THIS runtime env is
                        # idle or coming: evict one surplus idle worker of a
                        # different env to make room (reference: worker_pool
                        # kills idle workers of other envs under pressure).
                        victim = next(
                            (
                                w
                                for w in self.workers.values()
                                if w.state == "idle" and w.runtime_env_hash != spec_env_hash
                            ),
                            None,
                        )
                        if victim is not None:
                            victim.state = "dead"
                            if victim.proc is not None:
                                victim.proc.terminate()
                            deficit = 1
                    if (
                        deficit <= 0
                        and starting == 0
                        and self._num_live_workers() < self.cfg.max_workers_per_node
                        and time.monotonic() - self._last_progress > 2.0
                    ):
                        # Anti-starvation: busy workers may themselves be
                        # blocked on results of queued tasks (nested tasks);
                        # after 2s without dispatch progress, oversubscribe.
                        deficit = 1
                    # Start workers dedicated to the runtime envs of the
                    # tasks actually waiting (head of queue first). Only the
                    # first `deficit` entries are needed — materializing the
                    # whole queue here cost O(n) per submission at depth.
                    import itertools

                    pending_envs = [(spec.runtime_env, getattr(spec, "language", "py"))] + [
                        (s.runtime_env, getattr(s, "language", "py"))
                        for s in itertools.islice(self.task_queue, max(deficit, 0))
                    ]
                    for i in range(max(deficit, 0)):
                        env_i, lang_i = (
                            pending_envs[i] if i < len(pending_envs) else (None, "py")
                        )
                        self._start_worker(env_i, lang_i)
                    self.task_queue.appendleft(spec)
                    return
                if not self._acquire_for(spec):
                    # Should not happen (single-threaded loop; _fits_now was
                    # true) — requeue defensively rather than leak a worker.
                    worker.state = "idle"
                    self.task_queue.append(spec)
                    continue
                if spec.lease_id:
                    self._grant_lease(worker, spec)
                    made_progress = True
                    self._last_progress = time.monotonic()
                    continue
                worker.state = "actor" if spec.is_actor_creation() else "busy"
                worker.current_task = spec
                worker.dispatch_ts = time.monotonic()
                worker.last_job_id = spec.job_id
                worker.last_task_name = spec.name
                if spec.is_actor_creation():
                    worker.actor_id = spec.actor_id
                made_progress = True
                self._last_progress = time.monotonic()
                asyncio.ensure_future(self._push_to_worker(worker, spec))

    async def _push_to_worker(self, worker: WorkerHandle, spec: TaskSpec):
        try:
            await worker.client.acall(
                "push_task",
                {"spec": spec.to_wire(), "assigned_resources": spec.resources},
            )
        except Exception:
            logger.exception("push_task to worker %s failed", worker.worker_id[:8])
            await self._on_worker_death(worker, "push_task failed")

    # ---- worker leases (reference: direct_task_transport.cc:304) ----

    def _grant_lease(self, worker: WorkerHandle, spec: TaskSpec):
        fut = self._lease_futures.pop(spec.lease_id, None)
        if fut is None or fut.done():
            # Requester gave up (cancel or timeout) before we could grant.
            self._release_for(spec)
            worker.state = "idle"
            worker.last_idle = time.monotonic()
            return
        worker.state = "busy"
        worker.current_task = spec
        worker.dispatch_ts = time.monotonic()
        worker.last_job_id = spec.job_id
        worker.last_task_name = "__lease__"
        self._leases[spec.lease_id] = {
            "worker_id": worker.worker_id,
            "spec": spec,
            "renewed": time.monotonic(),
        }
        fut.set_result(
            {
                "granted": True,
                "worker_id": worker.worker_id,
                "address": list(worker.address),
                # Spilled grants come from a PEER raylet: renew/return must
                # target the raylet that actually holds the lease record.
                "raylet_address": list(self.address),
            }
        )

    @schema(spec=dict)
    async def rpc_request_worker_lease(self, req):
        spec = TaskSpec.from_wire(req["spec"])
        if not spec.lease_id:
            return {"granted": False, "error": "spec.lease_id missing"}
        # Cluster-level placement for the lease itself (reference: the lease
        # request is what spills back, cluster_task_manager.cc:44): forward
        # the whole request — the granted worker address is globally
        # routable, so the owner talks straight to the remote worker. The
        # lease spec carries the first task's args, so locality preference
        # applies here too (the default transport).
        target = self._pick_node(spec, prefer=await self._locality_prefs(spec))
        if target is not None and target != self.node_id:
            node = self.cluster_view.get(target)
            if node is not None:
                try:
                    return await self._peer(target, node["address"]).acall(
                        "request_worker_lease",
                        req,
                        timeout=self.cfg.worker_lease_timeout_s + 5,
                    )
                except Exception:
                    pass
        # Owner-side queue depth as autoscaler demand (the owner's shape
        # queue replaces the raylet task queue under the lease transport).
        self._lease_demand[(spec.owner_worker_id, tuple(sorted(spec.resources.items())))] = (
            int(req.get("backlog", 0)),
            time.monotonic(),
        )
        fut = asyncio.get_event_loop().create_future()
        self._lease_futures[spec.lease_id] = fut
        self.task_queue.append(spec)
        await self._dispatch()
        try:
            return await asyncio.wait_for(fut, self.cfg.worker_lease_timeout_s)
        except asyncio.TimeoutError:
            self._lease_futures.pop(spec.lease_id, None)
            self._remove_queued_lease(spec.lease_id)
            return {"granted": False}

    def _remove_queued_lease(self, lease_id: str):
        """Best-effort: at envelope queue depths (1M+) an O(n) walk per
        abandoned lease request would stall the loop; the dispatch path
        already frees workers granted to a vanished requester
        (_grant_lease's missing-future branch), so deep queues self-heal."""
        if len(self.task_queue) + len(self._infeasible) > 10_000:
            return
        for q in (self.task_queue, self._infeasible):
            for s in list(q):
                if s.lease_id == lease_id:
                    q.remove(s)

    @schema(lease_id=str)
    async def rpc_cancel_lease_request(self, req):
        fut = self._lease_futures.pop(req["lease_id"], None)
        if fut is not None and not fut.done():
            fut.set_result({"granted": False})
        self._remove_queued_lease(req["lease_id"])
        return {"ok": True}

    @schema(lease_id=str)
    async def rpc_return_worker_lease(self, req):
        lease = self._leases.pop(req["lease_id"], None)
        if lease is None:
            return {"ok": False}
        worker = self.workers.get(lease["worker_id"])
        spec = lease["spec"]
        # A returned lease means the owner's queue for this shape drained.
        self._lease_demand.pop(
            (spec.owner_worker_id, tuple(sorted(spec.resources.items()))), None
        )
        self._release_for(spec)
        if worker is not None and worker.state == "busy":
            worker.state = "idle"
            worker.current_task = None
            worker.last_idle = time.monotonic()
        await self._dispatch()
        return {"ok": True}

    @schema(lease_ids=list)
    async def rpc_renew_worker_leases(self, req):
        now = time.monotonic()
        revoked = []
        for lid in req["lease_ids"]:
            lease = self._leases.get(lid)
            if lease is None:
                revoked.append(lid)
            else:
                lease["renewed"] = now
        # Per-shape backlog refresh piggybacked on renewal: keeps the
        # autoscaler's demand view live while leases are held warm (the
        # request-time backlog figure is otherwise frozen for the lease's
        # whole lifetime).
        owner = req.get("owner")
        if owner:
            for res, count in req.get("backlogs") or []:
                key = (owner, tuple(sorted(res.items())))
                if count:
                    self._lease_demand[key] = (int(count), now)
                else:
                    self._lease_demand.pop(key, None)
        return {"revoked": revoked}

    def _pop_idle_worker(self, runtime_env_hash: str | None = None) -> WorkerHandle | None:
        for w in self.workers.values():
            if w.state == "idle" and w.runtime_env_hash == runtime_env_hash:
                return w
        return None

    def _num_live_workers(self) -> int:
        return sum(1 for w in self.workers.values() if w.state != "dead")

    # ---- worker pool (reference: worker_pool.cc) ----

    def _worker_env_delta(self, worker_id: str, runtime_env: dict | None) -> dict:
        """The env vars a worker needs on top of this raylet's environment."""
        delta = {
            "RAY_TPU_TORCH_WORKER_ID": worker_id,
            "RAY_TPU_TORCH_NODE_ID": self.node_id,
            "RAY_TPU_TORCH_RAYLET_ADDR": json.dumps(list(self.address)),
            "RAY_TPU_TORCH_GCS_ADDR": json.dumps(list(self.gcs.address)),
            "RAY_TPU_TORCH_ARENA_NAME": self.arena_name,
            "RAY_TPU_TORCH_SESSION_DIR": self.session_dir,
        }
        if runtime_env:
            delta["RAY_TPU_TORCH_RUNTIME_ENV"] = json.dumps(runtime_env)
        if self._tracing_enabled:
            delta["RAY_TPU_TORCH_TRACING"] = "1"
        # Workers must import the same modules the driver pickles by reference
        # (cloudpickle serializes importable functions by name); ship the
        # driver-side sys.path (reference: runtime-env py_modules/working_dir).
        extra_path = os.pathsep.join(p for p in sys.path if p)
        base = os.environ.get("PYTHONPATH")
        delta["PYTHONPATH"] = extra_path + os.pathsep + base if base else extra_path
        return delta

    def _zygote_client(self):
        """Lazy fork-server handle (zygote.py). None when disabled or on GPU
        nodes — a GPU worker initialises CUDA, which a forked child of a
        process that touched CUDA cannot, so GPU nodes spawn fresh processes
        (GPU workers are few and long-lived anyway)."""
        if not self.cfg.worker_zygote_enabled or self.resources_total.get("GPU"):
            return None
        if getattr(self, "_zygote", None) is None:
            from ray_tpu_torch._private.zygote import ZygoteClient

            base_env = os.environ.copy()
            # The zygote imports ray_tpu_torch at startup: it needs the driver's
            # sys.path just like workers do (the driver may have added the
            # package root via sys.path.insert, not PYTHONPATH).
            extra_path = os.pathsep.join(p for p in sys.path if p)
            base_env["PYTHONPATH"] = (
                extra_path + os.pathsep + base_env["PYTHONPATH"]
                if base_env.get("PYTHONPATH")
                else extra_path
            )
            self._zygote = ZygoteClient(
                self.session_dir, base_env, self._on_zygote_worker_exit
            )
        return self._zygote

    def _on_zygote_worker_exit(self, pid: int, returncode: int):
        from ray_tpu_torch._private.zygote import ZygoteWorkerProc

        for w in self.workers.values():
            if w.pid == pid and isinstance(w.proc, ZygoteWorkerProc):
                w.proc.returncode = returncode

    def _start_worker(self, runtime_env: dict | None = None, language: str = "py"):
        worker_id = WorkerID.from_random().hex()
        delta = self._worker_env_delta(worker_id, runtime_env)
        log_path = os.path.join(self.session_dir, "logs", f"worker-{worker_id[:8]}")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        handle = WorkerHandle(
            worker_id=worker_id,
            pid=0,
            runtime_env_hash=_worker_key(runtime_env, language),
        )
        self.workers[worker_id] = handle
        if language == "cpp":
            raise NotImplementedError(
                "C++ workers are not ported (ROADMAP A5, what remains)"
            )
        zygote = self._zygote_client()
        if zygote is not None:
            asyncio.ensure_future(
                self._spawn_via_zygote(zygote, handle, delta, log_path)
            )
        else:
            self._popen_worker(handle, delta, log_path)

    def _popen_worker(self, handle: WorkerHandle, delta: dict, log_path: str):
        """Spawn a fresh Python worker process."""
        env = os.environ.copy()
        env.update(delta)
        stdout = open(log_path + ".out", "ab")
        stderr = open(log_path + ".err", "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env,
            stdout=stdout,
            stderr=stderr,
            cwd=os.getcwd(),
        )
        handle.proc = proc
        handle.pid = proc.pid

    async def _spawn_via_zygote(self, zygote, handle: WorkerHandle, delta: dict, log_path: str):
        from ray_tpu_torch._private.zygote import ZygoteWorkerProc

        try:
            pid = await zygote.spawn(delta, log_path + ".out", log_path + ".err")
        except Exception:
            logger.exception("zygote spawn failed; falling back to subprocess")
            if handle.state == "dead":
                return
            # The fork may have succeeded with the reply lost or late (zygote
            # died post-fork, wait timeout): retire this worker id and give
            # the Popen replacement a fresh one, so an orphan child that
            # registers late can't collide with the replacement. A late
            # spawn reply for the abandoned req_id kills the orphan pid
            # (ZygoteClient._read_loop).
            self.workers.pop(handle.worker_id, None)
            self._retired_worker_ids.add(handle.worker_id)
            fresh_id = WorkerID.from_random().hex()
            handle.worker_id = fresh_id
            self.workers[fresh_id] = handle
            self._popen_worker(
                handle, dict(delta, RAY_TPU_TORCH_WORKER_ID=fresh_id), log_path
            )
            return
        handle.pid = pid
        handle.proc = ZygoteWorkerProc(pid)
        if handle.state == "dead":
            # Killed while the fork was in flight (eviction/stop).
            handle.proc.kill()

    @schema(worker_id=str, pid=int, address=list)
    async def rpc_register_worker(self, req):
        worker_id = req["worker_id"]
        if worker_id in self._retired_worker_ids:
            # An orphan from an abandoned zygote spawn (we already Popen'd a
            # replacement under a fresh id): tell it to exit, and reap it
            # shortly after in case it doesn't (it is a local process).
            pid = req["pid"]

            def _reap():
                try:
                    os.kill(pid, 9)
                except (ProcessLookupError, PermissionError):
                    pass

            asyncio.get_event_loop().call_later(2.0, _reap)
            return {"ok": False, "reason": "retired worker id"}
        handle = self.workers.get(worker_id)
        if handle is None:
            handle = WorkerHandle(worker_id=worker_id, pid=req["pid"])
            self.workers[worker_id] = handle
        handle.address = tuple(req["address"])
        handle.client = RpcClient(handle.address, label=f"worker-{worker_id[:8]}")
        handle.state = "idle"
        handle.last_idle = time.monotonic()
        await self._dispatch()
        return {"ok": True, "node_id": self.node_id}

    @schema(worker_id=str)
    async def rpc_task_finished(self, req):
        """Worker reports completion; release resources + lease for reuse."""
        worker = self.workers.get(req["worker_id"])
        if worker is None:
            return {"ok": False}
        spec = worker.current_task
        if spec is not None:
            self._release_for(spec)
        worker.current_task = None
        if worker.state == "busy":
            worker.state = "idle"
            worker.last_idle = time.monotonic()
        await self._dispatch()
        return {"ok": True}

    async def rpc_actor_ready(self, req):
        """Actor finished __init__; keep the worker dedicated but free to serve."""
        worker = self.workers.get(req["worker_id"])
        if worker is not None:
            worker.actor_spec = worker.current_task
            worker.current_task = None
        return {"ok": True}

    async def _reap_loop(self):
        """Monitor worker processes; report deaths (reference: worker failure path)."""
        while True:
            await asyncio.sleep(0.2)
            self._reap_stale_push_sessions()
            for worker in list(self.workers.values()):
                if worker.state == "dead":
                    continue
                if worker.proc is not None and worker.proc.poll() is not None:
                    await self._on_worker_death(
                        worker,
                        "worker killed by the node memory monitor (node memory "
                        "usage exceeded the threshold)"
                        if worker.oom_killed
                        else f"worker process exited with code {worker.proc.returncode}",
                        oom=worker.oom_killed,
                    )
            # Abort unsealed store entries orphaned by a producer killed
            # between create and seal (active push/pull sessions exempt).
            try:
                self.store.reap_orphaned_unsealed(
                    60.0,
                    exclude=set(self._inbound_pushes)
                    | self.pull_manager.inflight_ids(),
                )
            except Exception:
                pass
            # Expire leases whose owner stopped renewing (owner process died
            # without returning them): reclaim the worker via the death path
            # so resource release and owner notification stay in one place.
            now = time.monotonic()
            for lid, lease in list(self._leases.items()):
                if now - lease["renewed"] > self.cfg.worker_lease_timeout_s + 15:
                    worker = self.workers.get(lease["worker_id"])
                    logger.warning("lease %s expired; reclaiming worker", lid[:8])
                    self._leases.pop(lid, None)
                    if worker is not None and worker.proc is not None:
                        worker.proc.kill()
            # Memory pressure: kill a task worker if the node is over the
            # threshold (reference: memory_monitor + worker killing policy).
            if time.monotonic() - self._last_memory_check >= self.cfg.memory_monitor_interval_s:
                self._last_memory_check = time.monotonic()
                try:
                    self._memory_monitor.tick()
                except Exception:
                    logger.debug("memory monitor tick failed", exc_info=True)
            # Scale down long-idle workers beyond the prestart floor.
            now = time.monotonic()
            idle = [w for w in self.workers.values() if w.state == "idle"]
            for w in idle[self.cfg.prestart_workers:] if len(idle) > self.cfg.prestart_workers else []:
                if now - w.last_idle > self.cfg.worker_idle_timeout_s:
                    w.state = "dead"
                    if w.proc is not None:
                        w.proc.terminate()

    async def _on_worker_death(self, worker: WorkerHandle, reason: str, oom: bool = False):
        if worker.state == "dead":
            return
        prev_state = worker.state
        worker.state = "dead"
        spec = worker.current_task
        flight_recorder.record(
            "worker_death", f"{worker.worker_id[:8]}:{reason[:60]}"
        )
        logger.warning("worker %s died: %s", worker.worker_id[:8], reason)
        for held in self._store_holds.pop(worker.pid, {}).values():
            self._release_hold(*held)
        if worker.actor_spec is not None:
            # Release the actor's lifetime resource hold.
            self._release_for(worker.actor_spec)
            worker.actor_spec = None
        if spec is not None and spec.lease_id:
            # Leased worker: the owner tracks which specs were in flight on
            # it — revoke so it fails them over (lease_manager._lease_failed).
            self._release_for(spec)
            self._leases.pop(spec.lease_id, None)
            if spec.owner_addr:
                try:
                    owner = RpcClient(tuple(spec.owner_addr), label="lease-owner")
                    await owner.acall(
                        "lease_revoked",
                        {"lease_id": spec.lease_id, "oom": bool(oom), "reason": reason},
                    )
                    owner.close()
                except Exception:
                    pass
        elif spec is not None:
            self._release_for(spec)
            # Tell the owner so it can retry (reference: task_manager.h:335).
            if spec.owner_addr:
                owner = None
                try:
                    owner = RpcClient(tuple(spec.owner_addr), label="owner")
                    # Per-attempt timeout, retries KEPT (acall retries
                    # TimeoutError/ConnectionLost): losing this notification
                    # hangs the owner's wait() forever, so transient owner
                    # stalls (load on a small box) must be retried —
                    # a single 5s shot dropped deaths and deadlocked
                    # the owner. Total stays bounded (~20s) against the
                    # recycled-port black hole.
                    await owner.acall(
                        "task_failed",
                        {
                            "task_id": spec.task_id,
                            "error": "OutOfMemoryError" if oom else "WorkerCrashedError",
                            "message": reason,
                            "retriable": True,
                        },
                        timeout=5,
                    )
                except Exception:
                    pass
                finally:
                    if owner is not None:
                        owner.close()  # failed-delivery path must not leak
        if prev_state == "actor" and worker.actor_id:
            try:
                await self.gcs.acall(
                    "report_worker_death",
                    {
                        "actor_ids": [worker.actor_id],
                        "reason": reason,
                        "worker_id": worker.worker_id,
                    },
                )
            except Exception:
                pass
        worker.current_task = None
        await self._dispatch()

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    async def rpc_debug_dump(self, req):
        """Node-wide flight-recorder dump: every ring in this session's
        flight dir — live processes write through their mmap, and a
        SIGKILLed worker's file still holds its final events, which is the
        whole postmortem story. File scan runs off-loop (it is disk I/O)."""
        loop = asyncio.get_event_loop()
        processes = await loop.run_in_executor(
            None, flight_recorder.collect_dir, self.session_dir
        )
        return {"node_id": self.node_id, "processes": processes}

    async def rpc_get_state(self, req):
        return {
            "node_id": self.node_id,
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": self._num_live_workers(),
            "queued_tasks": len(self.task_queue) + len(self._infeasible),
            "store": {**self.store.usage(), "objects": self.store.objects_info()},
            "workers": {
                wid: {"state": w.state, "pid": w.pid, "actor_id": w.actor_id}
                for wid, w in self.workers.items()
            },
        }

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        self._hb_task.cancel()
        self._reap_task.cancel()
        self._log_monitor_task.cancel()
        for w in self.workers.values():
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        for w in self.workers.values():
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=2)
                except Exception:
                    w.proc.kill()
        if getattr(self, "_zygote", None) is not None:
            self._zygote.close()
        self.server.stop()
        self.gcs.close()
        for c in self._peer_clients.values():
            c.close()
        self.store.close()
        self._sched.close()


def main():
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}")
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--address-file", default="")
    args = parser.parse_args()
    gcs_addr = json.loads(args.gcs_address)
    raylet = Raylet(
        gcs_addr,
        args.session_dir,
        resources=json.loads(args.resources) or None,
        labels=json.loads(args.labels),
        object_store_memory=args.object_store_memory or None,
        # Standalone process: suicide when the GCS writes us off, so the
        # operator/autoscaler replaces the node (the reference's raylet
        # behavior). In-process raylets rejoin instead — see __init__.
        exit_on_dead=True,
    )
    # Standalone raylet: no CoreWorker will ever exist in this process, so
    # point the metrics flusher at our own GCS client (in-process heads use
    # the driver CoreWorker path instead — setting both would double-export
    # the shared registry under two KV keys).
    from ray_tpu_torch.util.metrics import set_fallback_flush_target

    set_fallback_flush_target(raylet.gcs, raylet.node_id, f"raylet-{raylet.node_id[:12]}")
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"address": list(raylet.address), "node_id": raylet.node_id, "arena": raylet.arena_name}, f)
        os.replace(tmp, args.address_file)
    import threading

    threading.Event().wait()


if __name__ == "__main__":
    main()
