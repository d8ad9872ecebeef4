"""GCS — Global Control Service.

Analog of the reference's GCS server
(src/ray/gcs/gcs_server/gcs_server.cc:119-160): the cluster control plane,
wiring per-domain managers over one RPC server:

- node membership + health checking (gcs_node_manager.h, gcs_health_check_manager.h:39)
- actor lifecycle + restart state machine (gcs_actor_manager.h:281)
- placement groups with 2-phase reserve/commit (gcs_placement_group_manager.h)
- cluster KV store, also the function table (gcs_kv_manager.h, gcs_function_manager.h)
- object directory (reference: ownership-based directory; centralised here —
  ownership_based_object_directory.h — acceptable at the per-pod scale this
  control plane targets, revisit for 2k-node envelopes)
- pub/sub fan-out (src/ray/pubsub/publisher.h:307)
- task-event history (gcs_task_manager.h) powering the state API and timeline
- job table

Storage is in-memory (reference default) with snapshot + write-ahead-log
durability (reference: redis_store_client.h — every committed mutation is
durable before it is acknowledged). Mutating handlers append the changed
table entry to an append-only WAL and flush BEFORE replying; the debounced
snapshot acts as WAL compaction (each snapshot truncates the log). On
restart: load snapshot, then replay the WAL tail — so an acknowledged
mutation survives a GCS kill at any point after the reply.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import time

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.rpc import EventLoopThread, RpcClient, RpcServer, schema
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger(__name__)

# Actor states (reference: src/ray/design_docs/actor_states.rst)
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class GcsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, persist_path: str | None = None):
        self.cfg = get_config()
        self.server = RpcServer("gcs")
        self.server.register_all(self)
        self.persist_path = persist_path

        # Tables.
        self.nodes: dict[str, dict] = {}
        self.actors: dict[str, dict] = {}
        self.named_actors: dict[tuple[str, str], str] = {}  # (namespace, name) -> actor_id
        self.kv: dict[str, bytes] = {}
        self.object_locations: dict[str, set[str]] = {}
        # Reverse index: node_id -> oids it holds. _on_node_death used to
        # scan EVERY location row (O(objects) per death — a fan-in hot spot
        # at 1k nodes); with the index a death touches only that node's rows.
        self._locations_by_node: dict[str, set[str]] = {}
        self.placement_groups: dict[str, dict] = {}
        self.jobs: dict[str, dict] = {}
        # Drop-oldest ring: event fan-in at sim scale must degrade
        # observability (oldest history), never liveness or memory.
        self.task_events: collections.deque = collections.deque(
            maxlen=max(1, self.cfg.task_events_buffer_size)
        )
        self.events_dropped_total = 0
        self._overload_flight_ts = 0.0
        self._job_counter = 0
        # Versioned cluster-view sync (delta heartbeats). Every MATERIAL
        # node-row change (register, death, drain, changed availability)
        # bumps _view_version and stamps the row; a heartbeat carrying the
        # client's last seen version gets only rows newer than it plus
        # removal tombstones. Idle heartbeats don't bump anything, so the
        # steady-state reply is empty — per-interval bytes go from O(N) per
        # raylet (O(N^2) cluster-wide) to O(changes).
        self._view_version = 0
        self._view_removals: collections.deque = collections.deque()
        # Clients whose version predates pruned tombstones get a full-view
        # resync (also covers a GCS restart: versions restart at 0, so a
        # client arriving "from the future" falls back to full view).
        self._removals_floor = 0
        # Heartbeat reply accounting for the scale bench (rows/bytes per
        # reply). Payload measurement costs one msgpack encode per reply, so
        # it is off unless the sim harness turns it on.
        self.hb_account = False
        self.hb_stats = {"replies": 0, "rows": 0, "full_replies": 0, "view_bytes": 0}
        # Bumped by mutating handlers; the persist loop skips unchanged state.
        self._mutations = 0
        self._subscribers: dict[str, list] = {}  # channel -> [writer]
        self._raylet_clients: dict[str, RpcClient] = {}
        # actor_id -> in-flight creation-schedule future (register retries
        # share one schedule; NOT in the actor info dict — that is
        # WAL-persisted and a Future is unserializable).
        self._creation_inflight: dict = {}
        self._io = EventLoopThread.get()
        # Write-ahead log (reference durability bar: redis_store_client.h).
        # Restore + open the WAL BEFORE the server starts accepting: a
        # mutation acknowledged while _wal_file were still None would skip
        # logging, and replay racing live handlers could clobber fresh
        # entries with stale values — both break the "acknowledged means
        # durable" contract documented above.
        self._wal_path = persist_path + ".wal" if persist_path else None
        self._wal_file = None
        self._wal_records = 0
        # Sync policy: batched fdatasync at most once a second (redis
        # appendfsync-everysec class: bounded ~1 s loss on host crash).
        self._wal_dirty = False
        self._wal_dirty_epoch = 0
        restored = False
        if persist_path and os.path.exists(persist_path):
            self._load_snapshot()
            restored = True
        if self._wal_path:
            restored = self._replay_wal() or restored
            # Append mode: replayed records stay until the next snapshot
            # truncates them (replay is idempotent — records are full values).
            self._wal_file = open(self._wal_path, "ab")
        self.server.start(host, port)
        self.address = self.server.address
        self._health_task = self._io.spawn(self._health_check_loop())
        if restored:
            self._io.spawn(self._recover_loaded_actors())
            self._io.spawn(self._recover_loaded_pgs())
        self._persist_task = (
            self._io.spawn(self._persist_loop()) if persist_path else None
        )

    # ------------------------------------------------------------------
    # Nodes & health
    # ------------------------------------------------------------------

    @schema(node_id=str, address=list, resources=dict)
    async def rpc_register_node(self, req):
        self._mutations += 1
        node_id = req["node_id"]
        self.nodes[node_id] = {
            "node_id": node_id,
            "address": req["address"],
            "resources_total": req["resources"],
            "resources_available": dict(req["resources"]),
            "labels": req.get("labels", {}),
            "arena_name": req.get("arena_name", ""),
            "state": "ALIVE",
            "last_heartbeat": time.monotonic(),
            "store_usage": {},
        }
        self._bump_view(node_id)
        await self._publish("node_updates", {"node_id": node_id, "state": "ALIVE"})
        # New capacity may make parked placement groups feasible.
        asyncio.ensure_future(self._retry_pending_pgs())
        return {"ok": True}

    @schema(node_id=str)
    async def rpc_heartbeat(self, req):
        node = self.nodes.get(req["node_id"])
        if node is None:
            # Not "dead" — we may have restarted and lost the (non-persisted)
            # node table; the raylet re-registers and carries on (reference:
            # HandleRayletNotifyGCSRestart, core_worker.cc:3149).
            return {"ok": False, "unknown": True}
        if node["state"] == "DEAD":
            return {"ok": False, "dead": True}
        node["last_heartbeat"] = time.monotonic()
        avail = req.get("resources_available")
        if avail is not None and avail != node["resources_available"]:
            # Material change: peers mirror availability into their local
            # sched_core ledgers, so it must flow. Idle heartbeats (same
            # availability) stamp nothing — the delta reply stays empty.
            node["resources_available"] = avail
            self._bump_view(req["node_id"])
            if any(pg.get("state") == "PENDING" for pg in self.placement_groups.values()):
                # Resources came back (a bundle returned, a worker exited):
                # a parked placement group may fit now (reference:
                # GcsPlacementGroupManager schedules pending groups again
                # when resources change, not only on node join).
                asyncio.ensure_future(self._retry_pending_pgs())
        node["store_usage"] = req.get("store_usage", node["store_usage"])
        node["load"] = req.get("load", [])
        node["num_active_workers"] = req.get("num_active_workers", 0)
        # Return the cluster resource view: this doubles as the resource
        # syncer (reference: src/ray/common/ray_syncer/ray_syncer.h:86).
        resp = {"ok": True, "tracing": bool(self.kv.get("tracing:enabled"))}
        client_ver = req.get("view_version")
        if client_ver is None:
            # Legacy client: full view every interval (O(N) per reply).
            resp["nodes"] = self._cluster_view()
            self._account_hb(resp["nodes"], full=True)
            return resp
        if (
            client_ver == 0
            or client_ver > self._view_version
            or client_ver < self._removals_floor
        ):
            # First contact, a GCS restart (client from the future), or the
            # client missed so many generations its tombstones were pruned:
            # full-view resync.
            resp["view"] = self._cluster_view()
            resp["view_removed"] = []
            resp["view_full"] = True
            self._account_hb(resp["view"], full=True)
        else:
            resp["view"] = {
                nid: self._view_row(n)
                for nid, n in self.nodes.items()
                if n["state"] == "ALIVE" and n.get("view_ver", 0) > client_ver
            }
            resp["view_removed"] = [
                nid for ver, nid in self._view_removals if ver > client_ver
            ]
            resp["view_full"] = False
            self._account_hb(resp["view"], full=False)
        resp["view_version"] = self._view_version
        return resp

    def _view_row(self, n: dict) -> dict:
        return {
            "address": n["address"],
            "resources_total": n["resources_total"],
            "resources_available": n["resources_available"],
            "labels": n["labels"],
            "state": n["state"],
        }

    def _cluster_view(self):
        return {
            nid: self._view_row(n)
            for nid, n in self.nodes.items()
            if n["state"] == "ALIVE"
        }

    def _bump_view(self, node_id: str, removed: bool = False):
        """Stamp one node-row change into the versioned view. ``removed``
        appends a tombstone (death/drain — the row leaves the ALIVE view);
        tombstone history is bounded, with the pruned floor forcing lagging
        clients onto the full-resync path."""
        self._view_version += 1
        if removed:
            self._view_removals.append((self._view_version, node_id))
            while len(self._view_removals) > 1024:
                pruned_ver, _ = self._view_removals.popleft()
                self._removals_floor = pruned_ver
        else:
            node = self.nodes.get(node_id)
            if node is not None:
                node["view_ver"] = self._view_version

    def _account_hb(self, rows: dict, full: bool):
        self.hb_stats["replies"] += 1
        self.hb_stats["rows"] += len(rows)
        if full:
            self.hb_stats["full_replies"] += 1
        if self.hb_account and rows:
            import msgpack

            try:
                self.hb_stats["view_bytes"] += len(
                    msgpack.packb(rows, use_bin_type=True)
                )
            except Exception:
                pass

    async def rpc_get_nodes(self, req):
        return {"nodes": self.nodes}

    async def rpc_runtime_name(self, req):
        """Which runtime this GCS belongs to: the JAX package's GCS speaks the
        same wire protocol, and ``ray_tpu_torch.init(address=...)`` refuses
        any GCS that does not answer with the port's name."""
        return {"runtime": "ray_tpu_torch"}

    @schema(node_id=str, stats=dict)
    async def rpc_report_node_stats(self, req):
        """Per-node dashboard agent report (dashboard/agent.py): host CPU/mem,
        per-worker process stats, accelerator presence."""
        node = self.nodes.get(req["node_id"])
        if node is None:
            return {"ok": False}
        node["stats"] = req.get("stats", {})
        return {"ok": True}

    async def rpc_drain_node(self, req):
        node = self.nodes.get(req["node_id"])
        if node is not None:
            node["state"] = "DRAINING"
            # Leaves the ALIVE view: delta clients must see the removal.
            self._bump_view(req["node_id"], removed=True)
        return {"ok": True}

    async def _health_check_loop(self):
        # Reference: GcsHealthCheckManager (gcs_health_check_manager.h:39).
        while True:
            await asyncio.sleep(self.cfg.heartbeat_interval_s)
            now = time.monotonic()
            for node_id, node in list(self.nodes.items()):
                if node["state"] != "ALIVE":
                    continue
                if now - node["last_heartbeat"] > self.cfg.node_death_timeout_s:
                    await self._on_node_death(node_id)

    async def _on_node_death(self, node_id: str):
        node = self.nodes.get(node_id)
        if node is None or node["state"] == "DEAD":
            return
        node["state"] = "DEAD"
        logger.warning("GCS: node %s declared dead", node_id[:8])
        self._bump_view(node_id, removed=True)
        # Drop its object copies from the directory — via the per-node
        # reverse index: O(rows on the dead node), not O(all rows). The
        # legacy full scan is kept behind the config toggle as the measured
        # baseline arm for the scale bench.
        if self.cfg.gcs_location_index:
            for oid in self._locations_by_node.pop(node_id, set()):
                locs = self.object_locations.get(oid)
                if locs is not None:
                    locs.discard(node_id)
                    if not locs:
                        del self.object_locations[oid]
        else:
            self._locations_by_node.pop(node_id, None)
            for oid, locs in list(self.object_locations.items()):
                locs.discard(node_id)
                if not locs:
                    del self.object_locations[oid]
        # Restart or kill its actors.
        for actor_id, info in list(self.actors.items()):
            if info.get("node_id") == node_id and info["state"] in (ALIVE, PENDING_CREATION):
                await self._handle_actor_failure(actor_id, f"node {node_id[:8]} died")
        await self._publish("node_updates", {"node_id": node_id, "state": "DEAD"})

    # ------------------------------------------------------------------
    # Actors (reference: gcs_actor_manager.h:281 + gcs_actor_scheduler.h)
    # ------------------------------------------------------------------

    async def rpc_register_actor(self, req):
        self._mutations += 1
        spec = TaskSpec.from_wire(req["spec"])
        actor_id = spec.actor_id
        # IDEMPOTENT under at-least-once delivery: owners now retry a
        # register whose reply was lost (bounded per-attempt timeout), and
        # re-running the body would clobber a live actor's state back to
        # PENDING_CREATION and schedule a DUPLICATE creation. Serve the
        # remembered outcome instead; if the first attempt registered but
        # could not schedule, re-drive just the scheduling.
        prior = self.actors.get(actor_id)
        if prior is not None and prior["state"] != DEAD:
            return await self._ensure_creation_scheduled(actor_id)
        if spec.actor_name:
            key = (spec.namespace, spec.actor_name)
            existing = self.named_actors.get(key)
            if existing is not None and self.actors[existing]["state"] != DEAD:
                if spec.get_if_exists:
                    return {"ok": True, "existing": True, "actor_id": existing}
                return {"ok": False, "error": f"actor name {spec.actor_name!r} taken"}
            self.named_actors[key] = actor_id
        self.actors[actor_id] = {
            "actor_id": actor_id,
            "state": PENDING_CREATION,
            "spec": req["spec"],
            "address": None,
            "node_id": None,
            "worker_id": None,
            "name": spec.actor_name,
            "namespace": spec.namespace,
            "num_restarts": 0,
            "max_restarts": spec.max_restarts,
            "death_cause": "",
        }
        self._wal("actors", actor_id)
        if spec.actor_name:
            self._wal("named_actors", (spec.namespace, spec.actor_name))
        return await self._ensure_creation_scheduled(actor_id)

    async def _ensure_creation_scheduled(self, actor_id: str) -> dict:
        """Schedule the creation AT MOST ONCE even under concurrent
        register retries: an owner whose first reply was lost re-enters
        while the first schedule may still be awaiting its raylet ack —
        both must share ONE in-flight schedule (kept OUTSIDE the actor
        info dict: that dict is WAL-persisted and a Future is not
        serializable) instead of racing duplicate creations."""
        info = self.actors[actor_id]
        if info.get("create_scheduled"):
            return {"ok": True, "existing": False, "actor_id": actor_id}
        fut = self._creation_inflight.get(actor_id)
        if fut is None:
            fut = self._creation_inflight[actor_id] = asyncio.ensure_future(
                self._schedule_actor_creation(actor_id)
            )
        try:
            ok = await fut
        finally:
            if self._creation_inflight.get(actor_id) is fut:
                self._creation_inflight.pop(actor_id, None)
        if not ok:
            return {"ok": False, "error": "no feasible node for actor"}
        info["create_scheduled"] = True
        return {"ok": True, "existing": False, "actor_id": actor_id}

    async def _schedule_actor_creation(self, actor_id: str) -> bool:
        """Forward the creation task to a raylet (GcsActorScheduler analog).
        A target that cannot be REACHED (partitioned/resetting — its
        heartbeat may not have lapsed yet) is excluded and the creation
        fails over to the next feasible node: an unreachable first pick
        used to surface as a bogus 'no feasible node' with two healthy
        nodes sitting idle."""
        info = self.actors[actor_id]
        spec = TaskSpec.from_wire(info["spec"])
        tried: set[str] = set()
        for _ in range(3):
            target = self._pick_node_for(spec, exclude=tried)
            if target is None:
                return False
            client = self._raylet_client(target)
            try:
                # Two bounded attempts per node, then fail over (the
                # transport default of 3 retries would turn 10s into ~40s
                # per node and eat the owner's whole register budget inside
                # one pick; zero retries let a single silently-dropped
                # reply burn a healthy node — three drops exhausted the
                # whole candidate list into a bogus 'no feasible node').
                # A PARTITIONED pick still fails over in ~0.2s: its
                # ConnectionLost is fail-fast, only silent drops pay the
                # 10s slice. A reply lost AFTER the raylet accepted can
                # double-submit; the actor_alive incumbent guard resolves
                # that (duplicate worker exits).
                await client.acall(
                    "submit_task", {"spec": info["spec"]}, timeout=10, retries=1
                )
                return True
            except Exception:
                tried.add(target)
                logger.warning(
                    "failed to submit actor creation to node %s; failing over",
                    target[:8],
                )
        return False

    def _pick_node_for(self, spec: TaskSpec, exclude: set | None = None) -> str | None:
        # Least-loaded feasible node.
        best, best_score = None, None
        for node_id, node in self.nodes.items():
            if node["state"] != "ALIVE":
                continue
            if exclude and node_id in exclude:
                continue
            total = node["resources_total"]
            if any(total.get(k, 0) < v for k, v in spec.resources.items()):
                continue
            avail = node["resources_available"]
            score = sum(avail.get(k, 0) / max(total.get(k, 1), 1) for k in ("CPU", "GPU"))
            if best_score is None or score > best_score:
                best, best_score = node_id, score
        return best

    async def rpc_actor_alive(self, req):
        info = self.actors.get(req["actor_id"])
        if info is None:
            return {"ok": False}
        if info.get("state") == ALIVE and info.get("worker_id") not in (None, req.get("worker_id")):
            # A second worker created the same actor (e.g. restart-recovery
            # raced an in-flight creation): the incumbent wins, the duplicate
            # process must exit. Remember it so its death report is ignored
            # even if the incumbent's state changes before the report lands.
            info.setdefault("rejected_workers", []).append(req.get("worker_id"))
            return {"ok": False, "duplicate": True}
        if info.get("state") == DEAD:
            # Killed while its creation was in flight: the worker that has
            # just come up must exit, not revive the actor. Revived, it kept
            # its resources with no handle left to kill it (the reference's
            # GCS has the same fault: ROADMAP C15).
            info.setdefault("rejected_workers", []).append(req.get("worker_id"))
            return {"ok": False, "killed": True}
        self._mutations += 1
        info.update(
            state=ALIVE,
            address=req["address"],
            node_id=req["node_id"],
            worker_id=req.get("worker_id"),
        )
        self._wal("actors", req["actor_id"])
        await self._publish("actor_updates", {"actor_id": req["actor_id"], "state": ALIVE, "address": req["address"]})
        return {"ok": True}

    async def rpc_report_worker_death(self, req):
        """Raylet reports a dead worker and any actor it hosted."""
        self._mutations += 1
        reporter = req.get("worker_id")
        for actor_id in req.get("actor_ids", []):
            info = self.actors.get(actor_id)
            if info is not None and reporter:
                rejected = info.get("rejected_workers") or []
                if reporter in rejected:
                    # A rejected duplicate exiting — expected, regardless of
                    # the incumbent's current state.
                    rejected.remove(reporter)
                    continue
                if (
                    info.get("state") == ALIVE
                    and info.get("worker_id")
                    and info["worker_id"] != reporter
                ):
                    # A different worker than the actor's registered host
                    # died; the incumbent is healthy — ignore.
                    continue
            await self._handle_actor_failure(actor_id, req.get("reason", "worker died"))
        return {"ok": True}

    async def _handle_actor_failure(self, actor_id: str, reason: str):
        info = self.actors.get(actor_id)
        if info is None or info["state"] == DEAD:
            return
        self._mutations += 1
        max_restarts = info["max_restarts"]
        if max_restarts == -1 or info["num_restarts"] < max_restarts:
            info["num_restarts"] += 1
            info["state"] = RESTARTING
            info["address"] = None
            from ray_tpu_torch._private import flight_recorder, self_metrics

            flight_recorder.record(
                "actor_restart", f"{actor_id[:8]}:n={info['num_restarts']}"
            )
            try:
                self_metrics.instruments()["actor_restarts"].inc()
            except Exception:
                pass
            self._wal("actors", actor_id)
            await self._publish("actor_updates", {"actor_id": actor_id, "state": RESTARTING})
            ok = await self._schedule_actor_creation(actor_id)
            if ok:
                return
            reason += " (restart scheduling failed)"
        info["state"] = DEAD
        info["death_cause"] = reason
        info["address"] = None
        self._wal("actors", actor_id)
        await self._publish("actor_updates", {"actor_id": actor_id, "state": DEAD, "reason": reason})

    async def rpc_kill_actor(self, req):
        self._mutations += 1
        actor_id = req["actor_id"]
        info = self.actors.get(actor_id)
        if info is None:
            return {"ok": False}
        no_restart = req.get("no_restart", True)
        addr = info.get("address")
        if no_restart:
            info["state"] = DEAD
            info["death_cause"] = "ray_tpu_torch.kill"
            self._wal("actors", actor_id)
            if info.get("name"):
                self.named_actors.pop((info["namespace"], info["name"]), None)
                self._wal("named_actors", (info["namespace"], info["name"]))
        if addr:
            client = None
            try:
                client = RpcClient(tuple(addr), label="actor-worker")
                # Best-effort and BOUNDED: the worker address is ephemeral
                # and may have been reused by an unrelated listener that
                # accepts but never replies (observed: a cycled port landing
                # on a non-framework server hung this await — and with it
                # the caller's no-timeout kill() — forever). The worker
                # reaper + actor-updates publish cover delivery failure.
                # Outer wait_for: acall RETRIES TimeoutError internally, so
                # a per-attempt timeout alone would still take 4x + sleeps.
                await asyncio.wait_for(
                    client.acall("kill_self", {"no_restart": no_restart}, timeout=5),
                    timeout=5,
                )
            except Exception:
                pass
            finally:
                if client is not None:
                    client.close()  # timeout path must not leak the socket
        if no_restart:
            await self._publish("actor_updates", {"actor_id": actor_id, "state": DEAD, "reason": "killed"})
        return {"ok": True}

    async def rpc_get_actor(self, req):
        actor_id = req.get("actor_id")
        if actor_id is None:
            key = (req.get("namespace", ""), req["name"])
            actor_id = self.named_actors.get(key)
            if actor_id is None:
                return {"found": False}
        info = self.actors.get(actor_id)
        if info is None:
            return {"found": False}
        out = {k: v for k, v in info.items() if k != "spec"}
        return {"found": True, "info": out}

    async def rpc_list_actors(self, req):
        return {
            "actors": [
                {k: v for k, v in info.items() if k != "spec"} for info in self.actors.values()
            ]
        }

    # ------------------------------------------------------------------
    # KV store (reference: gcs_kv_manager.h; function table rides on this)
    # ------------------------------------------------------------------

    @schema(key=str, value=bytes)
    async def rpc_kv_put(self, req):
        self._mutations += 1
        overwrite = req.get("overwrite", True)
        key = req["key"]
        if not overwrite and key in self.kv:
            return {"ok": False, "added": False}
        self.kv[key] = req["value"]
        self._wal("kv", key)
        return {"ok": True, "added": True}

    @schema(key=str)
    async def rpc_kv_get(self, req):
        value = self.kv.get(req["key"])
        return {"found": value is not None, "value": value}

    @schema(key=str)
    async def rpc_kv_del(self, req):
        self._mutations += 1
        existed = self.kv.pop(req["key"], None) is not None
        if existed:
            self._wal("kv", req["key"])
        return {"ok": True, "existed": existed}

    async def rpc_kv_keys(self, req):
        prefix = req.get("prefix", "")
        return {"keys": [k for k in self.kv if k.startswith(prefix)]}

    # ------------------------------------------------------------------
    # Object directory
    # ------------------------------------------------------------------

    @schema(object_id=str, node_id=str)
    async def rpc_add_object_location(self, req):
        self.object_locations.setdefault(req["object_id"], set()).add(req["node_id"])
        self._locations_by_node.setdefault(req["node_id"], set()).add(req["object_id"])
        return {"ok": True}

    @schema(object_id=str, node_id=str)
    async def rpc_remove_object_location(self, req):
        locs = self.object_locations.get(req["object_id"])
        if locs:
            locs.discard(req["node_id"])
            if not locs:
                del self.object_locations[req["object_id"]]
        by_node = self._locations_by_node.get(req["node_id"])
        if by_node:
            by_node.discard(req["object_id"])
            if not by_node:
                del self._locations_by_node[req["node_id"]]
        return {"ok": True}

    @schema(object_id=str)
    async def rpc_get_object_locations(self, req):
        locs = self.object_locations.get(req["object_id"], set())
        out = []
        for nid in locs:
            node = self.nodes.get(nid)
            if node and node["state"] == "ALIVE":
                out.append({"node_id": nid, "address": node["address"]})
        return {"locations": out}

    # ------------------------------------------------------------------
    # Placement groups (reference: gcs_placement_group_manager.h, 2PC in
    # gcs_placement_group_scheduler.h; bundle policies PACK/SPREAD/
    # STRICT_PACK/STRICT_SPREAD in policy/bundle_scheduling_policy.h:31)
    # ------------------------------------------------------------------

    async def rpc_create_placement_group(self, req):
        self._mutations += 1
        pg_id = req["pg_id"]
        bundles = req["bundles"]  # list[dict resource->qty]
        strategy = req.get("strategy", "PACK")
        self.placement_groups[pg_id] = {
            "pg_id": pg_id,
            "bundles": bundles,
            "strategy": strategy,
            "state": "PENDING",
            "bundle_nodes": [None] * len(bundles),
            "name": req.get("name", ""),
        }
        self._wal("placement_groups", pg_id)
        ok = await self._schedule_placement_group(pg_id)
        return {"ok": ok, "state": self.placement_groups[pg_id]["state"]}

    async def _schedule_placement_group(self, pg_id: str) -> bool:
        # In-flight guard: concurrent retries (two nodes registering in the
        # same window both kick _retry_pending_pgs) must not run the 2PC
        # twice — prepare_bundle is not idempotent and a double
        # prepare+commit double-acquires the bundle's resources.
        inflight = getattr(self, "_pg_scheduling", None)
        if inflight is None:
            inflight = self._pg_scheduling = set()
        if pg_id in inflight:
            return False
        inflight.add(pg_id)
        try:
            return await self._schedule_placement_group_inner(pg_id)
        finally:
            inflight.discard(pg_id)

    async def _schedule_placement_group_inner(self, pg_id: str) -> bool:
        pg = self.placement_groups[pg_id]
        bundles, strategy = pg["bundles"], pg["strategy"]
        alive = [(nid, n) for nid, n in self.nodes.items() if n["state"] == "ALIVE"]
        plan = self._plan_bundles(bundles, strategy, alive)
        if plan is None:
            pg["state"] = "PENDING"  # infeasible now; retried on node join
            return False
        # Phase 1: prepare (reserve) on each node; Phase 2: commit.
        reserved = []
        try:
            for idx, node_id in enumerate(plan):
                client = self._raylet_client(node_id)
                resp = await client.acall(
                    "prepare_bundle",
                    {"pg_id": pg_id, "bundle_index": idx, "resources": bundles[idx]},
                )
                if not resp.get("ok"):
                    raise RuntimeError(f"bundle {idx} reserve failed on {node_id[:8]}")
                reserved.append((idx, node_id))
            for idx, node_id in reserved:
                await self._raylet_client(node_id).acall(
                    "commit_bundle", {"pg_id": pg_id, "bundle_index": idx}
                )
        except Exception as e:
            logger.warning("PG %s scheduling rolled back: %s", pg_id[:8], e)
            for idx, node_id in reserved:
                try:
                    await self._raylet_client(node_id).acall(
                        "return_bundle", {"pg_id": pg_id, "bundle_index": idx}
                    )
                except Exception:
                    pass
            return False
        pg["bundle_nodes"] = list(plan)
        pg["state"] = "CREATED"
        self._wal("placement_groups", pg_id)
        await self._publish("pg_updates", {"pg_id": pg_id, "state": "CREATED"})
        return True

    def _plan_bundles(self, bundles, strategy, alive):
        """Bin-pack bundles onto nodes honoring the placement strategy."""
        avail = {nid: dict(n["resources_available"]) for nid, n in alive}

        def fits(nid, res):
            return all(avail[nid].get(k, 0) >= v for k, v in res.items())

        def take(nid, res):
            for k, v in res.items():
                avail[nid][k] = avail[nid].get(k, 0) - v

        plan: list[str | None] = [None] * len(bundles)
        if strategy == "STRICT_PACK":
            # All bundles on a single node (one-host
            # gang scheduling — see util/placement_group.py).
            for nid, _ in alive:
                trial = dict(avail[nid])
                ok = True
                for b in bundles:
                    if all(trial.get(k, 0) >= v for k, v in b.items()):
                        for k, v in b.items():
                            trial[k] = trial.get(k, 0) - v
                    else:
                        ok = False
                        break
                if ok:
                    return [nid] * len(bundles)
            return None
        if strategy == "STRICT_SPREAD":
            if len(bundles) > len(alive):
                return None
            used_nodes: set[str] = set()
            for i, b in enumerate(bundles):
                placed = False
                for nid, _ in alive:
                    if nid in used_nodes:
                        continue
                    if fits(nid, b):
                        take(nid, b)
                        plan[i] = nid
                        used_nodes.add(nid)
                        placed = True
                        break
                if not placed:
                    return None
            return plan
        # PACK / SPREAD best-effort.
        order = list(alive)
        for i, b in enumerate(bundles):
            if strategy == "SPREAD":
                order = sorted(alive, key=lambda kv: sum(1 for p in plan if p == kv[0]))
            placed = False
            for nid, _ in order:
                if fits(nid, b):
                    take(nid, b)
                    plan[i] = nid
                    placed = True
                    break
            if not placed:
                return None
        return plan

    async def rpc_remove_placement_group(self, req):
        self._mutations += 1
        pg = self.placement_groups.get(req["pg_id"])
        if pg is None:
            return {"ok": False}
        for idx, node_id in enumerate(pg["bundle_nodes"]):
            if node_id is None:
                continue
            try:
                await self._raylet_client(node_id).acall(
                    "return_bundle", {"pg_id": req["pg_id"], "bundle_index": idx}
                )
            except Exception:
                pass
        pg["state"] = "REMOVED"
        self._wal("placement_groups", req["pg_id"])
        return {"ok": True}

    async def rpc_get_placement_group(self, req):
        pg = self.placement_groups.get(req["pg_id"])
        if pg is None:
            return {"found": False}
        return {"found": True, "info": pg}

    # ------------------------------------------------------------------
    # Jobs
    # ------------------------------------------------------------------

    async def rpc_next_job_id(self, req):
        self._mutations += 1
        self._job_counter += 1
        job_id = f"{self._job_counter:08x}"
        self.jobs[job_id] = {"job_id": job_id, "state": "RUNNING", "start_time": time.time()}
        self._wal("job_counter")
        self._wal("jobs", job_id)
        return {"job_id": job_id}

    async def rpc_list_jobs(self, req):
        return {"jobs": list(self.jobs.values())}

    async def rpc_mark_job_finished(self, req):
        self._mutations += 1
        job = self.jobs.get(req["job_id"])
        if job is not None:
            job["state"] = req.get("state", "SUCCEEDED")
            job["end_time"] = time.time()
            self._wal("jobs", req["job_id"])
        return {"ok": job is not None}

    async def rpc_list_placement_groups(self, req):
        out = []
        for pg_id, pg in self.placement_groups.items():
            entry = {k: v for k, v in pg.items() if k != "client"}
            entry.setdefault("pg_id", pg_id)
            out.append(entry)
        return {"placement_groups": out}

    # ------------------------------------------------------------------
    # Task events (reference: gcs_task_manager.h; powers `ray timeline`)
    # ------------------------------------------------------------------

    @schema(events=list)
    async def rpc_record_task_events(self, req):
        events = req["events"]
        ring = self.task_events
        overflow = len(ring) + len(events) - ring.maxlen
        ring.extend(events)  # deque(maxlen=...) drops oldest — never blocks
        if overflow > 0:
            self.events_dropped_total += overflow
            from ray_tpu_torch._private import flight_recorder, self_metrics

            try:
                self_metrics.instruments()["gcs_events_dropped"].inc(overflow)
            except Exception:
                pass
            now = time.monotonic()
            if now - self._overload_flight_ts >= 5.0:
                # Rate-limited: the overload condition is per-burst news,
                # per-batch stamps would themselves flood the flight ring.
                self._overload_flight_ts = now
                flight_recorder.record(
                    "gcs_overload",
                    f"task_events dropped={self.events_dropped_total}",
                )
        return {"ok": True, "dropped": max(0, overflow)}

    async def rpc_get_task_events(self, req):
        limit = req.get("limit", 1000)
        events = list(self.task_events)
        return {"events": events[-limit:]}

    # ------------------------------------------------------------------
    # Pub/sub (reference: src/ray/pubsub/publisher.h:307)
    # ------------------------------------------------------------------

    @schema(channel=str)
    async def rpc_subscribe(self, req):
        """Register the requesting connection for pushes on a channel.

        Channels are fanned out over dedicated RpcClient connections the
        subscriber opens toward GCS; the subscriber passes its own push-back
        address and we connect back (long-poll-free push).
        """
        channel = req["channel"]
        addr = tuple(req["address"]) if isinstance(req["address"], list) else req["address"]
        subs = self._subscribers.setdefault(channel, [])
        # Idempotent per (channel, address): subscribers periodically
        # re-subscribe so a restarted GCS regains them without duplicates.
        for existing in list(subs):
            if getattr(existing, "address", None) == addr:
                subs.remove(existing)
                existing.close()
        client = RpcClient(addr, label=f"sub-{channel}")
        subs.append(client)
        return {"ok": True}

    async def _publish(self, channel: str, message: dict):
        subs = self._subscribers.get(channel, [])
        dead = []
        # Snapshot: rpc_subscribe may mutate the list between awaits.
        for client in list(subs):
            try:
                await client.apush("pubsub", {"channel": channel, "message": message})
            except Exception:
                dead.append(client)
        for d in dead:
            try:
                subs.remove(d)
            except ValueError:
                pass  # a concurrent re-subscribe already replaced it

    @schema(channel=str, message=None)
    async def rpc_publish(self, req):
        await self._publish(req["channel"], req["message"])
        return {"ok": True}

    # ------------------------------------------------------------------
    # Persistence (reference: HA GCS via redis_store_client.h + gcs_init_data.h)
    # ------------------------------------------------------------------

    def _snapshot(self) -> dict:
        # Actor/PG/job tables reload on restart (reference: gcs_init_data.h
        # repopulates managers from Redis). Per-actor RPC clients and the
        # node table are rebuilt live as raylets re-register. Pickled, not
        # JSON: actor specs embed serialized (bytes) arguments.
        return {
            "kv": dict(self.kv),
            "named_actors": dict(self.named_actors),
            "job_counter": self._job_counter,
            "actors": dict(self.actors),
            "placement_groups": self.placement_groups,
            "jobs": self.jobs,
        }

    async def _recover_loaded_actors(self):
        """Re-drive creation of actors snapshotted mid-flight: an actor
        persisted as PENDING_CREATION/RESTARTING has no worker yet and nothing
        else will ever schedule it after a restart. Waits for raylets to
        re-register first."""
        pending = [
            aid
            for aid, a in self.actors.items()
            if a.get("state") in (PENDING_CREATION, RESTARTING)
        ]
        if not pending:
            return
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(n["state"] == "ALIVE" for n in self.nodes.values()):
                break
            await asyncio.sleep(0.2)
        # Grace period: an in-flight creation on a surviving raylet may still
        # land (worker spawn takes seconds); only resubmit actors that remain
        # PENDING after it. rpc_actor_alive also rejects duplicates.
        await asyncio.sleep(self.cfg.gcs_actor_recovery_grace_s)
        for aid in pending:
            info = self.actors.get(aid)
            if info is None or info.get("state") not in (PENDING_CREATION, RESTARTING):
                continue
            try:
                await self._schedule_actor_creation(aid)
            except Exception:
                logger.exception("recovery scheduling of actor %s failed", aid[:8])

    async def _retry_pending_pgs(self):
        """Drive parked (infeasible) placement groups; called on node join
        and after a restore (reference: GcsPlacementGroupManager retries
        pending PGs on node add, gcs_placement_group_manager.cc)."""
        for pg_id, pg in list(self.placement_groups.items()):
            if pg.get("state") == "PENDING":
                try:
                    await self._schedule_placement_group(pg_id)
                except Exception:
                    logger.exception("pending PG %s retry failed", pg_id[:8])

    async def _recover_loaded_pgs(self):
        """Re-drive placement groups snapshotted mid-creation: a PG restored
        as PENDING would otherwise wait for a node JOIN that may never come
        (the raylets merely re-register). CREATED PGs need nothing — their
        bundles live on the surviving raylets, which keep their node ids."""
        if not any(pg.get("state") == "PENDING" for pg in self.placement_groups.values()):
            return
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(n["state"] == "ALIVE" for n in self.nodes.values()):
                break
            await asyncio.sleep(0.2)
        await asyncio.sleep(self.cfg.gcs_actor_recovery_grace_s)
        await self._retry_pending_pgs()

    async def _persist_loop(self):
        """Mutation-triggered snapshots with a short debounce (the analog of
        the reference's write-through Redis store, gcs_table_storage.h:
        every committed mutation is durable). Heartbeats don't bump
        _mutations, so the steady-state cost is one integer compare per
        tick; a mutation burst coalesces into one snapshot ~150ms later —
        the crash-loss window is that debounce, not a fixed 2s period."""
        saved_at = -1
        last_fsync = time.monotonic()
        while True:
            await asyncio.sleep(0.1)
            # everysec WAL policy: batched fdatasync at most once per second
            # while dirty — host-crash loss window is bounded by ~1s.
            if (
                self._wal_dirty
                and self._wal_file is not None
                and time.monotonic() - last_fsync >= 1.0
            ):
                # Off-loop: a slow disk's fdatasync must not stall heartbeat
                # and lease RPC handling (redis offloads everysec fsync to a
                # background thread for the same reason). Appends landing
                # during the sync bump the epoch, keeping the tail dirty;
                # only a successful sync of an unchanged epoch clears it.
                epoch = self._wal_dirty_epoch
                try:
                    fd = self._wal_file.fileno()
                    await asyncio.get_event_loop().run_in_executor(
                        None, os.fdatasync, fd
                    )
                    if self._wal_dirty_epoch == epoch:
                        self._wal_dirty = False
                except Exception:
                    logger.debug("wal fdatasync failed", exc_info=True)
                last_fsync = time.monotonic()
            if self._mutations == saved_at:
                continue  # nothing changed since the last snapshot
            await asyncio.sleep(0.05)  # coalesce the rest of the burst
            try:
                saved_at = self._mutations
                self._do_save()
            except Exception:
                logger.debug("gcs snapshot failed", exc_info=True)

    # ---- write-ahead log ----

    def _wal(self, table: str, key=None):
        """Append one table entry's NEW value (None = deleted) to the WAL and
        flush, BEFORE the mutating handler replies: an acknowledged mutation
        survives a GCS kill at any later instant (the debounced snapshot
        alone had a ~150ms loss window). Runs on the IO loop thread only."""
        f = self._wal_file
        if f is None:
            return
        import pickle

        if table == "job_counter":
            rec = ("job_counter", None, self._job_counter)
        else:
            rec = (table, key, getattr(self, table).get(key))
        try:
            data = pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            f.write(len(data).to_bytes(4, "big") + data)
            # flush reaches the page cache: survives process kill. Host-crash
            # durability comes from the fdatasync that _persist_loop runs
            # at most once a second (~1 s loss window on host crash).
            f.flush()
            self._wal_dirty = True
            self._wal_dirty_epoch += 1
            self._wal_records += 1
        except Exception:
            logger.debug("wal append failed", exc_info=True)

    def _replay_wal(self) -> bool:
        """Apply the WAL tail over the loaded snapshot. Torn trailing record
        (crash mid-append, pre-ack) is discarded — it was never acknowledged."""
        if not self._wal_path or not os.path.exists(self._wal_path):
            return False
        import pickle

        try:
            with open(self._wal_path, "rb") as f:
                buf = f.read()
        except OSError:
            return False
        pos, applied = 0, 0
        while pos + 4 <= len(buf):
            length = int.from_bytes(buf[pos : pos + 4], "big")
            if pos + 4 + length > len(buf):
                break  # torn tail
            try:
                table, key, value = pickle.loads(buf[pos + 4 : pos + 4 + length])
            except Exception:
                break  # corrupt tail
            pos += 4 + length
            if table == "job_counter":
                self._job_counter = max(self._job_counter, value)
            elif table in ("actors", "named_actors", "kv", "placement_groups", "jobs"):
                tbl = getattr(self, table)
                if value is None:
                    tbl.pop(key, None)
                else:
                    tbl[key] = value
            applied += 1
        if applied:
            logger.info("replayed %d WAL records over the GCS snapshot", applied)
        return applied > 0

    def _do_save(self):
        """Write the snapshot. MUST run on the IO loop thread — tables are
        mutated by RPC handlers on that loop, so this is the only thread from
        which pickling them is race-free. Doubles as WAL compaction: state up
        to this instant is in the snapshot, so the log restarts empty."""
        if not self.persist_path:
            return
        import pickle

        tmp = self.persist_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self._snapshot(), f)
            # The snapshot must be host-crash durable BEFORE it replaces the
            # old one and truncates the WAL — otherwise compaction trades
            # synced WAL records for page-cache bytes and an acknowledged
            # mutation can vanish.
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.persist_path)
        try:
            dfd = os.open(os.path.dirname(self.persist_path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)  # make the rename itself durable
            finally:
                os.close(dfd)
        except OSError:
            pass
        if self._wal_file is not None:
            self._wal_file.close()
            self._wal_file = open(self._wal_path, "wb")
            self._wal_dirty = False
            self._wal_records = 0

    def save_snapshot(self):
        """Thread-safe snapshot: marshals onto the IO loop."""
        if not self.persist_path:
            return

        async def _save():
            self._do_save()

        self._io.run(_save())

    def _load_snapshot(self):
        import pickle

        try:
            with open(self.persist_path, "rb") as f:
                snap = pickle.load(f)
        except Exception:
            # Legacy JSON snapshot (or corruption): best-effort partial load;
            # never block GCS startup on an unreadable snapshot.
            try:
                with open(self.persist_path) as f:
                    legacy = json.load(f)
                snap = {
                    "kv": {k: bytes.fromhex(v) for k, v in legacy.get("kv", {}).items()},
                    "named_actors": {
                        tuple(k.split("\x00", 1)): a
                        for k, a in legacy.get("named_actors", {}).items()
                    },
                    "job_counter": legacy.get("job_counter", 0),
                }
            except Exception:
                logger.warning("unreadable GCS snapshot %s; starting fresh", self.persist_path)
                return
        self.kv = dict(snap.get("kv", {}))
        self.named_actors.update(snap.get("named_actors", {}))
        self._job_counter = snap.get("job_counter", 0)
        self.actors.update(snap.get("actors", {}))
        self.placement_groups.update(snap.get("placement_groups", {}))
        self.jobs.update(snap.get("jobs", {}))

    def _raylet_client(self, node_id: str) -> RpcClient:
        client = self._raylet_clients.get(node_id)
        if client is None:
            node = self.nodes[node_id]
            client = RpcClient(tuple(node["address"]), label=f"raylet-{node_id[:8]}")
            self._raylet_clients[node_id] = client
        return client

    def stop(self):
        self._health_task.cancel()
        if self._persist_task is not None:
            self._persist_task.cancel()
        self.save_snapshot()
        if self._wal_file is not None:
            try:
                self._wal_file.close()
            except Exception:
                pass
            self._wal_file = None
        for c in self._raylet_clients.values():
            c.close()
        self.server.stop()


def main():
    import argparse

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--address-file", default="")
    parser.add_argument("--persist-path", default="")
    args = parser.parse_args()
    server = GcsServer(args.host, args.port, persist_path=args.persist_path or None)
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"address": list(server.address)}, f)
        os.replace(tmp, args.address_file)
    import threading

    threading.Event().wait()


if __name__ == "__main__":
    main()
