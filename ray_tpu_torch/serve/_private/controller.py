"""ServeController — the singleton control-plane actor.

Reference: python/ray/serve/_private/controller.py:79 ServeController,
deployment reconciliation in _private/deployment_state.py (DeploymentState
:1115, _scale_deployment_replicas :1493, DeploymentStateManager :2073), config
fan-out via long-poll (_private/long_poll.py), queue-depth autoscaling
(autoscaling_policy.py:9,53).

The controller actor holds target state (deployments + configs), runs a
reconcile thread that starts/stops replica actors to match, health-checks
replicas, collects queue metrics, and serves long-poll subscriptions from
routers/proxies for the replica membership table.

Replica lifecycle rides the AIR execution layer (``air/execution``
``ActorManager`` + ``FixedResourceManager``) — the same audited
start/failure/release substrate beneath Tune and Train: replica actors are
tracked actors (named, ``max_concurrency``-tuned via ``actor_options``),
process death fires ``on_failure`` (replica leaves the routing table, the
reconcile pass starts a replacement of the TARGET version — version-aware
replacement is controller policy, so manager-level restart stays off), and
resource acquisitions release with the actor, never leaking budget. A
dedicated pump thread drives ``ActorManager.next``; every manager call
holds ``_mgr_lock`` (taken OUTSIDE ``self._lock`` — callbacks run under it
and take ``self._lock`` inside).
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch._private import self_metrics
from ray_tpu_torch.air.execution import ActorManager, FixedResourceManager, ResourceRequest
from ray_tpu_torch.serve._private.common import (
    AutoscalingConfig,
    DeploymentConfig,
    DeploymentInfo,
    ReplicaInfo,
)

logger = logging.getLogger(__name__)


class ServeController:
    def __init__(self):
        # name -> DeploymentInfo (target state)
        self._deployments: dict[str, DeploymentInfo] = {}
        # name -> list[ReplicaInfo] (RUNNING replicas, in the routing table)
        self._replicas: dict[str, list[ReplicaInfo]] = {}
        # name -> {replica_id: created_ts} for STARTING replicas (created,
        # not yet healthy); drives both the over-start guard and the
        # rolling-update stall detector.
        self._starting_births: dict[str, dict[str, float]] = {}
        self._replica_handles: dict[str, object] = {}
        # AIR execution layer: replica actors are manager-tracked. _mgr_lock
        # serializes every manager call (pump thread, reconcile thread, RPC
        # threads) and is ALWAYS taken outside self._lock.
        self._mgr = ActorManager(FixedResourceManager())
        self._mgr_lock = threading.RLock()
        self._replica_tracked: dict[str, object] = {}  # replica_id -> TrackedActor
        # autoscaling bookkeeping
        self._metrics: dict[str, dict] = {}
        self._scale_marks: dict[str, float] = {}
        # replica_id -> last health-check timestamp (RUNNING replicas)
        self._health_marks: dict[str, float] = {}
        # name -> forced retires not yet matched by a new healthy replica.
        # Caps the stall-breaker at maxUnavailable=1: a rollout whose new
        # version never becomes healthy sacrifices at most one old replica.
        self._forced_debt: dict[str, int] = {}
        # replica_id -> drain record for replicas in drain-before-retire
        # (out of the routing table, refusing new work, finishing in-flight
        # streams). A health-check failure mid-drain pops the record and
        # retires IMMEDIATELY; the drain thread yields to it.
        self._draining: dict[str, dict] = {}
        self._lock = threading.RLock()
        self._epoch = 0
        self._epoch_cv = threading.Condition(self._lock)
        self._shutdown = False
        # Proxy fleet (reference: _private/http_state.py HTTPProxyState
        # manager): one ingress proxy actor per ALIVE node, health-checked
        # and restarted on a DEDICATED thread — proxy starts/health probes
        # block for seconds and must not stall replica reconciliation.
        self._proxies: dict[str, dict] = {}
        self._proxy_starting: set[str] = set()
        # node_id -> (consecutive start failures, monotonic next-retry time).
        # With a fixed http_port and several raylets sharing one host (the
        # simulated-cluster topology) all but one bind fails with EADDRINUSE;
        # exponential backoff keeps the reconciler from retrying every tick.
        self._proxy_backoff: dict[str, tuple[int, float]] = {}
        self._http_cfg: tuple | None = None
        self._proxy_thread: threading.Thread | None = None
        self._mgr_thread = threading.Thread(
            target=self._manager_loop, name="serve-actor-manager", daemon=True
        )
        self._mgr_thread.start()
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True
        )
        self._reconcile_thread.start()

    def _manager_loop(self):
        """Drive the ActorManager: starts pending replicas, polls liveness,
        dispatches task callbacks (readiness checks) on this thread."""
        while not self._shutdown:
            try:
                with self._mgr_lock:
                    progressed = self._mgr.next(timeout=0.2)
            except Exception:
                logger.exception("serve actor-manager pump failed")
                progressed = False
            if not progressed:
                time.sleep(0.05)

    # ------------------------------------------------------------------
    # Target-state API (called by serve.run / serve.delete)
    # ------------------------------------------------------------------
    def deploy(self, infos: list) -> bool:
        with self._lock:
            for raw in infos:
                info: DeploymentInfo = pickle.loads(raw) if isinstance(raw, bytes) else raw
                prev = self._deployments.get(info.name)
                self._deployments[info.name] = info
                if prev is not None and prev.config.version != info.config.version:
                    pass  # rolling update handled by reconcile (version mismatch)
        self._reconcile_once()
        return True

    def delete_deployments(self, names: list) -> bool:
        with self._lock:
            for name in names:
                self._deployments.pop(name, None)
        self._reconcile_once()
        return True

    def get_deployments(self) -> dict:
        with self._lock:
            return {
                name: {
                    "num_replicas": len(self._replicas.get(name, [])),
                    "num_replicas_current_version": sum(
                        1
                        for r in self._replicas.get(name, [])
                        if r.version == info.config.version
                    ),
                    "target": self._target_replicas(info, mutate=False),
                    "route_prefix": info.route_prefix,
                    "version": info.config.version,
                }
                for name, info in self._deployments.items()
            }

    def graceful_shutdown(self):
        with self._lock:
            self._deployments.clear()
        self._reconcile_once()
        self._shutdown = True
        # Guaranteed release: whatever reconcile missed (mid-start replicas,
        # in-flight probes), the manager kills and frees.
        with self._mgr_lock:
            self._mgr.clear()
        return True

    # ------------------------------------------------------------------
    # Long-poll routing table (reference: long_poll.py LongPollHost)
    # ------------------------------------------------------------------
    def get_routing_table(self, known_epoch: int = -1, timeout_s: float = 30.0) -> dict:
        """Block until the table changes from known_epoch (long poll)."""
        deadline = time.time() + timeout_s
        with self._epoch_cv:
            while self._epoch == known_epoch and not self._shutdown:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._epoch_cv.wait(remaining)
            table = {
                name: {
                    "replicas": [
                        {
                            "replica_id": r.replica_id,
                            "actor_name": r.actor_name,
                            "max_concurrent_queries": r.max_concurrent_queries,
                        }
                        for r in reps
                    ],
                    "route_prefix": self._deployments[name].route_prefix
                    if name in self._deployments
                    else None,
                }
                for name, reps in self._replicas.items()
                if name in self._deployments
            }
            return {"epoch": self._epoch, "table": table}

    def _bump_epoch_locked(self):
        self._epoch += 1
        self._epoch_cv.notify_all()

    # ------------------------------------------------------------------
    # Proxy fleet (reference: _private/http_state.py:32 HTTPProxyStateManager
    # + http_proxy.py:553 — one HTTPProxyActor per node, controller-managed)
    # ------------------------------------------------------------------
    def ensure_http(self, host: str = "127.0.0.1", port: int = 0) -> dict:
        """Enable per-node ingress; returns node_id -> [host, port] once at
        least one proxy is serving."""
        with self._lock:
            self._http_cfg = (host, port)
            if self._proxy_thread is None or not self._proxy_thread.is_alive():
                self._proxy_thread = threading.Thread(
                    target=self._proxy_loop, name="serve-proxy-fleet", daemon=True
                )
                self._proxy_thread.start()
        # First call waits for the initial proxy so serve.start() can hand
        # back a usable address.
        deadline = time.time() + 60
        while time.time() < deadline and not self.proxy_addresses():
            time.sleep(0.1)
        return self.proxy_addresses()

    def _proxy_loop(self):
        while not self._shutdown:
            try:
                self._reconcile_proxies()
            except Exception:
                logger.exception("proxy reconcile failed")
            time.sleep(1.0)

    def proxy_addresses(self) -> dict:
        with self._lock:
            return {
                nid: list(p["address"])
                for nid, p in self._proxies.items()
                if p.get("address") is not None
            }

    def _reconcile_proxies(self):
        with self._lock:
            cfg = self._http_cfg
        if cfg is None:
            return
        host, port = cfg
        try:
            nodes = ray_tpu_torch.nodes()
        except Exception:
            return
        alive = {
            n["node_id"] for n in nodes if str(n.get("state", "ALIVE")).upper() == "ALIVE"
        }
        with self._lock:
            proxies = dict(self._proxies)
        # Ingress on a dead node is gone with the node: forget it so routing
        # (and http_address()) only ever names live proxies.
        for nid in list(proxies):
            if nid not in alive:
                with self._lock:
                    self._proxies.pop(nid, None)
                    self._proxy_backoff.pop(nid, None)
                try:
                    ray_tpu_torch.kill(proxies[nid]["handle"])
                except Exception:
                    pass
        with self._lock:
            # Backoff entries can exist for nodes that never got a proxy up
            # (every start failed) — purge those for departed nodes too.
            for nid in list(self._proxy_backoff):
                if nid not in alive:
                    self._proxy_backoff.pop(nid, None)
        for nid in alive:
            with self._lock:
                if nid in self._proxy_starting:
                    continue  # a start for this node is already in flight
                backoff = self._proxy_backoff.get(nid)
            if (
                backoff is not None
                and nid not in proxies
                and time.monotonic() < backoff[1]
            ):
                continue  # recent start failure: wait out the backoff
            rec = proxies.get(nid)
            if rec is not None:
                if time.time() - rec.get("checked", 0) < 5.0:
                    continue
                try:
                    ray_tpu_torch.get(rec["handle"].ready.remote(), timeout=5)
                    with self._lock:
                        if nid in self._proxies:
                            self._proxies[nid]["checked"] = time.time()
                    continue
                except Exception:
                    logger.warning("serve proxy on node %s failed health check", nid[:8])
                    with self._lock:
                        self._proxies.pop(nid, None)
                    try:
                        ray_tpu_torch.kill(rec["handle"])
                    except Exception:
                        pass
            self._start_proxy(nid, host, port)

    def _start_proxy(self, node_id: str, host: str, port: int):
        from ray_tpu_torch.serve._private.common import CONTROLLER_NAME, PROXY_NAME
        from ray_tpu_torch.serve._private.http_proxy import HTTPProxy

        # Unique name per incarnation: a dead proxy's name can linger in the
        # GCS registry until death propagation completes.
        name = f"{PROXY_NAME}:{node_id[:12]}:{uuid.uuid4().hex[:6]}"
        handle = None
        with self._lock:
            if node_id in self._proxy_starting:
                return
            self._proxy_starting.add(node_id)
        try:
            cls = ray_tpu_torch.remote(
                num_cpus=0,
                name=name,
                max_concurrency=16,
                scheduling_strategy=f"node:{node_id}",
            )(HTTPProxy)
            handle = cls.remote(CONTROLLER_NAME, host, port)
            addr = ray_tpu_torch.get(handle.address.remote(), timeout=30)
            with self._lock:
                self._proxies[node_id] = {
                    "handle": handle,
                    "address": tuple(addr),
                    "checked": time.time(),
                }
            logger.info("serve proxy up on node %s at %s", node_id[:8], addr)
            with self._lock:
                self._proxy_backoff.pop(node_id, None)
        except Exception as e:
            with self._lock:
                fails = self._proxy_backoff.get(node_id, (0, 0.0))[0] + 1
                delay = min(2.0 * (2 ** (fails - 1)), 60.0)
                self._proxy_backoff[node_id] = (fails, time.monotonic() + delay)
            if fails == 1 or fails % 5 == 0:
                logger.exception(
                    "failed to start serve proxy on node %s "
                    "(attempt %d, next retry in %.0fs): %s",
                    node_id[:8], fails, delay, e,
                )
            if handle is not None:
                try:
                    ray_tpu_torch.kill(handle)  # don't leak a half-started proxy
                except Exception:
                    pass
        finally:
            with self._lock:
                self._proxy_starting.discard(node_id)

    def shutdown_proxies(self):
        with self._lock:
            proxies, self._proxies = dict(self._proxies), {}
            self._http_cfg = None
        for rec in proxies.values():
            try:
                ray_tpu_torch.kill(rec["handle"])
            except Exception:
                pass
        return True

    # ------------------------------------------------------------------
    # Metrics ingest (replicas push; reference: autoscaling_metrics.py)
    # ------------------------------------------------------------------
    def record_metrics(self, deployment: str, replica_id: str, ongoing: int) -> bool:
        with self._lock:
            self._metrics.setdefault(deployment, {})[replica_id] = (ongoing, time.time())
        return True

    def get_autoscaling_metrics(self) -> dict:
        """Current per-replica queue depths (observability + tests)."""
        with self._lock:
            return {
                name: {rid: m[0] for rid, m in reps.items()}
                for name, reps in self._metrics.items()
            }

    # ------------------------------------------------------------------
    # Reconciliation
    # ------------------------------------------------------------------
    def _reconcile_loop(self):
        while not self._shutdown:
            try:
                self._health_check_replicas()
            except Exception:
                logger.exception("replica health checks failed")
            try:
                self._sweep_stale_births()
            except Exception:
                logger.exception("stale-birth sweep failed")
            try:
                self._reconcile_once()
            except Exception:
                logger.exception("reconcile failed")
            time.sleep(0.5)

    def _health_check_replicas(self):
        """Periodically health-check RUNNING replicas and retire dead ones
        (reference: deployment_state.py check_health loop — start-up checks
        alone leave a crashed replica in the routing table forever; the
        reconcile pass then replaces the removed replica).

        Liveness signal #1 is the replica's own metrics PUSH recency: the
        push thread runs OUTSIDE the request pool, so a saturated-but-
        healthy replica (every slot busy with long requests) still proves
        it is alive without an actor call that would queue behind those
        requests and time out. The check_health actor call is the fallback
        for replicas with no recent push."""
        now = time.time()
        with self._lock:
            due = []
            for name, reps in self._replicas.items():
                info = self._deployments.get(name)
                if info is None:
                    continue
                period = info.config.health_check_period_s
                for r in reps:
                    if now - self._health_marks.get(r.replica_id, 0.0) < period:
                        continue
                    self._health_marks[r.replica_id] = now
                    push_ts = self._metrics.get(name, {}).get(r.replica_id, (0, 0.0))[1]
                    if now - push_ts < 5.0:
                        continue  # fresh push == alive
                    due.append((name, r, info.config.health_check_timeout_s))
            # DRAINING replicas left the routing table but still hold a
            # process + in-flight streams: keep health-checking them so a
            # replica that dies/wedges mid-drain is retired immediately
            # instead of riding out the whole drain_timeout_s.
            for rid, rec in list(self._draining.items()):
                info = self._deployments.get(rec["name"])
                period = info.config.health_check_period_s if info else 10.0
                if now - self._health_marks.get(rid, 0.0) < period:
                    continue
                self._health_marks[rid] = now
                push_ts = (
                    self._metrics.get(rec["name"], {}).get(rid, (0, 0.0))[1]
                )
                if now - push_ts < 5.0:
                    continue
                due.append((
                    rec["name"], rec["rinfo"],
                    info.config.health_check_timeout_s if info else 30.0,
                ))
        # Fan out ALL probes, then collect under one shared deadline: a node
        # death with N replicas must cost one timeout, not N.
        refs = []
        max_timeout = 0.0
        for name, r, timeout_s in due:
            handle = self._replica_handles.get(r.replica_id)
            if handle is None:
                with self._lock:
                    rec = self._draining.get(r.replica_id)
                handle = rec.get("handle") if rec else None
            max_timeout = max(max_timeout, timeout_s)
            if handle is None:
                refs.append((name, r, None))
                continue
            try:
                refs.append((name, r, handle.check_health.remote()))
            except Exception:
                refs.append((name, r, None))
        deadline = time.time() + max_timeout
        for name, r, ref in refs:
            ok = False
            try:
                remaining = max(0.1, deadline - time.time())
                ok = ref is not None and bool(ray_tpu_torch.get(ref, timeout=remaining))
            except Exception:
                ok = False
            if not ok:
                self._retire_unhealthy_replica(name, r)

    def _retire_unhealthy_replica(self, name: str, r):
        with self._lock:
            reps = self._replicas.get(name, [])
            present = r in reps
            if present:
                reps.remove(r)
                self._bump_epoch_locked()
            tracked = self._replica_tracked.pop(r.replica_id, None)
            handle = self._replica_handles.pop(r.replica_id, None)
            self._health_marks.pop(r.replica_id, None)
            self._metrics.get(name, {}).pop(r.replica_id, None)
            # Health failure OUTRANKS an in-progress drain: a dead/wedged
            # replica drains nothing, so claim the drain record (its thread
            # yields once the record is gone) and kill NOW.
            draining = self._draining.pop(r.replica_id, None)
        if draining is not None:
            tracked = tracked or draining.get("tracked")
            handle = handle or draining.get("handle")
        elif not present:
            return  # raced a deliberate stop (downscale/rollout) — no-op
        logger.warning(
            "replica %s of %s failed its health check; removing and killing%s",
            r.replica_id, name,
            " (drain in progress, retired immediately)" if draining else "",
        )
        # Kill the actor too: a hung replica left alive would hold its CPU
        # reservation and starve the replacement on a full cluster.
        if tracked is not None:
            with self._mgr_lock:
                self._mgr.remove_actor(tracked)
        elif handle is not None:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

    def _target_replicas(self, info: DeploymentInfo, mutate: bool = True) -> int:
        """Desired replica count. Only the reconcile loop may pass
        mutate=True — the delay-mark bookkeeping must not be perturbed by
        read-only callers like serve.status()."""
        auto = info.config.autoscaling
        if auto is None:
            return info.config.num_replicas
        with self._lock:
            metrics = self._metrics.get(info.name, {})
            live = {r.replica_id for r in self._replicas.get(info.name, [])}
            now = time.time()
            vals = [m[0] for rid, m in metrics.items() if rid in live and now - m[1] < 5.0]
        total_ongoing = sum(vals) if vals else 0
        # reference: autoscaling_policy.py:9 calculate_desired_num_replicas
        desired = int(-(-total_ongoing // max(auto.target_num_ongoing_requests_per_replica, 1e-9)))
        desired = max(auto.min_replicas, min(auto.max_replicas, max(desired, 0) or auto.min_replicas))
        key = info.name
        prev = len(self._replicas.get(key, []))
        if not mutate:
            return desired
        if desired > prev:
            mark = self._scale_marks.get(key + ":up")
            if mark is None:
                self._scale_marks[key + ":up"] = now
                return prev
            if now - mark < auto.upscale_delay_s:
                return prev
            self._scale_marks.pop(key + ":up", None)
            return desired
        if desired < prev:
            mark = self._scale_marks.get(key + ":down")
            if mark is None:
                self._scale_marks[key + ":down"] = now
                return prev
            if now - mark < auto.downscale_delay_s:
                return prev
            self._scale_marks.pop(key + ":down", None)
            return desired
        self._scale_marks.pop(key + ":up", None)
        self._scale_marks.pop(key + ":down", None)
        return desired

    def _reconcile_once(self):
        with self._lock:
            targets = dict(self._deployments)
        changed = False
        # Remove replicas of deleted deployments. Stale-version replicas are
        # NOT torn down here — the rolling update below retires them only as
        # new-version replicas pass health checks (reference: versioned
        # rolling updates in deployment_state.py / version.py).
        with self._lock:
            current = {k: list(v) for k, v in self._replicas.items()}
        for name, reps in current.items():
            if name not in targets:
                for r in reps:
                    self._stop_replica(name, r)
                    changed = True
        # Scale each deployment to target (STARTING replicas count toward the
        # target so reconcile doesn't over-start while actors boot).
        for name, info in targets.items():
            version = info.config.version
            with self._lock:
                reps = list(self._replicas.get(name, []))
                starting = len(self._starting_births.get(name, {}))
            new_reps = [r for r in reps if r.version == version]
            old_reps = [r for r in reps if r.version != version]
            target = self._target_replicas(info)
            if len(new_reps) + starting < target:
                for _ in range(target - len(new_reps) - starting):
                    self._start_replica(info)
            elif len(new_reps) > target:
                for r in new_reps[target:]:
                    self._stop_replica(name, r)
                changed = True
            # Retire one old replica per healthy new one; drain the rest once
            # the new version fully covers the target.
            retire = len(old_reps) if len(new_reps) >= target else min(
                len(old_reps), max(0, len(new_reps) + len(old_reps) - target)
            )
            forced = False
            if retire == 0 and old_reps and starting > 0:
                # Rolling update stalled: new-version replicas CANNOT PLACE
                # (tracked actors still PENDING = waiting for resources,
                # typically because the old version holds them all).
                # Force-retire ONE old replica to free resources — and only
                # one outstanding at a time (maxUnavailable=1), so a
                # rollout whose new version keeps crashing cannot drain the
                # whole deployment. A replica that placed and is merely
                # SLOW-STARTING (model load/compile) is NOT a stall: those
                # used to trip this branch and rob old replicas of their
                # drain.
                from ray_tpu_torch.air.execution.actor_manager import PENDING

                with self._lock:
                    births = self._starting_births.get(name, {})
                    oldest = min(births.values()) if births else None
                    unplaceable = any(
                        self._replica_tracked.get(rid) is not None
                        and self._replica_tracked[rid].state == PENDING
                        for rid in births
                    )
                    if (
                        oldest is not None
                        and unplaceable
                        and time.time() - oldest > 3.0
                        and self._forced_debt.get(name, 0) == 0
                    ):
                        retire = 1
                        forced = True
                        self._forced_debt[name] = 1
            for r in old_reps[:retire]:
                # Forced stall-breaker retires skip the drain: they exist
                # to free resources for a wedged rollout NOW.
                self._stop_replica(name, r, drain=not forced)
                changed = True
        if changed:
            with self._epoch_cv:
                self._bump_epoch_locked()

    def _start_replica(self, info: DeploymentInfo):
        """Create the replica actor through the AIR ActorManager; it enters
        the routing table only once its first health check answers
        (reference: replica STARTING -> RUNNING transition in
        deployment_state.py). The manager owns process lifecycle + resource
        accounting; version-aware replacement stays controller policy."""
        from ray_tpu_torch.serve._private.common import CONTROLLER_NAME
        from ray_tpu_torch.serve._private.replica import Replica

        replica_id = uuid.uuid4().hex[:8]
        actor_name = f"SERVE_REPLICA::{info.name}#{replica_id}"
        opts = dict(info.config.ray_actor_options or {})
        bundle = {"CPU": opts.pop("num_cpus", 1)}
        ngpu = opts.pop("num_gpus", None)
        if ngpu:
            bundle["GPU"] = ngpu  # fractions too: two replicas at 0.5 share one card
        bundle.update(opts.pop("resources", None) or {})
        actor_options = dict(opts)
        actor_options["name"] = actor_name
        # Admit concurrent requests up to the routing limit so @serve.batch
        # can actually form batches (reference: replicas are async actors).
        actor_options.setdefault(
            "max_concurrency", min(info.config.max_concurrent_queries, 32)
        )
        rinfo = ReplicaInfo(
            replica_id=replica_id,
            deployment_name=info.name,
            actor_name=actor_name,
            max_concurrent_queries=info.config.max_concurrent_queries,
            version=info.config.version,
        )

        def _on_start(tracked):
            # ALIVE at the GCS: run the readiness probe as a manager task so
            # its result/error flows back through the pump thread.
            self._mgr.schedule_actor_task(
                tracked,
                "check_health",
                on_result=lambda ok: self._replica_ready(rinfo, tracked, bool(ok)),
                on_error=lambda e: self._replica_ready(rinfo, tracked, False),
            )

        def _on_failure(tracked, error, will_restart):
            self._replica_failed(rinfo, error)

        with self._mgr_lock:
            tracked = self._mgr.add_actor(
                Replica,
                {
                    "import_spec": info.import_spec,
                    "user_config": info.config.user_config,
                    "deployment_name": info.name,
                    "replica_id": replica_id,
                    "controller_name": CONTROLLER_NAME,
                },
                resource_request=ResourceRequest([bundle]),
                actor_options=actor_options,
                on_start=_on_start,
                on_failure=_on_failure,
            )
        with self._lock:
            self._starting_births.setdefault(info.name, {})[replica_id] = time.time()
            self._replica_tracked[replica_id] = tracked

    def _replica_ready(self, rinfo: ReplicaInfo, tracked, ok: bool):
        """Readiness probe answered (ActorManager pump thread, _mgr_lock
        held): healthy replicas enter the routing table, anything else is
        removed through the manager."""
        name = rinfo.deployment_name
        with self._lock:
            self._starting_births.get(name, {}).pop(rinfo.replica_id, None)
            if ok:
                self._forced_debt.pop(name, None)
            admitted = ok and name in self._deployments
            if admitted:
                self._replicas.setdefault(name, []).append(rinfo)
                self._replica_handles[rinfo.replica_id] = tracked.actor_handle
            else:
                self._replica_tracked.pop(rinfo.replica_id, None)
                self._replica_handles.pop(rinfo.replica_id, None)
        if admitted:
            with self._epoch_cv:
                self._bump_epoch_locked()
            logger.info("replica %s of %s is running", rinfo.replica_id, name)
        else:
            if not ok:
                logger.warning("replica %s of %s failed to start", rinfo.replica_id, name)
            self._mgr.remove_actor(tracked)  # reentrant under _mgr_lock

    def _replica_failed(self, rinfo: ReplicaInfo, error: BaseException):
        """Replica process died (ActorManager on_failure): drop it from the
        routing table; the reconcile pass starts a target-version
        replacement."""
        name = rinfo.deployment_name
        with self._lock:
            reps = self._replicas.get(name, [])
            present = rinfo in reps
            if present:
                reps.remove(rinfo)
            self._starting_births.get(name, {}).pop(rinfo.replica_id, None)
            self._replica_tracked.pop(rinfo.replica_id, None)
            self._replica_handles.pop(rinfo.replica_id, None)
            self._health_marks.pop(rinfo.replica_id, None)
            self._metrics.get(name, {}).pop(rinfo.replica_id, None)
            # Died while draining: the manager already reaped the process;
            # clearing the record makes the drainer thread exit quietly.
            self._draining.pop(rinfo.replica_id, None)
        if present:
            logger.warning(
                "replica %s of %s died (%s); removing from routing table",
                rinfo.replica_id, name, error,
            )
            with self._epoch_cv:
                self._bump_epoch_locked()

    def _sweep_stale_births(self):
        """Abort STARTING replicas whose readiness never answered within the
        health-check timeout (hung __init__ / lost probe): the pre-manager
        controller bounded startup with a get(timeout=) — the manager probe
        has no deadline of its own, so the sweep enforces one."""
        stale = []
        now = time.time()
        with self._lock:
            for name, births in self._starting_births.items():
                info = self._deployments.get(name)
                limit = max(
                    30.0,
                    info.config.health_check_timeout_s * 3 if info is not None else 30.0,
                )
                for rid, born in list(births.items()):
                    if now - born > limit:
                        births.pop(rid, None)
                        stale.append((name, rid, self._replica_tracked.pop(rid, None)))
        for name, rid, tracked in stale:
            logger.warning("replica %s of %s never became ready; aborting", rid, name)
            if tracked is not None:
                with self._mgr_lock:
                    self._mgr.remove_actor(tracked)

    def _stop_replica(self, name: str, rinfo: ReplicaInfo, drain: bool = True):
        """Deliberate retirement (downscale / rolling update / delete).

        With ``drain`` (and a positive ``drain_timeout_s``): the replica
        leaves the routing table NOW (routers stop assigning on the next
        epoch), is told to refuse new requests, and a drainer thread
        retires the process only once its in-flight requests and stream
        pumps hit zero — or the bound expires. The stall-breaker's forced
        retire passes ``drain=False``: it exists to free resources for a
        stuck rollout, and waiting on a drain would re-create the stall."""
        with self._lock:
            if rinfo.replica_id in self._draining:
                return  # a drainer already owns this replica
            reps = self._replicas.get(name, [])
            if rinfo in reps:
                reps.remove(rinfo)
            tracked = self._replica_tracked.pop(rinfo.replica_id, None)
            handle = self._replica_handles.pop(rinfo.replica_id, None)
            # Prune per-replica bookkeeping: under autoscaling churn these
            # maps would otherwise grow one entry per retired replica forever.
            self._health_marks.pop(rinfo.replica_id, None)
            self._metrics.get(name, {}).pop(rinfo.replica_id, None)
            info = self._deployments.get(name)
            # Deleted deployments still drain their live streams (the
            # config is gone with the deployment; use the default bound).
            timeout_s = (
                info.config.drain_timeout_s
                if info is not None
                else DeploymentConfig.drain_timeout_s
            )
            start_drain = (
                drain
                and timeout_s > 0
                and handle is not None
                and not self._shutdown
            )
            if start_drain:
                self._draining[rinfo.replica_id] = {
                    "name": name,
                    "rinfo": rinfo,
                    "tracked": tracked,
                    "handle": handle,
                }
        if start_drain:
            threading.Thread(
                target=self._drain_then_retire,
                args=(name, rinfo, tracked, handle, timeout_s),
                name=f"serve-drain-{rinfo.replica_id}",
                daemon=True,
            ).start()
            return
        self._retire_replica_process(name, rinfo, tracked, handle)

    def _drain_then_retire(self, name, rinfo, tracked, handle, timeout_s):
        """Drainer thread for ONE deliberately-stopped replica. Yields to
        the health-check path: if that retires the replica mid-drain (dead
        replicas drain nothing), the drain record vanishes and this thread
        simply exits."""
        from ray_tpu_torch._private import flight_recorder

        rid = rinfo.replica_id
        flight_recorder.record("replica_drain", f"{rid}:begin")
        outcome = "clean"
        try:
            ray_tpu_torch.get(handle.drain.remote(), timeout=10)
        except Exception:
            # The replica may still be fine (a loaded box can blow a 10s
            # bound); the routing-table removal already stops new assigns,
            # so keep polling — the status loop decides liveness.
            pass
        deadline = time.monotonic() + timeout_s
        fails = 0
        while not self._shutdown:
            with self._lock:
                if self._draining.get(rid) is None:
                    return  # force-retired by a health-check failure
            if time.monotonic() > deadline:
                outcome = "timeout"
                break
            try:
                st = ray_tpu_torch.get(handle.drain_status.remote(), timeout=10)
            except Exception:
                # Transient (slow box) vs dead: three consecutive misses
                # within the drain window reads as dead — a single blown
                # bound must not retire a replica with live streams.
                fails += 1
                if fails >= 3:
                    outcome = "died_draining"
                    break
            else:
                fails = 0
                if st.get("ongoing", 0) == 0 and st.get("streams", 0) == 0:
                    break
            time.sleep(0.25)
        with self._lock:
            if self._draining.pop(rid, None) is None:
                return  # raced the force-retire path; it owns the kill
        flight_recorder.record("replica_drain", f"{rid}:{outcome}")
        try:
            self_metrics.instruments()["serve_drains"].inc(tags={"outcome": outcome})
        except Exception:
            pass
        self._retire_replica_process(name, rinfo, tracked, handle)

    def _retire_replica_process(self, name, rinfo, tracked, handle):
        if handle is not None:
            try:
                # Graceful shutdown hook: let the user callable release
                # resources before the actor process is killed.
                ray_tpu_torch.get(
                    handle.prepare_for_shutdown.remote(),
                    timeout=min(5.0, self._deployments[name].config.graceful_shutdown_timeout_s)
                    if name in self._deployments
                    else 5.0,
                )
            except Exception:
                pass
        if tracked is not None:
            with self._mgr_lock:
                try:
                    self._mgr.remove_actor(tracked)  # kills + releases resources
                except Exception:
                    pass  # already removed (died mid-drain; on_failure ran)
        elif handle is not None:
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass
        # A draining replica kept pushing queue metrics after the stop-time
        # prune (its push thread stops only in prepare_for_shutdown above);
        # prune AFTER the process is gone so retired replicas don't accrete
        # map entries.
        with self._lock:
            self._health_marks.pop(rinfo.replica_id, None)
            self._metrics.get(name, {}).pop(rinfo.replica_id, None)
        logger.info("stopped replica %s of %s", rinfo.replica_id, name)
