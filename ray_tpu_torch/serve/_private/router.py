"""Router — picks a replica for each request.

Reference: python/ray/serve/_private/router.py:368 Router,
ReplicaScheduler.assign_replica :76, round-robin skipping replicas at
max_concurrent_queries :125,336; membership pushed from the controller via
long-poll (long_poll.py:68 LongPollClient).
"""

from __future__ import annotations

import logging
import threading
import time

import ray_tpu_torch
from ray_tpu_torch._private import self_metrics

logger = logging.getLogger(__name__)


class Router:
    """One per handle/proxy process; tracks the routing table with a
    background long-poll thread and round-robins requests."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self, controller_handle):
        self._controller = controller_handle
        self._table: dict = {}
        self._epoch = -1
        self._handles: dict[str, object] = {}  # actor_name -> handle
        self._rr: dict[str, int] = {}
        self._inflight: dict[str, int] = {}  # replica actor_name -> count
        self._alive_cache: dict[str, float] = {}  # actor_name -> verdict stamp
        # Replicas KNOWN to be draining (refused a request with the typed
        # ReplicaDrainingError), actor_name -> expiry stamp. The controller
        # eventually removes them from the table; until that table version
        # lands, every assignment policy — round-robin, prefix-affinity pin,
        # least-queue-depth spill, handoff targeting — must skip them, or a
        # request burns one of its bounded reassign retries on a replica
        # that is guaranteed to refuse it. TTL-bounded so a replica that
        # aborts its drain (or a name reused by a new replica) recovers.
        self._draining: dict[str, float] = {}
        self._metrics = self_metrics.instruments()
        self._lock = threading.Lock()
        # Saturated assigns park on this condition (same underlying lock);
        # release() and table refreshes notify — no busy polling.
        self._avail = threading.Condition(self._lock)
        self._update_event = threading.Event()
        # controller_handle=None is the unit-test seam: a bare router with a
        # hand-fed table and no background poller.
        if controller_handle is not None:
            self._poll_thread = threading.Thread(target=self._poll_loop, daemon=True)
            self._poll_thread.start()
            # Synchronous first fetch so handles work immediately after run().
            self._refresh(timeout_s=0.1)

    @classmethod
    def shared(cls, controller_handle) -> "Router":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Router(controller_handle)
            return cls._instance

    @classmethod
    def reset(cls):
        with cls._instance_lock:
            cls._instance = None

    def _refresh(self, timeout_s: float = 30.0):
        resp = ray_tpu_torch.get(
            self._controller.get_routing_table.remote(self._epoch, timeout_s)
        )
        with self._lock:
            self._epoch = resp["epoch"]
            self._table = resp["table"]
            # New/scaled deployments can unblock saturated assigns.
            self._avail.notify_all()
        self._update_event.set()

    def _poll_loop(self):
        while True:
            try:
                self._refresh()
            except Exception:
                time.sleep(1.0)

    def replicas_for(self, deployment: str) -> list:
        with self._lock:
            entry = self._table.get(deployment)
            return list(entry["replicas"]) if entry else []

    def route_for_prefix(self, path: str):
        """Longest-prefix route match for HTTP (reference: proxy route table)."""
        return self.route_and_prefix_for(path)[0]

    def route_and_prefix_for(self, path: str):
        """(deployment, matched route prefix) — the proxy forwards the
        prefix so replicas can resolve request.sub_path without knowing
        their own mount point."""
        with self._lock:
            best, best_prefix, best_len = None, None, -1
            for name, entry in self._table.items():
                prefix = entry.get("route_prefix")
                if prefix is None:
                    continue
                if (path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/") and len(prefix) > best_len:
                    best, best_prefix, best_len = name, prefix, len(prefix)
            return best, best_prefix

    def wait_for_deployment(self, deployment: str, timeout_s: float = 30.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.replicas_for(deployment):
                return True
            time.sleep(0.05)
        return False

    def assign_replica(
        self,
        deployment: str,
        timeout_s: float = 30.0,
        model_id: str = "",
        prefix_hint: str = "",
        exclude=(),
    ):
        """Pick a replica and claim a queue slot on it.

        Policy (reference: router.py:125 RoundRobinReplicaScheduler, plus
        the cache-aware layer for serve.llm):

        - ``model_id`` pins to a stable replica (warm multiplexed model
          cache) with round-robin fallback when it is saturated;
        - ``prefix_hint`` (hash of a request's leading prompt block —
          ``serve.llm.prefix_route_hint``) pins to a stable replica so
          requests sharing a system prompt land where its KV prefix-cache
          blocks already live, falling back to the LEAST-QUEUE-DEPTH
          unsaturated replica (a cache miss should at least balance load);
        - otherwise round-robin, skipping replicas at max_concurrent_queries.

        When every replica is saturated the caller parks on a Condition that
        ``release()`` (and table refreshes) notify — a freed slot hands off
        in microseconds, not a 10 ms poll; ``timeout_s`` still bounds the
        total wait.

        ``exclude``: actor names to never pick — the reassign/migration
        callers pass the replica they just watched die, since it can linger
        in the table until the controller notices the death.
        """
        deadline = time.time() + timeout_s
        exclude = set(exclude)
        with self._avail:
            while True:
                entry = self._table.get(deployment)
                replicas = list(entry["replicas"]) if entry else []
                if self._draining:
                    self._prune_draining_locked()
                if self._draining:
                    replicas = [
                        r
                        for r in replicas
                        if r["actor_name"] not in self._draining
                    ]
                if exclude:
                    replicas = [r for r in replicas if r["actor_name"] not in exclude]
                if replicas:
                    r = self._pick_locked(deployment, replicas, model_id, prefix_hint)
                    if r is not None:
                        name = r["actor_name"]
                        self._inflight[name] = self._inflight.get(name, 0) + 1
                        try:
                            self._metrics["serve_requests"].inc(
                                tags={"deployment": deployment}
                            )
                            self._set_queue_depth_locked(deployment)
                        except Exception:
                            pass
                        return r
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no available replica for deployment {deployment!r} "
                        f"within {timeout_s}s"
                    )
                # The 1 s cap is a backstop for changes nobody notifies
                # about (e.g. a replica's limit raised by a new table
                # version swallowed between checks).
                self._avail.wait(timeout=min(remaining, 1.0))

    def _pick_locked(self, deployment, replicas, model_id, prefix_hint):
        """Choose an unsaturated replica (caller holds _lock); None if all
        are at their queue limit."""
        import zlib

        n = len(replicas)

        def free(r):
            return self._inflight.get(r["actor_name"], 0) < r["max_concurrent_queries"]

        if model_id:
            # Stable affinity: same model id -> same replica; round-robin
            # scan from there when saturated (existing behavior).
            start = zlib.crc32(model_id.encode()) % n
            for i in range(n):
                r = replicas[(start + i) % n]
                if free(r):
                    return r
            return None
        if prefix_hint:
            # Cache-aware: the replica holding the shared prefix blocks,
            # else spill to the least-loaded unsaturated replica.
            r = replicas[zlib.crc32(prefix_hint.encode()) % n]
            if free(r):
                return r
            candidates = [x for x in replicas if free(x)]
            if not candidates:
                return None
            return min(
                candidates, key=lambda x: self._inflight.get(x["actor_name"], 0)
            )
        start = self._rr.get(deployment, 0)
        for i in range(n):
            r = replicas[(start + i) % n]
            if free(r):
                self._rr[deployment] = (start + i + 1) % n
                return r
        return None

    def _set_queue_depth_locked(self, deployment: str):
        """Refresh the deployment's in-flight gauge (caller holds _lock).
        Updated on BOTH assign and release — a gauge only set on assign
        would report the peak depth forever once traffic stops."""
        entry = self._table.get(deployment)
        if entry is None:
            return
        self._metrics["serve_queue_depth"].set(
            sum(self._inflight.get(r["actor_name"], 0) for r in entry["replicas"]),
            tags={"deployment": deployment},
        )

    def release(self, replica, deployment: str | None = None, duration_s: float | None = None):
        with self._lock:
            name = replica["actor_name"]
            self._inflight[name] = max(0, self._inflight.get(name, 0) - 1)
            self._avail.notify_all()  # wake assigns parked on saturation
            if deployment is not None:
                try:
                    self._set_queue_depth_locked(deployment)
                except Exception:
                    pass
        if deployment is not None and duration_s is not None:
            try:
                self._metrics["serve_latency"].observe(
                    duration_s, tags={"deployment": deployment}
                )
            except Exception:
                pass

    # How long a drain verdict sticks without confirmation. Long enough to
    # outlive the controller's table update (which removes the replica for
    # real), short enough that a reused actor name or an aborted drain
    # re-enters rotation on its own.
    _DRAINING_TTL_S = 60.0

    def mark_draining(self, replica_or_name, ttl_s: float | None = None):
        """A caller saw this replica refuse a request with the typed
        ReplicaDrainingError: take it out of every assignment policy until
        the routing table catches up (or the TTL expires)."""
        name = (
            replica_or_name["actor_name"]
            if isinstance(replica_or_name, dict)
            else replica_or_name
        )
        with self._lock:
            self._draining[name] = time.monotonic() + (
                self._DRAINING_TTL_S if ttl_s is None else ttl_s
            )

    def is_draining(self, replica_or_name) -> bool:
        name = (
            replica_or_name["actor_name"]
            if isinstance(replica_or_name, dict)
            else replica_or_name
        )
        with self._lock:
            self._prune_draining_locked()
            return name in self._draining

    def _prune_draining_locked(self):
        now = time.monotonic()
        for name, expiry in list(self._draining.items()):
            if expiry <= now:
                del self._draining[name]

    # Positive liveness verdicts are cached briefly so the per-call probe
    # costs ~one GCS RPC per replica per window, not one per request —
    # the race window the probe closes narrows from forever to the TTL.
    _ALIVE_TTL_S = 2.0

    def replica_alive(self, replica) -> bool:
        """Bounded GCS probe (TTL-cached when positive): is the replica's
        actor still registered and not DEAD? Closes the assign->dead-replica
        race for handle calls — a replica that died after assignment but
        before accepting is detectable here, and the caller reassigns
        instead of handing its caller a doomed ref. Unknown (GCS
        unreachable) reads as alive: the probe must never turn a healthy
        call into a failure."""
        from ray_tpu_torch._private.worker_context import get_core_worker

        name = replica["actor_name"]
        now = time.monotonic()
        with self._lock:
            stamp = self._alive_cache.get(name)
            if stamp is not None and now - stamp < self._ALIVE_TTL_S:
                return True
        try:
            cw = get_core_worker()
            resp = cw.gcs.call(
                "get_actor",
                {"name": name, "namespace": cw.namespace},
                timeout=2,
            )
        except Exception:
            return True
        alive = resp.get("found", False) and resp["info"].get("state") != "DEAD"
        with self._lock:
            if alive:
                self._alive_cache[name] = now
            else:
                self._alive_cache.pop(name, None)
        return alive

    def handle_for(self, replica) -> object:
        name = replica["actor_name"]
        handle = self._handles.get(name)
        if handle is None:
            handle = ray_tpu_torch.get_actor(name)
            self._handles[name] = handle
        return handle

    def invalidate_handle(self, replica):
        self._handles.pop(replica["actor_name"], None)
        with self._lock:
            self._alive_cache.pop(replica["actor_name"], None)
