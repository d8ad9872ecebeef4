"""Owner-side worker-lease transport for normal tasks.

Analog of the reference's direct task transport
(src/ray/core_worker/transport/direct_task_transport.cc:304 lease
pipelining + lease_policy.h): the owner leases whole WORKERS from the
raylet — lease requests ride the normal scheduling queue, so placement,
fairness and resource accounting are unchanged — and then ships ready
tasks DIRECTLY to the leased worker, pipelined, with results flowing back
over the worker->owner channel that actor calls already use.

The effect on the per-task control plane: the raylet sees one lease
request per held worker instead of four RPCs per task
(submit -> dispatch -> push_task -> task_finished), which is what held
task throughput to sync-rate regardless of pipelining depth.

Leases are keyed by (runtime_env, resource shape). A lease is returned
when its shape's queue drains (after a short linger so sync call loops
reuse it), renewed periodically, and failed over: if the worker dies, its
in-flight specs are resubmitted up to each task's max_retries
(reference: task_manager.cc retriable-failure path).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field

from ray_tpu_torch._private import flight_recorder, self_metrics
from ray_tpu_torch._private.concurrency import any_thread, loop_only
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.exceptions import WorkerCrashedError

logger = logging.getLogger(__name__)


def _bg(coro):
    """Fire-and-forget on the current loop, consuming exceptions (best-effort
    control RPCs like return_worker_lease race shutdown by design)."""
    task = asyncio.ensure_future(coro)
    task.add_done_callback(lambda t: t.cancelled() or t.exception())
    return task


class _LeaseStats:
    """Plain-int lease counters — _feed runs once per staged chunk on the
    dispatch hot loop, where an instrument lock + tag-dict per inc is
    measurable. Folded into ray_tpu_lease_* Counters at metrics-flush
    cadence (self_metrics collector), like rpc.WIRE."""

    __slots__ = ("grants", "reuses", "tasks")

    def __init__(self):
        self.grants = 0
        self.reuses = 0
        self.tasks = 0


LEASE_STATS = _LeaseStats()


class _Lease:
    __slots__ = (
        "lease_id", "worker_id", "address", "client", "shape", "inflight",
        "last_active", "raylet_addr", "ever_used",
    )

    def __init__(self, lease_id, worker_id, address, client, shape, raylet_addr):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.address = address
        self.client = client
        self.shape = shape
        self.inflight: dict[str, TaskSpec] = {}
        self.last_active = time.monotonic()
        # The raylet holding the lease record — a PEER when the request was
        # spilled; renew/return against anything else silently no-ops and
        # the granting raylet reaps the healthy worker at lease expiry.
        self.raylet_addr = raylet_addr
        # Observability: once a first batch has shipped, later batches count
        # as warm reuses (the hit side of the warm-lease hit ratio).
        self.ever_used = False


@dataclass(eq=False)  # identity hash: shapes are collected in sets
class _Shape:
    key: tuple
    resources: dict
    runtime_env: dict
    queue: deque = field(default_factory=deque)
    leases: dict = field(default_factory=dict)  # lease_id -> _Lease
    pending_requests: set = field(default_factory=set)
    # EMA of observed task duration; drives the staging-depth policy.
    avg_task_s: float | None = None


class LeaseManager:
    """All state lives on the owner's IO loop thread; submit() is the only
    cross-thread entry point."""

    def __init__(self, cw):
        self.cw = cw
        self.cfg = cw.cfg
        self._shapes: dict[tuple, _Shape] = {}
        self._task_lease: dict[str, _Lease] = {}
        self._attempts: dict[str, int] = {}
        self._maintenance_task = None
        self._closed = False
        import threading

        self._submit_lock = threading.Lock()
        self._submit_buf: list = []
        self._submit_scheduled = False
        self._raylet_clients: dict[tuple, RpcClient] = {}
        self._metrics = self_metrics.instruments()

    def _update_pool_gauge(self):
        try:
            self._metrics["lease_pool"].set(
                sum(len(s.leases) for s in self._shapes.values())
            )
        except Exception:
            pass

    def _raylet_for(self, addr):
        """Control client for the raylet holding a lease record (the LOCAL
        raylet unless the request was spilled to a peer)."""
        if addr is None or tuple(addr) == tuple(self.cw.raylet.address):
            return self.cw.raylet
        key = tuple(addr)
        client = self._raylet_clients.get(key)
        if client is None:
            client = self._raylet_clients[key] = RpcClient(key, label=f"lease-raylet")
        return client

    # ---- entry points ----

    @any_thread
    def submit(self, spec: TaskSpec):
        """Any-thread entry: queue the ready-to-run spec for lease dispatch.
        Bursts coalesce into ONE loop hop (a per-spec call_soon_threadsafe
        was measurable at 100-in-flight submission rates)."""
        with self._submit_lock:
            self._submit_buf.append(spec)
            if self._submit_scheduled:
                return
            self._submit_scheduled = True
        self.cw._io.loop.call_soon_threadsafe(self._drain_entry)

    @loop_only
    def _drain_entry(self):
        """Loop callback. The warm sync ping-pong case — ONE pending spec,
        a warm lease with room — stages and writes the lease_exec frame
        synchronously right here: zero further loop hops between the user
        thread's wakeup of the loop and the frame hitting the socket.
        Bursts fall back to the coalescing async drain."""
        with self._submit_lock:
            single = len(self._submit_buf) == 1
            if single:
                batch, self._submit_buf = self._submit_buf, []
                self._submit_scheduled = False
        if not single:
            asyncio.ensure_future(self._drain_submits())
            return
        spec = batch[0]
        shape = self._shape_for(spec)
        shape.queue.append(spec)
        self._pump(shape)

    async def _drain_submits(self):
        await asyncio.sleep(0)  # let the submitting thread's burst accumulate
        with self._submit_lock:
            batch, self._submit_buf = self._submit_buf, []
            self._submit_scheduled = False
        shapes = []
        for spec in batch:
            shape = self._shape_for(spec)
            shape.queue.append(spec)
            if shape not in shapes:
                shapes.append(shape)
        for shape in shapes:
            self._pump(shape)

    def _shape_for(self, spec: TaskSpec) -> _Shape:
        key = (
            json.dumps(spec.runtime_env, sort_keys=True) if spec.runtime_env else "",
            tuple(sorted(spec.resources.items())),
        )
        shape = self._shapes.get(key)
        if shape is None:
            shape = self._shapes[key] = _Shape(
                key=key, resources=dict(spec.resources), runtime_env=dict(spec.runtime_env)
            )
        return shape

    # ---- dispatch ----

    @loop_only
    def _pump(self, shape: _Shape):
        """Synchronous (IO-loop-only): stages ready specs onto warm leases —
        writing the lease_exec frames inline on warm connections — and tops
        up lease requests. Only the RPC *acks* are awaited, in background
        tasks, so one dead worker's 15s timeout can never head-of-line
        block other shapes/leases."""
        if self._closed:
            return
        for lease in list(shape.leases.values()):
            if not shape.queue:
                break
            self._feed(lease)
        want = min(len(shape.queue), self.cfg.lease_max_per_shape) - (
            len(shape.leases) + len(shape.pending_requests)
        )
        for _ in range(max(0, want)):
            asyncio.ensure_future(self._request_lease(shape))
        if self._maintenance_task is None or self._maintenance_task.done():
            self._maintenance_task = asyncio.ensure_future(self._maintenance_loop())

    @loop_only
    def _feed(self, lease: _Lease):
        shape = lease.shape
        # Staging depth adapts to OBSERVED task duration: short tasks stack
        # up to lease_max_inflight (the per-completion round trip would
        # otherwise dominate), long tasks go 1-per-worker — stacking them
        # would serialize work on one lease while other leased workers
        # idle, and parallelism for long tasks comes from MORE leases.
        # Unknown duration (nothing completed yet) is treated as long: the
        # first completion of a fast burst unlocks stacking within ~1ms.
        if shape.avg_task_s is not None and shape.avg_task_s < 0.05:
            depth = self.cfg.lease_max_inflight
        else:
            depth = 1
        room = depth - len(lease.inflight)
        if room <= 0 or not shape.queue:
            return
        chunk = []
        while shape.queue and len(chunk) < room:
            chunk.append(shape.queue.popleft())
        # Warm-lease hit accounting: plain ints on the hottest owner-side
        # loop, folded into instruments at flush time. The flight EVENT is
        # sampled 1-in-64 (with the cumulative reuse count in the detail):
        # task_ship already narrates the ring per task, and a per-chunk
        # reuse event was a measurable slice of the sync-loop budget.
        LEASE_STATS.tasks += len(chunk)
        if lease.ever_used:
            reuses = LEASE_STATS.reuses = LEASE_STATS.reuses + len(chunk)
            if reuses & 63 < len(chunk):
                flight_recorder.record(
                    "lease_reuse", f"{lease.lease_id[:8]}:n={reuses}"
                )
        else:
            lease.ever_used = True
        now = time.monotonic()
        for s in chunk:
            lease.inflight[s.task_id] = s
            self._task_lease[s.task_id] = lease
        lease.last_active = now
        payload = {"specs": [s.to_wire() for s in chunk]}
        # Warm connection: the frame is written synchronously HERE (no
        # task-scheduling iteration between staging and the wire); only the
        # accepted-ack is awaited in the background.
        fut = lease.client.send_nowait("lease_exec", payload)
        if fut is not None:
            _bg(self._await_exec_ack(lease, fut))
        else:
            _bg(self._send_exec(lease, payload))

    async def _await_exec_ack(self, lease: _Lease, fut):
        try:
            await asyncio.wait_for(fut, 15)
        except Exception:
            await self._lease_failed(lease, "lease_exec failed")

    async def _send_exec(self, lease: _Lease, payload: dict):
        try:
            await lease.client.acall("lease_exec", payload, timeout=15)
        except Exception:
            await self._lease_failed(lease, "lease_exec failed")

    async def _request_lease(self, shape: _Shape):
        lease_id = os.urandom(12).hex()
        shape.pending_requests.add(lease_id)
        # Locality hint: the head-of-queue task's REFERENCE args ride the
        # lease request (oid + owner only — never inline bytes), so the
        # raylet can prefer a holder node when placing the lease
        # (raylet._locality_prefs; the lease is what spills back).
        head = shape.queue[0] if shape.queue else None
        ref_args = (
            [a for a in head.args if isinstance(a, (list, tuple)) and a and a[0] == "r"]
            if head is not None
            else []
        )
        rep = TaskSpec(
            task_id=lease_id,
            job_id=self.cw.job_id.hex(),
            name="__lease__",
            args=ref_args[: self.cfg.locality_max_args],
            resources=dict(shape.resources),
            runtime_env=dict(shape.runtime_env),
            owner_addr=list(self.cw.address),
            owner_worker_id=self.cw.worker_id,
            lease_id=lease_id,
        )
        try:
            resp = await self.cw.raylet.acall(
                "request_worker_lease",
                # backlog rides the lease request so the autoscaler still
                # sees owner-side queue depth as demand (reference:
                # direct_task_transport.cc backlog_size reporting).
                {"spec": rep.to_wire(), "backlog": len(shape.queue)},
                timeout=self.cfg.worker_lease_timeout_s + 10,
            )
        except Exception:
            resp = {"granted": False}
        shape.pending_requests.discard(lease_id)
        if self._closed or not resp.get("granted"):
            if self._closed and resp.get("granted"):
                _bg(self._raylet_for(resp.get("raylet_address")).acall(
                    "return_worker_lease", {"lease_id": lease_id}))
                return
            if not resp.get("granted"):
                # Make sure no stale request/future lingers at the raylet
                # (e.g. our acall failed at transport level before the
                # server-side timeout resolved it).
                _bg(self.cw.raylet.acall("cancel_lease_request", {"lease_id": lease_id}))
            # No grant (cluster saturated / timeout). If work remains and
            # nothing is coming, retry after a beat instead of spinning.
            if shape.queue and not shape.leases and not shape.pending_requests:
                await asyncio.sleep(0.2)
                self._pump(shape)
            return
        client = RpcClient(tuple(resp["address"]), label=f"lease-{resp['worker_id'][:8]}")
        lease = _Lease(
            lease_id, resp["worker_id"], tuple(resp["address"]), client, shape,
            tuple(resp.get("raylet_address") or self.cw.raylet.address),
        )
        shape.leases[lease_id] = lease
        flight_recorder.record(
            "lease_grant", f"{lease_id[:8]}:worker={resp['worker_id'][:8]}"
        )
        LEASE_STATS.grants += 1
        self._update_pool_gauge()
        self._feed(lease)

    # ---- completion / failure ----

    @loop_only
    def cancel_queued(self, task_id: str) -> bool:
        """Recall a spec still staged owner-side (pre-ship). IO-loop only."""
        with self._submit_lock:
            for s in self._submit_buf:
                if s.task_id == task_id:
                    self._submit_buf.remove(s)
                    return True
        for shape in self._shapes.values():
            for s in shape.queue:
                if s.task_id == task_id:
                    shape.queue.remove(s)
                    self._attempts.pop(task_id, None)
                    return True
        return False

    @loop_only
    def lease_for(self, task_id: str):
        """The lease (worker) a shipped task is in flight on, if any."""
        return self._task_lease.get(task_id)

    @loop_only
    def on_task_done(self, task_id: str, duration_s: float | None = None):
        """Bookkeeping on result arrival (the payload itself is handled by
        CoreWorker._handle_task_done). Returns the shape to top up."""
        self._attempts.pop(task_id, None)
        lease = self._task_lease.pop(task_id, None)
        if lease is None:
            return None
        lease.inflight.pop(task_id, None)
        lease.last_active = time.monotonic()
        shape = lease.shape
        if duration_s is not None:
            shape.avg_task_s = (
                duration_s
                if shape.avg_task_s is None
                else 0.8 * shape.avg_task_s + 0.2 * duration_s
            )
        return shape

    @loop_only
    def topup(self, shapes):
        for shape in shapes:
            if shape is not None and (shape.queue or shape.pending_requests):
                self._pump(shape)

    @loop_only
    def on_lease_revoked(self, lease_id: str, oom: bool = False, reason: str = "revoked by raylet"):
        for shape in self._shapes.values():
            lease = shape.leases.get(lease_id)
            if lease is not None:
                asyncio.ensure_future(self._lease_failed(lease, reason, oom=oom))
                return

    async def _lease_failed(self, lease: _Lease, reason: str, oom: bool = False):
        shape = lease.shape
        if shape.leases.pop(lease.lease_id, None) is None:
            return  # already handled
        flight_recorder.record("lease_revoked", f"{lease.lease_id[:8]}:{reason[:40]}")
        self._update_pool_gauge()
        logger.warning("lease %s failed (%s); %d tasks to retry",
                       lease.lease_id[:8], reason, len(lease.inflight))
        lease.client.close()
        respecs = list(lease.inflight.values())
        lease.inflight.clear()
        _bg(self._raylet_for(lease.raylet_addr).acall(
            "return_worker_lease", {"lease_id": lease.lease_id}))
        for s in respecs:
            self._task_lease.pop(s.task_id, None)
            pending = self.cw.pending_tasks.get(s.task_id)
            if pending is not None and pending.cancel_requested:
                # Cancelled task caught in the failover (e.g. force-kill of
                # the leased worker): surface cancellation, never resubmit.
                self._attempts.pop(s.task_id, None)
                self.cw._fail_task(s.task_id, self.cw._cancel_error(s))
                continue
            attempts = self._attempts.get(s.task_id, 0)
            if attempts < s.max_retries:
                self._attempts[s.task_id] = attempts + 1
                shape.queue.append(s)
            else:
                self._attempts.pop(s.task_id, None)
                if oom:
                    from ray_tpu_torch.exceptions import OutOfMemoryError

                    err: Exception = OutOfMemoryError(
                        f"task {s.name} ({s.task_id[:8]}) failed: {reason}"
                    )
                else:
                    err = WorkerCrashedError(
                        f"worker {lease.worker_id[:8]} died executing leased task "
                        f"({reason}); retries exhausted"
                    )
                self.cw._fail_task(s.task_id, err)
        self._pump(shape)

    # ---- maintenance ----

    async def _maintenance_loop(self):
        while not self._closed:
            await asyncio.sleep(2.0)
            now = time.monotonic()
            by_raylet: dict[tuple, list] = {}
            for shape in self._shapes.values():
                for lease in list(shape.leases.values()):
                    if (
                        not lease.inflight
                        and not shape.queue
                        and now - lease.last_active > self.cfg.lease_idle_release_s
                    ):
                        shape.leases.pop(lease.lease_id, None)
                        lease.client.close()
                        flight_recorder.record("lease_release", lease.lease_id[:8])
                        self._update_pool_gauge()
                        _bg(self._raylet_for(lease.raylet_addr).acall(
                            "return_worker_lease", {"lease_id": lease.lease_id}))
                        continue
                    by_raylet.setdefault(lease.raylet_addr, []).append(lease.lease_id)
                    if lease.inflight and now - lease.last_active > 30.0:
                        # No completion in a long time: probe the worker; a
                        # dead one fails over without waiting for the raylet.
                        asyncio.ensure_future(self._probe(lease))
            # Renew against the raylet that HOLDS each lease (spilled grants
            # live on peers). The LOCAL raylet's renewal also carries the
            # owner's current per-shape backlog: under warm leases the
            # initial request's backlog figure goes stale while the lease is
            # held, and the autoscaler must keep seeing the live queue depth
            # (reference: backlog_size reporting in ReportWorkerBacklog).
            local = tuple(self.cw.raylet.address)
            for addr, ids in by_raylet.items():
                payload = {"lease_ids": ids, "owner": self.cw.worker_id}
                if tuple(addr) == local:
                    payload["backlogs"] = [
                        [dict(s.resources), len(s.queue)]
                        for s in self._shapes.values()
                    ]
                try:
                    resp = await self._raylet_for(addr).acall(
                        "renew_worker_leases", payload, timeout=10
                    )
                    for lid in resp.get("revoked", []):
                        self.on_lease_revoked(lid)
                except Exception:
                    pass

    async def _probe(self, lease: _Lease):
        try:
            await lease.client.acall("lease_ping", {}, timeout=5)
            lease.last_active = time.monotonic()
        except Exception:
            await self._lease_failed(lease, "worker unresponsive")

    @any_thread
    def close(self):
        self._closed = True
        if self._maintenance_task is not None:
            # asyncio.Task.cancel is NOT threadsafe and close() runs on the
            # caller's (shutdown) thread: hop to the loop. Found by graftlint
            # while annotating this file.
            self.cw._io.loop.call_soon_threadsafe(self._maintenance_task.cancel)

        async def _release_all():
            for shape in self._shapes.values():
                for lease in list(shape.leases.values()):
                    lease.client.close()
                    try:
                        await self._raylet_for(lease.raylet_addr).acall(
                            "return_worker_lease", {"lease_id": lease.lease_id}, timeout=2
                        )
                    except Exception:
                        pass
                shape.leases.clear()
            for client in self._raylet_clients.values():
                client.close()

        try:
            self.cw._io.spawn(_release_all()).result(timeout=5)
        except Exception:
            pass
