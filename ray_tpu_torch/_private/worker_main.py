"""Worker process entry point.

Analog of the reference's default_worker.py + the Cython task
execution handler (python/ray/_private/workers/default_worker.py,
_raylet.pyx:1791 task_execution_handler): spawned by the raylet's worker pool,
registers back, then serves

- ``push_task`` from the raylet (normal + actor-creation tasks)
- ``actor_call`` directly from callers (the direct actor transport —
  reference: direct_actor_task_submitter.h:67 server side,
  actor_scheduling_queue.h:40 ordering)
- ``kill_self`` for ray_tpu_torch.kill / actor teardown.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ray_tpu_torch._private.concurrency import any_thread, loop_only

logger = logging.getLogger(__name__)


def _set_result_if_pending(fut, payload):
    if not fut.done():
        fut.set_result(payload)


class _MainThreadExecutor:
    """Executor-protocol shim that runs submitted callables on the worker's
    MAIN thread (worker_main.main() drains the queue in run_forever).

    Tasks must execute on the main thread so that non-force
    ray_tpu_torch.cancel() can interrupt C-blocked calls: CPython delivers signal
    handlers only to the main thread, and a handler that raises aborts the
    in-flight blocking call (PEP 475). The reference runs tasks on the
    worker main thread and cancels via KeyboardInterrupt for exactly this
    reason (_raylet.pyx task_execution_handler + CancelTask).

    Duck-types concurrent.futures.Executor far enough for
    loop.run_in_executor (submit) and CoreWorker teardown (shutdown)."""

    def __init__(self):
        import queue

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._stopped = False

    @any_thread
    def submit(self, fn, *args, **kwargs):
        import concurrent.futures

        fut = concurrent.futures.Future()
        self._q.put((fut, fn, args, kwargs))
        return fut

    @any_thread
    def submit_callback(self, fn, args, callback):
        """Zero-Future fast path: run fn(*args) on the exec thread, deliver
        the result to callback(result) ON THAT THREAD (callers hop back to
        their loop themselves). Saves the cf.Future + wrap_future + done-
        callback machinery per task — measurable on the lease hot loop."""
        self._q.put((None, fn, args, callback))

    def run_forever(self):
        while not self._stopped:
            item = self._q.get()
            if item is None:
                break
            fut, fn, args, kwargs = item
            if fut is None:  # submit_callback fast path
                callback = kwargs
                try:
                    result = fn(*args)
                except BaseException:  # noqa: BLE001 — fn is _safe_execute-
                    # class (never raises); a raise here is a framework bug,
                    # but the callback must still fire or a task is lost.
                    logger.exception("submit_callback fn raised")
                    result = None
                try:
                    callback(result)
                except BaseException:  # noqa: BLE001
                    logger.exception("submit_callback delivery failed")
                continue
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — ship to the waiter
                fut.set_exception(e)
            else:
                fut.set_result(result)

    def shutdown(self, wait=True, cancel_futures=False):
        self._stopped = True
        self._q.put(None)


class WorkerExecutor:
    def __init__(self, core_worker, raylet_client):
        self.cw = core_worker
        self.raylet = raylet_client
        self._loop = core_worker._io.loop
        self._concurrency_pool: ThreadPoolExecutor | None = None
        server = core_worker.server
        server.register("push_task", self.rpc_push_task)
        server.register("actor_call", self.rpc_actor_call)
        server.register("actor_has_task", self.rpc_actor_has_task)
        server.register("kill_self", self.rpc_kill_self)
        server.register("lease_exec", self.rpc_lease_exec)
        server.register("lease_ping", self.rpc_lease_ping)
        server.register("cancel_exec", self.rpc_cancel_exec)
        # Channel-loop mode (compiled execution graphs, dag/compiled.py):
        # install starts a resident loop on a dedicated thread that serves
        # channel iterations with no per-call task spec / ObjectRef / raylet
        # RPC; classic calls keep flowing through the main exec queue.
        server.register("channel_loop_install", self.rpc_channel_loop_install)
        server.register("channel_loop_stop", self.rpc_channel_loop_stop)
        server.register("channel_loop_stats", self.rpc_channel_loop_stats)
        self._channel_loops: dict = {}
        # Leased-task pipeline (reference: direct task transport worker side,
        # core_worker.cc task receiver): owners ship batches of specs; we
        # execute FIFO (the main-thread exec queue) and push completion
        # payloads back, coalescing results that finish while a previous
        # report RPC is still in flight.
        self._done_buf: list = []
        self._done_flushing = False
        # Queued-but-unstarted specs (task_id -> ("lease", owner_addr, spec)
        # or ("actor", fut, spec)): lets pre-dispatch cancellation resolve
        # the caller IMMEDIATELY instead of waiting behind the running task.
        # Entries pop at execution start (exec thread; GIL-atomic dict ops).
        self._fast_queued: dict = {}
        # Actor-call at-least-once state: received task ids (duplicate
        # frames must NOT re-execute the method) and a bounded cache of
        # recent results (re-answers a duplicate/probe after the original
        # response frame was lost). See rpc_actor_call/rpc_actor_has_task.
        from collections import deque

        from ray_tpu_torch._private.ids import BoundedIdSet

        self._actor_call_seen = BoundedIdSet(cap=4096)
        self._actor_results: dict = {}
        self._actor_results_order: deque = deque()

    def _safe_execute(self, spec):
        """execute_task catches everything inside its own try; anything that
        escapes is either a cancellation async-exc that landed a few
        bytecodes late (after the task body returned — the tombstone for
        spec.task_id is still set because the FINISHED path never consumes
        it) or a genuine internal error. Only the former becomes a
        cancelled payload; misreporting an internal error as CANCELLED
        would suppress the owner's retries and hide the real failure."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.exceptions import TaskCancelledError, TaskError

        try:
            return self.cw.execute_task(spec)
        except BaseException as e:  # noqa: BLE001 — must not kill the loop
            if (
                isinstance(e, TaskCancelledError)
                and spec.task_id in self.cw._cancelled_tasks
            ):
                self.cw._cancelled_tasks.discard(spec.task_id)
                return self.cw.cancelled_payload(spec)
            logger.exception("task %s escaped execute_task", spec.task_id[:8])
            err = TaskError.from_exception(e, task_name=spec.name)
            return {
                "task_id": spec.task_id,
                "results": [],
                "error": serialization.serialize(err).to_bytes(),
                "duration_s": 0.0,
            }

    # ---- normal / actor-creation tasks ----

    async def rpc_push_task(self, req):
        from ray_tpu_torch._private.task_spec import TaskSpec

        spec = TaskSpec.from_wire(req["spec"])
        asyncio.ensure_future(self._execute_pushed(spec))
        return {"ok": True}

    async def _execute_pushed(self, spec):
        loop = asyncio.get_event_loop()
        payload = await loop.run_in_executor(self.cw._executor, self._safe_execute, spec)
        if spec.is_actor_creation():
            await self._finish_actor_creation(spec, payload)
        else:
            payload["cid"] = os.urandom(8).hex()  # owner-side duplicate filter
            # Piggybacked completion: once the task_done frame is ON THE
            # WIRE, task_finished runs concurrently with the owner's ack
            # (was two serial RTTs per classic-path task). Ordering is
            # load-bearing: freeing the worker FIRST would let a crash in
            # the window clear worker.current_task at the raylet, so a
            # death before the owner got the result would send no
            # task_failed and the owner would wait for the slow lost-task
            # sweep. task_finished stays an acknowledged, retried acall — a
            # one-way push frame lost to a resetting connection would
            # strand the worker 'busy' forever.
            sent = None
            if spec.owner_addr is not None:
                try:
                    owner = self.cw._owner_client(tuple(spec.owner_addr))
                    sent = owner.send_nowait("task_done", payload)
                except Exception:
                    sent = None
            if sent is None:
                # Cold or backpressured owner connection: keep the fully
                # crash-safe serial order (owner ack, then free the worker).
                await self._report_to_owner(spec, payload)
                try:
                    await self.raylet.acall(
                        "task_finished", {"worker_id": self.cw.worker_id}
                    )
                except Exception:
                    pass
            else:
                fin = asyncio.ensure_future(
                    self.raylet.acall("task_finished", {"worker_id": self.cw.worker_id})
                )
                fin.add_done_callback(lambda t: t.cancelled() or t.exception())
                try:
                    # Bounded ack wait: a task_done frame lost WITHOUT a
                    # connection reset (the receiver dropped it)
                    # used to park this await forever and the owner's get()
                    # with it until the lost-task sweep. On timeout the
                    # stale pending entry is unregistered and the payload
                    # re-delivers through the acked retrying path (the
                    # owner drops the duplicate by cid).
                    await asyncio.wait_for(
                        sent, self.cw.cfg.task_done_ack_timeout_s
                    )
                except Exception:
                    # Connection failed or the ack never came: re-deliver
                    # through the retrying path (owner dedupes by cid).
                    seq = getattr(sent, "_rtpu_seq", None)
                    if seq is not None and spec.owner_addr is not None:
                        try:
                            self.cw._owner_client(
                                tuple(spec.owner_addr)
                            )._pending.pop(seq, None)
                        except Exception:
                            pass
                    await self._report_to_owner(spec, payload)

    async def _report_to_owner(self, spec, payload):
        if spec.owner_addr is None:
            return
        try:
            owner = self.cw._owner_client(tuple(spec.owner_addr))
            # Per-attempt ack bound so a silently lost frame retries (acall
            # re-sends on TimeoutError; the owner dedupes by cid) instead
            # of parking this coroutine on an unresolvable future.
            await owner.acall(
                "task_done", payload, timeout=self.cw.cfg.task_done_ack_timeout_s
            )
        except Exception:
            logger.warning("could not report task %s to owner", spec.task_id[:8])

    async def _finish_actor_creation(self, spec, payload):
        if payload.get("error") is None:
            if spec.max_concurrency > 1:
                self._concurrency_pool = ThreadPoolExecutor(
                    max_workers=spec.max_concurrency, thread_name_prefix="actor-cg"
                )
            # max_concurrency == 1 needs no queue of its own: ordered calls
            # ride the main-thread exec queue (rpc_actor_call fast path).
            resp = await self.cw.gcs.acall(
                "actor_alive",
                {
                    "actor_id": spec.actor_id,
                    "address": list(self.cw.address),
                    "node_id": self.cw.node_id,
                    "worker_id": self.cw.worker_id,
                },
            )
            if resp.get("duplicate"):
                # Another worker already owns this actor (e.g. GCS-restart
                # recovery raced an in-flight creation); the incumbent wins.
                logger.warning("duplicate actor %s; exiting", spec.actor_id[:8])
                os._exit(0)
            if resp.get("killed"):
                # kill() reached the GCS before this creation finished.
                logger.warning("actor %s was killed during its creation; exiting", spec.actor_id[:8])
                os._exit(0)
            await self.raylet.acall("actor_ready", {"worker_id": self.cw.worker_id})
        else:
            logger.error("actor %s __init__ failed", spec.actor_id[:8])
            try:
                await self.cw.gcs.acall(
                    "report_worker_death",
                    {"actor_ids": [spec.actor_id], "reason": "actor __init__ raised"},
                )
            finally:
                os._exit(1)

    # ---- leased normal tasks (reference: direct_task_transport worker side) ----

    async def rpc_lease_ping(self, req):
        return {"ok": True}

    async def rpc_lease_exec(self, req):
        from ray_tpu_torch._private.task_spec import TaskSpec

        specs = [TaskSpec.from_wire(wire) for wire in req["specs"]]
        ex = self.cw._executor
        if hasattr(ex, "submit_callback"):
            # Hot loop: specs go straight onto the main-thread exec queue
            # (FIFO preserved — one queue, one thread) and completions hop
            # back with a single call_soon_threadsafe each. No consumer
            # coroutine, no cf.Future per task.
            import functools

            for spec in specs:
                self._fast_queued[spec.task_id] = ("lease", tuple(spec.owner_addr), spec)
                ex.submit_callback(
                    self._fast_execute,
                    (spec,),
                    functools.partial(
                        self._lease_result_from_thread, tuple(spec.owner_addr), spec
                    ),
                )
        else:
            # Fallback executors (no submit_callback) are single-worker
            # ThreadPoolExecutors — submission order IS execution order.
            loop = asyncio.get_event_loop()
            for spec in specs:
                asyncio.ensure_future(self._lease_exec_fallback(loop, spec))
        # Ack = accepted-into-queue, not executed: the owner's flow control
        # is per-task (tasks_done), so the ack must not wait on execution.
        return {"accepted": len(specs)}

    async def _lease_exec_fallback(self, loop, spec):
        payload = await loop.run_in_executor(self.cw._executor, self._safe_execute, spec)
        self._lease_done(tuple(spec.owner_addr), payload)

    def _fast_execute(self, spec):
        """Exec-thread entry: unregister from the queued set, then run.
        A cancel that raced us already delivered a cancelled payload and
        tombstoned the id — execute_task's entry check drops the body and
        the duplicate completion is ignored by the owner (pending popped)."""
        self._fast_queued.pop(spec.task_id, None)
        return self._safe_execute(spec)

    def _bug_payload(self, spec):
        """A completion for a spec whose execution path itself broke:
        dropping it instead would hang the owner forever (its lease probe
        pings THIS worker, which is alive)."""
        from ray_tpu_torch._private import serialization
        from ray_tpu_torch.exceptions import TaskError

        err = TaskError.from_exception(
            RuntimeError("worker framework error during task execution"),
            task_name=spec.name,
        )
        return {
            "task_id": spec.task_id,
            "results": [],
            "error": serialization.serialize(err).to_bytes(),
            "duration_s": 0.0,
        }

    @any_thread
    def _lease_result_from_thread(self, owner_addr, spec, payload):
        """Runs on the exec thread; marshal the completion to the loop."""
        if payload is None:  # submit_callback swallowed a framework bug
            payload = self._bug_payload(spec)
        self._loop.call_soon_threadsafe(self._lease_done, owner_addr, payload)

    @loop_only
    def _lease_done(self, owner_addr, payload):
        # Delivery here is at-least-once (both the direct-send fallback and
        # _flush_done re-send payloads whose connection failed after the
        # frame may already have arrived); the cid lets the owner drop the
        # duplicates instead of double-consuming retry budget.
        payload.setdefault("cid", os.urandom(8).hex())
        # Clear pipe + warm connection: write the tasks_done frame NOW
        # (zero scheduling between completion and the wire). Failures fall
        # back into the buffered retry path below, which is also taken
        # whenever a flush is already in flight (keeps rough FIFO).
        if not self._done_buf and not self._done_flushing:
            fut = None
            try:
                owner = self.cw._owner_client(owner_addr)
                fut = owner.send_nowait("tasks_done", {"batch": [payload]})
            except Exception:
                fut = None
            if fut is not None:
                def _delivered(f, oa=owner_addr, p=payload):
                    if f.cancelled() or f.exception() is not None:
                        self._lease_done_buffered(oa, p)

                fut.add_done_callback(_delivered)

                # Ack watchdog: a tasks_done frame lost WITHOUT a reset
                # (silent receiver drop) resolves this future
                # never — the owner's get() used to hang forever because
                # its lease probe pings THIS worker, which is alive.
                # Cancelling routes into _delivered -> the acked retrying
                # path (owner dedupes by cid).
                def _ack_timeout(f=fut, oa=owner_addr):
                    if f.done():
                        return
                    seq = getattr(f, "_rtpu_seq", None)
                    if seq is not None:
                        try:
                            self.cw._owner_client(oa)._pending.pop(seq, None)
                        except Exception:
                            pass
                    f.cancel()

                self._loop.call_later(
                    self.cw.cfg.task_done_ack_timeout_s, _ack_timeout
                )
                return
        self._lease_done_buffered(owner_addr, payload)

    @loop_only
    def _lease_done_buffered(self, owner_addr, payload):
        self._done_buf.append((owner_addr, payload))
        if not self._done_flushing:
            self._done_flushing = True
            asyncio.ensure_future(self._flush_done())

    async def _flush_done(self):
        """Deliver completion payloads, re-queuing on failure: dropping a
        batch would leave the owner's get() hanging forever — its lease
        probe only pings THIS worker, which is alive. Bounded retries: a
        permanently unreachable owner is dead, and dead owners' results
        are garbage."""
        try:
            attempts = 0
            while self._done_buf:
                batch, self._done_buf = self._done_buf, []
                by_owner: dict = {}
                for owner_addr, payload in batch:
                    by_owner.setdefault(owner_addr, []).append(payload)
                failed: list = []
                for owner_addr, payloads in by_owner.items():
                    try:
                        owner = self.cw._owner_client(owner_addr)
                        batch = {"batch": payloads}
                        ack = self.cw.cfg.task_done_ack_timeout_s
                        fut = owner.send_nowait("tasks_done", batch)
                        if fut is not None:
                            # Bounded ack wait (silent-loss heal; the
                            # timeout path re-queues, owner dedupes by cid).
                            try:
                                await asyncio.wait_for(fut, ack)
                            except asyncio.TimeoutError:
                                seq = getattr(fut, "_rtpu_seq", None)
                                if seq is not None:
                                    owner._pending.pop(seq, None)
                                raise
                        else:
                            await owner.acall("tasks_done", batch, timeout=ack)
                    except Exception:
                        logger.warning(
                            "lease result delivery to %s failed (%d results)",
                            owner_addr, len(payloads),
                        )
                        failed.extend((owner_addr, p) for p in payloads)
                if failed:
                    attempts += 1
                    if attempts >= 12:  # ~60s of owner unreachability
                        # Dropping silently would hang a still-alive owner
                        # forever (its probe pings US, and we're healthy).
                        # Dying converts the situation into worker-death:
                        # the raylet revokes the lease and the owner's
                        # failover re-runs the tasks (or, if the owner is
                        # truly dead, nothing is lost).
                        logger.error(
                            "exiting: %d lease results undeliverable to owner",
                            len(failed),
                        )
                        os._exit(1)
                    self._done_buf = failed + self._done_buf
                    await asyncio.sleep(min(5.0, 0.5 * attempts))
        finally:
            self._done_flushing = False

    # ---- direct actor calls ----

    async def rpc_actor_call(self, req):
        from ray_tpu_torch._private.task_spec import TaskSpec

        spec = TaskSpec.from_wire(req["spec"])
        # At-least-once dedupe: the owner resends an actor_call whose frame
        # it believes lost (probe-and-resend in _drive_actor_call), and the
        # wire itself can duplicate a frame. Without this tombstone a
        # duplicated frame EXECUTED THE METHOD TWICE — user-visible state
        # mutated twice. The duplicate is answered from the result cache
        # when the first execution already finished, else with a dup marker
        # (the live execution's response rides the original request).
        tid = spec.task_id
        if tid in self._actor_call_seen:
            cached = self._actor_results.get(tid)
            if cached is not None:
                return cached
            return {"dup": True, "task_id": tid}
        self._actor_call_seen.add(tid)
        loop = asyncio.get_event_loop()
        if self._concurrency_pool is not None:
            # Threaded actor: concurrent execution, no ordering guarantee
            # (reference: concurrency groups / max_concurrency > 1).
            return self._finish_actor_call(tid, await loop.run_in_executor(
                self._concurrency_pool, self._safe_execute, spec
            ))
        ex = self.cw._executor
        if hasattr(ex, "submit_callback"):
            # Hot loop: straight onto the main-thread exec queue (FIFO =
            # actor order; creation rides the same queue, so calls racing
            # init serialize behind it automatically). One threadsafe hop
            # back, no cf.Future. Pre-dispatch cancellation resolves the
            # future immediately via _fast_queued (see rpc_cancel_exec).
            fut = loop.create_future()
            self._fast_queued[spec.task_id] = ("actor", fut, spec)

            def deliver(payload, _fut=fut, _loop=loop, _spec=spec):
                if payload is None:  # framework bug: never leave fut hanging
                    payload = self._bug_payload(_spec)
                _loop.call_soon_threadsafe(_set_result_if_pending, _fut, payload)

            ex.submit_callback(self._fast_execute, (spec,), deliver)
            return self._finish_actor_call(tid, await fut)
        # Fallback executors are single-worker ThreadPoolExecutors:
        # submission order is execution order.
        return self._finish_actor_call(
            tid,
            await loop.run_in_executor(self.cw._executor, self._safe_execute, spec),
        )

    async def rpc_actor_has_task(self, req):
        """Owner-side loss probe (see _drive_actor_call): has this worker
        ever RECEIVED the call, and if finished, what was its result? The
        probe rides the same FIFO connection as the call itself, so 'never
        received' is proof the frame was lost, not merely late."""
        tid = req["task_id"]
        cached = self._actor_results.get(tid)
        return {
            "has": tid in self._actor_call_seen,
            "result": cached,
        }

    def _finish_actor_call(self, tid: str, payload):
        """Result cache (answers duplicate/probe re-delivery
        after a lost response frame; bounded FIFO)."""
        self._actor_results[tid] = payload
        self._actor_results_order.append(tid)
        while len(self._actor_results_order) > 512:
            self._actor_results.pop(self._actor_results_order.popleft(), None)
        return payload

    # ---- channel-loop mode (compiled graphs; experimental/channel/) ----

    async def rpc_channel_loop_install(self, req):
        """Bind this actor into a compiled DAG: build the channel endpoints
        and start the resident loop on its own dedicated thread. A separate
        thread (the reference runs accelerated-DAG loops on a background
        execution thread the same way) keeps the actor AVAILABLE: classic
        method calls still run on the main exec queue instead of queuing
        behind the loop forever. Mixing classic calls with compiled stages
        therefore executes them concurrently — same hazard class as
        max_concurrency > 1, and the user opted in by mixing the paths."""
        from ray_tpu_torch.experimental.channel.resident_loop import ChannelLoop

        if self._channel_loops:
            return {
                "error": "actor already participates in a compiled graph; "
                "teardown() the existing CompiledDAG first"
            }
        if self.cw._actor_instance is None:
            return {"error": "channel loops require an actor worker"}
        try:
            loop = ChannelLoop(self.cw, req["loop_id"], req["stages"])
        except Exception as e:  # bad descriptor / unknown method
            return {"error": f"channel loop install failed: {e!r}"}
        self._channel_loops[req["loop_id"]] = loop
        threading.Thread(
            target=loop.run, name="channel-loop", daemon=True
        ).start()
        return {"ok": True}

    async def rpc_channel_loop_stop(self, req):
        """Teardown: stop the resident loop, wait for its thread to exit,
        and drop its reader gates. ok=False (loop still running — e.g. a
        stage method stuck in user code) keeps the loop REGISTERED so a new
        compile cannot double-bind the actor, and tells the driver not to
        free arena blocks the loop may still write."""
        loop = self._channel_loops.pop(req["loop_id"], None)
        if loop is None:
            return {"ok": True, "stopped": False}
        loop.stop()
        try:
            await asyncio.wait_for(loop.exited.wait(), 15)
        except asyncio.TimeoutError:
            self._channel_loops[req["loop_id"]] = loop
            return {"ok": False, "error": "channel loop did not exit within 15s"}
        self.cw.channels.drop(loop.channel_ids)
        # Eager-pushed payloads nobody will ever take (producer raced the
        # stop) must not sit in the inbox until the age sweep.
        for cid in loop.channel_ids:
            self.cw.p2p_inbox.purge_prefix(f"chdev/{cid}/")
        return {"ok": True, "stopped": True}

    async def rpc_channel_loop_stats(self, req):
        """Per-stage stall/busy/resolve split of a resident loop — the
        driver-side bubble-fraction measurement reads it (parallel/
        mpmd_pipeline.py)."""
        loop = self._channel_loops.get(req["loop_id"])
        if loop is None:
            return {"found": False, "stages": []}
        if req.get("reset"):
            import time as _time

            for s in loop.stages:
                s.stall_ns = s.busy_ns = s.resolve_ns = s.iters = 0
                # Stamp the reset so an interval already in flight (a loop
                # blocked in read()) charges only its post-reset portion.
                s.reset_ns = _time.perf_counter_ns()
        return {"found": True, "stages": [s.stats_dict() for s in loop.stages]}

    # ---- cancellation (reference: core_worker.cc HandleCancelTask) ----

    async def rpc_cancel_exec(self, req):
        """Recall a task delivered to this worker: resolve immediately if
        still queued (exec-queue registry), interrupt if running, tombstone
        if it has not arrived yet; recursively cancel children this worker
        owns."""
        task_id = req["task_id"]
        force = bool(req.get("force"))
        recursive = req.get("recursive", True)
        handled = False
        # Queued-but-unstarted (any kind): tombstone FIRST so a racing
        # dequeue drops the body at execute_task entry, then answer the
        # caller NOW — a cancelled call must not wait behind the currently
        # running task. The spec still flows through the exec queue; its
        # duplicate cancelled completion is ignored by the owner (pending
        # already popped) / the already-resolved future.
        entry = None
        if task_id in self._fast_queued:
            # Tombstone BEFORE popping: if the exec thread dequeues the spec
            # in this window, the entry check still drops the body.
            self.cw.mark_cancelled(task_id)
            entry = self._fast_queued.pop(task_id, None)
        if entry is not None:
            if entry[0] == "lease":
                _, owner_addr, spec = entry
                self._lease_done(owner_addr, self.cw.cancelled_payload(spec))
            else:  # actor
                _, fut, spec = entry
                _set_result_if_pending(fut, self.cw.cancelled_payload(spec))
            handled = True
        # Running right now.
        if not handled:
            handled = self.cw.interrupt_running_task(task_id, force=force)
        if not handled:
            # Not here (yet): tombstone so a late arrival is dropped at
            # execution entry and reported as cancelled.
            self.cw.mark_cancelled(task_id)
        if recursive:
            self.cw.cancel_children_of(task_id, force, recursive)
        return {"found": handled}

    async def rpc_kill_self(self, req):
        def _die():
            os._exit(0)

        asyncio.get_event_loop().call_later(0.05, _die)
        return {"ok": True}


def _apply_runtime_env(raw: str | None):
    """Apply this worker's runtime env before anything else imports.

    Reference: _private/runtime_env/ plugins — env_vars, working_dir and
    py_modules are fully supported; pip/conda/container provisioning needs
    package installation (network) and is rejected up-front so tasks fail
    with a clear error instead of silently running in the wrong env.
    """
    if not raw:
        return
    from ray_tpu_torch.runtime_env import UNSUPPORTED_FIELDS

    renv = json.loads(raw)
    for key, value in (renv.get("env_vars") or {}).items():
        os.environ[str(key)] = str(value)
    working_dir = renv.get("working_dir")
    if working_dir:
        os.chdir(working_dir)
        sys.path.insert(0, working_dir)
    for mod_path in renv.get("py_modules") or []:
        sys.path.insert(0, mod_path)
    unsupported = set(renv) & UNSUPPORTED_FIELDS
    if unsupported:
        raise RuntimeError(
            f"runtime_env fields {sorted(unsupported)} require package "
            "installation, which this environment does not support; "
            "pre-install dependencies on the node image instead"
        )


def main():
    import time as _time

    _boot_t0 = _time.monotonic()
    _trace = os.environ.get("RAY_TPU_TORCH_BOOT_TRACE")

    def _mark(label):
        if _trace:
            print(f"[boot-trace {os.getpid()}] {label} +{(_time.monotonic() - _boot_t0) * 1e3:.1f}ms",
                  file=sys.stderr, flush=True)

    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker %(process)d] %(levelname)s %(name)s: %(message)s",
    )
    # `ray_tpu_torch stack` sends SIGUSR1; the dump lands in this worker's .err log
    # (the reference shells out to py-spy from the dashboard agent — not in
    # this image, so workers self-report via faulthandler).
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, file=sys.stderr, all_threads=True)
    except Exception:
        pass
    _apply_runtime_env(os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV"))
    worker_id = os.environ["RAY_TPU_TORCH_WORKER_ID"]
    node_id = os.environ["RAY_TPU_TORCH_NODE_ID"]
    raylet_addr = json.loads(os.environ["RAY_TPU_TORCH_RAYLET_ADDR"])
    gcs_addr = json.loads(os.environ["RAY_TPU_TORCH_GCS_ADDR"])
    arena_name = os.environ["RAY_TPU_TORCH_ARENA_NAME"]
    session_dir = os.environ["RAY_TPU_TORCH_SESSION_DIR"]

    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch._private.core_worker import WORKER, CoreWorker
    from ray_tpu_torch._private.ids import JobID

    _mark("imports")
    worker_env = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
    cw = CoreWorker(
        mode=WORKER,
        gcs_address=gcs_addr,
        raylet_address=raylet_addr,
        arena_name=arena_name,
        node_id=node_id,
        session_dir=session_dir,
        job_id=JobID.from_int(0),
        worker_id=worker_id,
        # Nested tasks inherit this worker's runtime env by default
        # (reference semantics: children inherit the parent's env).
        job_runtime_env=json.loads(worker_env) if worker_env else None,
    )
    worker_context.set_core_worker(cw)
    _mark("core_worker")
    # Tasks run on THIS (main) thread: swap the default pool executor for
    # the main-thread drain loop and install the cancel signal handler —
    # both before register_worker, after which tasks may arrive.
    from ray_tpu_torch.exceptions import TaskCancelledError

    cw._executor.shutdown(wait=False)
    cw._executor = _MainThreadExecutor()
    cw._main_thread_ident = threading.get_ident()

    def _cancel_handler(signum, frame):
        # Raise ONLY if the cancel target is still the task running on this
        # thread — a signal that lands after the task finished (or while
        # idle in the queue) is a no-op and the interrupted blocking call
        # is retried per PEP 475.
        target = cw._main_cancel_target
        if target is not None and target == cw._main_task_id:
            cw._main_cancel_target = None
            raise TaskCancelledError("task was cancelled by ray_tpu_torch.cancel()")

    import signal

    signal.signal(signal.SIGUSR2, _cancel_handler)
    # Flight-recorder fatal-signal hook: a terminating signal stamps a final
    # `fatal_signal` event into the mmap ring before the process dies, so
    # the ring shows WHY it ends where it does. (SIGKILL
    # needs no hook — the mmap file survives it as-is.)
    from ray_tpu_torch._private import flight_recorder

    flight_recorder.install_signal_dump([signal.SIGTERM])
    executor = WorkerExecutor(cw, cw.raylet)
    reply = cw.raylet.call(
        "register_worker",
        {"worker_id": worker_id, "address": list(cw.address), "pid": os.getpid()},
    )
    if not (reply or {}).get("ok", True):
        # The raylet retired this worker id (e.g. a zygote spawn it gave up
        # on and replaced) — we're an orphan; exit instead of double-serving.
        sys.exit(0)
    _mark("registered")
    # Workers exit if their parent raylet dies (reference: core_worker.cc:926
    # ExitIfParentRayletDies).
    def _watch_raylet():
        import time

        while True:
            time.sleep(2.0)
            try:
                cw.raylet.call("store_contains", {"object_id": "00" * 28}, timeout=5)
            except Exception:
                logger.warning("parent raylet unreachable; worker exiting")
                os._exit(1)

    threading.Thread(target=_watch_raylet, daemon=True).start()
    cw._executor.run_forever()


if __name__ == "__main__":
    main()
