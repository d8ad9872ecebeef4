"""CoreWorker — the per-process runtime.

Analog of the reference's CoreWorker
(src/ray/core_worker/core_worker.h:284) plus its Cython binding
(python/ray/_raylet.pyx:2625): lives in every driver and worker process and
implements

- task submission (core_worker.cc:1893 SubmitTask) through the local raylet
- actor creation via GCS + direct actor task transport
  (direct_actor_task_submitter.h:67) — actor calls go straight to the actor
  process over its own RPC server, the raylet is not involved after creation
- Put/Get/Wait over the two-tier object store: small objects in the owner's
  in-process store (memory_store.h:43), large objects in the node's shm arena
  (plasma_store_provider.h:88)
- ownership + distributed reference counting (reference_count.h:61, simplified
  borrower protocol: every materialised ObjectRef increfs its owner, task args
  are pinned for the task's lifetime)
- task retry + lineage reconstruction (task_manager.h:164,
  object_recovery_manager.h:41): specs of completed tasks are retained so a
  lost object can be rebuilt by re-executing its creating task
- the task execution loop for worker processes (core_worker.cc:2512), including
  the ordered actor scheduling queue (actor_scheduling_queue.h:40) and
  concurrency groups via thread pools.
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import hashlib
import logging
import os
import sys
import threading
import time
from concurrent.futures import Future as ConcurrentFuture
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import cloudpickle

from ray_tpu_torch._private import flight_recorder, self_metrics, serialization
from ray_tpu_torch._private.concurrency import any_thread, blocking, loop_only
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import ActorID, BoundedIdSet, JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.rpc import ConnectionLost, EventLoopThread, RpcClient, RpcError, RpcServer
from ray_tpu_torch._private.store.object_store import StoreClient
from ray_tpu_torch._private.task_spec import ACTOR_CREATION_TASK, ACTOR_TASK, NORMAL_TASK, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    OwnerDiedError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

# Current executing task: (TaskID, TaskSpec). A contextvar (not a
# threading.local) so async actor methods — which hop to the shared
# actor-async loop thread — keep their task attribution per asyncio Task.
_exec_ctx: contextvars.ContextVar = contextvars.ContextVar("ray_tpu_exec_ctx", default=None)

DRIVER = "driver"
WORKER = "worker"


def _is_device_tensor(obj) -> bool:
    """True iff obj is a top-level plain ``torch.Tensor`` (neither a DTensor
    nor another subclass), on any device — the values ``tensor_transport=``
    keeps resident (the JAX package's ``_maybe_jax_array``). The module-name
    probe keeps torch out of processes whose values are not tensors."""
    if not type(obj).__module__.startswith("torch"):
        return False
    import torch

    return type(obj) is torch.Tensor


@dataclass
class PendingTask:
    spec: TaskSpec
    retries_left: int
    arg_refs: list = field(default_factory=list)
    # Cancellation state (reference: task_manager.cc MarkTaskCanceled):
    # a cancel-requested task is never retried, and completion payloads
    # arriving later are folded into TaskCancelledError.
    cancel_requested: bool = False
    # "resolving" = still owner-local (waiting on ObjectRef args);
    # "submitted" = handed to the raylet / lease transport / actor.
    phase: str = "resolving"
    # First completion claims the task (duplicate completion payloads are
    # routine: cancel races, lease failover double-delivery) so arg unpin /
    # borrowed decref run exactly once.
    done_claimed: bool = False
    # Task that submitted this one (the executing task's id when submitted
    # from inside a worker) — drives recursive cancellation.
    parent_task_id: str = ""
    # Lost-task sweep bookkeeping (raylet-path tasks only): server-side
    # spillback means a spec can die WITH a node and be held by nobody;
    # the owner sweeps alive raylets (locate_tasks) and resubmits specs
    # found nowhere twice in a row. via_lease tasks are excluded — the
    # lease manager owns their failover.
    via_lease: bool = False
    submitted_ts: float = 0.0
    sweep_misses: int = 0
    sweep_resubmits: int = 0


@dataclass
class OwnedObject:
    ref_count: int = 0
    pinned: int = 0  # pins from in-flight tasks that use this object as an arg
    in_plasma: bool = False
    location_hint: str | None = None
    # Refs nested inside this object's value (reference: nested-ref borrow
    # handoff, reference_count.h). The producer increfs each on our behalf;
    # we decref them when this object itself is freed.
    contained: list = field(default_factory=list)  # [(oid hex, owner addr)]
    # Device object (experimental/device_object/): the payload lives on the
    # HOLDER process's device, only a descriptor is stored here.
    # {"addr": [h, p], "id": holder id} — freeing this object releases the
    # holder's device buffers through the ownership protocol.
    device: dict | None = None


class CoreWorker:
    def __init__(
        self,
        mode: str,
        gcs_address,
        raylet_address,
        arena_name: str,
        node_id: str,
        session_dir: str,
        job_id: JobID | None = None,
        worker_id: str | None = None,
        namespace: str = "",
        job_runtime_env: dict | None = None,
    ):
        self.mode = mode
        self.cfg = get_config()
        self.node_id = node_id
        self.session_dir = session_dir
        self.namespace = namespace
        # Job-level runtime env (ray.init(runtime_env=...)): merged under
        # every task/actor-level env at submit time (reference: job_config).
        self.job_runtime_env = dict(job_runtime_env or {})
        self.worker_id = worker_id or WorkerID.from_random().hex()
        _bt = os.environ.get("RAY_TPU_TORCH_BOOT_TRACE")
        _t0 = time.monotonic()

        def _mark(label):
            if _bt:
                import sys as _sys

                print(
                    f"[cw-trace {os.getpid()}] {label} +{(time.monotonic() - _t0) * 1e3:.1f}ms",
                    file=_sys.stderr, flush=True,
                )

        self._io = EventLoopThread.get()
        _mark("io-loop")
        # Always-on observability plane: the crash-surviving event ring
        # (flight_recorder.py) plus the ray_tpu_* runtime instruments
        # (self_metrics.py) that flow through the /metrics KV path.
        flight_recorder.attach(session_dir, role=mode, ident=self.worker_id)
        self._metrics = self_metrics.instruments()
        # task_done ring events are sampled 1-in-64: completion is implied
        # by the NEXT task_exec on this worker, and a ring that ends with a
        # task_exec (no later exec) is precisely the "died mid-task"
        # postmortem signal — so per-task done events bought latency on the
        # exec critical path without adding information. task_ship is
        # sampled the same way (first ship after init always records): the
        # driver ring's unique value is driver-death postmortems — for the
        # common worker-death case the live driver's pending_tasks + task
        # events already name every in-flight task exactly. task_exec and
        # task_fail stay per-event.
        self._done_event_ctr = 0
        self._ship_event_ctr = 0

        self.gcs = RpcClient(tuple(gcs_address), label="gcs")
        self.raylet = RpcClient(tuple(raylet_address), label="raylet")
        self.store = StoreClient(arena_name, self.raylet)
        _mark("store-attach")

        if job_id is None:
            job_hex = self.gcs.call("next_job_id", timeout=15)["job_id"]
            job_id = JobID.from_hex(job_hex)
        self.job_id = job_id
        self._default_task_id = TaskID.for_driver(job_id)
        # Per-execution-thread task context: threaded actors
        # (max_concurrency > 1) run execute_task concurrently, so the current
        # spec/id must not be shared process state.
        # Process-wide registry of currently-executing tasks, insertion
        # ordered — the fallback for threads the user spawned inside a task
        # (contextvars don't cross thread creation) is the most recently
        # started still-running task.
        self._active_exec: dict[int, tuple] = {}
        self._active_exec_lock = threading.Lock()
        self._active_exec_seq = 0
        self._task_counter = 0

        # Own RPC server (the "core worker service").
        self.server = RpcServer(f"core-{self.worker_id[:8]}")
        self.server.register_all(self)
        _mark("register_all")
        self.server.start("127.0.0.1", 0)
        self.address = self.server.address
        _mark("server-start")

        # Object bookkeeping (all guarded by _lock; events live on the IO loop).
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._submit_buf: list = []
        self._submit_flush_scheduled = False
        # Streaming generator returns (reference: StreamingObjectRefGenerator,
        # _raylet.pyx:227): task_id -> {"items": {index: oid}, "count": int|None,
        # "error": bytes|None, "cond": threading.Condition}
        self._streams: dict[str, dict] = {}
        self.in_process_store: dict[str, dict] = {}  # oid -> {data | value}
        self.owned: dict[str, OwnedObject] = {}
        self._object_events: dict[str, asyncio.Event] = {}
        # Synchronous get() waiters: oid -> [threading.Event]. The warm-path
        # result wake — a completion handler on the IO loop sets the event
        # and the blocked user thread runs, ONE handoff — replacing the old
        # run_coroutine_threadsafe + asyncio.Event + cf.Future chain (three
        # serial loop ticks + two thread handoffs per sync call).
        self._sync_waiters: dict[str, list] = {}
        self._owner_client_cache: dict[tuple, RpcClient] = {}
        # Compiled-graph channel plane (experimental/channel/): reader gates
        # for every channel this process consumes; the rpc_channel_* handlers
        # below dispatch doorbells / side-channel chunks / poison into it.
        from ray_tpu_torch.experimental.channel.channel import ChannelRegistry

        self.channels = ChannelRegistry()
        # Direct p2p mailbox (util/collective/p2p.py): landing zone for
        # eager-pushed channel payloads (descriptor slots resolve from it
        # without a pull round trip) — rpc_p2p_data deposits into it.
        from ray_tpu_torch.util.collective.p2p import ChunkStreams, P2PInbox, RelayTable

        self.p2p_inbox = P2PInbox()
        # Tree-collective planes: relay sessions forwarding broadcast
        # chunks down the binomial tree (cut-through), and reduce partial
        # streams combined chunk-at-a-time at each hop.
        self.p2p_relays = RelayTable()
        self.p2p_streams = ChunkStreams()
        self.pending_tasks: dict[str, PendingTask] = {}
        # Tombstones for cancelled tasks that may not have reached this
        # process yet (cancel racing submission); checked at execution
        # entry. Bounded FIFO — cancellation is rare.
        self._cancelled_tasks = BoundedIdSet()
        # Completion-payload ids already processed (task_done/tasks_done are
        # delivered at-least-once: resends after a connection failure can
        # duplicate a payload that DID arrive). Without this filter a
        # duplicate ERROR payload double-decrements the retry budget in
        # _handle_task_done's retry branch. Sized to cover the resend
        # horizon (worker _flush_done retries for up to ~60s) at multi-k/s
        # completion rates: 64k ids ≈ a few MB, and a filter miss degrades
        # to the pre-filter behavior (a wasted retry), never corrupts.
        self._seen_completions = BoundedIdSet(65536)
        self.lineage: collections.OrderedDict[str, TaskSpec] = collections.OrderedDict()
        self._borrowed_decref_queue: list = []

        # Function table cache (reference: _private/function_manager.py).
        self._function_cache: dict[str, object] = {}
        self._exported_functions: set[str] = set()
        import weakref

        self._fn_key_by_obj: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

        # Direct task transport (lease_manager.py), created on first
        # eligible submit.
        self._lease_mgr = None
        # Lost-task sweep (raylet-path orphan recovery), started on first
        # non-lease submit.
        self._lost_sweep_task = None
        self._sweep_clients: dict[tuple, RpcClient] = {}
        # Last (job, task name) announced to the log pipeline (in-band
        # attribution).
        self._log_attr_name: tuple | None = None

        # Actor-call transport state.
        self._actor_clients: dict[str, RpcClient] = {}
        self._actor_addrs: dict[str, tuple] = {}
        self._actor_seq: dict[str, int] = collections.defaultdict(int)
        self._actor_pending: dict[str, set] = collections.defaultdict(set)
        self._actor_submit_locks: dict[str, asyncio.Lock] = collections.defaultdict(asyncio.Lock)
        # The refs an actor's creation arguments rode in, pinned for its
        # restarts: released when this process kills it for good.
        self._actor_creation_args: dict[str, list] = {}

        # Execution state (worker mode).
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="task-exec")
        # Worker processes execute tasks on the process MAIN thread
        # (worker_main.main() swaps _executor for a main-thread drain loop
        # and records its ident here). Running on the main thread is what
        # lets a non-force cancel interrupt C-blocked calls like
        # time.sleep: CPython only runs signal handlers on the main thread,
        # and a raising handler aborts the blocking call (PEP 475). The
        # reference executes tasks on the worker main thread and interrupts
        # with KeyboardInterrupt for the same reason (core_worker.cc
        # CancelTask → PyErr_SetInterrupt path in _raylet.pyx).
        self._main_thread_ident: int | None = None
        self._main_task_id: str | None = None  # task now running on main thread
        self._main_cancel_target: str | None = None  # read by SIGUSR2 handler
        self._actor_instance = None
        self._actor_id: str | None = None
        self._actor_creation_spec: TaskSpec | None = None
        # Device object plane (experimental/device_object/): tensor_transport
        # declared by this actor's class (tensor returns stay
        # device-resident); the manager is created on first device put/return.
        self._tensor_transport: str = ""
        self._device_objects = None
        # Short-connect clients for devobj_pull: a dead holder must surface
        # as DeviceObjectLostError in seconds, not after the default
        # connect budget (same rationale as _actor_client's 2s timeout).
        self._devobj_clients: dict[tuple, RpcClient] = {}
        # The CUDA device this actor's own thread made current (recorded
        # after its constructor ran): a resident channel loop's thread sets
        # it, since the current device is per thread.
        self._cuda_device: int | None = None
        self._actor_exec_queue: asyncio.Queue | None = None
        self._actor_concurrency_pool: ThreadPoolExecutor | None = None
        self._actor_async_loop: asyncio.AbstractEventLoop | None = None
        self._shutdown = False

        # Task-event buffer (reference: task_event_buffer.h:41 — periodically
        # flushed to the GCS task manager; powers `ray timeline` / state API).
        self._task_events: list[dict] = []
        self._task_events_lock = threading.Lock()
        self._task_events_flusher: threading.Thread | None = None

        # Log pipeline: drivers subscribe to worker stdout/stderr lines
        # published by each raylet's LogMonitor (reference: print_logs in
        # _private/worker.py; disable with RAY_TPU_TORCH_LOG_TO_DRIVER=0).
        self.log_to_driver = (
            mode == DRIVER and os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0"
        )
        if self.log_to_driver:
            try:
                self.gcs.call(
                    "subscribe", {"channel": "worker_logs", "address": list(self.address)}
                )
                # Periodic re-subscribe: subscription state is not persisted
                # by the GCS, so a restarted GCS regains subscribers within
                # one period (subscribe is idempotent per address).
                threading.Thread(
                    target=self._resubscribe_loop, name="log-resubscribe", daemon=True
                ).start()
            except Exception:
                self.log_to_driver = False

    def _resubscribe_loop(self):
        while not self._shutdown:
            time.sleep(10.0)
            if self._shutdown:
                return
            try:
                self.gcs.call(
                    "subscribe", {"channel": "worker_logs", "address": list(self.address)}
                )
            except Exception:
                pass

    def _fallback_ctx(self) -> tuple | None:
        with self._active_exec_lock:
            if not self._active_exec:
                return None
            return next(reversed(self._active_exec.values()))

    @property
    def current_task_id(self) -> TaskID:
        ctx = _exec_ctx.get() or self._fallback_ctx()
        return ctx[0] if ctx is not None else self._default_task_id

    @property
    def current_task_spec(self) -> TaskSpec | None:
        ctx = _exec_ctx.get() or self._fallback_ctx()
        return ctx[1] if ctx is not None else None

    # ==================================================================
    # Task events (reference: src/ray/core_worker/task_event_buffer.h:41)
    # ==================================================================

    def record_task_event(self, spec: TaskSpec, state: str, **extra):
        """Buffer one task state transition; flushed in batches to GCS."""
        if not self.cfg.task_events_enabled:
            return
        event = {
            "task_id": spec.task_id,
            "name": spec.name,
            "job_id": spec.job_id,
            "task_type": spec.task_type,
            "actor_id": spec.actor_id or "",
            "state": state,
            "ts": time.time(),
            "worker_id": self.worker_id,
            "node_id": self.node_id,
        }
        if spec.trace_ctx:
            event["trace_ctx"] = spec.trace_ctx
        event.update(extra)
        with self._task_events_lock:
            self._task_events.append(event)
            if self._task_events_flusher is None:
                self._task_events_flusher = threading.Thread(
                    target=self._task_events_flush_loop,
                    name="task-events-flush",
                    daemon=True,
                )
                self._task_events_flusher.start()

    def _task_events_flush_loop(self):
        interval = self.cfg.task_events_flush_interval_s
        while not self._shutdown:
            time.sleep(interval)
            self.flush_task_events()

    def flush_task_events(self):
        with self._task_events_lock:
            batch, self._task_events = self._task_events, []
        if not batch:
            return
        try:
            self.gcs.call("record_task_events", {"events": batch})
        except Exception:
            logger.debug("task-event flush failed", exc_info=True)

    # ==================================================================
    # Submission-side API
    # ==================================================================

    def _next_task_id(self) -> TaskID:
        self._task_counter += 1
        return TaskID.for_task(ActorID(self.current_task_id.binary()[:16]))

    def _export_function(self, func) -> str:
        # Hot path: @ray_tpu_torch.remote functions are submitted thousands of
        # times — cache the pickle/hash per function object (weak so
        # dynamically-created functions don't leak).
        try:
            cached = self._fn_key_by_obj.get(func)
        except TypeError:  # unhashable/unweakrefable callables
            cached = None
        if cached is not None:
            return cached
        pickled = cloudpickle.dumps(func)
        key = "fn:" + hashlib.sha1(pickled).hexdigest()
        if key not in self._exported_functions:
            # Bounded + retried (kv_put with overwrite=False is idempotent):
            # a silently lost export frame must not hang .remote() forever.
            self.gcs.call(
                "kv_put", {"key": key, "value": pickled, "overwrite": False},
                timeout=15,
            )
            self._exported_functions.add(key)
            self._function_cache[key] = func
        try:
            self._fn_key_by_obj[func] = key
        except TypeError:
            pass
        return key

    def _prepare_args(self, args: tuple, kwargs: dict) -> tuple[list, list]:
        """Serialize positional+keyword args into wire form; returns
        (wire_args, referenced_refs). kwargs ride as a trailing marker."""
        from ray_tpu_torch.object_ref import ObjectRef

        wire = []
        refs = []
        flat = list(args) + [("__kwargs__", kwargs)] if kwargs else list(args)
        for arg in flat:
            if isinstance(arg, ObjectRef):
                refs.append(arg)
                wire.append(["r", arg.hex(), list(arg.owner_addr or self.address)])
            else:
                ser = serialization.serialize(arg)
                refs.extend(ser.contained_refs)
                data = ser.to_bytes()
                if len(data) > self.cfg.max_direct_call_object_size:
                    ref = self.put_serialized(ser)
                    refs.append(ref)
                    wire.append(["r", ref.hex(), list(self.address)])
                else:
                    wire.append(["v", data])
        return wire, refs

    def submit_task(self, func, args=(), kwargs=None, **opts):
        """Submit a normal task; returns list[ObjectRef]."""
        from ray_tpu_torch.object_ref import ObjectRef

        kwargs = kwargs or {}
        task_id = self._next_task_id()
        num_returns = opts.get("num_returns", 1)
        wire_args, arg_refs = self._prepare_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id.hex(),
            job_id=self.job_id.hex(),
            name=opts.get("name") or getattr(func, "__name__", "task"),
            task_type=NORMAL_TASK,
            function_key=self._export_function(func),
            args=wire_args,
            num_returns=num_returns,
            resources=opts.get("resources") or {"CPU": 1},
            max_retries=opts.get("max_retries", self.cfg.default_max_retries),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            owner_addr=list(self.address),
            owner_worker_id=self.worker_id,
            placement_group_id=opts.get("placement_group_id", ""),
            placement_group_bundle_index=opts.get("placement_group_bundle_index", -1),
            scheduling_strategy=opts.get("scheduling_strategy", "DEFAULT"),
            runtime_env=self._merged_runtime_env(opts.get("runtime_env")),
            trace_ctx=self._trace_ctx(),
        )
        if spec.is_streaming():
            with self._lock:
                # Bound the registry like lineage: prune oldest COMPLETED
                # streams (never-consumed generators would otherwise leak
                # their state forever in a long-lived driver).
                if len(self._streams) > 1000:
                    now = time.monotonic()
                    for tid in [
                        t for t, s in self._streams.items()
                        if s["count"] is not None and now - s["created"] > 600.0
                    ][: len(self._streams) - 1000]:
                        self._drop_stream_locked(tid)
                self._streams[spec.task_id] = {
                    "items": {}, "count": None, "error": None,
                    "created": time.monotonic(),
                    "cond": threading.Condition(),
                }
        self._register_pending(spec, arg_refs)
        self.record_task_event(spec, "PENDING_ARGS_AVAIL")
        self._submit_when_ready(spec, arg_refs)
        if spec.is_streaming():
            from ray_tpu_torch.object_ref import ObjectRefGenerator

            return ObjectRefGenerator(self, spec.task_id)
        return [
            ObjectRef(ObjectID.for_return(task_id, i), self.address)
            for i in range(num_returns)
        ]

    @staticmethod
    def _trace_ctx() -> dict:
        from ray_tpu_torch.util import tracing

        # Chain spans when tracing is enabled locally OR when the currently
        # executing task arrived with a span (a worker spawned before the
        # cluster-wide flag propagated must still not break its parent's
        # trace).
        if tracing.tracing_enabled() or tracing.get_current_span_context() is not None:
            return tracing.child_span_context()
        return {}

    def _merged_runtime_env(self, task_env: dict | None) -> dict:
        """Task/actor env over the job-level env; env_vars dicts merge."""
        if not self.job_runtime_env:
            merged = dict(task_env or {})
        elif not task_env:
            merged = dict(self.job_runtime_env)
        else:
            merged = dict(self.job_runtime_env)
            for key, value in task_env.items():
                if key == "env_vars" and isinstance(merged.get("env_vars"), dict):
                    merged["env_vars"] = {**merged["env_vars"], **(value or {})}
                else:
                    merged[key] = value
        from ray_tpu_torch.runtime_env import UNSUPPORTED_FIELDS

        unsupported = set(merged) & UNSUPPORTED_FIELDS
        if unsupported:
            # Fail at submission, not in a crash-looping worker: provisioning
            # packages needs network access this environment doesn't have.
            raise ValueError(
                f"runtime_env fields {sorted(unsupported)} require package "
                "installation, which is not supported; pre-install "
                "dependencies on the node image instead"
            )
        # Validate paths here too — a worker that dies in env setup before
        # registering would otherwise crash-loop while the task hangs.
        import os as _os

        wd = merged.get("working_dir")
        if wd and not _os.path.isdir(wd):
            raise ValueError(f"runtime_env working_dir {wd!r} is not a directory")
        for p in merged.get("py_modules") or []:
            if not _os.path.exists(p):
                raise ValueError(f"runtime_env py_modules path {p!r} does not exist")
        return merged

    def _submit_when_ready(self, spec: TaskSpec, arg_refs: list):
        """Submitter-side dependency resolution (reference:
        dependency_resolver.h:29 LocalDependencyResolver): hold the task until
        every ObjectRef argument is available, so leased workers never block
        on unproduced inputs. Owned refs wait on completion events; borrowed
        refs poll the owner."""
        unready = [ref for ref in arg_refs if not self._arg_available(ref)]
        if not unready:
            # Fire-and-forget: the ObjectRef already exists and results flow
            # back through completion events — blocking on the raylet's ack
            # here would serialize every submission on an RPC round-trip
            # (the reference's SubmitTask is asynchronous for the same
            # reason, core_worker.cc:1893). Errors fail the task instead.
            # Bursts coalesce into ONE submit_tasks RPC per IO-loop tick
            # (the reference pipelines leases similarly) — per-task RPCs were
            # the dominant cost at 100 tasks in flight.
            self._enqueue_submit(spec)
            return

        async def _wait_and_submit():
            # Runs ON the IO loop: only async RPC here — a blocking .call()
            # would deadlock every socket in the process.
            try:
                for ref in unready:
                    oid_hex = ref.hex()
                    if self._is_own(ref):
                        await self._wait_event(oid_hex, None)
                    else:
                        while not await self._arg_available_async(ref):
                            await asyncio.sleep(0.02)
                with self._lock:
                    p = self.pending_tasks.get(spec.task_id)
                    # A missing entry means the task was already failed out
                    # of pending_tasks — for a not-yet-submitted task the
                    # only path that does that is cancel. Treating it as
                    # "not cancelled" would submit (and execute) a task
                    # whose get() already raised TaskCancelledError.
                    cancelled = p is None or p.cancel_requested
                if cancelled:
                    self._fail_task(
                        spec.task_id,
                        TaskCancelledError(
                            f"task {spec.name} ({spec.task_id[:8]}) was cancelled "
                            "before submission"
                        ),
                    )
                    return
                self._enqueue_submit(spec)
            except Exception as e:
                logger.exception("deferred submit of %s failed", spec.task_id[:8])
                self._fail_task(spec.task_id, WorkerCrashedError(f"submit failed: {e!r}"))

        self._io.spawn(_wait_and_submit())

    def _lease_eligible(self, spec: TaskSpec) -> bool:
        """Normal tasks with default placement ride the direct lease
        transport (lease_manager.py); everything placement-sensitive (PGs,
        node affinity, SPREAD) and streaming generators keep the classic
        raylet submit path."""
        return (
            self.cfg.direct_task_leases
            and spec.task_type == NORMAL_TASK
            and not spec.is_streaming()
            and (spec.scheduling_strategy or "DEFAULT") == "DEFAULT"
            and not spec.placement_group_id
        )

    def _get_lease_manager(self):
        lm = self._lease_mgr
        if lm is None:
            from ray_tpu_torch._private.lease_manager import LeaseManager

            with self._lock:
                if self._lease_mgr is None:
                    self._lease_mgr = LeaseManager(self)
                lm = self._lease_mgr
        return lm

    def _enqueue_submit(self, spec: TaskSpec) -> None:
        with self._lock:
            p = self.pending_tasks.get(spec.task_id)
            if p is None or p.cancel_requested:
                # Cancelled between registration and submission: the
                # resolving-phase cancel branch already failed the task
                # (get() raises TaskCancelledError) — shipping it now would
                # execute it anyway, unreachable by any further cancel.
                # Checked under the same lock that flips phase so the
                # cancel driver sees either "resolving" (we skip here) or
                # "submitted" (it recalls from the transport).
                return
            p.phase = "submitted"
            p.submitted_ts = time.monotonic()
            p.via_lease = self._lease_eligible(spec)
        self._ship_event_ctr += 1
        if self._ship_event_ctr & 63 == 1:  # records at 1, 65, 129, ...
            flight_recorder.record(
                "task_ship", f"{spec.name}:{spec.task_id[:8]}:n={self._ship_event_ctr}"
            )
        if p.via_lease:
            self._get_lease_manager().submit(spec)
            return
        self._ensure_lost_task_sweeper()
        with self._submit_lock:
            self._submit_buf.append(spec)
            if self._submit_flush_scheduled:
                return
            self._submit_flush_scheduled = True
        self._io.spawn(self._flush_submits())

    # ---- lost-task sweep (raylet-path orphan recovery) -------------------
    #
    # Server-side spillback forwards a spec raylet-to-raylet and forgets
    # it; a node that dies holding the spec leaves the owner waiting on
    # its returns forever (no raylet will ever report task_done /
    # task_failed for it). The reference avoids this shape by owner-side
    # spillback replies (direct_task_transport.cc) — our lease path has
    # the same owner-owned failover, but SPREAD/affinity/PG/streaming
    # tasks ride the classic raylet queue. This sweep is their safety
    # net: aged submitted tasks are located across alive raylets
    # (locate_tasks) and resubmitted when found nowhere twice in a row.

    def _ensure_lost_task_sweeper(self):
        # Under the lock: submit_task runs on user threads, and two racing
        # spawns would double the sweep cadence — a single transient
        # "not found" could then reach the two-miss confirm in one window.
        with self._lock:
            if self._lost_sweep_task is None and not self._shutdown:
                self._lost_sweep_task = self._io.spawn(self._lost_task_sweep_loop())

    async def _lost_task_sweep_loop(self):
        interval = getattr(self.cfg, "lost_task_sweep_interval_s", 15.0)
        while not self._shutdown:
            await asyncio.sleep(interval)
            try:
                await self._sweep_lost_tasks()
            except Exception:
                logger.debug("lost-task sweep iteration failed", exc_info=True)

    async def _sweep_lost_tasks(self):
        now = time.monotonic()
        with self._lock:
            cands = [
                p
                for p in self.pending_tasks.values()
                if p.phase == "submitted"
                and not p.via_lease
                and not p.cancel_requested
                and p.spec.task_type == NORMAL_TASK
                and now - p.submitted_ts > getattr(self.cfg, "lost_task_age_s", 30.0)
            ]
        if not cands:
            return
        resp = await self.gcs.acall("get_nodes", {}, timeout=10)
        raylets = [
            tuple(info["address"])
            for info in resp.get("nodes", {}).values()
            if info.get("state") == "ALIVE" and info.get("address")
        ]
        ids = [p.spec.task_id for p in cands]
        found: set = set()
        for addr in raylets:
            client = self._sweep_clients.get(addr)
            if client is None:
                client = self._sweep_clients[addr] = RpcClient(
                    addr, label="sweep-raylet"
                )
            try:
                r = await client.acall("locate_tasks", {"task_ids": ids}, timeout=5)
                found.update(r.get("found", []))
            except Exception:
                # Unreachable raylet: absence is unprovable this round —
                # treat everything as found rather than double-execute.
                found.update(ids)
                self._sweep_clients.pop(addr, None)
                client.close()
                break
        for p in cands:
            tid = p.spec.task_id
            # Re-verify under the lock: the task may have COMPLETED during
            # the get_nodes/locate awaits above (done pops it from
            # pending_tasks; locate then reports it nowhere) — resubmitting
            # a finished task would re-run its side effects.
            with self._lock:
                live = self.pending_tasks.get(tid)
            if live is not p or p.phase != "submitted":
                continue
            if tid in found or p.cancel_requested:
                p.sweep_misses = 0
                continue
            p.sweep_misses += 1
            if p.sweep_misses < 2:
                continue  # could be mid-spillback; confirm next sweep
            p.sweep_misses = 0
            if p.sweep_resubmits >= 5:
                from ray_tpu_torch.exceptions import WorkerCrashedError

                self._fail_task(
                    tid,
                    WorkerCrashedError(
                        f"task {p.spec.name} ({tid[:8]}) was lost repeatedly "
                        "(no alive raylet holds it after resubmission)"
                    ),
                )
                continue
            p.sweep_resubmits += 1
            logger.warning(
                "task %s (%s) held by no alive raylet; resubmitting (%d/5)",
                tid[:8], p.spec.name, p.sweep_resubmits,
            )
            self._reset_stream_for_retry(tid)
            try:
                await self.raylet.acall("submit_task", {"spec": p.spec.to_wire()})
            except Exception:
                logger.warning("lost-task resubmit of %s failed", tid[:8])

    async def _flush_submits(self) -> None:
        await asyncio.sleep(0)  # let the submitting thread's burst accumulate
        with self._submit_lock:
            batch, self._submit_buf = self._submit_buf, []
            self._submit_flush_scheduled = False
        if not batch:
            return
        try:
            if len(batch) == 1:
                await self.raylet.acall("submit_task", {"spec": batch[0].to_wire()})
            else:
                resp = await self.raylet.acall(
                    "submit_tasks", {"specs": [s.to_wire() for s in batch]}
                )
                # Per-spec failures: the rest of the batch is queued and
                # runs; only the reported specs actually failed.
                for f in resp.get("failed") or []:
                    self._fail_task(
                        f["task_id"], WorkerCrashedError(f"submit failed: {f['error']}")
                    )
        except Exception as e:
            # Transport-level failure (after the RPC client's own retries):
            # unknown which specs the raylet saw; fail all for visibility.
            logger.exception("batched submit of %d tasks failed", len(batch))
            for s in batch:
                self._fail_task(s.task_id, WorkerCrashedError(f"submit failed: {e!r}"))

    async def _arg_available_async(self, ref) -> bool:
        """Non-blocking (IO-loop-safe) version of _arg_available for
        borrowed refs."""
        oid_hex = ref.hex()
        with self._lock:
            if oid_hex in self.in_process_store:
                return True
        try:
            resp = await self.raylet.acall("store_contains", {"object_id": oid_hex})
            if resp.get("found"):
                return True
        except Exception:
            pass
        try:
            client = self._owner_client(tuple(ref.owner_addr))
            resp = await client.acall("get_inline", {"object_id": oid_hex, "wait": False}, timeout=2)
            return resp.get("kind") in ("inline", "plasma")
        except Exception:
            return False

    def _is_own(self, ref) -> bool:
        return ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address)

    def _arg_available(self, ref) -> bool:
        oid_hex = ref.hex()
        with self._lock:
            if oid_hex in self.in_process_store:
                return True
            if self._is_own(ref):
                task_id = oid_hex[: TaskID.SIZE * 2]
                if task_id in self.pending_tasks:
                    return False
                obj = self.owned.get(oid_hex)
                return obj is not None and (obj.in_plasma or oid_hex in self.in_process_store)
        # Borrowed: only cheap local checks on the submit path — a remote
        # owner probe here would block .remote() for seconds when the owner
        # is slow; the deferred async waiter handles the remote case.
        return self.store.contains(oid_hex)

    def _owner_client(self, addr: tuple) -> RpcClient:
        """Cached connection to another worker/driver (owner of a borrowed
        ref). One connection per peer, reused across gets/probes/decrefs."""
        with self._lock:
            client = self._owner_client_cache.get(addr)
            if client is None:
                client = RpcClient(addr, label=f"owner-{addr}")
                self._owner_client_cache[addr] = client
            return client

    def _register_pending(self, spec: TaskSpec, arg_refs: list):
        ctx = _exec_ctx.get()
        parent = ctx[1].task_id if ctx is not None else ""
        with self._lock:
            self.pending_tasks[spec.task_id] = PendingTask(
                spec=spec,
                retries_left=spec.max_retries,
                arg_refs=list(arg_refs),
                parent_task_id=parent,
            )
            for oid in spec.return_object_ids():
                self.owned.setdefault(oid, OwnedObject())
                self._ensure_event(oid)
        for ref in arg_refs:
            self._pin_arg(ref)

    def _pin_arg(self, ref):
        if ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address):
            with self._lock:
                obj = self.owned.setdefault(ref.hex(), OwnedObject())
                obj.pinned += 1
        else:
            self._push_to_owner(ref, "incref")

    def release_actor_args(self, actor_id: str) -> None:
        """Unpin the creation arguments of an actor this process created and
        killed with no restart: nothing will run its constructor again."""
        self._unpin_args(self._actor_creation_args.pop(actor_id, []))

    def _unpin_args(self, arg_refs):
        for ref in arg_refs:
            if ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address):
                with self._lock:
                    obj = self.owned.get(ref.hex())
                    if obj is not None:
                        obj.pinned = max(0, obj.pinned - 1)
                        self._maybe_free_locked(ref.hex(), obj)
            else:
                self._push_to_owner(ref, "decref")

    def _push_to_owner(self, ref, method: str):
        async def _push():
            try:
                client = self._owner_client(tuple(ref.owner_addr))
                await client.apush(method, {"object_id": ref.hex()})
            except Exception:
                pass

        self._io.spawn(_push())

    # ---- puts ----

    def put(self, value, tensor_transport: str | None = None) -> "object":
        if tensor_transport:
            return self.put_device(value, tensor_transport)
        ser = serialization.serialize(value)
        return self.put_serialized(ser)

    # ---- device object plane (experimental/device_object/) ----

    def _device_manager(self):
        mgr = self._device_objects
        if mgr is None:
            from ray_tpu_torch.experimental.device_object.manager import DeviceObjectManager

            with self._lock:
                if self._device_objects is None:
                    self._device_objects = DeviceObjectManager(self)
                mgr = self._device_objects
        return mgr

    def _holder_identity(self) -> tuple[str, str]:
        if self._actor_id:
            return self._actor_id, "actor"
        return self.worker_id, "driver" if self.mode == DRIVER else "worker"

    def put_device(self, value, transport: str):
        """put() with tensor_transport=: the tensor stays resident on this
        process's device; only a small descriptor enters the store.
        The returned ObjectRef is first-class (refcounted/waitable/passable)
        and resolves out of band (same-process live tensor / collective p2p /
        host fallback — see experimental/device_object/resolve.py)."""
        from ray_tpu_torch.experimental.device_object.descriptor import validate_transport
        from ray_tpu_torch.experimental.device_object.manager import refuse_sharded
        from ray_tpu_torch.object_ref import ObjectRef

        validate_transport(transport)
        refuse_sharded(value)
        if not _is_device_tensor(value):
            raise TypeError(
                "tensor_transport= requires a top-level torch.Tensor, got "
                f"{type(value).__name__}; use a plain put() for host values"
            )
        oid = ObjectID.for_put(self.current_task_id)
        oid_hex = oid.hex()
        holder_id, holder_kind = self._holder_identity()
        meta = self._device_manager().create_resident(oid_hex, value, transport, holder_id, holder_kind)
        data = serialization.serialize(meta).to_bytes()
        with self._lock:
            entry = self.owned.setdefault(oid_hex, OwnedObject())
            entry.device = {"addr": list(self.address), "id": holder_id}
            self.in_process_store[oid_hex] = {"data": data, "value": meta}
        self._set_event(oid_hex)
        return ObjectRef(oid, self.address)

    def _package_device(self, oid_hex: str, value) -> list:
        """Actor-task return under tensor_transport=: keep the tensor here
        (this actor is the holder), ship the descriptor as the inline result
        plus the holder coordinates the owner's refcounting needs."""
        holder_id, holder_kind = self._holder_identity()
        meta = self._device_manager().create_resident(
            oid_hex, value, self._tensor_transport, holder_id, holder_kind
        )
        data = serialization.serialize(meta).to_bytes()
        return [oid_hex, "inline", data, [], {"addr": list(self.address), "id": holder_id}]

    def _devobj_client(self, addr: tuple) -> RpcClient:
        """Cached connection to a device-object holder with a SHORT connect
        timeout: resolution probes holders that may be dead, and the typed
        loss must surface quickly (the host-copy fallback runs after it)."""
        with self._lock:
            client = self._devobj_clients.get(addr)
            if client is None:
                client = RpcClient(addr, label=f"devobj-{addr}", connect_timeout=2.0)
                self._devobj_clients[addr] = client
            return client

    @any_thread
    def _free_device_object(self, oid: str, dev: dict):
        """Owner-side release reached zero refs: tell the holder to drop the
        device buffers (and any host copy it spilled)."""
        addr = tuple(dev.get("addr") or ())
        if addr == tuple(self.address):
            mgr = self._device_objects
            if mgr is not None:
                mgr.free(oid)
            return

        async def _push():
            try:
                await self._owner_client(addr).apush("devobj_free", {"object_id": oid})
            except Exception:
                pass

        self._io.spawn(_push())

    def put_serialized(self, ser: serialization.SerializedObject):
        from ray_tpu_torch.object_ref import ObjectRef

        oid = ObjectID.for_put(self.current_task_id)
        oid_hex = oid.hex()
        contained = self._incref_contained(ser.contained_refs)
        with self._lock:
            entry = self.owned.setdefault(oid_hex, OwnedObject())
            entry.contained = contained
        if ser.total_size > self.cfg.max_direct_call_object_size:
            self.store.put_serialized(oid_hex, ser)
            with self._lock:
                self.owned[oid_hex].in_plasma = True
                self.owned[oid_hex].location_hint = self.node_id
        else:
            with self._lock:
                self.in_process_store[oid_hex] = {"data": ser.to_bytes()}
        self._set_event(oid_hex)
        return ObjectRef(oid, self.address)

    # ---- gets ----

    def _ensure_event(self, oid_hex: str) -> asyncio.Event:
        ev = self._object_events.get(oid_hex)
        if ev is None:
            ev = asyncio.Event()
            self._object_events[oid_hex] = ev
        return ev

    def _set_event(self, oid_hex: str):
        self._set_events((oid_hex,))

    @any_thread
    def _set_events(self, oid_hexes):
        """Signal completion of one or more objects, coalesced.

        Sync get() waiters wake directly (threading.Event.set is safe from
        any thread — no loop round-trip); asyncio waiters are set inline
        when already on the IO loop (a batch of results then costs ZERO
        extra loop ticks) and via one call_soon_threadsafe for the whole
        batch otherwise."""
        if not oid_hexes:
            return
        with self._lock:
            waiter_lists = [
                w for o in oid_hexes for w in (self._sync_waiters.pop(o, None),) if w
            ]
        for lst in waiter_lists:
            for ev in lst:
                ev.set()

        def _set_all():
            with self._lock:
                evs = [self._ensure_event(o) for o in oid_hexes]
            for ev in evs:
                ev.set()

        if threading.current_thread() is self._io._thread:
            _set_all()
        else:
            self._io.loop.call_soon_threadsafe(_set_all)

    async def _wait_event(self, oid_hex: str, timeout: float | None):
        with self._lock:
            ev = self._ensure_event(oid_hex)
        if timeout is None:
            await ev.wait()
        else:
            await asyncio.wait_for(ev.wait(), timeout)

    @staticmethod
    def _raise_if_error(value):
        """The one error surface for materialized values (shared by get()
        and get_device_meta so new error types never diverge)."""
        if isinstance(value, TaskError):
            if isinstance(value.cause, (TaskCancelledError, ActorDiedError)):
                raise value.cause
            raise value
        if isinstance(
            value,
            (ObjectLostError, WorkerCrashedError, ActorDiedError, TaskCancelledError, OutOfMemoryError),
        ):
            raise value

    @blocking
    def get(self, refs, timeout: float | None = None):
        single = not isinstance(refs, list)
        ref_list = [refs] if single else refs
        deadline = None if timeout is None else time.monotonic() + timeout
        values = [self._get_one(ref, deadline) for ref in ref_list]
        for v in values:
            self._raise_if_error(v)
        return values[0] if single else values

    def _remaining(self, deadline) -> float | None:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise GetTimeoutError("ray_tpu_torch.get() timed out")
        return rem

    @blocking
    def get_device_meta(self, ref, timeout: float | None = None):
        """The RAW DeviceObjectMeta behind a device-object ref, WITHOUT
        resolving the payload (device_object.broadcast needs the holder
        coordinates, not the tensor). Waits for the descriptor to
        materialize exactly like get(); raises TypeError for refs that are
        not device objects."""
        deadline = None if timeout is None else time.monotonic() + timeout
        value = self._get_one_raw(ref, deadline)
        self._raise_if_error(value)
        if type(value).__name__ == "DeviceObjectMeta":
            return value
        raise TypeError(
            f"object {ref.hex()[:12]} is not a device object (resolved to "
            f"{type(value).__name__}); group broadcast applies to "
            "tensor_transport= refs"
        )

    def _get_one(self, ref, deadline):
        value = self._get_one_raw(ref, deadline)
        # Device object descriptors resolve out of band (live tensor /
        # collective transfer / host fallback). Name probe first so the
        # ordinary get path never imports the device plane.
        if type(value).__name__ == "DeviceObjectMeta":
            from ray_tpu_torch.experimental.device_object import DeviceObjectMeta, resolve_meta

            if isinstance(value, DeviceObjectMeta):
                return resolve_meta(self, value, deadline)
        return value

    def _get_one_raw(self, ref, deadline):
        oid_hex = ref.hex()
        is_owner = ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address)
        attempts = 0
        missing_probes = 0  # CONSECUTIVE no-location probes (not loop passes)
        while True:
            attempts += 1
            # 1. In-process store.
            with self._lock:
                entry = self.in_process_store.get(oid_hex)
            if entry is not None:
                return self._materialize(oid_hex, entry)
            # 2. Pending task we own: wait for completion. Direct threading
            # waiter — the completion handler (on the IO loop) sets it and
            # this thread runs: one handoff, no loop scheduling. Registration
            # re-checks completion under the lock so a result landing between
            # the pending probe and the registration can't strand the waiter.
            task_id = oid_hex[: TaskID.SIZE * 2]
            with self._lock:
                pending = task_id in self.pending_tasks
            if pending and is_owner:
                waiter = threading.Event()
                with self._lock:
                    # Unlike the persistent asyncio.Event this replaced, a
                    # threading waiter registered AFTER the signal would miss
                    # it — so availability (inline result, or a plasma copy:
                    # streaming items of a still-running task land there) is
                    # re-checked under the same lock every producer stores
                    # under before it signals.
                    obj = self.owned.get(oid_hex)
                    if (
                        task_id in self.pending_tasks
                        and oid_hex not in self.in_process_store
                        and not (obj is not None and obj.in_plasma)
                    ):
                        self._sync_waiters.setdefault(oid_hex, []).append(waiter)
                    else:
                        waiter = None
                if waiter is not None:
                    rem = self._remaining(deadline)
                    if not waiter.wait(rem):
                        with self._lock:
                            lst = self._sync_waiters.get(oid_hex)
                            if lst is not None and waiter in lst:
                                lst.remove(waiter)
                                if not lst:
                                    self._sync_waiters.pop(oid_hex, None)
                        raise GetTimeoutError("ray_tpu_torch.get() timed out")
                continue
            # 3. Local/remote plasma.
            with self._lock:
                obj = self.owned.get(oid_hex)
                in_plasma = obj.in_plasma if obj else None
            if is_owner and in_plasma is False and entry is None:
                # Owned, not in plasma, not in-process => lost; try lineage.
                if self._try_reconstruct(oid_hex):
                    continue
                raise ObjectLostError(oid_hex)
            # Local plasma fast path: only block in the store when the copy
            # is already local, or when we know it lives in plasma somewhere
            # (owner's in_plasma flag). Borrowers must NOT speculatively pull
            # — small results live inline at the owner, not in any store.
            local = self.store.contains(oid_hex)
            if local or (is_owner and in_plasma):
                try:
                    rem = self._remaining(deadline)
                    # The pin lasts as long as what is deserialized zero-copy from it.
                    return serialization.deserialize(
                        self.store.get_pinned(oid_hex, timeout=min(rem, 5.0) if rem else 5.0))
                except GetTimeoutError:
                    raise
                except Exception:
                    pass
            # 4. Borrower path: ask the owner directly (blocks until the task
            # finishes; returns inline bytes or points us at plasma).
            if not is_owner:
                result = self._fetch_from_owner(ref, deadline)
                if result is not _MISSING:
                    return result
                # Owner reports a plasma copy: pull it through our raylet.
                try:
                    rem = self._remaining(deadline)
                    return serialization.deserialize(
                        self.store.get_pinned(oid_hex, timeout=min(rem, 30.0) if rem else 30.0))
                except GetTimeoutError:
                    raise
                except Exception:
                    pass
            else:
                # Only reconstruct when no copy exists anywhere (a slow pull
                # must not trigger a spurious re-execution). Location rows
                # are registered asynchronously at seal time, so one missing
                # probe is not proof of loss — require two CONSECUTIVE
                # missing probes (a counter of its own: the overall loop
                # counter also ticks on waits that never probed locations)
                # before re-executing.
                if not self._has_any_location(oid_hex):
                    missing_probes += 1
                    if missing_probes >= 2 and self._try_reconstruct(oid_hex):
                        missing_probes = 0
                        continue
                    if missing_probes >= 4:
                        raise ObjectLostError(oid_hex)
                else:
                    missing_probes = 0
            time.sleep(0.05)
            self._remaining(deadline)

    def _materialize(self, oid_hex: str, entry: dict):
        if "value" not in entry:
            entry["value"] = serialization.deserialize(entry["data"])
        return entry["value"]

    def _fetch_from_owner(self, ref, deadline):
        try:
            client = self._owner_client(tuple(ref.owner_addr))
            # get_inline with wait=True is an idempotent LONG-POLL, so wait
            # in bounded slices and simply re-poll on a slice timeout OR an
            # in-slice "missing" (= still pending) answer: a request/reply
            # frame silently lost on the wire costs one slice (it used to
            # park this borrower for the caller's whole deadline — forever
            # for task-arg resolution, which has none), and the server
            # parks its wait for at most the slice too, so abandoned
            # slices cannot accumulate parked handler tasks on the owner.
            # The overall wait envelope stays the pre-slicing one:
            # worker_lease_timeout_s total, then "missing" falls through.
            wait_deadline = time.monotonic() + self.cfg.worker_lease_timeout_s
            while True:
                rem = self._remaining(deadline)  # raises at the deadline
                per = min(
                    10.0,
                    max(0.5, wait_deadline - time.monotonic()),
                    rem if rem is not None else 10.0,
                )
                try:
                    resp = client.call(
                        "get_inline",
                        {"object_id": ref.hex(), "wait": True, "timeout": per},
                        timeout=per + 2.0,
                        retries=0,
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    resp = None  # slice lost on the wire; re-poll
                if resp is not None and resp.get("kind") != "missing":
                    break
                if time.monotonic() >= wait_deadline:
                    resp = resp or {"kind": "missing"}
                    break
        except GetTimeoutError:
            raise
        except Exception:
            raise OwnerDiedError(ref.hex(), f"owner of {ref.hex()} is unreachable")
        kind = resp.get("kind")
        if kind == "inline":
            return serialization.deserialize(resp["data"])
        if kind == "plasma":
            return _MISSING  # loop will pull via local raylet
        raise ObjectLostError(ref.hex())

    def _has_any_location(self, oid_hex: str) -> bool:
        try:
            resp = self.gcs.call("get_object_locations", {"object_id": oid_hex}, timeout=5)
            return bool(resp.get("locations"))
        except Exception:
            return False

    def _try_reconstruct(self, oid_hex: str) -> bool:
        """Lineage reconstruction (reference: object_recovery_manager.h:90)."""
        task_id = oid_hex[: TaskID.SIZE * 2]
        with self._lock:
            spec = self.lineage.get(task_id)
            if spec is None or spec.max_retries <= 0:
                return False
            if task_id in self.pending_tasks:
                return True
            self.lineage.pop(task_id, None)
            for oid in spec.return_object_ids():
                ev = self._object_events.get(oid)
                if ev is not None:
                    self._io.loop.call_soon_threadsafe(ev.clear)
                obj = self.owned.get(oid)
                if obj is not None:
                    obj.in_plasma = False
        logger.info("reconstructing object %s by re-executing task %s", oid_hex[:8], task_id[:8])
        self._register_pending(spec, [])
        self.raylet.call("submit_task", {"spec": spec.to_wire()})
        return True

    # ---- wait ----

    @blocking
    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: list = []
        while True:
            still = []
            for ref in pending:
                if self._is_ready(ref, fetch_local):
                    ready.append(ref)
                else:
                    still.append(ref)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.02)
        # reference semantics (worker.py:2587): at most num_returns in the
        # ready list; ready-but-surplus refs stay in the remaining list
        return ready[:num_returns], ready[num_returns:] + pending

    def _is_ready(self, ref, fetch_local: bool) -> bool:
        oid_hex = ref.hex()
        with self._lock:
            if oid_hex in self.in_process_store:
                return True
            task_id = oid_hex[: TaskID.SIZE * 2]
            if task_id in self.pending_tasks:
                return False
            obj = self.owned.get(oid_hex)
        if obj is not None and obj.in_plasma:
            if not fetch_local:
                return True
            return self.store.contains(oid_hex)
        if ref.owner_addr is not None and tuple(ref.owner_addr) != tuple(self.address):
            if self.store.contains(oid_hex):
                return True
            try:
                client = self._owner_client(tuple(ref.owner_addr))
                resp = client.call("get_inline", {"object_id": oid_hex, "wait": False}, timeout=2)
                return resp.get("kind") in ("inline", "plasma")
            except Exception:
                return False
        return obj is not None and (obj.in_plasma or oid_hex in self.in_process_store)

    def as_future(self, ref) -> ConcurrentFuture:
        fut: ConcurrentFuture = ConcurrentFuture()

        def _resolve():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    # ==================================================================
    # Actor submission (reference: direct_actor_task_submitter.h:67)
    # ==================================================================

    def create_actor(self, cls, args, kwargs, **opts):
        actor_id = ActorID.of(self.job_id)
        if opts.get("tensor_transport"):
            from ray_tpu_torch.experimental.device_object.descriptor import validate_transport

            validate_transport(opts["tensor_transport"])
        wire_args, arg_refs = self._prepare_args(args, kwargs or {})
        spec = TaskSpec(
            task_id=TaskID.for_task(actor_id).hex(),
            job_id=self.job_id.hex(),
            name=f"{cls.__name__}.__init__",
            task_type=ACTOR_CREATION_TASK,
            function_key=self._export_function(cls),
            args=wire_args,
            num_returns=0,
            # Actors hold no CPU while alive (reference semantics: num_cpus=0
            # default for actor lifetime) so many actors can share a node.
            resources=opts.get("resources") or {},
            owner_addr=list(self.address),
            owner_worker_id=self.worker_id,
            actor_id=actor_id.hex(),
            max_restarts=opts.get("max_restarts", self.cfg.default_actor_max_restarts),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            actor_name=opts.get("name") or "",
            namespace=opts.get("namespace") or self.namespace,
            get_if_exists=opts.get("get_if_exists", False),
            placement_group_id=opts.get("placement_group_id", ""),
            placement_group_bundle_index=opts.get("placement_group_bundle_index", -1),
            scheduling_strategy=opts.get("scheduling_strategy", "DEFAULT"),
            runtime_env=self._merged_runtime_env(opts.get("runtime_env")),
            trace_ctx=self._trace_ctx(),
            tensor_transport=opts.get("tensor_transport") or "",
        )
        for ref in arg_refs:
            self._pin_arg(ref)
        if arg_refs:
            self._actor_creation_args[actor_id.hex()] = list(arg_refs)
        # Bounded per-attempt ack (acall retries on TimeoutError): a
        # register_actor request/reply silently lost on the wire used to
        # park .remote() FOREVER — no timeout, no backstop, not even the
        # 2-minute kind. The GCS handler is idempotent under the retry
        # (remembered outcome; see gcs.rpc_register_actor). Transport
        # exhaustion surfaces as the TYPED unavailability error naming the
        # component, not a bare TimeoutError.
        from ray_tpu_torch.exceptions import ActorUnavailableError

        try:
            resp = self.gcs.call(
                "register_actor", {"spec": spec.to_wire()}, timeout=15
            )
        except (TimeoutError, ConnectionLost) as e:
            raise ActorUnavailableError(
                f"could not register actor {cls.__name__} with the GCS at "
                f"{self.gcs.address}: {type(e).__name__}: {e}"
            ) from e
        if not resp.get("ok"):
            err = resp.get("error", "actor registration failed")
            if "no feasible node" in err:
                # Placement exhaustion is a (possibly transient) cluster
                # condition, not a caller bug: surface the TYPED
                # unavailability error; name collisions etc. stay ValueError.
                raise ActorUnavailableError(f"actor {cls.__name__}: {err}")
            raise ValueError(err)
        return {
            "actor_id": resp["actor_id"],
            "max_task_retries": spec.max_task_retries,
            "name": spec.actor_name,
        }

    @blocking
    def _resolve_actor(self, actor_id: str, timeout: float | None = None) -> tuple:
        """Wait for the actor's address. Reference semantics: calls to an
        actor still being created BUFFER until it is ready (creation can
        legitimately take long under load — worker spawn + heavy imports), so
        the timeout clock only runs while the actor is NOT progressing
        through PENDING_CREATION/RESTARTING."""
        timeout = timeout if timeout is not None else self.cfg.worker_lease_timeout_s
        deadline = time.monotonic() + timeout
        creation_deadline = time.monotonic() + self.cfg.actor_creation_timeout_s
        while True:
            addr = self._actor_addrs.get(actor_id)
            if addr is not None:
                return addr
            # Bounded read (idempotent): a lost reply costs one retry, not
            # the resolve loop wedged forever inside its own deadline.
            resp = self.gcs.call("get_actor", {"actor_id": actor_id}, timeout=10)
            if not resp.get("found"):
                raise ActorDiedError(f"actor {actor_id[:8]} not found")
            info = resp["info"]
            if info["state"] == "ALIVE" and info.get("address"):
                addr = tuple(info["address"])
                self._actor_addrs[actor_id] = addr
                return addr
            if info["state"] == "DEAD":
                raise ActorDiedError(
                    f"actor {actor_id[:8]} is dead: {info.get('death_cause', '')}",
                    actor_id=actor_id,
                )
            in_creation = info["state"] in ("PENDING_CREATION", "RESTARTING")
            limit = creation_deadline if in_creation else deadline
            if time.monotonic() > limit:
                raise ActorDiedError(
                    f"timed out resolving actor {actor_id[:8]} (state {info['state']})"
                )
            time.sleep(0.05)

    @blocking
    def _actor_client(self, actor_id: str) -> RpcClient:
        addr = self._resolve_actor(actor_id)
        client = self._actor_clients.get(actor_id)
        if client is None or client.address != addr:
            if client is not None:
                client.close()
            # Short connect timeout: a dead actor should surface as
            # ActorDiedError quickly; restarts re-resolve through GCS anyway.
            client = RpcClient(addr, label=f"actor-{actor_id[:8]}", connect_timeout=2.0)
            self._actor_clients[actor_id] = client
        return client

    def submit_actor_task(self, actor_id: str, method_name: str, args, kwargs, num_returns=1, max_task_retries=0):
        from ray_tpu_torch.object_ref import ObjectRef

        if not isinstance(num_returns, int):
            raise ValueError(
                "num_returns='streaming' is not supported for actor tasks yet; "
                "use a normal @ray_tpu_torch.remote task"
            )
        task_id = self._next_task_id()
        wire_args, arg_refs = self._prepare_args(args, kwargs or {})
        self._actor_seq[actor_id] += 1
        spec = TaskSpec(
            task_id=task_id.hex(),
            job_id=self.job_id.hex(),
            name=method_name,
            task_type=ACTOR_TASK,
            args=wire_args,
            num_returns=num_returns,
            owner_addr=list(self.address),
            owner_worker_id=self.worker_id,
            actor_id=actor_id,
            method_name=method_name,
            seq_no=self._actor_seq[actor_id],
            max_task_retries=max_task_retries,
            trace_ctx=self._trace_ctx(),
        )
        self._register_pending(spec, arg_refs)
        self._actor_pending[actor_id].add(spec.task_id)
        self._io.spawn(self._drive_actor_call(spec, attempts_left=max(0, max_task_retries)))
        return [
            ObjectRef(ObjectID.for_return(task_id, i), self.address)
            for i in range(num_returns)
        ]

    @loop_only
    def _actor_client_cached(self, actor_id: str) -> RpcClient | None:
        """Loop-safe fast path: the already-resolved, address-matching client
        for an actor, or None. Skips the run_in_executor round trip (two
        thread handoffs) that the cold resolve path needs for its blocking
        GCS lookup — on the warm sync-call loop that round trip was the
        single largest owner-side cost."""
        addr = self._actor_addrs.get(actor_id)
        if addr is None:
            return None
        client = self._actor_clients.get(actor_id)
        if client is None or client.address != addr:
            return None
        return client

    async def _await_actor_resp(self, client, spec: TaskSpec, wire, fut):
        """Await an actor call's response with LOSS detection. An actor
        method may legitimately run for hours, so there is no result
        timeout — but a silently lost request or response frame (the
        connection stays up, so no ConnectionLost ever fires and no sweep
        covers actor calls) used to park the call FOREVER. Every ack
        interval with no response, probe the worker over the same FIFO
        connection: 'never received' is proof of request loss (the probe
        cannot overtake the request frame) -> resend, deduped worker-side
        by task id; a cached result means the RESPONSE frame was lost ->
        the probe re-delivers it."""
        ack = max(2.0, self.cfg.task_done_ack_timeout_s)
        futs = {fut}
        try:
            while True:
                if not futs:
                    # Every outstanding seq answered dup: the seq carrying
                    # the real answer died with a reset connection while
                    # the method still runs. PACE on the probe (an
                    # immediate resend would spin dup/resend at round-trip
                    # rate for the method's whole runtime) — completion
                    # re-delivers through the worker's result cache.
                    await asyncio.sleep(min(1.0, ack))
                    probe = await client.acall(
                        "actor_has_task", {"task_id": spec.task_id},
                        timeout=5, retries=1,
                    )
                    if probe.get("result") is not None:
                        return probe["result"]
                    if probe.get("has"):
                        continue  # still executing; keep pacing
                    resent = client.send_nowait("actor_call", wire)
                    if resent is None:
                        resent = await client.astart_call("actor_call", wire)
                    futs.add(resent)
                done, _pending = await asyncio.wait(
                    futs, timeout=ack, return_when=asyncio.FIRST_COMPLETED
                )
                for f in done:
                    resp = await f  # done: instant; raises ConnectionLost up
                    futs.discard(f)
                    if not (isinstance(resp, dict) and resp.get("dup")):
                        return resp
                    # dup marker: the real answer rides another pending seq.
                if done:
                    continue
                probe = await client.acall(
                    "actor_has_task", {"task_id": spec.task_id}, timeout=5, retries=1
                )
                if probe.get("result") is not None:
                    return probe["result"]
                if not probe.get("has"):
                    resent = client.send_nowait("actor_call", wire)
                    if resent is None:
                        resent = await client.astart_call("actor_call", wire)
                    futs.add(resent)
                # has=True, no result yet: the method is genuinely running —
                # keep waiting with no bound, as before.
        finally:
            # Abandoned duplicates (we returned/raised with sends still
            # pending) must not surface never-retrieved exceptions when the
            # connection eventually resolves them.
            for f in futs:
                if not f.done():
                    f.add_done_callback(lambda x: x.cancelled() or x.exception())

    async def _drive_actor_call(self, spec: TaskSpec, attempts_left: int):
        actor_id = spec.actor_id
        loop = asyncio.get_event_loop()
        # Per-actor FIFO lock: resolve + send under the lock so calls hit the
        # wire in submission order (reference: sequential_actor_submit_queue.h);
        # responses are awaited outside so calls still pipeline.
        lock = self._actor_submit_locks[actor_id]
        while True:
            try:
                async with lock:
                    client = self._actor_client_cached(actor_id)
                    if client is None:
                        client = await loop.run_in_executor(None, self._actor_client, actor_id)
                    wire = {"spec": spec.to_wire()}
                    fut = client.send_nowait("actor_call", wire)
                    if fut is None:
                        fut = await client.astart_call("actor_call", wire)
                resp = await self._await_actor_resp(client, spec, wire, fut)
                self._handle_task_done(spec.task_id, resp)
                return
            except ActorDiedError as e:
                self._fail_task(spec.task_id, e)
                return
            except (ConnectionLost, RpcError, OSError) as e:
                # Actor process may be restarting; drop the cached address and
                # re-resolve (reference: GCS-driven actor restart, client resubmit).
                self._actor_addrs.pop(actor_id, None)
                old = self._actor_clients.pop(actor_id, None)
                if old is not None:
                    old.close()
                if attempts_left <= 0:
                    self._fail_task(
                        spec.task_id,
                        ActorDiedError(f"actor {actor_id[:8]} died during call: {e}", actor_id=actor_id),
                    )
                    return
                attempts_left -= 1
                await asyncio.sleep(0.1)

    # ==================================================================
    # Cancellation (reference: worker.py:2773 ray.cancel +
    # core_worker.cc CancelTask / task_manager.cc MarkTaskCanceled)
    # ==================================================================

    def cancel(self, ref, force: bool = False, recursive: bool = True):
        """Cancel the task that produces ``ref``. Best-effort and async like
        the reference: returns immediately; a successful cancel surfaces as
        TaskCancelledError from ``get`` on the task's returns."""
        task_id = ref.id.task_id().hex()
        if (
            ref.owner_addr is not None
            and tuple(ref.owner_addr) != tuple(self.address)
        ):
            # Borrowed ref: only the owner tracks the producing task —
            # forward (reference: RemoteCancelTask to the owner).
            msg = {"task_id": task_id, "force": force, "recursive": recursive}
            if force:
                # force=True can be invalid (actor tasks) and the reference
                # surfaces that as ValueError at the call site — so this one
                # path is synchronous: wait for the owner's verdict instead
                # of discarding it in a fire-and-forget coroutine.
                resp = self._owner_client(tuple(ref.owner_addr)).call(
                    "cancel_task", msg, timeout=30
                )
                if (resp or {}).get("error"):
                    raise ValueError(resp["error"])
                return

            async def _fwd():
                try:
                    resp = await self._owner_client(tuple(ref.owner_addr)).acall(
                        "cancel_task", msg, timeout=30
                    )
                    if (resp or {}).get("error"):
                        logger.warning(
                            "cancel of %s rejected by owner: %s",
                            task_id[:8], resp["error"],
                        )
                except Exception:
                    logger.warning("forwarding cancel of %s to owner failed", task_id[:8])

            self._io.spawn(_fwd())
            return
        self.cancel_owned(task_id, force=force, recursive=recursive)

    def cancel_owned(self, task_id: str, force: bool = False, recursive: bool = True) -> bool:
        """Owner-side cancel. Returns False if the task already finished."""
        with self._lock:
            pending = self.pending_tasks.get(task_id)
        if pending is None:
            return False
        if pending.spec.is_actor_task() and force:
            raise ValueError(
                "force=True is not supported for actor tasks (reference "
                "semantics: kill the actor with ray_tpu_torch.kill instead)"
            )
        pending.cancel_requested = True
        self._io.spawn(self._drive_cancel(pending, force, recursive))
        return True

    def _cancel_error(self, spec: TaskSpec) -> TaskCancelledError:
        return TaskCancelledError(
            f"task {spec.name} ({spec.task_id[:8]}) was cancelled"
        )

    async def _drive_cancel(self, pending: PendingTask, force: bool, recursive: bool):
        spec = pending.spec
        task_id = spec.task_id
        msg = {"task_id": task_id, "force": bool(force), "recursive": bool(recursive)}
        loop = asyncio.get_event_loop()
        try:
            if spec.is_actor_task():
                # Queued or running at the actor process: its executor
                # dequeues pre-dispatch calls and interrupts the running one.
                try:
                    client = await loop.run_in_executor(None, self._actor_client, spec.actor_id)
                    await client.acall("cancel_exec", msg, timeout=30)
                except Exception:
                    # Actor unreachable (dead/restarting): the call will fail
                    # through the normal actor-death path; nothing to recall.
                    pass
                return
            if pending.phase == "resolving":
                # Still owner-local, waiting on args: the deferred submitter
                # checks cancel_requested and aborts; fail the task now.
                self._fail_task(task_id, self._cancel_error(spec))
                return
            # Drain owner-local submit buffers (classic path).
            with self._submit_lock:
                for s in self._submit_buf:
                    if s.task_id == task_id:
                        self._submit_buf.remove(s)
                        self._fail_task(task_id, self._cancel_error(spec))
                        return
            lm = self._lease_mgr
            if lm is not None and self._lease_eligible(spec):
                if lm.cancel_queued(task_id):
                    # Recalled from owner-side lease staging, never shipped.
                    self._fail_task(task_id, self._cancel_error(spec))
                    return
                lease = lm.lease_for(task_id)
                if lease is not None:
                    try:
                        await lease.client.acall("cancel_exec", msg, timeout=30)
                    except Exception:
                        pass  # worker death → lease failover sees cancel_requested
                    return
                # Not staged, not in flight: completion raced us; if still
                # pending, fall through to the raylet probe below.
            resp = {}
            try:
                resp = await self.raylet.acall("cancel_task", msg, timeout=30)
            except Exception:
                pass
            with self._lock:
                still_pending = task_id in self.pending_tasks
            if still_pending and (resp.get("dequeued") or not resp.get("found")):
                # Dequeued before dispatch, or nowhere in the cluster
                # (pre-arrival tombstones drop it if it shows up late).
                self._fail_task(task_id, self._cancel_error(spec))
        except Exception:
            logger.exception("cancel of task %s failed", task_id[:8])

    @any_thread
    def mark_cancelled(self, task_id: str):
        """Tombstone: drop this task if it arrives for execution later."""
        self._cancelled_tasks.add(task_id)

    def cancelled_payload(self, spec: TaskSpec) -> dict:
        err = self._cancel_error(spec)
        return {
            "task_id": spec.task_id,
            "results": [],
            "error": serialization.serialize(err).to_bytes(),
            "cancelled": True,
            "duration_s": 0.0,
        }

    def interrupt_running_task(self, task_id: str, force: bool = False) -> bool:
        """Interrupt the thread currently executing ``task_id``. Non-force
        raises TaskCancelledError at the next bytecode boundary (analog of
        the reference's KeyboardInterrupt into the executing thread); force
        kills the worker process like the reference's force-kill."""
        with self._active_exec_lock:
            ident = None
            for entry in self._active_exec.values():
                if len(entry) > 2 and entry[1].task_id == task_id:
                    ident = entry[2]
                    break
            if ident is None:
                return False
            self.mark_cancelled(task_id)  # lets execute_task tag the payload
            if force:
                import signal as _signal

                os.kill(os.getpid(), _signal.SIGKILL)
                return True  # unreachable
            if ident == self._main_thread_ident:
                # Main-thread task: deliver via SIGUSR2 so the raising
                # handler (installed by worker_main) aborts even C-blocked
                # calls — time.sleep, socket waits — per PEP 475. An
                # async-exc alone only lands on a bytecode boundary, which a
                # C-level block never reaches. The handler re-checks that
                # _main_task_id still equals the target so a late signal
                # can't cancel a subsequent task.
                import signal as _signal

                self._main_cancel_target = task_id
                try:
                    _signal.pthread_kill(ident, _signal.SIGUSR2)
                    return True
                except Exception:
                    pass  # handler unavailable: fall back to async-exc
            import ctypes

            # Fired while holding _active_exec_lock: execute_task's finally
            # must take this lock before the thread can move on to another
            # task, so the async-exc cannot land inside an unrelated task's
            # body (the reference re-checks the executing task id the same
            # way before raising into the thread).
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident), ctypes.py_object(TaskCancelledError)
            )
        return True

    def cancel_children_of(self, parent_task_id: str, force: bool, recursive: bool):
        """Cancel every pending task THIS process owns that was submitted by
        ``parent_task_id`` (recursive cancellation: children of a task are
        owned by the worker that executed it)."""
        with self._lock:
            children = [
                tid
                for tid, p in self.pending_tasks.items()
                if p.parent_task_id == parent_task_id
            ]
        for tid in children:
            try:
                self.cancel_owned(tid, force=force, recursive=recursive)
            except ValueError:
                pass  # force on an actor-task child: skip, cancel the rest

    async def rpc_cancel_task(self, req):
        """Owner-side handler for forwarded cancels (borrower → owner)."""
        try:
            found = self.cancel_owned(
                req["task_id"],
                force=bool(req.get("force")),
                recursive=req.get("recursive", True),
            )
        except ValueError as e:
            return {"found": True, "error": str(e)}
        return {"found": found}

    @any_thread
    def _fail_task(self, task_id: str, error: BaseException):
        with self._lock:
            pending = self.pending_tasks.get(task_id)
            if pending is None or pending.done_claimed:
                return
            pending.done_claimed = True
        ser = serialization.serialize(error).to_bytes()
        with self._lock:
            stream = self._streams.get(task_id)
            for oid in pending.spec.return_object_ids():
                self.in_process_store[oid] = {"data": ser, "value": error}
            # Pop only after the error entries are visible (same ordering
            # contract as _handle_task_done).
            self.pending_tasks.pop(task_id, None)
        if stream is not None:
            with stream["cond"]:
                stream["error"] = ser
                stream["cond"].notify_all()
        self._set_events(pending.spec.return_object_ids())
        if pending.spec.actor_id:
            self._actor_pending[pending.spec.actor_id].discard(task_id)
        self._unpin_args(pending.arg_refs)

    # ==================================================================
    # Owner-side RPC handlers
    # ==================================================================

    def _duplicate_completion(self, payload: dict) -> bool:
        cid = payload.get("cid")
        if not cid:
            return False
        if cid in self._seen_completions:
            return True
        self._seen_completions.add(cid)
        return False

    async def rpc_task_done(self, req):
        if self._duplicate_completion(req):
            return {"ok": True}
        self._handle_task_done(req["task_id"], req)
        return {"ok": True}

    async def rpc_tasks_done(self, req):
        """Batched completions from a leased worker (lease_manager.py).

        Runs on the IO loop, so _handle_task_done's event sets are inline —
        the whole batch of future wakeups costs zero extra loop ticks
        (sync getters wake directly off their threading.Event)."""
        now = time.monotonic()
        lm = self._lease_mgr
        shapes = set()
        for payload in req["batch"]:
            if self._duplicate_completion(payload):
                continue
            if lm is not None:
                shapes.add(lm.on_task_done(payload["task_id"], payload.get("duration_s")))
            self._handle_task_done(payload["task_id"], payload)
        if lm is not None:
            lm.topup(shapes)
        return {"ok": True}

    async def rpc_lease_revoked(self, req):
        if self._lease_mgr is not None:
            self._lease_mgr.on_lease_revoked(
                req["lease_id"],
                oom=bool(req.get("oom")),
                reason=req.get("reason") or "revoked by raylet",
            )
        return {"ok": True}

    async def rpc_stream_item(self, req):
        self._record_stream_item(req["task_id"], req["index"], req["result"])
        return {"ok": True}

    def _record_stream_item(self, task_id: str, index: int, result: list):
        oid, kind, data = result[0], result[1], result[2]
        contained = result[3] if len(result) > 3 else []
        with self._lock:
            obj = self.owned.setdefault(oid, OwnedObject())
            if contained:
                obj.contained = contained
            if len(result) > 4 and result[4]:
                # A device-object item must never lose its holder
                # coordinates — that's the free protocol (see
                # _handle_task_done).
                obj.device = result[4]
            if kind == "inline":
                self.in_process_store[oid] = {"data": data}
            else:
                obj.in_plasma = True
                obj.location_hint = data
            stream = self._streams.get(task_id)
        self._set_event(oid)
        if stream is not None:
            # Index-keyed (not append): item delivery is pipelined, so
            # robustness can't depend on arrival order.
            with stream["cond"]:
                stream["items"][index] = oid
                stream["cond"].notify_all()

    def _drop_stream_locked(self, task_id: str):
        """Remove stream state and free its never-wrapped items (oids the
        consumer never turned into ObjectRefs sit at ref_count 0 and would
        otherwise leak in the owner forever). Caller holds self._lock."""
        stream = self._streams.pop(task_id, None)
        if stream is None:
            return
        for oid in stream["items"].values():
            obj = self.owned.get(oid)
            if obj is not None and obj.ref_count == 0 and obj.pinned == 0:
                self._maybe_free_locked(oid, obj)

    def _reset_stream_for_retry(self, task_id: str):
        """A retried streaming task re-yields from index 0: clear delivered
        items so the re-execution's (same-oid) items replace them instead of
        duplicating, and the consumer just blocks until re-production
        catches up with its position."""
        with self._lock:
            stream = self._streams.get(task_id)
        if stream is not None:
            with stream["cond"]:
                stream["items"].clear()
                stream["error"] = None
                stream["count"] = None

    @blocking
    def stream_next(self, task_id: str, index: int, timeout: float | None = None):
        """Block until stream item `index` exists; returns its oid hex.
        Raises StopIteration past the end and re-raises task errors."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        with self._lock:
            stream = self._streams.get(task_id)
        if stream is None:
            if index == 0:
                raise StopIteration  # unknown/never-streamed task
            # Mid-iteration loss (state evicted or re-iteration of a
            # consumed stream): an explicit error beats silent truncation.
            raise ObjectLostError(
                f"stream state for task {task_id[:8]} is gone (consumed or evicted)"
            )
        deadline = time.monotonic() + timeout if timeout is not None else None
        complete_since = None  # when count became known with this item missing
        with stream["cond"]:
            while True:
                if index in stream["items"]:
                    return stream["items"][index]
                if stream["error"] is not None:
                    err = serialization.loads(stream["error"])
                    with self._lock:
                        self._drop_stream_locked(task_id)  # single consumption
                    raise err
                if stream["count"] is not None:
                    if index >= stream["count"]:
                        with self._lock:
                            self._drop_stream_locked(task_id)  # exhausted
                        raise StopIteration
                    # Task finished but this item never arrived (its
                    # fire-and-forget delivery was lost): bounded wait, then
                    # a typed error instead of hanging forever.
                    if complete_since is None:
                        complete_since = time.monotonic()
                    elif time.monotonic() - complete_since > 60.0:
                        raise ObjectLostError(
                            f"stream item {index} of task {task_id[:8]} was "
                            "never delivered (producer finished)"
                        )
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"stream item {index} of {task_id[:8]} timed out")
                stream["cond"].wait(timeout=min(remaining, 1.0) if remaining else 1.0)

    @loop_only
    def _handle_task_done(self, task_id: str, payload: dict):
        with self._lock:
            pending = self.pending_tasks.get(task_id)
            if pending is None or pending.done_claimed:
                return
        error = payload.get("error")
        if (
            error is not None
            and pending.spec.retry_exceptions
            and pending.retries_left > 0
            and not pending.cancel_requested
            and not payload.get("cancelled")
        ):
            pending.retries_left -= 1
            self._reset_stream_for_retry(task_id)
            # May run on the IO loop (rpc handler) — must not block.
            self._io.spawn(self.raylet.acall("submit_task", {"spec": pending.spec.to_wire()}))
            return
        with self._lock:
            if pending.done_claimed:
                return  # duplicate completion raced us past the first check
            pending.done_claimed = True
            stream = self._streams.get(task_id)
        if stream is not None:
            with stream["cond"]:
                if error is not None:
                    stream["error"] = bytes(error)
                else:
                    stream["count"] = payload.get("stream_count", len(stream["items"]))
                stream["cond"].notify_all()
        with self._lock:
            for result in payload.get("results", []):
                oid, kind, data = result[0], result[1], result[2]
                contained = result[3] if len(result) > 3 else []
                obj = self.owned.setdefault(oid, OwnedObject())
                if contained:
                    obj.contained = contained
                if len(result) > 4 and result[4]:
                    # Device object: result is a descriptor; the holder's
                    # coordinates drive the free-on-last-ref protocol.
                    obj.device = result[4]
                if kind == "inline":
                    self.in_process_store[oid] = {"data": data}
                else:  # plasma
                    obj.in_plasma = True
                    obj.location_hint = data
            if error is not None:
                for oid in pending.spec.return_object_ids():
                    self.in_process_store[oid] = {"data": error}
            # Retain lineage for reconstruction.
            self.lineage[task_id] = pending.spec
            while len(self.lineage) > 10_000:
                self.lineage.popitem(last=False)
            # Pop LAST, after results are visible: a getter observing the
            # task gone from pending_tasks must find its results (the old
            # pop-first ordering had a window where a concurrent get() saw
            # neither and misread the object as lost).
            self.pending_tasks.pop(task_id, None)
        self._set_events(pending.spec.return_object_ids())
        if pending.spec.actor_id:
            self._actor_pending[pending.spec.actor_id].discard(task_id)
        self._unpin_args(pending.arg_refs)

    async def rpc_task_failed(self, req):
        """Raylet tells us a worker died mid-task (reference: retry path)."""
        task_id = req["task_id"]
        with self._lock:
            pending = self.pending_tasks.get(task_id)
        if pending is None:
            return {"ok": True}
        if pending.cancel_requested:
            # Worker died while (or because) this task was being cancelled —
            # e.g. force-kill. Surface cancellation, never retry.
            self._fail_task(task_id, self._cancel_error(pending.spec))
            return {"ok": True}
        if req.get("retriable", True) and pending.retries_left > 0:
            pending.retries_left -= 1
            logger.info(
                "task %s failed (%s); retrying (%d left)",
                task_id[:8],
                req.get("message", ""),
                pending.retries_left,
            )
            self._reset_stream_for_retry(pending.spec.task_id)
            await self.raylet.acall("submit_task", {"spec": pending.spec.to_wire()})
        else:
            message = req.get("message", "worker crashed")
            if req.get("error") == "OutOfMemoryError":
                self._fail_task(task_id, OutOfMemoryError(message))
            else:
                self._fail_task(task_id, WorkerCrashedError(message))
        return {"ok": True}

    # ---- device object plane (experimental/device_object/) ----

    async def rpc_devobj_pull(self, req):
        """Consumer asks the holder for a device object's payload. Decides
        the transfer in one round trip: a shared collective group (named by
        the consumer) kicks off a p2p send the consumer recv()s; otherwise
        small tensors ship inline and large ones are sealed into this node's
        arena under the same object id for the store pull path."""
        mgr = self._device_objects
        oid = req["object_id"]
        entry = mgr.entry(oid) if mgr is not None else None
        if entry is None:
            return {"kind": "missing"}
        loop = asyncio.get_event_loop()
        dkey = req.get("direct_key")
        if dkey is not None:
            # Direct-mailbox reply (serve.llm KV handoff / prefix tier): the
            # consumer named its own inbox key in the request, so ONE round
            # trip decides the transfer and the payload streams straight to
            # its p2p inbox — no group membership, no store seal, no arena
            # copy. Serialization runs off-loop; the entry may be freed
            # concurrently (LRU eviction racing an import), in which case
            # host_bytes reads None and the consumer gets a typed miss —
            # never a torn payload.
            data = await loop.run_in_executor(None, mgr.host_bytes, oid)
            if data is None:
                return {"kind": "missing"}
            from ray_tpu_torch.util.collective.p2p import direct_send

            direct_send(self, tuple(req["direct_addr"]), dkey, data)
            return {"kind": "direct", "nbytes": len(data)}
        group = req.get("group")
        if group is not None and entry.meta.transport == "collective":
            from ray_tpu_torch.util.collective import get_group, is_group_initialized

            if is_group_initialized(group):
                src_rank = get_group(group).rank
                # Send on an executor thread: serialization + the mailbox
                # round trips must not stall this process's IO loop.
                loop.run_in_executor(
                    None, mgr.send_via_group, oid, group, req["dst_rank"], req["tag"]
                )
                return {"kind": "collective", "group": group, "src_rank": src_rank}
        # Spilled entries already have an arena copy under this oid: point
        # the consumer at the store instead of restoring device-side just to
        # re-serialize (the restore would also re-pin memory that pressure
        # evicted).
        if (
            entry.array is not None
            and entry.meta.nbytes <= self.cfg.max_direct_call_object_size
        ):
            data = await loop.run_in_executor(None, mgr.host_bytes, oid)
            if data is not None:
                return {"kind": "inline", "data": data}
        ok = await loop.run_in_executor(None, mgr.materialize_to_store, oid)
        if ok:
            return {"kind": "plasma", "location": self.node_id}
        return {"kind": "missing"}

    async def rpc_devobj_free(self, req):
        """Owner's last ref dropped: release the device buffers here."""
        mgr = self._device_objects
        if mgr is not None:
            mgr.free(req["object_id"])
        return {"ok": True}

    async def rpc_devobj_release(self, req):
        """A channel-payload consumer resolved its descriptor slot: drop
        one pin; the last pin frees (device_envelope.release)."""
        mgr = self._device_objects
        if mgr is not None:
            mgr.release_pin(req["object_id"])
        return {"ok": True}

    async def rpc_p2p_data(self, req):
        """Direct-mailbox payload chunk (one-way): an eager-pushed channel
        payload or any address-directed p2p transfer lands here for a
        blocked direct_recv to take. A channel payload's deposit doubles as
        the channel doorbell (the producer skipped the separate wakeup
        frame: the payload lands right after the slot publish, so ONE frame
        both delivers the bytes and wakes the blocked reader)."""
        key = req["key"]
        if key.startswith("collred/"):
            # Tree-reduce partials: consumed chunk-at-a-time by a combiner
            # on an executor thread — never reassembled, so they land in
            # the stream pads instead of the inbox.
            self.p2p_streams.deposit(key, req.get("idx", 0), req["data"])
            return {"ok": True}
        done = self.p2p_inbox.deposit(
            key, req.get("idx", 0), req.get("total", 1), req["data"]
        )
        if req.get("relay"):
            # Mid-tree member of a tree broadcast: forward this chunk to
            # our own children the moment the contiguous prefix reaches it
            # (cut-through; the inbox keeps its copy for the local take).
            self.p2p_relays.feed(
                self, key, req.get("idx", 0), req.get("total", 1),
                req["data"], req["relay"],
            )
        if done and key.startswith("chdev/"):
            self.channels.ring_doorbell(key.split("/", 2)[1])
        return {"ok": True}

    async def rpc_p2p_ack(self, req):
        """Delivery receipt for a direct-mailbox payload: True once every
        chunk of ``key`` has landed (including already-taken payloads — the
        tombstone remembers). The group-broadcast fan-out acalls this after
        its chunk pushes, turning the one-way frames into a confirmed
        delivery and a dead member into a NAMED failure."""
        timeout = min(float(req.get("timeout", 2.0)), 30.0)
        if self.p2p_inbox.completed(req["key"]):
            return {"ok": True}
        loop = asyncio.get_event_loop()
        ok = await loop.run_in_executor(
            None, self.p2p_inbox.wait_complete, req["key"], timeout
        )
        return {"ok": bool(ok)}

    async def rpc_devobj_broadcast(self, req):
        """Driver asks this HOLDER to fan a device object out: with a
        ``group`` (one this process initialized), one group operation
        delivers to every member's direct mailbox
        (manager.broadcast_via_group); without one, materialize the host
        copy into this node's arena so the caller can relay it cluster-wide
        over the cut-through push tree (the cross-node fallback)."""
        mgr = self._device_objects
        oid = req["object_id"]
        entry = mgr.entry(oid) if mgr is not None else None
        if entry is None:
            return {"kind": "missing"}
        loop = asyncio.get_event_loop()
        group = req.get("group")
        if group is not None:
            from ray_tpu_torch.util.collective import is_group_initialized

            if not is_group_initialized(group):
                return {
                    "kind": "error",
                    "error": f"holder has no collective group {group!r}",
                }
            try:
                result = await loop.run_in_executor(
                    None, mgr.broadcast_via_group, oid, group,
                    float(req.get("timeout", 30.0)),
                )
            except KeyError:
                return {"kind": "missing"}
            return {"kind": "collective", **result}
        ok = await loop.run_in_executor(None, mgr.materialize_to_store, oid)
        if ok:
            return {"kind": "plasma", "location": self.node_id}
        return {"kind": "missing"}

    async def rpc_devobj_reduce(self, req):
        """One HOLDER's share of a device-object group reduce/allreduce:
        feed the resident tensor into the tree combine on an executor
        thread (chunk waits + elementwise math must not stall the IO
        loop). The gang is concurrent by construction — the driver
        dispatches every holder's RPC in parallel and each holder blocks
        in the collective until its children/parent move."""
        mgr = self._device_objects
        oid = req["object_id"]
        entry = mgr.entry(oid) if mgr is not None else None
        if entry is None:
            return {"kind": "missing"}
        group = req.get("group")
        from ray_tpu_torch.util.collective import is_group_initialized

        if group is None or not is_group_initialized(group):
            return {
                "kind": "error",
                "error": f"holder has no collective group {group!r}",
            }
        loop = asyncio.get_event_loop()
        try:
            result = await loop.run_in_executor(
                None, mgr.reduce_via_group, oid, group,
                req.get("mode", "allreduce"), req.get("op", "SUM"),
                int(req.get("dst_rank", 0)), req["tag"],
                float(req.get("timeout", 60.0)),
            )
        except KeyError:
            return {"kind": "missing"}
        except Exception as e:
            # The collective itself failed (timeout naming a silent child,
            # shape disagreement, ...): the object is intact — answer with
            # the error instead of severing the connection.
            return {"kind": "error", "error": repr(e)}
        return {"kind": "collective", **result}

    async def rpc_devobj_stats(self, req):
        from ray_tpu_torch.experimental.device_object.manager import device_object_stats

        return device_object_stats()

    # ---- compiled-graph channel plane (experimental/channel/) ----

    async def rpc_channel_doorbell(self, req):
        """One-way producer wakeup: the reader blocked on this channel
        re-checks its ring/side-channel now instead of at the next poll."""
        self.channels.ring_doorbell(req["cid"])
        return {"ok": True}

    async def rpc_channel_data(self, req):
        """Side-channel envelope chunk (oversize payloads and the cross-node
        fallback ride this, chunked like the object push path)."""
        gate = self.channels.gate_if_live(req["cid"])
        if gate is None or gate.closed:
            return {"ok": False, "closed": True}
        gate.add_chunk(req["seq"], req["idx"], req["total"], req["data"])
        return {"ok": True}

    async def rpc_channel_query(self, req):
        """Remote-mode backpressure probe: the producer bounds its in-flight
        envelopes by the reader's queue depth."""
        gate = self.channels.gate_if_live(req["cid"])
        if gate is None:
            return {"queued": 0, "closed": True}
        return {"queued": gate.queued(), "closed": gate.closed}

    async def rpc_channel_poison(self, req):
        """Plant a sticky error envelope (actor death propagation): every
        subsequent read on this channel returns the typed error."""
        gate = self.channels.gate_if_live(req["cid"])
        if gate is not None:
            gate.poison(req["env"])
            flight_recorder.record("channel_poison", req["cid"][:12])
        return {"ok": True}

    async def rpc_channel_close(self, req):
        """Teardown: blocked readers raise ChannelClosedError promptly."""
        gate = self.channels.gate_if_live(req["cid"])
        if gate is not None:
            gate.close()
            flight_recorder.record("channel_close", req["cid"][:12])
        return {"ok": True}

    async def rpc_get_inline(self, req):
        """Serve an owned object to a borrower."""
        oid_hex = req["object_id"]
        with self._lock:
            entry = self.in_process_store.get(oid_hex)
            obj = self.owned.get(oid_hex)
        if entry is not None:
            return {"kind": "inline", "data": entry["data"]}
        if obj is not None and obj.in_plasma:
            return {"kind": "plasma", "location": obj.location_hint}
        task_id = oid_hex[: TaskID.SIZE * 2]
        with self._lock:
            pending = task_id in self.pending_tasks
        if pending and req.get("wait"):
            # Honor the caller's slice bound when it sends one: borrowers
            # long-poll in short re-poll slices (loss healing), and a
            # handler parked past its slice serves a seq nobody awaits.
            bound = min(
                float(req.get("timeout") or self.cfg.worker_lease_timeout_s),
                self.cfg.worker_lease_timeout_s,
            )
            await self._wait_event(oid_hex, bound)
            with self._lock:
                entry = self.in_process_store.get(oid_hex)
                obj = self.owned.get(oid_hex)
            if entry is not None:
                return {"kind": "inline", "data": entry["data"]}
            if obj is not None and obj.in_plasma:
                return {"kind": "plasma", "location": obj.location_hint}
        return {"kind": "missing"}

    async def rpc_debug_dump(self, req):
        """This process's flight-recorder ring (the raylet's debug_dump
        aggregates node-wide, including rings of already-dead processes)."""
        proc = flight_recorder.dump()
        return {"processes": [proc] if proc is not None else []}

    async def rpc_pubsub(self, req):
        """GCS pubsub push (driver: worker_logs echo)."""
        if req.get("channel") == "worker_logs" and self.log_to_driver:
            from ray_tpu_torch._private.log_monitor import print_worker_logs

            print_worker_logs(req.get("message") or {}, self.job_id.hex())
        return {"ok": True}

    async def rpc_incref(self, req):
        with self._lock:
            self.owned.setdefault(req["object_id"], OwnedObject()).ref_count += 1
        return {"ok": True}

    async def rpc_decref(self, req):
        oid = req["object_id"]
        with self._lock:
            obj = self.owned.get(oid)
            if obj is not None:
                obj.ref_count -= 1
                self._maybe_free_locked(oid, obj)
        return {"ok": True}

    def register_ref(self, ref):
        oid = ref.hex()
        if ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address):
            with self._lock:
                self.owned.setdefault(oid, OwnedObject()).ref_count += 1
        else:
            self._push_to_owner(ref, "incref")

    def deregister_ref(self, ref):
        if self._shutdown:
            return
        oid = ref.hex()
        if ref.owner_addr is None or tuple(ref.owner_addr) == tuple(self.address):
            with self._lock:
                obj = self.owned.get(oid)
                if obj is not None:
                    obj.ref_count -= 1
                    self._maybe_free_locked(oid, obj)
        else:
            self._push_to_owner(ref, "decref")

    def _incref_contained(self, refs) -> list:
        """Incref nested refs on behalf of a containing object; returns the
        (id, owner) list to store on the container's OwnedObject."""
        contained = []
        for ref in refs or []:
            owner = tuple(ref.owner_addr) if ref.owner_addr else tuple(self.address)
            contained.append((ref.hex(), list(owner)))
            if owner == tuple(self.address):
                with self._lock:
                    self.owned.setdefault(ref.hex(), OwnedObject()).ref_count += 1
            else:
                self._push_to_owner(ref, "incref")
        return contained

    def _decref_contained(self, contained: list):
        from ray_tpu_torch.object_ref import ObjectRef as _Ref

        for cid, owner in contained:
            if tuple(owner) == tuple(self.address):
                with self._lock:
                    obj = self.owned.get(cid)
                    if obj is not None:
                        obj.ref_count -= 1
                        self._maybe_free_locked(cid, obj)
            else:
                self._push_to_owner(_Ref(ObjectID.from_hex(cid), owner, _register=False), "decref")

    def _maybe_free_locked(self, oid: str, obj: OwnedObject):
        """Free the object once all refs + pins are gone. Caller holds _lock."""
        if obj.ref_count > 0 or obj.pinned > 0:
            return
        task_id = oid[: TaskID.SIZE * 2]
        if task_id in self.pending_tasks:
            return
        self.in_process_store.pop(oid, None)
        self.owned.pop(oid, None)
        self._object_events.pop(oid, None)
        if obj.contained:
            contained, obj.contained = obj.contained, []
            # Decref outside any recursion concerns via the same thread; the
            # inner call re-takes the lock per entry.
            self._io.loop.call_soon_threadsafe(self._decref_contained, contained)
        if obj.device is not None:
            dev, obj.device = obj.device, None
            # Release the holder's device buffers (and any spilled copy).
            # Async push / manager-internal lock only — we hold self._lock.
            self._free_device_object(oid, dev)
        if obj.in_plasma:
            async def _free():
                try:
                    await self.raylet.acall("free_object", {"object_id": oid})
                except Exception:
                    pass

            self._io.spawn(_free())

    # ==================================================================
    # Execution side (worker mode; reference: core_worker.cc:2512 loop)
    # ==================================================================

    def _load_function(self, key: str):
        fn = self._function_cache.get(key)
        if fn is None:
            resp = self.gcs.call("kv_get", {"key": key}, timeout=15)
            if not resp.get("found"):
                raise RuntimeError(f"function {key} not in GCS function table")
            fn = cloudpickle.loads(resp["value"])
            self._function_cache[key] = fn
        return fn

    def _resolve_args(self, wire_args: list):
        from ray_tpu_torch.object_ref import ObjectRef

        args = []
        kwargs = {}
        for arg in wire_args:
            if arg[0] == "r":
                ref = ObjectRef(ObjectID.from_hex(arg[1]), tuple(arg[2]))
                value = self.get(ref)
            else:
                value = serialization.deserialize(arg[1])
            if isinstance(value, tuple) and len(value) == 2 and value[0] == "__kwargs__":
                kwargs = value[1]
            else:
                args.append(value)
        return args, kwargs

    def _package_one(self, spec: TaskSpec, value, index: int) -> list:
        """Package a single indexed return (shared by fixed and streaming)."""
        from ray_tpu_torch._private.ids import ObjectID, TaskID

        oid = ObjectID.for_return(TaskID.from_hex(spec.task_id), index).hex()
        if self._tensor_transport and spec.is_actor_task() and (
            _is_device_tensor(value) or type(value).__name__ == "DTensor"
        ):
            # Device object plane: the tensor never leaves this actor's
            # device; the owner gets a descriptor + holder coordinates (a
            # DTensor is refused there, naming ROADMAP A9f).
            return self._package_device(oid, value)
        ser = serialization.serialize(value)
        contained = self._incref_contained(ser.contained_refs)
        if ser.total_size > self.cfg.max_direct_call_object_size:
            self.store.put_serialized(oid, ser)
            return [oid, "plasma", self.node_id, contained]
        return [oid, "inline", ser.to_bytes(), contained]

    def _package_results(self, spec: TaskSpec, values: list) -> list:
        """Serialize return values; small inline, large to plasma. Refs
        nested in a result are incref'd here on the result's behalf and
        shipped so the caller (the result's owner) holds them until the
        result itself is freed (reference: nested-ref borrow handoff)."""
        return [self._package_one(spec, value, i) for i, value in enumerate(values)]

    def execute_task(self, spec: TaskSpec) -> dict:
        """Run one task; returns the task_done payload."""
        if (
            self.mode == WORKER
            and spec.task_type == NORMAL_TASK
            and (spec.job_id, spec.name) != self._log_attr_name
        ):
            # In-band log attribution for the driver's log pipeline: leased
            # tasks never pass through the raylet, so the "(name pid=...)"
            # prefix source must travel with the stdout stream itself
            # (log_monitor.py parses and strips this control line). Keyed by
            # (job, name): a reused worker crossing jobs must re-announce
            # even when the task name repeats.
            self._log_attr_name = (spec.job_id, spec.name)
            print(f"\x01attr:{spec.job_id}:{spec.name}", flush=True)
        if spec.task_id in self._cancelled_tasks:
            # Cancelled before execution started (cancel raced delivery).
            self._cancelled_tasks.discard(spec.task_id)
            self.record_task_event(spec, "CANCELLED")
            return self.cancelled_payload(spec)
        ctx = (TaskID.from_hex(spec.task_id), spec)
        token = _exec_ctx.set(ctx)
        on_main = threading.get_ident() == self._main_thread_ident
        if on_main:
            # Single writer (the main thread itself); read lock-free by the
            # SIGUSR2 cancel handler to decide whether to raise.
            self._main_task_id = spec.task_id
        with self._active_exec_lock:
            self._active_exec_seq += 1
            exec_key = self._active_exec_seq
            # Thread ident rides along so cancellation can interrupt the
            # executing thread (interrupt_running_task).
            self._active_exec[exec_key] = (ctx[0], ctx[1], threading.get_ident())
        from ray_tpu_torch.util import tracing

        trace_token = tracing.set_task_context(spec.trace_ctx)
        start = time.time()
        task_tag = f"{spec.name}:{spec.task_id[:8]}"  # shared by exec/done/fail events
        flight_recorder.record("task_exec", task_tag)
        self.record_task_event(spec, "RUNNING", start_ts=start)
        try:
            if spec.is_actor_task():
                fn = getattr(self._actor_instance, spec.method_name)
            else:
                fn = self._load_function(spec.function_key)
            args, kwargs = self._resolve_args(spec.args)
            if spec.is_actor_creation():
                instance = fn(*args, **kwargs)
                self._actor_instance = instance
                self._actor_id = spec.actor_id
                self._actor_creation_spec = spec
                self._tensor_transport = spec.tensor_transport
                torch = sys.modules.get("torch")
                if torch is not None and torch.cuda.is_initialized():
                    self._cuda_device = torch.cuda.current_device()
                values = []
            else:
                out = fn(*args, **kwargs)
                import inspect as _inspect

                # inspect.iscoroutine, NOT asyncio.iscoroutine: on
                # Python <= 3.10 the latter also matches plain generators
                # (legacy generator-based coroutines), which would route
                # num_returns="streaming" generators into the async-actor
                # loop and blow up on `await <generator>`.
                if _inspect.iscoroutine(out):
                    out = self._run_actor_coroutine(out)
                if spec.is_streaming():
                    if not _inspect.isgenerator(out) and not hasattr(out, "__iter__"):
                        raise TypeError(
                            f"num_returns='streaming' task {spec.name} must "
                            f"return a generator/iterable, got {type(out).__name__}"
                        )
                    # Each yielded value ships to the owner AS PRODUCED — the
                    # caller iterates while this task is still running
                    # (reference: StreamingObjectRefGenerator). Sends are
                    # pipelined (fire-and-forget on the IO loop) so producer
                    # throughput isn't one item per network round trip; the
                    # final task_done travels the same client/connection, so
                    # it serializes after every item write.
                    owner = self._owner_client(tuple(spec.owner_addr))
                    n = 0

                    def _log_lost(fut, idx):
                        exc = fut.exception()
                        if exc is not None:
                            logger.warning(
                                "stream item %d of %s failed to deliver: %r",
                                idx, spec.task_id[:8], exc,
                            )

                    for value in out:
                        item = self._package_one(spec, value, n)
                        fut = self._io.spawn(owner.acall(
                            "stream_item",
                            {"task_id": spec.task_id, "index": n, "result": item},
                        ))
                        fut.add_done_callback(lambda f, i=n: _log_lost(f, i))
                        n += 1
                    values = []
                    stream_count = n
                elif spec.num_returns == 0:
                    values = []
                elif spec.num_returns == 1:
                    values = [out]
                else:
                    values = list(out)
                    if len(values) != spec.num_returns:
                        raise ValueError(
                            f"task {spec.name} declared num_returns={spec.num_returns} "
                            f"but returned {len(values)} values"
                        )
            results = self._package_results(spec, values)
            payload = {"task_id": spec.task_id, "results": results, "error": None}
            if spec.is_streaming() and not spec.is_actor_creation():
                payload["stream_count"] = stream_count
            self._done_event_ctr += 1
            if self._done_event_ctr & 63 == 0:
                flight_recorder.record(
                    "task_done", f"{task_tag}:n={self._done_event_ctr}"
                )
            self.record_task_event(spec, "FINISHED", start_ts=start, end_ts=time.time())
        except BaseException as e:  # noqa: BLE001 — errors ship to the caller
            # CANCELLED only when THIS task was the target of a cancel
            # (interrupt_running_task tombstones before firing). A bare
            # isinstance check would also swallow a stray late async-exc
            # aimed at a previous task on this thread, or user code
            # re-raising a child's TaskCancelledError — both of those are
            # ordinary task failures (retries still apply).
            cancelled = spec.task_id in self._cancelled_tasks
            if cancelled:
                # Interrupted by cancel (or raised it itself): ship the bare
                # TaskCancelledError — owners must not retry it.
                self._cancelled_tasks.discard(spec.task_id)
                payload = self.cancelled_payload(spec)
                self.record_task_event(
                    spec, "CANCELLED", start_ts=start, end_ts=time.time()
                )
            else:
                logger.debug("task %s raised", spec.name, exc_info=True)
                flight_recorder.record(
                    "task_fail", f"{task_tag}:{type(e).__name__}"
                )
                err = TaskError.from_exception(e, task_name=spec.name)
                payload = {
                    "task_id": spec.task_id,
                    "results": [],
                    "error": serialization.serialize(err).to_bytes(),
                }
                self.record_task_event(
                    spec, "FAILED", start_ts=start, end_ts=time.time(), error_type=type(e).__name__
                )
        finally:
            # A late cancel (SIGUSR2 handler raise, or the async-exc landing
            # after the body already exited) can fire INSIDE this finally and
            # would skip the remaining statements, leaking the _active_exec
            # entry and the context tokens. Each step is idempotent-guarded,
            # so retrying until all have run is safe; the pending cancel
            # exception is consumed by the first retry (the SIGUSR2 handler
            # won't re-raise once _main_task_id clears, and an async-exc is
            # delivered at most once).
            while True:
                try:
                    if on_main:
                        self._main_task_id = None
                    if token is not None:
                        _exec_ctx.reset(token)
                        token = None
                    if trace_token is not None:
                        tracing.reset_task_context(trace_token)
                        trace_token = None
                    with self._active_exec_lock:
                        self._active_exec.pop(exec_key, None)
                    break
                except BaseException:  # noqa: BLE001 — late cancel mid-cleanup
                    continue
        payload["duration_s"] = time.time() - start
        return payload

    def _run_actor_coroutine(self, coro):
        """Async actor methods run on a dedicated per-actor event loop."""
        if self._actor_async_loop is None:
            loop = asyncio.new_event_loop()
            t = threading.Thread(target=loop.run_forever, name="actor-async", daemon=True)
            t.start()
            self._actor_async_loop = loop
        # Propagate the task context onto the loop thread: each asyncio Task
        # runs in its own contextvars Context, so setting inside the wrapper
        # is task-local even when coroutines interleave on the shared loop.
        ctx = _exec_ctx.get()
        spec = ctx[1] if ctx is not None else None

        async def _with_ctx():
            if ctx is not None:
                _exec_ctx.set(ctx)
            if spec is not None and spec.trace_ctx:
                from ray_tpu_torch.util import tracing

                tracing.set_task_context(spec.trace_ctx)
            return await coro

        return asyncio.run_coroutine_threadsafe(_with_ctx(), self._actor_async_loop).result()

    # ---- shutdown ----

    def shutdown(self, job_state: str | None = None):
        self._shutdown = True
        if self._lost_sweep_task is not None:
            self._lost_sweep_task.cancel()
            self._lost_sweep_task = None
        for c in list(self._sweep_clients.values()):
            c.close()
        self._sweep_clients.clear()
        if self._lease_mgr is not None:
            try:
                self._lease_mgr.close()
            except Exception:
                pass
        try:
            self.flush_task_events()
        except Exception:
            pass
        # Final metrics window must not vanish with the process: the periodic
        # flusher runs every metrics_flush_interval_s, and this GCS client is
        # about to close.
        try:
            from ray_tpu_torch.util.metrics import flush_metrics

            flush_metrics(self)
        except Exception:
            pass
        flight_recorder.record("exit", self.mode)
        if self.mode == DRIVER:
            if job_state is None:
                job_state = "SUCCEEDED"
            try:
                self.gcs.call(
                    "mark_job_finished",
                    {"job_id": self.job_id.hex(), "state": job_state},
                )
            except Exception:
                pass
        for c in list(self._actor_clients.values()):
            c.close()
        for c in list(self._owner_client_cache.values()):
            c.close()
        for c in list(self._devobj_clients.values()):
            c.close()
        self.server.stop()
        self.store.close()
        self.gcs.close()
        self.raylet.close()
        self._executor.shutdown(wait=False)


_MISSING = object()
