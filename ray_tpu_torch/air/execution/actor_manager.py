"""Event-driven actor lifecycle manager for the AIR execution layer.

Analog of the reference's ``RayActorManager``
(python/ray/air/execution/_internal/actor_manager.py): library controllers
(Tune's trial loop, Train's BackendExecutor) hand actor lifecycle to ONE
audited component instead of each hand-rolling restart/leak semantics.

Model:

- ``add_actor(cls, kwargs, resource_request, ...) -> TrackedActor`` tracks a
  logical actor. Resources are acquired through the ``ResourceManager``
  (refcounted per request instance, so a gang of N actors sharing one
  N-bundle request holds exactly one placement group); the actor process is
  created once the request is ready and ``on_actor_start`` fires when the
  GCS reports it ALIVE.
- ``schedule_actor_task(tracked, method, ...)`` schedules a method call with
  per-task ``on_result``/``on_error`` callbacks. Tasks scheduled before the
  actor is up are queued and submitted on start.
- Process-level death (``ActorDiedError``/``WorkerCrashedError``/...) is an
  ACTOR failure: in-flight tasks are swallowed, ``on_actor_failure(tracked,
  error, will_restart)`` fires, and if the tracked restart budget allows,
  the manager recreates the actor after an exponential backoff —
  ``restart_count`` increments, ``kwargs_fn`` (if given) re-resolves the
  constructor kwargs so a restart can pick up e.g. the latest checkpoint,
  and ``on_actor_start`` fires again. Application exceptions raised by the
  method are TASK errors: ``on_error`` fires, the actor stays alive.
- ``remove_actor`` cleanly cancels in-flight tasks (their callbacks never
  fire), kills the process, fires ``on_actor_stop``, and releases the
  resource acquisition once its last user is gone — guaranteed even when
  the actor died mid-start or mid-task.
- ``next(timeout)`` drives everything: starts due/pending actors, waits on
  in-flight task futures, dispatches callbacks. Callbacks run on the caller
  thread and may reentrantly call manager methods (remove/add/schedule).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Callable, Optional

from ray_tpu_torch.air.execution.resources import (
    AcquiredResources,
    FixedResourceManager,
    ResourceManager,
    ResourceRequest,
)

logger = logging.getLogger(__name__)

# TrackedActor states
PENDING = "PENDING"  # waiting for resources
STARTING = "STARTING"  # actor creation submitted, not ALIVE yet
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"  # failed, waiting out the backoff
STOPPED = "STOPPED"  # removed by the consumer
FAILED = "FAILED"  # failed with no restart budget left

_FAILURE_EXC_NAMES = (
    "ActorDiedError",
    "ActorUnavailableError",
    "ActorError",
    "WorkerCrashedError",
    "NodeDiedError",
    "OwnerDiedError",
    # The memory monitor kills the whole worker process hosting the actor,
    # so an OOM surfacing from an actor task implies process death.
    "OutOfMemoryError",
)


def _is_actor_failure(exc: BaseException) -> bool:
    """Process-level death vs an application exception raised by the method."""
    from ray_tpu_torch import exceptions as exc_mod

    for name in _FAILURE_EXC_NAMES:
        cls = getattr(exc_mod, name, None)
        if cls is not None and isinstance(exc, cls):
            return True
    return False


class TrackedActorTask:
    """Handle for one scheduled method call."""

    __slots__ = ("tracked_actor", "method", "args", "kwargs", "on_result", "on_error", "ref")

    def __init__(self, tracked_actor, method, args, kwargs, on_result, on_error):
        self.tracked_actor = tracked_actor
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.on_result = on_result
        self.on_error = on_error
        self.ref = None  # ObjectRef once submitted


class TrackedActor:
    """A logical actor whose identity survives process restarts."""

    _ids = itertools.count()

    def __init__(
        self,
        cls,
        kwargs: dict,
        *,
        resource_request: ResourceRequest,
        bundle_index: int = 0,
        kwargs_fn: Optional[Callable[[], dict]] = None,
        on_start: Optional[Callable[["TrackedActor"], None]] = None,
        on_stop: Optional[Callable[["TrackedActor"], None]] = None,
        on_failure: Optional[Callable[["TrackedActor", BaseException, bool], None]] = None,
        max_restarts: int = 0,
        restart_backoff_s: float = 0.5,
        graceful_stop_method: str | None = None,
        actor_options: dict | None = None,
    ):
        self.tracked_id = next(self._ids)
        self.state = PENDING
        self.actor_handle = None
        self.actor_id: str | None = None
        self.restart_count = 0
        self.last_error: BaseException | None = None
        self._cls = cls
        self._kwargs = dict(kwargs or {})
        self._kwargs_fn = kwargs_fn
        self.resource_request = resource_request
        self.bundle_index = bundle_index
        self.on_start = on_start
        self.on_stop = on_stop
        self.on_failure = on_failure
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.graceful_stop_method = graceful_stop_method
        # Extra .options() entries (name=, max_concurrency=, runtime_env=,
        # ...) overlaid on the acquisition-derived scheduling options —
        # library controllers with named actors (Serve) need both.
        self.actor_options = dict(actor_options or {})
        self._restart_due = 0.0  # monotonic time the next restart may run
        self._queued_tasks: list[TrackedActorTask] = []

    @property
    def is_live(self) -> bool:
        return self.state in (PENDING, STARTING, ALIVE, RESTARTING)

    def _constructor_kwargs(self) -> dict:
        return dict(self._kwargs_fn()) if self._kwargs_fn is not None else dict(self._kwargs)

    def __repr__(self):
        return (
            f"TrackedActor(#{self.tracked_id}, {self.state}, "
            f"restarts={self.restart_count})"
        )


class ActorManager:
    """Tracks pooled actors, their tasks, and their resource acquisitions."""

    def __init__(self, resource_manager: ResourceManager | None = None):
        self.resource_manager = resource_manager or FixedResourceManager()
        self._tracked: list[TrackedActor] = []
        # resource refcounting: request instance -> (AcquiredResources, users)
        self._acquisitions: dict[int, list] = {}  # id(request) -> [acq, set(tracked)]
        self._inflight: dict[Any, TrackedActorTask] = {}  # ObjectRef -> task
        self._last_state_poll = 0.0

    # -- introspection -----------------------------------------------------

    @property
    def all_actors(self) -> list[TrackedActor]:
        return list(self._tracked)

    @property
    def num_live_actors(self) -> int:
        return sum(1 for t in self._tracked if t.state == ALIVE)

    @property
    def num_pending_actors(self) -> int:
        return sum(1 for t in self._tracked if t.state in (PENDING, STARTING, RESTARTING))

    @property
    def num_tracked_actors(self) -> int:
        return sum(1 for t in self._tracked if t.is_live)

    # -- actor lifecycle ---------------------------------------------------

    def add_actor(
        self,
        cls,
        kwargs: dict | None = None,
        *,
        resource_request: ResourceRequest | None = None,
        bundle_index: int = 0,
        kwargs_fn: Optional[Callable[[], dict]] = None,
        on_start=None,
        on_stop=None,
        on_failure=None,
        max_restarts: int = 0,
        restart_backoff_s: float = 0.5,
        graceful_stop_method: str | None = None,
        actor_options: dict | None = None,
    ) -> TrackedActor:
        """Track a new actor. Creation is asynchronous: the actor process
        starts once ``resource_request`` is ready (driven by ``next()``)."""
        if resource_request is None:
            resource_request = ResourceRequest([{"CPU": 1}])
        tracked = TrackedActor(
            cls,
            kwargs or {},
            resource_request=resource_request,
            bundle_index=bundle_index,
            kwargs_fn=kwargs_fn,
            on_start=on_start,
            on_stop=on_stop,
            on_failure=on_failure,
            max_restarts=max_restarts,
            restart_backoff_s=restart_backoff_s,
            graceful_stop_method=graceful_stop_method,
            actor_options=actor_options,
        )
        self._tracked.append(tracked)
        if id(resource_request) not in self._acquisitions:
            self.resource_manager.request_resources(resource_request)
        self._try_create(tracked)
        return tracked

    def remove_actor(self, tracked: TrackedActor, kill: bool = True) -> None:
        """Stop tracking: cancel in-flight tasks (no callbacks), kill the
        process, fire ``on_actor_stop``, release resources."""
        if tracked.state in (STOPPED, FAILED):
            return
        was_alive = tracked.state == ALIVE
        tracked.state = STOPPED
        self._cancel_inflight(tracked)
        tracked._queued_tasks.clear()
        if kill and tracked.actor_handle is not None:
            import ray_tpu_torch

            if tracked.graceful_stop_method:
                # Best-effort, fire-and-forget (matches the pre-manager Tune
                # behavior: stop.remote() immediately followed by kill).
                try:
                    getattr(tracked.actor_handle, tracked.graceful_stop_method).remote()
                except Exception:
                    pass
            try:
                ray_tpu_torch.kill(tracked.actor_handle)
            except Exception:
                pass
        tracked.actor_handle = None
        self._release_resources(tracked)
        self._forget(tracked)
        if was_alive and tracked.on_stop is not None:
            self._safe_callback(tracked.on_stop, tracked)

    def restart_actor(self, tracked: TrackedActor) -> None:
        """Consumer-initiated restart (e.g. retry an errored trial from a
        checkpoint): kill the current process, keep the acquisition, recreate
        immediately (no backoff) with freshly-resolved kwargs. Increments
        ``restart_count``, and that IS the counter the automatic restart
        budget checks — explicit and failure-driven restarts share one
        budget, so a consumer retrying app errors spends the same
        ``max_restarts`` allowance as process deaths (what Tune's
        ``max_failures`` semantics require)."""
        if not tracked.is_live:
            raise ValueError(f"cannot restart {tracked}: not live")
        self._cancel_inflight(tracked)
        if tracked.actor_handle is not None:
            import ray_tpu_torch

            try:
                ray_tpu_torch.kill(tracked.actor_handle)
            except Exception:
                pass
            tracked.actor_handle = None
        tracked.restart_count += 1
        tracked._restart_due = 0.0
        tracked.state = PENDING
        self._try_create(tracked)

    def clear(self) -> None:
        """Remove every tracked actor and release every acquisition."""
        for tracked in list(self._tracked):
            if tracked.is_live:
                self.remove_actor(tracked)
        self._tracked.clear()
        self._inflight.clear()
        self._acquisitions.clear()
        self.resource_manager.clear()

    def _forget(self, tracked: TrackedActor) -> None:
        """Stop scanning a terminally dead actor. The TrackedActor object
        stays valid for its holder; the manager just drops it so a long-lived
        controller (thousands of completed trials) doesn't accumulate dead
        entries in every _start_phase pass."""
        try:
            self._tracked.remove(tracked)
        except ValueError:
            pass

    # -- task scheduling ---------------------------------------------------

    def schedule_actor_task(
        self,
        tracked: TrackedActor,
        method: str,
        args: tuple = (),
        kwargs: dict | None = None,
        *,
        on_result: Optional[Callable[[Any], None]] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ) -> TrackedActorTask:
        """Schedule ``method`` on the tracked actor. If the actor is not up
        yet (or is restarting), the task is queued and submitted on start."""
        if not tracked.is_live:
            raise ValueError(f"cannot schedule task on {tracked}: not live")
        task = TrackedActorTask(tracked, method, args, dict(kwargs or {}), on_result, on_error)
        if tracked.state == ALIVE and tracked.actor_handle is not None:
            self._submit(task)
        else:
            tracked._queued_tasks.append(task)
        return task

    def _submit(self, task: TrackedActorTask) -> None:
        handle = task.tracked_actor.actor_handle
        ref = getattr(handle, task.method).remote(*task.args, **task.kwargs)
        task.ref = ref
        self._inflight[ref] = task

    def _cancel_inflight(self, tracked: TrackedActor) -> None:
        for ref, task in list(self._inflight.items()):
            if task.tracked_actor is tracked:
                del self._inflight[ref]

    # -- event loop --------------------------------------------------------

    def next(self, timeout: float | None = 5.0) -> bool:
        """Drive one batch of events: start ready/due actors, then wait up
        to ``timeout`` for a task future and dispatch callbacks. Returns
        True if any event (start, result, error, failure) was processed."""
        import ray_tpu_torch

        progressed = self._start_phase()

        refs = list(self._inflight.keys())
        if not refs:
            if not progressed and self._has_unstarted():
                # Nothing in flight and actors still coming up: yield briefly
                # instead of a hot spin in caller loops.
                time.sleep(min(0.05, timeout or 0.05))
                progressed = self._start_phase() or progressed
            return progressed
        ready, _ = ray_tpu_torch.wait(
            refs, num_returns=1, timeout=0 if progressed else timeout
        )
        # Grab every already-finished future in one sweep (cheap second wait).
        if ready:
            more, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
            ready = more or ready
        for ref in ready:
            task = self._inflight.pop(ref, None)
            if task is None:
                continue  # cancelled while we were waiting
            tracked = task.tracked_actor
            try:
                value = ray_tpu_torch.get(ref)
            except Exception as e:  # noqa: BLE001 — classified below
                if _is_actor_failure(e):
                    self._handle_actor_failure(tracked, e)
                elif task.on_error is not None:
                    self._safe_callback(task.on_error, e)
                progressed = True
                continue
            if task.on_result is not None:
                self._safe_callback(task.on_result, value)
            progressed = True
        return progressed

    def wait_for_actors(
        self, actors: list[TrackedActor], timeout: float = 300.0
    ) -> None:
        """Block until every listed actor is ALIVE. Raises TimeoutError on
        timeout and RuntimeError if one terminally fails while waiting."""
        deadline = time.monotonic() + timeout
        while True:
            if all(t.state == ALIVE for t in actors):
                return
            dead = [t for t in actors if t.state in (FAILED, STOPPED)]
            if dead:
                raise RuntimeError(f"actor(s) failed during start: {dead}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"actors not up after {timeout}s: "
                    f"{[t for t in actors if t.state != ALIVE]}"
                )
            self.next(timeout=0.5)

    # -- internals ---------------------------------------------------------

    def _has_unstarted(self) -> bool:
        return any(t.state in (PENDING, STARTING, RESTARTING) for t in self._tracked)

    def _start_phase(self) -> bool:
        progressed = False
        now = time.monotonic()
        for tracked in list(self._tracked):
            if tracked.state == RESTARTING and now >= tracked._restart_due:
                tracked.state = PENDING
            if tracked.state == PENDING:
                progressed = self._try_create(tracked) or progressed
            if tracked.state == STARTING:
                progressed = self._poll_starting(tracked) or progressed
        # Periodic liveness poll for idle ALIVE actors: an actor with no
        # in-flight task has no error channel, so its death would otherwise
        # go unnoticed until the next task.
        if now - self._last_state_poll >= 0.5:
            self._last_state_poll = now
            busy = {t.tracked_actor for t in self._inflight.values()}
            for tracked in list(self._tracked):
                if tracked.state == ALIVE and tracked not in busy:
                    progressed = self._poll_alive(tracked) or progressed
        return progressed

    def _acquire_for(self, tracked: TrackedActor) -> AcquiredResources | None:
        key = id(tracked.resource_request)
        entry = self._acquisitions.get(key)
        if entry is not None:
            entry[1].add(tracked)
            return entry[0]
        if not self.resource_manager.has_resources_ready(tracked.resource_request):
            return None
        acq = self.resource_manager.acquire_resources(tracked.resource_request)
        if acq is None:
            return None
        self._acquisitions[key] = [acq, {tracked}]
        return acq

    def _release_resources(self, tracked: TrackedActor) -> None:
        key = id(tracked.resource_request)
        entry = self._acquisitions.get(key)
        if entry is None:
            # Never acquired: drop the outstanding request (refcount it too —
            # a gang shares one request, cancel only when no live user left).
            if not any(
                t.is_live and id(t.resource_request) == key for t in self._tracked
            ):
                self.resource_manager.cancel_resource_request(tracked.resource_request)
            return
        acq, users = entry
        users.discard(tracked)
        if not users:
            del self._acquisitions[key]
            self.resource_manager.free_resources(acq)

    def _try_create(self, tracked: TrackedActor) -> bool:
        acq = self._acquire_for(tracked)
        if acq is None:
            return False
        from ray_tpu_torch.actor import ActorClass

        cls = tracked._cls
        if not isinstance(cls, ActorClass):
            import ray_tpu_torch

            cls = ray_tpu_torch.remote(cls)
        opts = acq.actor_options(tracked.bundle_index)
        opts.update(tracked.actor_options)
        # GCS-level restart stays OFF: restarts are manager-tracked so
        # callbacks fire and constructor kwargs re-resolve (a GCS restart
        # would silently hand back a fresh instance with stale state).
        opts["max_restarts"] = 0
        try:
            tracked.actor_handle = cls.options(**opts).remote(
                **tracked._constructor_kwargs()
            )
            tracked.actor_id = tracked.actor_handle.actor_id
            tracked.state = STARTING
        except Exception as e:  # noqa: BLE001 — creation failure is actor failure
            self._handle_actor_failure(tracked, e)
        return True

    def _actor_state(self, tracked: TrackedActor) -> dict | None:
        from ray_tpu_torch._private import worker_context

        try:
            cw = worker_context.get_core_worker()
            resp = cw.gcs.call("get_actor", {"actor_id": tracked.actor_id})
        except Exception:
            return None
        if not resp.get("found"):
            return None
        return resp["info"]

    def _poll_starting(self, tracked: TrackedActor) -> bool:
        info = self._actor_state(tracked)
        if info is None:
            return False
        state = info.get("state")
        if state == "ALIVE":
            tracked.state = ALIVE
            queued, tracked._queued_tasks = tracked._queued_tasks, []
            if tracked.on_start is not None:
                self._safe_callback(tracked.on_start, tracked)
            # on_start may have scheduled tasks or removed the actor; only
            # flush the pre-start queue if the actor is still alive.
            if tracked.state == ALIVE:
                for task in queued:
                    self._submit(task)
            return True
        if state == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError

            self._handle_actor_failure(
                tracked,
                ActorDiedError(
                    f"actor died during start: {info.get('death_cause') or 'unknown'}",
                ),
            )
            return True
        return False

    def _poll_alive(self, tracked: TrackedActor) -> bool:
        info = self._actor_state(tracked)
        if info is None:
            return False
        if info.get("state") == "DEAD":
            from ray_tpu_torch.exceptions import ActorDiedError

            self._handle_actor_failure(
                tracked,
                ActorDiedError(
                    f"actor process died: {info.get('death_cause') or 'unknown'}",
                ),
            )
            return True
        return False

    def _handle_actor_failure(self, tracked: TrackedActor, error: BaseException) -> None:
        if tracked.state in (STOPPED, FAILED):
            return
        tracked.last_error = error
        self._cancel_inflight(tracked)
        tracked.actor_handle = None
        will_restart = (
            tracked.max_restarts < 0 or tracked.restart_count < tracked.max_restarts
        )
        if will_restart:
            tracked.restart_count += 1
            tracked.state = RESTARTING
            tracked._restart_due = time.monotonic() + tracked.restart_backoff_s * (
                2 ** max(0, tracked.restart_count - 1)
            )
            logger.warning(
                "tracked actor #%d failed (%s); restart %d scheduled in %.1fs",
                tracked.tracked_id,
                error,
                tracked.restart_count,
                tracked._restart_due - time.monotonic(),
            )
        else:
            tracked.state = FAILED
            self._release_resources(tracked)
            self._forget(tracked)
        if tracked.on_failure is not None:
            self._safe_callback(tracked.on_failure, tracked, error, will_restart)

    @staticmethod
    def _safe_callback(cb, *args) -> None:
        try:
            cb(*args)
        except Exception:
            logger.exception("actor manager callback %r raised", cb)
