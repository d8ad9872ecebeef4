"""Resource acquisition for the AIR execution layer.

Analog of the reference's ``python/ray/air/execution/resources/`` —
``ResourceRequest`` describes what an execution unit needs (one or more
bundles plus a placement strategy), a ``ResourceManager`` turns requests into
``AcquiredResources`` that annotate actors with the right scheduling options,
and — the robustness point of this layer — guarantees release: every
acquisition is tracked until freed, ``clear()`` force-releases everything,
and the placement-group manager removes its PGs even when an actor died
mid-start or mid-task (the pre-existing Train restart path leaked one PG per
gang restart precisely because release lived in consumer code).

Two implementations:

- ``FixedResourceManager`` — plain-resource bookkeeping against a fixed
  budget (defaults to the cluster totals). Acquired bundles translate to
  per-actor ``num_cpus``/``num_gpus``/``resources`` options; the raylet
  enforces them, the manager only tracks the budget so callers can gate
  how much work they launch.
- ``PlacementGroupResourceManager`` — each request is backed by a placement
  group (gang reservation; STRICT_PACK = one node for GPU gangs).
  Bundles map to ``PlacementGroupSchedulingStrategy(pg, bundle_index)``.

Requests are compared by IDENTITY, not value: two equal-looking requests are
two reservations. A multi-bundle request is acquired and released as a unit
(gang semantics), which is what lets the ActorManager refcount one placement
group across a whole worker gang.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass(eq=False)
class ResourceRequest:
    """What one execution unit (trial actor, worker gang) needs.

    ``bundles`` is a list of resource dicts — one per actor that will be
    scheduled against this request. ``strategy`` only matters for
    placement-group-backed managers.
    """

    bundles: list[dict]
    strategy: str = "PACK"

    def __post_init__(self):
        if not self.bundles or any(not isinstance(b, dict) or not b for b in self.bundles):
            raise ValueError("ResourceRequest needs non-empty resource-dict bundles")
        self.bundles = [dict(b) for b in self.bundles]

    @property
    def required_resources(self) -> dict:
        total: dict[str, float] = {}
        for b in self.bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0) + v
        return total

    def __repr__(self):
        return f"ResourceRequest({self.bundles}, strategy={self.strategy!r})"


@dataclass(eq=False)
class AcquiredResources:
    """A satisfied request. ``actor_options(i)`` yields the ``.options()``
    dict that pins an actor to bundle ``i`` of this acquisition."""

    request: ResourceRequest
    placement_group: object | None = None
    _freed: bool = field(default=False, repr=False)

    def actor_options(self, bundle_index: int = 0) -> dict:
        if not 0 <= bundle_index < len(self.request.bundles):
            raise IndexError(
                f"bundle_index {bundle_index} out of range for "
                f"{len(self.request.bundles)} bundles"
            )
        bundle = dict(self.request.bundles[bundle_index])
        opts: dict = {}
        if self.placement_group is not None:
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy,
            )

            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                self.placement_group, bundle_index
            )
            # The PG bundle already reserved the resources; the actor still
            # declares them so the raylet accounts its usage inside the bundle.
        ncpu = bundle.pop("CPU", None)
        ngpu = bundle.pop("GPU", None)
        if ncpu:
            opts["num_cpus"] = ncpu
        if ngpu:
            opts["num_gpus"] = ngpu
        if bundle:
            opts["resources"] = bundle
        return opts


class ResourceManager:
    """Base interface. Lifecycle of one request:

    ``request_resources(req)`` (idempotent) -> poll ``has_resources_ready``
    -> ``acquire_resources(req) -> AcquiredResources`` -> eventually
    ``free_resources(acquired)``. ``cancel_resource_request`` abandons a
    request that was never acquired. ``clear()`` releases everything this
    manager handed out or still has pending — the guaranteed-release hook
    consumers call from their own teardown paths.
    """

    def request_resources(self, request: ResourceRequest) -> None:
        raise NotImplementedError

    def cancel_resource_request(self, request: ResourceRequest) -> None:
        raise NotImplementedError

    def has_resources_ready(self, request: ResourceRequest) -> bool:
        raise NotImplementedError

    def acquire_resources(self, request: ResourceRequest) -> AcquiredResources | None:
        raise NotImplementedError

    def free_resources(self, acquired: AcquiredResources) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class FixedResourceManager(ResourceManager):
    """Budget bookkeeping over plain resources (no gang atomicity).

    The budget defaults to the cluster totals at first use. Acquisition
    subtracts the request's total; release adds it back. Used where trial
    actors request ordinary resources and the raylet does the real
    enforcement — the manager's job is leak-proof accounting so a failed
    actor always returns its slice of the budget.
    """

    def __init__(self, total_resources: dict | None = None):
        self._lock = threading.RLock()
        self._total = dict(total_resources) if total_resources else None
        self._used: dict[str, float] = {}
        self._pending: list[ResourceRequest] = []
        self._acquired: list[AcquiredResources] = []

    def _budget(self) -> dict:
        if self._total is None:
            import ray_tpu_torch

            try:
                self._total = dict(ray_tpu_torch.cluster_resources())
            except Exception:
                self._total = {}
        return self._total

    def request_resources(self, request: ResourceRequest) -> None:
        with self._lock:
            if request not in self._pending:
                self._pending.append(request)

    def cancel_resource_request(self, request: ResourceRequest) -> None:
        with self._lock:
            if request in self._pending:
                self._pending.remove(request)

    def has_resources_ready(self, request: ResourceRequest) -> bool:
        with self._lock:
            budget = self._budget()
            for k, v in request.required_resources.items():
                # Unknown resource kinds are treated as available: on a
                # growing cluster (autoscaler) the raylet is authoritative.
                if k in budget and self._used.get(k, 0) + v > budget[k]:
                    return False
            return True

    def acquire_resources(self, request: ResourceRequest) -> AcquiredResources | None:
        with self._lock:
            if not self.has_resources_ready(request):
                return None
            for k, v in request.required_resources.items():
                self._used[k] = self._used.get(k, 0) + v
            if request in self._pending:
                self._pending.remove(request)
            acq = AcquiredResources(request=request)
            self._acquired.append(acq)
            return acq

    def free_resources(self, acquired: AcquiredResources) -> None:
        with self._lock:
            if acquired._freed:
                return
            acquired._freed = True
            if acquired in self._acquired:
                self._acquired.remove(acquired)
            for k, v in acquired.request.required_resources.items():
                self._used[k] = max(0.0, self._used.get(k, 0) - v)

    def clear(self) -> None:
        with self._lock:
            for acq in list(self._acquired):
                self.free_resources(acq)
            self._pending.clear()
            self._used.clear()


class PlacementGroupResourceManager(ResourceManager):
    """Placement-group-backed acquisition: every request creates a PG with
    the request's bundles/strategy; readiness is the GCS-reported CREATED
    state (non-blocking poll); freeing removes the PG. Every PG this manager
    ever created is tracked until removed, so ``clear()`` (and consumer
    teardown paths that call it) cannot leave a bundle reserved — the leak
    audit in GlobalState.placement_groups() comes back empty.
    """

    def __init__(self):
        self._lock = threading.RLock()
        # id(request) -> (request, PlacementGroup). The request rides in the
        # value so it stays referenced while pending — an id() key alone
        # could be recycled by the allocator after the request is collected.
        self._pending: dict[int, tuple] = {}
        self._acquired: list[AcquiredResources] = []

    @staticmethod
    def _pg_state(pg) -> str:
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        resp = cw.gcs.call("get_placement_group", {"pg_id": pg.id.hex()})
        if not resp.get("found"):
            return "REMOVED"
        return resp["info"]["state"]

    def request_resources(self, request: ResourceRequest) -> None:
        from ray_tpu_torch.util.placement_group import placement_group

        with self._lock:
            if id(request) in self._pending:
                return
            pg = placement_group(
                [dict(b) for b in request.bundles], strategy=request.strategy
            )
            self._pending[id(request)] = (request, pg)

    def cancel_resource_request(self, request: ResourceRequest) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group

        with self._lock:
            entry = self._pending.pop(id(request), None)
        if entry is not None:
            pg = entry[1]
            try:
                remove_placement_group(pg)
            except Exception:
                logger.warning("failed to remove cancelled PG %s", pg.id.hex()[:8])

    def has_resources_ready(self, request: ResourceRequest) -> bool:
        with self._lock:
            entry = self._pending.get(id(request))
        if entry is None:
            return False
        return self._pg_state(entry[1]) == "CREATED"

    def acquire_resources(self, request: ResourceRequest) -> AcquiredResources | None:
        with self._lock:
            entry = self._pending.get(id(request))
            if entry is None or self._pg_state(entry[1]) != "CREATED":
                return None
            self._pending.pop(id(request))
            acq = AcquiredResources(request=request, placement_group=entry[1])
            self._acquired.append(acq)
            return acq

    def free_resources(self, acquired: AcquiredResources) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group

        with self._lock:
            if acquired._freed:
                return
            acquired._freed = True
            if acquired in self._acquired:
                self._acquired.remove(acquired)
        if acquired.placement_group is not None:
            try:
                remove_placement_group(acquired.placement_group)
            except Exception:
                logger.warning(
                    "failed to remove PG %s on free; it may leak bundles",
                    acquired.placement_group.id.hex()[:8],
                )

    def clear(self) -> None:
        with self._lock:
            pending = [pg for _req, pg in self._pending.values()]
            self._pending.clear()
            acquired = list(self._acquired)
        from ray_tpu_torch.util.placement_group import remove_placement_group

        for pg in pending:
            try:
                remove_placement_group(pg)
            except Exception:
                pass
        for acq in acquired:
            self.free_resources(acq)
