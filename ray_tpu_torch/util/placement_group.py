"""Placement groups — atomic gang reservation of resource bundles.

Analog of the reference's placement group API (python/ray/util/placement_group.py:34,139)
backed by the GCS 2PC scheduler (gcs_placement_group_scheduler.h) and raylet
bundle accounting (placement_group_resource_manager.h).

STRICT_PACK maps all bundles onto a single node: a GPU gang placed in a
STRICT_PACK group shares one host (and its NVLink).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ray_tpu_torch._private.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: list
    strategy: str

    def ready(self, timeout: float | None = None):
        """Block until all bundles are reserved (analog of pg.ready())."""
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        deadline = time.monotonic() + (timeout if timeout is not None else 3600.0)
        while time.monotonic() < deadline:
            resp = cw.gcs.call("get_placement_group", {"pg_id": self.id.hex()})
            if resp.get("found") and resp["info"]["state"] == "CREATED":
                return True
            time.sleep(0.05)
        from ray_tpu_torch.exceptions import PlacementGroupUnavailableError

        raise PlacementGroupUnavailableError(f"placement group {self.id.hex()[:8]} not ready")

    def bundle_node(self, bundle_index: int) -> str | None:
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        resp = cw.gcs.call("get_placement_group", {"pg_id": self.id.hex()})
        if not resp.get("found"):
            return None
        return resp["info"]["bundle_nodes"][bundle_index]


def placement_group(bundles: list[dict], strategy: str = "PACK", name: str = "") -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    pg_id = PlacementGroupID.from_random()
    cw.gcs.call(
        "create_placement_group",
        {
            "pg_id": pg_id.hex(),
            "bundles": bundles,
            "strategy": strategy,
            "name": name,
        },
    )
    return PlacementGroup(id=pg_id, bundles=bundles, strategy=strategy)


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    cw.gcs.call("remove_placement_group", {"pg_id": pg.id.hex()})
