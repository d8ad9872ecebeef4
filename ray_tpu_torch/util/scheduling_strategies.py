"""Scheduling strategies (analog of python/ray/util/scheduling_strategies.py:15,41)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = 0

    def to_options(self) -> dict:
        return {
            "placement_group_id": self.placement_group.id.hex(),
            "placement_group_bundle_index": self.placement_group_bundle_index,
        }


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def to_options(self) -> dict:
        suffix = ":soft" if self.soft else ""
        return {"scheduling_strategy": f"node:{self.node_id}{suffix}"}


SPREAD = "SPREAD"
DEFAULT = "DEFAULT"
