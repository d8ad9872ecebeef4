"""Lazy logical plan for ray_tpu_torch.data.

Analog of the reference's logical operators + planner
(python/ray/data/_internal/logical/, _internal/planner/): a Dataset holds a
chain of LogicalOp nodes; at execution time consecutive one-to-one transforms
are fused into single tasks (the reference's OperatorFusionRule) and the chain
is lowered to physical operators for the streaming executor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class LogicalOp:
    name: str
    input_op: Optional["LogicalOp"]


@dataclasses.dataclass
class InputData(LogicalOp):
    """Already-materialized (ref, metadata) bundles."""

    bundles: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Read(LogicalOp):
    read_tasks: list = dataclasses.field(default_factory=list)  # list[ReadTask]
    ray_remote_args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MapTransform(LogicalOp):
    """One-to-one block transform: fn(Block) -> Block. Covers map_batches,
    map, flat_map, filter, select/drop/rename — all fusable."""

    block_fn: Callable = None  # type: ignore[assignment]
    compute: Any = None  # None (tasks) or ActorPoolStrategy
    ray_remote_args: dict = dataclasses.field(default_factory=dict)
    fn_constructor: Optional[Callable] = None  # for callable-class UDFs on actors


@dataclasses.dataclass
class AllToAll(LogicalOp):
    """Barrier op: fn(list[(ref, meta)], ctx) -> list[(ref, meta)]."""

    bulk_fn: Callable = None  # type: ignore[assignment]
    num_outputs: Optional[int] = None


@dataclasses.dataclass
class Limit(LogicalOp):
    limit: int = 0


@dataclasses.dataclass
class Union(LogicalOp):
    extra_inputs: list = dataclasses.field(default_factory=list)  # list[LogicalOp]


@dataclasses.dataclass
class Zip(LogicalOp):
    other: LogicalOp = None  # type: ignore[assignment]


def fuse_map_chain(op: LogicalOp) -> LogicalOp:
    """Fuse consecutive MapTransform nodes (same compute strategy) into one.

    Reference: _internal/logical/rules/operator_fusion.py — avoids
    materializing intermediate blocks between e.g. read->map->filter.
    """
    if op is None:
        return None
    inp = fuse_map_chain(op.input_op) if op.input_op is not None else None

    if isinstance(op, Union):
        op = dataclasses.replace(op, extra_inputs=[fuse_map_chain(e) for e in op.extra_inputs])
    if isinstance(op, Zip):
        op = dataclasses.replace(op, other=fuse_map_chain(op.other))

    if (
        isinstance(op, MapTransform)
        and isinstance(inp, MapTransform)
        and op.compute is None
        and inp.compute is None
        and op.fn_constructor is None
        and inp.fn_constructor is None
    ):
        f, g = inp.block_fn, op.block_fn

        def fused(block, _f=f, _g=g):
            return _g(_f(block))

        return MapTransform(
            name=f"{inp.name}->{op.name}",
            input_op=inp.input_op,
            block_fn=fused,
            ray_remote_args={**inp.ray_remote_args, **op.ray_remote_args},
        )
    return dataclasses.replace(op, input_op=inp) if op.input_op is not inp else op


def plan_to_chain(op: LogicalOp) -> list:
    """Linearize the (mostly linear) plan into an executor chain."""
    chain: list = []
    cur = op
    while cur is not None:
        chain.append(cur)
        cur = cur.input_op
    chain.reverse()
    return chain
