"""Streaming executor for ray_tpu_torch.data.

Analog of the reference's StreamingExecutor
(python/ray/data/_internal/execution/streaming_executor.py:48 and
operators/{task_pool,actor_pool}_map_operator.py): the logical chain is
lowered to physical operators; map stages run as ray_tpu_torch tasks (or an actor
pool) over block refs with bounded in-flight concurrency, and completed output
bundles stream to the consumer in block order while upstream work continues.
Barrier ops (shuffle/sort/union/zip) materialize their input first, like the
reference's AllToAllOperator.

A "bundle" is ``(block_ref, BlockMetadata)`` — the metadata travels eagerly on
the driver while the block stays in the object store (reference: RefBundle).
"""

from __future__ import annotations

import collections
from typing import Iterator, Optional

import ray_tpu_torch
from ray_tpu_torch.data._internal.logical_plan import (
    AllToAll,
    InputData,
    Limit,
    MapTransform,
    Read,
    Union,
    Zip,
    fuse_map_chain,
    plan_to_chain,
)
from ray_tpu_torch.data.block import BlockAccessor


def _run_read_task(read_task):
    """Execute a ReadTask: returns (block, metadata)."""
    blocks = list(read_task())
    block = BlockAccessor.concat([BlockAccessor.batch_to_block(b) for b in blocks])
    acc = BlockAccessor.for_block(block)
    return block, acc.get_metadata()


def _run_map_task(fn, block):
    out = fn(block)
    out = BlockAccessor.batch_to_block(out)
    return out, BlockAccessor.for_block(out).get_metadata()


def _slice_block_task(block, start, end):
    out = BlockAccessor.for_block(block).slice(start, end)
    return out, BlockAccessor.for_block(out).get_metadata()


def _zip_blocks_task(left, right):
    la, ra = BlockAccessor.for_block(left), BlockAccessor.for_block(right)
    if la.num_rows() != ra.num_rows():
        raise ValueError(f"zip row mismatch: {la.num_rows()} vs {ra.num_rows()}")
    out = dict(left)
    for name, col in right.items():
        out[name if name not in left else name + "_1"] = col
    return out, BlockAccessor.for_block(out).get_metadata()


class _MapWorker:
    """Actor-pool map worker (reference: ActorPoolMapOperator._MapWorker)."""

    def __init__(self, fn_constructor=None):
        self._udf = fn_constructor() if fn_constructor is not None else None

    def ready(self):
        return True

    def map_block(self, fn, block):
        if self._udf is not None:
            out = fn(block, self._udf)
        else:
            out = fn(block)
        out = BlockAccessor.batch_to_block(out)
        return out, BlockAccessor.for_block(out).get_metadata()


class ActorPoolStrategy:
    """Compute strategy selecting an autoscaling actor pool
    (reference: data/_internal/compute.py ActorPoolStrategy). ``num_gpus``
    (a fraction allowed) is each actor's share of the runtime's "GPU"
    resource, in place of the JAX package's ``num_tpus``."""

    def __init__(self, size: Optional[int] = None, min_size: int = 1, max_size: Optional[int] = None, num_gpus: float = 0, num_cpus: float = 1):
        if size is not None:
            min_size = max_size = size
        self.min_size = min_size
        self.max_size = max_size or max(min_size, 2)
        self.num_gpus = num_gpus
        self.num_cpus = num_cpus


class ExecutionContext:
    def __init__(
        self,
        max_tasks_in_flight: Optional[int] = None,
        preserve_order: bool = True,
        per_op_budget_blocks: Optional[int] = None,
    ):
        if max_tasks_in_flight is None:
            try:
                max_tasks_in_flight = max(2, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))
            except Exception:
                max_tasks_in_flight = 4
        self.max_tasks_in_flight = max_tasks_in_flight
        self.preserve_order = preserve_order
        # Per-op output budget (reference: streaming_executor_state.py
        # under_output_budget / select_operator_to_run): an op may not run
        # further ahead than this many unconsumed downstream blocks, so a
        # fast upstream can't materialize the whole dataset in the object
        # store while a slow downstream lags.
        self.per_op_budget_blocks = per_op_budget_blocks or 2 * max_tasks_in_flight
        # Observability for tests/stats: high-water marks per run.
        self.stats = {"max_inter_op_queued": 0, "max_inflight": 0}
        # Per-op execution stats (reference: DatasetStats, stats.py:117).
        from ray_tpu_torch.data._internal.stats import DatasetStats

        self.dataset_stats = DatasetStats()


class _PhysicalMapOp:
    """Task-pool (or actor-pool) map stage with bounded in-flight tasks."""

    def __init__(self, logical: MapTransform, ctx: ExecutionContext):
        from ray_tpu_torch.data._internal.stats import OpStats

        self.logical = logical
        self.ctx = ctx
        self.op_stats = OpStats(name=logical.name)
        ctx.dataset_stats.op_stats.append(self.op_stats)
        self.input: collections.deque = collections.deque()
        self.in_flight: dict = {}  # watch_ref -> (index, meta_ref_pair)
        self.output: dict = {}  # index -> bundle
        self.upstream_done = False
        self._pool: list = []
        self._pool_idx = 0
        self._actor_cls = None
        if isinstance(logical.compute, ActorPoolStrategy):
            strat = logical.compute
            self._actor_cls = ray_tpu_torch.remote(
                num_cpus=strat.num_cpus, num_gpus=strat.num_gpus or None
            )(_MapWorker)
            self._pool = [
                self._actor_cls.remote(logical.fn_constructor) for _ in range(strat.min_size)
            ]

    @property
    def capacity(self) -> int:
        if self._pool:
            return max(0, 2 * len(self._pool) - len(self.in_flight))
        return max(0, self.ctx.max_tasks_in_flight - len(self.in_flight))

    def dispatch(self, limit: Optional[int] = None):
        if self._pool and self.input:
            # Autoscale the pool toward max_size while a backlog exists
            # (reference: ActorPoolMapOperator's autoscaling actor pool).
            strat = self.logical.compute
            backlog = max(0, len(self.input) - self.capacity)
            grow = min(backlog, strat.max_size - len(self._pool))
            for _ in range(grow):
                self._pool.append(self._actor_cls.remote(self.logical.fn_constructor))
        n = 0
        while self.input and self.capacity > 0 and (limit is None or n < limit):
            index, (block_ref, _meta) = self.input.popleft()
            if self._pool:
                actor = self._pool[self._pool_idx % len(self._pool)]
                self._pool_idx += 1
                refs = actor.map_block.options(num_returns=2).remote(
                    self.logical.block_fn, block_ref
                )
            else:
                remote_args = dict(self.logical.ray_remote_args)
                refs = (
                    ray_tpu_torch.remote(num_returns=2, **remote_args)(_run_map_task)
                    .remote(self.logical.block_fn, block_ref)
                )
            self.in_flight[refs[1]] = (index, refs)
            self.op_stats.mark_start()
            self.op_stats.num_tasks += 1
            n += 1

    def complete(self, watch_ref):
        index, refs = self.in_flight.pop(watch_ref)
        meta = ray_tpu_torch.get(refs[1])
        self.op_stats.record_output(meta)
        self.output[index] = (refs[0], meta)

    @property
    def done(self) -> bool:
        return self.upstream_done and not self.input and not self.in_flight

    def shutdown(self):
        """Kill the pool's actors, which frees what their constructors were
        sent: until then a pool holds its actors' CPUs and GPUs."""
        pool, self._pool = self._pool, []
        if pool and ray_tpu_torch.is_initialized():
            for actor in pool:
                ray_tpu_torch.kill(actor)


class _PhysicalReadOp:
    def __init__(self, logical: Read, ctx: ExecutionContext):
        from ray_tpu_torch.data._internal.stats import OpStats

        self.logical = logical
        self.ctx = ctx
        self.op_stats = OpStats(name=logical.name)
        ctx.dataset_stats.op_stats.append(self.op_stats)
        self.input = collections.deque(enumerate(logical.read_tasks))
        self.in_flight: dict = {}
        self.output: dict = {}
        self.upstream_done = True

    @property
    def capacity(self) -> int:
        return max(0, self.ctx.max_tasks_in_flight - len(self.in_flight))

    def dispatch(self, limit: Optional[int] = None):
        n = 0
        while self.input and self.capacity > 0 and (limit is None or n < limit):
            index, read_task = self.input.popleft()
            refs = (
                ray_tpu_torch.remote(num_returns=2, **dict(self.logical.ray_remote_args))(_run_read_task)
                .remote(read_task)
            )
            self.in_flight[refs[1]] = (index, refs)
            self.op_stats.mark_start()
            self.op_stats.num_tasks += 1
            n += 1

    def complete(self, watch_ref):
        index, refs = self.in_flight.pop(watch_ref)
        meta = ray_tpu_torch.get(refs[1])
        self.op_stats.record_output(meta)
        self.output[index] = (refs[0], meta)

    @property
    def done(self) -> bool:
        return not self.input and not self.in_flight


def execute_streaming(plan, ctx: Optional[ExecutionContext] = None) -> Iterator[tuple]:
    """Execute the plan, yielding output bundles in block order as they
    complete. The scheduling loop keeps all map stages saturated
    (reference: streaming_executor_state.py:363 select_operator_to_run)."""
    ctx = ctx or ExecutionContext()
    plan = fuse_map_chain(plan)
    chain = plan_to_chain(plan)

    # Materialize any barrier prefix: everything up to the last non-streaming
    # op runs first; the streaming suffix (reads + maps + limit) pipelines.
    bundles: list = []
    stream_ops: list = []
    i = 0
    while i < len(chain):
        op = chain[i]
        if isinstance(op, InputData):
            bundles = list(op.bundles)
        elif isinstance(op, Read):
            stream_ops.append(_PhysicalReadOp(op, ctx))
        elif isinstance(op, MapTransform):
            stream_ops.append(_PhysicalMapOp(op, ctx))
        elif isinstance(op, (AllToAll, Union, Zip, Limit)):
            # Barrier: drain current streaming suffix into bundles first.
            bundles = _drain(bundles, stream_ops, ctx)
            stream_ops = []
            from ray_tpu_torch.data._internal.stats import OpStats

            op_stats = OpStats(name=op.name)
            ctx.dataset_stats.op_stats.append(op_stats)
            op_stats.mark_start()
            if isinstance(op, AllToAll):
                bundles = op.bulk_fn(bundles)
            elif isinstance(op, Union):
                for extra in op.extra_inputs:
                    bundles = bundles + list(execute_streaming(extra, ctx))
            elif isinstance(op, Zip):
                other = list(execute_streaming(op.other, ctx))
                bundles = _zip_bundles(bundles, other)
            elif isinstance(op, Limit):
                bundles = _apply_limit(bundles, op.limit)
            for _, meta in bundles:
                op_stats.record_output(meta)
        else:
            raise TypeError(f"unknown logical op {op}")
        i += 1

    if not stream_ops:
        yield from bundles
        return
    yield from _pump(bundles, stream_ops, ctx)


def _pump(seed_bundles, ops, ctx) -> Iterator[tuple]:
    """Core scheduling loop over a chain of streaming ops (reference:
    streaming_executor_state.py:363 select_operator_to_run).

    Backpressure: forwarding into a downstream op's input queue and each
    op's dispatch are both gated on ctx.per_op_budget_blocks of unconsumed
    downstream work, and dispatch allowances are granted downstream-first —
    so a fast producer ahead of a slow consumer parks at the budget instead
    of materializing every intermediate block in the object store at once.
    """
    if ops and isinstance(ops[0], _PhysicalMapOp):
        for idx, b in enumerate(seed_bundles):
            ops[0].input.append((idx, b))
        ops[0].upstream_done = True
    next_fwd = [0] * len(ops)  # next output index each op hands downstream
    final = ops[-1]
    budget = max(2, ctx.per_op_budget_blocks)

    def forward():
        for k, op in enumerate(ops[:-1]):
            nxt = ops[k + 1]
            while next_fwd[k] in op.output and len(nxt.input) < budget:
                nxt.input.append((next_fwd[k], op.output.pop(next_fwd[k])))
                next_fwd[k] += 1
            if op.done and not op.output:
                nxt.upstream_done = True
            ctx.stats["max_inter_op_queued"] = max(
                ctx.stats["max_inter_op_queued"], len(nxt.input)
            )

    def select_and_dispatch():
        # Downstream ops first: draining them frees budget for upstream.
        for k in range(len(ops) - 1, -1, -1):
            op = ops[k]
            # Unconsumed work this op is responsible for: its buffered
            # outputs, its in-flight tasks, and what it already handed the
            # next op but that op hasn't consumed. For the final op the
            # buffered output IS op.output — counting it again would halve
            # its effective budget.
            downstream_q = len(ops[k + 1].input) if k + 1 < len(ops) else 0
            pressure = len(op.output) + len(op.in_flight) + downstream_q
            allowance = budget - pressure
            if allowance > 0:
                op.dispatch(limit=allowance)
            ctx.stats["max_inflight"] = max(ctx.stats["max_inflight"], len(op.in_flight))

    try:
        while True:
            forward()
            select_and_dispatch()
            while next_fwd[-1] in final.output:
                yield final.output.pop(next_fwd[-1])
                next_fwd[-1] += 1
            if all(op.done for op in ops) and not final.output:
                return
            watch = [r for op in ops for r in op.in_flight]
            if not watch:
                # No tasks in flight but not done: forwarding must unblock us.
                continue
            ready, _ = ray_tpu_torch.wait(watch, num_returns=1, timeout=30.0, fetch_local=False)
            for r in ready:
                for op in ops:
                    if r in op.in_flight:
                        op.complete(r)
                        break
    finally:
        # Unlike the JAX package's executor, release each actor pool when
        # its stage ends (or the consumer stops early): ROADMAP C9.
        for op in ops:
            if isinstance(op, _PhysicalMapOp):
                op.shutdown()


def _drain(seed_bundles, ops, ctx) -> list:
    if not ops:
        return list(seed_bundles)
    return list(_pump(seed_bundles, ops, ctx))


def _apply_limit(bundles, limit) -> list:
    out, count = [], 0
    for ref, meta in bundles:
        if count >= limit:
            break
        if count + meta.num_rows <= limit:
            out.append((ref, meta))
            count += meta.num_rows
        else:
            take = limit - count
            refs = ray_tpu_torch.remote(num_returns=2)(_slice_block_task).remote(ref, 0, take)
            new_meta = ray_tpu_torch.get(refs[1])
            out.append((refs[0], new_meta))
            count = limit
    return out


def _zip_bundles(left, right) -> list:
    """Align row counts then zip pairwise. Requires equal total rows."""
    lrows = sum(m.num_rows for _, m in left)
    rrows = sum(m.num_rows for _, m in right)
    if lrows != rrows:
        raise ValueError(f"zip: datasets have different row counts ({lrows} vs {rrows})")
    lsplit = _resplit(left, [m.num_rows for _, m in left])
    rsplit = _resplit(right, [m.num_rows for _, m in left])
    out = []
    for (lref, _), (rref, _) in zip(lsplit, rsplit):
        refs = ray_tpu_torch.remote(num_returns=2)(_zip_blocks_task).remote(lref, rref)
        out.append((refs[0], ray_tpu_torch.get(refs[1])))
    return out


def _resplit(bundles, target_sizes) -> list:
    """Re-chunk bundles into blocks of the given row counts."""
    out = []
    cur = list(bundles)
    cur_off = 0
    for size in target_sizes:
        need = size
        parts = []
        while need > 0:
            ref, meta = cur[0]
            avail = meta.num_rows - cur_off
            take = min(avail, need)
            refs = ray_tpu_torch.remote(num_returns=2)(_slice_block_task).remote(ref, cur_off, cur_off + take)
            parts.append(refs[0])
            need -= take
            cur_off += take
            if cur_off >= meta.num_rows:
                cur.pop(0)
                cur_off = 0
        if len(parts) == 1:
            block_ref = parts[0]
        else:
            block_ref = ray_tpu_torch.remote(num_returns=1)(
                lambda *bs: BlockAccessor.concat(list(bs))
            ).remote(*parts)
        nrows = size
        from ray_tpu_torch.data.block import BlockMetadata

        out.append((block_ref, BlockMetadata(num_rows=nrows, size_bytes=0)))
    return out
