"""All-to-all operations: shuffle, repartition, sort, grouped aggregation.

Analog of the reference's pull-based sort-shuffle
(python/ray/data/_internal/{shuffle.py,push_based_shuffle.py,sort.py}): a map
stage splits every input block into ``num_outputs`` partitions (random, hash,
or range assignment) and a reduce stage concatenates partition *i* across all
maps. Map and reduce both run as ray_tpu_torch tasks; the reduce task receives its
input partitions as refs so blocks move peer-to-peer through the object store,
never through the driver.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, BlockMetadata


def _map_random(block, num_outputs, seed):
    return tuple(BlockAccessor.for_block(block).random_partition(num_outputs, seed))


def _map_hash(block, num_outputs, key):
    return tuple(BlockAccessor.for_block(block).hash_partition(key, num_outputs))


def _map_range(block, key, boundaries, descending):
    acc = BlockAccessor.for_block(block)
    parts = acc.range_partition(key, boundaries)
    if descending:
        parts = parts[::-1]
    return tuple(parts)


def _reduce_concat(shuffle_seed, *parts):
    out = BlockAccessor.concat(list(parts))
    if shuffle_seed is not None:
        out = BlockAccessor.for_block(out).random_shuffle(shuffle_seed)
    return out, BlockAccessor.for_block(out).get_metadata()


def _reduce_sorted(key, descending, *parts):
    out = BlockAccessor.concat(list(parts))
    out = BlockAccessor.for_block(out).sort(key, descending)
    return out, BlockAccessor.for_block(out).get_metadata()


def _map_single(block, map_fn, *args):
    """num_returns=1 wrapper: unwrap the 1-tuple the partition fns return."""
    return map_fn(block, *args)[0]


def _shuffle(bundles, map_fn, map_args, reduce_fn, reduce_args, num_outputs) -> list:
    if not bundles:
        return []
    if num_outputs == 1:
        map_tasks = [
            [ray_tpu_torch.remote(num_returns=1)(_map_single).remote(ref, map_fn, *map_args)]
            for ref, _ in bundles
        ]
    else:
        map_tasks = [
            ray_tpu_torch.remote(num_returns=num_outputs)(map_fn).remote(ref, *map_args)
            for ref, _ in bundles
        ]
    out = []
    for p in range(num_outputs):
        parts = [m[p] for m in map_tasks]
        refs = ray_tpu_torch.remote(num_returns=2)(reduce_fn).remote(*reduce_args, *parts)
        out.append(refs)
    return [(refs[0], ray_tpu_torch.get(refs[1])) for refs in out]


def _merge_parts(*parts):
    """Merge-stage combine (push-based shuffle): concat one round's shards
    of one output partition."""
    return BlockAccessor.concat(list(parts))


def push_based_shuffle(
    bundles,
    num_outputs: Optional[int] = None,
    seed: Optional[int] = None,
    merge_factor: Optional[int] = None,
) -> list:
    """Three-stage map -> merge -> reduce shuffle (reference:
    data/_internal/push_based_shuffle.py:1).

    The plain 2-stage shuffle gives every reducer fan-in = num_maps: at M
    map blocks each reducer concatenates M tiny shards, and the object
    store holds M*N intermediate objects at once. Here map outputs are
    combined by INTERMEDIATE merge tasks in rounds of ``merge_factor``
    (default ~sqrt(M)), so reducer fan-in drops to ceil(M/merge_factor)
    and merging pipelines with mapping — a merge round only depends on its
    own round's maps, so it starts while later rounds still run (our
    submitter-side dependency resolution provides the reference's
    pipelined scheduling for free)."""
    if not bundles:
        return []
    n = num_outputs or max(1, len(bundles))
    num_maps = len(bundles)
    factor = merge_factor or max(2, int(np.sqrt(num_maps)))
    if n == 1:
        map_tasks = [
            [ray_tpu_torch.remote(num_returns=1)(_map_single).remote(ref, _map_random, n, seed)]
            for ref, _ in bundles
        ]
    else:
        map_tasks = [
            ray_tpu_torch.remote(num_returns=n)(_map_random).remote(ref, n, seed)
            for ref, _ in bundles
        ]
    rounds = [map_tasks[i : i + factor] for i in range(0, num_maps, factor)]
    out = []
    sub = seed if seed is not None else None
    for p in range(n):
        merged = [
            ray_tpu_torch.remote(num_returns=1)(_merge_parts).remote(*[m[p] for m in rnd])
            for rnd in rounds
        ]
        refs = ray_tpu_torch.remote(num_returns=2)(_reduce_concat).remote(sub, *merged)
        out.append(refs)
    return [(refs[0], ray_tpu_torch.get(refs[1])) for refs in out]


def random_shuffle(bundles, num_outputs: Optional[int] = None, seed: Optional[int] = None) -> list:
    from ray_tpu_torch.data.context import DataContext

    n = num_outputs or max(1, len(bundles))
    sub = seed if seed is not None else None
    ctx = DataContext.get_current()
    # Default OFF, like the reference (RAY_DATA_PUSH_BASED_SHUFFLE): the
    # merge stage adds R*N tasks, which only pays for itself when reducer
    # fan-in would otherwise pressure the object store / network — i.e.
    # wide multi-node shuffles, not single-host runs (microbench tracks the
    # crossover as shuffle_{pull,push}_rows_per_s).
    if ctx.use_push_based_shuffle:
        return push_based_shuffle(bundles, num_outputs, seed)
    return _shuffle(bundles, _map_random, (n, seed), _reduce_concat, (sub,), n)


def repartition(bundles, num_outputs: int) -> list:
    """Even re-chunking without changing row order (reference: sort.py
    repartition path). Uses slice tasks rather than a full shuffle."""
    total = sum(m.num_rows for _, m in bundles)
    if total == 0 or not bundles:
        return bundles[:num_outputs] if bundles else []
    sizes = [total // num_outputs] * num_outputs
    for i in range(total % num_outputs):
        sizes[i] += 1
    sizes = [s for s in sizes if s > 0]
    from ray_tpu_torch.data._internal.executor import _resplit

    return _resplit(bundles, sizes)


def sort(bundles, key: str, descending: bool = False, num_outputs: Optional[int] = None) -> list:
    """Sample-based range-partitioned sort (reference: sort.py — sample
    boundaries, range-partition maps, sorted merges)."""
    if not bundles:
        return []
    n = num_outputs or len(bundles)

    def _sample(block, key):
        acc = BlockAccessor.for_block(block)
        rows = acc.num_rows()
        if rows == 0:
            return np.array([])
        idx = np.linspace(0, rows - 1, min(20, rows)).astype(int)
        return np.asarray(acc.take_indices(idx)[key].tolist())

    samples = ray_tpu_torch.get([
        ray_tpu_torch.remote(num_returns=1)(_sample).remote(ref, key) for ref, _ in bundles
    ])
    allv = np.sort(np.concatenate([s for s in samples if len(s)]))
    if len(allv) == 0:
        return bundles
    bidx = np.linspace(0, len(allv) - 1, n + 1).astype(int)[1:-1]
    boundaries = list(allv[bidx])
    if descending:
        pass  # partitions are reversed inside _map_range
    return _shuffle(
        bundles, _map_range, (key, boundaries, descending), _reduce_sorted, (key, descending), len(boundaries) + 1
    )


def hash_aggregate(bundles, key: Optional[str], agg_fns: list, num_outputs: Optional[int] = None) -> list:
    """Grouped aggregation via hash shuffle then per-partition combine
    (reference: grouped_data.py + _internal/planner/aggregate.py)."""
    if key is None:
        # Global aggregate: per-block partials combined on one reducer.
        partial_refs = [
            ray_tpu_torch.remote(num_returns=1)(_partial_agg).remote(ref, key, agg_fns)
            for ref, _ in bundles
        ]
        refs = ray_tpu_torch.remote(num_returns=2)(_final_agg).remote(key, agg_fns, *partial_refs)
        return [(refs[0], ray_tpu_torch.get(refs[1]))]
    n = num_outputs or max(1, len(bundles))
    shuffled = _shuffle(bundles, _map_hash, (n, key), _reduce_concat, (None,), n)
    out = []
    for ref, _meta in shuffled:
        p = ray_tpu_torch.remote(num_returns=1)(_partial_agg).remote(ref, key, agg_fns)
        refs = ray_tpu_torch.remote(num_returns=2)(_final_agg).remote(key, agg_fns, p)
        out.append((refs[0], ray_tpu_torch.get(refs[1])))
    return out


def _partial_agg(block, key, agg_fns):
    """Returns list of (group_key, [accumulator_per_agg]) pairs."""
    acc = BlockAccessor.for_block(block)
    groups: dict = {}
    for row in acc.iter_rows():
        gk = row[key] if key is not None else None
        gk = gk.item() if hasattr(gk, "item") else gk
        if gk not in groups:
            groups[gk] = [fn.init(gk) for fn in agg_fns]
        groups[gk] = [fn.accumulate(a, row) for fn, a in zip(agg_fns, groups[gk])]
    return list(groups.items())


def _final_agg(key, agg_fns, *partials):
    merged: dict = {}
    for partial in partials:
        for gk, accs in partial:
            if gk not in merged:
                merged[gk] = accs
            else:
                merged[gk] = [fn.merge(a, b) for fn, a, b in zip(agg_fns, merged[gk], accs)]
    rows = []
    for gk in sorted(merged, key=lambda x: (x is None, x)):
        row = {} if key is None else {key: gk}
        for fn, a in zip(agg_fns, merged[gk]):
            row[fn.name] = fn.finalize(a)
        rows.append(row)
    out = BlockAccessor.batch_to_block(rows)
    return out, BlockAccessor.for_block(out).get_metadata()
