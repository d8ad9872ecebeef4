"""Batch iteration with prefetching (reference:
python/ray/data/iterator.py DataIterator + _internal/block_batching/).

``iter_batches_from_refs`` pulls the next block ref while slicing the current
one into batches; ``DataIterator`` is the per-consumer view used by Train
(`session.get_dataset_shard`), including the shared-shard state behind
``streaming_split``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Iterator, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor


def iter_batches_from_refs(
    ref_iter,
    *,
    batch_size: Optional[int],
    batch_format: str = "numpy",
    prefetch_batches: int = 1,
    drop_last: bool = False,
    local_shuffle_buffer_size: Optional[int] = None,
    local_shuffle_seed: Optional[int] = None,
) -> Iterator[Any]:
    """Slice a stream of block refs into batches, prefetching blocks."""
    rng = np.random.default_rng(local_shuffle_seed)

    def fetch_blocks():
        # Real prefetch: background-thread gets overlap block transfer with
        # the consumer's compute (holding refs alone starts no fetch).
        from concurrent.futures import ThreadPoolExecutor

        depth = max(1, prefetch_batches)
        with ThreadPoolExecutor(max_workers=depth, thread_name_prefix="data-prefetch") as pool:
            window: collections.deque = collections.deque()
            for ref, _meta in ref_iter:
                window.append(pool.submit(ray_tpu_torch.get, ref))
                while len(window) > depth:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()

    carry: Optional[Any] = None  # leftover block slice
    shuffle_buf: list = []

    def emit(table):
        acc = BlockAccessor.for_block(table)
        return acc.to_batch(batch_format)

    for block in fetch_blocks():
        table = block if carry is None else BlockAccessor.concat([carry, block])
        carry = None
        if local_shuffle_buffer_size:
            shuffle_buf.append(table)
            buffered = sum(BlockAccessor(t).num_rows() for t in shuffle_buf)
            if buffered < local_shuffle_buffer_size:
                continue
            merged = BlockAccessor.concat(shuffle_buf)
            table = BlockAccessor.for_block(merged).random_shuffle(int(rng.integers(2**31)))
            shuffle_buf = []
        if batch_size is None:
            yield emit(table)
            continue
        acc = BlockAccessor.for_block(table)
        n = acc.num_rows()
        start = 0
        while n - start >= batch_size:
            yield emit(acc.slice(start, start + batch_size))
            start += batch_size
        if start < n:
            carry = acc.slice(start, n)

    if shuffle_buf:
        merged = BlockAccessor.concat(shuffle_buf + ([carry] if carry is not None else []))
        carry = BlockAccessor.for_block(merged).random_shuffle(int(rng.integers(2**31)))
    if carry is not None and BlockAccessor.for_block(carry).num_rows() > 0:
        if batch_size is None:
            yield emit(carry)
            return
        acc = BlockAccessor.for_block(carry)
        n = acc.num_rows()
        start = 0
        while n - start >= batch_size:
            yield emit(acc.slice(start, start + batch_size))
            start += batch_size
        if start < n and not drop_last:
            yield emit(acc.slice(start, n))


class _ShardState:
    """Shared execution state behind streaming_split: one executor run,
    bundles dealt to n consumers (reference: OutputSplitter).

    equal=True matters for SPMD gangs: if one rank sees more rows than
    another, a data-parallel training gang deadlocks at the shorter rank's epoch end.
    Bundles are dealt to the least-loaded shard (imbalance bounded by one
    block) and, at exhaustion, still-queued surplus is trimmed to the
    minimum assigned row count via remote slice tasks."""

    def __init__(self, dataset, n: int, equal: bool):
        self._dataset = dataset
        self._n = n
        self._equal = equal
        self._lock = threading.Lock()
        self._queues = [collections.deque() for _ in range(n)]
        self._assigned_rows = [0] * n
        self._source: Optional[Iterator] = None
        self._exhausted = False
        self._next_shard = 0
        self._trimmed = False
        self._trim_event = threading.Event()

    def _deal_one(self) -> bool:
        """Pull one bundle from the source and assign it. Lock held."""
        if self._source is None:
            self._source = self._dataset.iter_internal_refs()
        try:
            bundle = next(self._source)
        except StopIteration:
            self._exhausted = True
            return False
        if self._equal:
            target = min(range(self._n), key=lambda i: self._assigned_rows[i])
        else:
            target = self._next_shard
            self._next_shard = (self._next_shard + 1) % self._n
        self._queues[target].append(bundle)
        self._assigned_rows[target] += bundle[1].num_rows
        return True

    def _trim_to_equal(self):
        """Equalize assigned rows across shards at exhaustion. The remote
        slice round-trips run with the lock RELEASED (the plan — which
        bundles to drop/slice — is made and applied under the lock; only
        the slicing itself happens outside), so sibling consumers aren't
        stalled behind object-store calls."""
        from ray_tpu_torch.data._internal.executor import _slice_block_task

        slice_jobs = []  # (shard, ref, keep)
        with self._lock:
            if self._trimmed:
                return
            self._trimmed = True
            floor = min(self._assigned_rows)
            for i in range(self._n):
                excess = self._assigned_rows[i] - floor
                while excess > 0 and self._queues[i]:
                    ref, meta = self._queues[i].pop()
                    if meta.num_rows <= excess:
                        excess -= meta.num_rows
                        self._assigned_rows[i] -= meta.num_rows
                        continue
                    slice_jobs.append((i, ref, meta.num_rows - excess))
                    self._assigned_rows[i] -= excess
                    excess = 0
                # Rows a shard already consumed beyond the floor can't be
                # clawed back; least-loaded dealing bounds that to < one
                # block when consumers pull concurrently.
        if not slice_jobs:
            self._trim_event.set()
            return
        pairs = [
            (i, ray_tpu_torch.remote(num_returns=2)(_slice_block_task).remote(ref, 0, keep))
            for i, ref, keep in slice_jobs
        ]
        resolved = [(i, refs[0], ray_tpu_torch.get(refs[1])) for i, refs in pairs]
        with self._lock:
            for i, ref, meta in resolved:
                self._queues[i].append((ref, meta))
        self._trim_event.set()

    def next_bundle(self, shard: int):
        while True:
            with self._lock:
                if self._queues[shard]:
                    return self._queues[shard].popleft()
                if self._exhausted:
                    if not self._equal or self._trim_event.is_set():
                        if self._queues[shard]:
                            continue
                        return None
                    need_trim = not self._trimmed
                else:
                    self._deal_one()
                    continue
            # Exhausted, equal-split: first consumer here runs the trim
            # (outside the lock); the rest wait for it to finish.
            if need_trim:
                self._trim_to_equal()
            else:
                self._trim_event.wait(timeout=300)


class DataIterator:
    """Per-consumer iterator handle (reference: data/iterator.py)."""

    def __init__(self, dataset=None, shard_state: Optional[_ShardState] = None, shard_index: int = 0):
        self._dataset = dataset
        self._shard_state = shard_state
        self._shard_index = shard_index
        # Bundles this shard has claimed from the shared state: replayed on
        # re-iteration so count()/multiple epochs see the same shard.
        self._claimed: list = []
        self._drained = False

    def _ref_iter(self):
        if self._shard_state is not None:
            yield from self._claimed
            while not self._drained:
                bundle = self._shard_state.next_bundle(self._shard_index)
                if bundle is None:
                    self._drained = True
                    return
                self._claimed.append(bundle)
                yield bundle
        else:
            yield from self._dataset.iter_internal_refs()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        kwargs.setdefault("batch_size", 256)
        kwargs.setdefault("batch_format", "numpy")
        return iter_batches_from_refs(self._ref_iter(), **kwargs)

    def iter_rows(self) -> Iterator[dict]:
        for ref, _ in self._ref_iter():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows()

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        drop_last: bool = False,
        device=None,
        dtypes: Optional[dict] = None,
        sharding=None,
        **kwargs,
    ) -> Iterator[dict]:
        """Batches as dicts of ``torch.Tensor`` on ``device``, with one batch
        of transfer lookahead, as the JAX package's ``iter_jax_batches``
        (iterator.py:235-258): batch i+1's host-to-device copy is issued
        before batch i is handed out, so on a card it overlaps the
        consumer's step i.

        ``device``: None means the train session's device
        (``session.get_device()``) inside a train worker and the card
        elsewhere; it raises where there is no card (pass ``device="cpu"``).
        On a card each column is copied into pinned host memory and sent
        with ``non_blocking=True``; the pinned copy is kept until a CUDA
        event recorded after its send has passed. ``dtypes``: column ->
        torch or numpy dtype, cast on the host before the copy as the
        reference's ``astype`` (on the card after it, for a dtype numpy
        lacks, such as bfloat16). ``sharding``: a mesh (``parallel.mesh.
        Mesh`` or a torch ``DeviceMesh``) of one rank, whose device is the
        card; more ranks raise ``TypeError`` (ROADMAP A9f)."""
        dev = _torch_device(device)
        _check_sharding(sharding)
        batches = self.iter_batches(batch_size=batch_size, drop_last=drop_last, **kwargs)
        return _with_lookahead(batches, dev, dtypes or {})

    def materialize(self):
        from ray_tpu_torch.data._internal.logical_plan import InputData
        from ray_tpu_torch.data.dataset import Dataset

        bundles = list(self._ref_iter())
        ds = Dataset(InputData(name="InputData", input_op=None, bundles=bundles))
        ds._cached_bundles = bundles
        return ds

    def count(self) -> int:
        return sum(m.num_rows for _, m in self._ref_iter())


def _torch_device(device):
    import torch

    if device is None:
        from ray_tpu_torch.air import session

        device = session.get_device() if session.in_session() else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to iterate on the CPU")
    return device


def _check_sharding(sharding) -> None:
    if sharding is None:
        return
    mesh = getattr(sharding, "device_mesh", sharding)
    if mesh.size() > 1:
        raise TypeError(
            f"iter_torch_batches(sharding=...) over a mesh of {mesh.size()} ranks is not ported: batches "
            "sharded over more than one rank wait for ROADMAP A9f"
        )


def _torch_dtype(dtype):
    import torch

    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _numpy_dtype(dtype):
    """numpy's dtype for a torch dtype, or None where numpy has none."""
    import torch

    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return None


class _Transfer:
    """One batch on its way to ``device``: the tensors there, and on a card
    the pinned host copies they were sent from, with the event after the
    sends."""

    def __init__(self, batch: dict, device, dtypes: dict):
        import torch

        self.tensors, self._pinned, self._event = {}, [], None
        cuda = device.type == "cuda"
        for name, values in batch.items():
            want = _torch_dtype(dtypes.get(name))
            host_np = _numpy_dtype(want) if want is not None else None
            values = np.asarray(values)
            if host_np is not None:
                values = values.astype(host_np, copy=False)
            if not cuda:
                t = torch.from_numpy(np.array(values))
                self.tensors[name] = t if want is None else t.to(want)
                continue
            host = torch.empty(values.shape, dtype=torch.from_numpy(np.empty(0, values.dtype)).dtype,
                               pin_memory=True)
            np.copyto(host.numpy(), values)
            t = host.to(device, non_blocking=True)
            self.tensors[name] = t if want is None else t.to(want)
            self._pinned.append(host)
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def release(self) -> None:
        if self._event is not None and not self._event.query():
            self._event.synchronize()
        self._pinned, self._event = [], None


def _with_lookahead(batches, device, dtypes: dict) -> Iterator[dict]:
    prev = None
    for batch in batches:
        cur = _Transfer(batch, device, dtypes)
        if prev is not None:
            yield prev.tensors
            prev.release()
        prev = cur
    if prev is not None:
        yield prev.tensors
        prev.release()
