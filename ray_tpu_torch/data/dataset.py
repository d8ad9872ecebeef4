"""Dataset — lazy, distributed, streaming-executable datasets.

Analog of the reference's Dataset (python/ray/data/dataset.py:168 —
map_batches:381, iter_batches:2877, materialize:3967): transforms append
logical ops to a lazy plan; consumption lowers the plan to the streaming
executor (blocks flow as object-store refs between ray_tpu_torch tasks).
Blocks are dicts of numpy arrays (``block.py``). The device step is
``iter_torch_batches``, which yields batches of ``torch.Tensor`` on the card
(the counterpart of the JAX package's ``iter_jax_batches``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data._internal import shuffle as shuffle_mod
from ray_tpu_torch.data._internal.executor import (
    ActorPoolStrategy,
    ExecutionContext,
    execute_streaming,
)
from ray_tpu_torch.data._internal.logical_plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalOp,
    MapTransform,
    Union as UnionOp,
    Zip as ZipOp,
)
from ray_tpu_torch.data.block import BlockAccessor, BlockMetadata, require


def _batch_udf_to_block_fn(fn, batch_format, batch_size, fn_args, fn_kwargs):
    """Wrap a user batch UDF into Block -> Block."""

    def block_fn(block):
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        outs = []
        size = batch_size or max(n, 1)
        for start in range(0, max(n, 1), size):
            sub = acc.slice(start, min(start + size, n)) if n else block
            batch = BlockAccessor.for_block(sub).to_batch(batch_format)
            out = fn(batch, *fn_args, **fn_kwargs)
            outs.append(BlockAccessor.batch_to_block(out))
        return BlockAccessor.concat(outs)

    return block_fn


class Dataset:
    def __init__(self, plan: LogicalOp):
        self._plan = plan
        self._cached_bundles: Optional[list] = None

    # ------------------------------------------------------------------
    # Transforms (lazy)
    # ------------------------------------------------------------------
    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[ActorPoolStrategy] = None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        **ray_remote_args,
    ) -> "Dataset":
        """Apply a UDF over batches (reference: dataset.py:381)."""
        fn_kwargs = fn_kwargs or {}
        if num_cpus is not None:
            ray_remote_args["num_cpus"] = num_cpus
        if num_gpus is not None:
            ray_remote_args["num_gpus"] = num_gpus
        if isinstance(fn, type):
            # Callable class: runs on an actor pool with constructed state.
            compute = compute or ActorPoolStrategy()

            def block_fn(block, udf, _bf=batch_format, _bs=batch_size, _fa=fn_args, _fk=fn_kwargs):
                inner = _batch_udf_to_block_fn(udf, _bf, _bs, _fa, _fk)
                return inner(block)

            op = MapTransform(
                name="MapBatches",
                input_op=self._plan,
                block_fn=block_fn,
                compute=compute,
                ray_remote_args=ray_remote_args,
                fn_constructor=fn,
            )
            return Dataset(op)
        block_fn = _batch_udf_to_block_fn(fn, batch_format, batch_size, fn_args, fn_kwargs)
        op = MapTransform(
            name="MapBatches",
            input_op=self._plan,
            block_fn=block_fn,
            compute=compute,
            ray_remote_args=ray_remote_args,
        )
        return Dataset(op)

    def map(self, fn: Callable[[dict], dict], **ray_remote_args) -> "Dataset":
        def block_fn(block):
            rows = [fn(row) for row in BlockAccessor.for_block(block).iter_rows()]
            return BlockAccessor.batch_to_block(rows)

        return Dataset(MapTransform(name="Map", input_op=self._plan, block_fn=block_fn, ray_remote_args=ray_remote_args))

    def flat_map(self, fn: Callable[[dict], list], **ray_remote_args) -> "Dataset":
        def block_fn(block):
            rows = []
            for row in BlockAccessor.for_block(block).iter_rows():
                rows.extend(fn(row))
            return BlockAccessor.batch_to_block(rows)

        return Dataset(MapTransform(name="FlatMap", input_op=self._plan, block_fn=block_fn, ray_remote_args=ray_remote_args))

    def filter(self, fn: Callable[[dict], bool], **ray_remote_args) -> "Dataset":
        def block_fn(block):
            return BlockAccessor.for_block(block).filter_rows(fn)

        return Dataset(MapTransform(name="Filter", input_op=self._plan, block_fn=block_fn, ray_remote_args=ray_remote_args))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return Dataset(MapTransform(name="Select", input_op=self._plan, block_fn=lambda b: BlockAccessor.for_block(b).select(cols)))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return Dataset(MapTransform(name="Drop", input_op=self._plan, block_fn=lambda b: BlockAccessor.for_block(b).drop(cols)))

    def rename_columns(self, mapping: dict) -> "Dataset":
        return Dataset(MapTransform(name="Rename", input_op=self._plan, block_fn=lambda b: BlockAccessor.for_block(b).rename(mapping)))

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            col = fn(acc.to_pandas("add_column"))
            out = acc.drop([name])
            out[name] = np.asarray(col)
            return out

        return Dataset(MapTransform(name="AddColumn", input_op=self._plan, block_fn=block_fn))

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            rng = np.random.default_rng(seed)
            keep = np.nonzero(rng.random(acc.num_rows()) < fraction)[0]
            return acc.take_indices(keep)

        return Dataset(MapTransform(name="RandomSample", input_op=self._plan, block_fn=block_fn))

    def random_shuffle(self, *, seed: Optional[int] = None, num_blocks: Optional[int] = None) -> "Dataset":
        return Dataset(AllToAll(
            name="RandomShuffle",
            input_op=self._plan,
            bulk_fn=lambda bundles: shuffle_mod.random_shuffle(bundles, num_blocks, seed),
        ))

    def repartition(self, num_blocks: int) -> "Dataset":
        return Dataset(AllToAll(
            name="Repartition",
            input_op=self._plan,
            bulk_fn=lambda bundles: shuffle_mod.repartition(bundles, num_blocks),
        ))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(AllToAll(
            name="Sort",
            input_op=self._plan,
            bulk_fn=lambda bundles: shuffle_mod.sort(bundles, key, descending),
        ))

    def limit(self, n: int) -> "Dataset":
        return Dataset(Limit(name="Limit", input_op=self._plan, limit=n))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(UnionOp(name="Union", input_op=self._plan, extra_inputs=[o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(ZipOp(name="Zip", input_op=self._plan, other=other._plan))

    def window(self, *, blocks_per_window: int = 10) -> "DatasetPipeline":
        """Epoch/window pipelining (reference: data/dataset_pipeline.py):
        stream this dataset's blocks in windows of ``blocks_per_window``,
        each exposed as its own Dataset — nothing is materialized beyond
        the window in flight."""
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(self, blocks_per_window)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Repeat this dataset for ``times`` epochs (None = forever). A lazy
        plan re-executes per epoch — fresh reads, bounded memory."""
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        if times is not None and times < 1:
            raise ValueError("repeat() takes times >= 1 (or None for forever)")
        return DatasetPipeline(lambda: iter([self]), epochs=times)

    def groupby(self, key: Optional[str]) -> "GroupedData":
        from ray_tpu_torch.data.grouped_data import GroupedData

        return GroupedData(self, key)

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def _execute(self) -> list:
        if self._cached_bundles is None:
            from ray_tpu_torch.data._internal.executor import ExecutionContext

            ctx = ExecutionContext()
            self._cached_bundles = list(execute_streaming(self._plan, ctx))
            self._last_stats = ctx.dataset_stats
        return self._cached_bundles

    def iter_internal_refs(self) -> Iterator[tuple]:
        if self._cached_bundles is not None:
            yield from self._cached_bundles
        else:
            yield from execute_streaming(self._plan)

    def materialize(self) -> "Dataset":
        bundles = self._execute()
        out = Dataset(InputData(name="InputData", input_op=None, bundles=bundles))
        out._cached_bundles = bundles
        # ds.materialize().stats() must show the execution that produced it.
        out._last_stats = getattr(self, "_last_stats", None)
        return out

    def stats(self) -> str:
        """Per-operator execution summary (reference: DatasetStats,
        data/_internal/stats.py:117)."""
        bundles = self._execute()
        total = sum(m.num_rows for _, m in bundles)
        sz = sum(m.size_bytes for _, m in bundles)
        totals = f"Dataset: {len(bundles)} blocks, {total} rows, {sz} bytes"
        last = getattr(self, "_last_stats", None)
        if last is None or not last.op_stats:
            return totals
        return last.summary_string(totals)

    # ------------------------------------------------------------------
    # Consumption
    # ------------------------------------------------------------------
    def count(self) -> int:
        return sum(m.num_rows for _, m in self._execute())

    def num_blocks(self) -> int:
        return len(self._execute())

    def size_bytes(self) -> int:
        return sum(m.size_bytes for _, m in self._execute())

    def schema(self):
        for _, m in self._execute():
            if m.schema is not None:
                return m.schema
        return None

    def columns(self) -> Optional[list]:
        s = self.schema()
        return list(s.names) if s is not None else None

    def input_files(self) -> list:
        files: list = []
        for _, m in self._execute():
            files.extend(m.input_files or [])
        return sorted(set(files))

    def take(self, n: int = 20) -> List[dict]:
        out: List[dict] = []
        for ref, _meta in self.iter_internal_refs():
            block = ray_tpu_torch.get(ref)
            for row in BlockAccessor.for_block(block).iter_rows():
                out.append({k: (v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0 else v) for k, v in row.items()})
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[dict]:
        return self.take(n=2**63 - 1)

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        for batch in self.iter_batches(batch_size=batch_size, batch_format=batch_format):
            return batch
        raise ValueError("empty dataset")

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[dict]:
        for ref, _ in self.iter_internal_refs():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        prefetch_batches: int = 1,
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_from_refs

        yield from iter_batches_from_refs(
            self.iter_internal_refs(),
            batch_size=batch_size,
            batch_format=batch_format,
            prefetch_batches=prefetch_batches,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed,
        )

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
        """Yield batches as dicts of ``torch.Tensor`` on ``device`` (the
        counterpart of the JAX package's ``iter_jax_batches``,
        dataset.py:329-349): ``DataIterator.iter_torch_batches`` over this
        dataset, which says what ``device``, ``dtypes`` and ``sharding``
        do."""
        return self.iterator().iter_torch_batches(
            batch_size=batch_size, drop_last=drop_last, device=device, dtypes=dtypes, sharding=sharding, **kwargs
        )

    def to_pandas(self, limit: Optional[int] = None):
        pd = require("pandas", "Dataset.to_pandas")
        frames = []
        n = 0
        for ref, _ in self.iter_internal_refs():
            df = BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_pandas("Dataset.to_pandas")
            frames.append(df)
            n += len(df)
            if limit is not None and n >= limit:
                break
        if not frames:
            return pd.DataFrame()
        out = pd.concat(frames, ignore_index=True)
        return out.head(limit) if limit is not None else out

    def to_arrow_refs(self) -> list:
        """Refs to each block as the JAX package's arrow table (needs
        pyarrow, here and in the workers)."""
        require("pyarrow", "to_arrow_refs")

        def conv(block):
            return BlockAccessor.for_block(block).to_arrow("to_arrow_refs")

        return [ray_tpu_torch.remote(num_returns=1)(conv).remote(ref) for ref, _ in self._execute()]

    def to_numpy_refs(self) -> list:
        """Refs to each block's dict of numpy arrays: the blocks themselves."""
        return [ref for ref, _ in self._execute()]

    # ------------------------------------------------------------------
    # Aggregation
    # ------------------------------------------------------------------
    def aggregate(self, *aggs) -> dict:
        bundles = self._execute()
        out = shuffle_mod.hash_aggregate(bundles, None, list(aggs))
        rows = list(BlockAccessor.for_block(ray_tpu_torch.get(out[0][0])).iter_rows())
        row = rows[0] if rows else {}
        # Unwrap numpy SCALARS only — an aggregate may legitimately return
        # an array/list (e.g. a reservoir sample), where .item() throws.
        return {
            k: (v.item() if hasattr(v, "item") and getattr(v, "size", 1) == 1 else v)
            for k, v in row.items()
        }

    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))[f"sum({on})"]

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))[f"min({on})"]

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))[f"max({on})"]

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof))[f"std({on})"]

    def unique(self, column: str) -> list:
        seen = set()
        for ref, _ in self.iter_internal_refs():
            vals = BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_numpy([column])[column]
            seen.update(v.item() if hasattr(v, "item") else v for v in vals)
        return sorted(seen)

    # ------------------------------------------------------------------
    # Splitting (Train ingest)
    # ------------------------------------------------------------------
    def split(self, n: int, *, equal: bool = False, locality_hints=None) -> List["Dataset"]:
        bundles = self._execute()
        total = sum(m.num_rows for _, m in bundles)
        if equal:
            per = total // n
            sizes = [per] * n
        else:
            per = (total + n - 1) // n
            sizes = [min(per, max(0, total - i * per)) for i in range(n)]
        from ray_tpu_torch.data._internal.executor import _resplit

        outs = []
        flat = _resplit(bundles, [s for s in sizes if s > 0])
        it = iter(flat)
        for s in sizes:
            if s <= 0:
                outs.append(Dataset(InputData(name="InputData", input_op=None, bundles=[])))
            else:
                b = next(it)
                outs.append(Dataset(InputData(name="InputData", input_op=None, bundles=[b])))
        return outs

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        bundles = self._execute()
        total = sum(m.num_rows for _, m in bundles)
        points = [0] + list(indices) + [total]
        sizes = [points[i + 1] - points[i] for i in range(len(points) - 1)]
        from ray_tpu_torch.data._internal.executor import _resplit

        flat = _resplit(bundles, [max(s, 0) for s in sizes])
        return [Dataset(InputData(name="InputData", input_op=None, bundles=[b])) for b in flat]

    def split_proportionately(self, proportions: List[float]) -> List["Dataset"]:
        total = self.count()
        indices, acc = [], 0.0
        for p in proportions:
            acc += p
            indices.append(int(total * acc))
        return self.split_at_indices(indices)

    def train_test_split(self, test_size: float, *, shuffle: bool = False, seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1.0 - test_size])
        return train, test

    def streaming_split(self, n: int, *, equal: bool = True, locality_hints=None) -> list:
        """Per-consumer iterators over disjoint shards (reference:
        dataset.py streaming_split via OutputSplitter). equal=True re-chunks
        to exactly-equal row counts (SPMD consumers lockstep-iterate, so
        uneven shards would desync collectives); equal=False deals bundles
        round-robin without materializing."""
        from ray_tpu_torch.data.iterator import DataIterator, _ShardState

        if equal:
            parts = self.split(n, equal=True)
            return [DataIterator(dataset=p) for p in parts]
        state = _ShardState(self, n, equal)
        return [DataIterator(shard_state=state, shard_index=i) for i in range(n)]

    def iterator(self):
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(dataset=self)

    # ------------------------------------------------------------------
    # Writes
    # ------------------------------------------------------------------
    def _write(self, path: str, write_one: Callable, extension: str):
        import os

        os.makedirs(path, exist_ok=True)

        def task(block, i):
            fname = os.path.join(path, f"part-{i:05d}.{extension}")
            write_one(block, fname)
            return fname

        refs = [
            ray_tpu_torch.remote(num_returns=1)(task).remote(ref, i)
            for i, (ref, _) in enumerate(self.iter_internal_refs())
        ]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str):
        require("pyarrow.parquet", "write_parquet")

        def write_one(block, fname):
            import pyarrow.parquet as pq

            pq.write_table(BlockAccessor.for_block(block).to_arrow("write_parquet"), fname)

        return self._write(path, write_one, "parquet")

    def write_webdataset(self, path: str):
        """One .tar shard per block; rows become key-prefixed files decoded
        back by read_webdataset (reference: write_webdataset)."""
        def write_one(block, fname):
            import tarfile

            from ray_tpu_torch.data.datasource.webdataset_datasource import write_sample

            with tarfile.open(fname, "w") as tf:
                for n, row in enumerate(BlockAccessor.for_block(block).iter_rows()):
                    key = str(row.get("__key__", f"{n:08d}"))
                    write_sample(tf, key, row)

        return self._write(path, write_one, "tar")

    def write_csv(self, path: str):
        """One CSV file per block, header first, by the standard library's
        ``csv`` (``read_csv`` reads it back with the same column types)."""
        from ray_tpu_torch.data.datasource.datasource import write_csv_block

        return self._write(path, write_csv_block, "csv")

    def write_json(self, path: str):
        """One JSON-lines file per block (a JSON object per row), by the
        standard library's ``json``."""
        from ray_tpu_torch.data.datasource.datasource import write_json_block

        return self._write(path, write_json_block, "json")

    def write_numpy(self, path: str, column: str):
        def write_one(block, fname):
            np.save(fname, BlockAccessor.for_block(block).to_numpy([column])[column])

        return self._write(path, write_one, "npy")

    def write_sql(self, table: str, connection_factory: Callable) -> int:
        """Insert every row into a SQL table via DB-API 2.0 connections
        (reference: Dataset.write_sql). Connections are created INSIDE the
        write tasks — pass a factory, not a live handle. SQLite note: its
        writer lock serializes concurrent INSERTs, so blocks write from
        parallel tasks but commit sequentially."""
        from ray_tpu_torch.data.datasource.sql_datasource import write_sql_block

        refs = [
            ray_tpu_torch.remote(num_returns=1)(write_sql_block).remote(
                ref, table, connection_factory
            )
            for ref, _ in self.iter_internal_refs()
        ]
        return sum(ray_tpu_torch.get(refs))

    def __repr__(self):
        return f"Dataset(plan={self._plan.name})"
