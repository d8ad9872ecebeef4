"""Dataset creation APIs (reference: python/ray/data/read_api.py —
range:~, from_items, read_parquet:527, etc.)."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._internal.logical_plan import InputData, Read
from ray_tpu_torch.data.block import BlockAccessor, require
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource.datasource import (
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    ImageDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    TextDatasource,
    TFRecordsDatasource,
)


def _default_parallelism(override: Optional[int]) -> int:
    if override is not None and override > 0:
        return override
    ctx = DataContext.get_current()
    if ctx.default_parallelism:
        return ctx.default_parallelism
    try:
        return max(2, int(ray_tpu_torch.cluster_resources().get("CPU", 4)))
    except Exception:
        return 4


def read_datasource(datasource: Datasource, *, parallelism: int = -1, ray_remote_args: Optional[dict] = None) -> Dataset:
    tasks = datasource.get_read_tasks(_default_parallelism(parallelism if parallelism > 0 else None))
    return Dataset(Read(name="Read", input_op=None, read_tasks=tasks, ray_remote_args=ray_remote_args or {}))


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001 - reference name
    return read_datasource(RangeDatasource(n), parallelism=parallelism)


def read_sql(
    sql: str,
    connection_factory,
    *,
    parallelism: int = -1,
    shard_column: Optional[str] = None,
    shard_bounds: Optional[tuple] = None,
) -> Dataset:
    """Load a SQL query's results (reference: read_api.read_sql over DB-API
    connections; sqlite3 works out of the box). With ``shard_column`` (an
    integer column) the query is range-partitioned into parallel read
    tasks; otherwise it runs as one task."""
    from ray_tpu_torch.data.datasource.sql_datasource import SQLDatasource

    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_column, shard_bounds),
        parallelism=parallelism if shard_column is not None else 1,
    )


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    ds = range(n, parallelism=parallelism)

    def to_tensor(batch):
        ids = batch["id"]
        data = np.broadcast_to(ids.reshape((-1,) + (1,) * len(shape)), (len(ids),) + tuple(shape)).copy()
        return {"data": data}

    return ds.map_batches(to_tensor)


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    if items and not isinstance(items[0], dict):
        items = [{"item": x} for x in items]
    par = max(1, min(_default_parallelism(parallelism if parallelism > 0 else None), max(len(items), 1)))
    chunks = np.array_split(np.arange(len(items)), par)
    bundles = []
    for c in chunks:
        if len(c) == 0:
            continue
        block = BlockAccessor.batch_to_block([items[i] for i in c])
        ref = ray_tpu_torch.put(block)
        bundles.append((ref, BlockAccessor.for_block(block).get_metadata()))
    return Dataset(InputData(name="InputData", input_op=None, bundles=bundles))


def from_pandas(dfs) -> Dataset:
    require("pandas", "from_pandas")
    if not isinstance(dfs, list):
        dfs = [dfs]
    bundles = []
    for df in dfs:
        block = BlockAccessor.batch_to_block(df)
        bundles.append((ray_tpu_torch.put(block), BlockAccessor.for_block(block).get_metadata()))
    return Dataset(InputData(name="InputData", input_op=None, bundles=bundles))


def from_numpy(arrays, column: str = "data") -> Dataset:
    if not isinstance(arrays, list):
        arrays = [arrays]
    bundles = []
    for arr in arrays:
        block = BlockAccessor.batch_to_block({column: arr})
        bundles.append((ray_tpu_torch.put(block), BlockAccessor.for_block(block).get_metadata()))
    return Dataset(InputData(name="InputData", input_op=None, bundles=bundles))


def from_arrow(tables) -> Dataset:
    require("pyarrow", "from_arrow")
    if not isinstance(tables, list):
        tables = [tables]
    bundles = []
    for t in tables:
        block = BlockAccessor.batch_to_block(t)
        bundles.append((ray_tpu_torch.put(block), BlockAccessor.for_block(block).get_metadata()))
    return Dataset(InputData(name="InputData", input_op=None, bundles=bundles))


def read_parquet(paths, *, columns: Optional[list] = None, parallelism: int = -1, **kwargs) -> Dataset:
    if "meta_provider" not in kwargs:
        from ray_tpu_torch.data.datasource.partitioning import ParquetMetadataProvider

        # Footer-only row counts/sizes: exact progress + memory accounting
        # without reading data pages.
        kwargs["meta_provider"] = ParquetMetadataProvider()
    return read_datasource(ParquetDatasource(paths, columns=columns, **kwargs), parallelism=parallelism)


def read_csv(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(CSVDatasource(paths, **kwargs), parallelism=parallelism)


def read_json(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(JSONDatasource(paths, **kwargs), parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(NumpyDatasource(paths, **kwargs), parallelism=parallelism)


def read_text(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(TextDatasource(paths, **kwargs), parallelism=parallelism)


def read_binary_files(paths, *, include_paths: bool = False, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(BinaryDatasource(paths, include_paths=include_paths, **kwargs), parallelism=parallelism)


def read_images(paths, *, size: Optional[tuple] = None, mode: str = "RGB", include_paths: bool = False, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(ImageDatasource(paths, size=size, mode=mode, include_paths=include_paths, **kwargs), parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    return read_datasource(TFRecordsDatasource(paths, **kwargs), parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = -1, **kwargs) -> Dataset:
    """Read WebDataset .tar shards (reference: read_webdataset): samples
    are key-prefixed file groups inside each shard, decoded by extension."""
    from ray_tpu_torch.data.datasource.webdataset_datasource import WebDatasetDatasource

    return read_datasource(WebDatasetDatasource(paths, **kwargs), parallelism=parallelism)


def read_mongo(uri: str, database: str, collection: str, *, pipeline=None,
               parallelism: int = -1, **kwargs) -> Dataset:
    """Read a MongoDB collection, range-partitioned into parallel tasks
    (reference: read_mongo; requires pymongo unless a collection_factory
    is injected)."""
    from ray_tpu_torch.data.datasource.mongo_datasource import MongoDatasource

    return read_datasource(
        MongoDatasource(uri, database, collection, pipeline=pipeline, **kwargs),
        parallelism=parallelism,
    )
