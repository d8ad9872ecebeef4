"""SQL datasource (DB-API 2.0 connections; sqlite3 in the standard image).

Reference: python/ray/data/datasource/sql_datasource.py (read_sql) and
dataset.write_sql: the user supplies a zero-arg ``connection_factory`` so
the CONNECTION is created inside each read/write task — DB handles don't
serialize, factories do. Reads can shard on an integer column
(``shard_column``) so partitions run as parallel tasks; without one the
query runs as a single task (the reference's default too, since an
arbitrary SQL query has no general row-addressing scheme).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import BlockMetadata
from ray_tpu_torch.data.datasource.datasource import Datasource, ReadTask


def _rows_to_columns(rows, description):
    names = [d[0] for d in description]
    if not rows:
        return {n: np.array([]) for n in names}
    cols = {}
    for i, n in enumerate(names):
        values = [r[i] for r in rows]
        cols[n] = np.asarray(values)
    return cols


class SQLDatasource(Datasource):
    def __init__(
        self,
        sql: str,
        connection_factory: Callable,
        shard_column: Optional[str] = None,
        shard_bounds: Optional[tuple] = None,
    ):
        self.sql = sql
        self.connection_factory = connection_factory
        self.shard_column = shard_column
        self.shard_bounds = shard_bounds

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self.connection_factory
        sql = self.sql

        if self.shard_column is None or parallelism <= 1:
            def read():
                conn = factory()
                try:
                    cur = conn.cursor()
                    cur.execute(sql)
                    yield _rows_to_columns(cur.fetchall(), cur.description)
                finally:
                    conn.close()

            return [ReadTask(read, BlockMetadata(num_rows=-1, size_bytes=0))]

        column = self.shard_column
        if self.shard_bounds is not None:
            lo, hi = self.shard_bounds
        else:
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(f"SELECT MIN({column}), MAX({column}) FROM ({sql})")
                lo, hi = cur.fetchone()
            finally:
                conn.close()
        if lo is None:
            return [ReadTask(lambda: iter(()), BlockMetadata(num_rows=0, size_bytes=0))]
        edges = np.linspace(int(lo), int(hi) + 1, parallelism + 1).astype(int)
        tasks = []
        for start, end in zip(edges[:-1], edges[1:]):
            if start == end:
                continue

            def read(start=int(start), end=int(end)):
                conn = factory()
                try:
                    cur = conn.cursor()
                    cur.execute(
                        f"SELECT * FROM ({sql}) WHERE {column} >= ? AND {column} < ?",
                        (start, end),
                    )
                    yield _rows_to_columns(cur.fetchall(), cur.description)
                finally:
                    conn.close()

            tasks.append(ReadTask(read, BlockMetadata(num_rows=-1, size_bytes=0)))

        def read_nulls():
            # Range predicates drop NULL shard-column rows from every shard;
            # a dedicated task keeps the sharded read row-equivalent to the
            # single-task read.
            conn = factory()
            try:
                cur = conn.cursor()
                cur.execute(f"SELECT * FROM ({sql}) WHERE {column} IS NULL")
                rows = cur.fetchall()
                if rows:
                    yield _rows_to_columns(rows, cur.description)
            finally:
                conn.close()

        tasks.append(ReadTask(read_nulls, BlockMetadata(num_rows=-1, size_bytes=0)))
        return tasks


def write_sql_block(block, table: str, connection_factory: Callable):
    """Insert one block into `table` (used by Dataset.write_sql tasks)."""
    from ray_tpu_torch.data.block import BlockAccessor

    acc = BlockAccessor.for_block(block)
    rows = list(acc.iter_rows())
    if not rows:
        return 0
    names = list(rows[0].keys())
    placeholders = ",".join(["?"] * len(names))
    conn = connection_factory()
    try:
        cur = conn.cursor()
        cur.executemany(
            f"INSERT INTO {table} ({','.join(names)}) VALUES ({placeholders})",
            [
                tuple(
                    v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0 else v
                    for v in r.values()
                )
                for r in rows
            ],
        )
        conn.commit()
        return len(rows)
    finally:
        conn.close()
