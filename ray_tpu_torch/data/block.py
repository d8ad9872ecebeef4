"""Block model for ray_tpu_torch.data: a block is a dict of numpy arrays.

Counterpart of ``ray_tpu/data/block.py``, whose block is a ``pyarrow.Table``.
The card's machine has neither pyarrow nor pandas, so here a block is a
columnar dict: each column one numpy array, every column of the same length.
A tensor column is an array of ndim > 1 (no fixed-size-list packing). Rows
are plain dicts; a batch in the "numpy" (default) format is a copy of the
block's dict (the same arrays). The "pandas" and "pyarrow" formats, and the conversions to and from
those packages, import them inside the call and raise ``ImportError`` naming
the package and the call where it is missing.

Where this block gives other values than the arrow block, ROADMAP queue C
says so (C8).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
from typing import Any, Callable, Iterator, Optional

import numpy as np

Block = dict

_TENSOR_SHAPES_KEY = b"ray_tpu.tensor_shapes"  # the arrow schema metadata the JAX package writes


def require(package: str, call: str):
    """Import ``package`` for ``call``, or raise ImportError naming both."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{call} needs the '{package.split('.')[0]}' package, which is not installed") from e


def _is_instance_of(obj, package: str, name: str) -> bool:
    """``isinstance(obj, package.name)`` without importing the package."""
    return any(c.__module__.split(".")[0] == package and c.__name__ == name for c in type(obj).__mro__)


@dataclasses.dataclass(frozen=True)
class Schema:
    """A block's columns: names, numpy dtypes and the shape of one row of
    each (``()`` for a scalar column)."""

    names: tuple
    types: tuple
    shapes: tuple

    def __repr__(self):
        cols = ", ".join(f"{n}: {t}{list(s) if s else ''}" for n, t, s in zip(self.names, self.types, self.shapes))
        return f"Schema({cols})"


@dataclasses.dataclass
class BlockMetadata:
    """Lightweight stats shipped next to each block ref (reference:
    data/block.py:276 BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Schema] = None
    input_files: Optional[list] = None

    def merged_with(self, other: "BlockMetadata") -> "BlockMetadata":
        return BlockMetadata(
            num_rows=self.num_rows + other.num_rows,
            size_bytes=self.size_bytes + other.size_bytes,
            schema=self.schema or other.schema,
            input_files=(self.input_files or []) + (other.input_files or []),
        )


def _column(values: Any) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    arr = np.asarray(values)
    if arr.ndim == 0:
        raise TypeError(f"a column must be an array of rows, not the scalar {values!r}")
    return arr


def _arrow_to_block(table) -> Block:
    """The JAX package's arrow block (tensor columns packed as fixed-size
    lists, their shapes in the schema's metadata) as a numpy block."""
    pa = require("pyarrow", "converting a pyarrow.Table")
    raw = (table.schema.metadata or {}).get(_TENSOR_SHAPES_KEY)
    shapes = ast.literal_eval(raw.decode()) if raw else {}
    out = {}
    for name in table.column_names:
        col = table.column(name)
        if pa.types.is_fixed_size_list(col.type):
            flat = col.combine_chunks().flatten().to_numpy(zero_copy_only=False)
            out[name] = flat.reshape((table.num_rows,) + tuple(shapes.get(name, (col.type.list_size,))))
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return out


def _nbytes(arr: np.ndarray) -> int:
    if arr.dtype != object:
        return int(arr.nbytes)
    extra = 0
    for v in arr.ravel():
        if isinstance(v, (str, bytes)):
            extra += len(v)
        elif isinstance(v, np.ndarray):
            extra += int(v.nbytes)
    return int(arr.nbytes) + extra


def _sort_indices(values: np.ndarray, descending: bool) -> np.ndarray:
    """Stable order of ``values``, NaN last in either direction (as arrow's
    ``sort_indices``)."""
    if not descending:
        return np.argsort(values, kind="stable")
    n = len(values)
    idx = n - 1 - np.argsort(values[::-1], kind="stable")[::-1]
    if values.dtype.kind == "f":
        nan = np.isnan(values[idx])
        idx = np.concatenate([idx[~nan], idx[nan]])
    return idx


class BlockAccessor:
    """Uniform operations over a block (reference: data/block.py:255)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Any) -> "BlockAccessor":
        return BlockAccessor(BlockAccessor.batch_to_block(block))

    # -- construction ------------------------------------------------------
    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Convert a user-produced batch (dict of arrays / list of rows /
        pandas / arrow) into a numpy block."""
        if isinstance(batch, dict):
            block = {name: _column(values) for name, values in batch.items()}
            lengths = {name: len(col) for name, col in block.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError(f"columns of unequal length: {lengths}")
            return block
        if isinstance(batch, list):  # list of row dicts
            if not batch:
                return {}
            keys = batch[0].keys()
            return BlockAccessor.batch_to_block({k: np.array([r[k] for r in batch]) for k in keys})
        if _is_instance_of(batch, "pandas", "DataFrame"):
            return {str(name): np.asarray(batch[name].to_numpy()) for name in batch.columns}
        if _is_instance_of(batch, "pyarrow", "Table"):
            return _arrow_to_block(batch)
        raise TypeError(f"cannot convert batch of type {type(batch)} to a block")

    @staticmethod
    def concat(blocks: list) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0] or blocks[:1]
        if not blocks:
            return {}
        if len(blocks) == 1:
            return blocks[0]
        names = list(blocks[0])
        for b in blocks[1:]:
            if set(b) != set(names):
                raise ValueError(f"cannot concatenate blocks with columns {names} and {list(b)}")
        return {name: np.concatenate([b[name] for b in blocks]) for name in names}

    # -- stats -------------------------------------------------------------
    def num_rows(self) -> int:
        for col in self._block.values():
            return len(col)
        return 0

    def size_bytes(self) -> int:
        return sum(_nbytes(col) for col in self._block.values())

    def schema(self) -> Schema:
        cols = self._block
        return Schema(tuple(cols), tuple(c.dtype for c in cols.values()), tuple(c.shape[1:] for c in cols.values()))

    def get_metadata(self, input_files: Optional[list] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files,
        )

    # -- conversion --------------------------------------------------------
    def to_numpy(self, columns: Optional[list] = None) -> dict:
        return {name: self._block[name] for name in (columns or self._block)}

    def to_pandas(self, call: str = "to_pandas"):
        pd = require("pandas", call)
        # A tensor column becomes a column of per-row arrays, as arrow's
        # to_pandas gives for a fixed-size list.
        return pd.DataFrame({k: (v if v.ndim == 1 else list(v)) for k, v in self._block.items()})

    def to_arrow(self, call: str = "to_arrow"):
        """The JAX package's arrow block for this block."""
        pa = require("pyarrow", call)
        cols, shapes = {}, {}
        for name, values in self._block.items():
            if values.ndim > 1 and 0 not in values.shape[1:]:
                flat = values.reshape(len(values), -1)
                cols[name] = pa.FixedSizeListArray.from_arrays(pa.array(flat.ravel()), flat.shape[1])
                shapes[name] = values.shape[1:]
            elif values.ndim > 1:
                cols[name] = pa.array([list(row) for row in values])
            else:
                cols[name] = pa.array(values)
        table = pa.table(cols)
        if shapes:
            table = table.replace_schema_metadata({_TENSOR_SHAPES_KEY: repr(shapes).encode()})
        return table

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return dict(self._block)
        if batch_format == "pandas":
            return self.to_pandas('batch_format="pandas"')
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow(f'batch_format="{batch_format}"')
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # -- row/slice ops -----------------------------------------------------
    def iter_rows(self) -> Iterator[dict]:
        cols = self._block
        for i in range(self.num_rows()):
            yield {k: v[i] for k, v in cols.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._block.items()}

    def take_indices(self, indices) -> Block:
        idx = np.asarray(indices, dtype=np.intp)
        return {k: v[idx] for k, v in self._block.items()}

    def random_shuffle(self, seed: Optional[int]) -> Block:
        rng = np.random.default_rng(seed)
        return self.take_indices(rng.permutation(self.num_rows()))

    def sort(self, key: str, descending: bool = False) -> Block:
        if not self.num_rows():
            return self._block  # may lack the key's column: an empty partition of an aggregate (C10)
        return self.take_indices(_sort_indices(self._block[key], descending))

    def filter_rows(self, predicate: Callable[[dict], bool]) -> Block:
        keep = [i for i, row in enumerate(self.iter_rows()) if predicate(row)]
        return self.take_indices(keep)

    def select(self, columns: list) -> Block:
        return {c: self._block[c] for c in columns}

    def rename(self, mapping: dict) -> Block:
        return {mapping.get(c, c): v for c, v in self._block.items()}

    def drop(self, columns: list) -> Block:
        return {c: v for c, v in self._block.items() if c not in columns}

    def hash_partition(self, key: str, num_partitions: int) -> list:
        # Process-stable hash: builtin hash() is salted per process for
        # str/bytes, which would scatter the same key across partitions when
        # map tasks run in different workers.
        import zlib

        def stable_hash(v) -> int:
            if isinstance(v, bytes):
                return zlib.crc32(v)
            return zlib.crc32(repr(v).encode())

        vals = self._block[key].tolist()
        assignments = np.array([stable_hash(v) % num_partitions for v in vals])
        return [self.take_indices(np.nonzero(assignments == p)[0]) for p in range(num_partitions)]

    def random_partition(self, num_partitions: int, seed: Optional[int]) -> list:
        rng = np.random.default_rng(seed)
        assignments = rng.integers(0, num_partitions, self.num_rows())
        return [self.take_indices(np.nonzero(assignments == p)[0]) for p in range(num_partitions)]

    def range_partition(self, key: str, boundaries: list) -> list:
        """Split sorted-key values by boundary values (for sort-shuffle)."""
        if not self.num_rows():
            return [self._block] * (len(boundaries) + 1)
        vals = np.asarray(self._block[key].tolist())
        assignments = np.searchsorted(np.asarray(boundaries), vals, side="right")
        return [
            self.take_indices(np.nonzero(assignments == p)[0])
            for p in range(len(boundaries) + 1)
        ]
