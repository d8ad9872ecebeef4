"""Datasource protocol + file-based readers.

Analog of the reference's datasource layer (python/ray/data/datasource/*.py):
a ``Datasource.get_read_tasks(parallelism)`` returns serializable ``ReadTask``
callables, each producing one or more blocks; file readers share path
expansion + per-file task logic (file_based_datasource.py). Writers mirror
``Dataset.write_*``.

Every reader yields numpy blocks. CSV and JSON are read and written with the
standard library's ``csv`` and ``json``, with column types inferred as the
JAX package's readers (pyarrow's CSV reader, pandas' ``read_json``) infer
them for integers, floats, booleans and strings (``_infer_column``); parquet
needs pyarrow, images PIL, each imported inside the read.
"""

from __future__ import annotations

import csv
import glob as globlib
import json
import math
import os
import re
from typing import Callable, Iterable, List, Optional

import numpy as np

from ray_tpu_torch.data.block import BlockAccessor, BlockMetadata, _arrow_to_block, require


class ReadTask:
    """A serializable zero-arg callable yielding batches/blocks, carrying
    advance metadata for scheduling (reference: datasource.py ReadTask)."""

    def __init__(self, read_fn: Callable[[], Iterable], metadata: Optional[BlockMetadata] = None):
        self._read_fn = read_fn
        self.metadata = metadata

    def __call__(self):
        return self._read_fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None


class RangeDatasource(Datasource):
    def __init__(self, n: int, column: str = "id"):
        self._n = n
        self._column = column

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n, col = self._n, self._column
        parallelism = max(1, min(parallelism, n)) if n else 1
        tasks = []
        chunk = (n + parallelism - 1) // parallelism if n else 0
        for start in range(0, n, max(chunk, 1)):
            end = min(start + chunk, n)

            def read(start=start, end=end):
                yield {col: np.arange(start, end)}

            tasks.append(ReadTask(read, BlockMetadata(num_rows=end - start, size_bytes=8 * (end - start))))
        return tasks or [ReadTask(lambda: iter([{col: np.array([], dtype=np.int64)}]), BlockMetadata(0, 0))]


def _expand_paths(paths, suffixes=None) -> list:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if suffixes:
        out = [p for p in out if any(p.endswith(s) for s in suffixes)]
    if not out:
        raise ValueError(f"no files found for {paths}")
    return out


def _attach_partition_cols(block, fields: dict):
    """Append constant partition columns to one block, skipping names the
    data already carries."""
    if not fields:
        return block
    out = BlockAccessor.batch_to_block(block)
    n = BlockAccessor(out).num_rows()
    out = dict(out)
    for k, v in fields.items():
        if k not in out:
            out[k] = np.full(n, v)
    return out


class FileBasedDatasource(Datasource):
    _suffixes: Optional[list] = None

    def __init__(self, paths, partitioning=None, partition_filter=None,
                 meta_provider=None, **reader_args):
        """``partitioning``: a Partitioning describing how fields encode in
        paths — parsed values become extra columns on every block.
        ``partition_filter``: dict -> bool predicate; files whose partition
        fields fail it are PRUNED before any byte is read (reference:
        partitioning.py PathPartitionFilter). ``meta_provider``: a
        FileMetadataProvider supplying size/row metadata without reading
        data (reference: file_meta_provider.py:20)."""
        all_paths = _expand_paths(paths, self._suffixes)
        self._partitions: dict = {}
        if partitioning is not None:
            self._partitions = {p: partitioning.parse(p) for p in all_paths}
            if partition_filter is not None:
                all_paths = [p for p in all_paths if partition_filter(self._partitions[p])]
                if not all_paths:
                    raise ValueError("partition_filter pruned every input file")
        elif partition_filter is not None:
            raise ValueError("partition_filter requires partitioning=")
        self._paths = all_paths
        if meta_provider is None:
            from ray_tpu_torch.data.datasource.partitioning import DefaultFileMetadataProvider

            meta_provider = DefaultFileMetadataProvider()
        self._meta_provider = meta_provider
        self._reader_args = reader_args

    def _read_file(self, path: str, **kwargs):
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        size = self._meta_provider.get_metadata(self._paths).size_bytes
        return None if size is None or size < 0 else size

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        groups = np.array_split(np.arange(len(self._paths)), max(1, min(parallelism, len(self._paths))))
        read_file = self._read_file
        args = self._reader_args
        partitions = self._partitions
        tasks = []
        for g in groups:
            if len(g) == 0:
                continue
            files = [self._paths[i] for i in g]

            def read(files=files):
                for f in files:
                    fields = partitions.get(f)
                    for block in read_file(f, **args):
                        yield _attach_partition_cols(block, fields)

            tasks.append(ReadTask(read, self._meta_provider.get_metadata(files)))
        return tasks


class ParquetDatasource(FileBasedDatasource):
    _suffixes = [".parquet"]

    def __init__(self, paths, **kwargs):
        require("pyarrow.parquet", "read_parquet")
        super().__init__(paths, **kwargs)

    def _read_file(self, path, columns=None, **kwargs):
        pq = require("pyarrow.parquet", "read_parquet")
        yield _arrow_to_block(pq.read_table(path, columns=columns, **kwargs))


_TRUE, _FALSE = {"true", "True", "TRUE"}, {"false", "False", "FALSE"}
_INT = re.compile(r"[+-]?[0-9]+")


def _infer_column(values: list) -> np.ndarray:
    """One column of parsed values (None for a missing one) as numpy, typed
    as the JAX package's readers type it: integers as int64 (float64 with
    NaN where one is missing), numbers as float64, booleans as bool,
    strings as str; anything else (lists, objects, mixed) as objects."""
    present = [v for v in values if v is not None]
    if not present:
        return np.array(values, dtype=object)
    if all(isinstance(v, bool) for v in present):
        return np.array(values, dtype=bool if len(present) == len(values) else object)
    if all(isinstance(v, int) and not isinstance(v, bool) for v in present):
        if len(present) == len(values):
            return np.array(values, dtype=np.int64)
        return np.array([math.nan if v is None else v for v in values], dtype=np.float64)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present):
        return np.array([math.nan if v is None else v for v in values], dtype=np.float64)
    if all(isinstance(v, str) for v in present) and len(present) == len(values):
        return np.array(values, dtype=str)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _parse_bool(text: str) -> bool:
    if text in _TRUE or text in _FALSE:
        return text in _TRUE
    raise ValueError(text)


def _parse_int(text: str) -> int:
    if not _INT.fullmatch(text):
        raise ValueError(text)
    return int(text)


def _csv_column(fields: list) -> np.ndarray:
    """One CSV column as pyarrow's reader types it: the first of int64,
    bool and float64 that every non-empty field parses as (an empty field
    is missing), else strings (an empty field is then "")."""
    present = [f for f in fields if f != ""]
    for parse in (_parse_int, _parse_bool, float):
        try:
            parsed = iter([parse(f) for f in present])
        except ValueError:
            continue
        return _infer_column([next(parsed) if f != "" else None for f in fields])
    return np.array(fields, dtype=str)


class CSVDatasource(FileBasedDatasource):
    _suffixes = None

    def _read_file(self, path, **kwargs):
        with open(path, newline="") as f:
            rows = list(csv.reader(f, **kwargs))
        if not rows:
            return
        header, body = rows[0], rows[1:]
        yield {name: _csv_column([r[i] for r in body]) for i, name in enumerate(header)}


def write_csv_block(block, fname: str) -> None:
    """One block as CSV: a header, then a row per row; booleans as
    true/false and a missing value (None, NaN) as an empty field."""
    for name, col in block.items():
        if col.ndim > 1:
            raise ValueError(f"write_csv: column {name!r} is a tensor column {col.shape[1:]}, which CSV cannot hold")

    def field(v):
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return ""
        if isinstance(v, bool):
            return "true" if v else "false"
        return v

    with open(fname, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(block))
        w.writerows([[field(v) for v in row] for row in zip(*(col.tolist() for col in block.values()))])


def write_json_block(block, fname: str) -> None:
    """One block as JSON lines; NaN as null (as pandas' ``to_json``)."""

    def value(v):
        return None if isinstance(v, float) and math.isnan(v) else v

    names = list(block)
    with open(fname, "w") as f:
        for row in zip(*(col.tolist() for col in block.values())):
            f.write(json.dumps({n: value(v) for n, v in zip(names, row)}) + "\n")


class JSONDatasource(FileBasedDatasource):
    _suffixes = None

    def _read_file(self, path, **kwargs):
        with open(path) as f:
            if kwargs.get("lines", True):
                rows = [json.loads(line) for line in f if line.strip()]
            else:
                rows = json.load(f)
        names: dict = {}
        for r in rows:
            names.update(dict.fromkeys(r))
        yield {name: _infer_column([r.get(name) for r in rows]) for name in names}


class NumpyDatasource(FileBasedDatasource):
    _suffixes = [".npy", ".npz"]

    def _read_file(self, path, column: str = "data", **kwargs):
        arr = np.load(path, allow_pickle=False)
        if isinstance(arr, np.lib.npyio.NpzFile):
            yield {k: arr[k] for k in arr.files}
        else:
            yield {column: arr}


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path, include_paths: bool = False, **kwargs):
        with open(path, "rb") as f:
            data = f.read()
        batch = {"bytes": np.empty(1, dtype=object)}
        batch["bytes"][0] = data
        if include_paths:
            batch["path"] = np.array([path])
        yield batch


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path, encoding: str = "utf-8", drop_empty_lines: bool = True, **kwargs):
        with open(path, "r", encoding=encoding) as f:
            lines = [ln.rstrip("\n") for ln in f]
        if drop_empty_lines:
            lines = [ln for ln in lines if ln.strip()]
        yield {"text": np.array(lines, dtype=object).astype(str)}


class ImageDatasource(FileBasedDatasource):
    _suffixes = [".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp"]

    def _read_file(self, path, size: Optional[tuple] = None, mode: str = "RGB", include_paths: bool = False, **kwargs):
        from PIL import Image

        img = Image.open(path).convert(mode)
        if size is not None:
            img = img.resize(size)
        arr = np.asarray(img)
        batch = {"image": arr[None, ...]}
        if include_paths:
            batch["path"] = np.array([path])
        yield batch


class TFRecordsDatasource(FileBasedDatasource):
    """Minimal TFRecord reader (uncompressed) parsing tf.train.Example
    protos without a TF dependency (reference: tfrecords_datasource.py)."""

    _suffixes = None

    def _read_file(self, path, **kwargs):
        rows = []
        with open(path, "rb") as f:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                (length,) = np.frombuffer(header, dtype="<u8", count=1)
                f.read(4)  # length crc
                payload = f.read(int(length))
                f.read(4)  # data crc
                rows.append(_parse_tf_example(payload))
        if rows:
            keys = rows[0].keys()
            yield {k: np.array([r[k] for r in rows]) for k in keys}


def _parse_tf_example(payload: bytes) -> dict:
    """Tiny protobuf wire-format parser for tf.train.Example."""
    out = {}
    feats = _pb_fields(payload).get(1)
    if not feats:
        return out
    for fmap in feats:
        for entry in _pb_fields(fmap).get(1, []):
            fields = _pb_fields(entry)
            name = fields[1][0].decode()
            feature = fields[2][0]
            ff = _pb_fields(feature)
            if 1 in ff:  # bytes_list
                vals = _pb_fields(ff[1][0]).get(1, [])
                out[name] = vals[0] if len(vals) == 1 else vals
            elif 2 in ff:  # float_list
                raw = _pb_fields(ff[2][0]).get(1, [])
                arr = np.concatenate([np.frombuffer(r, dtype="<f4") if isinstance(r, bytes) else np.array([r], dtype="<f4") for r in raw]) if raw else np.array([], "<f4")
                out[name] = arr[0] if arr.size == 1 else arr
            elif 3 in ff:  # int64_list
                raw = _pb_fields(ff[3][0]).get(1, [])
                vals = []
                for r in raw:
                    if isinstance(r, bytes):
                        vals.extend(_decode_varints(r))
                    else:
                        vals.append(r)
                out[name] = vals[0] if len(vals) == 1 else np.array(vals)
    return out


def _pb_fields(buf: bytes) -> dict:
    """Parse one protobuf message into {field_number: [values]}."""
    out: dict = {}
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:
            val = np.frombuffer(buf[i : i + 4], dtype="<f4")[0]
            i += 4
        elif wire == 1:
            val = np.frombuffer(buf[i : i + 8], dtype="<f8")[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def _read_varint(buf: bytes, i: int):
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _decode_varints(buf: bytes) -> list:
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out
