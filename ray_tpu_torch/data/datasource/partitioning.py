"""Path partitioning + file-metadata providers.

Analog of the reference's python/ray/data/datasource/partitioning.py:34
(``Partitioning`` — hive and dir path styles) and file_meta_provider.py:20
(``FileMetadataProvider`` — size/row-count prefetch feeding BlockMetadata
and parallelism autodetection). Partition values parse from the PATH, so
pruning with ``partition_filter`` happens before any file is opened.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.data.block import BlockMetadata


class Partitioning:
    """Describes how partition fields are encoded in file paths.

    - ``style="hive"``: ``.../year=2024/country=fr/part-0.parquet`` — field
      names come from the path itself.
    - ``style="dir"``: ``.../2024/fr/part-0.parquet`` with
      ``field_names=["year", "country"]`` — positional directories under
      ``base_dir``.

    Values are strings by default (matching the reference); pass
    ``field_types={"year": int}`` to cast specific fields.
    """

    def __init__(self, style: str = "hive", *, base_dir: Optional[str] = None,
                 field_names: Optional[List[str]] = None,
                 field_types: Optional[Dict[str, Callable]] = None):
        if style not in ("hive", "dir"):
            raise ValueError(f"unknown partitioning style {style!r} (hive|dir)")
        if style == "dir" and not field_names:
            raise ValueError("style='dir' requires field_names")
        if style == "dir" and not base_dir:
            # Without an anchor the leading path segments would zip against
            # field_names (e.g. year='' from the root slash) — wrong values
            # with no error.
            raise ValueError("style='dir' requires base_dir")
        self.style = style
        self.base_dir = os.path.normpath(base_dir) if base_dir else None
        self.field_names = list(field_names or [])
        self.field_types = dict(field_types or {})

    def _rel_dirs(self, path: str) -> List[str]:
        d = os.path.dirname(os.path.normpath(path))
        if self.base_dir:
            rel = os.path.relpath(d, self.base_dir)
            if rel.startswith(".."):
                return []
            if rel == ".":
                return []
            return rel.split(os.sep)
        return d.split(os.sep)

    def parse(self, path: str) -> Dict[str, object]:
        """Extract partition fields from one file path."""
        parts = self._rel_dirs(path)
        out: Dict[str, object] = {}
        if self.style == "hive":
            for seg in parts:
                if "=" in seg:
                    k, v = seg.split("=", 1)
                    out[k] = v
            if self.field_names:
                out = {k: v for k, v in out.items() if k in self.field_names}
        else:
            # dir style: positional under base_dir.
            for name, seg in zip(self.field_names, parts):
                out[name] = seg
        for k, cast in self.field_types.items():
            if k in out:
                out[k] = cast(out[k])
        return out


class FileMetadataProvider:
    """Supplies BlockMetadata for a group of input files WITHOUT reading
    their contents (reference: file_meta_provider.py:20). The streaming
    executor uses size/row estimates for memory budgeting and the read
    layer for parallelism autodetection."""

    def get_metadata(self, paths: List[str]) -> BlockMetadata:
        raise NotImplementedError


class DefaultFileMetadataProvider(FileMetadataProvider):
    """os.stat sizes; row counts unknown."""

    def get_metadata(self, paths: List[str]) -> BlockMetadata:
        size = 0
        for p in paths:
            try:
                size += os.path.getsize(p)
            except OSError:
                pass
        return BlockMetadata(num_rows=-1, size_bytes=size, input_files=list(paths))


class FastFileMetadataProvider(FileMetadataProvider):
    """Skips per-file stat calls entirely — for huge listings where even
    stat round-trips dominate (reference: FastFileMetadataProvider)."""

    def get_metadata(self, paths: List[str]) -> BlockMetadata:
        return BlockMetadata(num_rows=-1, size_bytes=-1, input_files=list(paths))


class ParquetMetadataProvider(FileMetadataProvider):
    """Exact row counts + uncompressed sizes from parquet footers — no
    data pages are read (reference: ParquetMetadataProvider)."""

    def get_metadata(self, paths: List[str]) -> BlockMetadata:
        from ray_tpu_torch.data.block import require

        pq = require("pyarrow.parquet", "ParquetMetadataProvider")

        rows = 0
        size = 0
        for p in paths:
            try:
                md = pq.ParquetFile(p).metadata
                rows += md.num_rows
                for rg in range(md.num_row_groups):
                    size += md.row_group(rg).total_byte_size
            except Exception:
                return DefaultFileMetadataProvider().get_metadata(paths)
        return BlockMetadata(num_rows=rows, size_bytes=size, input_files=list(paths))
