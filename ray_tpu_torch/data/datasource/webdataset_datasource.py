"""WebDataset tar-shard reader/writer.

Analog of the reference's webdataset_datasource.py: samples are groups of
files inside .tar shards sharing a key prefix (``{key}.{ext}``); the
extension names the column AND its format. Implemented on stdlib
``tarfile`` — no webdataset pip package required.

Conventions (round-trip safe):
- A column whose name is itself a known format (``txt``, ``json``,
  ``cls``, images, ``bin``) is stored as ``{key}.{col}``.
- Any other column gets a format suffix: ``{key}.{col}.{fmt}`` (e.g.
  ``sample0.meta.json``) and decodes back into column ``col``.
Writing goes through ``Dataset.write_webdataset`` (one shard per block).
Formats: json (dict/list/float/bool), txt (str), cls (int),
jpg/jpeg/png/ppm/bmp (PIL image -> np array when PIL is available, else
raw bytes), bin (raw bytes).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.datasource.datasource import FileBasedDatasource

_IMAGE_FORMATS = ("jpg", "jpeg", "png", "ppm", "bmp")
_KNOWN_FORMATS = {"txt", "text", "json", "cls", "id", "index", "bin", *_IMAGE_FORMATS}


def _jsonable(value):
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    return value


def _decode(fmt: str, data: bytes):
    fmt = fmt.lower()
    if fmt == "json":
        return json.loads(data.decode("utf-8"))
    if fmt in ("txt", "text"):
        return data.decode("utf-8")
    if fmt in ("cls", "id", "index"):
        return int(data.decode("utf-8").strip())
    if fmt in _IMAGE_FORMATS:
        try:
            import numpy as np
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)))
        except ImportError:
            return data
    return data  # bin / unknown: raw bytes


def _encode(col: str, value):
    """-> (member suffix, payload bytes). The suffix encodes column name
    and format per the module docstring."""
    value = _jsonable(value)
    if isinstance(value, bytes):
        fmt, data = "bin", value
    elif isinstance(value, str):
        fmt, data = "txt", value.encode()
    elif isinstance(value, bool) or not isinstance(value, int):
        fmt, data = "json", json.dumps(value).encode()
    else:
        fmt, data = "cls", str(value).encode()
    if col.lower() in _KNOWN_FORMATS:
        return col, data  # column name IS the format (trusted)
    return f"{col}.{fmt}", data


def write_sample(tf: tarfile.TarFile, key: str, row: dict):
    for col, value in row.items():
        if col == "__key__":
            continue
        suffix, data = _encode(col, value)
        info = tarfile.TarInfo(name=f"{key}.{suffix}")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))


class WebDatasetDatasource(FileBasedDatasource):
    _suffixes = [".tar"]

    def _read_file(self, path, batch_size: int = 64, **kwargs):
        rows: list = []
        current_key = None
        sample: dict = {}
        with tarfile.open(path, "r") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                if "." in base:
                    key, ext = base.split(".", 1)
                else:
                    key, ext = base, "bin"
                key = os.path.join(os.path.dirname(member.name), key)
                if current_key is not None and key != current_key:
                    if sample:
                        rows.append(sample)
                    sample = {}
                    if len(rows) >= batch_size:
                        yield BlockAccessor.batch_to_block(rows)
                        rows = []
                current_key = key
                sample["__key__"] = key
                ext_parts = ext.split(".")
                fmt = ext_parts[-1]
                col = ext if len(ext_parts) == 1 else ".".join(ext_parts[:-1])
                sample[col] = _decode(fmt, tf.extractfile(member).read())
        if sample:
            rows.append(sample)
        if rows:
            yield BlockAccessor.batch_to_block(rows)


