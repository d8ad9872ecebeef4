"""Checkpoint — uniform dict/directory/bytes representation.

Analog of the reference's air.Checkpoint (python/ray/air/checkpoint.py:66):
convertible between an in-memory dict, a directory on disk, and opaque bytes;
framework layers store dicts of tensors in it (``checkpoint_from_tensors``),
pulled to host numpy on save.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import cloudpickle


class Checkpoint:
    def __init__(self, data: dict | None = None, directory: str | None = None):
        self._data = data
        self._directory = directory
        # Small side-band info (e.g. training_iteration); travels with the
        # object through the object store and as metadata.json in dir form.
        self.metadata: dict = {}
        if directory is not None:
            meta_path = os.path.join(directory, "metadata.json")
            if os.path.exists(meta_path):
                import json

                with open(meta_path) as f:
                    self.metadata = json.load(f)

    # ---- constructors ----

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(directory=path)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        return cls(data=cloudpickle.loads(blob))

    # ---- conversions ----

    def to_dict(self) -> dict:
        if self._data is not None:
            return self._data
        assert self._directory is not None
        with open(os.path.join(self._directory, "checkpoint.pkl"), "rb") as f:
            return cloudpickle.load(f)

    def to_bytes(self) -> bytes:
        return cloudpickle.dumps(self.to_dict())

    def to_directory(self, path: str | None = None) -> str:
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._directory is not None:
            if os.path.abspath(self._directory) != os.path.abspath(path):
                shutil.copytree(self._directory, path, dirs_exist_ok=True)
        else:
            tmp = os.path.join(path, f".tmp.{os.getpid()}.{time.monotonic_ns()}")
            with open(tmp, "wb") as f:
                cloudpickle.dump(self._data, f)
            os.replace(tmp, os.path.join(path, "checkpoint.pkl"))
        if self.metadata:
            import json

            with open(os.path.join(path, "metadata.json"), "w") as f:
                json.dump(self.metadata, f, default=str)
        return path

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._directory}"
        return f"Checkpoint({kind})"


def checkpoint_from_tensors(tensors: dict, **extra) -> Checkpoint:
    """Host-transfer a (nested) dict of tensors into a Checkpoint: each tensor
    becomes a numpy array; a dtype numpy lacks (bfloat16) is kept bit for bit
    as an integer view beside its dtype's name."""
    return Checkpoint.from_dict({"tensors": _map_tensors(tensors, HostTensor.from_tensor), **extra})


def tensors_from_checkpoint(checkpoint: Checkpoint, device="cuda") -> dict:
    """The dict of tensors ``checkpoint_from_tensors`` stored, on ``device``:
    the card unless the caller asks for the CPU. Raises when asked for a card
    and this process has none."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to restore onto the CPU")
    return _map_tensors(checkpoint.to_dict()["tensors"], lambda h: h.to_tensor(device))


class HostTensor:
    """A tensor's bytes as numpy, plus its torch dtype's name."""

    __slots__ = ("array", "dtype")

    def __init__(self, array, dtype: str):
        self.array = array
        self.dtype = dtype

    @classmethod
    def from_tensor(cls, t) -> "HostTensor":
        from ray_tpu_torch._private.serialization import tensor_to_numpy

        return cls(*tensor_to_numpy(t))

    def to_tensor(self, device):
        from ray_tpu_torch._private.serialization import tensor_from_numpy

        return tensor_from_numpy(self.array, self.dtype).to(device)


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree)
