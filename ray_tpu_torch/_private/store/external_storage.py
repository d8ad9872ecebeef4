"""Pluggable external storage for object spilling.

Analog of the reference's external storage seam
(python/ray/_private/external_storage.py:246): the store daemon spills
sealed objects through an ``ExternalStorage`` implementation selected by
``RAY_TPU_TORCH_OBJECT_SPILLING_CONFIG`` (JSON, same shape as the reference's
``object_spilling_config``):

    {"type": "filesystem", "params": {"directory_path": "<directory>"}}
    {"type": "smart_open", "params": {"uri_prefix": "s3://bucket/spill"}}

``filesystem`` is the default and fully supported. ``smart_open`` needs the
smart_open package (network storage) — not in this image, so it raises with
guidance, exactly like the reference without the extra installed. Custom
backends register via ``register_external_storage`` (the plugin seam the
reference exposes by class path).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable

logger = logging.getLogger(__name__)


class ExternalStorage:
    """One spilled object = one handle. Implementations must be safe for
    concurrent puts of distinct objects (the daemon serializes per-object)."""

    def put(self, object_id: str, data: bytes) -> str:
        """Persist; returns an opaque handle used for get/delete."""
        raise NotImplementedError

    def get(self, handle: str) -> bytes:
        raise NotImplementedError

    def delete(self, handle: str) -> None:
        raise NotImplementedError


class FileSystemStorage(ExternalStorage):
    """Default: atomic tmp+rename files under a local directory."""

    def __init__(self, directory_path: str):
        self.directory = directory_path
        os.makedirs(directory_path, exist_ok=True)

    def put(self, object_id: str, data: bytes) -> str:
        path = os.path.join(self.directory, object_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def get(self, handle: str) -> bytes:
        with open(handle, "rb") as f:
            return f.read()

    def delete(self, handle: str) -> None:
        try:
            os.unlink(handle)
        except OSError:
            pass


class SmartOpenStorage(ExternalStorage):
    """Remote-URI spilling via smart_open (reference:
    external_storage.py:246 ExternalStorageSmartOpenImpl)."""

    def __init__(self, uri_prefix: str, **open_kwargs):
        try:
            from smart_open import open as smart_open_fn  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "object_spilling_config type 'smart_open' requires the "
                "smart_open package (and the relevant cloud SDK); it is not "
                "installed in this image. Use type 'filesystem', or install "
                "smart_open on every node."
            ) from e
        self._open = smart_open_fn
        self.uri_prefix = uri_prefix.rstrip("/")
        self.open_kwargs = open_kwargs

    def put(self, object_id: str, data: bytes) -> str:
        uri = f"{self.uri_prefix}/{object_id}"
        with self._open(uri, "wb", **self.open_kwargs) as f:
            f.write(data)
        return uri

    def get(self, handle: str) -> bytes:
        with self._open(handle, "rb", **self.open_kwargs) as f:
            return f.read()

    def delete(self, handle: str) -> None:
        # smart_open has no uniform delete; best-effort per scheme.
        try:
            if handle.startswith("file://") or os.path.exists(handle):
                os.unlink(handle.replace("file://", ""))
        except OSError:
            pass


_factories: dict[str, Callable[..., ExternalStorage]] = {
    "filesystem": FileSystemStorage,
    "smart_open": SmartOpenStorage,
}


def register_external_storage(type_name: str, factory: Callable[..., ExternalStorage]):
    """Custom backend seam (reference: custom external storage class path)."""
    _factories[type_name] = factory


def create_external_storage(default_dir: str) -> ExternalStorage:
    """Build the configured storage; default = filesystem under the session
    spill dir. ``type`` may also be a dotted class path ("pkg.mod.Class") —
    the process-safe form for store daemons running as separate OS
    processes that never executed a register_external_storage() call
    (reference: custom external storage by class path)."""
    raw = os.environ.get("RAY_TPU_TORCH_OBJECT_SPILLING_CONFIG", "")
    if not raw:
        return FileSystemStorage(default_dir)
    try:
        cfg = json.loads(raw)
        type_name = cfg.get("type", "filesystem")
        factory = _factories.get(type_name)
        if factory is None and "." in type_name:
            import importlib

            module_name, _, cls_name = type_name.rpartition(".")
            factory = getattr(importlib.import_module(module_name), cls_name)
        if factory is None:
            raise ValueError(
                f"unknown object spilling storage type {type_name!r}; "
                f"registered: {sorted(_factories)} (or use a dotted class path)"
            )
        params = dict(cfg.get("params") or {})
        if type_name == "filesystem":
            params.setdefault("directory_path", default_dir)
        return factory(**params)
    except Exception as e:
        raise ValueError(
            f"invalid RAY_TPU_TORCH_OBJECT_SPILLING_CONFIG ({raw!r}): {e}"
        ) from e
