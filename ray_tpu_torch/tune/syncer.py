"""Experiment-directory syncing (analog of reference python/ray/tune/syncer.py).

The reference syncs trial/experiment state to cloud storage or shared NFS so
a new head node can `Tuner.restore` an interrupted sweep. Here:
- local / NFS / file:// targets sync with a real directory copy;
- cloud URI schemes (s3:// gs:// ...) are gated — no cloud SDK is among the
  port's dependencies — with the same Syncer plugin seam the reference exposes, so a
  deployment with boto/gcsfs installs a custom Syncer and keeps the API.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass


class Syncer:
    """Plugin seam (reference: tune/syncer.py Syncer)."""

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        raise NotImplementedError

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        raise NotImplementedError


class _LocalDirSyncer(Syncer):
    """rsync-style copy for filesystem targets (NFS mounts, file:// URIs)."""

    def _copy(self, src: str, dst: str) -> bool:
        if not os.path.isdir(src):
            return False
        os.makedirs(dst, exist_ok=True)
        for root, _dirs, files in os.walk(src):
            rel = os.path.relpath(root, src)
            out = os.path.join(dst, rel) if rel != "." else dst
            os.makedirs(out, exist_ok=True)
            for fname in files:
                s = os.path.join(root, fname)
                d = os.path.join(out, fname)
                # Skip files whose size+mtime are unchanged (rsync heuristic).
                try:
                    if os.path.exists(d):
                        ss, ds = os.stat(s), os.stat(d)
                        if ss.st_size == ds.st_size and ss.st_mtime <= ds.st_mtime:
                            continue
                    shutil.copy2(s, d)
                except OSError:
                    pass
        return True

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        return self._copy(local_dir, _strip_file_scheme(remote_dir))

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        return self._copy(_strip_file_scheme(remote_dir), local_dir)


def _strip_file_scheme(uri: str) -> str:
    return uri[len("file://"):] if uri.startswith("file://") else uri


_CLOUD_SCHEMES = ("s3://", "gs://", "gcs://", "az://", "abfs://", "hdfs://")


def get_syncer(upload_dir: str | None, custom: Syncer | None = None) -> Syncer | None:
    if custom is not None:
        return custom
    if not upload_dir:
        return None
    if upload_dir.startswith(_CLOUD_SCHEMES):
        raise ValueError(
            f"cloud sync target {upload_dir!r} needs a cloud SDK that is not "
            "among the port's dependencies; pass SyncConfig(syncer=YourSyncer()) "
            "backed by your storage client (reference: custom Syncer plugin)"
        )
    return _LocalDirSyncer()


@dataclass
class SyncConfig:
    """Analog of reference tune/syncer.py SyncConfig."""

    upload_dir: str | None = None
    syncer: Syncer | None = None
    sync_period_s: float = 300.0


class SyncManager:
    """Throttled sync_up driver used by the Tune controller."""

    def __init__(self, config: SyncConfig, experiment_dir: str, experiment_name: str):
        self.config = config
        self.experiment_dir = experiment_dir
        self.remote_dir = (
            os.path.join(config.upload_dir, experiment_name) if config.upload_dir else None
        )
        self._syncer = get_syncer(config.upload_dir, config.syncer)
        self._last = 0.0

    @property
    def enabled(self) -> bool:
        return self._syncer is not None and self.remote_dir is not None

    def maybe_sync_up(self, force: bool = False) -> bool:
        if not self.enabled:
            return False
        now = time.monotonic()
        if not force and now - self._last < self.config.sync_period_s:
            return False
        self._last = now
        return self._syncer.sync_up(self.experiment_dir, self.remote_dir)
