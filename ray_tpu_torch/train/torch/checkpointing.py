"""Sharded checkpoints for torch training, on ``torch.distributed.checkpoint``.

Counterpart of ``ray_tpu/train/jax/checkpointing.py`` (orbax there): a
nested dict of tensors and DTensors is saved without gathering it to one
rank — each rank writes its own shards — and restored onto any layout,
another mesh included, as ``like`` dictates.

- ``save_sharded(path, tree)`` — safe to call from every rank of a process
  group (the save is collective), or from one process without one.
- ``restore_sharded(path, like=...)`` — each leaf restored into the layout
  of ``like``'s leaf (a DTensor's mesh and placements, or a plain tensor's
  device); the data move at read. ``like=None`` restores every tensor whole,
  on the CPU.
- ``TrainCheckpointer`` — step-numbered checkpoint dirs with retention (keep
  the newest K, by save recency).

The reference's durability rules hold: an overwrite is written to a sibling
``.saving`` directory before the old checkpoint moves aside to ``.old``, a
read finishes a swap that a crash interrupted, and directory moves happen on
rank 0 only, fenced by barriers.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional


def _proc0() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """Sync point of every rank; nothing without a process group."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _recover_interrupted_swap(path: str) -> None:
    """A crash between save_sharded's two renames leaves the data at
    ``path + ".old"`` with nothing at ``path`` — finish the swap."""
    old = path + ".old"
    if not os.path.exists(path) and os.path.exists(old) and _proc0():
        os.rename(old, path)


def save_sharded(path: str, tree: Any) -> str:
    """Write a sharded checkpoint of ``tree`` (a nested dict of tensors)
    at ``path``.

    Overwrite is durable-then-swap: the new checkpoint is fully written to a
    sibling tmp dir before the old one is replaced, so a crash mid-save never
    loses the previous checkpoint.
    """
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    tmp = path + ".saving"
    if _proc0():
        _recover_interrupted_swap(path)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    _barrier()
    dcp.save(tree, checkpoint_id=tmp)  # collective across ranks; returns once written
    _barrier()
    if _proc0():
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier()
    return path


def _empty_like(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def _whole_from_metadata(path: str) -> dict:
    """Empty CPU tensors of every saved tensor's full shape and dtype, nested
    as saved (DCP flattens nested dicts to dotted keys)."""
    import torch
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    tree: dict = {}
    for key, md in FileSystemReader(path).read_metadata().state_dict_metadata.items():
        if not isinstance(md, TensorStorageMetadata):
            raise TypeError(f"{path}: entry {key!r} is not a tensor; restore it with like=")
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.empty(md.size, dtype=md.properties.dtype)
    return tree


def restore_sharded(path: str, like: Any = None) -> Any:
    """Load a checkpoint; ``like`` dictates placement.

    ``like`` is a nested dict of the leaves' targets: a DTensor (restored
    with its mesh and placements, which may differ from those at save
    time), or a plain tensor (restored whole on its device). ``like=None``
    restores every tensor whole on the CPU.
    """
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    _recover_interrupted_swap(path)
    _barrier()
    tree = _whole_from_metadata(path) if like is None else _empty_like(like)
    dcp.load(tree, checkpoint_id=path)
    return tree


class TrainCheckpointer:
    """Step-numbered sharded checkpoints with top-K retention.

    save(step, tree) -> <dir>/step_<N>; latest_step()/restore(step, like=)
    pick them back up. Retention and "latest" rank by SAVE RECENCY
    (directory mtime), not step number — after a rollback, save(10) with a
    stale step_12 on disk must neither delete itself nor resume from the
    abandoned future step.
    """

    _STEP_RE = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        """Steps ordered oldest-save-first (mtime, step as tiebreak)."""
        out = []
        for name in os.listdir(self.directory):
            m = self._STEP_RE.match(name)
            if m:
                full = os.path.join(self.directory, name)
                try:
                    mtime = os.path.getmtime(full)
                except OSError:
                    continue  # reaped concurrently
                out.append((mtime, int(m.group(1))))
        return [step for _, step in sorted(out)]

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, tree: Any) -> str:
        path = save_sharded(self._step_dir(step), tree)
        if _proc0():  # retention is a rank-0 filesystem concern
            for old in self._steps()[: -self.keep] if self.keep > 0 else []:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        _barrier()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_sharded(self._step_dir(step), like=like)
