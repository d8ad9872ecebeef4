"""Offline RL IO.

Analog of the reference's rllib/offline/ (json_writer.py, json_reader.py,
dataset_reader.py): write rollouts as JSON-lines episode rows; read them back
as SampleBatches with discounted return-to-go targets for offline losses
(BC/MARWIL); or read from a ray_tpu_torch.data Dataset.
"""

from __future__ import annotations

import glob as glob_mod
import json
import os
from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import (
    ACTIONS,
    DONES,
    EPS_ID,
    OBS,
    REWARDS,
    VALUE_TARGETS,
    SampleBatch,
)


class JsonWriter:
    """Append SampleBatches to JSON-lines files (reference: json_writer.py)."""

    def __init__(self, path: str, max_file_size_rows: int = 100_000):
        self.path = path
        os.makedirs(path, exist_ok=True)
        # Continue numbering past existing files so a second writer on the
        # same directory creates new files instead of appending duplicates.
        existing = sorted(glob_mod.glob(os.path.join(path, "output-*.json")))
        self._file_idx = (
            max(int(os.path.basename(f)[len("output-") : -len(".json")]) for f in existing) + 1
            if existing
            else 0
        )
        self._rows_in_file = 0
        self._max_rows = max_file_size_rows
        self._f = None

    def _ensure_file(self):
        if self._f is None or self._rows_in_file >= self._max_rows:
            if self._f is not None:
                self._f.close()
            self._f = open(
                os.path.join(self.path, f"output-{self._file_idx:05d}.json"), "a"
            )
            self._file_idx += 1
            self._rows_in_file = 0

    def write(self, batch: SampleBatch):
        self._ensure_file()
        n = len(batch)
        keys = list(batch.keys())
        for i in range(n):
            row = {}
            for k in keys:
                v = batch[k][i]
                row[k] = v.tolist() if hasattr(v, "tolist") else v
            self._f.write(json.dumps(row) + "\n")
            self._rows_in_file += 1
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


def _rows_to_batch(rows: list[dict]) -> SampleBatch:
    if not rows:
        return SampleBatch()
    keys = rows[0].keys()
    return SampleBatch({k: np.asarray([r[k] for r in rows]) for k in keys})


def _add_return_targets(batch: SampleBatch, gamma: float) -> SampleBatch:
    """Discounted return-to-go per episode → VALUE_TARGETS (what offline
    losses regress the value head on)."""
    if VALUE_TARGETS in batch or REWARDS not in batch:
        return batch
    rewards = np.asarray(batch[REWARDS], dtype=np.float64)
    dones = np.asarray(batch.get(DONES, np.zeros(len(rewards), bool)), dtype=bool)
    returns = np.zeros_like(rewards)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        returns[i] = acc
    batch[VALUE_TARGETS] = returns.astype(np.float32)
    return batch


class JsonReader:
    """Load JSON-lines rollout files; serve shuffled minibatches
    (reference: json_reader.py)."""

    def __init__(self, inputs, gamma: float = 0.99, seed: int = 0):
        paths = [inputs] if isinstance(inputs, str) else list(inputs)
        files: list[str] = []
        for p in paths:
            if os.path.isdir(p):
                files += sorted(glob_mod.glob(os.path.join(p, "*.json")))
            else:
                files += sorted(glob_mod.glob(p))
        if not files:
            raise FileNotFoundError(f"no offline data files under {paths}")
        rows: list[dict] = []
        for fpath in files:
            with open(fpath) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
        self.batch = _add_return_targets(_rows_to_batch(rows), gamma)
        self._rng = np.random.default_rng(seed)

    def next(self, batch_size: Optional[int] = None) -> SampleBatch:
        n = len(self.batch)
        if batch_size is None or batch_size >= n:
            return self.batch
        idx = self._rng.choice(n, size=batch_size, replace=False)
        return SampleBatch({k: np.asarray(v)[idx] for k, v in self.batch.items()})


class DatasetReader:
    """Offline data from a ray_tpu_torch.data Dataset of row dicts
    (reference: offline/dataset_reader.py)."""

    def __init__(self, dataset, gamma: float = 0.99, seed: int = 0):
        rows = dataset.take_all()
        self.batch = _add_return_targets(_rows_to_batch(rows), gamma)
        self._rng = np.random.default_rng(seed)

    next = JsonReader.next


class ExternalInputReader:
    """Input reader over a live ``PolicyServerInput`` — train directly from
    external simulators.

    Reference parity: there ``PolicyServerInput`` IS an input reader plugged
    in via ``config.input_`` (``"input": lambda ioctx: PolicyServerInput(...)``,
    rllib/env/policy_server_input.py), so offline-capable algorithms consume
    client-driven episodes instead of files. Here the same seam: the first
    ``next()`` blocks until ``min_episodes`` external episodes have
    completed; every later call drains whatever episodes have finished since
    (min 1, so nothing sits stale). Return targets are computed per drained
    fragment and the rows land in a preallocated FIFO ``ReplayBuffer``
    window (O(fresh) writes, no full-window copies). Sampling is uniform
    with replacement at exactly ``batch_size`` rows, so the training batch
    shape is static from the first step.
    """

    def __init__(
        self,
        server,
        gamma: float = 0.99,
        seed: int = 0,
        min_episodes: int = 1,
        window_rows: int = 50_000,
        poll_interval_s: float = 0.05,
        timeout_s: float = 60.0,
    ):
        from ray_tpu_torch.rllib.utils.replay_buffers import ReplayBuffer

        self._server = server
        self._gamma = gamma
        self._min_episodes = min_episodes
        self._poll = poll_interval_s
        self._timeout = timeout_s
        self._window = ReplayBuffer(window_rows, seed=seed)

    def next(self, batch_size: Optional[int] = None) -> SampleBatch:
        import time as _time

        deadline = _time.monotonic() + self._timeout
        while True:
            # One call drains every completed episode held by the server;
            # after the initial fill, any single finished episode is folded
            # immediately rather than waiting for min_episodes again.
            need = self._min_episodes if len(self._window) == 0 else 1
            fresh = self._server.next_batch(need)
            if fresh is not None:
                fresh = _add_return_targets(fresh, self._gamma)
                n = len(fresh)
                cap = self._window.capacity
                if n > cap:
                    # One drain can exceed the window (many sims ran before
                    # training started): keep only the newest rows —
                    # ReplayBuffer.add would otherwise wrap/clobber (or
                    # raise past 2x capacity).
                    fresh = SampleBatch(
                        {k: np.asarray(v)[n - cap:] for k, v in fresh.items()}
                    )
                self._window.add(fresh)
            if len(self._window) > 0:
                break
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"no external episodes completed within {self._timeout}s"
                )
            _time.sleep(self._poll)
        if batch_size is None:
            batch_size = len(self._window)
        return self._window.sample(batch_size)


def make_input_reader(input_, gamma: float = 0.99, seed: int = 0, **reader_kwargs):
    """Dispatch config.input_ to the right reader — shared by every
    offline-capable algorithm (MARWIL/BC, CQL, CRR): a ray_tpu_torch.data Dataset,
    a live PolicyServerInput (external simulators), or json path(s).

    ``reader_kwargs`` (config.offline_data(input_reader_kwargs=...)) reach
    the constructed reader — e.g. ``timeout_s``/``min_episodes``/
    ``window_rows`` for slow external simulators."""
    if hasattr(input_, "take_all"):
        return DatasetReader(input_, gamma=gamma, seed=seed, **reader_kwargs)
    if hasattr(input_, "next_batch"):
        return ExternalInputReader(input_, gamma=gamma, seed=seed, **reader_kwargs)
    return JsonReader(input_, gamma=gamma, seed=seed, **reader_kwargs)


from ray_tpu_torch.rllib.offline.estimators import (  # noqa: F401,E402
    AlgorithmPolicyAdapter,
    DirectMethod,
    DoublyRobust,
    ImportanceSampling,
    OffPolicyEstimator,
    WeightedImportanceSampling,
)
