"""DatasetPipeline — epoch/window pipelining (analog of reference
python/ray/data/dataset_pipeline.py).

A thin user-facing surface over the existing streaming executor: a pipeline
is a *factory* of per-window Datasets, re-invoked per epoch, so nothing is
materialized beyond the window in flight —

    pipe = ray_tpu_torch.data.range(10_000).window(blocks_per_window=4).repeat(3)
    for epoch_ds in pipe.iter_epochs():          # 3 epochs
        for batch in epoch_ds.iter_batches():    # windows stream through
            ...

``Dataset.window`` groups streamed block bundles into window Datasets;
``Dataset.repeat`` re-executes the (lazy) plan per epoch. Per-window
transforms (``map_batches`` etc.) are applied lazily to each window as it is
formed.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, Optional

from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data._internal.logical_plan import InputData


def _windows_of(ds: Dataset, blocks_per_window: int) -> Iterator[Dataset]:
    """Stream the dataset's block bundles, grouping every ``blocks_per_window``
    into a window Dataset. Pulls from the streaming executor — the source is
    never materialized wholesale."""
    batch: list = []
    for bundle in ds.iter_internal_refs():
        batch.append(bundle)
        if len(batch) >= blocks_per_window:
            yield _window_dataset(batch)
            batch = []
    if batch:
        yield _window_dataset(batch)


def _window_dataset(bundles: list) -> Dataset:
    w = Dataset(InputData(name="InputData", input_op=None, bundles=list(bundles)))
    w._cached_bundles = list(bundles)
    return w


class DatasetPipeline:
    """A lazy sequence of window Datasets, optionally repeated for epochs.

    ``_make_windows`` is re-invoked per epoch, so a lazy source re-executes
    (fresh reads, bounded memory) rather than replaying a materialized copy.
    """

    def __init__(
        self,
        make_windows: Callable[[], Iterator[Dataset]],
        *,
        epochs: Optional[int] = 1,
        length: Optional[int] = None,
    ):
        self._make_windows = make_windows
        self._epochs = epochs  # None = repeat forever
        self._length = length  # windows per epoch, if known

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_dataset(ds: Dataset, blocks_per_window: int) -> "DatasetPipeline":
        if blocks_per_window < 1:
            raise ValueError("blocks_per_window must be >= 1")
        return DatasetPipeline(lambda: _windows_of(ds, blocks_per_window))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Repeat the pipeline's windows for ``times`` epochs (None = forever).
        Each epoch re-invokes the window factory — a lazy plan re-executes."""
        if self._epochs not in (1, None) or (times is not None and times < 1):
            raise ValueError("repeat() takes times >= 1 and applies once")
        return DatasetPipeline(self._make_windows, epochs=times, length=self._length)

    # -- per-window transforms ----------------------------------------------

    def foreach_window(self, fn: Callable[[Dataset], Dataset]) -> "DatasetPipeline":
        make = self._make_windows

        def mapped():
            for w in make():
                yield fn(w)

        return DatasetPipeline(mapped, epochs=self._epochs, length=self._length)

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self.foreach_window(lambda w: w.map(fn, **kw))

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self.foreach_window(lambda w: w.map_batches(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self.foreach_window(lambda w: w.filter(fn, **kw))

    def random_shuffle_each_window(self, *, seed: Optional[int] = None) -> "DatasetPipeline":
        return self.foreach_window(lambda w: w.random_shuffle(seed=seed))

    # -- iteration -----------------------------------------------------------

    def _epoch_iter(self) -> Iterator[Iterator[Dataset]]:
        count = itertools.count() if self._epochs is None else range(self._epochs)
        for _ in count:
            yield self._make_windows()

    def iter_epochs(self) -> Iterator["_EpochDataset"]:
        """One `_EpochDataset` per epoch — a Dataset-like view chaining that
        epoch's windows."""
        for windows in self._epoch_iter():
            yield _EpochDataset(windows)

    def iter_datasets(self) -> Iterator[Dataset]:
        """Every window Dataset across all epochs, in order."""
        for windows in self._epoch_iter():
            yield from windows

    def iter_rows(self) -> Iterator[dict]:
        for w in self.iter_datasets():
            yield from w.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for w in self.iter_datasets():
            yield from w.iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        for w in self.iter_datasets():
            yield from w.iter_torch_batches(**kw)

    def stats(self) -> str:
        return f"DatasetPipeline(epochs={self._epochs}, windows_per_epoch={self._length or 'unknown'})"


class _EpochDataset:
    """One epoch's windows, exposed with the Dataset iteration surface."""

    def __init__(self, windows: Iterator[Dataset]):
        self._windows = windows

    def iter_windows(self) -> Iterator[Dataset]:
        return self._windows

    def iter_rows(self) -> Iterator[dict]:
        for w in self._windows:
            yield from w.iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        for w in self._windows:
            yield from w.iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        for w in self._windows:
            yield from w.iter_torch_batches(**kw)
