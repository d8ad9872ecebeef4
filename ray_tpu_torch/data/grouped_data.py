"""GroupedData (reference: python/ray/data/grouped_data.py)."""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data._internal import shuffle as shuffle_mod
from ray_tpu_torch.data._internal.logical_plan import AllToAll, MapTransform
from ray_tpu_torch.data.block import BlockAccessor


class GroupedData:
    def __init__(self, dataset, key: Optional[str]):
        self._dataset = dataset
        self._key = key

    def aggregate(self, *aggs):
        from ray_tpu_torch.data.dataset import Dataset

        key = self._key
        return Dataset(AllToAll(
            name="Aggregate",
            input_op=self._dataset._plan,
            bulk_fn=lambda bundles: shuffle_mod.hash_aggregate(bundles, key, list(aggs)),
        ))

    def count(self):
        return self.aggregate(agg_mod.Count())

    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        """Shuffle rows of each group together, then apply fn per group."""
        from ray_tpu_torch.data.dataset import Dataset

        key = self._key

        def regroup(bundles):
            return shuffle_mod._shuffle(
                bundles,
                shuffle_mod._map_hash,
                (max(1, len(bundles)), key),
                shuffle_mod._reduce_concat,
                (None,),
                max(1, len(bundles)),
            )

        shuffled = Dataset(AllToAll(name="GroupShuffle", input_op=self._dataset._plan, bulk_fn=regroup))

        def block_fn(block):
            acc = BlockAccessor.for_block(block)
            if acc.num_rows() == 0:
                return block
            sorted_block = acc.sort(key)
            sacc = BlockAccessor.for_block(sorted_block)
            keys = sorted_block[key].tolist()
            outs, start = [], 0
            for i in range(1, len(keys) + 1):
                if i == len(keys) or keys[i] != keys[start]:
                    group = sacc.slice(start, i)
                    out = fn(BlockAccessor.for_block(group).to_batch(batch_format))
                    outs.append(BlockAccessor.batch_to_block(out))
                    start = i
            return BlockAccessor.concat(outs)

        return Dataset(MapTransform(name="MapGroups", input_op=shuffled._plan, block_fn=block_fn))
