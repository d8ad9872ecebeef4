"""MongoDB datasource (reference: mongo_datasource.py).

Partitions a collection into parallel read tasks over an _id-sorted
skip/limit sharding (stable across cursors), applying the user pipeline
per shard. Requires ``pymongo`` unless a ``collection_factory`` is
injected (the import gate mirrors the reference's optional-dependency
behavior); the partitioning logic is exercised against a stand-in
collection in the tests.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ray_tpu_torch.data.block import BlockAccessor, BlockMetadata
from ray_tpu_torch.data.datasource.datasource import Datasource, ReadTask


class MongoDatasource(Datasource):
    def __init__(self, uri: str, database: str, collection: str,
                 *, pipeline: Optional[list] = None,
                 collection_factory: Optional[Callable] = None):
        """``collection_factory``: () -> collection-like object exposing
        count_documents/find/aggregate — defaults to a pymongo client
        (gated on the package being installed)."""
        if collection_factory is None:
            try:
                import pymongo  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "read_mongo requires the 'pymongo' package, which is not "
                    "installed in this environment. Install it on the node "
                    "image, or pass collection_factory= for a custom client."
                ) from e

            def collection_factory():
                import pymongo

                return pymongo.MongoClient(uri)[database][collection]

        self._factory = collection_factory
        self._pipeline = pipeline or []

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        factory = self._factory
        pipeline = self._pipeline
        coll = factory()
        total = coll.count_documents({})
        parallelism = max(1, min(parallelism, max(total, 1)))
        chunk = (total + parallelism - 1) // parallelism if total else 1
        tasks = []
        for i in range(parallelism):
            skip, limit = i * chunk, chunk

            def read(skip=skip, limit=limit):
                c = factory()
                # Shard the COLLECTION deterministically ($sort by _id makes
                # the skip/limit windows stable across separate cursors —
                # natural order isn't), then run the user pipeline on each
                # shard. Pipelines that expand cardinality ($unwind) are
                # safe: every input document lands in exactly one shard.
                stages = [
                    {"$sort": {"_id": 1}},
                    {"$skip": skip},
                    {"$limit": limit},
                ] + list(pipeline)
                rows = [
                    {k: v for k, v in doc.items() if k != "_id"}
                    for doc in c.aggregate(stages)
                ]
                if rows:
                    yield BlockAccessor.batch_to_block(rows)

            tasks.append(ReadTask(read, BlockMetadata(num_rows=-1, size_bytes=-1)))
        return tasks
