"""ray_tpu_torch.data — lazy, streaming, distributed datasets.

The port of the JAX package's ``data``, itself an analog of the reference's
Ray Data (python/ray/data/): blocks are dicts of numpy arrays (``block.py``;
no pyarrow or pandas needed) moved by ref through the object store;
transforms build a lazy plan executed by a streaming task/actor-pool
executor; iteration yields numpy, pandas or arrow batches, or
``torch.Tensor`` batches on the card (``iter_torch_batches``).
"""

from ray_tpu_torch.data import aggregate  # noqa: F401
from ray_tpu_torch.data._internal.executor import ActorPoolStrategy  # noqa: F401
from ray_tpu_torch.data.aggregate import AbsMax, AggregateFn, Count, Max, Mean, Min, Std, Sum  # noqa: F401
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata  # noqa: F401
from ray_tpu_torch.data.context import DataContext  # noqa: F401
from ray_tpu_torch.data.dataset import Dataset  # noqa: F401
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline  # noqa: F401
from ray_tpu_torch.data.grouped_data import GroupedData  # noqa: F401
from ray_tpu_torch.data.iterator import DataIterator  # noqa: F401
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_mongo,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.datasource.partitioning import (  # noqa: F401
    DefaultFileMetadataProvider,
    FastFileMetadataProvider,
    FileMetadataProvider,
    ParquetMetadataProvider,
    Partitioning,
)

__all__ = [
    "ActorPoolStrategy",
    "AggregateFn",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "Count",
    "DataContext",
    "DataIterator",
    "Dataset",
    "DatasetPipeline",
    "GroupedData",
    "Max",
    "Mean",
    "Min",
    "Std",
    "Sum",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_images",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
]
