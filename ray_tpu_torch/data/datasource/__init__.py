from ray_tpu_torch.data.datasource.datasource import (  # noqa: F401
    BinaryDatasource,
    CSVDatasource,
    Datasource,
    FileBasedDatasource,
    ImageDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    TextDatasource,
    TFRecordsDatasource,
)
