"""Readers: records to FeatureTable (counterpart of
``transmogrifai_tpu.readers``)."""
from .readers import (  # noqa: F401
    AvroReader, CSVAutoReader, CSVReader, DataReaders, Frame, FrameReader,
    ParquetReader, Reader, StreamingDataReader, frame_to_table, read_csv, series_to_column,
)
