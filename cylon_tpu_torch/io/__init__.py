"""I/O layer: CSV/Parquet ingest + egress (reference: cpp/src/cylon/io/),
the port of ``cylon_tpu/io``."""
from .arrow_io import (frame_from_ipc_bytes, frame_to_ipc_bytes, read_csv,
                       read_parquet, reader_counts, reset_reader_counts,
                       write_csv, write_parquet)
from .csv_config import CSVReadOptions, CSVWriteOptions, ParquetOptions

__all__ = [
    "read_csv", "read_parquet", "write_csv", "write_parquet",
    "CSVReadOptions", "CSVWriteOptions", "ParquetOptions",
    "frame_to_ipc_bytes", "frame_from_ipc_bytes", "reader_counts",
    "reset_reader_counts",
]
