"""CSV read/write option builders.

A copy of ``cylon_tpu/io/csv_config.py`` (reference:
cpp/src/cylon/io/csv_read_config.hpp:27-146 — a fluent builder
multiple-inheriting Arrow Read/Parse/ConvertOptions via CSVConfigHolder,
io/csv_read_config_holder.hpp:28-36 — and io/csv_write_config.hpp:24-39).
The holder maps onto ``pyarrow.csv`` option objects at read time; pyarrow
is imported only there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class CSVReadOptions:
    """Fluent CSV read options (reference: io/csv_read_config.hpp:35-146).

    Every method returns ``self`` so options chain like the reference's
    builder: ``CSVReadOptions().UseThreads(True).WithDelimiter('|')``.
    """

    def __init__(self):
        self.concurrent_file_reads: bool = True
        self.use_threads: bool = True
        self.delimiter: str = ","
        self.ignore_emptylines: bool = True
        self.autogenerate_column_names: bool = False
        self.column_names: Optional[List[str]] = None
        self.block_size: int = 1 << 20
        self.use_quoting: bool = True   # Arrow's ParseOptions default
        self.quote_char: str = '"'
        self.double_quote: bool = True
        self.use_escaping: bool = False
        self.escape_char: str = "\\"
        self.newlines_in_values: bool = False
        self.skip_rows: int = 0
        self.column_types: Dict[str, object] = {}
        self.null_values: Optional[List[str]] = None
        self.true_values: Optional[List[str]] = None
        self.false_values: Optional[List[str]] = None
        self.strings_can_be_null: bool = False
        self.include_columns: Optional[List[str]] = None
        self.include_missing_columns: bool = False
        self.string_width: Optional[int] = None  # device byte-matrix width

    # -- builder methods (names mirror csv_read_config.hpp) -----------------
    def ConcurrentFileReads(self, v: bool) -> "CSVReadOptions":
        self.concurrent_file_reads = v
        return self

    def IsConcurrentFileReads(self) -> bool:
        return self.concurrent_file_reads

    def UseThreads(self, v: bool) -> "CSVReadOptions":
        self.use_threads = v
        return self

    def WithDelimiter(self, d: str) -> "CSVReadOptions":
        self.delimiter = d
        return self

    def IgnoreEmptyLines(self) -> "CSVReadOptions":
        self.ignore_emptylines = True
        return self

    def AutoGenerateColumnNames(self) -> "CSVReadOptions":
        self.autogenerate_column_names = True
        return self

    def ColumnNames(self, names: Sequence[str]) -> "CSVReadOptions":
        self.column_names = list(names)
        return self

    def BlockSize(self, n: int) -> "CSVReadOptions":
        self.block_size = int(n)
        return self

    def UseQuoting(self, v: bool = True) -> "CSVReadOptions":
        self.use_quoting = v
        return self

    def WithQuoteChar(self, c: str) -> "CSVReadOptions":
        self.quote_char = c
        self.use_quoting = True
        return self

    def DoubleQuote(self) -> "CSVReadOptions":
        self.double_quote = True
        return self

    def UseEscaping(self) -> "CSVReadOptions":
        self.use_escaping = True
        return self

    def EscapingCharacter(self, c: str) -> "CSVReadOptions":
        self.escape_char = c
        self.use_escaping = True
        return self

    def HasNewLinesInValues(self) -> "CSVReadOptions":
        self.newlines_in_values = True
        return self

    def SkipRows(self, n: int) -> "CSVReadOptions":
        self.skip_rows = int(n)
        return self

    def WithColumnTypes(self, types: Dict[str, object]) -> "CSVReadOptions":
        self.column_types = dict(types)
        return self

    def NullValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self.null_values = list(vals)
        return self

    def TrueValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self.true_values = list(vals)
        return self

    def FalseValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self.false_values = list(vals)
        return self

    def StringsCanBeNull(self) -> "CSVReadOptions":
        self.strings_can_be_null = True
        return self

    def IncludeColumns(self, cols: Sequence[str]) -> "CSVReadOptions":
        self.include_columns = list(cols)
        return self

    def IncludeMissingColumns(self) -> "CSVReadOptions":
        self.include_missing_columns = True
        return self

    def StringWidth(self, width: int) -> "CSVReadOptions":
        """Extension: the byte width string columns are padded to on the
        device (see the ``cylon_tpu_torch.column`` docstring)."""
        self.string_width = int(width)
        return self

    # -- pyarrow holders (the CSVConfigHolder role) -------------------------
    def to_pyarrow(self):
        import pyarrow.csv as pc

        read = pc.ReadOptions(
            use_threads=self.use_threads,
            block_size=self.block_size,
            skip_rows=self.skip_rows,
            column_names=self.column_names,
            autogenerate_column_names=self.autogenerate_column_names,
        )
        parse = pc.ParseOptions(
            delimiter=self.delimiter,
            quote_char=self.quote_char if self.use_quoting else False,
            double_quote=self.double_quote,
            escape_char=self.escape_char if self.use_escaping else False,
            newlines_in_values=self.newlines_in_values,
            ignore_empty_lines=self.ignore_emptylines,
        )
        ctypes = None
        if self.column_types:
            import pyarrow as pa

            from .. import dtypes as dt

            ctypes = {}
            for name, t in self.column_types.items():
                if isinstance(t, dt.DataType):
                    ctypes[name] = dt.to_arrow_type(t)
                elif isinstance(t, pa.DataType):
                    ctypes[name] = t
                else:
                    ctypes[name] = pa.from_numpy_dtype(t)
        convert = pc.ConvertOptions(
            column_types=ctypes,
            null_values=self.null_values,
            true_values=self.true_values,
            false_values=self.false_values,
            strings_can_be_null=self.strings_can_be_null,
            include_columns=self.include_columns,
            include_missing_columns=self.include_missing_columns,
        )
        return read, parse, convert


class CSVWriteOptions:
    """reference: io/csv_write_config.hpp:24-39."""

    def __init__(self):
        self.delimiter: str = ","
        self.column_names: Optional[List[str]] = None

    def WithDelimiter(self, d: str) -> "CSVWriteOptions":
        self.delimiter = d
        return self

    def ColumnNames(self, names: Sequence[str]) -> "CSVWriteOptions":
        self.column_names = list(names)
        return self

    def GetDelimiter(self) -> str:
        return self.delimiter


class ParquetOptions:
    """reference: io/parquet_config.{hpp,cpp} (BUILD_CYLON_PARQUET path)."""

    def __init__(self):
        self.concurrent_file_reads: bool = True
        self.chunk_size: int = 1 << 20
        self.string_width: Optional[int] = None

    def ConcurrentFileReads(self, v: bool) -> "ParquetOptions":
        self.concurrent_file_reads = v
        return self

    def IsConcurrentFileReads(self) -> bool:
        return self.concurrent_file_reads

    def ChunkSize(self, n: int) -> "ParquetOptions":
        self.chunk_size = int(n)
        return self

    def StringWidth(self, width: int) -> "ParquetOptions":
        self.string_width = int(width)
        return self
