"""Series: one named, typed column.

The port of ``cylon_tpu/series.py`` (reference: python/pycylon/series.py:
25-76 — a named Column wrapper with id/data/dtype/shape accessors and
scalar indexing).  A Series built from host data goes to the card unless
``device=`` names another device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import dtypes
from .column import Column, to_numpy as _col_to_numpy
from .status import Code, CylonError


class Series:
    """reference: series.py:25-76."""

    def __init__(self, series_id: Optional[str] = None, data=None,
                 data_type: Optional[dtypes.DataType] = None, *,
                 column: Optional[Column] = None,
                 row_count: Optional[int] = None, device=None):
        from .column import from_numpy

        self._id = series_id or "s"
        if column is not None:
            if row_count is None:
                raise CylonError(
                    Code.Invalid,
                    "Series over a Column needs row_count (capacity includes "
                    "zeroed padding rows)")
            self._column = column
            self._count = int(row_count)
        else:
            arr = np.asarray(data)
            self._column = from_numpy(arr, dtype=data_type, device=device)
            self._count = len(arr)

    @property
    def id(self) -> str:
        return self._id

    @property
    def name(self) -> str:
        return self._id

    @property
    def data(self) -> Column:
        return self._column

    @property
    def dtype(self) -> dtypes.DataType:
        return self._column.dtype

    @property
    def shape(self):
        return (self._count,)

    def __len__(self) -> int:
        return self._count

    def to_numpy(self) -> np.ndarray:
        return _col_to_numpy(self._column, self._count)

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self.to_numpy(), name=self._id)

    def __getitem__(self, item):
        return self.to_numpy()[item]

    def __repr__(self) -> str:
        return (f"Series(id={self._id!r}, dtype={self.dtype}, "
                f"len={self._count})\n{self.to_numpy()!r}")
