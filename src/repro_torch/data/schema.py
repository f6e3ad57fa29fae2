"""Columnar record batches — the unit the filter operator consumes.

The paper's dataset has 3 attributes (date, integer, string); we carry any
number of columns as a dense float32 matrix [C, R] (column-major access is
what both the vectorized chain and the Pallas kernel want). String columns
are pre-hashed into [0, 2^20) by the generator (exact in f32).
"""

from __future__ import annotations

import dataclasses

import numpy as np

COL_DATE = 0
COL_INT = 1
COL_STR = 2
DEFAULT_COLUMNS = ("date", "int", "str_hash")


@dataclasses.dataclass
class RecordBatch:
    """One tile of the stream. ``row_offset`` is the global index of row 0 —
    it drives the deterministic-stride monitor sampling and makes the stream
    restartable from a checkpoint."""

    columns: np.ndarray                 # f32[C, R]
    row_offset: int
    names: tuple = DEFAULT_COLUMNS

    @property
    def n_rows(self) -> int:
        return int(self.columns.shape[1])

    @property
    def n_cols(self) -> int:
        return int(self.columns.shape[0])

    def select(self, mask: np.ndarray) -> np.ndarray:
        return self.columns[:, mask]
