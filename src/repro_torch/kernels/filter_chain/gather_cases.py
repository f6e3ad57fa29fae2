"""The gather kernel's hazard cases, and a run of it over a sentinel block.

One builder of the cases for every check of ``compact_gather_kernel``: the
CPU tests hold the twin against ``repro``'s ``compact_gather_pallas`` on
them, and the card's tests and ``chip_smoke.py`` hold the kernel against
the twin. Each caller picks the row count and the tile; the cases are:

  * a capacity of 1, 3, 5 and 4,194,303 (no multiple of 4, so the column
    rows of the output start unaligned), the last also with 2^22
    survivors, one row over it;
  * ``n_kept`` of 0, equal to the capacity and one below it;
  * a tile straddling the capacity, with later tiles wholly beyond it;
  * one tile; one and five columns; a ``fill`` of -0.0 and of NaN.

Survivors are random bit patterns (NaN payloads, ±0, subnormals), which
the copy must move unchanged. Compare outputs through
``view(torch.int32)``: ``torch.equal`` fails on a NaN fill, and ``==``
cannot tell ±0 apart.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.kernels.filter_chain import filter_chain as fc

HAZARDS = [
    "capacity_1", "capacity_3", "capacity_5", "n_kept_0",
    "n_kept_eq_capacity", "n_kept_eq_capacity_minus_1",
    "tile_straddles_capacity", "one_tile", "one_column", "five_columns",
    "fill_neg_zero", "fill_nan"]
# a [C, 4M] output: cases for the card only
HAZARDS_WIDE = ["capacity_4194303", "capacity_4194303_saturated"]

SENTINEL_BITS = 0x7FA5A5A5      # a NaN payload no float operation makes


def hazard(label: str, n_rows: int, tile: int = fc.DEFAULT_TILE,
           device="cpu", fill_tails: bool = False):
    """(packed f32[C, T*tile], offsets i32[T], counts i32[T], capacity,
    fill) of the hazard ``label`` over packs of ``n_rows`` rows.

    A tile's slots past its count hold random bits, which the gather must
    never store; ``fill_tails`` puts ``fill`` there instead, as the chain
    kernel's pack leaves them — what ``compact_gather_pallas``, which
    stores whole tiles, needs to match the twin."""
    r = np.random.default_rng(zlib.crc32(label.encode()))
    n_cols = {"one_column": 1, "five_columns": 5}.get(label, 3)
    fill = {"fill_neg_zero": -0.0, "fill_nan": float("nan")}.get(label, -1.0)
    if label == "one_tile":
        n_rows = min(n_rows, tile - tile // 4)
    if label == "capacity_4194303_saturated":
        cnt = np.full((1 << 22) // tile, tile)
    else:
        n_tiles = -(-n_rows // tile)
        cnt = (np.zeros(n_tiles, np.int64) if label == "n_kept_0"
               else r.integers(0, tile + 1, n_tiles))
        cnt[-1] = min(cnt[-1], n_rows - (n_tiles - 1) * tile)
    n_tiles = len(cnt)
    mid = n_tiles // 2
    if label == "tile_straddles_capacity":
        cnt[mid] = max(cnt[mid], 2)
    off = np.cumsum(cnt) - cnt
    total = int(cnt.sum())
    capacity = {
        "capacity_1": 1, "capacity_3": 3, "capacity_5": 5,
        "n_kept_0": 4099,
        "capacity_4194303": (1 << 22) - 1,
        "capacity_4194303_saturated": (1 << 22) - 1,
        "n_kept_eq_capacity": total, "n_kept_eq_capacity_minus_1": total + 1,
        "tile_straddles_capacity": int(off[mid] + cnt[mid] // 2),
        "one_tile": total // 2 + 1,
        "one_column": total // 2 + 1,
        "five_columns": total + 4097,
    }.get(label, total + 3)
    bits = r.integers(0, 1 << 32, (n_cols, n_tiles, tile),
                      dtype=np.uint32).view(np.float32)
    if fill_tails:
        bits[:, np.arange(tile)[None, :] >= cnt[:, None]] = fill
    return (torch.from_numpy(bits.reshape(n_cols, -1)).to(device),
            torch.from_numpy(off.astype(np.int32)).to(device),
            torch.from_numpy(cnt.astype(np.int32)).to(device), capacity, fill)


def gather_in_sentinel(packed, offsets, counts, capacity: int, fill):
    """``compact_gather_kernel`` writing into a freed block that held
    SENTINEL_BITS in every slot, so a slot it leaves unwritten keeps that
    payload. Returns the output and whether the caching allocator handed
    the kernel the sentinel's block (the check holds only then)."""
    torch.cuda.empty_cache()
    sentinel = torch.full((packed.shape[0], capacity), SENTINEL_BITS,
                          dtype=torch.int32, device=packed.device)
    ptr = sentinel.data_ptr()
    del sentinel
    got = fc.compact_gather_kernel(packed, offsets, counts, capacity,
                                   fill=fill)
    return got, got.data_ptr() == ptr
