"""The device tokenizer's edge block, shared by its checks.

One builder of the inputs for every check of ``tokens_from_padded``: the
CPU tests hold it against ``rows_to_tokens`` on them, and the card's
tests and ``chip_smoke.py`` hold the card's result against the CPU's,
bit for bit (whole tensor, zero tail included, and ``n_valid``). The
block covers:

  * f32 bit patterns whose widening is not a plain re-bias: signalling
    NaNs with payloads (``0x7f800001``, ``0xff812345``, ``0x7fbfffff``),
    a quiet NaN with a payload (``0x7fc00001``), ±inf, ±0, the smallest
    and the largest subnormal, between random bit patterns;
  * counts of 0, part of the capacity and all of it;
  * one pipeline (``[C, cap]`` with a scalar count) and three
    (``[3, C, cap]``);
  * vocab 2, 152,064 and 2^24 − 1, the largest the modulo takes.
"""

from __future__ import annotations

import numpy as np

EDGE_BITS = np.array([
    0x7F800001, 0xFF812345, 0x7FC00001, 0x7FBFFFFF,   # NaN payloads
    0x7F800000, 0xFF800000, 0x00000000, 0x80000000,   # ±inf, ±0
    0x00000001, 0x007FFFFF, 0x80000001, 0x807FFFFF,   # ± subnormals
], np.uint32)
VOCABS = (2, 152_064, (1 << 24) - 1)
N_COLS = 3
CAPACITY = 256
TOKENS_PER_ROW = 8


def _block(rng, shards: int) -> np.ndarray:
    """f32[shards, C, cap] of random bit patterns, the edge values in the
    first slots of every column (and again just below each count)."""
    bits = rng.integers(0, 1 << 32, (shards, N_COLS, CAPACITY),
                        dtype=np.uint64).astype(np.uint32)
    n = EDGE_BITS.size
    for c in range(N_COLS):
        bits[:, c, :n] = np.roll(EDGE_BITS, c)
        bits[:, c, 100 - n:100] = np.roll(EDGE_BITS, -c)
    return bits.view(np.float32)


def cases(seed: int = 0) -> list[tuple]:
    """[(label, packed, counts, vocab, tokens_per_row)] as numpy arrays:
    ``packed`` f32[C, cap] with a scalar i32 count, or f32[3, C, cap] with
    i32[3] counts."""
    rng = np.random.default_rng(seed)
    out = []
    for vocab in VOCABS:
        one = _block(rng, 1)[0]
        for count in (0, 100, CAPACITY):
            out.append((f"S1_count{count}_vocab{vocab}", one,
                        np.int32(count), vocab, TOKENS_PER_ROW))
        out.append((f"S3_vocab{vocab}", _block(rng, 3),
                    np.array([100, 0, CAPACITY], np.int32), vocab,
                    TOKENS_PER_ROW))
    return out
