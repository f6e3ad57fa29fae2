"""Hash tokenizer stub: surviving log rows → LM token streams.

PyTorch port of ``repro.data.tokenizer``. Each surviving row is mixed into
``tokens_per_row`` int tokens by a splitmix64 hash of its column values,
so the LM examples are (a) a pure function of the filtered stream and
(b) reproducible across restarts.

Two implementations of the SAME hash:

  ``rows_to_tokens``     — numpy, host path (dense survivor rows in); the
                           oracle the device path is held to.
  ``tokens_from_padded`` — torch, on the device of the padded survivor
                           buffer + counts that compaction emits, so the
                           batch columns never come back to the host:
                           count-masked hash of every slot, then the live
                           tokens packed to a prefix (the cumsum scatter
                           of the compactor across shards).

The hash is defined on the u64 bit pattern of the f64-widened column
values (the numpy path's ``astype(float64).view(uint64)``). The torch path
keeps that u64 arithmetic in ``torch.int64``: add and multiply wrap mod
2^64 in two's complement exactly as u64 does, xor is bitwise, and a
logical right shift is the arithmetic one masked to its low ``64 - k``
bits (``torch.uint64`` has no shift, add or remainder on the CPU in torch
2.13). The f32 → f64 widening is integer surgery on the f32 bit pattern,
with no float conversion of the value, so a NaN payload widens the same
way on every device. ``% vocab`` is taken from the two 32-bit halves,
``((hi % v) * (2^32 % v) + lo) % v``: every term stays below 2^49 for
``v < 2^24``, and no remainder sees a negative operand.
"""

from __future__ import annotations

import numpy as np
import torch

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def _max_device_vocab() -> int:
    """Modulo ceiling, single-sourced in ``core.plan`` (imported lazily:
    this module stays a leaf)."""
    from repro_torch.core.plan import MAX_DEVICE_VOCAB
    return MAX_DEVICE_VOCAB


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + _GAMMA).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x = (x * _MIX1) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    x = (x * _MIX2) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    return x


def rows_to_tokens(columns: np.ndarray, vocab_size: int,
                   tokens_per_row: int = 8) -> np.ndarray:
    """f32[C, R] → i32[R * tokens_per_row] token ids in [0, vocab_size)."""
    if columns.shape[1] == 0:
        return np.zeros((0,), np.int32)
    base = np.zeros(columns.shape[1], np.uint64)
    for c in range(columns.shape[0]):
        base = _splitmix(base ^ columns[c].astype(np.float64).view(np.uint64))
    toks = []
    h = base
    for _ in range(tokens_per_row):
        h = _splitmix(h)
        toks.append((h % np.uint64(vocab_size)).astype(np.int32))
    return np.stack(toks, axis=1).reshape(-1)


# ================================================= int64 device path (torch)
def _as_i64(u: int) -> int:
    """The int64 with the bits of the u64 constant ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_T_GAMMA = _as_i64(int(_GAMMA))
_T_MIX1 = _as_i64(int(_MIX1))
_T_MIX2 = _as_i64(int(_MIX2))
_SIGN = _as_i64(1 << 63)
_LO32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64, 0 < k < 64."""
    return (x >> k).bitwise_and_((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """``_splitmix`` on int64 bit patterns (a new tensor)."""
    x = x + _T_GAMMA
    x ^= _shr(x, 30)
    x *= _T_MIX1
    x ^= _shr(x, 27)
    x *= _T_MIX2
    x ^= _shr(x, 31)
    return x


def f64_bits_of_f32(x: torch.Tensor) -> torch.Tensor:
    """f32[...] → int64[...]: the IEEE-754 bit pattern of float64(x).

    Widening is exact, so the f64 bits are a function of the f32 bits:
    the exponent is re-biased (+896, in exponent units) and the mantissa
    moves up 29 bits. Zeros keep their sign; inf and NaN get exponent 2047
    with the payload widened the same way, and a signalling NaN is quieted
    (f64 bit 51), as a hardware f32 → f64 conversion does. A subnormal
    m·2^-149 (0 < m < 2^23) renormalises: float32(m) is exact, its
    exponent field is floor(log2 m) + 127 and its mantissa field the
    fraction below the leading bit, so its bits re-biased by 747 are the
    widened value's.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64).bitwise_and_(_LO32)
    sign = (bits >> 31) * _SIGN
    mag = bits.bitwise_and_(0x7FFFFFFF)
    e = mag >> 23
    m = mag & 0x7FFFFF
    sub = m.to(torch.float32).view(torch.int32).to(torch.int64)
    src = torch.where(e == 0, sub, mag)
    rebias = torch.where(e == 255, 1792, torch.where(e == 0, 747, 896))
    out = (src + (rebias << 23)) << 29
    out = torch.where(mag == 0, 0, out)
    quiet = torch.where((e == 255) & (m != 0), 1 << 51, 0)
    return out.bitwise_or_(sign).bitwise_or_(quiet)


def mod_u64(x: torch.Tensor, v: int) -> torch.Tensor:
    """(u64 bits of ``x``) % v for 1 <= v < 2^24, from the 32-bit halves."""
    hi = _shr(x, 32)
    lo = x & _LO32
    return ((hi % v) * ((1 << 32) % v) + lo) % v


def tokens_from_padded(packed, counts, vocab_size: int,
                       tokens_per_row: int = 8):
    """Device tokenize+pack over padded survivor buffers.

    ``packed``: f32[S, C, cap] (or [C, cap] for a single pipeline — auto-
    promoted), ``counts``: i32[S] valid widths. Returns (tokens
    i32[S·cap·T], n_valid i32[]) on the device of ``packed``: the first
    ``n_valid`` tokens equal ``rows_to_tokens`` of the shard-major
    concatenation of the valid survivor slices, and the rest are zero —
    the whole tensor equals ``repro``'s bit for bit. Reads nothing from
    the device; requires ``vocab_size < 2**24``.
    """
    if not 1 <= vocab_size < _max_device_vocab():
        raise ValueError(
            f"device tokenize needs 1 <= vocab_size < {_max_device_vocab()} "
            f"(u32-limb byte-fold modulo), got {vocab_size}")
    packed = torch.as_tensor(packed, dtype=torch.float32)
    dev = packed.device
    counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    if packed.ndim == 2:
        packed = packed[None]
        counts = counts.reshape(1)
    s, n_cols, cap = packed.shape
    h = torch.zeros((s, cap), dtype=torch.int64, device=dev)
    for c in range(n_cols):
        h = splitmix64(h ^ f64_bits_of_f32(packed[:, c, :]))
    toks = []
    for _ in range(tokens_per_row):
        h = splitmix64(h)
        toks.append(mod_u64(h, vocab_size).to(torch.int32))
    flat = torch.stack(toks, dim=-1).reshape(-1)       # i32[S·cap·T]
    n = flat.shape[0]
    total = (counts.sum() * tokens_per_row).to(torch.int32)
    if s == 1:
        # the live rows are the first ``count`` slots, so their tokens are
        # already the prefix [0, count·T) of the [cap, T] layout
        return torch.where(torch.arange(n, device=dev) < total, flat, 0), \
            total
    # shard-major O(N) pack: the same cumsum scatter as the compactor
    valid = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    flat_valid = valid.reshape(-1).repeat_interleave(tokens_per_row)
    pos = torch.cumsum(flat_valid, 0) - 1
    dest = torch.where(flat_valid, pos, n)
    out = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    out.scatter_(0, dest, flat)
    return out[:n], total
