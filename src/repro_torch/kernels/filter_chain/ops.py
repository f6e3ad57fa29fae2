"""Wrappers around the fused filter-chain kernels (PyTorch port).

Counterpart of ``repro.kernels.filter_chain.ops``: pads the batch to the
tile, packs the meta scalars on the device, launches the kernels through
their wrappers (which run the plain twins on CPU tensors) and reduces the
per-tile counters into the engine-wide ``ChainResult``. The O(n_tiles)
exclusive cumsum of the per-tile survivor counts between the two
compacting launches stays PyTorch glue, as it is XLA glue in ``repro``;
so do the skip tier's Bloom bitmap and tile resolution around the stats
kernel (``skip_triage``). Nothing here reads a device value on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import skip_tier
from repro_torch.core.engine.base import ChainResult, SkipInfo
from repro_torch.core.predicates import PredicateSpecs
from repro_torch.kernels.filter_chain.filter_chain import (
    DEFAULT_TILE, STAT_TILE, compact_gather_kernel, filter_chain_kernel,
    tile_stats_kernel)

MONITOR_MODES = ("row", "block")


def _pack_meta(n_rows: int, collect_rate: int, sample_phase,
               monitor_mode: str, device) -> torch.Tensor:
    """i32[4] = (n_rows, collect_rate, sample_phase, mode) on ``device``.

    ``sample_phase`` may be a device tensor (the order state's): it is
    stacked on the device, never read on the host.
    """
    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    phase = sample_phase.to(device=device, dtype=torch.int32).reshape(()) \
        if isinstance(sample_phase, torch.Tensor) else scalar(sample_phase)
    return torch.stack([scalar(n_rows), scalar(collect_rate), phase,
                        scalar(1 if monitor_mode == "block" else 0)])


def _pad_cols(columns: torch.Tensor, tile: int) -> torch.Tensor:
    pad = (-columns.shape[1]) % tile
    columns = columns.contiguous()
    return F.pad(columns, (0, pad)) if pad else columns


def _reduce_result(mask_i8, active, cut, gcut, nmon, specs: PredicateSpecs,
                   perm, n_rows: int,
                   skip: SkipInfo | None = None) -> ChainResult:
    active_before = active.sum(dim=0)                        # f32[P]
    cost_in_order = specs.static_cost.index_select(0, perm.to(torch.int64))
    work = (active_before * cost_in_order).sum()
    n_monitored = nmon.sum()
    if skip is None:
        n_pass_t = n_fail_t = n_amb_t = torch.zeros(
            (), dtype=torch.int32, device=mask_i8.device)
    else:
        n_pass_t, n_fail_t, n_amb_t = skip_tier.tile_counters(skip)
    return ChainResult(
        mask=mask_i8[0, :n_rows].to(torch.bool),
        work_units=work,
        active_before=active_before,
        cut_counts=cut.sum(dim=0),
        n_monitored=n_monitored,
        monitor_cost=specs.static_cost * n_monitored,
        group_cut_counts=gcut.sum(dim=0),
        n_tiles_pass=n_pass_t,
        n_tiles_fail=n_fail_t,
        n_tiles_ambiguous=n_amb_t,
    )


def _launch_chain(columns, specs, perm, collect_rate, sample_phase,
                  monitor_mode, compact, fill, skip=None):
    if monitor_mode not in MONITOR_MODES:
        raise ValueError(monitor_mode)
    n_rows = int(columns.shape[1])
    padded = _pad_cols(columns.to(torch.float32), DEFAULT_TILE)
    meta = _pack_meta(n_rows, collect_rate, sample_phase, monitor_mode,
                      columns.device)
    perm = perm.to(device=columns.device, dtype=torch.int32).contiguous()
    decisions = None if skip is None else tuple(
        t.to(torch.int32).contiguous()
        for t in (skip.pass_tiles, skip.fail_tiles))
    outs = filter_chain_kernel(padded, specs, perm, meta, compact=compact,
                               fill=fill, skip_decisions=decisions)
    return n_rows, perm, outs


def _gather(outs, capacity: int, fill: float):
    """Launch 2 of the compacting path: per-tile counts → exclusive
    offsets → the gather kernel. Returns (mask/counter outputs, packed,
    n_kept)."""
    *chain_outs, packed_tiles, tile_cnt = outs
    cnt = tile_cnt[:, 0]                                     # i32[T]
    csum = torch.cumsum(cnt, dim=0, dtype=torch.int32)
    offsets = csum - cnt
    packed = compact_gather_kernel(packed_tiles, offsets, cnt, capacity,
                                   fill=fill)
    return chain_outs, packed, torch.clamp(csum[-1], max=capacity)


def skip_triage(columns: torch.Tensor, specs: PredicateSpecs, *,
                bloom: bool) -> SkipInfo:
    """Zone-map (+ Bloom) triage for the cuda engine's skip tier.

    Pads to the kernels' 2048-row tile with ZEROS (matching the chain
    launch's padding): zero lanes can only weaken a fail proof, and a pass
    proof they satisfy is still intersected with row validity in-kernel.
    The min/max summaries come from the stats kernel; the Bloom bitmap and
    the CNF tile resolution are PyTorch glue (``core.skip_tier``). Tile
    counts are over the PADDED tiling: a ragged tail contributes
    decided-but-empty sub-tiles.
    """
    assert STAT_TILE == skip_tier.SKIP_TILE
    padded = _pad_cols(columns.to(torch.float32), DEFAULT_TILE)
    mins, maxs = tile_stats_kernel(padded)
    bl = skip_tier.bloom_bitmap(padded) if bloom else None
    pass_t, fail_t = skip_tier.resolve_tiles(mins, maxs, bl, specs)
    n_amb = (~(pass_t | fail_t)).sum(dtype=torch.int32)
    return SkipInfo(pass_tiles=pass_t, fail_tiles=fail_t, n_ambiguous=n_amb)


def filter_chain(columns: torch.Tensor, specs: PredicateSpecs,
                 perm: torch.Tensor, *, collect_rate: int, sample_phase,
                 monitor_mode: str = "row") -> ChainResult:
    """Fused adaptive CNF chain over f32[C, R]; same contract as run_chain.

    monitor_mode: "row" = the paper's stride sampling; "block" = one
    128-lane slice of every Nth tile (the same sampling fraction).
    """
    n_rows, perm, outs = _launch_chain(columns, specs, perm, collect_rate,
                                       sample_phase, monitor_mode, False, 0.0)
    return _reduce_result(*outs, specs, perm, n_rows)


def filter_chain_compact(columns: torch.Tensor, specs: PredicateSpecs,
                         perm: torch.Tensor, *, collect_rate: int,
                         sample_phase, capacity: int,
                         monitor_mode: str = "row", fill: float = 0.0):
    """Fused chain + in-kernel compaction (two launches, no sort).

    Returns (ChainResult, packed f32[C, capacity], n_kept i32[]). Launch 1
    packs each tile's survivors while it reads the tile; the exclusive
    cumsum of the per-tile counts gives each tile's offset; launch 2
    stores each tile's survivors at its offset. Survivors beyond
    ``capacity`` are dropped and ``n_kept`` saturates.
    """
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    n_rows, perm, outs = _launch_chain(columns, specs, perm, collect_rate,
                                       sample_phase, monitor_mode, True, fill)
    chain_outs, packed, n_kept = _gather(outs, capacity, fill)
    return _reduce_result(*chain_outs, specs, perm, n_rows), packed, n_kept


def filter_chain_skip(columns: torch.Tensor, specs: PredicateSpecs,
                      perm: torch.Tensor, skip: SkipInfo, *,
                      collect_rate: int, sample_phase,
                      monitor_mode: str = "row") -> ChainResult:
    """``filter_chain`` with zone-map-decided sub-tiles bypassing the chain.

    ``skip`` comes from ``skip_triage`` on the same batch. Decided
    sub-tiles start with no pending rows (work counters charge only
    ambiguous rows); the monitor lane is untouched, so ordering statistics
    equal the unskipped launch's.
    """
    n_rows, perm, outs = _launch_chain(columns, specs, perm, collect_rate,
                                       sample_phase, monitor_mode, False,
                                       0.0, skip)
    return _reduce_result(*outs, specs, perm, n_rows, skip)


def filter_chain_compact_skip(columns: torch.Tensor, specs: PredicateSpecs,
                              perm: torch.Tensor, skip: SkipInfo, *,
                              collect_rate: int, sample_phase, capacity: int,
                              monitor_mode: str = "row", fill: float = 0.0):
    """``filter_chain_compact`` behind the skip tier: provably-passing
    sub-tiles reach the in-kernel pack through the mask with no predicate
    work; provably-failing ones contribute nothing. Saturation semantics
    are unchanged."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    n_rows, perm, outs = _launch_chain(columns, specs, perm, collect_rate,
                                       sample_phase, monitor_mode, True, fill,
                                       skip)
    chain_outs, packed, n_kept = _gather(outs, capacity, fill)
    return (_reduce_result(*chain_outs, specs, perm, n_rows, skip), packed,
            n_kept)
