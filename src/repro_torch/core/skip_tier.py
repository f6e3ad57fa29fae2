"""Tile-statistics skip tier: zone maps + Bloom bits ahead of the chain.

PyTorch port of ``repro.core.skip_tier``. Every batch is summarized in
128-row tiles (``SKIP_TILE``): per-column min/max, plus an optional
128-bit Bloom bitmap of ``round(x) mod 128`` keys for equality predicates.
A pre-pass resolves whole tiles against the current chain:

  provably PASS  — every OR-group has a member whose zone range proves
                   every row passes → the tile skips the row-level chain;
  provably FAIL  — some OR-group's every member provably fails every row
                   → the tile is dropped without row-level work;
  ambiguous      — the tile reaches the row-level chain.

Provability per op (f32 min/max ``mn``/``mx`` of the tile's column):

  GT       pass: mn > t1            fail: mx <= t1
  LT       pass: mx < t1            fail: mn >= t1
  BETWEEN  pass: mn > t1 & mx < t2  fail: mx <= t1 | mn >= t2
  EQ       pass: round(mn) == round(mx) == round(t1)
           fail: round(t1) outside [round(mn), round(mx)], or the Bloom
                 bit of round(t1) mod 128 is clear (zonemap+bloom mode)
  HASHMIX  never provable — always ambiguous.

Proofs are conservative: padding lanes (NaN here, zeros in the kernel
glue) can only weaken a proof, and provably-pass tiles are intersected
with row validity downstream. The monitor lane is untouched by the tier,
so cut counts, group selectivities and the adopted permutations are the
same with the tier on or off.

The predicate ops and thresholds come from the specs' host tuples, so
tile resolution branches on the op in Python and never reads the device.
``SkipTierTuner`` is the ``skip_tier="auto"`` arm, as in ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import filter_exec
from repro_torch.core import predicates as pred_lib
from repro_torch.core.engine.base import ChainResult, SkipInfo

SKIP_TILE = 128          # rows per zone-map tile
BLOOM_BITS = 128         # Bloom bitmap width per (column, tile)
#: gather capacities of the torch skip path are quantized to this many
#: tiles (a bounded set of widths, as in ``repro``)
AMBIG_QUANTUM_TILES = 16

SKIP_TIER_MODES = ("off", "zonemap", "zonemap+bloom", "auto")


def eq_round(t1: float) -> float:
    """The EQ threshold key: round() in f32, exactly as the packed specs
    and the row-level ``round(x) == round(t1)`` see it."""
    return float(np.round(np.float32(t1)))


def bloom_key(t1: float) -> int:
    """Bloom bit index of an EQ threshold: round32(t1) mod BLOOM_BITS —
    the same fold ``bloom_bitmap`` applies to the data side."""
    return int(np.mod(eq_round(t1), float(BLOOM_BITS)))


def host_pred_rows(specs) -> list[tuple[int, int, float, float]]:
    """Static per-predicate (column, op, t1, t2) rows, from the host copy
    of the specs (no device read)."""
    return [(col, op, t1, t2) for (col, op, _), (t1, t2)
            in zip(specs.static, specs.thresholds)]


# ------------------------------------------------------------- summaries
def pad_to_tiles(columns: torch.Tensor,
                 fill: float = float("nan")) -> torch.Tensor:
    """Pad f32[C, R] to a SKIP_TILE multiple; NaN lanes stay ambiguous."""
    pad = (-columns.shape[1]) % SKIP_TILE
    return F.pad(columns, (0, pad), value=fill) if pad else columns


def tile_summaries(columns: torch.Tensor, *, bloom: bool):
    """Zone maps (+ optional Bloom bitmap) of one batch.

    Returns (mins f32[C, T], maxs f32[C, T], bloom bool[C, T, BLOOM_BITS]
    | None) with T = ceil(R / SKIP_TILE). NaN padding propagates into
    min/max, keeping ragged tail tiles unprovable.
    """
    padded = pad_to_tiles(columns)
    n_cols = padded.shape[0]
    tiles = padded.reshape(n_cols, padded.shape[1] // SKIP_TILE, SKIP_TILE)
    mins, maxs = torch.aminmax(tiles, dim=2)
    bl = bloom_bitmap(padded) if bloom else None
    return mins, maxs, bl


def bloom_bitmap(columns: torch.Tensor, *,
                 nonfinite_bit: bool = True) -> torch.Tensor:
    """Bloom bitmap bool[C, T, BLOOM_BITS] of a batch.

    Key = round(x) mod BLOOM_BITS (``torch.remainder``: the sign of the
    divisor, as ``jnp.mod``). NaN lanes fold to key 0. A non-finite key
    (x = ±inf) folds to key 0 too, as XLA:CPU folds it under ``repro``'s
    jnp and Pallas engines — only ever ADDING a bit, which weakens fail
    proofs and never strengthens them; with ``nonfinite_bit=False`` it
    sets no bit, as under ``repro``'s numpy engine (the ``numpy`` engine's
    triage: its keys land in a spare 129th lane, dropped). Built with one
    ``scatter_``; nothing of size [C, T, 128, 128] is materialized.
    """
    padded = pad_to_tiles(columns)
    n_cols = padded.shape[0]
    tiles = padded.reshape(n_cols, padded.shape[1] // SKIP_TILE, SKIP_TILE)
    zero = torch.zeros((), dtype=tiles.dtype, device=tiles.device)
    vals = torch.where(torch.isnan(tiles), zero, torch.round(tiles))
    keys = torch.remainder(vals, float(BLOOM_BITS))
    spare = 0 if nonfinite_bit else 1
    keys = torch.where(torch.isfinite(keys), keys,
                       zero + spare * BLOOM_BITS).to(torch.int64)
    bits = torch.zeros(tiles.shape[:2] + (BLOOM_BITS + spare,),
                       dtype=torch.bool, device=tiles.device)
    return bits.scatter_(2, keys, True)[..., :BLOOM_BITS]


# ------------------------------------------------------------ resolution
def resolve_tiles(mins, maxs, bloom, specs) -> tuple:
    """Tri-state tile resolution against the chain's CNF structure.

    Returns (pass_tiles bool[T], fail_tiles bool[T]). A group provably
    passes a tile iff ANY member provably passes every row; it provably
    fails iff EVERY member provably fails every row. The tile passes the
    chain iff every group passes, fails iff any group fails.
    """
    n_tiles = mins.shape[1]
    never = torch.zeros((n_tiles,), dtype=torch.bool, device=mins.device)
    all_pass, all_fail = [], []
    for col, op, t1, t2 in host_pred_rows(specs):
        mn, mx = mins[col], maxs[col]
        if op == pred_lib.OP_GT:
            ap, af = mn > t1, mx <= t1
        elif op == pred_lib.OP_LT:
            ap, af = mx < t1, mn >= t1
        elif op == pred_lib.OP_BETWEEN:
            ap = (mn > t1) & (mx < t2)
            af = (mx <= t1) | (mn >= t2)
        elif op == pred_lib.OP_EQ:
            r1 = eq_round(t1)
            rmn, rmx = torch.round(mn), torch.round(mx)
            ap = (rmn == r1) & (rmx == r1)
            af = (rmn > r1) | (rmx < r1)
            if bloom is not None:
                af = af | ~bloom[col, :, bloom_key(t1)]
        else:                                   # OP_HASHMIX: never provable
            ap = af = never
        all_pass.append(ap)
        all_fail.append(af)

    pass_t = ~never
    fail_t = never
    for members in specs.group_members:
        gp = all_pass[members[0]]
        gf = all_fail[members[0]]
        for m in members[1:]:
            gp = gp | all_pass[m]
            gf = gf & all_fail[m]
        pass_t = pass_t & gp
        fail_t = fail_t | gf
    return pass_t & ~fail_t, fail_t


def triage(columns: torch.Tensor, specs, *, bloom: bool) -> SkipInfo:
    """Summaries + resolution in one call (the torch engine's ``triage``);
    NaN padding to 128 rows, so T = ceil(R / 128)."""
    mins, maxs, bl = tile_summaries(columns, bloom=bloom)
    pass_t, fail_t = resolve_tiles(mins, maxs, bl, specs)
    n_amb = (~(pass_t | fail_t)).sum(dtype=torch.int32)
    return SkipInfo(pass_tiles=pass_t, fail_tiles=fail_t, n_ambiguous=n_amb)


def quantize_amb_cap(n_ambiguous: int, n_tiles: int) -> int:
    """Gather width (in tiles) for the torch skip path: rounded up to
    ``AMBIG_QUANTUM_TILES``, at least one quantum, capped at the batch's
    tile count."""
    q = AMBIG_QUANTUM_TILES
    want = max(int(n_ambiguous), 1)
    return min(int(-(-want // q)) * q, max(int(n_tiles), 1))


def tile_counters(skip: SkipInfo):
    """(n_pass, n_fail, n_ambiguous) i32 scalars from a SkipInfo."""
    n_pass = skip.pass_tiles.sum(dtype=torch.int32)
    n_fail = skip.fail_tiles.sum(dtype=torch.int32)
    n_tiles = skip.pass_tiles.shape[0]
    return n_pass, n_fail, n_tiles - n_pass - n_fail


# ------------------------------------------------------- torch skip chain
def run_chain_skip(columns: torch.Tensor, specs, perm, monitor,
                   skip: SkipInfo, *, amb_cap: int) -> ChainResult:
    """The torch engine's skip-tier chain: gather → row-level → scatter.

    Only the ambiguous tiles' rows reach the row-level CNF evaluation: they
    are gathered into a [C, amb_cap·SKIP_TILE] buffer (``amb_cap`` from
    ``quantize_amb_cap``; the caller reads the ambiguous count once per
    step), evaluated there, and their mask scattered back; provably-pass
    tiles are bulk-set, provably-fail tiles stay cut. Unused gather slots
    and the ragged tail are invalid rows: never kept, never charged. The
    monitor lane runs on the full columns, so the ordering statistics are
    the off path's. Work counters charge only the valid ambiguous rows.
    """
    n_cols, n_rows = columns.shape
    dev = columns.device
    n_tiles = skip.pass_tiles.shape[0]
    amb = ~(skip.pass_tiles | skip.fail_tiles)

    # gather map: the k-th ambiguous tile's index lands in slot k; the
    # other tiles go to a dump slot that is sliced off (index n_tiles
    # marks an unused slot)
    pos = torch.cumsum(amb.to(torch.int64), dim=0) - 1
    dest = torch.where(amb & (pos < amb_cap), pos,
                       torch.full_like(pos, amb_cap))
    tile_idx = torch.full((amb_cap + 1,), n_tiles, dtype=torch.int64,
                          device=dev)
    tile_idx.scatter_(0, dest, torch.arange(n_tiles, dtype=torch.int64,
                                            device=dev))
    tile_idx = tile_idx[:amb_cap]

    padded = pad_to_tiles(columns)
    tiles = padded.reshape(n_cols, n_tiles, SKIP_TILE)
    # unused slots read tile 0 and are cut by ``valid`` before any work
    g = tiles.index_select(1, torch.clamp(tile_idx, max=n_tiles - 1))
    gcols = g.reshape(n_cols, amb_cap * SKIP_TILE)
    lane = torch.arange(SKIP_TILE, dtype=torch.int64, device=dev)
    valid = ((tile_idx[:, None] * SKIP_TILE + lane) < n_rows).reshape(-1)

    amb_mask, work, active = filter_exec.run_chain_masks(
        gcols, specs, perm, valid=valid)

    mask_tiles = torch.zeros((n_tiles + 1, SKIP_TILE), dtype=torch.bool,
                             device=dev)
    mask_tiles[:n_tiles] = skip.pass_tiles[:, None]
    mask_tiles.index_copy_(0, tile_idx, amb_mask.reshape(amb_cap, SKIP_TILE))
    mask = mask_tiles[:n_tiles].reshape(-1)[:n_rows]

    cut, gcut, n_mon, mon_cost = filter_exec.run_monitor(
        columns, specs, monitor.collect_rate, monitor.sample_phase)

    n_pass_t, n_fail_t, n_amb_t = tile_counters(skip)
    return ChainResult(
        mask=mask, work_units=work, active_before=active,
        cut_counts=cut, n_monitored=n_mon, monitor_cost=mon_cost,
        group_cut_counts=gcut,
        n_tiles_pass=n_pass_t, n_tiles_fail=n_fail_t,
        n_tiles_ambiguous=n_amb_t)


# ------------------------------------------------------------- auto tuner
class SkipTierTuner:
    """Online decision for ``skip_tier="auto"`` (one per session).

    Deterministic schedule, two arms ("off" vs the zone-map tier): the
    first ``2·warmup`` steps alternate arms to seed both EMAs (each arm's
    first sample is discarded); afterwards the faster EMA wins, re-probing
    the losing arm every ``probe_period`` steps. One structural rule
    overrides the clocks: when the observed ambiguous-tile fraction is at
    least ``ambig_off_frac``, the tier cannot pay — choose "off" without
    waiting for wall-clock evidence (shuffled layouts).
    """

    def __init__(self, on_mode: str, *, warmup: int = 3,
                 probe_period: int = 64, ambig_off_frac: float = 0.9,
                 ema: float = 0.3):
        if on_mode not in ("zonemap", "zonemap+bloom"):
            raise ValueError(on_mode)
        self.on_mode = on_mode
        self.warmup = warmup
        self.probe_period = probe_period
        self.ambig_off_frac = ambig_off_frac
        self.ema = ema
        self.step_idx = 0
        self.us_ema = {"off": None, on_mode: None}
        self.samples = {"off": 0, on_mode: 0}
        self.ambig_frac: float | None = None

    @property
    def active_mode(self) -> str:
        """The arm a non-probe step would run right now."""
        if self.ambig_frac is not None \
                and self.ambig_frac >= self.ambig_off_frac:
            return "off"
        on, off = self.us_ema[self.on_mode], self.us_ema["off"]
        if on is None:
            return self.on_mode
        if off is None:
            return "off"
        return self.on_mode if on <= off else "off"

    def choose(self) -> str:
        """Arm for the CURRENT step (advance with ``observe`` afterwards)."""
        if self.step_idx < 2 * self.warmup:
            return self.on_mode if self.step_idx % 2 == 0 else "off"
        active = self.active_mode
        if self.probe_period and self.step_idx % self.probe_period == 0:
            other = "off" if active != "off" else self.on_mode
            # never probe the tier back on when the layout rules it out
            if not (other != "off" and self.ambig_frac is not None
                    and self.ambig_frac >= self.ambig_off_frac):
                return other
        return active

    def observe(self, mode: str, us_per_row: float,
                ambig_frac: float | None = None) -> None:
        self.step_idx += 1
        if ambig_frac is not None:
            self.ambig_frac = float(ambig_frac)
        self.samples[mode] += 1
        if self.samples[mode] <= 1:
            return                     # first sample per arm is discarded
        prev = self.us_ema[mode]
        self.us_ema[mode] = us_per_row if prev is None \
            else (1 - self.ema) * prev + self.ema * us_per_row
