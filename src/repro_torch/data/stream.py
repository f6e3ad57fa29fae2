"""Synthetic structured-log stream with evolving statistics.

A numpy copy of ``repro.data.stream`` that produces the same bytes for
the same arguments (the port imports nothing of ``repro``).

Reproduces the paper's experimental dataset — 3 attributes (date, integer,
string), all value distributions normal — plus the property the paper's
technique exists for: *drift*. Batches are generated counter-based (each
batch from its own seeded Generator keyed by (seed, batch_index)), so the
stream is O(1)-restartable from any row offset: the ingredient checkpoint /
elastic-rescale needs.

Columns:
  0 date     ~ N(500, 100)   (days since epoch)
  1 int      ~ N(50, 15)     (e.g. cpuUsage)
  2 str_hash ~ U[0, 2^20)    (hash of a categorical string attribute)

Drift kinds:
  none    — stationary (paper's Fig. 1 setting)
  sine    — column means glide sinusoidally over rows (smooth drift)
  regime  — parameters switch between two regimes every ``period_rows``
            (abrupt drift; the case momentum is designed to survive)

Layouts (``layout=``) — the *physical row order within a batch*, the knob
the tile-statistics skip tier (``core.skip_tier``) lives or dies by. Row
SETS are identical across layouts (a pure permutation), so selectivities,
adopted orders, and survivors-as-a-set are layout-invariant; only the
per-128-row-tile value locality changes:

  iid       — generator order (exchangeable draws; no locality). Default,
              bit-identical to the pre-layout stream.
  clustered — rows sorted by (int, date): the sorted-ingest case — most
              tiles become provably pass/fail under zone maps.
  zordered  — Morton (Z-order) interleave of the date/int rank spaces:
              multi-column locality, the database clustering middle ground.
  shuffled  — explicit random permutation (adversarial for zone maps;
              tiles stay ambiguous and the skip tier should disable).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

BASE_DISTRIBUTIONS = {
    "date": (500.0, 100.0),
    "int": (50.0, 15.0),
}
STR_MOD = 1048576.0  # 2**20, matches predicates.MIX_MOD


def norm_ppf(q: float) -> float:
    """Inverse normal CDF (Acklam's rational approximation, |err| < 1.2e-9)."""
    if not 0.0 < q < 1.0:
        raise ValueError("quantile must be in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        ql = math.sqrt(-2 * math.log(q))
        return (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    if q > phigh:
        ql = math.sqrt(-2 * math.log(1 - q))
        return -(((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]) / \
               ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1)
    ql = q - 0.5
    r = ql * ql
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * ql / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def threshold_for_quantile(attr: str, q: float) -> float:
    """Threshold t with P(X < t) = q under the BASE (no-drift) distribution."""
    mean, std = BASE_DISTRIBUTIONS[attr]
    return mean + std * norm_ppf(q)


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    kind: str = "none"            # none | sine | regime
    period_rows: int = 2_000_000  # full drift cycle / regime length
    amplitude: float = 1.5        # mean shift in units of base std

    def __post_init__(self) -> None:
        if self.kind not in ("none", "sine", "regime"):
            raise ValueError(f"unknown drift kind {self.kind}")


def _drift_shift(drift: DriftConfig, row_mid: float) -> tuple[float, float, float]:
    """Per-column mean shifts (date_shift_std, int_shift_std, str_offset_frac)."""
    if drift.kind == "none":
        return 0.0, 0.0, 0.0
    phase = row_mid / drift.period_rows
    if drift.kind == "sine":
        s = math.sin(2 * math.pi * phase)
        # columns drift out of phase so the *optimal order* changes, not
        # just the absolute selectivities
        return (drift.amplitude * s,
                -drift.amplitude * math.sin(2 * math.pi * phase + 2.0),
                0.25 * math.sin(2 * math.pi * phase + 4.0))
    # regime: square wave
    regime = int(phase) % 2
    sign = 1.0 if regime == 0 else -1.0
    return (drift.amplitude * sign, -drift.amplitude * sign, 0.2 * sign)


LAYOUTS = ("iid", "clustered", "zordered", "shuffled")


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of ``v`` over even bit positions (u32)."""
    v = v.astype(np.uint32) & np.uint32(0x0000FFFF)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def _layout_order(cols: np.ndarray, layout: str, rng) -> np.ndarray | None:
    """Row permutation realizing ``layout`` (None → keep generator order)."""
    if layout == "iid":
        return None
    if layout == "shuffled":
        return rng.permutation(cols.shape[1])
    if layout == "clustered":
        # primary sort on the int column, date breaks ties — the sorted
        # ingest a warehouse's clustered index produces
        return np.lexsort((cols[0], cols[1]))
    if layout == "zordered":
        # Morton interleave of the 16-bit quantized date/int RANK spaces
        # (ranks, not raw values: Z-order locality should not depend on
        # the columns' absolute scales)
        n = cols.shape[1]
        q = np.empty((2, n), np.uint32)
        for i in (0, 1):
            q[i] = (np.argsort(np.argsort(cols[i], kind="stable"),
                               kind="stable").astype(np.uint64)
                    * 65535 // max(n - 1, 1)).astype(np.uint32)
        morton = _part1by1(q[0]) | (_part1by1(q[1]) << np.uint32(1))
        return np.argsort(morton, kind="stable")
    raise ValueError(f"unknown layout {layout!r}; pick from {LAYOUTS}")


def gen_batch(seed: int, batch_index: int, row_start: int, n_rows: int,
              drift: DriftConfig = DriftConfig(),
              layout: str = "iid") -> np.ndarray:
    """Generate rows [row_start, row_start+n_rows) as f32[3, n_rows].

    Counter-based: depends only on (seed, batch_index, drift, layout),
    never on generator history → restartable and shardable. ``layout``
    permutes rows *within the batch* (see the module docstring) — the row
    set is identical across layouts.
    """
    rng = np.random.Generator(np.random.Philox(key=[seed, batch_index]))
    d_shift, i_shift, s_shift = _drift_shift(drift, row_start + n_rows / 2)

    dmean, dstd = BASE_DISTRIBUTIONS["date"]
    imean, istd = BASE_DISTRIBUTIONS["int"]
    date = rng.normal(dmean + d_shift * dstd, dstd, n_rows)
    intc = rng.normal(imean + i_shift * istd, istd, n_rows)
    strh = (rng.integers(0, int(STR_MOD), n_rows).astype(np.float64)
            + s_shift * STR_MOD) % STR_MOD
    cols = np.stack([date, intc, strh]).astype(np.float32)
    order = _layout_order(cols, layout, rng)
    # np.take keeps the batch C-contiguous (``cols[:, order]`` would hand
    # the engines a Fortran-ordered array, copied again on every step)
    return cols if order is None else np.take(cols, order, axis=1)


class RequestStream:
    """Any counter-based per-batch generator as a restartable stream.

    Adapts ``gen(batch_index, row_start, n_rows) -> f32[C, n_rows]`` to
    the ``LogStream`` contract (``cursor`` / ``state`` / ``restore`` /
    ``batch_rows`` / iteration yielding ``RecordBatch``), so the serving
    ingest thread, ``GuardedSession.run_log_stream``'s rollback cursor
    replay, and the synchronous admission-parity reference all drive
    synthetic request traffic exactly like log batches. ``gen`` MUST be
    pure in its arguments (counter-based, like ``gen_batch`` above) —
    replay and the parity reference regenerate batches by index.
    """

    def __init__(self, gen, total_rows: int, batch_rows: int = 256,
                 start_batch: int = 0):
        if total_rows % batch_rows:
            total_rows = (total_rows // batch_rows) * batch_rows
        if total_rows <= 0:
            raise ValueError("total_rows must cover at least one batch")
        self.gen = gen
        self.total_rows = total_rows
        self.batch_rows = batch_rows
        self.cursor = start_batch  # global batch index; checkpointable

    @property
    def n_batches(self) -> int:
        return self.total_rows // self.batch_rows

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])

    def __iter__(self):
        from repro_torch.data.schema import RecordBatch

        while self.cursor < self.n_batches:
            b = self.cursor
            self.cursor += 1   # read live by rollback replay — rewind-safe
            cols = self.gen(b, b * self.batch_rows, self.batch_rows)
            yield RecordBatch(np.asarray(cols, np.float32),
                              row_offset=b * self.batch_rows)


class LogStream:
    """Restartable, shardable iterator of RecordBatches.

    Sharding: batch b goes to shard (b % num_shards) — round-robin keeps
    per-shard drift exposure aligned with wall-clock, like Spark partitions
    spread over executors.
    """

    def __init__(self, total_rows: int, batch_rows: int = 65536, seed: int = 0,
                 drift: DriftConfig = DriftConfig(), shard_id: int = 0,
                 num_shards: int = 1, start_batch: int = 0,
                 layout: str = "iid"):
        if total_rows % batch_rows:
            total_rows = (total_rows // batch_rows) * batch_rows
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; pick from {LAYOUTS}")
        self.total_rows = total_rows
        self.batch_rows = batch_rows
        self.seed = seed
        self.drift = drift
        self.layout = layout
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.cursor = start_batch  # global batch index; checkpointable

    @property
    def n_batches(self) -> int:
        return self.total_rows // self.batch_rows

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])

    def __iter__(self):
        from repro_torch.data.schema import RecordBatch

        while self.cursor < self.n_batches:
            b = self.cursor
            self.cursor += 1
            if b % self.num_shards != self.shard_id:
                continue
            cols = gen_batch(self.seed, b, b * self.batch_rows,
                             self.batch_rows, self.drift, self.layout)
            yield RecordBatch(cols, row_offset=b * self.batch_rows)
