"""``numpy`` engine: row-exact compacted host path (wall-clock-true).

The port's counterpart of ``repro``'s ``numpy`` engine, and its one
engine that is not traceable: it runs Python loops over numpy arrays so
that wall time tracks the evaluation order, and so that the monitor lane
can measure real per-predicate seconds (``cost_mode="measured"``, the
paper's ``System.nanoTime`` analogue). Results are numpy values with the
dtypes ``repro``'s engine casts to.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import np_exec, skip_tier
from repro_torch.core.engine.base import ChainResult, MonitorSpec, SkipInfo
from repro_torch.core.predicates import _OP_NAMES, Predicate, PredicateSpecs


def _preds_from_specs(specs: PredicateSpecs) -> list[Predicate]:
    """Host view of the packed chain, with the f32 thresholds and costs
    the other engines compare and charge (P is small)."""
    costs = specs.static_cost.tolist()
    return [Predicate(name=f"p{i}_{_OP_NAMES[op]}", column=col, op=op,
                      t1=t1, t2=t2, rounds=rounds, static_cost=cost)
            for i, ((col, op, rounds), (t1, t2), cost)
            in enumerate(zip(specs.static, specs.thresholds, costs))]


@engine_lib.register("numpy")
class NumpyEngine:
    """Compacted short-circuit CNF chain on the host (Spark's processNext)."""

    traceable = False
    supports_skip = True
    skip_gathers = False     # the host indexes ambiguous rows directly

    def _monitor(self, columns, preds, monitor: MonitorSpec, groups):
        cut, group_cut, n_mon, secs = np_exec.run_monitor_np(
            columns, preds, monitor.collect_rate,
            int(monitor.sample_phase), groups=groups)
        if monitor.cost_mode == "measured":
            monitor_cost = secs
        else:
            monitor_cost = np.asarray(
                [p.static_cost for p in preds], np.float64) * n_mon
        return cut, group_cut, n_mon, monitor_cost

    def run_chain(self, columns, specs, perm, monitor: MonitorSpec, *,
                  skip: SkipInfo | None = None,
                  amb_cap: int = 0) -> ChainResult:
        """The chain over the batch; with ``skip`` (from ``triage``),
        decided 128-row tiles bypass it and only the ambiguous tiles' rows
        are evaluated and charged. ``amb_cap`` is ignored. The monitor
        lane runs on the full batch either way."""
        columns = np.asarray(columns)
        preds = _preds_from_specs(specs)
        groups = specs.groups
        perm = np.asarray(perm)
        n_rows = columns.shape[1]

        tiles = {}                           # ChainResult's zeros
        if skip is None:
            mask, work, active_before = np_exec.run_chain_np(
                columns, preds, perm, groups=groups)
        else:
            tile = skip_tier.SKIP_TILE
            pass_t, fail_t = skip.pass_tiles, skip.fail_tiles
            amb_tiles = np.nonzero(~(pass_t | fail_t))[0]
            rows = (amb_tiles[:, None] * tile +
                    np.arange(tile)[None, :]).reshape(-1)
            rows = rows[rows < n_rows]
            sub_mask, work, active_before = np_exec.run_chain_np(
                columns[:, rows], preds, perm, groups=groups)
            mask = np.zeros(n_rows, bool)
            prows = (np.nonzero(pass_t)[0][:, None] * tile +
                     np.arange(tile)[None, :]).reshape(-1)
            mask[prows[prows < n_rows]] = True
            mask[rows] = sub_mask
            n_pass_t = pass_t.sum(dtype=np.int32)
            n_fail_t = fail_t.sum(dtype=np.int32)
            tiles = dict(n_tiles_pass=n_pass_t, n_tiles_fail=n_fail_t,
                         n_tiles_ambiguous=np.int32(pass_t.shape[0])
                         - n_pass_t - n_fail_t)

        cut, group_cut, n_mon, monitor_cost = self._monitor(
            columns, preds, monitor, groups)
        return ChainResult(
            mask=mask,
            work_units=np.float32(work),
            active_before=active_before,
            cut_counts=cut.astype(np.float32),
            n_monitored=np.float32(n_mon),
            monitor_cost=monitor_cost.astype(np.float32),
            group_cut_counts=group_cut.astype(np.float32),
            **tiles,
        )

    # ------------------------------------------------------- skip tier
    def triage(self, columns, specs, *, bloom: bool) -> SkipInfo:
        """Zone maps (+ Bloom bits) of the NaN-padded batch, resolved
        against the chain, on a CPU view of the batch. As under ``repro``'s
        numpy engine, a non-finite Bloom key (±inf) sets no bit, where the
        device engines set bit 0 (ROADMAP.md §3)."""
        cols = torch.from_numpy(np.ascontiguousarray(columns, np.float32))
        mins, maxs, _ = skip_tier.tile_summaries(cols, bloom=False)
        bits = skip_tier.bloom_bitmap(cols, nonfinite_bit=False) \
            if bloom else None
        pass_t, fail_t = skip_tier.resolve_tiles(mins, maxs, bits, specs)
        pass_t, fail_t = pass_t.numpy(), fail_t.numpy()
        n_amb = (~(pass_t | fail_t)).sum(dtype=np.int32)
        return SkipInfo(pass_tiles=pass_t, fail_tiles=fail_t,
                        n_ambiguous=n_amb)
