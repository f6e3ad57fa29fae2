"""Epoch controller: collectRate sampling, calculateRate epochs, momentum.

PyTorch port of ``repro.core.ordering`` (paper §2.2). ``OrderState`` is
one executor's adaptive state; every leaf is a tensor on the session's
device. The epoch boundary of ``advance`` is decided on the host from the
row count — which advances deterministically by the static batch width —
so a caller that mirrors ``rows_into_epoch`` on the host (the session
does) passes ``fire`` and the step never reads the device; the
evidence-dependent parts of ``epoch_update`` are device-side selects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import stats as stats_lib
from repro_torch.core.stats import FilterStats


@dataclasses.dataclass(frozen=True)
class OrderingConfig:
    """Table 1 of the paper (defaults reproduced verbatim)."""

    collect_rate: int = 1000        # sample 1 row in every collect_rate
    calculate_rate: int = 1_000_000  # re-rank after this many rows
    momentum: float = 0.3            # past-preservation factor
    # snap-on-flip: bypass momentum when the current order costs more than
    # snap_threshold × the fresh-optimal order under fresh stats; 0 = off
    snap_threshold: float = 0.0

    def __post_init__(self) -> None:
        if self.collect_rate < 1:
            raise ValueError("collect_rate must be >= 1")
        if self.calculate_rate < 1:
            raise ValueError("calculate_rate must be >= 1")
        if not 0.0 <= self.momentum < 1.0:
            raise ValueError("momentum must be in [0, 1)")
        if self.snap_threshold < 0.0:
            raise ValueError("snap_threshold must be >= 0")


class OrderState(NamedTuple):
    """The adaptive filter's full mutable state (tensors, f32/i32)."""

    perm: Any          # i32[P] current evaluation order (groups contiguous)
    adj_rank: Any      # f32[G] momentum-smoothed GROUP ranks
    stats: FilterStats  # accumulators for the current epoch
    rows_into_epoch: Any   # i32[] rows processed since last re-rank
    sample_phase: Any      # i32[] global row offset mod collect_rate
    epoch: Any             # i32[] completed epochs (0 → no history yet)
    group_perm: Any = None  # i32[G] current group evaluation order


def init_order_state(n_predicates: int, n_groups: int | None = None,
                     device="cpu") -> OrderState:
    """Initial order = the user-given statement order, as in Spark."""
    if n_groups is None:
        n_groups = n_predicates

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return OrderState(
        perm=torch.arange(n_predicates, dtype=torch.int32, device=device),
        adj_rank=torch.zeros((n_groups,), dtype=torch.float32, device=device),
        stats=stats_lib.init_stats(n_predicates, n_groups, device=device),
        rows_into_epoch=i32(),
        sample_phase=i32(),
        epoch=i32(),
        group_perm=torch.arange(n_groups, dtype=torch.int32, device=device),
    )


def _default_groups(state: OrderState) -> tuple:
    return tuple(range(int(state.perm.shape[0])))


def epoch_update(state: OrderState, cfg: OrderingConfig,
                 groups: tuple | None = None) -> OrderState:
    """Re-rank at an epoch boundary; reset accumulators; keep momentum.

    An epoch that monitored no rows keeps the previous order (a
    device-side select, no host read).
    """
    groups = tuple(groups) if groups is not None else _default_groups(state)
    n_preds = int(state.perm.shape[0])
    n_groups = int(state.adj_rank.shape[0])
    have_evidence = state.stats.n_monitored > 0.0

    rank_now = stats_lib.group_ranks(state.stats, groups)
    adj = stats_lib.momentum_update(state.adj_rank, rank_now, cfg.momentum,
                                    first_epoch=state.epoch == 0)
    if cfg.snap_threshold > 0.0:
        nc = stats_lib.group_normalized_costs(state.stats, groups)
        s = stats_lib.group_selectivities(state.stats)
        cost_cur = stats_lib.expected_chain_cost(nc, s, state.group_perm)
        fresh = stats_lib.order_from_ranks(rank_now)
        cost_fresh = stats_lib.expected_chain_cost(nc, s, fresh)
        adj = torch.where(cost_cur > cfg.snap_threshold * cost_fresh,
                          rank_now, adj)
    mrank = stats_lib.member_ranks(state.stats)
    new_perm, new_group_perm = stats_lib.cnf_order(adj, mrank, groups)

    return OrderState(
        perm=torch.where(have_evidence, new_perm, state.perm),
        adj_rank=torch.where(have_evidence, adj, state.adj_rank),
        stats=stats_lib.init_stats(n_preds, n_groups,
                                   device=state.perm.device),
        rows_into_epoch=torch.zeros_like(state.rows_into_epoch),
        sample_phase=state.sample_phase,
        epoch=state.epoch + have_evidence.to(torch.int32),
        group_perm=torch.where(have_evidence, new_group_perm,
                               state.group_perm),
    )


def advance(state: OrderState, cfg: OrderingConfig,
            cut_counts, costs, n_monitored, n_rows: int,
            group_cut=None, groups: tuple | None = None,
            defer_epoch: bool = False, fire: bool | None = None
            ) -> OrderState:
    """Fold one batch's monitor results in; fire the epoch boundary if due.

    ``fire`` is whether ``rows_into_epoch + n_rows >= calculate_rate``:
    callers that mirror the row counter on the host pass it (no device
    read); ``None`` reads the counter (one sync on a CUDA state).
    ``defer_epoch=True`` accumulates but never fires — the caller owns
    the boundary (deferred exchange).
    """
    new_stats = stats_lib.accumulate(state.stats, cut_counts, costs,
                                     n_monitored, group_cut=group_cut)
    rows = state.rows_into_epoch + n_rows
    state = state._replace(
        stats=new_stats,
        rows_into_epoch=rows,
        sample_phase=(state.sample_phase + n_rows) % cfg.collect_rate,
    )
    if defer_epoch:
        return state
    if fire is None:
        fire = bool(rows >= cfg.calculate_rate)
    if not fire:
        return state
    updated = epoch_update(state, cfg, groups=groups)
    # carry the overshoot so epoch length is exact on average
    return updated._replace(rows_into_epoch=rows % cfg.calculate_rate)


def boundary_update(state: OrderState, cfg: OrderingConfig,
                    groups: tuple | None = None,
                    stats_override: FilterStats | None = None) -> OrderState:
    """Explicit epoch boundary for the deferred-exchange path: re-rank
    (on ``stats_override`` when given), reset, keep the row overshoot."""
    if stats_override is not None:
        state = state._replace(stats=stats_override)
    updated = epoch_update(state, cfg, groups=groups)
    return updated._replace(
        rows_into_epoch=state.rows_into_epoch % cfg.calculate_rate)
