"""Sharded execution layer: S shards of the adaptive filter on one device.

PyTorch port of ``repro.core.sharded``. This is where the paper's central
design decision (§2.2 — *where does the adaptive metadata live?*) runs:
one ``ShardedAdaptiveFilter`` runs the single-shard ``AdaptiveFilter``
math once per shard, the ``OrderState`` gains a leading shard axis (one
per-executor state per shard) and the scope decides what the shards
share:

  PER_SHARD    — the paper's choice: every shard adapts to its own slice
                 and nothing crosses between shards. Shards diverge under
                 heterogeneous drift, which is the feature.
  CENTRALIZED  — the one-global-state alternative the paper rejects: batch
                 monitor counters are summed over the shards
                 (``scope.reduce_stats``) before they fold in, so every
                 shard holds the same global statistics and adopts the
                 same order at every boundary. ``exchange="eager"`` sums
                 every step; ``"deferred"`` once per ``calculate_rate``
                 rows, at the boundary (``exchange_update``, fired by the
                 session from its host row mirror); ``"deferred-async"``
                 folds the boundary's sums in one epoch late.
  PER_BATCH    — evidence dies with each batch on each shard (the monitor
                 stride and the epoch counter persist).

Where ``repro`` places the shards on an S-device mesh under
``shard_map``, the port keeps all S on the session's one device: the
mesh axis is the state's leading axis and ``psum`` a sum over it.

Data contract: ``columns`` is f32[C, S·R] with shard i owning rows
[i·R, (i+1)·R), what ``data.pipeline.ShardedPipeline`` assembles from
per-shard ``LogStream``s. Epochs fire per shard's rows (``calculate_rate``
rows per shard); every shard sees the same R, so all fire in lockstep and
the session's host mirror of ``rows_into_epoch`` is one integer. Each
shard's chain (and, with compaction, its gather) is its own engine call
on its slice: on the ``cuda`` engine, S launches of each kernel a step.
"""

from __future__ import annotations

import torch

from repro_torch.core.adaptive_filter import (AdaptiveFilter,
                                              AdaptiveFilterConfig,
                                              drive_exchange)
from repro_torch.core.ordering import OrderState
from repro_torch.core.plan import FilterPlan
from repro_torch.core.scope import Scope, reduce_stats
from repro_torch.core.stats import FilterStats


def _map_state(fn, *states: OrderState) -> OrderState:
    """Apply ``fn`` leaf by leaf across OrderStates (stats included)."""
    def leaf(*xs):
        return None if xs[0] is None else fn(*xs)

    stats = FilterStats(*(leaf(*xs) for xs in zip(*(s.stats
                                                     for s in states))))
    return OrderState(*(stats if i == 2 else leaf(*xs)
                        for i, xs in enumerate(zip(*states))))


def stack_states(state: OrderState, num_shards: int) -> OrderState:
    """Replicate one OrderState onto a leading shard axis: leaf → [S, ...]."""
    return _map_state(
        lambda x: x[None].repeat((num_shards,) + (1,) * x.ndim), state)


def shard_slice(state: OrderState, shard: int) -> OrderState:
    """Shard ``shard``'s OrderState out of the stacked one."""
    return _map_state(lambda x: x[shard], state)


def _no_skip(skip) -> None:
    if skip is not None:
        raise ValueError("the skip tier needs shards == 1")


def _stack(parts):
    """Per-shard OrderStates (or FilterStats, StepMetrics) → one stacked."""
    first = parts[0]
    if isinstance(first, OrderState):
        return _map_state(lambda *xs: torch.stack(xs), *parts)
    return type(first)(*(None if xs[0] is None else torch.stack(xs)
                         for xs in zip(*parts)))


class ShardedAdaptiveFilter:
    """Data-parallel adaptive CNF filter: one OrderState per shard, all on
    ``device``. Scopes and exchange modes as in the module docstring."""

    def __init__(self, plan: FilterPlan, device):
        self.plan = plan
        self.inner = AdaptiveFilter(plan.predicates,
                                    AdaptiveFilterConfig.of(plan),
                                    device=device)
        self.config = self.inner.config
        self.device = self.inner.device
        self.num_shards = int(plan.shards)
        self._scope = self.inner._scope
        self._pending_stats: FilterStats | None = None

    # ---------------------------------------------------------------- state
    def init_state(self) -> OrderState:
        """Stacked per-shard state: every leaf leads with the shard axis."""
        return stack_states(self.inner.init_state(), self.num_shards)

    @property
    def exchange_deferred(self) -> bool:
        return self.inner.exchange_deferred

    # ----------------------------------------------------------------- step
    def _shard_columns(self, columns: torch.Tensor) -> list:
        n = int(columns.shape[1])
        if n % self.num_shards:
            raise ValueError(
                f"a sharded batch is [C, S·R]: {n} rows do not split over "
                f"{self.num_shards} shards")
        r = n // self.num_shards
        return [columns[:, i * r:(i + 1) * r] for i in range(self.num_shards)]

    def _sharded(self, state: OrderState, columns: torch.Tensor, *,
                 capacity: int | None, fire: bool | None):
        """Every shard's chain on its slice, the eager CENTRALIZED merge,
        then every shard's advance. Returns (new_state, packed, n_kept,
        mask bool[S·R], metrics), each with a leading shard axis but the
        mask; packed and n_kept are None without compaction."""
        inner = self.inner
        parts = self._shard_columns(columns)
        n_local = int(parts[0].shape[1])
        states = [shard_slice(state, i) for i in range(self.num_shards)]
        runs = [inner._run(st, cols, capacity=capacity)
                for st, cols in zip(states, parts)]
        merged = [None] * self.num_shards
        if (self._scope is Scope.CENTRALIZED and inner.config.adaptive
                and not inner.exchange_deferred):
            total = reduce_stats(_stack([
                FilterStats(res.cut_counts, res.monitor_cost,
                            res.n_monitored, res.group_cut_counts)
                for _, res, _, _ in runs]), Scope.CENTRALIZED)
            merged = [FilterStats(*(x[i] for x in total))
                      for i in range(self.num_shards)]
        new_states, metrics = [], []
        for st, (perm, res, _, n_kept), m in zip(states, runs, merged):
            new = inner._advance_state(st, res, n_local, fire, m)
            new_states.append(new)
            metrics.append(inner._metrics(res, perm, new) if n_kept is None
                           else inner._compact_metrics(res, perm, new,
                                                       n_kept))
        mask = torch.cat([res.mask for _, res, _, _ in runs])
        packed = n_kept = None
        if capacity is not None:
            packed = torch.stack([p for _, _, p, _ in runs])
            n_kept = torch.stack([k for _, _, _, k in runs])
        return _stack(new_states), packed, n_kept, mask, _stack(metrics)

    def step(self, state: OrderState, columns: torch.Tensor, *,
             fire: bool | None = None, skip=None, amb_cap: int = 0):
        """One micro-batch on every shard: columns f32[C, S·R].

        Returns (new_state [S, ...], mask bool[S·R], metrics with a
        leading shard axis on every field). ``fire`` is the host's
        boundary decision, the same for every shard; None reads the
        device. ``AdaptiveFilter.step``'s signature; ``skip`` must be None,
        as the skip tier needs ``shards == 1`` (``validate_combo``).
        """
        _no_skip(skip)
        state, _, _, mask, metrics = self._sharded(state, columns,
                                                   capacity=None, fire=fire)
        return state, mask, metrics

    def _step_compact(self, state: OrderState, columns: torch.Tensor, *,
                      capacity: int | None = None, fire: bool | None = None,
                      skip=None, amb_cap: int = 0):
        """``step`` + per-shard device compaction.

        Returns (new_state, packed f32[S, C, cap], n_kept i32[S],
        mask bool[S·R], metrics); ``packed[i, :, :n_kept[i]]`` equals shard
        i's ``columns[:, mask]`` up to the capacity, which is per shard.
        """
        _no_skip(skip)
        n_local = int(columns.shape[1]) // self.num_shards
        return self._sharded(
            state, columns,
            capacity=self.inner._call_capacity(capacity, n_local), fire=fire)

    # repro's names for the two steps
    sharded_step = step
    sharded_step_compact = _step_compact

    # ------------------------------------------------ the one-shard surface
    @property
    def specs(self):
        return self.inner.specs

    def rows_after(self, rows_before: int, n_rows: int) -> tuple[bool, int]:
        """The host row mirror of one shard; every shard sees the same R,
        so one mirror serves all."""
        return self.inner.rows_after(rows_before, n_rows)

    # ------------------------------------------------------ deferred epochs
    def exchange_update(self, state: OrderState,
                        use_stats: FilterStats | None = None
                        ) -> tuple[OrderState, FilterStats]:
        """One epoch boundary: sum the stats over the shards and re-rank
        every shard on the sums (on ``use_stats`` when given — the
        deferred-async stash). Returns (new_state, merged_stats), the
        merged stats stacked with identical rows."""
        merged = reduce_stats(state.stats, Scope.CENTRALIZED)
        use = merged if use_stats is None else use_stats
        new = []
        for i in range(self.num_shards):
            st, _ = self.inner.exchange_update(
                shard_slice(state, i), FilterStats(*(
                    None if x is None else x[i] for x in use)))
            new.append(st)
        return _stack(new), merged

    def exchange_due(self, state: OrderState) -> bool:
        """Device-side boundary check (one read); the session decides from
        its host mirror instead."""
        if not self.exchange_deferred:
            return False
        rows = int(state.rows_into_epoch.max())
        return rows >= self.plan.ordering.calculate_rate

    def maybe_exchange(self, state: OrderState) -> OrderState:
        """Fire the deferred boundary if the device says it is due."""
        if not self.exchange_due(state):
            return state
        return drive_exchange(self, state)

    def exchange(self, state: OrderState) -> OrderState:
        """Fire a due deferred boundary (``drive_exchange``)."""
        return drive_exchange(self, state)

    # -------------------------------------------------- capacity auto-tune
    def resolve_capacity(self, n_rows_local: int) -> int:
        return self.inner.resolve_capacity(n_rows_local)

    def observe_for_capacity(self, evidence_state: OrderState,
                             new_state: OrderState,
                             n_rows_local: int) -> None:
        """The auto capacity from the largest pass rate over the shards."""
        self.inner.observe_for_capacity(evidence_state, new_state,
                                        n_rows_local)
