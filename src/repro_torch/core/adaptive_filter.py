"""The adaptive filter operator: the functional step math of one shard.

PyTorch port of ``repro.core.adaptive_filter``. ``AdaptiveFilter`` wires
an engine (``core/engine``) to the ordering math (``core.ordering`` /
``core.stats``); ``FilterSession`` (``core.session``) drives it, and
``core.sharded.ShardedAdaptiveFilter`` runs one per shard. Every
tensor stays on the filter's device: the only host-side decisions are the
epoch boundary, taken from the session's mirror of the deterministic row
counter, the ``capacity="auto"`` retune, which reads the device once
per epoch boundary, and the skip tier's gather width on engines that
gather (``skip_amb_cap``, one read per step).

  adaptive=False       → Spark's default Filter: statement order, the
                         monitor stride advances but nothing re-ranks
  scope="per_batch"    → evidence dies with each batch (stride and epoch
                         counter persist)
  exchange="deferred*" → the session fires the boundary
                         (``drive_exchange``); unsharded, the merge is the
                         identity, sharded it sums over the shard axis

The paper's own surface, on which its experiments run, is ``repro``'s
too: ``AdaptiveFilter(predicates, AdaptiveFilterConfig(...))`` and
``static_filter(predicates, order=...)``, driven by ``process_stream``
over a stream of f32[C, R] batches. A traceable engine streams through
a fresh ``FilterSession``; a host engine (``"numpy"``) through
``_process_stream_host``, which folds each batch into an ``OrderState``
on the CPU with the same ordering math.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import ordering as ordering_lib
from repro_torch.core import predicates as pred_lib
from repro_torch.core import skip_tier as skip_tier_lib
from repro_torch.core.engine import MonitorSpec, get_engine
from repro_torch.core.ordering import OrderingConfig, OrderState
from repro_torch.core.plan import FilterPlan, validate_combo
from repro_torch.core.predicates import Predicate
from repro_torch.core.scope import Scope, scope_from_str
from repro_torch.core.stats import FilterStats

CAPACITY_QUANTUM = 128   # auto capacities are multiples of this


def on_card_unless_asked(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises, since the port runs on the GPU unless the caller asks for the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; repro_torch runs on the "
            "GPU unless device='cpu' is passed explicitly")
    return device


def drive_exchange(owner, state: OrderState) -> OrderState:
    """Fire one deferred epoch boundary (the caller has found it due).

    ``owner`` is an ``AdaptiveFilter`` or a ``ShardedAdaptiveFilter``:
    anything with ``config.exchange``, ``exchange_update`` and a
    ``_pending_stats`` slot. One implementation, so the deferred-async
    stash cannot drift between the two: "deferred-async" re-ranks on the
    previous boundary's merged stats (the first boundary, and the first
    after a restore, on its own) and keeps this boundary's for the next.
    """
    is_async = owner.config.exchange == "deferred-async"
    if is_async and owner._pending_stats is not None:
        state, merged = owner.exchange_update(state, owner._pending_stats)
    else:
        state, merged = owner.exchange_update(state)
    owner._pending_stats = merged if is_async else None
    return state


@dataclasses.dataclass(frozen=True)
class AdaptiveFilterConfig:
    """The per-filter configuration of the paper's surface, with
    ``repro``'s fields and validation (``validate_combo``); the default
    backend is the port's default engine, ``"cuda"``.

    ``compact_capacity``: None (batch width), an int, or ``"auto"``
    (tracks the monitor lane's pass rate × ``compact_slack``).
    ``exchange`` matters only under ``scope="centralized"``;
    ``skip_tier`` is "off", "zonemap", "zonemap+bloom" or "auto".
    """

    ordering: OrderingConfig = OrderingConfig()
    scope: str = "per_shard"
    cost_mode: str = "static"
    backend: str = "cuda"
    adaptive: bool = True
    compact_output: bool = False
    compact_capacity: int | str | None = None
    compact_slack: float = 1.5
    exchange: str = "eager"
    skip_tier: str = "off"

    def __post_init__(self) -> None:
        validate_combo(scope=self.scope, cost_mode=self.cost_mode,
                       backend=self.backend,
                       compact_output=self.compact_output,
                       compact_capacity=self.compact_capacity,
                       compact_slack=self.compact_slack,
                       exchange=self.exchange,
                       skip_tier=self.skip_tier)

    def plan(self, predicates: Sequence[Predicate]) -> FilterPlan:
        """The unsharded ``FilterPlan`` of this configuration."""
        return FilterPlan(predicates, **{
            _PLAN_FIELD.get(f.name, f.name): getattr(self, f.name)
            for f in dataclasses.fields(self)})

    @classmethod
    def of(cls, plan: FilterPlan) -> "AdaptiveFilterConfig":
        """The per-filter configuration of ``plan`` (its sharding and
        tokenize stage are the session's)."""
        return cls(**{f.name: getattr(plan, _PLAN_FIELD.get(f.name, f.name))
                      for f in dataclasses.fields(cls)})


# AdaptiveFilterConfig field → FilterPlan field, where the names differ
_PLAN_FIELD = {"backend": "engine", "compact_output": "compact",
               "compact_capacity": "capacity", "compact_slack": "slack"}


class StepMetrics(NamedTuple):
    work_units: torch.Tensor     # row-level cost-weighted work for this batch
    n_pass: torch.Tensor         # surviving rows (mask popcount)
    perm: torch.Tensor           # order used for this batch
    epoch: torch.Tensor          # epochs completed so far
    adj_rank: torch.Tensor       # current smoothed GROUP ranks
    n_dropped: torch.Tensor      # survivors lost to capacity overflow
    n_tiles_pass: torch.Tensor       # skip-tier tile counters (zero when
    n_tiles_fail: torch.Tensor       # the tier is off for the step)
    n_tiles_ambiguous: torch.Tensor


class AdaptiveFilter:
    """Adaptive CNF filter with epoch-based predicate/group reordering.

    ``config`` defaults to ``AdaptiveFilterConfig()``. ``device=None``
    means ``"cuda"`` for a traceable engine, and raises without a card,
    and the CPU for a host engine. A session builds its filter from its
    plan through ``AdaptiveFilterConfig.of(plan)`` on its own device.
    """

    def __init__(self, predicates: Sequence[Predicate],
                 config: AdaptiveFilterConfig | None = None, *,
                 device=None):
        if isinstance(predicates, FilterPlan):
            raise TypeError(
                "AdaptiveFilter takes predicates and an AdaptiveFilterConfig; "
                "a FilterPlan compiles with build_session, or pass "
                "(plan.predicates, AdaptiveFilterConfig.of(plan))")
        if config is not None and not isinstance(config,
                                                 AdaptiveFilterConfig):
            raise TypeError(
                f"config must be an AdaptiveFilterConfig, got "
                f"{type(config).__name__} (the device is keyword-only)")
        if not predicates:
            raise ValueError("need at least one predicate")
        self.config = config = config or AdaptiveFilterConfig()
        if device is None:
            device = "cuda" if get_engine(config.backend).traceable \
                else "cpu"
        self.device = on_card_unless_asked(device, "AdaptiveFilter")
        self.predicates = list(predicates)
        self.specs = pred_lib.pack(self.predicates, self.device)
        self.groups = self.specs.groups          # static CNF structure
        self._scope = scope_from_str(config.scope)
        self._engine = get_engine(config.backend)
        # the engine of ``step``: a host engine streams only through
        # ``process_stream``; a step of its filter runs the ``torch`` engine
        # on this device, as ``repro``'s runs ``jnp``
        self._step_engine = self._engine if self._engine.traceable \
            else get_engine("torch")
        self._statement_order = torch.arange(
            len(self.predicates), dtype=torch.int32, device=self.device)
        # deferred-async: merged stats of the previous boundary, applied
        # one epoch late (transient: the first boundary after a restore
        # falls back to the synchronous merge)
        self._pending_stats: FilterStats | None = None
        # auto-capacity: current quantized width + last epoch it was tuned
        self._auto_cap: int | None = None
        self._auto_cap_epoch = 0

    def init_state(self) -> OrderState:
        return ordering_lib.init_order_state(
            len(self.predicates), self.specs.n_groups, device=self.device)

    # ------------------------------------------------------ row counter
    @property
    def exchange_deferred(self) -> bool:
        """True when the session fires the epoch boundaries (deferred modes)."""
        return (self.config.adaptive and self.config.exchange != "eager"
                and self._scope is Scope.CENTRALIZED)

    def rows_after(self, rows_before: int, n_rows: int) -> tuple[bool, int]:
        """Host mirror of the step's row counter.

        Returns (fire, rows_into_epoch after the step) for a step of
        ``n_rows`` rows from ``rows_before``: exactly what ``advance``
        computes on the device, without reading it.
        """
        if not self.config.adaptive:
            return False, rows_before
        if self._scope is Scope.PER_BATCH:
            rows_before = 0
        rows = rows_before + n_rows
        calc = self.config.ordering.calculate_rate
        if self.exchange_deferred or rows < calc:
            return False, rows
        return True, rows % calc

    # ------------------------------------------------------------- step
    def _advance_state(self, state: OrderState, res, n_rows: int,
                       fire: bool | None,
                       merged: FilterStats | None = None) -> OrderState:
        """Fold one batch's monitor evidence into the order state.

        ``merged`` is the eager CENTRALIZED merge of this batch's counters
        over every shard (``scope.reduce_stats``), which folds in instead
        of this shard's own ``res`` counters.
        """
        config = self.config
        if not config.adaptive:
            return state._replace(
                sample_phase=(state.sample_phase + n_rows)
                % config.ordering.collect_rate)
        if self._scope is Scope.PER_BATCH:
            # evidence dies with the batch; the monitor stride and the
            # epoch counter are stream properties and persist
            state = self.init_state()._replace(
                sample_phase=state.sample_phase, epoch=state.epoch)
        if merged is None:
            merged = FilterStats(res.cut_counts, res.monitor_cost,
                                 res.n_monitored, res.group_cut_counts)
        return ordering_lib.advance(
            state, config.ordering, merged.num_cut, merged.cost_acc,
            merged.n_monitored, n_rows=n_rows, group_cut=merged.group_cut,
            groups=self.groups, defer_epoch=self.exchange_deferred,
            fire=fire)

    def _i32(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(torch.int32)
        return torch.full((), v, dtype=torch.int32, device=self.device)

    def _metrics(self, res, perm, new_state, n_dropped=None) -> StepMetrics:
        return StepMetrics(
            work_units=res.work_units,
            n_pass=res.mask.sum(dtype=torch.int32),
            perm=perm,
            epoch=new_state.epoch,
            adj_rank=new_state.adj_rank,
            n_dropped=self._i32(0) if n_dropped is None else n_dropped,
            n_tiles_pass=self._i32(res.n_tiles_pass),
            n_tiles_fail=self._i32(res.n_tiles_fail),
            n_tiles_ambiguous=self._i32(res.n_tiles_ambiguous),
        )

    def _perm(self, state: OrderState) -> torch.Tensor:
        return state.perm if self.config.adaptive else self._statement_order

    def _monitor_spec(self, state: OrderState) -> MonitorSpec:
        return MonitorSpec(collect_rate=self.config.ordering.collect_rate,
                           sample_phase=state.sample_phase)

    def step(self, state: OrderState, columns: torch.Tensor, *,
             fire: bool | None = None, skip=None, amb_cap: int = 0):
        """One micro-batch: filter + monitor + (maybe) epoch re-rank.

        Returns (new_state, mask bool[R], metrics). ``fire`` is the host's
        epoch-boundary decision (``rows_after``); None reads the device.
        ``skip`` (from ``triage`` on the same batch) and ``amb_cap`` (from
        ``skip_amb_cap``) put the step behind the zone-map skip tier;
        ordering statistics advance as without it, since the monitor lane
        runs row-level on the full batch.
        """
        perm, res, _, _ = self._run(state, columns, skip=skip,
                                    amb_cap=amb_cap)
        new_state = self._advance_state(state, res, int(columns.shape[1]),
                                        fire)
        return new_state, res.mask, self._metrics(res, perm, new_state)

    def _run(self, state: OrderState, columns: torch.Tensor, *,
             capacity: int | None = None, skip=None, amb_cap: int = 0):
        """The engine's chain (+ compaction when ``capacity`` is given) in
        the state's order. Returns (perm, ChainResult, packed, n_kept);
        packed and n_kept are None without compaction."""
        perm = self._perm(state)
        spec = self._monitor_spec(state)
        if capacity is None:
            res = self._step_engine.run_chain(columns, self.specs, perm,
                                              spec, skip=skip,
                                              amb_cap=amb_cap)
            return perm, res, None, None
        res, packed, n_kept = self._step_engine.run_chain_compact(
            columns, self.specs, perm, spec, capacity=capacity, skip=skip,
            amb_cap=amb_cap)
        return perm, res, packed, n_kept

    def _compact_metrics(self, res, perm, new_state, n_kept) -> StepMetrics:
        n_pass = res.mask.sum(dtype=torch.int32)
        return self._metrics(res, perm, new_state, n_dropped=n_pass - n_kept)

    def _call_capacity(self, capacity: int | None, n_rows: int) -> int:
        """A compacting step's capacity: the caller's, else the config's
        fixed one (``capacity="auto"`` needs the caller's)."""
        if capacity is not None:
            return capacity
        if self.config.compact_capacity == "auto":
            raise ValueError(
                "compact_capacity='auto' needs an explicit per-call "
                "capacity: pass capacity=filt.resolve_capacity(n_rows)")
        return self.resolve_capacity(n_rows)

    def _step_compact(self, state: OrderState, columns: torch.Tensor, *,
                      capacity: int | None = None, fire: bool | None = None,
                      skip=None, amb_cap: int = 0):
        """``step`` + single-pass device-side survivor compaction.

        Returns (new_state, packed f32[C, cap], n_kept i32[], mask bool[R],
        metrics); ``packed[:, :n_kept]`` equals ``columns[:, mask]`` up to
        the capacity.
        """
        perm, res, packed, n_kept = self._run(
            state, columns,
            capacity=self._call_capacity(capacity, int(columns.shape[1])),
            skip=skip, amb_cap=amb_cap)
        new_state = self._advance_state(state, res, int(columns.shape[1]),
                                        fire)
        metrics = self._compact_metrics(res, perm, new_state, n_kept)
        return new_state, packed, n_kept, res.mask, metrics

    # ------------------------------------------------------------ skip tier
    def triage(self, columns: torch.Tensor, *, bloom: bool):
        """The engine's zone-map (+ Bloom) triage of one batch."""
        return self._step_engine.triage(columns, self.specs, bloom=bloom)

    def skip_on_mode(self) -> str:
        """The arm ``skip_tier="auto"`` tunes against "off": Bloom bits only
        pay when the chain has an equality predicate to consult them."""
        return "zonemap+bloom" \
            if any(p.op == pred_lib.OP_EQ for p in self.predicates) \
            else "zonemap"

    def skip_amb_cap(self, info, n_rows: int) -> int:
        """Gather width (tiles) for one step — 0 when the engine predicates
        in-kernel instead of gathering. The one device read of the tier,
        and only on an engine that gathers."""
        if not getattr(self._step_engine, "skip_gathers", False):
            return 0
        n_tiles = -(-n_rows // skip_tier_lib.SKIP_TILE)
        return skip_tier_lib.quantize_amb_cap(int(info.n_ambiguous), n_tiles)

    # --------------------------------------------------- capacity auto-tune
    def resolve_capacity(self, n_rows: int) -> int:
        """Current compaction width for an ``n_rows``-wide batch."""
        cap = self.config.compact_capacity
        if cap is None:
            return n_rows
        if cap == "auto":
            return min(self._auto_cap, n_rows) if self._auto_cap else n_rows
        return int(cap)

    def observe_for_capacity(self, evidence_state: OrderState,
                             new_state: OrderState, n_rows: int) -> None:
        """Re-derive the auto capacity after an epoch boundary.

        ``evidence_state`` still holds the epoch's monitor accumulators
        (the state before the boundary). Estimated pass rate = Π_g S_g over
        the exact per-group selectivities; correlation between groups is
        absorbed by ``slack``. A stacked ``[S, ...]`` state takes the
        largest pass rate over its shards and ``n_rows`` per shard. Reads
        the device once: call it only on a step that crossed a boundary or
        started from a restored state.
        """
        if self.config.compact_capacity != "auto":
            return
        st = evidence_state.stats
        k = new_state.epoch.numel()          # 1, or S for a stacked state
        host = torch.cat([new_state.epoch.to(torch.float64).reshape(-1),
                          st.n_monitored.to(torch.float64).reshape(-1),
                          st.group_cut.to(torch.float64).reshape(-1)]
                         ).cpu().numpy()
        epoch = int(host[:k].max())
        if epoch <= self._auto_cap_epoch:
            return
        self._auto_cap_epoch = epoch
        n_mon = np.maximum(host[k:2 * k], 0.0)
        if n_mon.max() <= 0.0:
            return                      # no evidence — keep current width
        gcut = host[2 * k:].reshape(k, -1)
        sel = np.clip(1.0 - gcut / np.maximum(n_mon, 1.0)[:, None], 0.0, 1.0)
        pass_rate = float(np.prod(sel, axis=-1).max())   # max over shards
        want = pass_rate * n_rows * self.config.compact_slack
        quant = int(np.ceil(want / CAPACITY_QUANTUM)) * CAPACITY_QUANTUM
        self._auto_cap = int(np.clip(quant, CAPACITY_QUANTUM, n_rows))

    # ------------------------------------------------------ deferred epochs
    def exchange_update(self, state: OrderState,
                        use_stats: FilterStats | None = None
                        ) -> tuple[OrderState, FilterStats]:
        """One epoch boundary: merge stats (identity here) and re-rank, on
        ``use_stats`` when given. Returns (new_state, merged_stats)."""
        merged = state.stats
        new_state = ordering_lib.boundary_update(
            state, self.config.ordering, groups=self.groups,
            stats_override=merged if use_stats is None else use_stats)
        return new_state, merged

    def exchange(self, state: OrderState) -> OrderState:
        """Fire a due deferred boundary (``drive_exchange``)."""
        return drive_exchange(self, state)

    # ------------------------------------------------------- host streaming
    def process_stream(self, batches: Iterable
                       ) -> Iterator[tuple[np.ndarray, np.ndarray, dict]]:
        """Drive the filter over a stream of f32[C, R] batches.

        Yields (surviving rows f32[C, n_pass], mask bool[R], metrics dict)
        per batch, as host numpy values. A traceable engine steps a fresh
        ``FilterSession`` over this filter, which owns all the driving
        (capacity, deferred exchange, retune, metrics); under
        ``compact_output`` the survivors come out of its packed buffer. A
        host engine runs ``_process_stream_host``.
        """
        if not self._engine.traceable:
            yield from self._process_stream_host(batches)
            return
        # imported here: core.session imports this module
        from repro_torch.core.session import FilterSession
        session = FilterSession.from_filter(self)
        state = session.init_state()
        for batch in batches:
            state, res = session.step(state, batch)
            yield res.survivors(batch), res.mask_np, res.metrics_dict()

    def _process_stream_host(self, batches):
        """The host engine's loop, as ``repro``'s: its counters fold into
        an ``OrderState`` on the CPU through ``ordering.advance`` (and
        ``boundary_update`` at a deferred boundary: no mesh, so the merge
        is the identity). Like ``repro``'s, it folds every batch into the
        stream's evidence under every scope, ``per_batch`` included
        (ROADMAP.md §3)."""
        config = self.config
        cfg = config.ordering
        state = ordering_lib.init_order_state(len(self.predicates),
                                              self.specs.n_groups)
        statement = torch.arange(len(self.predicates), dtype=torch.int32)
        defer = self.exchange_deferred
        for batch in batches:
            cols = batch.detach().cpu().numpy() \
                if isinstance(batch, torch.Tensor) else np.asarray(batch)
            n_rows = int(cols.shape[1])
            perm = state.perm if config.adaptive else statement
            monitor = MonitorSpec(collect_rate=cfg.collect_rate,
                                  sample_phase=int(state.sample_phase),
                                  cost_mode=config.cost_mode)
            skip = None
            if config.skip_tier != "off":
                skip = self._engine.triage(
                    cols, self.specs,
                    bloom=config.skip_tier == "zonemap+bloom")
            res = self._engine.run_chain(cols, self.specs, perm, monitor,
                                         skip=skip)
            if config.adaptive:
                state = ordering_lib.advance(
                    state, cfg, torch.from_numpy(res.cut_counts),
                    torch.from_numpy(res.monitor_cost), res.n_monitored,
                    n_rows=n_rows,
                    group_cut=torch.from_numpy(res.group_cut_counts),
                    groups=self.groups, defer_epoch=defer)
                if defer and int(state.rows_into_epoch) \
                        >= cfg.calculate_rate:
                    state = ordering_lib.boundary_update(
                        state, cfg, groups=self.groups)
            else:
                state = state._replace(
                    sample_phase=(state.sample_phase + n_rows)
                    % cfg.collect_rate)
            yield cols[:, res.mask], res.mask, {
                "work_units": float(res.work_units),
                "n_pass": int(res.mask.sum()),
                "perm": [int(i) for i in perm],
                "epoch": int(state.epoch),
                "n_dropped": 0,
                "n_tiles_skipped_pass": int(res.n_tiles_pass),
                "n_tiles_skipped_fail": int(res.n_tiles_fail),
                "n_tiles_ambiguous": int(res.n_tiles_ambiguous),
            }


def static_filter(predicates: Sequence[Predicate],
                  order: Sequence[int] | None = None,
                  backend: str = "cuda", *, device=None) -> AdaptiveFilter:
    """Spark's default Filter: a fixed order, nothing re-ranks.

    ``order`` permutes the statement order up front (Figure 1 sweeps all
    24 static orders of the paper's chain this way).
    """
    preds = list(predicates)
    if order is not None:
        preds = [preds[i] for i in order]
    cfg = AdaptiveFilterConfig(adaptive=False, backend=backend)
    return AdaptiveFilter(preds, cfg, device=device)
