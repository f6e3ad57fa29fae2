"""FilterSession: a compiled FilterPlan with ONE step entry point.

PyTorch port of ``repro.core.session``. ``build_session(plan,
device=None)`` lints the plan's chain (an unsatisfiable chain raises, a
redundant predicate warns once), then places the session on ``cuda``
unless the caller passes ``device="cpu"``; with no card and no CPU asked
for, it raises.

    state, result = session.step(state, batch)

``StepResult`` is the uniform step ABI with host accessors that copy on
demand:

    mask      bool[R] | bool[S·R]   rows passing the chain (always)
    packed    f32[C, cap] | f32[S, C, cap] | None   compacted survivors
    n_kept    i32[] | i32[S] | None  survivors kept per shard (compaction)
    tokens    i32[N] | i32[S, N] | None   packed device tokens (tokenize)
    n_tokens  i32[] | i32[S] | None  live prefix length of ``tokens``
    metrics   StepMetrics            a leading shard axis when sharded

A plan with ``shards = S > 1`` runs S shards on the session's device
(``core.sharded``): the batch is f32[C, S·R], shard i owning rows
[i·R, (i+1)·R), and the state leads with a shard axis. A step reads
nothing from the device:
the epoch boundary comes from a host mirror of ``rows_into_epoch`` (it
advances by the static batch width), and the tokenize stage reads no
count, so the only device→host copies of a step are the
``capacity="auto"`` retune after a boundary, the one re-anchoring read
when a state arrives that this session did not produce, and the skip
tier's: the ambiguous-tile count that sizes the ``torch`` engine's
gather (none on ``cuda``), and the ``skip_tier="auto"`` tuner's wall
clock (a ``synchronize`` plus one read of the tile counters on the
tier's arm).

A plan on a host engine (``engine="numpy"``) streams through
``AdaptiveFilter.process_stream``; its session's ``step`` runs the
``torch`` engine on the session's device, as ``repro``'s runs ``jnp``
on its default device. It is the one place where the engine a plan
names is not the engine that runs.

Checkpoints are the reference's schema v2 envelope (plan fingerprint,
shard layout, accumulator layout, crc32 over the state arrays) and load
v1 raw-array blobs; blobs move between ``repro`` and ``repro_torch`` in
both directions. Restores are elastic: a blob written on S shards loads
into a session over S′ (``reshard_state_arrays``, 0 meaning unsharded).
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import skip_tier as skip_tier_lib
from repro_torch.core import stats as stats_lib
from repro_torch.core.adaptive_filter import (AdaptiveFilter,
                                              AdaptiveFilterConfig,
                                              StepMetrics,
                                              on_card_unless_asked)
from repro_torch.core.ordering import OrderState
from repro_torch.core.plan import FilterPlan, TokenizeSpec
from repro_torch.core.sharded import ShardedAdaptiveFilter
from repro_torch.core.stats import FilterStats

log = logging.getLogger(__name__)

#: checkpoint schema written by ``FilterSession.save_state``
CKPT_VERSION = 2
CKPT_FORMAT = "filter-session"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ================================================================== StepResult
class StepResult(NamedTuple):
    """Uniform per-step output of ``FilterSession.step``.

    Tensors stay on the device until a host accessor (``mask_np``,
    ``survivors``, ``metrics_dict``, ...) is called.
    """

    mask: Any
    packed: Any | None
    n_kept: Any | None
    tokens: Any | None
    n_tokens: Any | None
    metrics: StepMetrics
    capacity: int | None = None   # compaction width used (None = no limit)
    warn_cell: list | None = None  # per-result once-cell for the warning
    quarantined: bool = False
    gate_s: float | None = None   # host seconds spent driving this step

    @property
    def mask_np(self) -> np.ndarray:
        return _np(self.mask)

    @property
    def n_pass(self) -> int:
        """Survivors actually kept: the packed count under compaction, the
        mask popcount otherwise."""
        self._maybe_warn_overflow()
        if self.n_kept is not None:
            return int(_np(self.n_kept).sum())
        return int(self.mask_np.sum())

    def _maybe_warn_overflow(self) -> None:
        """Warn once per result when capacity overflow dropped rows."""
        if self.capacity is None or self.warn_cell is None or self.warn_cell:
            return
        self.warn_cell.append(True)
        nd = int(_np(self.metrics.n_dropped).sum())
        if nd:
            log.warning(
                "compaction overflow: %d survivors dropped this step "
                "(capacity %s); raise compact_capacity or use 'auto'",
                nd, self.capacity)

    @property
    def n_dropped(self) -> int:
        self._maybe_warn_overflow()
        return int(_np(self.metrics.n_dropped).sum())

    @property
    def n_dropped_per_shard(self) -> list[int]:
        self._maybe_warn_overflow()
        return [int(x) for x in np.atleast_1d(_np(self.metrics.n_dropped))]

    @property
    def n_tiles_skipped_pass(self) -> int:
        return int(_np(self.metrics.n_tiles_pass).sum())

    @property
    def n_tiles_skipped_fail(self) -> int:
        return int(_np(self.metrics.n_tiles_fail).sum())

    @property
    def n_tiles_ambiguous(self) -> int:
        return int(_np(self.metrics.n_tiles_ambiguous).sum())

    def survivors(self, columns=None) -> np.ndarray:
        """Surviving rows as a host f32[C, n_pass] array (shard-major).

        Under compaction (incl. tokenize plans) this reads ``n_kept`` once
        and copies only each shard's ``packed[..., :n_kept]``; otherwise it
        boolean-indexes ``columns`` (required then). Tokenize-plan
        pipelines prefer ``host_tokens``: only the dense token stream
        crosses to the host there."""
        self._maybe_warn_overflow()
        if self.packed is not None:
            counts = np.atleast_1d(_np(self.n_kept))
            if self.packed.ndim == 2:                  # [C, cap]
                return _np(self.packed[:, :int(counts[0])])
            return np.concatenate(                     # [S, C, cap]
                [_np(self.packed[i, :, :int(n)])
                 for i, n in enumerate(counts)], axis=1)
        if columns is None:
            raise ValueError("no compaction in this session: pass the "
                             "original columns to slice by mask")
        return _np(columns)[:, self.mask_np]

    def host_tokens(self) -> np.ndarray:
        """Dense packed token stream (device tokenize sessions only):
        reads ``n_tokens`` once and copies only the live prefix. Sharded
        sessions tokenize and pack per shard; the shard-major
        concatenation here equals the single-stream pack."""
        if self.tokens is None:
            raise ValueError("session has no tokenize stage "
                            "(FilterPlan.tokenize is None)")
        if self.tokens.ndim == 2:                      # [S, cap·T]
            counts = _np(self.n_tokens)
            return np.concatenate([_np(self.tokens[i, :int(n)])
                                   for i, n in enumerate(counts)])
        return _np(self.tokens[:int(_np(self.n_tokens))])

    def metrics_dict(self) -> dict:
        """The JSON metrics encoding (same keys as ``repro``'s): sums over
        shards, with the per-shard ``n_dropped`` beside the sum when the
        step was sharded."""
        self._maybe_warn_overflow()
        m = self.metrics
        nd = _np(m.n_dropped)
        out = {
            "work_units": float(_np(m.work_units).sum()),
            "n_pass": int(_np(m.n_pass).sum()),
            "perm": _np(m.perm).tolist(),
            "epoch": int(_np(m.epoch).max()),
            "n_dropped": int(nd.sum()),
            "n_tiles_skipped_pass": self.n_tiles_skipped_pass,
            "n_tiles_skipped_fail": self.n_tiles_skipped_fail,
            "n_tiles_ambiguous": self.n_tiles_ambiguous,
            "quarantined": bool(self.quarantined),
        }
        if nd.ndim >= 1:
            out["n_dropped_per_shard"] = [int(x) for x in nd]
        return out


# ============================================================ state validation
def state_invariants(state: OrderState, *, n_predicates: int, n_groups: int,
                     collect_rate: int, calculate_rate: int,
                     rows_bounded: bool = True) -> torch.Tensor:
    """ONE fused boolean (a bool[] tensor) over every structural invariant
    of an OrderState: finite, non-negative accumulators; cut counts within
    ``n_monitored``; ``perm``/``group_perm`` true permutations; counters
    in range. Holds for ``[P]`` states and stacked ``[S, P]`` ones alike
    (every check broadcasts over a leading shard axis)."""
    st = state.stats

    def clean(a):      # finite AND non-negative
        return torch.isfinite(a).all() & (a >= 0).all()

    dev = state.perm.device
    ok = clean(st.num_cut) & clean(st.cost_acc) & clean(st.n_monitored)
    ok = ok & torch.isfinite(state.adj_rank).all()
    n_mon = st.n_monitored[..., None]
    ok = ok & (st.num_cut <= n_mon).all()
    if st.group_cut is not None:
        ok = ok & clean(st.group_cut) & (st.group_cut <= n_mon).all()
    ok = ok & (torch.sort(state.perm.to(torch.int32), dim=-1).values
               == torch.arange(n_predicates, dtype=torch.int32,
                               device=dev)).all()
    if state.group_perm is not None:
        ok = ok & (torch.sort(state.group_perm.to(torch.int32), dim=-1).values
                   == torch.arange(n_groups, dtype=torch.int32,
                                   device=dev)).all()
    ok = ok & (state.rows_into_epoch >= 0).all()
    if rows_bounded:
        ok = ok & (state.rows_into_epoch < calculate_rate).all()
    ok = ok & ((state.sample_phase >= 0)
               & (state.sample_phase < collect_rate)).all()
    return ok & (state.epoch >= 0).all()


# ======================================================== checkpoint arrays
def arrays_crc32(arrays: dict) -> int:
    """CRC32 over a state-arrays dict (key order canonicalized): each
    array's name, dtype, shape and raw bytes — as ``repro`` computes it."""
    crc = 0
    for k in sorted(arrays):
        v = np.ascontiguousarray(np.asarray(arrays[k]))
        crc = zlib.crc32(f"{k}|{v.dtype.str}|{v.shape}".encode(), crc)
        crc = zlib.crc32(v.tobytes(), crc)
    return crc


def fstate_to_arrays(fstate: OrderState) -> dict:
    """OrderState → flat dict of numpy arrays (checkpoint encoding); stats
    fields under a ``stats.`` prefix. Stacked ``[S, ...]`` states are
    stored verbatim."""
    return {k: _np(v) for k, v in fstate._asdict().items()
            if k != "stats"} \
        | {f"stats.{k}": _np(v) for k, v in fstate.stats._asdict().items()}


def fstate_from_arrays(fs: dict, device="cpu") -> OrderState:
    """Inverse of ``fstate_to_arrays``; pre-CNF blobs get group_cut =
    num_cut accumulators and an identity group_perm."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    adj = np.asarray(fs["adj_rank"])
    n_groups = int(adj.shape[-1])
    stats = FilterStats(t(fs["stats.num_cut"]), t(fs["stats.cost_acc"]),
                        t(fs["stats.n_monitored"]),
                        t(fs.get("stats.group_cut", fs["stats.num_cut"])))
    default_gperm = np.broadcast_to(
        np.arange(n_groups, dtype=np.int32), adj.shape)
    return OrderState(
        perm=t(fs["perm"]), adj_rank=t(fs["adj_rank"]), stats=stats,
        rows_into_epoch=t(fs["rows_into_epoch"]),
        sample_phase=t(fs["sample_phase"]), epoch=t(fs["epoch"]),
        group_perm=t(fs.get("group_perm", default_gperm)))


# ================================================================== session
class FilterSession:
    """A compiled ``FilterPlan`` on one device; see the module docstring."""

    def __init__(self, plan: FilterPlan, device, *, _filter=None):
        self.plan = plan
        self.device = torch.device(device)
        if _filter is not None:
            self.filter = _filter
        elif plan.shards > 1:
            self.filter = ShardedAdaptiveFilter(plan, self.device)
        else:
            self.filter = AdaptiveFilter(plan.predicates,
                                         AdaptiveFilterConfig.of(plan),
                                         device=self.device)
        # host mirror of rows_into_epoch and the tensor it mirrors; whether
        # that state came from outside (a restore or a foreign state)
        self._rows_host = 0
        self._rows_ref = None
        self._foreign = False
        # skip_tier="auto": the online us_per_row tuner (lazy; host-owned)
        self._skip_tuner: skip_tier_lib.SkipTierTuner | None = None

    # -------------------------------------------------------------- shape
    @property
    def sharded(self) -> bool:
        return isinstance(self.filter, ShardedAdaptiveFilter)

    @property
    def num_shards(self) -> int:
        return self.filter.num_shards if self.sharded else 1

    def _anchor(self, state: OrderState, rows: int, *,
                foreign: bool = False) -> None:
        self._rows_host = rows
        self._rows_ref = state.rows_into_epoch
        self._foreign = foreign

    def init_state(self) -> OrderState:
        state = self.filter.init_state()
        self._anchor(state, 0)
        return state

    @classmethod
    def from_filter(cls, filt, tokenize: TokenizeSpec | None = None
                    ) -> "FilterSession":
        """Adopt a filter built on the paper's surface
        (``AdaptiveFilter(predicates, config)``), or a sharded one, under
        its plan (plus ``tokenize``), on its device. Skips the chain lint,
        as ``repro``'s does: the filter is already built."""
        plan = filt.plan if isinstance(filt, ShardedAdaptiveFilter) \
            else filt.config.plan(filt.predicates)
        if tokenize is not None:
            plan = dataclasses.replace(plan, tokenize=tokenize)
        return cls(plan, filt.device, _filter=filt)

    def with_tokenize(self, tokenize: TokenizeSpec) -> "FilterSession":
        """The same filter, device and state mirror, plus the device
        tokenize stage (the plan is re-validated: tokenize needs
        compaction); the new session gets its own skip-tier tuner."""
        session = FilterSession(
            dataclasses.replace(self.plan, tokenize=tokenize), self.device,
            _filter=self.filter)
        session._rows_host, session._rows_ref, session._foreign = (
            self._rows_host, self._rows_ref, self._foreign)
        return session

    # ----------------------------------------------------------- skip tier
    def _skip_step_mode(self) -> str:
        """The skip-tier arm for the CURRENT step ("off" disables it).

        Fixed tiers pass through; "auto" asks the online tuner
        (``skip_tier.SkipTierTuner``) which arm to run.
        """
        tier = self.plan.skip_tier
        if tier == "off":
            return "off"
        if tier != "auto":
            return tier
        if self._skip_tuner is None:
            self._skip_tuner = skip_tier_lib.SkipTierTuner(
                self.filter.skip_on_mode())
        return self._skip_tuner.choose()

    @property
    def skip_tier_active(self) -> str:
        """The arm a step would run right now (bench/telemetry hook)."""
        if self.plan.skip_tier != "auto":
            return self.plan.skip_tier
        return self._skip_tuner.active_mode if self._skip_tuner else "auto"

    # ---------------------------------------------------------------- step
    def step(self, state: OrderState, batch) -> tuple[OrderState, StepResult]:
        """One micro-batch through the compiled plan.

        ``batch``: f32[C, R] (f32[C, S·R] when sharded), a tensor on the
        session's device (or host data, copied there). Runs the skip-tier
        triage (when the plan's tier is on for this step), the chain
        (+ compaction, + tokenize) of every shard, fires the epoch
        boundary the host mirror says is due (the deferred exchange, for
        deferred plans) and retunes ``capacity="auto"`` after a boundary,
        or on the first step from a restored or foreign state (whose epoch
        may be past the last one the tuner saw, as repro's every-step
        check finds).
        """
        t_gate = time.perf_counter()
        cols = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        n_rows = int(cols.shape[1])
        n_local = n_rows // self.num_shards
        f = self.filter
        if state.rows_into_epoch is not self._rows_ref:
            # a state this session did not produce: re-anchor (one read)
            self._anchor(state, self._sync_rows_into_epoch(state),
                         foreign=True)
        retune = self._foreign
        fire, rows = self.filter.rows_after(self._rows_host, n_local)
        prev = state
        packed = n_kept = tokens = n_tokens = cap = None
        skip_mode = self._skip_step_mode()
        t0 = time.perf_counter()
        skip, amb_cap = None, 0
        if skip_mode != "off":
            # the torch engine reads the ambiguous count here to size its
            # gather; the cuda engine predicates in-kernel and reads nothing
            skip = f.triage(cols, bloom=skip_mode == "zonemap+bloom")
            amb_cap = f.skip_amb_cap(skip, n_rows)
        if self.plan.compact:
            cap = f.resolve_capacity(n_local)
            state, packed, n_kept, mask, metrics = f._step_compact(
                state, cols, capacity=cap, fire=fire, skip=skip,
                amb_cap=amb_cap)
            if self.plan.tokenize is not None:
                tokens, n_tokens = self._tokenize(packed, n_kept)
        else:
            state, mask, metrics = f.step(state, cols, fire=fire, skip=skip,
                                          amb_cap=amb_cap)
        if self.plan.skip_tier == "auto":
            self._observe_skip_arm(skip_mode, metrics, t0, n_rows)
        if f.exchange_deferred \
                and rows >= self.plan.ordering.calculate_rate:
            state = f.exchange(state)
            rows %= self.plan.ordering.calculate_rate
            fire = True
        if fire or retune:
            f.observe_for_capacity(prev, state, n_local)
        self._anchor(state, rows)
        metrics = metrics._replace(epoch=state.epoch)
        return state, StepResult(mask, packed, n_kept, tokens, n_tokens,
                                 metrics, cap, warn_cell=[],
                                 gate_s=time.perf_counter() - t_gate)

    def _observe_skip_arm(self, skip_mode: str, metrics: StepMetrics,
                          t0: float, n_rows: int) -> None:
        """Feed the skip_tier="auto" tuner one honest per-arm wall clock.

        Both arms pay the same ``synchronize`` (``block_until_ready`` in
        ``repro``); the tier's arm also reads its tile counters (one copy)
        for the ambiguous fraction behind the structural shutoff.
        """
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        ambig_frac = None
        if skip_mode != "off":
            n_amb, n_pass, n_fail = _np(torch.stack([
                metrics.n_tiles_ambiguous, metrics.n_tiles_pass,
                metrics.n_tiles_fail]).to(torch.float64)).tolist()
            ambig_frac = n_amb / max(n_amb + n_pass + n_fail, 1.0)
        self._skip_tuner.observe(skip_mode, dt * 1e6 / max(n_rows, 1),
                                 ambig_frac)

    def _tokenize(self, packed, n_kept):
        """Device tokenize + pack of the padded survivors: one call
        unsharded; per shard when sharded (each shard's
        ``packed[i, :, :n_kept[i]]`` on its own), giving (tokens
        i32[S, cap·T], n_tokens i32[S])."""
        # imported here: repro_torch.data imports this module
        from repro_torch.data import tokenizer
        ts = self.plan.tokenize
        if not self.sharded:
            return tokenizer.tokens_from_padded(
                packed, n_kept, ts.vocab_size, ts.tokens_per_row)
        parts = [tokenizer.tokens_from_padded(
            packed[i], n_kept[i], ts.vocab_size, ts.tokens_per_row)
            for i in range(self.num_shards)]
        return (torch.stack([t for t, _ in parts]),
                torch.stack([n for _, n in parts]))

    def _sync_rows_into_epoch(self, state: OrderState) -> int:
        """Re-anchor the host row counter from the device state — only for
        a state that this session did not produce."""
        return int(_np(state.rows_into_epoch).max())

    # ----------------------------------------------------------- validation
    def validate_state(self, state: OrderState) -> bool:
        """Structural integrity check of an ``OrderState``: every invariant
        fused into one boolean, read with a single device→host copy."""
        cfg = self.plan.ordering
        ok = state_invariants(
            state, n_predicates=len(self.plan.predicates),
            n_groups=self.filter.specs.n_groups,
            collect_rate=cfg.collect_rate,
            calculate_rate=cfg.calculate_rate,
            rows_bounded=not self.filter.exchange_deferred)
        return bool(_np(ok))

    # =========================================================== checkpoints
    @property
    def _stats_replicated(self) -> bool:
        """Accumulator layout of this session's states.

        Under eager CENTRALIZED every batch's counters are summed over the
        shards before they fold in, so every shard's accumulators hold the
        same global totals (replicated). Every other combination
        accumulates per shard (partitioned). An elastic restore converts
        between the two, or it would count carried evidence S times over
        or S times under.
        """
        return (self.sharded and self.plan.scope == "centralized"
                and self.plan.exchange == "eager" and self.plan.adaptive)

    def save_state(self, state: OrderState) -> dict:
        """Versioned checkpoint blob (schema v2), as ``repro`` writes it:
        plan fingerprint, shard layout (0 = unsharded) and accumulator
        layout (``_stats_replicated``) beside the state arrays."""
        arrays = fstate_to_arrays(state)
        return {
            "format": CKPT_FORMAT,
            "version": CKPT_VERSION,
            "fingerprint": self.plan.fingerprint(),
            "shards": self.num_shards if self.sharded else 0,
            "stats_layout": "replicated" if self._stats_replicated
            else "partitioned",
            "crc32": arrays_crc32(arrays),
            "arrays": arrays,
        }

    def restore_state(self, blob: dict) -> OrderState:
        """Load a v1 (raw arrays) or v2 (versioned) blob, resharding S→S′.

        Rejects another plan's fingerprint and a crc32 mismatch with a
        ValueError. The same shard and accumulator layout restores
        verbatim; any other goes through ``reshard_state_arrays`` (sums
        merged and split, ranks re-derived when the source shards
        disagree), as ``repro`` restores it.
        """
        src_replicated = None
        if "arrays" in blob:                     # versioned (v2) envelope
            fmt = blob.get("format")
            if fmt is not None and fmt != CKPT_FORMAT:
                raise ValueError(
                    f"not a filter-session checkpoint (format {fmt!r})")
            version = blob.get("version")
            if version not in (CKPT_VERSION,):
                raise ValueError(
                    f"unknown filter-session checkpoint version {version!r} "
                    f"(this build reads v1 raw-array blobs and v2)")
            want = self.plan.fingerprint()
            got = blob.get("fingerprint")
            if got is not None and got != want:
                raise ValueError(
                    f"checkpoint plan fingerprint {got} does not match this "
                    f"session's {want}: the predicate chain, ordering "
                    "config, scope, adaptivity, or cost mode differ — "
                    "elastic restore only spans engines and shard counts")
            if "stats_layout" in blob:
                src_replicated = blob["stats_layout"] == "replicated"
            arrays = blob["arrays"]
            stored_crc = blob.get("crc32")
            if stored_crc is None:
                warnings.warn(
                    "repro_torch: loading a checksum-less v2 filter-session "
                    "checkpoint; corruption cannot be detected — re-save to "
                    "upgrade", UserWarning, stacklevel=2)
            else:
                got_crc = arrays_crc32(arrays)
                if got_crc != int(stored_crc):
                    raise ValueError(
                        f"corrupt checkpoint: crc32 mismatch (stored "
                        f"{int(stored_crc):#010x}, computed {got_crc:#010x})"
                        " — the blob was truncated or bit-flipped in "
                        "storage; refusing to deserialize garbage state")
        else:                                    # v1: raw fstate_to_arrays
            arrays = blob
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        old_shards = _layout_of(arrays)
        if blob.get("shards") is not None and blob["shards"] != old_shards:
            raise ValueError(
                f"corrupt checkpoint: envelope says {blob['shards']} "
                f"shard(s) but the state arrays carry {old_shards}")
        if src_replicated is None:
            # v1 blobs carry no layout tag: replicated shards are bitwise
            # identical (the eager-CENTRALIZED invariant); anything else
            # accumulated per shard
            src_replicated = old_shards > 1 and all(
                bool(np.all(arrays[k] == arrays[k][0]))
                for k in _SUM_KEYS if k in arrays)
        new_shards = self.num_shards if self.sharded else 0
        if old_shards != new_shards \
                or src_replicated != self._stats_replicated:
            arrays = reshard_state_arrays(
                arrays, new_shards, groups=self.filter.specs.groups,
                src_replicated=src_replicated,
                tgt_replicated=self._stats_replicated)
        restored = fstate_from_arrays(arrays, self.device)
        self._anchor(restored, int(np.max(arrays["rows_into_epoch"])),
                     foreign=True)
        return restored


#: chain-lint findings already warned about in this process (once per
#: (code, location): plans are rebuilt often)
_LINT_WARNED: set[tuple[str, str]] = set()


def _lint_plan_chain(plan: FilterPlan) -> None:
    """Plan-compile-time chain lint, as ``repro``'s ``build_session`` runs
    it: error findings (an unsatisfiable predicate, group or conjunction)
    raise, redundancy findings warn once per (code, location), info
    findings stay silent."""
    from repro_torch.analysis import chain_lint, diagnostics

    diags = chain_lint.lint_chain(plan.predicates)
    errs = diagnostics.errors(diags)
    if errs:
        raise ValueError("FilterPlan chain fails the semantics lint:\n"
                         + diagnostics.render_report(errs))
    for d in diagnostics.warnings_of(diags):
        key = (d.code, d.location)
        if key not in _LINT_WARNED:
            _LINT_WARNED.add(key)
            warnings.warn(f"repro_torch chain lint: {d.render()}",
                          UserWarning, stacklevel=3)


def build_session(plan: FilterPlan, device=None) -> FilterSession:
    """Compile a ``FilterPlan`` into a ``FilterSession`` on ``device``.

    Lints the chain first (``_lint_plan_chain``): a provably
    unsatisfiable chain raises here instead of cutting every row.
    ``device=None`` means ``"cuda"``; without a card that raises — pass
    ``device="cpu"`` to run on the CPU (the engines' plain paths).
    """
    _lint_plan_chain(plan)
    return FilterSession(plan, on_card_unless_asked(
        "cuda" if device is None else device, "build_session"))


# ========================================================== elastic reshard
def _layout_of(arrays: dict) -> int:
    """Shard layout of a state-arrays dict: 0 = unsharded (no leading
    axis), S >= 1 = stacked [S, ...] leaves."""
    rows = np.asarray(arrays["rows_into_epoch"])
    return 0 if rows.ndim == 0 else int(rows.shape[0])


_SUM_KEYS = ("stats.num_cut", "stats.cost_acc", "stats.n_monitored",
             "stats.group_cut", "rows_into_epoch")


def _consensus_order(merged: dict, groups: tuple):
    """(perm, group_perm) from merged accumulators: the rank math of the
    epoch boundary (``core.stats``), on CPU f32 tensors."""
    def f32(key):
        return torch.from_numpy(np.asarray(merged[key], np.float32))

    mstats = FilterStats(
        num_cut=f32("stats.num_cut"), cost_acc=f32("stats.cost_acc"),
        n_monitored=f32("stats.n_monitored"),
        group_cut=f32("stats.group_cut" if "stats.group_cut" in merged
                      else "stats.num_cut"))
    grank = stats_lib.group_ranks(mstats, groups)
    mrank = stats_lib.member_ranks(mstats)
    perm, gperm = stats_lib.cnf_order(grank, mrank, groups)
    return perm.numpy().astype(np.int32), gperm.numpy().astype(np.int32)


def reshard_state_arrays(arrays: dict, new_shards: int, groups: tuple,
                         src_replicated: bool = False,
                         tgt_replicated: bool = False) -> dict:
    """S→S′ elastic reshard of checkpointed state arrays (numpy), with
    ``repro.core.session.reshard_state_arrays``'s rules.

    The epoch accumulators (``stats.*``) merge to one logical executor by
    the SOURCE layout — the sum over the shard axis when the source
    accumulated per shard (partitioned), the first row when every shard
    held the global totals (replicated: eager CENTRALIZED) — and are laid
    out for the TARGET: split evenly over a partitioned target (the next
    boundary merge gives back the source totals; exact when S′ is a power
    of two), whole on every shard of a replicated target and for
    ``new_shards=0`` (unsharded). ``rows_into_epoch`` is a per-shard phase
    counter, so its maximum goes to every shard. Derived arrays (perm,
    group_perm, adj_rank, epoch) are taken as they are when every source
    shard agrees, and otherwise re-derived from the merged statistics
    with the boundary's rank math (adj_rank the shards' mean, epoch their
    maximum).
    """
    old = _layout_of(arrays)
    stacked = {k: np.asarray(v) for k, v in arrays.items()}
    if old == 0:                      # promote to a 1-shard stack
        stacked = {k: v[None] for k, v in stacked.items()}

    # ---- merge to one logical executor ------------------------------------
    merged: dict[str, np.ndarray] = {}
    for k, v in stacked.items():
        if k == "rows_into_epoch":
            merged[k] = v.max(axis=0)
        elif k in _SUM_KEYS:
            if src_replicated:
                merged[k] = v[0].astype(np.float64)
            elif np.issubdtype(v.dtype, np.integer):
                merged[k] = v.sum(axis=0, dtype=np.int64)
            else:
                merged[k] = v.astype(np.float64).sum(axis=0)
        else:
            merged[k] = v[0]
    shards_agree = all(bool(np.all(v == v[0])) for k, v in stacked.items()
                       if k not in _SUM_KEYS)
    if not shards_agree:
        merged["adj_rank"] = stacked["adj_rank"].astype(np.float64) \
            .mean(axis=0).astype(np.float32)
        if float(np.float32(merged["stats.n_monitored"])) > 0.0:
            merged["perm"], merged["group_perm"] = _consensus_order(
                merged, groups)
        merged["epoch"] = stacked["epoch"].max(axis=0)

    # ---- split over the new layout ----------------------------------------
    split_by = 1 if (tgt_replicated or new_shards == 0) \
        else max(new_shards, 1)
    out: dict[str, np.ndarray] = {}
    for k, v in merged.items():
        src_dtype = stacked[k].dtype
        if k in _SUM_KEYS and k != "rows_into_epoch":
            if np.issubdtype(src_dtype, np.integer):
                piece = (v // split_by).astype(src_dtype)
            else:
                piece = (v / split_by).astype(src_dtype)
        else:
            piece = np.asarray(v).astype(src_dtype)
        if new_shards == 0:
            out[k] = piece
        else:
            out[k] = np.broadcast_to(
                piece[None], (new_shards,) + piece.shape).copy()
    return out
