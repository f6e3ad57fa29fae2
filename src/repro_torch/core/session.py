"""FilterSession: a compiled FilterPlan with ONE step entry point.

PyTorch port of ``repro.core.session`` (unsharded). ``build_session(plan,
device=None)`` places the session on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no CPU asked for, it raises.

    state, result = session.step(state, batch)

``StepResult`` is the uniform step ABI (mask, packed + n_kept under
compaction, tokens + n_tokens under a ``TokenizeSpec``, metrics) with
host accessors that copy on demand. A step reads nothing from the device:
the epoch boundary comes from a host mirror of ``rows_into_epoch`` (it
advances by the static batch width), and the tokenize stage reads no
count, so the only device→host copies of a step are the
``capacity="auto"`` retune after a boundary, the one re-anchoring read
when a state arrives that this session did not produce, and the skip
tier's: the ambiguous-tile count that sizes the ``torch`` engine's
gather (none on ``cuda``), and the ``skip_tier="auto"`` tuner's wall
clock (a ``synchronize`` plus one read of the tile counters on the
tier's arm).

Checkpoints are the reference's schema v2 envelope (plan fingerprint,
shard layout, crc32 over the state arrays) and load v1 raw-array blobs;
blobs move between ``repro`` and ``repro_torch`` in both directions.
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
from repro_torch.core.adaptive_filter import AdaptiveFilter, StepMetrics
from repro_torch.core.ordering import OrderState
from repro_torch.core.plan import FilterPlan, TokenizeSpec
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
        """Surviving rows as a host f32[C, n_pass] array.

        Under compaction (incl. tokenize plans) this reads ``n_kept`` once
        and copies only ``packed[:, :n_kept]``; otherwise it boolean-
        indexes ``columns`` (required then). Tokenize-plan pipelines
        prefer ``host_tokens``: only the dense token stream crosses to the
        host there."""
        self._maybe_warn_overflow()
        if self.packed is not None:
            return _np(self.packed[:, :int(_np(self.n_kept))])
        if columns is None:
            raise ValueError("no compaction in this session: pass the "
                             "original columns to slice by mask")
        return _np(columns)[:, self.mask_np]

    def host_tokens(self) -> np.ndarray:
        """Dense packed token stream (device tokenize sessions only):
        reads ``n_tokens`` once and copies only ``tokens[:n_tokens]``."""
        if self.tokens is None:
            raise ValueError("session has no tokenize stage "
                            "(FilterPlan.tokenize is None)")
        return _np(self.tokens[:int(_np(self.n_tokens))])

    def metrics_dict(self) -> dict:
        """The JSON metrics encoding (same keys as ``repro``'s)."""
        self._maybe_warn_overflow()
        m = self.metrics
        return {
            "work_units": float(_np(m.work_units).sum()),
            "n_pass": int(_np(m.n_pass).sum()),
            "perm": _np(m.perm).tolist(),
            "epoch": int(_np(m.epoch).max()),
            "n_dropped": int(_np(m.n_dropped).sum()),
            "n_tiles_skipped_pass": self.n_tiles_skipped_pass,
            "n_tiles_skipped_fail": self.n_tiles_skipped_fail,
            "n_tiles_ambiguous": self.n_tiles_ambiguous,
            "quarantined": bool(self.quarantined),
        }


# ============================================================ state validation
def state_invariants(state: OrderState, *, n_predicates: int, n_groups: int,
                     collect_rate: int, calculate_rate: int,
                     rows_bounded: bool = True) -> torch.Tensor:
    """ONE fused boolean (a bool[] tensor) over every structural invariant
    of an OrderState: finite, non-negative accumulators; cut counts within
    ``n_monitored``; ``perm``/``group_perm`` true permutations; counters
    in range."""
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
    fields under a ``stats.`` prefix."""
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

    def __init__(self, plan: FilterPlan, device, *,
                 _filter: AdaptiveFilter | None = None):
        self.plan = plan
        self.device = torch.device(device)
        self.filter = (_filter if _filter is not None
                       else AdaptiveFilter(plan, self.device))
        # host mirror of rows_into_epoch and the tensor it mirrors; whether
        # that state came from outside (a restore or a foreign state)
        self._rows_host = 0
        self._rows_ref = None
        self._foreign = False
        # skip_tier="auto": the online us_per_row tuner (lazy; host-owned)
        self._skip_tuner: skip_tier_lib.SkipTierTuner | None = None

    def _anchor(self, state: OrderState, rows: int, *,
                foreign: bool = False) -> None:
        self._rows_host = rows
        self._rows_ref = state.rows_into_epoch
        self._foreign = foreign

    def init_state(self) -> OrderState:
        state = self.filter.init_state()
        self._anchor(state, 0)
        return state

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

        ``batch``: f32[C, R], a tensor on the session's device (or host
        data, copied there). Runs the skip-tier triage (when the plan's
        tier is on for this step), the chain (+ compaction), fires the
        epoch boundary the host mirror says is due (the deferred exchange,
        for deferred plans) and retunes ``capacity="auto"`` after a
        boundary, or on the first step from a restored or foreign state
        (whose epoch may be past the last one the tuner saw, as repro's
        every-step check finds).
        """
        t_gate = time.perf_counter()
        cols = torch.as_tensor(batch, dtype=torch.float32, device=self.device)
        n_rows = int(cols.shape[1])
        f = self.filter
        if state.rows_into_epoch is not self._rows_ref:
            # a state this session did not produce: re-anchor (one read)
            self._anchor(state, self._sync_rows_into_epoch(state),
                         foreign=True)
        retune = self._foreign
        fire, rows = f.rows_after(self._rows_host, n_rows)
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
            cap = f.resolve_capacity(n_rows)
            state, packed, n_kept, mask, metrics = f._step_compact(
                state, cols, capacity=cap, fire=fire, skip=skip,
                amb_cap=amb_cap)
            if self.plan.tokenize is not None:
                # imported here: repro_torch.data imports this module
                from repro_torch.data import tokenizer
                ts = self.plan.tokenize
                tokens, n_tokens = tokenizer.tokens_from_padded(
                    packed, n_kept, ts.vocab_size, ts.tokens_per_row)
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
            f.observe_for_capacity(prev, state, n_rows)
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
    def save_state(self, state: OrderState) -> dict:
        """Versioned checkpoint blob (schema v2), as ``repro`` writes it."""
        arrays = fstate_to_arrays(state)
        return {
            "format": CKPT_FORMAT,
            "version": CKPT_VERSION,
            "fingerprint": self.plan.fingerprint(),
            "shards": 0,
            "stats_layout": "partitioned",
            "crc32": arrays_crc32(arrays),
            "arrays": arrays,
        }

    def restore_state(self, blob: dict) -> OrderState:
        """Load a v1 (raw arrays) or v2 (versioned) unsharded blob.

        Rejects another plan's fingerprint and a crc32 mismatch with a
        ValueError. A sharded blob needs the elastic reshard of the
        sharding slice and raises NotImplementedError.
        """
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
        rows = np.asarray(arrays["rows_into_epoch"])
        old_shards = 0 if rows.ndim == 0 else int(rows.shape[0])
        if blob.get("shards") is not None and blob["shards"] != old_shards:
            raise ValueError(
                f"corrupt checkpoint: envelope says {blob['shards']} "
                f"shard(s) but the state arrays carry {old_shards}")
        if old_shards:
            raise NotImplementedError(
                "restoring a sharded checkpoint into an unsharded session "
                "needs the elastic reshard: ROADMAP.md queue 1 item 10 "
                "(sharding) is not ported yet")
        restored = fstate_from_arrays(arrays, self.device)
        self._anchor(restored, int(rows), foreign=True)
        return restored


def build_session(plan: FilterPlan, device=None) -> FilterSession:
    """Compile a ``FilterPlan`` into a ``FilterSession`` on ``device``.

    ``device=None`` means ``"cuda"``; without a card that raises — pass
    ``device="cpu"`` to run on the CPU (the engines' plain paths).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_session: no CUDA device is available; repro_torch runs "
            "on the GPU unless device='cpu' is passed explicitly")
    return FilterSession(plan, device)
