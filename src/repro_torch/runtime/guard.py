"""GuardedSession: self-healing wrapper around ``FilterSession.step``.

PyTorch port of ``repro.runtime.guard``. The paper's operator only pays
off on *long-running* streams — which means the runtime around it must
survive what long-running streams actually serve: NaN/Inf-poisoned
batches, adversarial traffic storms that overflow the compaction
capacity, transient step failures, bit-rotted checkpoints, and corrupted
device state. Strider (arXiv 1705.05688) frames continuous queries as
processes that must outlive their faults; Cuttlefish (arXiv 1802.09180)
shows switching physical operators online is cheap — the same primitive,
driven by failure counters instead of reward, is a *degrade ladder*:

  detection
    * data-plane admission: a poisoned (non-finite) batch never reaches
      the step — it is QUARANTINED (all-False mask, zero metrics, state
      unchanged, ``StepResult.quarantined=True``; a tokenize plan's result
      carries zero tokens, so a pipeline goes on past it). A host batch
      is checked with numpy, a tensor with one
      ``torch.isfinite(cols).all()`` read. A sharded session is guarded
      whole: admission on the ``[C, S·R]`` batch, the overflow rung on
      the shards' summed ``n_dropped``, the validator and the ring on the
      stacked state;
    * capacity overflow: ``n_dropped > 0`` under a bounded compaction
      width (a column storm) triggers a lossless re-run of the SAME batch
      from the pre-step state — no survivor is ever lost, no statistic is
      folded twice (one read of ``n_dropped`` per step);
    * state integrity: ``FilterSession.validate_state`` — every
      structural invariant fused into ONE boolean, ONE device read —
      runs once per validation boundary, never per step;
    * checkpoint integrity: every ring entry is the session's versioned
      blob with its crc32; a bit-flipped entry is rejected at restore and
      the ring falls back to the next-newest valid blob.

  recovery
    * bounded retry with exponential backoff + deterministic jitter for
      transient step failures (injected node kills recover here). A
      fault of the kernel or the device is not transient: a
      ``KernelError`` (the kernel library did not build or load, a launch
      returned a CUDA error, or a wrapper refused to launch) and a CUDA
      error that torch reports (``torch.AcceleratorError``, or a
      ``RuntimeError`` reading "CUDA error") propagate at once, never
      retried and never degraded to the ``torch`` engine, which would
      hide a kernel that does not run;
    * rollback to a ring of the last-K integrity-checked checkpoints when
      the state itself is corrupt, with stream-cursor replay through the
      counter-based stream (``run_log_stream``) — replayed batch indices
      simply overwrite their earlier, suspect results;
    * a graceful-degradation ladder driven by consecutive failures:
      cuda → torch engine (on the same device: ``torch`` runs on the
      card too; a ``numpy`` plan starts below this rung, as in
      ``repro``), skip_tier → off, fused → mask compaction (bounded
      capacity → lossless). Plan fingerprints exclude exactly these
      execution fields, so the live ``OrderState`` and every ring
      checkpoint stay valid across all rungs. The ladder also climbs
      back UP: after ``GuardPolicy.promote_after`` consecutive validated
      boundaries with no fault, the newest degrade is reverted
      (``GuardHealth.promotes`` records each climb). A failure that
      outlasts the bottom rung propagates.

Survivor bit-parity: masks depend on the predicate SET, not the evaluation
order, so quarantine-induced statistic divergence, rollback replay, and
ladder rungs never change which rows survive.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import random
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.adaptive_filter import StepMetrics
from repro_torch.core.session import FilterSession, StepResult
from repro_torch.kernels.filter_chain.filter_chain import KernelError

log = logging.getLogger(__name__)


def _not_transient(e: Exception) -> bool:
    """A fault that no retry and no rung of the ladder cures: the guard's
    own state error, a kernel build, launch or refusal, or a CUDA error
    raised by torch (the context of a sticky one is lost for every
    engine on the card)."""
    accel = getattr(torch, "AcceleratorError", None)
    return isinstance(e, (GuardStateError, KernelError)) \
        or (accel is not None and isinstance(e, accel)) \
        or (isinstance(e, RuntimeError) and str(e).startswith("CUDA error"))


class GuardStateError(RuntimeError):
    """Unrecoverable: state invalid and no ring checkpoint restores."""


class GuardRollback(Exception):
    """Internal control flow: a ring rollback needs the STREAM rewound.

    Raised by ``step`` only under ``run_log_stream`` (which owns the
    cursor); carries the restored state and the replay cursor.
    """

    def __init__(self, state, cursor: int, entry_step: int):
        super().__init__(f"rollback to ring checkpoint @step {entry_step}")
        self.state = state
        self.cursor = cursor
        self.entry_step = entry_step


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Recovery policy knobs (all counters in steps, delays in seconds)."""

    max_retries: int = 3          # bounded retry per step before degrading
    backoff_base_s: float = 0.05  # first retry delay; doubles per attempt
    backoff_max_s: float = 2.0
    jitter: float = 0.25          # ± fraction of the delay, seeded
    ring_size: int = 4            # last-K integrity-checked checkpoints
    checkpoint_every: int = 16    # steps between ring snapshots
    validate_every: int = 4       # steps between validator syncs
    # re-promotion: after this many CONSECUTIVE validated boundaries with
    # no fault of any kind (quarantine/retry/overflow/validator), climb
    # the degradation ladder back UP one rung (0 disables — degrades are
    # then permanent for the session's lifetime)
    promote_after: int = 0
    seed: int = 0                 # backoff-jitter determinism
    # injectable clock for tests (never sleep real seconds in CI)
    sleep: Callable[[float], None] = time.sleep


@dataclasses.dataclass
class GuardHealth:
    """Counters every recovery path accounts into (serve metrics)."""

    steps: int = 0                # batches that produced a live result
    quarantined: int = 0          # poisoned batches refused at admission
    retries: int = 0              # step failures absorbed by retry
    rollbacks: int = 0            # ring restores (state corruption)
    validator_failures: int = 0   # boundary validations that came back False
    crc_rejects: int = 0          # ring blobs refused (corrupt/invalid)
    overflow_events: int = 0      # capacity storms degraded to lossless
    degrades: list = dataclasses.field(default_factory=list)
    promotes: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["n_degrades"] = len(self.degrades)
        d["n_promotes"] = len(self.promotes)
        return d

    def summary(self) -> str:
        return (f"steps={self.steps} quarantined={self.quarantined} "
                f"retries={self.retries} rollbacks={self.rollbacks} "
                f"crc_rejects={self.crc_rejects} "
                f"overflows={self.overflow_events} "
                f"degrades={len(self.degrades)} "
                f"promotes={len(self.promotes)}")


_RingEntry = collections.namedtuple("_RingEntry", "step cursor blob")


class GuardedSession:
    """Wrap a ``FilterSession`` with detection + recovery (module docstring).

    Drop-in: exposes the full session surface (``plan``, ``device``,
    ``init_state``, ``save_state``/``restore_state``, ...) by delegation,
    so the pipelines and launchers drive it exactly like the bare session.

    ``step_injector``/``state_injector`` are chaos hooks: the first is
    called with the step index inside the retry scope (raise to simulate a
    node failure — ``FailureInjector.maybe_fail`` fits directly), the
    second maps ``(step_index, state) -> state`` before the step runs
    (return a corrupted state to simulate device-state rot; the boundary
    validator must catch it).
    """

    is_guarded_session = True

    def __init__(self, session: FilterSession,
                 policy: GuardPolicy = GuardPolicy(), *,
                 health: GuardHealth | None = None,
                 step_injector: Callable[[int], None] | None = None,
                 state_injector: Callable[[int, Any], Any] | None = None):
        self.session = session
        self.policy = policy
        self.health = health if health is not None else GuardHealth()
        self.step_injector = step_injector
        self.state_injector = state_injector
        self._ring: collections.deque = collections.deque(
            maxlen=policy.ring_size)
        self._rng = random.Random(policy.seed)
        self._step_idx = 0
        self._stream_cursor = 0       # set by run_log_stream before steps
        self._raise_rollback = False  # True only under run_log_stream
        # re-promotion bookkeeping: each degrade pushes the INVERSE plan
        # changes; ``promote_after`` consecutive fault-free validated
        # boundaries pop one rung back (see _note_boundary)
        self._degrade_stack: list[dict] = []
        self._healthy_boundaries = 0
        self._fault_since = False     # any fault since the last boundary

    # ------------------------------------------------------------ delegation
    def __getattr__(self, name):
        if name == "session":       # not set yet: don't recurse during init
            raise AttributeError(name)
        return getattr(self.session, name)

    def init_state(self):
        state = self.session.init_state()
        self._ring.clear()
        self._snapshot(state)
        return state

    def restore_state(self, blob: dict):
        state = self.session.restore_state(blob)
        self._ring.clear()
        self._snapshot(state)
        return state

    def with_tokenize(self, spec) -> "GuardedSession":
        return GuardedSession(self.session.with_tokenize(spec), self.policy,
                              health=self.health,
                              step_injector=self.step_injector,
                              state_injector=self.state_injector)

    # ---------------------------------------------------------------- step
    def step(self, state, batch):
        """One guarded micro-batch; same signature/ABI as the session's."""
        i = self._step_idx
        self._step_idx += 1

        cols = np.asarray(batch, np.float32) if isinstance(
            batch, (np.ndarray, list)) else batch

        # ---- data-plane admission: quarantine poisoned batches
        if not self._batch_finite(cols):
            self.health.quarantined += 1
            self._fault_since = True
            log.warning("guard: quarantined poisoned batch at step %d "
                        "(non-finite values); state unchanged", i)
            return state, self._quarantined_result(state, cols)

        if self.state_injector is not None:
            state = self.state_injector(i, state)

        # ---- bounded retry + degrade ladder for step failures
        new_state, res = self._step_with_retry(state, cols, i)

        # ---- column storm: overflow under a bounded capacity
        if res.capacity is not None \
                and int(res.metrics.n_dropped.sum()) > 0:
            self.health.overflow_events += 1
            self._fault_since = True
            if self._degrade_lossless(
                    f"capacity overflow at step {i}"):
                # SAME batch, PRE-step state: survivors recovered losslessly
                # and the epoch statistics fold exactly once
                new_state, res = self.session.step(state, cols)

        # ---- boundary validation + ring snapshot
        p = self.policy
        snapshot_due = self._step_idx % p.checkpoint_every == 0
        if snapshot_due or self._step_idx % p.validate_every == 0:
            if not self.session.validate_state(new_state):
                self.health.validator_failures += 1
                self._fault_since = True
                new_state, res = self._recover(state, cols, i)
                snapshot_due = False      # never snapshot a suspect epoch
            self._note_boundary(i)
        if snapshot_due:
            self._snapshot(new_state)
        self.health.steps += 1
        return new_state, res

    def _note_boundary(self, i: int) -> None:
        """Validated-boundary bookkeeping for re-promotion: a boundary
        with no fault since the previous one extends the healthy window;
        any fault (quarantine/retry/overflow/validator) resets it. After
        ``policy.promote_after`` consecutive clean boundaries the
        degradation ladder climbs back UP one rung — a recurring fault
        simply degrades again, so a flapping rung oscillates with period
        ``promote_after`` instead of pinning the session at the bottom."""
        if self._fault_since:
            self._fault_since = False
            self._healthy_boundaries = 0
            return
        self._healthy_boundaries += 1
        p = self.policy
        if p.promote_after > 0 and self._degrade_stack \
                and self._healthy_boundaries >= p.promote_after:
            self._promote_once(
                f"{self._healthy_boundaries} clean validated boundaries "
                f"ending at step {i}")
            self._healthy_boundaries = 0

    # -------------------------------------------------------------- recovery
    def _step_with_retry(self, state, cols, i: int):
        attempt = 0
        while True:
            try:
                if self.step_injector is not None:
                    self.step_injector(i)
                return self.session.step(state, cols)
            except Exception as e:           # noqa: BLE001 — retry scope
                if _not_transient(e):
                    raise
                attempt += 1
                self._fault_since = True
                if attempt <= self.policy.max_retries:
                    self.health.retries += 1
                    self._backoff(attempt, i, e)
                    continue
                if self._degrade_once(
                        f"{self.policy.max_retries} consecutive step "
                        f"failures at step {i}: {e}"):
                    attempt = 0
                    continue
                raise

    def _backoff(self, attempt: int, i: int, exc: Exception) -> None:
        p = self.policy
        delay = min(p.backoff_base_s * (2.0 ** (attempt - 1)), p.backoff_max_s)
        delay *= 1.0 + p.jitter * (2.0 * self._rng.random() - 1.0)
        log.warning("guard: step %d failed (%s); retry %d/%d in %.3fs",
                    i, exc, attempt, p.max_retries, delay)
        p.sleep(delay)

    def _recover(self, pre_state, cols, i: int):
        """Post-step state failed validation: replay, then roll back.

        1. If the PRE-step state still validates, the corruption happened
           in flight — re-run the batch from it.
        2. Otherwise the state itself rotted: restore the newest ring
           checkpoint that passes crc + validation and re-run the batch
           from there (under ``run_log_stream`` this raises
           ``GuardRollback`` instead, so the stream cursor replays every
           suspect batch since that snapshot).
        3. If even the replay result fails validation, the BATCH drives
           the state invalid: quarantine it and keep the healthy state.
        """
        if self.session.validate_state(pre_state):
            new_state, res = self.session.step(pre_state, cols)
            if self.session.validate_state(new_state):
                return new_state, res
            self.health.quarantined += 1
            log.warning("guard: batch at step %d corrupts any state it "
                        "touches; quarantined", i)
            return pre_state, self._quarantined_result(pre_state, cols)

        entry, restored = self._restore_newest_valid()
        self.health.rollbacks += 1
        log.warning("guard: state corrupt at step %d; rolled back to ring "
                    "checkpoint from step %d", i, entry.step)
        if self._raise_rollback:
            raise GuardRollback(restored, entry.cursor, entry.step)
        new_state, res = self.session.step(restored, cols)
        if self.session.validate_state(new_state):
            return new_state, res
        self.health.quarantined += 1
        return restored, self._quarantined_result(restored, cols)

    def _restore_newest_valid(self):
        """Newest ring entry whose blob passes crc AND whose state passes
        the validator; corrupt entries are skipped (accounted) — the
        integrity-checked-ring contract."""
        for entry in reversed(self._ring):
            try:
                st = self.session.restore_state(entry.blob)
            except ValueError as e:
                self.health.crc_rejects += 1
                log.warning("guard: ring checkpoint @step %d rejected: %s",
                            entry.step, e)
                continue
            if self.session.validate_state(st):
                return entry, st
            self.health.crc_rejects += 1
        raise GuardStateError(
            "state validation failed and no ring checkpoint restores "
            "cleanly — the session cannot self-heal; restart from durable "
            "storage")

    # --------------------------------------------------------- degrade ladder
    def _degrade_once(self, reason: str) -> bool:
        """One rung down: cuda→torch, then skip_tier→off, then fused→mask
        compaction. Returns False when already at the bottom. ``torch``
        and ``numpy`` are bottom engines, as ``jnp`` and ``numpy`` are in
        ``repro``: a ``numpy`` plan's first rung is its skip tier."""
        plan = self.session.plan
        if plan.engine not in ("torch", "numpy"):
            changes: dict = {"engine": "torch"}
        elif plan.skip_tier != "off":
            changes = {"skip_tier": "off"}
        elif plan.compact and plan.tokenize is None:
            changes = {"compact": False, "capacity": None}
        elif plan.compact and plan.capacity is not None:
            changes = {"capacity": None}     # tokenize needs compact: go
        else:                                # lossless instead of mask
            return False
        self._swap_plan(changes, reason)
        return True

    def _degrade_lossless(self, reason: str) -> bool:
        """Storm response: drop the bounded capacity, keep everything else."""
        plan = self.session.plan
        if not plan.compact or plan.capacity is None:
            return False
        self._swap_plan({"capacity": None}, reason)
        return True

    def _swap_plan(self, changes: dict, reason: str) -> None:
        """One rung DOWN: apply ``changes`` and push their inverse so a
        healthy window can climb back (see ``_note_boundary``)."""
        inverse = {k: getattr(self.session.plan, k) for k in changes}
        event = self._apply_plan(changes, reason)
        self._degrade_stack.append(inverse)
        self._healthy_boundaries = 0
        self._fault_since = True
        self.health.degrades.append(event)
        log.warning("guard: degraded %s (%s)", event["changes"], reason)

    def _promote_once(self, reason: str) -> None:
        """One rung UP: pop the newest degrade's inverse and re-apply it.
        If the fault recurs, the regular ladder degrades again."""
        changes = self._degrade_stack.pop()
        event = self._apply_plan(changes, reason)
        self.health.promotes.append(event)
        log.info("guard: re-promoted %s (%s)", event["changes"], reason)

    def _apply_plan(self, changes: dict, reason: str) -> dict:
        old = self.session
        new = FilterSession(dataclasses.replace(old.plan, **changes),
                            old.device)
        # the host row mirror survives the swap (plan fingerprints exclude
        # every changed field, so the live OrderState and all ring blobs
        # remain loadable as-is). The new filter has no auto capacity yet:
        # marked foreign, its first step retunes it, as repro's fresh
        # filter does on the first step after a swap
        new._rows_host, new._rows_ref = old._rows_host, old._rows_ref
        new._foreign = True
        self.session = new
        return {"step": self._step_idx, "reason": reason,
                "changes": {k: str(v) for k, v in changes.items()}}

    def health_snapshot(self) -> dict:
        """Health counters plus the ladder's CURRENT rungs — what the
        admission server exports into its metrics."""
        d = self.health.to_dict()
        p = self.session.plan
        d["rungs"] = {"engine": p.engine, "skip_tier": p.skip_tier,
                      "compact": p.compact, "capacity": str(p.capacity),
                      "degrade_depth": len(self._degrade_stack)}
        return d

    # ------------------------------------------------------------------ ring
    def _snapshot(self, state) -> None:
        self._ring.append(_RingEntry(
            step=self._step_idx, cursor=self._stream_cursor,
            blob=self.session.save_state(state)))

    # ------------------------------------------------------------- admission
    def _batch_finite(self, cols) -> bool:
        if isinstance(cols, np.ndarray):
            return bool(np.isfinite(cols).all())
        return bool(torch.isfinite(cols).all())

    def _quarantined_result(self, state, cols) -> StepResult:
        """All-False mask and zero metrics on the state's device, one per
        shard when sharded; the perm, epoch and ranks are the (unchanged)
        state's own. A compacting plan's result keeps nothing (``n_kept``
        0, an empty pack) and a tokenize plan's carries no token
        (``n_tokens`` 0), so a pipeline goes on past the batch. ``repro``
        returns no tokens there, and its pipeline stops; the port departs
        from it on purpose."""
        dev = state.perm.device
        plan = self.session.plan
        lead = (self.session.num_shards,) if self.session.sharded else ()

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(lead + shape, dtype=dtype, device=dev)

        z32 = zeros()
        metrics = StepMetrics(
            work_units=zeros(dtype=torch.float32), n_pass=z32,
            perm=state.perm, epoch=state.epoch, adj_rank=state.adj_rank,
            n_dropped=z32, n_tiles_pass=z32, n_tiles_fail=z32,
            n_tiles_ambiguous=z32)
        mask = torch.zeros((int(cols.shape[1]),), dtype=torch.bool,
                           device=dev)
        packed = n_kept = tokens = n_tokens = None
        if plan.compact:
            packed = zeros(int(cols.shape[0]), 0, dtype=torch.float32)
            n_kept = z32
        if plan.tokenize is not None:
            tokens, n_tokens = zeros(0), z32
        return StepResult(mask, packed, n_kept, tokens, n_tokens, metrics,
                          None, warn_cell=None, quarantined=True, gate_s=0.0)

    # ------------------------------------------------------------ stream run
    def run_log_stream(self, stream, state=None, *,
                       batch_hook: Callable | None = None) -> tuple:
        """Drive a whole counter-based stream (``LogStream`` or
        ``RequestStream``) under guard.

        The full recovery story, including CURSOR REPLAY: ring snapshots
        record the stream cursor, and a rollback rewinds the stream to the
        snapshot's cursor (counter-based generation makes this exact), so
        every batch stepped on a suspect state is re-run — its replayed
        result simply overwrites the earlier one.

        ``batch_hook(batch_index, cols) -> cols`` is the data-plane fault
        injection point; it MUST be a pure function of its arguments
        (``DataFaultInjector`` is) so replay re-applies identical faults.

        Returns ``(final_state, results)`` where ``results`` maps the
        global batch index to its final ``StepResult``.
        """
        if state is None:
            state = self.session.init_state()
        self._ring.clear()
        self._stream_cursor = stream.cursor
        self._snapshot(state)       # there is always a rollback target
        results: dict[int, StepResult] = {}
        self._raise_rollback = True
        try:
            for rb in stream:       # the generator reads `cursor` live —
                b = rb.row_offset // stream.batch_rows   # rewind-safe
                cols = rb.columns if batch_hook is None \
                    else batch_hook(b, rb.columns)
                self._stream_cursor = stream.cursor
                try:
                    state, res = self.step(state, cols)
                except GuardRollback as g:
                    state = g.state
                    stream.cursor = g.cursor
                    continue
                results[b] = res
        finally:
            self._raise_rollback = False
        return state, results
