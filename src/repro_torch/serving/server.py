"""Continuous-batching admission server: queued ingest → adaptive
guardrail gate → packed prefill/decode slots.

PyTorch port of ``repro.serving.server``. The shape of an
offline-inference server (MaxText/JetStream style), with the paper's
adaptive filter as the admission gate:

    ingest thread ──► request queue (bounded) ──► GATE (FilterSession /
        GuardedSession.step, FIFO per micro-batch)
            ├─ rejected / quarantined → result queue (answered
            │     immediately with a reason code)
            └─ admitted → backlog (bounded) → free slot → prefill →
                  one decode tick per server loop → result queue

    collector thread ◄── result queue (bounded)

No global barrier anywhere: a freed slot is refilled from the backlog on
the same loop iteration, and the gate keeps deciding new micro-batches
while slots decode.

ADMISSION DETERMINISM — the property everything else leans on: the gate
consumes micro-batches in FIFO arrival order from ONE queue, and the
adaptive state advances only through ``session.step``. Queue depth, slot
timing, thread scheduling, and executor speed therefore change admission
LATENCY but never admission DECISIONS: the admit/reject sequence and the
final ``OrderState`` are bit-identical to ``synchronous_reference`` over
the same seeded traffic. ``tests/test_torch_serving.py`` pins this, and
that the decisions equal ``repro``'s.

ACCOUNTING — every request the ingest thread enqueues gets exactly one
``RequestResult``: rejects/quarantines at decision time, admits at
decode completion. Bounded queues block (backpressure), never drop.

Graceful drain: a ``stop`` object with a truthy ``requested`` attribute
(``runtime.fault_tolerance.GracefulShutdown`` fits) stops the ingest
thread, finishes gating everything already queued, lets in-flight slots
decode to completion, and flushes a final checkpoint blob + health line
into the ``ServerReport``.

Hot-path discipline: ``AdmissionServer._gate_batch`` drives the gate and
nothing else; the ONE sanctioned device→host read of the serving loop is
``AdmissionServer._decide``: answering rejects immediately requires the
gate mask on the host, one copy per micro-batch. (A guarded gate adds
its own reads: PERF.md §2.)
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable

import numpy as np

from repro_torch.serving.metrics import ServerMetrics

REASON_ADMITTED = "admitted"
REASON_REJECTED = "rejected"
REASON_QUARANTINED = "quarantined"

_SENTINEL = object()


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Queue/slot geometry + drain knobs."""

    num_slots: int = 8            # fixed prefill/decode slots
    queue_depth: int = 8          # request & result queue bound (batches)
    max_backlog: int | None = None  # admitted awaiting a slot (None→4·slots)
    gate_poll_s: float = 0.001    # dequeue timeout while slots decode

    def backlog_bound(self) -> int:
        return self.max_backlog if self.max_backlog is not None \
            else 4 * self.num_slots


@dataclasses.dataclass
class GateItem:
    """One ingested micro-batch awaiting its admission decision."""

    batch_index: int
    cols: np.ndarray              # f32[C, B]
    row_start: int
    t_enqueue: float


@dataclasses.dataclass
class Ticket:
    """One ADMITTED request heading for a slot."""

    request_id: int               # global row id (row_start + offset)
    batch_index: int
    features: np.ndarray          # f32[C]


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """The answer every ingested request gets exactly once."""

    request_id: int
    batch_index: int
    reason: str                   # admitted | rejected | quarantined
    latency_s: float              # enqueue → admission decision
    decode_steps: int = 0         # admitted only: slot ticks consumed


@dataclasses.dataclass
class ServerReport:
    """Everything a run produced (drives the CLI's payload + the tests)."""

    results: list                 # RequestResult, completion order
    masks: dict                   # batch_index → admission mask (np.bool_)
    state: Any                    # final OrderState (on the gate's device)
    state_blob: dict              # final versioned checkpoint (always)
    metrics: dict                 # ServerMetrics.snapshot(...)
    drained: bool                 # True when a stop request ended the run
    health_line: str | None      # guarded runs: GuardHealth.summary()

    def results_by_id(self) -> dict:
        return {r.request_id: r for r in self.results}


class SimExecutor:
    """Deterministic stand-in slot executor: decode length is a pure
    function of the request features, so run output is reproducible and
    tests can meter slot pressure with ``tick_s``."""

    def __init__(self, max_decode_steps: int = 8, tick_s: float = 0.0):
        self.max_decode_steps = max_decode_steps
        self.tick_s = tick_s

    def prefill(self, ticket: Ticket):
        return 1 + int(abs(float(ticket.features[0]))) % self.max_decode_steps

    def advance(self, remaining):
        if self.tick_s:
            time.sleep(self.tick_s)
        remaining -= 1
        return remaining, remaining <= 0


class _IngestThread(threading.Thread):
    """Background producer: generates the stream, applies the (pure)
    batch hook, stamps enqueue time, and blocks on the bounded queue —
    backpressure, never drops. Always terminates the queue with the
    sentinel, even on error or early stop."""

    def __init__(self, stream, out_q: queue.Queue, stop_event: threading.Event,
                 hook: Callable | None, metrics: ServerMetrics):
        super().__init__(name="serve-ingest", daemon=True)
        self.stream = stream
        self.out_q = out_q
        self.stop_event = stop_event
        self.hook = hook
        self.metrics = metrics

    def run(self) -> None:
        try:
            for rb in self.stream:
                if self.stop_event.is_set():
                    break
                b = rb.row_offset // self.stream.batch_rows
                cols = rb.columns if self.hook is None \
                    else self.hook(b, rb.columns)
                self.metrics.note_ingest(int(cols.shape[1]))
                self.out_q.put(GateItem(b, cols, rb.row_offset,
                                        time.perf_counter()))
        finally:
            self.out_q.put(_SENTINEL)


class _CollectorThread(threading.Thread):
    """Drains the bounded result queue into the report's result list."""

    def __init__(self, in_q: queue.Queue, sink: list):
        super().__init__(name="serve-collect", daemon=True)
        self.in_q = in_q
        self.sink = sink

    def run(self) -> None:
        while True:
            item = self.in_q.get()
            if item is _SENTINEL:
                return
            self.sink.append(item)


class AdmissionServer:
    """The server (module docstring). ``session`` is a ``FilterSession``
    or ``GuardedSession``; ``stream`` follows the ``LogStream`` contract
    (``data.stream.RequestStream`` adapts any counter-based generator);
    ``executor`` provides ``prefill(ticket) -> ctx`` and
    ``advance(ctx) -> (ctx, done)`` (``SimExecutor`` by default, the
    model-backed one is ROADMAP.md queue 1 item 11); ``batch_hook(b,
    cols) -> cols`` is the pure data-plane fault-injection seam shared
    with ``GuardedSession.run_log_stream``; ``warmup_batch`` runs the
    gate once on a throwaway state before the clock starts, so the first
    request's latency holds no kernel build or first-launch cost."""

    def __init__(self, session, stream, config: ServerConfig = ServerConfig(),
                 *, executor=None, batch_hook: Callable | None = None,
                 warmup_batch: np.ndarray | None = None):
        self.session = session
        self.stream = stream
        self.config = config
        self.executor = executor if executor is not None else SimExecutor()
        self.batch_hook = batch_hook
        self.warmup_batch = warmup_batch
        self.metrics = ServerMetrics()
        self.request_q: queue.Queue = queue.Queue(maxsize=config.queue_depth)
        self.result_q: queue.Queue = queue.Queue(maxsize=config.queue_depth)
        self._backlog: list[Ticket] = []
        self._lat_by_id: dict[int, float] = {}
        self.masks: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ gate
    def _gate_batch(self, state, item: GateItem):
        """The serving admission step: drive the gate, then hand its
        outputs to the one sanctioned decision read. Nothing else may
        touch the device."""
        state, res = self.session.step(state, item.cols)
        self._decide(res, item)
        return state

    def _decide(self, res, item: GateItem) -> None:
        """THE sanctioned dequeue→decision read of the serving loop:
        rejects and quarantined batches are answered immediately with a
        reason code, which requires the gate mask on the host — one
        readback per micro-batch, by design."""
        mask = np.asarray(res.mask_np)
        now = time.perf_counter()
        latency = now - item.t_enqueue
        self.masks[item.batch_index] = mask
        quarantined = bool(getattr(res, "quarantined", False))
        n = int(mask.shape[0])
        if quarantined:
            self.metrics.note_decision(0, 0, n, latency,
                                       float(res.gate_s or 0.0))
            for off in range(n):
                self.result_q.put(RequestResult(
                    item.row_start + off, item.batch_index,
                    REASON_QUARANTINED, latency))
            return
        n_admit = int(mask.sum())
        self.metrics.note_decision(n_admit, n - n_admit, 0, latency,
                                   float(res.gate_s or 0.0))
        for off in np.flatnonzero(~mask):
            self.result_q.put(RequestResult(
                item.row_start + int(off), item.batch_index,
                REASON_REJECTED, latency))
        for off in np.flatnonzero(mask):
            self._backlog.append(Ticket(
                request_id=item.row_start + int(off),
                batch_index=item.batch_index,
                features=np.array(item.cols[:, int(off)])))
            self._lat_by_id[item.row_start + int(off)] = latency

    # ----------------------------------------------------------------- slots
    def _fill_slots(self, slots: list, free: list) -> None:
        while free and self._backlog:
            s = free.pop()
            tk = self._backlog.pop(0)
            slots[s] = (tk, self.executor.prefill(tk), 0)

    def _tick_slots(self, slots: list, free: list) -> None:
        occupied = [s for s in range(len(slots)) if slots[s] is not None]
        if not occupied:
            return
        for s in occupied:
            tk, ctx, ticks = slots[s]
            ctx, done = self.executor.advance(ctx)
            if done:
                self.result_q.put(RequestResult(
                    tk.request_id, tk.batch_index, REASON_ADMITTED,
                    self._lat_by_id.pop(tk.request_id, 0.0),
                    decode_steps=ticks + 1))
                self.metrics.note_completion()
                slots[s] = None
                free.append(s)
            else:
                slots[s] = (tk, ctx, ticks + 1)
        self.metrics.note_tick(len(occupied), len(slots))

    # ------------------------------------------------------------------- run
    def _warmup(self) -> None:
        """Warm the gate outside the measured window: one step on a
        throwaway state through the UNDERLYING session, so guarded
        health counters and the ring stay untouched. The session's host
        row mirror then follows the throwaway state, so a ``state``
        passed to ``run`` takes the session's foreign-state path (one
        re-anchoring read) and steps exactly as without the warmup."""
        if self.warmup_batch is None:
            return
        inner = getattr(self.session, "session", self.session)
        wstate = inner.init_state()
        inner.step(wstate, self.warmup_batch)

    def run(self, state=None, stop=None) -> ServerReport:
        cfg = self.config
        self._warmup()
        session = self.session
        if state is None:
            state = session.init_state()

        results: list[RequestResult] = []
        stop_ingest = threading.Event()
        ingest = _IngestThread(self.stream, self.request_q, stop_ingest,
                               self.batch_hook, self.metrics)
        collector = _CollectorThread(self.result_q, results)
        t0 = time.perf_counter()
        collector.start()
        ingest.start()

        slots: list = [None] * cfg.num_slots
        free: list[int] = list(range(cfg.num_slots))
        ingest_done = False
        drained = False
        backlog_bound = cfg.backlog_bound()
        while True:
            if stop is not None and getattr(stop, "requested", False) \
                    and not drained:
                drained = True
                stop_ingest.set()
            # 1) gate the next queued micro-batch (FIFO — determinism),
            #    unless the admitted backlog is at its bound
            if not ingest_done and len(self._backlog) < backlog_bound:
                try:
                    item = self.request_q.get(
                        timeout=cfg.gate_poll_s if any(
                            s is not None for s in slots) else 0.05)
                except queue.Empty:
                    item = None
                if item is _SENTINEL:
                    ingest_done = True
                elif item is not None:
                    state = self._gate_batch(state, item)
            # 2) freed slot → next admitted request prefills (no barrier)
            self._fill_slots(slots, free)
            # 3) one decode tick across every occupied slot
            self._tick_slots(slots, free)
            self._fill_slots(slots, free)
            if ingest_done and self.request_q.empty() \
                    and not self._backlog \
                    and all(s is None for s in slots):
                break
        wall_s = time.perf_counter() - t0
        ingest.join()
        self.result_q.put(_SENTINEL)
        collector.join()

        # final checkpoint + health line flushed on every exit, drained or
        # not — the drain contract of the SIGTERM test
        blob = session.save_state(state)
        guarded = getattr(session, "is_guarded_session", False)
        guard = session.health_snapshot() if guarded else None
        health_line = session.health.summary() if guarded else None
        return ServerReport(
            results=results, masks=self.masks, state=state, state_blob=blob,
            metrics=self.metrics.snapshot(wall_s, guard=guard),
            drained=drained, health_line=health_line)


def synchronous_reference(session, stream, batch_hook: Callable | None = None):
    """The admission ORACLE: the same plan over the same seeded traffic
    with no queues, threads, or slots. ``AdmissionServer`` must produce a
    bit-identical admit/reject sequence and final ``OrderState`` —
    queuing changes latency, never admission decisions.

    Returns ``(final_state, masks)`` with ``masks[batch_index]`` the
    boolean admission mask.
    """
    state = session.init_state()
    masks: dict[int, np.ndarray] = {}
    for rb in stream:
        b = rb.row_offset // stream.batch_rows
        cols = rb.columns if batch_hook is None else batch_hook(b, rb.columns)
        state, res = session.step(state, cols)
        masks[b] = np.asarray(res.mask_np)
    return state, masks
