"""Serving metrics: admission counters, latency quantiles, occupancy.

A copy of ``repro.serving.metrics`` (plain Python: the port imports
nothing of ``repro``). One ``ServerMetrics`` instance accounts every
request exactly once (ingested → decided → [completed]); ``snapshot()``
is the schema of the serve CLI's ``--bench-out`` payload, the same field
names as ``repro``'s.

Thread discipline: ``note_ingest`` is called from the ingest thread,
everything else from the serving thread; counters are partitioned by
writer so no lock is needed (CPython int/append atomicity covers the
cross-thread reads at snapshot time, which happens after join anyway).

NOTE ``note_decision`` is reachable from the admission hot path
(``AdmissionServer._gate_batch``): it must stay pure host arithmetic — no
tensor accessors, no ``.item()``, no numpy materialization. Callers hand
it plain Python numbers.
"""

from __future__ import annotations

import dataclasses


def weighted_quantile(pairs: list, q: float) -> float:
    """Quantile over (value, count) pairs (counts = batch sizes).

    The admission decision is per micro-batch, so every request in a
    batch shares its latency; weighting by count makes the p99 a true
    per-REQUEST quantile, not a per-batch one.
    """
    if not pairs:
        return 0.0
    ordered = sorted(pairs)
    total = sum(c for _, c in ordered)
    target = q * total
    seen = 0
    for value, count in ordered:
        seen += count
        if seen >= target:
            return value
    return ordered[-1][0]


@dataclasses.dataclass
class ServerMetrics:
    """Counters + reservoirs for one server run (module docstring)."""

    # ingest thread
    requests_in: int = 0          # rows handed to the request queue
    batches_in: int = 0
    # serving thread: admission
    admitted: int = 0
    rejected: int = 0
    quarantined: int = 0
    gate_batches: int = 0
    gate_s_total: float = 0.0     # host time inside FilterSession.step
    # serving thread: slots
    completed: int = 0            # admitted requests whose decode finished
    decode_ticks: int = 0
    _occ_sum: float = 0.0
    _occ_samples: int = 0
    # (latency_s, n_requests) per decided micro-batch
    _lat: list = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------ ingest side
    def note_ingest(self, n_rows: int) -> None:
        self.requests_in += n_rows
        self.batches_in += 1

    # ----------------------------------------------------------- serving side
    def note_decision(self, n_admit: int, n_reject: int, n_quar: int,
                      latency_s: float, gate_s: float) -> None:
        """One gated micro-batch: enqueue→decision latency covers queue
        wait + gate compute for every request in the batch."""
        self.admitted += n_admit
        self.rejected += n_reject
        self.quarantined += n_quar
        self.gate_batches += 1
        self.gate_s_total += gate_s
        self._lat.append((latency_s, n_admit + n_reject + n_quar))

    def note_tick(self, occupied: int, slots: int) -> None:
        self.decode_ticks += 1
        self._occ_sum += occupied / slots
        self._occ_samples += 1

    def note_completion(self, n: int = 1) -> None:
        self.completed += n

    # -------------------------------------------------------------- summaries
    @property
    def decided(self) -> int:
        return self.admitted + self.rejected + self.quarantined

    def admission_latency_s(self, q: float) -> float:
        return weighted_quantile(self._lat, q)

    def snapshot(self, wall_s: float, guard: dict | None = None) -> dict:
        """The metrics block of the ``--bench-out`` payload. ``guard`` is
        ``GuardedSession.health_snapshot()`` when the gate is guarded,
        None otherwise (the key is always present — schema stability)."""
        decided = self.decided
        denom = max(decided, 1)
        return {
            "requests": self.requests_in,
            "batches": self.batches_in,
            "decided": decided,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "quarantined": self.quarantined,
            "completed": self.completed,
            "admit_rate": self.admitted / denom,
            "reject_rate": self.rejected / denom,
            "quarantine_rate": self.quarantined / denom,
            "wall_s": wall_s,
            "requests_per_sec": decided / wall_s if wall_s > 0 else 0.0,
            "admission_latency_ms": {
                "p50": 1e3 * self.admission_latency_s(0.50),
                "p99": 1e3 * self.admission_latency_s(0.99),
                "max": 1e3 * max((v for v, _ in self._lat), default=0.0),
            },
            "gate_us_per_request": 1e6 * self.gate_s_total / denom,
            "slot_occupancy": (self._occ_sum / self._occ_samples
                               if self._occ_samples else 0.0),
            "decode_ticks": self.decode_ticks,
            "guard": guard,
        }
