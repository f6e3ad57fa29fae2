"""Fault injection and the process plumbing of a long-running stream.

PyTorch port of ``repro.runtime.fault_tolerance`` (its restartable
training loop and JSON pipeline state are not ported yet: ROADMAP.md
queue 1 item 11). Long-running streams treat failure as the normal case:

  * ``FailureInjector`` kills steps deterministically for tests and
    chaos runs;
  * ``DataFaultInjector`` — seeded NaN/Inf batch poisoning and all-pass
    column storms, pure in ``(seed, batch_index)`` so rollback REPLAY
    re-applies identical faults (the same bytes as ``repro``'s);
  * ``corrupt_state`` / ``corrupt_blob`` — one-defect OrderState and
    bit-flipped checkpoint factories for validator/integrity tests; the
    corrupted state stays on the device of the state it was made from;
  * ``GracefulShutdown`` — SIGINT/SIGTERM → polled flag, so a
    long-running loop flushes a final checkpoint instead of dying
    mid-epoch;
  * ``StragglerMonitor`` — the data-plane mitigation the per-executor
    scope enables: a slow shard's unprocessed batches move to healthy
    shards without transferring adaptive state (any shard can generate
    any batch of the counter-based stream).
"""

from __future__ import annotations

import copy
import dataclasses
import signal
from typing import Iterable

import numpy as np


class FailureInjector:
    """Deterministically raises at the given step numbers (chaos testing)."""

    def __init__(self, fail_at_steps: Iterable[int] = ()):
        self.fail_at = set(fail_at_steps)
        self.failures = 0

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise RuntimeError(f"injected node failure at step {step}")


# ========================================================= data-plane faults
class DataFaultInjector:
    """Seeded, REPLAY-DETERMINISTIC data-plane fault schedule.

    Transforms batch contents as a pure function of ``(seed, batch_index,
    cols)`` — never of call count — so the guarded runtime's rollback
    replay (``GuardedSession.run_log_stream``) re-applies identical faults
    to re-generated batches. Fault kinds:

      * ``poison_at``: NaN/Inf-poison a seeded fraction of the batch's
        cells (half NaN, half +Inf) — the admission check must quarantine;
      * ``storm_at``: replace the batch with ``storm_row`` tiled across
        every row — an adversarial column storm in which (by the caller's
        construction of ``storm_row``) every row passes the chain,
        overflowing any bounded compaction capacity.

    Batches are host numpy arrays. Use directly as the ``batch_hook`` of
    ``run_log_stream`` or of the admission server.
    """

    def __init__(self, *, poison_at: Iterable[int] = (),
                 storm_at: Iterable[int] = (), storm_row=None,
                 poison_frac: float = 0.01, seed: int = 0):
        self.poison_at = frozenset(poison_at)
        self.storm_at = frozenset(storm_at)
        if self.storm_at and storm_row is None:
            raise ValueError("storm_at needs storm_row (a [C] feature "
                             "vector every predicate passes)")
        self.storm_row = None if storm_row is None \
            else np.asarray(storm_row, np.float32)
        self.poison_frac = poison_frac
        self.seed = seed

    def __call__(self, batch_index: int, cols: np.ndarray) -> np.ndarray:
        if batch_index in self.storm_at:
            return np.tile(self.storm_row[:, None],
                           (1, cols.shape[1])).astype(np.float32)
        if batch_index in self.poison_at:
            rng = np.random.Generator(
                np.random.Philox(key=[self.seed, batch_index]))
            out = np.array(cols, np.float32)
            flat = out.reshape(-1)
            n = max(1, int(flat.size * self.poison_frac))
            idx = rng.choice(flat.size, size=n, replace=False)
            flat[idx[: n // 2 + 1]] = np.nan
            flat[idx[n // 2 + 1:]] = np.inf
            return out
        return cols


#: defect classes ``corrupt_state`` injects — each one is a distinct
#: violated invariant the fused validator must detect
STATE_CORRUPTIONS = ("nan_stat", "inf_stat", "bad_perm", "bad_group_perm",
                     "count_overflow", "negative_rows")


def corrupt_state(state, kind: str, seed: int = 0):
    """Return a copy of an ``OrderState`` with ONE injected defect, on the
    state's own device.

    Simulates in-memory/device state rot for validator property tests and
    the chaos soak. ``kind`` is one of ``STATE_CORRUPTIONS``.
    """
    from repro_torch.core.session import fstate_from_arrays, fstate_to_arrays

    a = {k: np.array(v) for k, v in fstate_to_arrays(state).items()}
    rng = np.random.Generator(np.random.Philox(key=[seed, 0]))
    if kind == "nan_stat":
        flat = a["stats.num_cut"].reshape(-1)
        flat[rng.integers(flat.size)] = np.nan
    elif kind == "inf_stat":
        flat = a["stats.cost_acc"].reshape(-1)
        flat[rng.integers(flat.size)] = np.inf
    elif kind == "bad_perm":
        a["perm"][..., 0] = a["perm"][..., 1]     # duplicate entry
    elif kind == "bad_group_perm":
        a["group_perm"][..., 0] = a["group_perm"].shape[-1] + 3
    elif kind == "count_overflow":
        a["stats.num_cut"][..., 0] = a["stats.n_monitored"] + 1000.0
    elif kind == "negative_rows":
        a["rows_into_epoch"][...] = -5
    else:
        raise ValueError(f"unknown corruption kind {kind!r}; pick from "
                         f"{STATE_CORRUPTIONS}")
    return fstate_from_arrays(a, device=state.perm.device)


def corrupt_blob(blob: dict, *, seed: int = 0, n_flips: int = 1) -> dict:
    """Bit-flip a checkpoint blob (deep copy; the original is untouched).

    Flips ``n_flips`` seeded bits in one of the envelope's state arrays —
    the storage-rot model the crc32 integrity field exists to catch.
    """
    out = copy.deepcopy(blob)
    arrays = out["arrays"] if isinstance(out, dict) and "arrays" in out \
        else out
    rng = np.random.Generator(np.random.Philox(key=[seed, 1]))
    key = sorted(arrays)[int(rng.integers(len(arrays)))]
    v = np.array(np.asarray(arrays[key]))
    raw = v.reshape(-1).view(np.uint8)
    for _ in range(n_flips):
        raw[int(rng.integers(raw.size))] ^= np.uint8(
            1 << int(rng.integers(8)))
    arrays[key] = v
    return out


# ========================================================= graceful shutdown
class GracefulShutdown:
    """Context manager turning SIGINT/SIGTERM into a polled flag.

    First signal: set ``requested`` — the loop finishes the current
    step, flushes a final checkpoint, and prints the resume command.
    Second signal: raise ``KeyboardInterrupt`` (the operator insists).
    Handlers are restored on exit; must be entered from the main thread.
    """

    def __init__(self, signals: Iterable[int] | None = None):
        self._signals = tuple(signals) if signals is not None \
            else (signal.SIGINT, signal.SIGTERM)
        self.requested = False
        self._old: dict = {}

    def _handler(self, signum, frame):
        if self.requested:
            raise KeyboardInterrupt
        self.requested = True

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> bool:
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old.clear()
        return False


@dataclasses.dataclass
class StragglerMonitor:
    """Tracks per-shard step latencies; flags shards slower than
    ``threshold`` × median and proposes batch reassignment."""

    n_shards: int
    threshold: float = 2.0
    window: int = 16

    def __post_init__(self):
        self._lat = [list() for _ in range(self.n_shards)]

    def record(self, shard: int, seconds: float):
        buf = self._lat[shard]
        buf.append(seconds)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> list[int]:
        med = np.median([np.mean(l) for l in self._lat if l] or [0.0])
        if med <= 0:
            return []
        return [i for i, l in enumerate(self._lat)
                if l and np.mean(l) > self.threshold * med]

    def reassign(self, shard_batches: dict[int, list[int]]
                 ) -> dict[int, list[int]]:
        """Move the tail of each straggler's queue to the fastest shards.
        Batches are counter-based (``data.stream.gen_batch``) so any shard
        can produce any batch — no data movement, just index
        reassignment."""
        slow = set(self.stragglers())
        if not slow:
            return shard_batches
        fast = [i for i in shard_batches if i not in slow]
        if not fast:
            return shard_batches
        out = {k: list(v) for k, v in shard_batches.items()}
        for s in slow:
            tail = out[s][len(out[s]) // 2:]
            out[s] = out[s][:len(out[s]) // 2]
            for j, b in enumerate(tail):
                out[fast[j % len(fast)]].append(b)
        return out
