"""FilterEngine contract: the one ABI every execution backend implements.

Counterpart of ``repro.core.engine.base``. An engine turns (columns,
packed specs, permutation, monitor config) into a ``ChainResult``: CNF
evaluation with both short-circuit levels, exact row-level work counters,
and the paper's §2.1 monitor lane. Engines never touch ordering state.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Protocol, runtime_checkable


class ChainResult(NamedTuple):
    """Uniform output contract of every filter engine."""

    mask: Any             # bool[R] — rows passing the whole CNF chain
    work_units: Any       # f32[] — row-level cost-weighted work
    active_before: Any    # f32[P] — rows pending evaluation at each position
    cut_counts: Any       # f32[P] — monitor lane: rows failing each predicate
    n_monitored: Any      # f32[] — monitor lane: sampled row count
    monitor_cost: Any     # f32[P] — per-predicate monitor cost contribution
    group_cut_counts: Any  # f32[G] — monitor lane: rows cut by each OR-group
    # skip-tier counters; zero while the tier is not ported
    n_tiles_pass: Any = 0
    n_tiles_fail: Any = 0
    n_tiles_ambiguous: Any = 0


class SkipInfo(NamedTuple):
    """Tri-state tile resolution of the skip tier (bool[T] each)."""

    pass_tiles: Any
    fail_tiles: Any
    n_ambiguous: Any


class MonitorSpec(NamedTuple):
    """Monitor-lane parameters threaded to an engine for one batch."""

    collect_rate: int      # sample 1 row in every collect_rate
    sample_phase: Any      # i32[] tensor or int: global row offset mod rate
    cost_mode: str = "static"
    mode: str = "row"      # "row" | "block" (kernel tile sampling)


@runtime_checkable
class FilterEngine(Protocol):
    """The pluggable execution seam (register with ``engine.register``)."""

    name: str
    # True → the engine runs on device tensors without host round trips
    traceable: bool

    def run_chain(self, columns, specs, perm,
                  monitor: MonitorSpec) -> ChainResult:
        """Evaluate the CNF chain in ``perm`` order + run the monitor lane."""
        ...

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0):
        """``run_chain`` + fixed-capacity survivor compaction.

        Returns (ChainResult, packed f32[C, capacity], n_kept i32[]).
        """
        ...
