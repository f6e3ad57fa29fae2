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
    # skip-tier counters (core/skip_tier.py); zero whenever the tier is
    # off. Work/active counters above charge only ambiguous-tile rows when
    # the tier resolves tiles — the row-level work actually performed.
    n_tiles_pass: Any = 0       # i32[] — tiles provably passing every group
    n_tiles_fail: Any = 0       # i32[] — tiles provably failing some group
    n_tiles_ambiguous: Any = 0  # i32[] — tiles sent to the row-level chain


class SkipInfo(NamedTuple):
    """Tri-state tile resolution produced by an engine's ``triage``.

    ``pass_tiles``/``fail_tiles`` are bool[T] over the engine's padded
    128-row tiling of the batch (mutually exclusive; everything else is
    ambiguous). ``n_ambiguous`` is an i32[] tensor the session reads once
    per step to size the torch engine's gather width.
    """

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

    def run_chain(self, columns, specs, perm, monitor: MonitorSpec, *,
                  skip: SkipInfo | None = None,
                  amb_cap: int = 0) -> ChainResult:
        """Evaluate the CNF chain in ``perm`` order + run the monitor lane
        (behind the skip tier when ``skip`` is given; see below)."""
        ...

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0,
                          skip: SkipInfo | None = None, amb_cap: int = 0):
        """``run_chain`` + fixed-capacity survivor compaction.

        Returns (ChainResult, packed f32[C, capacity], n_kept i32[]).
        """
        ...

    # --- optional skip-tier surface (core/skip_tier.py) -----------------
    # Engines with ``supports_skip = True`` additionally implement
    #
    #   triage(columns, specs, *, bloom: bool) -> SkipInfo
    #       Zone-map (+ optional Bloom) summaries resolved against the
    #       chain, from the specs' host tuples (no device read),
    #
    # and accept its result as ``skip`` in ``run_chain`` /
    # ``run_chain_compact``. ``amb_cap`` is the gathered width in tiles
    # for engines that gather (``skip_gathers = True``: torch); the cuda
    # engine predicates in-kernel and ignores it. The monitor lane always
    # runs row-level on the full batch, so ordering statistics are
    # identical with the tier on or off.
