"""``torch`` engine: masked vectorized evaluation in plain PyTorch.

The counterpart of ``repro``'s ``jnp`` engine; runs on CPU or CUDA
tensors.
"""

from __future__ import annotations

from repro_torch.core import engine as engine_lib
from repro_torch.core import filter_exec, skip_tier
from repro_torch.core.engine.base import ChainResult, MonitorSpec, SkipInfo


@engine_lib.register("torch")
class TorchEngine:
    """Fully vectorized masked CNF chain; exact row-level work counters."""

    traceable = True
    supports_skip = True
    # the skip path gathers ambiguous tiles into a buffer sized on the
    # host, so the session reads the ambiguous count once per step
    skip_gathers = True

    def run_chain(self, columns, specs, perm, monitor: MonitorSpec, *,
                  skip: SkipInfo | None = None,
                  amb_cap: int = 0) -> ChainResult:
        """With ``skip``: gather ambiguous tiles → row-level chain →
        scatter the mask back; the monitor lane runs on the full batch."""
        if skip is not None:
            return skip_tier.run_chain_skip(columns, specs, perm, monitor,
                                            skip, amb_cap=amb_cap)
        return filter_exec.run_chain(
            columns, specs, perm,
            collect_rate=monitor.collect_rate,
            sample_phase=monitor.sample_phase)

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0,
                          skip: SkipInfo | None = None, amb_cap: int = 0):
        """Chain + O(R) cumsum-scatter compaction (no sort)."""
        res = self.run_chain(columns, specs, perm, monitor, skip=skip,
                             amb_cap=amb_cap)
        packed, n_kept = filter_exec.compact_fixed(columns, res.mask,
                                                   capacity, fill)
        return res, packed, n_kept

    # ------------------------------------------------------- skip tier
    def triage(self, columns, specs, *, bloom: bool) -> SkipInfo:
        """Zone-map (+ Bloom) summaries over NaN-padded 128-row tiles,
        resolved against the chain."""
        return skip_tier.triage(columns, specs, bloom=bloom)
