"""``torch`` engine: masked vectorized evaluation in plain PyTorch.

The counterpart of ``repro``'s ``jnp`` engine; runs on CPU or CUDA
tensors. The skip-tier methods arrive with the skip-tier slice.
"""

from __future__ import annotations

from repro_torch.core import engine as engine_lib
from repro_torch.core import filter_exec
from repro_torch.core.engine.base import ChainResult, MonitorSpec


@engine_lib.register("torch")
class TorchEngine:
    """Fully vectorized masked CNF chain; exact row-level work counters."""

    traceable = True
    supports_skip = False

    def run_chain(self, columns, specs, perm,
                  monitor: MonitorSpec) -> ChainResult:
        return filter_exec.run_chain(
            columns, specs, perm,
            collect_rate=monitor.collect_rate,
            sample_phase=monitor.sample_phase)

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0):
        """Chain + O(R) cumsum-scatter compaction (no sort)."""
        res = self.run_chain(columns, specs, perm, monitor)
        packed, n_kept = filter_exec.compact_fixed(columns, res.mask,
                                                   capacity, fill)
        return res, packed, n_kept
