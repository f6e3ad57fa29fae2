"""``cuda`` engine: the hand-written chain and gather kernels.

The counterpart of ``repro``'s ``pallas`` engine. On CUDA tensors the
kernel wrappers launch the kernels (or raise); on CPU tensors they run
the kernels' plain twins. The skip-tier methods arrive with the
skip-tier slice.
"""

from __future__ import annotations

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine.base import ChainResult, MonitorSpec


@engine_lib.register("cuda")
class CudaEngine:
    """Fused per-tile CNF chain with tile short-circuit and in-tile pack."""

    traceable = True
    supports_skip = False

    def run_chain(self, columns, specs, perm,
                  monitor: MonitorSpec) -> ChainResult:
        from repro_torch.kernels.filter_chain import ops as kernel_ops
        return kernel_ops.filter_chain(
            columns, specs, perm,
            collect_rate=monitor.collect_rate,
            sample_phase=monitor.sample_phase,
            monitor_mode=monitor.mode)

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0):
        """Survivors are packed per tile by the chain kernel; the gather
        kernel stores each tile's pack at its exclusive offset."""
        from repro_torch.kernels.filter_chain import ops as kernel_ops
        return kernel_ops.filter_chain_compact(
            columns, specs, perm,
            collect_rate=monitor.collect_rate,
            sample_phase=monitor.sample_phase,
            capacity=capacity, fill=fill,
            monitor_mode=monitor.mode)
