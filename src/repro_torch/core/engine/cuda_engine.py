"""``cuda`` engine: the hand-written chain, gather and tile-stats kernels.

The counterpart of ``repro``'s ``pallas`` engine. On CUDA tensors the
kernel wrappers launch the kernels (or raise); on CPU tensors they run
the kernels' plain twins.
"""

from __future__ import annotations

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine.base import ChainResult, MonitorSpec, SkipInfo


@engine_lib.register("cuda")
class CudaEngine:
    """Fused per-tile CNF chain with tile short-circuit and in-tile pack."""

    traceable = True
    supports_skip = True
    # decided sub-tiles are predicated in-kernel — nothing is gathered, so
    # the session never reads an ambiguous count for this engine
    skip_gathers = False

    def run_chain(self, columns, specs, perm, monitor: MonitorSpec, *,
                  skip: SkipInfo | None = None,
                  amb_cap: int = 0) -> ChainResult:
        """With ``skip``, the chain kernel's decisions variant: decided
        rows start non-pending (a fully decided tile evaluates no
        predicate); ``amb_cap`` is ignored — nothing is gathered."""
        from repro_torch.kernels.filter_chain import ops as kernel_ops
        kw = dict(collect_rate=monitor.collect_rate,
                  sample_phase=monitor.sample_phase,
                  monitor_mode=monitor.mode)
        if skip is not None:
            return kernel_ops.filter_chain_skip(columns, specs, perm, skip,
                                                **kw)
        return kernel_ops.filter_chain(columns, specs, perm, **kw)

    def run_chain_compact(self, columns, specs, perm, monitor: MonitorSpec,
                          *, capacity: int, fill: float = 0.0,
                          skip: SkipInfo | None = None, amb_cap: int = 0):
        """Survivors are packed per tile by the chain kernel; the gather
        kernel stores each tile's pack at its exclusive offset."""
        from repro_torch.kernels.filter_chain import ops as kernel_ops
        kw = dict(collect_rate=monitor.collect_rate,
                  sample_phase=monitor.sample_phase,
                  capacity=capacity, fill=fill, monitor_mode=monitor.mode)
        if skip is not None:
            return kernel_ops.filter_chain_compact_skip(columns, specs, perm,
                                                        skip, **kw)
        return kernel_ops.filter_chain_compact(columns, specs, perm, **kw)

    # ------------------------------------------------------- skip tier
    def triage(self, columns, specs, *, bloom: bool) -> SkipInfo:
        """Stats kernel over the zero-padded batch + zone-map/Bloom
        resolution."""
        from repro_torch.kernels.filter_chain import ops as kernel_ops
        return kernel_ops.skip_triage(columns, specs, bloom=bloom)
