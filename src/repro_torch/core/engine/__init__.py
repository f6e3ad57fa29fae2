"""Execution-engine registry (counterpart of ``repro.core.engine``).

Three engines ship in the port and register themselves on import:

  torch — masked vectorized evaluation in plain PyTorch (CPU or CUDA);
          the counterpart of ``jnp``
  cuda  — the hand-written chain, gather and tile-stats kernels; on a
          CPU tensor their wrappers run the kernels' plain twins. The
          counterpart of ``pallas``
  numpy — row-exact compacted host path (wall-clock-true, measured
          costs); the counterpart of ``repro``'s ``numpy``
"""

from __future__ import annotations

from repro_torch.core.engine.base import ChainResult, FilterEngine, MonitorSpec

_REGISTRY: dict = {}


def register(name: str):
    """Class decorator: instantiate and expose an engine under ``name``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_engine(name: str) -> FilterEngine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown filter engine {name!r}; available: "
            f"{available_engines()}") from None


def available_engines() -> tuple:
    return tuple(sorted(_REGISTRY))


from repro_torch.core.engine import cuda_engine as _cuda_engine    # noqa: E402
from repro_torch.core.engine import numpy_engine as _numpy_engine  # noqa: E402
from repro_torch.core.engine import torch_engine as _torch_engine  # noqa: E402

__all__ = ["ChainResult", "FilterEngine", "MonitorSpec", "register",
           "get_engine", "available_engines"]
