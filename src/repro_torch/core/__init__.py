"""Adaptive filter ordering — the paper's contribution, in PyTorch.

Public API (one plan, one session), as in ``repro.core``:
  FilterPlan, TokenizeSpec         — the declarative config surface
  build_session → FilterSession    — compiled plan on one device; one
                                     ``session.step`` returning StepResult
  ShardedAdaptiveFilter            — S shards of the filter on that device
                                     (``plan.shards > 1``)
  Predicate, pack, OP_*            — predicate algebra (CNF via ``group``)
  OrderingConfig, OrderState       — Table-1 parameters + adaptive state
  Scope, EXCHANGE_MODES            — statistics scopes and exchange modes
  engine (get_engine/register)     — the "torch", "cuda" and "numpy"
                                     engines
  AdaptiveFilter, AdaptiveFilterConfig, StepMetrics, static_filter
                                   — the paper's surface: a filter over a
                                     chain, ``process_stream`` over a
                                     stream of batches
"""

from repro_torch.core.adaptive_filter import (AdaptiveFilter,
                                              AdaptiveFilterConfig,
                                              StepMetrics, static_filter)
from repro_torch.core.engine import (ChainResult, MonitorSpec,
                                     available_engines, get_engine, register)
from repro_torch.core.ordering import (OrderingConfig, OrderState,
                                       init_order_state)
from repro_torch.core.plan import FilterPlan, TokenizeSpec, validate_combo
from repro_torch.core.predicates import (OP_BETWEEN, OP_EQ, OP_GT,
                                         OP_HASHMIX, OP_LT, Predicate,
                                         pack, paper_filters_4,
                                         paper_filters_cnf)
from repro_torch.core.scope import EXCHANGE_MODES, Scope
from repro_torch.core.session import FilterSession, StepResult, build_session
from repro_torch.core.sharded import (ShardedAdaptiveFilter, shard_slice,
                                      stack_states)

__all__ = [
    "AdaptiveFilter", "AdaptiveFilterConfig", "StepMetrics", "static_filter",
    "ChainResult", "MonitorSpec", "available_engines", "get_engine",
    "register", "OrderingConfig", "OrderState", "init_order_state",
    "FilterPlan", "TokenizeSpec", "validate_combo", "OP_BETWEEN", "OP_EQ",
    "OP_GT", "OP_HASHMIX", "OP_LT", "Predicate", "pack", "paper_filters_4",
    "paper_filters_cnf", "EXCHANGE_MODES", "Scope", "FilterSession",
    "StepResult", "build_session", "ShardedAdaptiveFilter", "shard_slice",
    "stack_states",
]
