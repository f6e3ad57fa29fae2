"""Continuous-batching admission serving in the port (see
``serving.server``)."""

from repro_torch.serving.metrics import ServerMetrics, weighted_quantile
from repro_torch.serving.server import (REASON_ADMITTED,
                                        REASON_QUARANTINED, REASON_REJECTED,
                                        AdmissionServer, GateItem,
                                        RequestResult, ServerConfig,
                                        ServerReport, SimExecutor, Ticket,
                                        synchronous_reference)
from repro_torch.serving.traffic import (TrafficConfig, TrafficGenerator,
                                         gen_requests,
                                         gen_requests_with_users,
                                         guardrail_chain, phase_of)

__all__ = [
    "AdmissionServer", "GateItem", "RequestResult", "ServerConfig",
    "ServerMetrics", "ServerReport", "SimExecutor", "Ticket",
    "TrafficConfig", "TrafficGenerator", "REASON_ADMITTED",
    "REASON_QUARANTINED", "REASON_REJECTED", "gen_requests",
    "gen_requests_with_users", "guardrail_chain", "phase_of",
    "synchronous_reference", "weighted_quantile",
]
