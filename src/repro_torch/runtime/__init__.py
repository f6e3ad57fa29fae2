"""Runtime substrate of the port: failure injection, straggler
mitigation, graceful shutdown, and the guarded (self-healing) session
runtime. The restartable training loop is not ported yet (ROADMAP.md
queue 1 item 11)."""

from repro_torch.runtime.fault_tolerance import (STATE_CORRUPTIONS,
                                                 DataFaultInjector,
                                                 FailureInjector,
                                                 GracefulShutdown,
                                                 StragglerMonitor,
                                                 corrupt_blob, corrupt_state)
from repro_torch.runtime.guard import (GuardedSession, GuardHealth,
                                       GuardPolicy, GuardStateError)

__all__ = [
    "FailureInjector", "StragglerMonitor", "DataFaultInjector",
    "GracefulShutdown", "corrupt_state", "corrupt_blob", "STATE_CORRUPTIONS",
    "GuardedSession", "GuardPolicy", "GuardHealth", "GuardStateError",
]
