"""Static analysis of filter plans (port of part of ``repro.analysis``).

  diagnostics — the ``Diagnostic`` record every pass emits
  chain_lint  — interval + domain semantics lint of a CNF chain, run by
                ``core.session.build_session`` at plan-compile time
"""

from repro_torch.analysis.chain_lint import lint_chain
from repro_torch.analysis.diagnostics import Diagnostic

__all__ = ["Diagnostic", "lint_chain"]
