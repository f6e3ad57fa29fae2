"""The one Diagnostic ABI every analysis pass emits.

PyTorch port's copy of the record and report part of
``repro.analysis.diagnostics`` (it imports nothing of ``repro``; the
CLI's JSON and SARIF encodings are not ported, as the CLI is not).
``chain_lint`` returns flat lists of ``Diagnostic`` records — code,
severity, location, message, fix hint — so the ``build_session`` lint
hook and the tests consume one shape whatever produced a finding.

Severity contract:

  error    the plan is wrong (an unsatisfiable chain); ``build_session``
           raises.
  warning  provably wasted work (subsumed / always-true predicates, Bloom
           key collisions); ``build_session`` warns once per finding.
  info     advisory structure notes (e.g. a HASHMIX member shadowing a
           group's tile-fail proof). Never fatal.
"""

from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding from one analysis pass.

    ``code`` is a stable kebab-case identifier (``chain-unsat-group``,
    ``hlo-step-collective``, ``hotpath-host-sync``, ...) — tests and CI
    match on it, never on the prose. ``location`` is ``file.py:LINE`` for
    source findings and a chain/plan coordinate (``chain[2]:int_lo``,
    ``plan:step-hlo``) for semantic ones.
    """

    code: str
    severity: str
    location: str
    message: str
    fix_hint: str = ""

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"bad severity {self.severity!r}; pick from {SEVERITIES}")

    def render(self) -> str:
        hint = f"\n    hint: {self.fix_hint}" if self.fix_hint else ""
        return f"[{self.severity:7s}] {self.code} @ {self.location}: " \
               f"{self.message}{hint}"


def errors(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == "error"]


def warnings_of(diags) -> list[Diagnostic]:
    return [d for d in diags if d.severity == "warning"]


def render_report(diags) -> str:
    """Human-readable report, errors first, stable within severity."""
    order = {s: i for i, s in enumerate(SEVERITIES)}
    lines = []
    for d in sorted(diags, key=lambda d: (order[d.severity], d.location,
                                          d.code)):
        lines.append(d.render())
    if not diags:
        lines.append("clean (no findings)")
    return "\n".join(lines)
