"""Finding/Report types shared by every static analyzer (the port's copy of
``repro/analysis/findings.py``).

A *finding* is one violated invariant with enough context (layer, stage,
resource, job) to act on without re-running the analyzer; a *report* is an
ordered collection of findings plus a count of the individual invariant
checks performed (so tests can assert an analyzer actually exercised its
checklist rather than silently skipping it).

Analyzers never raise on bad input -- they report.  Callers that want
exception semantics (``optimize_plan(verify=True)``, ``run_plan(verify=True)``)
use :meth:`Report.raise_if_failed`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Finding", "Report", "AnalysisError"]


@dataclass(frozen=True)
class Finding:
    """One violated invariant.

    ``check`` is a stable dotted identifier (``plan.coverage``,
    ``dag.deadlock``, ``kernel.support``, ``keying.unkeyed``) so tests and CI
    can match on the invariant class; ``where`` names the site (layer, stage,
    slot, resource, job, config field); ``detail`` is the human diagnostic."""

    check: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.where}: {self.detail}"


class AnalysisError(ValueError):
    """Raised by :meth:`Report.raise_if_failed`; carries the full report."""

    def __init__(self, context: str, report: "Report"):
        self.report = report
        lines = "\n".join(f"  {f}" for f in report.findings)
        super().__init__(
            f"{context}: {len(report.findings)} static-analysis finding(s)\n{lines}"
        )


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    checks: int = 0  # invariant checks performed (passed + failed)

    @property
    def ok(self) -> bool:
        return not self.findings

    def add(self, check: str, where: str, detail: str) -> None:
        self.findings.append(Finding(check, where, detail))

    def tick(self, n: int = 1) -> None:
        """Count ``n`` invariant checks as performed."""
        self.checks += n

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.checks += other.checks
        return self

    def filtered(self, check_prefix: str) -> list[Finding]:
        return [f for f in self.findings if f.check.startswith(check_prefix)]

    def raise_if_failed(self, context: str) -> None:
        if not self.ok:
            raise AnalysisError(context, self)

    def __str__(self) -> str:
        if self.ok:
            return f"ok ({self.checks} checks)"
        body = "\n".join(str(f) for f in self.findings)
        return f"{len(self.findings)} finding(s) / {self.checks} checks:\n{body}"
