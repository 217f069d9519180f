"""Shared diagnostic model for the static program verifier (counterpart
of paddle_tpu/analysis/diagnostics.py).

The reference framework validates op descs at compile time through
proto-level checks plus per-op `InferShape` asserts scattered through C++
(framework.proto OpDesc/VarDesc, operator.cc InferShapeContext) — errors
surface as one-off PADDLE_ENFORCE aborts.  Here every analysis pass emits
structured `Diagnostic` records instead, so one verification run can
report ALL problems in a program at once, callers can filter by severity,
and tools (cli verify, debugger dumps, Executor pre-flight) share the
same machinery.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = [
    "Diagnostic",
    "ProgramVerificationError",
    "SEVERITIES",
    "severity_rank",
    "format_diagnostics",
    "max_severity",
]

# ordered weakest -> strongest; rank comparisons use list position
SEVERITIES = ("info", "warning", "error")


def severity_rank(severity: str) -> int:
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {SEVERITIES}"
        ) from None


@dataclasses.dataclass
class Diagnostic:
    """One finding from one analysis pass.

    `block_idx` / `op_idx` locate the offending op in the Program IR
    (`op_idx` is None for block- or program-level findings); `op_repr` is
    a short human rendering of the op desc; `hint` suggests a fix.
    """

    pass_id: str
    severity: str  # "error" | "warning" | "info"
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    op_repr: str = ""
    hint: str = ""
    # source-level location (the concurrency analyzer locates findings
    # in repo files, not Program blocks); when `file` is set it wins
    # over the block/op rendering
    file: Optional[str] = None
    line: Optional[int] = None

    def __post_init__(self):
        severity_rank(self.severity)  # validate

    def to_dict(self) -> dict:
        """Machine-readable form (cli verify/analyze/concurrency
        --json): severity + pass id, a structured location, the
        message, and the fix hint — stable keys for CI annotations and
        editor integrations."""
        loc: dict = {
            "block": self.block_idx,
            "op": self.op_idx,
            "op_type": self.op_type,
        }
        if self.file is not None:
            loc = {"file": self.file, "line": self.line}
        return {
            "pass": self.pass_id,
            "severity": self.severity,
            "message": self.message,
            "location": loc,
            "hint": self.hint or None,
        }

    def location(self) -> str:
        if self.file is not None:
            return f"{self.file}:{self.line}"
        loc = f"block {self.block_idx}"
        if self.op_idx is not None:
            loc += f" op {self.op_idx}"
            if self.op_type:
                loc += f" ({self.op_type})"
        return loc

    def __str__(self):
        s = f"[{self.severity}] {self.pass_id}: {self.message} " \
            f"({self.location()})"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


def max_severity(diagnostics: List[Diagnostic]) -> Optional[str]:
    if not diagnostics:
        return None
    return max(diagnostics, key=lambda d: severity_rank(d.severity)).severity


def format_diagnostics(diagnostics: List[Diagnostic]) -> str:
    """Multi-line report, strongest severity first, stable within severity."""
    ordered = sorted(
        diagnostics,
        key=lambda d: (-severity_rank(d.severity), d.block_idx,
                       -1 if d.op_idx is None else d.op_idx),
    )
    counts = {}
    for d in diagnostics:
        counts[d.severity] = counts.get(d.severity, 0) + 1
    head = ", ".join(
        f"{counts[s]} {s}{'s' if counts[s] != 1 else ''}"
        for s in reversed(SEVERITIES) if s in counts
    ) or "no findings"
    return "\n".join([f"program verification: {head}"]
                     + [str(d) for d in ordered])


class ProgramVerificationError(ValueError):
    """Raised by Program.verify / the Executor pre-flight when a program
    has diagnostics at or above the requested severity level."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__(format_diagnostics(self.diagnostics))
