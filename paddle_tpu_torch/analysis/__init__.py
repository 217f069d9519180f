"""paddle_tpu_torch.analysis — build-time static analysis of the Program
IR (counterpart of paddle_tpu/analysis).

A pass-based verifier over Program/Block/Operator descs: catches bad
graphs in milliseconds at build time instead of at the first failing op
on the card.  The Fluid architecture compiles the whole program before
anything runs (framework.proto OpDesc/VarDesc, compile-time InferShape);
this package is the reproduction's analogue of that compile-time
checking layer, upgraded from scattered per-op asserts to a real
analyzer with structured diagnostics.

Entry points:
  * `Program.verify(level=...)` (core/framework.py) — the user surface;
  * `verify_program(program, ...)` — the functional driver;
  * `preflight(program, ...)` — the Executor/ParallelExecutor hook,
    gated by the `verify` flag (env `PADDLE_TPU_VERIFY=off|warn|error`)
    and cached per program version so steady-state training loops pay
    nothing;
  * `register_pass` — extend the pipeline with project-specific
    invariants (docs/analysis.md shows a worked example).
"""
from __future__ import annotations

import warnings
import weakref
from typing import Iterable, List, Optional

from .diagnostics import (  # noqa: F401
    Diagnostic,
    ProgramVerificationError,
    SEVERITIES,
    format_diagnostics,
    max_severity,
    severity_rank,
)
from .registry import (  # noqa: F401
    AnalysisPass,
    PassContext,
    get_pass,
    register_pass,
    registered_passes,
    verify_program,
)
from . import passes as _builtin_passes  # noqa: F401  (registers built-ins)
from . import cost_model  # noqa: F401  (registers cost/comm passes)
from . import concurrency  # noqa: F401  (AST concurrency analyzer)
from . import schedcheck  # noqa: F401  (deterministic-schedule checker)
from .cost_model import (  # noqa: F401
    CommEstimate,
    OpCost,
    ProgramCostEstimate,
    analyze_generation_spec,
    check_budget,
    estimate_comm,
    estimate_op,
    estimate_peak_hbm,
    estimate_program,
    ridge_point,
    serving_kernel_cost,
)

__all__ = [
    "Diagnostic",
    "ProgramVerificationError",
    "SEVERITIES",
    "format_diagnostics",
    "max_severity",
    "register_pass",
    "registered_passes",
    "get_pass",
    "verify_program",
    "preflight",
    "PassContext",
    "AnalysisPass",
    "OpCost",
    "ProgramCostEstimate",
    "CommEstimate",
    "estimate_op",
    "estimate_program",
    "estimate_peak_hbm",
    "estimate_comm",
    "ridge_point",
    "analyze_generation_spec",
    "serving_kernel_cost",
    "check_budget",
    "concurrency",
    "schedcheck",
]


# program -> (version, mode) already verified; weak keys so a dropped
# Program releases its entry.  One program is re-verified only when it
# mutates (bump_version) or the verify mode changes.
_preflight_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _verify_mode() -> str:
    from ..core.flags import get_flag

    mode = str(get_flag("verify") or "off").lower()
    if mode not in ("off", "warn", "error"):
        raise ValueError(
            f"PADDLE_TPU_VERIFY must be off|warn|error, got {mode!r}")
    return mode


def preflight(
    program,
    feed_names: Optional[Iterable[str]] = None,
    fetch_names: Optional[Iterable[str]] = None,
) -> List[Diagnostic]:
    """Flag-gated verification before an executor runs `program`.

    `PADDLE_TPU_VERIFY=off` (default): no-op.  `warn`: run the analyzer
    and emit one RuntimeWarning per error/warning diagnostic.  `error`:
    additionally raise ProgramVerificationError when any error-severity
    diagnostic exists.  Results are cached per (program, version, mode):
    a training loop re-running one stable program verifies exactly once.

    Empty feed/fetch containers are treated as "context unknown", not
    "known empty": a warm-up `exe.run(prog)` with no fetch_list must
    not upgrade dead-op findings to warnings for the whole cached
    program.
    """
    mode = _verify_mode()
    if mode == "off":
        return []
    feed_names = feed_names or None
    fetch_names = fetch_names or None
    try:
        cached = _preflight_cache.get(program)
    except TypeError:  # unhashable/weakref-less program stand-in
        cached = None
    if cached is not None and cached == (program._version, mode):
        return []
    diagnostics = verify_program(program, feed_names=feed_names,
                                 fetch_names=fetch_names)
    errors = [d for d in diagnostics if d.severity == "error"]
    notable = [d for d in diagnostics if d.severity != "info"]
    if mode == "error" and errors:
        raise ProgramVerificationError(errors)
    if notable:
        warnings.warn(
            "program verification found issues:\n"
            + format_diagnostics(notable),
            RuntimeWarning, stacklevel=3)
    try:
        _preflight_cache[program] = (program._version, mode)
    except TypeError:
        pass
    return diagnostics
