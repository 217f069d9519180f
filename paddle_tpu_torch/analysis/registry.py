"""Pass registry + the verification driver (counterpart of
paddle_tpu/analysis/registry.py).

Analysis passes are plain functions `fn(ctx) -> iterable[Diagnostic]`
registered under a stable pass id.  `verify_program` runs a pass
pipeline over one Program and collects every diagnostic — the pass-based
architecture mirrors the reference's compile-time pipeline (one
InferShape/validate hook per op desc), but passes here see the WHOLE
program so they can check cross-op and cross-block invariants the
per-op hooks could not.

Registering a custom pass:

    from paddle_tpu_torch import analysis

    @analysis.register_pass("my-invariant")
    def my_invariant(ctx):
        for block, idx, op in ctx.iter_ops():
            if bad(op):
                yield ctx.diag("error", "...", block, idx, op,
                               hint="...")
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ..core import registry as op_registry
from .diagnostics import (
    Diagnostic,
    ProgramVerificationError,
    severity_rank,
)

__all__ = [
    "AnalysisPass",
    "PassContext",
    "register_pass",
    "registered_passes",
    "get_pass",
    "verify_program",
]


@dataclasses.dataclass
class AnalysisPass:
    id: str
    fn: Callable  # fn(ctx) -> iterable[Diagnostic]
    order: int = 100  # lower runs first (shape prop feeds later passes)
    doc: str = ""


_PASSES: Dict[str, AnalysisPass] = {}


def register_pass(pass_id: str, order: int = 100):
    """Decorator: register `fn(ctx)` as analysis pass `pass_id`."""

    def deco(fn):
        _PASSES[pass_id] = AnalysisPass(
            id=pass_id, fn=fn, order=order, doc=(fn.__doc__ or "").strip()
        )
        return fn

    return deco


def registered_passes() -> List[AnalysisPass]:
    return sorted(_PASSES.values(), key=lambda p: (p.order, p.id))


def get_pass(pass_id: str) -> AnalysisPass:
    if pass_id not in _PASSES:
        raise KeyError(
            f"analysis pass {pass_id!r} is not registered; known: "
            f"{sorted(_PASSES)}"
        )
    return _PASSES[pass_id]


class PassContext:
    """Per-verification state shared by every pass.

    `feed_names` / `fetch_names` are optional runtime context (the
    Executor pre-flight knows them; `Program.verify()` usually does not)
    — passes must degrade severity gracefully when they are None.
    """

    def __init__(self, program, feed_names=None, fetch_names=None):
        self.program = program
        self.feed_names = (None if feed_names is None
                           else {str(n) for n in feed_names})
        self.fetch_names = (None if fetch_names is None
                            else {str(n) for n in fetch_names})

    # -- iteration helpers ---------------------------------------------------
    def iter_ops(self):
        """Yield (block, op_idx, op) over every block in program order."""
        for block in self.program.blocks:
            for idx, op in enumerate(block.ops):
                yield block, idx, op

    def op_info(self, op):
        """Registered OpInfo for `op`, or None when unregistered.  For a
        generic grad op this resolves to the FORWARD op's info (the
        registry convention) — callers compare info.type vs op.type."""
        try:
            return op_registry.get_op_info(op.type)
        except KeyError:
            return None

    def resolvable(self, block, name: str) -> bool:
        """Scope-style lookup: name found in `block` or an ancestor."""
        b = block
        seen = set()
        while b is not None and b.idx not in seen:
            seen.add(b.idx)
            if name in b.vars:
                return True
            b = b.parent if 0 <= b.parent_idx < len(self.program.blocks) \
                else None
        return False

    # -- diagnostic factory --------------------------------------------------
    def diag(self, severity, message, block=None, op_idx=None, op=None,
             pass_id="", hint="") -> Diagnostic:
        return Diagnostic(
            pass_id=pass_id,
            severity=severity,
            message=message,
            block_idx=getattr(block, "idx", 0) if block is not None else 0,
            op_idx=op_idx,
            op_type=getattr(op, "type", None),
            op_repr=repr(op) if op is not None else "",
            hint=hint,
        )


def verify_program(
    program,
    level: Optional[str] = None,
    passes: Optional[Sequence[str]] = None,
    feed_names: Optional[Iterable[str]] = None,
    fetch_names: Optional[Iterable[str]] = None,
) -> List[Diagnostic]:
    """Run analysis passes over `program`, returning every diagnostic.

    `level`: when set ("info" | "warning"/"warn" | "error"), raise
    ProgramVerificationError if any diagnostic is at or above that
    severity.  None/"off" never raises.
    `passes`: restrict to these pass ids (default: all registered).
    """
    from . import passes as _builtin  # noqa: F401  (registers built-ins)
    from . import cost_model as _cost  # noqa: F401  (cost/comm passes)

    selected = (registered_passes() if passes is None
                else [get_pass(p) for p in passes])
    ctx = PassContext(program, feed_names=feed_names,
                      fetch_names=fetch_names)
    diagnostics: List[Diagnostic] = []
    for p in selected:
        for d in p.fn(ctx) or ():
            if not d.pass_id:
                d.pass_id = p.id
            diagnostics.append(d)
    if level not in (None, "off"):
        lvl = "warning" if level == "warn" else level
        threshold = severity_rank(lvl)
        bad = [d for d in diagnostics
               if severity_rank(d.severity) >= threshold]
        if bad:
            raise ProgramVerificationError(bad)
    return diagnostics
