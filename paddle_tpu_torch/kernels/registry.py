"""Serving-kernel registry: selection + per-op fallback accounting.

Counterpart of paddle_tpu/kernels/registry.py, with the same contract
retargeted to hand-written CUDA kernels:

  * each kernel registers a `supports(**ctx) -> None | reason` predicate
    over the shapes/dtypes it takes and a `build(**ctx)` factory;
  * `Selection.pick(name, platform=..., **ctx)` resolves the
    `serving_kernels` flag (PADDLE_TPU_SERVING_KERNELS): "auto" arms for
    a consumer placed on a CUDA device, "on" arms everywhere, "off"
    never arms.  There is no interpret mode: the plain PyTorch version
    is what runs when the kernel is not armed;
  * an armed combination the kernel does not take records its reason,
    counted in ``paddle_tpu_kernel_fallbacks_total{kernel,reason}``, and
    the Selection that counted it reclaims its series on close;
  * `Selection.require(name, **ctx)` serves consumers that have no plain
    path on a CUDA device (the training kernels): no flag disarms the
    kernel there, and a context it does not take raises.

Reasons are real limits of the kernel (dtype, head split, window, head
width) or of the place (no CUDA device).  Nothing is routed silently: a
kernel that is picked and then fails to build or launch raises.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..observability import metrics as obs_metrics

__all__ = [
    "register_kernel",
    "kernels_mode",
    "kernels_armed",
    "Selection",
    "select",
    "FALLBACK_METRIC",
]

FALLBACK_METRIC = "paddle_tpu_kernel_fallbacks_total"

# always=True: an operator must be able to see that an armed kernel
# never ran, so it counts even with the metrics gate off
_M_FALLBACKS = obs_metrics.counter(
    FALLBACK_METRIC,
    "serving-kernel selections routed to the plain PyTorch version",
    ("kernel", "reason"), always=True)


class _KernelDef:
    __slots__ = ("name", "supports", "build")

    def __init__(self, name, supports, build):
        self.name = name
        self.supports = supports
        self.build = build


_REGISTRY: Dict[str, _KernelDef] = {}


def register_kernel(name: str, supports: Callable[..., Optional[str]]):
    """Register `build(**ctx) -> callable` as the CUDA implementation of
    `name`; `supports(**ctx)` returns None when the context (shapes,
    dtypes, platform) is runnable and a short reason otherwise."""

    def deco(build):
        _REGISTRY[name] = _KernelDef(name, supports, build)
        return build

    return deco


def _kernel_def(name: str) -> _KernelDef:
    kdef = _REGISTRY.get(name)
    if kdef is None:
        raise KeyError(f"unknown serving kernel {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return kdef


def kernels_mode() -> str:
    """The `serving_kernels` flag, normalized to auto/on/off."""
    from ..core.flags import get_flag

    v = str(get_flag("serving_kernels")).strip().lower()
    if v in ("1", "true", "yes", "on"):
        return "on"
    if v in ("0", "false", "no", "off"):
        return "off"
    return "auto"


def kernels_armed(platform: str) -> bool:
    """Whether selection tries the kernel tier: "on" arms everywhere,
    "auto" only for a consumer placed on a CUDA device."""
    mode = kernels_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return platform == "cuda"


class Selection:
    """One consumer's kernel choices plus its fallback-series ledger.

    `chosen` maps kernel name -> "cuda" or "plain:<reason>" (the reason
    "disarmed" when the flag kept the kernel tier off); `close()`
    reclaims exactly the {kernel,reason} series this consumer
    counted."""

    def __init__(self):
        self.chosen: Dict[str, str] = {}
        self._counted: List[Tuple[str, str]] = []

    def pick(self, name: str, *, platform: str, **ctx):
        """-> the kernel callable, or None for the plain version.

        Disarmed returns None without counting — nothing fell back, the
        plain version was the plan.  Armed but unsupported counts one
        fallback and returns None."""
        kdef = _kernel_def(name)
        if not kernels_armed(platform):
            self.chosen[name] = "plain:disarmed"
            return None
        reason = kdef.supports(platform=platform, **ctx)
        if reason is not None:
            self._count(name, reason)
            return None
        self.chosen[name] = "cuda"
        return kdef.build(**ctx)

    def require(self, name: str, **ctx):
        """-> the kernel callable for a consumer whose tensors are on a
        CUDA device, where the port has no plain path: the flag does not
        disarm it, and a context the kernel does not take raises
        ValueError naming the reason."""
        kdef = _kernel_def(name)
        reason = kdef.supports(platform="cuda", **ctx)
        if reason is not None:
            raise ValueError(
                f"{name}: the CUDA kernel does not take this call "
                f"({reason}) and there is no plain path on a CUDA device: "
                f"{ctx}")
        self.chosen[name] = "cuda"
        return kdef.build(**ctx)

    def decline(self, name: str, reason: str, *, platform: str):
        """The consumer ruled the kernel out itself (the shape of its
        program, not a limit of the kernel): "plain:disarmed" when the
        flag keeps the tier off, else counted like an unsupported
        context."""
        _kernel_def(name)
        if not kernels_armed(platform):
            self.chosen[name] = "plain:disarmed"
        else:
            self._count(name, reason)

    def _count(self, name: str, reason: str):
        self.chosen[name] = f"plain:{reason}"
        self._counted.append((name, reason))
        _M_FALLBACKS.labels(kernel=name, reason=reason).inc()

    def close(self):
        """Drop this consumer's fallback series.  Safe to call twice."""
        for key in dict.fromkeys(self._counted):
            _M_FALLBACKS.remove(kernel=key[0], reason=key[1])
        self._counted = []


def select(name: str, **ctx):
    """One-off selection with no reclamation ledger (prefer a Selection
    for anything with a close() lifecycle): `ctx` carries `platform`,
    as Selection.pick takes it."""
    return Selection().pick(name, **ctx)
