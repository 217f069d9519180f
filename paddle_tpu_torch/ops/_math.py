"""A correctly rounded float32 square root on the host.

PyTorch's float32 ``torch.sqrt`` on a CPU tensor misses the correctly
rounded value in about 0.6 % of elements (its vectorised path); the JAX
package's ``jnp.sqrt`` and the card's ``torch.sqrt`` round correctly.  A
float32 square root taken in float64 and rounded back is correctly
rounded (53 >= 2 * 24 + 2), so every sqrt-using lowering goes through
`sqrt` here: a CPU float32 tensor takes that route, every other tensor
(the card's among them) ``torch.sqrt`` as before.
"""
from __future__ import annotations

import torch

__all__ = ["sqrt"]


class _HostSqrt(torch.autograd.Function):
    """sqrt in float64, rounded to float32; its gradient is the JAX
    package's rule, g * (0.5 / sqrt(x)), in float32."""

    @staticmethod
    def forward(ctx, x):
        out = torch.sqrt(x.double()).float()
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        return g * (0.5 / out)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt(x)``, correctly rounded where x is a float32 tensor
    on the CPU."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return _HostSqrt.apply(x)
    return torch.sqrt(x)
