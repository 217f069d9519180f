"""Parameter initializers — append init ops to the startup program
(counterpart of paddle_tpu/initializer.py: Constant/Uniform/Normal/
Xavier/MSRA, each emitting fill_constant / uniform_random /
gaussian_random ops into the startup block)."""
from __future__ import annotations

import contextlib
import math

__all__ = [
    "Constant",
    "Uniform",
    "Normal",
    "Xavier",
    "MSRA",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "XavierInitializer",
    "MSRAInitializer",
    "force_init_on_cpu",
    "init_on_cpu",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "value": self.value,
             "force_cpu": force_init_on_cpu()})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "min": self.low, "max": self.high, "seed": self.seed,
             "force_cpu": force_init_on_cpu()})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", {}, {"Out": [var.name]},
            {"shape": list(var.shape), "dtype": var.dtype,
             "mean": self.loc, "std": self.scale, "seed": self.seed,
             "force_cpu": force_init_on_cpu()})


def _fan_in_out(var):
    """For conv filters [out_c, in_c, k...] fan_in = in_c*prod(k),
    fan_out = out_c*prod(k)."""
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    recep = 1
    for d in shape[2:]:
        recep *= d
    return shape[1] * recep, shape[0] * recep


class XavierInitializer(Initializer):
    """Glorot init."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He init."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer


# ---------------------------------------------------------------------------
# init-on-cpu context (the JAX package's initializer.py:124-147): the
# initializer ops created inside carry force_cpu=True.  The attribute
# travels with the Program; the lowerings draw on the op's device as
# before.
# ---------------------------------------------------------------------------

_force_init_on_cpu_ = False


def force_init_on_cpu() -> bool:
    return _force_init_on_cpu_


@contextlib.contextmanager
def init_on_cpu():
    """`with init_on_cpu():` — initializer ops created inside carry
    force_cpu=True; the previous state comes back on exit."""
    global _force_init_on_cpu_
    pre_state = _force_init_on_cpu_
    _force_init_on_cpu_ = True
    try:
        yield
    finally:
        _force_init_on_cpu_ = pre_state
