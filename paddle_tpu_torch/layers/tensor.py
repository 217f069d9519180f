"""Tensor layers: create_parameter, fill_constant, sums (counterpart of
paddle_tpu/layers/tensor.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "fill_constant", "sums"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = dict(attr or {})
    if name:
        attr.setdefault("name", name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, out=None, main_program=None):
    helper = LayerHelper("fill_constant", main_program=main_program)
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op("fill_constant", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    out.stop_gradient = True
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(dtype=input[0].dtype)
    helper.append_op("sum", {"X": [v.name for v in input]},
                     {"Out": [out.name]})
    return out

