"""Thin generated layer wrappers for one-input and two-input ops
(counterpart of paddle_tpu/layers/ops.py, the same three lists): the
comparisons and logicals make bool outputs."""
from __future__ import annotations

import sys

from ..core import registry
from ..layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "sqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "log", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_shrink",
    "thresholded_relu", "hard_sigmoid", "swish", "softmax", "cumsum",
    "clip", "clip_by_norm", "scale", "transpose", "reshape", "slice",
]

_BINARY = [
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "logical_and", "logical_or",
    "logical_xor",
]

_BOOL_OUT = {
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "logical_and", "logical_or", "logical_xor", "logical_not",
}

__all__ = list(_UNARY) + list(_BINARY) + ["logical_not"]

_mod = sys.modules[__name__]


def _make_unary(op_type):
    info = registry.get_op_info(op_type)
    in_slot = info.inputs[0] if info.inputs else "X"
    out_slot = info.outputs[0] if info.outputs else "Out"

    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        dtype = "bool" if op_type in _BOOL_OUT else x.dtype
        out = helper.create_tmp_variable(dtype=dtype)
        helper.append_op(op_type, {in_slot: [x.name]},
                         {out_slot: [out.name]}, attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return layer


def _make_binary(op_type):
    def layer(x, y, axis=-1, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        dtype = "bool" if op_type in _BOOL_OUT else x.dtype
        out = helper.create_tmp_variable(dtype=dtype)
        a = dict(attrs)
        if not op_type.startswith("logical"):   # the logicals have no axis
            a["axis"] = axis
        helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                         {"Out": [out.name]}, a)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return layer


for _t in _UNARY:
    setattr(_mod, _t, _make_unary(_t))
for _t in _BINARY:
    setattr(_mod, _t, _make_binary(_t))
setattr(_mod, "logical_not", _make_unary("logical_not"))
