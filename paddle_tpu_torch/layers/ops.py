"""Thin generated layer wrappers for one-input and two-input ops
(counterpart of paddle_tpu/layers/ops.py), for the ops this package
registers."""
from __future__ import annotations

import sys

from ..core import registry
from ..layer_helper import LayerHelper

_UNARY = ["relu", "square", "sqrt", "softmax", "clip", "clip_by_norm",
          "scale", "reshape", "slice"]
_BINARY = ["elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max"]

__all__ = list(_UNARY) + list(_BINARY)

_mod = sys.modules[__name__]


def _make_unary(op_type):
    info = registry.get_op_info(op_type)
    in_slot = info.inputs[0] if info.inputs else "X"
    out_slot = info.outputs[0] if info.outputs else "Out"

    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(op_type, {in_slot: [x.name]},
                         {out_slot: [out.name]}, attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return layer


def _make_binary(op_type):
    def layer(x, y, axis=-1, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                         {"Out": [out.name]}, {**attrs, "axis": axis})
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Autogenerated wrapper for the `{op_type}` op."
    return layer


for _t in _UNARY:
    setattr(_mod, _t, _make_unary(_t))
for _t in _BINARY:
    setattr(_mod, _t, _make_binary(_t))
