"""The comparison layers of paddle_tpu/layers/control_flow.py:
`less_than` and `equal` with the in-place `cond` idiom of While loops.
As in the JAX package they shadow the generated wrappers of
layers/ops.py in `fluid.layers`.  The rest of that module (While,
IfElse, DynamicRNN, tensor arrays) needs sub-blocks and LoD: ROADMAP
A7."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["less_than", "equal"]


def _compare(op_type, x, y, cond):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_tmp_variable("bool")
        cond.stop_gradient = True
    helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                     {"Out": [cond.name]})
    return cond


def less_than(x, y, cond=None, **ignored):
    """x < y elementwise; written into `cond` when given."""
    return _compare("less_than", x, y, cond)


def equal(x, y, cond=None, **ignored):
    """x == y elementwise; written into `cond` when given."""
    return _compare("equal", x, y, cond)
