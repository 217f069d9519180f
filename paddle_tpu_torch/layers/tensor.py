"""Tensor-creation and manipulation layers (counterpart of
paddle_tpu/layers/tensor.py)."""
from __future__ import annotations

import numpy as np

from ..core.framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var",
           "fill_constant", "fill_constant_batch_size_like", "ones",
           "zeros", "cast", "concat", "sums", "assign", "argmax",
           "increment", "zeros_like"]


def create_tensor(dtype, name=None, main_program=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name,
                         main_program=main_program)
    return helper.create_variable(
        name or helper.name, dtype=dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = dict(attr or {})
    if name:
        attr.setdefault("name", name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None):
    """A global-block variable filled with `value` by the startup
    program."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(name=name, dtype=dtype, shape=shape,
                                        persistable=persistable)
    sb = helper.startup_program.global_block()
    sb.create_var(name=var.name, shape=tuple(shape), dtype=dtype,
                  persistable=persistable)
    sb.append_op("fill_constant", {}, {"Out": [var.name]},
                 {"shape": list(shape), "dtype": dtype,
                  "value": float(value)})
    return var


def fill_constant(shape, dtype, value, out=None, main_program=None):
    helper = LayerHelper("fill_constant", main_program=main_program)
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op("fill_constant", {}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op("fill_constant_batch_size_like",
                     {"Input": [input.name]}, {"Out": [out.name]},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value), "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, main_program=None):
    return fill_constant(shape, dtype, 1.0, main_program=main_program)


def zeros(shape, dtype, main_program=None):
    return fill_constant(shape, dtype, 0.0, main_program=main_program)


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op("cast", {"X": [x.name]}, {"Out": [out.name]},
                     {"out_dtype": dtype})
    return out


def concat(input, axis=0):
    """Join `input` (a list of Variables) along `axis`; the output's
    shape is set here, as the JAX package's layer sets it (-1 where any
    input's joined dim is unknown)."""
    helper = LayerHelper("concat")
    out = helper.create_tmp_variable(dtype=input[0].dtype)
    helper.append_op("concat", {"X": [v.name for v in input]},
                     {"Out": [out.name]}, {"axis": axis})
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        ax = axis if axis >= 0 else axis + len(shapes[0])
        dims = list(shapes[0])
        dims[ax] = (-1 if any(int(s[ax]) < 0 for s in shapes)
                    else sum(int(s[ax]) for s in shapes))
        out.shape = tuple(dims)
    out.lod_level = max(getattr(v, "lod_level", 0) for v in input)
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(dtype=input[0].dtype)
    helper.append_op("sum", {"X": [v.name for v in input]},
                     {"Out": [out.name]})
    return out



def assign(input, output=None):
    """Copy a Variable (`assign`), or a numpy array into the Program as
    an `assign_value` constant (its values, shape and dtype as attrs)."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_tmp_variable(
            dtype=input.dtype if isinstance(input, Variable) else "float32")
    if isinstance(input, Variable):
        helper.append_op("assign", {"X": [input.name]},
                         {"Out": [output.name]})
    else:
        arr = np.asarray(input)
        helper.append_op("assign_value", {}, {"Out": [output.name]},
                         {"shape": list(arr.shape), "dtype": str(arr.dtype),
                          "values": arr.flatten().tolist()})
    return output


def argmax(x, axis=-1):
    helper = LayerHelper("argmax")
    out = helper.create_tmp_variable(dtype="int64", stop_gradient=True)
    helper.append_op("argmax", {"X": [x.name]}, {"Out": [out.name]},
                     {"axis": axis})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op("increment", {"X": [x.name]}, {"Out": [out.name]},
                     {"step": float(value)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op("fill_zeros_like", {"X": [x.name]}, {"Out": [out.name]})
    return out
