"""NN layers: fc, embedding, flash_attention, layer_norm, the losses
and reductions of a training Program (counterpart of
paddle_tpu/layers/nn.py)."""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "flash_attention", "layer_norm", "mean",
           "reduce_sum", "cross_entropy", "square_error_cost",
           "softmax_with_cross_entropy"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, main_program=None, startup_program=None):
    """Fully-connected: mul per input + sum + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var in helper.multiple_input():
        param_shape = [abs(math.prod(input_var.shape[num_flatten_dims:])),
                       size]
        w = helper.create_parameter(param_attr, param_shape, dtype,
                                    suffix="w")
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(
            "mul", {"X": [input_var.name], "Y": [w.name]},
            {"Out": [tmp.name]},
            {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op("sum", {"X": [v.name for v in mul_results]},
                         {"Out": [pre_bias.name]})
    # bias covers only the projected dims: a [size] bias
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """Lookup-table layer."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, size, dtype, suffix="w")
    tmp = helper.create_tmp_variable(dtype)
    tmp.lod_level = input.lod_level
    tmp.shape = (-1, int(size[1]))
    helper.append_op(
        "lookup_table", {"Ids": [input.name], "W": [w.name]},
        {"Out": [tmp.name]},
        {"is_sparse": bool(is_sparse),
         "padding_idx": -1 if padding_idx is None else int(padding_idx)})
    return tmp


def flash_attention(q, k, v, causal=False, scale=None, min_seq_k=None,
                    name=None):
    """Fused attention over [batch, seq, heads, head_dim] tensors.
    `min_seq_k` is recorded on the op as the JAX package does; this
    package's op does not read it."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_tmp_variable(q.dtype)
    out.shape = q.shape
    helper.append_op("flash_attention",
                     {"Q": [q.name], "K": [k.name], "V": [v.name]},
                     {"Out": [out.name]},
                     {"causal": bool(causal),
                      "scale": 1.0 if scale is None else float(scale),
                      "default_scale": scale is None,
                      "min_seq_k": -1 if min_seq_k is None
                      else int(min_seq_k)})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(
            param_attr, norm_shape, dtype,
            default_initializer=ConstantInitializer(1.0), suffix="scale")
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr or {}, norm_shape, dtype,
                                    is_bias=True, suffix="shift")
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(dtype)
    mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    var = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op("layer_norm", inputs,
                     {"Y": [out.name], "Mean": [mean.name],
                      "Variance": [var.name]},
                     {"epsilon": epsilon,
                      "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("mean", {"X": [x.name]}, {"Out": [out.name]})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_tmp_variable(input.dtype)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
        attrs["dim"] = [0]
    else:
        attrs["reduce_all"] = False
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    helper.append_op("reduce_sum", {"X": [input.name]}, {"Out": [out.name]},
                     attrs)
    return out


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("cross_entropy",
                     {"X": [input.name], "Label": [label.name]},
                     {"Y": [out.name]}, {"soft_label": soft_label})
    return out


def square_error_cost(input, label):
    """(input - label)^2."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_tmp_variable(input.dtype)
    helper.append_op("elementwise_sub",
                     {"X": [input.name], "Y": [label.name]},
                     {"Out": [minus_out.name]}, {"axis": -1})
    square_out = helper.create_tmp_variable(input.dtype)
    helper.append_op("square", {"X": [minus_out.name]},
                     {"Out": [square_out.name]})
    return square_out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits.name], "Label": [label.name]},
                     {"Softmax": [softmax.name], "Loss": [loss.name]},
                     {"soft_label": soft_label})
    return loss
