"""NN layers: fc, embedding, flash_attention, the conv-net layers
(conv2d, pool2d, batch_norm, dropout), layer_norm, the losses,
reductions and metrics of a training Program (counterpart of
paddle_tpu/layers/nn.py)."""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "dropout", "flash_attention", "moe_ffn",
           "accuracy", "conv2d", "pool2d", "batch_norm", "layer_norm", "lrn",
           "mean", "reduce_sum", "topk", "cross_entropy",
           "square_error_cost", "softmax_with_cross_entropy"]


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


def dropout(x, dropout_prob, is_test=False, seed=0, name=None):
    """Dropout (ops/activation.py): a nonzero `seed` fixes the draws."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("dropout", {"X": [x.name]},
                     {"Out": [out.name], "Mask": [mask.name]},
                     {"dropout_prob": float(dropout_prob),
                      "is_test": is_test, "seed": seed,
                      "fix_seed": seed != 0})
    return out


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


def moe_ffn(input, num_experts, d_inner=None, top_k=1,
            capacity_factor=1.25, param_attr=None, name=None):
    """Mixture-of-Experts FFN layer (parallel/moe.py holds the math).

    input: [..., D] activations; builds a [D, E] router plus per-expert
    [E, D, H]/[E, H, D] FFN weights and returns (out [..., D],
    aux_loss [1]).  Add `weight * aux_loss` to the training loss to
    train the router toward load balance (Switch eq. 4).
    """
    helper = LayerHelper("moe_ffn", input=input, param_attr=param_attr,
                         name=name)
    dtype = helper.input_dtype()
    d = int(input.shape[-1])
    d_inner = int(d_inner or 4 * d)
    num_experts = int(num_experts)

    def attr_for(suffix):
        # three differently-shaped params from ONE param_attr: an
        # explicit name must fan out per suffix or create_parameter
        # would silently overwrite the same variable three times
        a = dict(param_attr or {})
        if a.get("name"):
            a["name"] = f"{a['name']}.{suffix}"
        return a

    gate_w = helper.create_parameter(attr_for("gate_w"),
                                     [d, num_experts], dtype,
                                     suffix="gate_w")
    w_in = helper.create_parameter(attr_for("w_in"),
                                   [num_experts, d, d_inner],
                                   dtype, suffix="w_in")
    w_out = helper.create_parameter(attr_for("w_out"),
                                    [num_experts, d_inner, d],
                                    dtype, suffix="w_out")
    out = helper.create_tmp_variable(dtype)
    out.shape = input.shape
    aux = helper.create_tmp_variable(dtype)
    aux.shape = [1]
    helper.append_op("moe_ffn",
                     {"X": [input.name], "GateW": [gate_w.name],
                      "WIn": [w_in.name], "WOut": [w_out.name]},
                     {"Out": [out.name], "AuxLoss": [aux.name]},
                     {"top_k": int(top_k),
                      "capacity_factor": float(capacity_factor)})
    return out, aux


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy from top_k + accuracy ops."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    topk_indices = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("top_k", {"X": [input.name]},
                     {"Out": [topk_out.name],
                      "Indices": [topk_indices.name]}, {"k": k})
    acc_out = helper.create_tmp_variable("float32", stop_gradient=True)
    correct = correct or helper.create_tmp_variable("int32",
                                                    stop_gradient=True)
    total = total or helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        {"Out": [topk_out.name], "Indices": [topk_indices.name],
         "Label": [label.name]},
        {"Accuracy": [acc_out.name], "Correct": [correct.name],
         "Total": [total.name]})
    return acc_out


def _check_layout(value, name="data_format"):
    """Normalize/validate a layout string: a typo such as "nhwc" must not
    build a mixed-layout network."""
    v = str(value).upper()
    if v not in ("NCHW", "NHWC"):
        raise ValueError(f"{name} must be 'NCHW' or 'NHWC', got {value!r}")
    return v


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None,
           name=None, use_cudnn=True, main_program=None,
           startup_program=None, data_format="NCHW"):
    """2-D convolution (+ bias over the channel axis, + act); the filter
    is [num_filters, C / groups, kh, kw], N(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = input.dtype
    data_format = _check_layout(data_format)
    c_axis = 3 if data_format == "NHWC" else 1
    num_channels = input.shape[c_axis]
    groups = groups or 1
    filter_size = _pair_list(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = math.sqrt(2.0 / (num_channels * filter_size[0] * filter_size[1]))
    w = helper.create_parameter(param_attr, filter_shape, dtype,
                                default_initializer=NormalInitializer(
                                    0.0, std),
                                suffix="w")
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        "conv2d", {"Input": [input.name], "Filter": [w.name]},
        {"Output": [pre_bias.name]},
        {"strides": _pair_list(stride), "paddings": _pair_list(padding),
         "dilations": _pair_list(dilation), "groups": groups,
         "use_cudnn": use_cudnn, "data_format": data_format})
    pre_act = helper.append_bias_op(pre_bias, dim_start=c_axis,
                                    dim_end=c_axis + 1)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True, name=None,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    data_format = _check_layout(data_format)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "pool2d", {"X": [input.name]}, {"Out": [out.name]},
        {"pooling_type": pool_type, "ksize": _pair_list(pool_size),
         "strides": _pair_list(pool_stride),
         "paddings": _pair_list(pool_padding),
         "global_pooling": global_pooling, "use_cudnn": use_cudnn,
         "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None):
    """Batch norm over the channel axis; the moving mean and variance are
    persistable, non-trainable parameters that the op updates in place
    (MeanOut/VarianceOut are written under their names)."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    data_layout = _check_layout(data_layout, "data_layout")
    c_axis = 1 if data_layout == "NCHW" else len(input.shape) - 1
    channels = input.shape[c_axis]
    scale = helper.create_parameter(
        param_attr, [channels], dtype,
        default_initializer=ConstantInitializer(1.0), suffix="scale")
    bias = helper.create_parameter(bias_attr or {}, [channels], dtype,
                                   is_bias=True, suffix="offset")
    mean = helper.create_parameter(
        {"name": moving_mean_name, "trainable": False}, [channels], dtype,
        default_initializer=ConstantInitializer(0.0), suffix="mean")
    variance = helper.create_parameter(
        {"name": moving_variance_name, "trainable": False}, [channels],
        dtype, default_initializer=ConstantInitializer(1.0), suffix="var")
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_var = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        "batch_norm",
        {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
         "Mean": [mean.name], "Variance": [variance.name]},
        {"Y": [out.name], "MeanOut": [mean.name],
         "VarianceOut": [variance.name], "SavedMean": [saved_mean.name],
         "SavedVariance": [saved_var.name]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout})
    return helper.append_activation(out)


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


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None):
    """Cross-channel local response normalization (ops/norm.py)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype)
    mid = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    helper.append_op("lrn", {"X": [input.name]},
                     {"Out": [out.name], "MidOut": [mid.name]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


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


def topk(input, k=1):
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    indices = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("top_k", {"X": [input.name]},
                     {"Out": [values.name], "Indices": [indices.name]},
                     {"k": k})
    return values, indices


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
