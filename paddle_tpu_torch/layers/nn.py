"""NN layers: fc, embedding, flash_attention, the conv-net layers
(conv2d, pool2d, batch_norm, dropout), layer_norm, matmul, the losses,
reductions, split, l2_normalize, one_hot, cos_sim, multiplex, the step
counter and the metrics of a training Program, the sequence and
recurrent layers over LoD values, CTC and the sampled losses
(counterpart of paddle_tpu/layers/nn.py)."""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "dropout", "flash_attention", "moe_ffn",
           "accuracy", "conv2d", "pool2d", "batch_norm", "layer_norm", "lrn",
           "mean", "matmul", "reduce_sum", "reduce_mean", "reduce_max",
           "reduce_min", "topk", "cross_entropy", "square_error_cost",
           "cos_sim", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "split", "l2_normalize",
           "one_hot", "autoincreased_step_counter", "smooth_l1",
           "multiplex", "edit_distance", "linear_chain_crf",
           "crf_decoding", "chunk_eval", "dynamic_lstm", "dynamic_gru",
           "sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_softmax", "sequence_expand",
           "sequence_reshape", "lod_reset", "im2sequence", "dynamic_lstmp",
           "gru_unit", "lstm_unit", "warpctc", "ctc_align",
           "ctc_greedy_decoder", "nce", "hsigmoid"]


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


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("matmul", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]},
                     {"transpose_X": transpose_x,
                      "transpose_Y": transpose_y})
    return out


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    """dim None reduces every dim (reduce_all)."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_tmp_variable(input.dtype)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
        attrs["dim"] = [0]
    else:
        attrs["reduce_all"] = False
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    helper.append_op(op_type, {"X": [input.name]}, {"Out": [out.name]},
                     attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


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


def cos_sim(X, Y):
    """Row-wise cosine similarity; Y may have a single row, broadcast
    to X."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype)
    xnorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", {"X": [X.name], "Y": [Y.name]},
                     {"Out": [out.name], "XNorm": [xnorm.name],
                      "YNorm": [ynorm.name]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_tmp_variable(logits.dtype)
    loss = helper.create_tmp_variable(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits.name], "Label": [label.name]},
                     {"Softmax": [softmax.name], "Loss": [loss.name]},
                     {"soft_label": soft_label})
    return loss


def sigmoid_cross_entropy_with_logits(x, label):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x.name], "Label": [label.name]},
                     {"Out": [out.name]})
    return out


def split(input, num_or_sections, dim=-1):
    """`num_or_sections` equal parts (an int) or those sizes (a list)
    along `dim` -> the list of parts."""
    helper = LayerHelper("split")
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_tmp_variable(input.dtype)
            for _ in range(num if num else len(sections))]
    helper.append_op("split", {"X": [input.name]},
                     {"Out": [o.name for o in outs]},
                     {"axis": dim, "num": num, "sections": sections})
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(sum(x^2) over `axis`), built from square, reduce_sum,
    sqrt and elementwise_div (axis 0) as the JAX package builds it;
    `epsilon` is accepted and not used, as there."""
    from . import ops as _ops

    LayerHelper("l2_normalize", name=name)      # counts the name
    ssum = reduce_sum(_ops.square(x), dim=axis, keep_dim=True)
    helper = LayerHelper("l2_normalize")
    norm = helper.create_tmp_variable(x.dtype)
    helper.append_op("sqrt", {"X": [ssum.name]}, {"Out": [norm.name]})
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("elementwise_div", {"X": [x.name], "Y": [norm.name]},
                     {"Out": [out.name]}, {"axis": 0})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op("one_hot", {"X": [input.name]}, {"Out": [out.name]},
                     {"depth": depth, "dtype": "float32"})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter, `begin - step` at startup and
    incremented by `step` at every run of the main program."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.main_program.global_block().create_var(
        name=name, dtype="int64", shape=(1,), persistable=True,
        stop_gradient=True)
    sb = helper.startup_program.global_block()
    if name not in sb.vars:
        sb.create_var(name=name, dtype="int64", shape=(1,),
                      persistable=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": [1], "dtype": "int64",
                      "value": float(begin - step)})
    helper.append_op("increment", {"X": [name]}, {"Out": [name]},
                     {"step": float(step)})
    counter.stop_gradient = True
    return counter


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1")
    diff = helper.create_tmp_variable(x.dtype)
    out = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op("smooth_l1_loss", inputs,
                     {"Diff": [diff.name], "Out": [out.name]},
                     {"sigma": sigma or 1.0})
    return out


def multiplex(inputs, index):
    """Row i from inputs[index[i]]."""
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(inputs[0].dtype)
    helper.append_op("multiplex",
                     {"Ids": [index.name], "X": [v.name for v in inputs]},
                     {"Out": [out.name]}, {})
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None):
    """Levenshtein distance between hypothesis and reference sequences
    (reference layers edit_distance / edit_distance_op.cc)."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        erased = helper.create_tmp_variable("int64")
        helper.append_op("sequence_erase", {"X": [input.name]},
                         {"Out": [erased.name]},
                         {"tokens": list(ignored_tokens)})
        input = erased
        erased_l = helper.create_tmp_variable("int64")
        helper.append_op("sequence_erase", {"X": [label.name]},
                         {"Out": [erased_l.name]},
                         {"tokens": list(ignored_tokens)})
        label = erased_l
    out = helper.create_tmp_variable("float32", stop_gradient=True)
    seq_num = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(
        "edit_distance",
        {"Hyps": [input.name], "Refs": [label.name]},
        {"Out": [out.name], "SequenceNum": [seq_num.name]},
        {"normalized": bool(normalized)})
    return out, seq_num



def warpctc(input, label, blank=0, norm_by_times=False):
    """The CTC loss [num_seqs, 1] of LoD logits against LoD labels
    (reference layers/nn.py warpctc; computed natively, ops/ctc.py)."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable("float32")
    grad = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        "warpctc",
        {"Logits": [input.name], "Label": [label.name]},
        {"Loss": [loss.name], "WarpCTCGrad": [grad.name]},
        {"blank": int(blank), "norm_by_times": bool(norm_by_times)})
    return loss


def ctc_align(input, blank=0, merge_repeated=True):
    """Greedy CTC decode's collapse (reference ctc_align_op.cc)."""
    helper = LayerHelper("ctc_align")
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    out.lod_level = 1
    helper.append_op("ctc_align", {"Input": [input.name]},
                     {"Output": [out.name]},
                     {"blank": int(blank),
                      "merge_repeated": bool(merge_repeated)})
    return out


def ctc_greedy_decoder(input, blank, name=None):
    """Each step's argmax, then the CTC collapse (reference layers/nn.py
    ctc_greedy_decoder: top_k with k 1, then ctc_align)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    _, ids = topk(input, k=1)
    out = helper.create_tmp_variable("int64")
    out.lod_level = 1
    helper.append_op(
        "ctc_align", {"Input": [ids.name]}, {"Output": [out.name]},
        {"blank": blank, "merge_repeated": True})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    """The noise-contrastive estimation loss [batch, 1] (reference
    layers/nn.py nce); `bias_attr=False` makes no bias."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr)
    dim = int(input.shape[1])
    w = helper.create_parameter(helper.param_attr,
                                [num_total_classes, dim], input.dtype,
                                suffix="w")
    b = None
    if bias_attr is not False:
        ba = {} if bias_attr in (None, True) else dict(bias_attr)
        b = helper.create_parameter(ba, [num_total_classes], input.dtype,
                                    is_bias=True, suffix="b")
    if num_neg_samples is None:
        num_neg_samples = 10
    cost = helper.create_tmp_variable(input.dtype)
    sample_logits = helper.create_tmp_variable(input.dtype,
                                               stop_gradient=True)
    sample_labels = helper.create_tmp_variable("int64", stop_gradient=True)
    inputs = {"Input": [input.name], "Label": [label.name],
              "Weight": [w.name]}
    if b is not None:
        inputs["Bias"] = [b.name]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    helper.append_op(
        "nce", inputs,
        {"Cost": [cost.name], "SampleLogits": [sample_logits.name],
         "SampleLabels": [sample_labels.name]},
        {"num_total_classes": int(num_total_classes),
         "num_neg_samples": int(num_neg_samples)})
    cost.shape = (-1, 1)
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None):
    """The hierarchical sigmoid cost [batch, 1] (reference
    gserver/layers/HierarchicalSigmoidLayer.cpp); `bias_attr=False`
    makes no bias."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr)
    dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr, [num_classes - 1, dim],
                                input.dtype, suffix="w")
    b = None
    if bias_attr is not False:
        ba = {} if bias_attr in (None, True) else dict(bias_attr)
        b = helper.create_parameter(ba, [num_classes - 1], input.dtype,
                                    is_bias=True, suffix="b")
    out = helper.create_tmp_variable(input.dtype)
    pre_out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    inputs = {"X": [input.name], "Label": [label.name], "W": [w.name]}
    if b is not None:
        inputs["Bias"] = [b.name]
    helper.append_op("hsigmoid", inputs,
                     {"Out": [out.name], "PreOut": [pre_out.name]},
                     {"num_classes": int(num_classes)})
    out.shape = (-1, 1)
    return out

def linear_chain_crf(input, label, param_attr=None):
    """The CRF negative log-likelihood [S, 1] over a LoD emission
    sequence (reference layers/nn.py linear_chain_crf,
    linear_chain_crf_op.cc).  The transition parameter is [D+2, D]: the
    start and end rows first."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(param_attr, [size + 2, size],
                                         input.dtype, suffix="transition")
    alpha = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    em_exps = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    tr_exps = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    log_likelihood = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "linear_chain_crf",
        {"Emission": [input.name], "Transition": [transition.name],
         "Label": [label.name]},
        {"Alpha": [alpha.name], "EmissionExps": [em_exps.name],
         "TransitionExps": [tr_exps.name],
         "LogLikelihood": [log_likelihood.name]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with the transition parameter linear_chain_crf
    learned, found by the name in `param_attr`."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    name = (param_attr or {}).get("name")
    block = helper.main_program.global_block()
    if name and name in block.vars:
        transition = block.vars[name]
    else:
        size = input.shape[-1]
        transition = helper.create_parameter(param_attr, [size + 2, size],
                                             input.dtype,
                                             suffix="transition")
    path = helper.create_tmp_variable("int64", stop_gradient=True)
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    helper.append_op("crf_decoding", inputs, {"ViterbiPath": [path.name]})
    return path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """-> (precision, recall, f1, n_infer, n_label, n_correct) of the
    chunks in `input` against `label` (reference chunk_eval_op.cc)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_tmp_variable("float32", stop_gradient=True)
    recall = helper.create_tmp_variable("float32", stop_gradient=True)
    f1 = helper.create_tmp_variable("float32", stop_gradient=True)
    n_infer = helper.create_tmp_variable("int64", stop_gradient=True)
    n_label = helper.create_tmp_variable("int64", stop_gradient=True)
    n_correct = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op(
        "chunk_eval",
        {"Inference": [input.name], "Label": [label.name]},
        {"Precision": [precision.name], "Recall": [recall.name],
         "F1-Score": [f1.name], "NumInferChunks": [n_infer.name],
         "NumLabelChunks": [n_label.name],
         "NumCorrectChunks": [n_correct.name]},
        {"chunk_scheme": chunk_scheme, "num_chunk_types": num_chunk_types,
         "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, n_infer, n_label, n_correct

# ---------------------------------------------------------------------------
# sequence / recurrent layers (the reference's layers/nn.py dynamic_lstm,
# dynamic_gru, sequence_conv, sequence_pool, sequence_expand, ...)
# ---------------------------------------------------------------------------


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """`input` must be a LoD var of width 4*hidden (typically an fc output);
    `size` is 4*hidden to match the reference API."""
    helper = LayerHelper("lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    weight = helper.create_parameter(param_attr, [hidden, 4 * hidden],
                                     dtype, suffix="w")
    bias_size = 7 * hidden if use_peepholes else 4 * hidden
    bias = helper.create_parameter(bias_attr or {}, [1, bias_size], dtype,
                                   is_bias=True, suffix="b")
    h = helper.create_tmp_variable(dtype)
    c = helper.create_tmp_variable(dtype)
    bg = helper.create_tmp_variable(dtype, stop_gradient=True)
    bc = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(
        "lstm",
        {"Input": [input.name], "Weight": [weight.name],
         "Bias": [bias.name]},
        {"Hidden": [h.name], "Cell": [c.name], "BatchGate": [bg.name],
         "BatchCellPreAct": [bc.name]},
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation})
    for v in (h, c):
        v.shape = (-1, hidden)
        v.lod_level = input.lod_level
    return h, c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """`input` width must be 3*size."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(param_attr, [size, 3 * size], dtype,
                                     suffix="w")
    bias = helper.create_parameter(bias_attr or {}, [1, 3 * size], dtype,
                                   is_bias=True, suffix="b")
    h = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    bg = helper.create_tmp_variable(dtype, stop_gradient=True)
    br = helper.create_tmp_variable(dtype, stop_gradient=True)
    bh = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(
        "gru", inputs,
        {"Hidden": [h.name], "BatchGate": [bg.name],
         "BatchResetHiddenPrev": [br.name], "BatchHidden": [bh.name]},
        {"is_reverse": is_reverse, "gate_activation": gate_activation,
         "activation": candidate_activation})
    h.shape = (-1, size)
    h.lod_level = input.lod_level
    return h


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    w = helper.create_parameter(param_attr, filter_shape, dtype, suffix="w")
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        "sequence_conv",
        {"X": [input.name], "Filter": [w.name]},
        {"Out": [pre_bias.name]},
        {"contextStride": filter_stride,
         "contextStart": -int(filter_size // 2),
         "contextLength": filter_size})
    pre_bias.shape = (-1, num_filters)
    pre_bias.lod_level = input.lod_level
    pre_act = helper.append_bias_op(pre_bias)
    out = helper.append_activation(pre_act)
    out.lod_level = input.lod_level
    return out


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("sequence_pool", {"X": [input.name]},
                     {"Out": [out.name], "MaxIndex": [max_index.name]},
                     {"pooltype": pool_type.upper()})
    out.shape = (-1,) + tuple(input.shape[1:])
    out.lod_level = max(0, input.lod_level - 1)
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input):
    helper = LayerHelper("sequence_softmax")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_softmax", {"X": [input.name]},
                     {"Out": [out.name]})
    out.shape = input.shape
    out.lod_level = input.lod_level
    return out


def sequence_expand(x, y, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("sequence_expand", {"X": [x.name], "Y": [y.name]},
                     {"Out": [out.name]})
    out.shape = x.shape
    out.lod_level = max(x.lod_level, 1)
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("sequence_reshape", {"X": [input.name]},
                     {"Out": [out.name]}, {"new_dim": new_dim})
    out.shape = (-1, new_dim)
    out.lod_level = input.lod_level
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset")
    out = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x.name]}
    if y is not None:
        inputs["Y"] = [y.name]
    helper.append_op("lod_reset", inputs, {"Out": [out.name]},
                     {"target_lod": target_lod or []})
    out.shape = x.shape
    out.lod_level = max(1, x.lod_level)
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0):
    helper = LayerHelper("im2sequence")
    fs = [filter_size] * 2 if isinstance(filter_size, int) else filter_size
    st = [stride] * 2 if isinstance(stride, int) else stride
    pd = [padding] * 4 if isinstance(padding, int) else padding
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("im2sequence", {"X": [input.name]},
                     {"Out": [out.name]},
                     {"kernels": list(fs), "strides": list(st),
                      "paddings": list(pd)})
    out.lod_level = 1
    return out


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with recurrent projection (reference layers/nn.py:400
    dynamic_lstmp / lstmp_op.cc).  `input` is a LoD var of width 4*hidden;
    `size` = 4*hidden, `proj_size` = projection width."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    weight = helper.create_parameter(param_attr, [proj_size, 4 * hidden],
                                     dtype, suffix="w")
    proj_weight = helper.create_parameter(param_attr,
                                          [hidden, proj_size], dtype,
                                          suffix="proj_w")
    bias_size = 7 * hidden if use_peepholes else 4 * hidden
    bias = helper.create_parameter(bias_attr or {}, [1, bias_size], dtype,
                                   is_bias=True, suffix="b")
    proj = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    bg = helper.create_tmp_variable(dtype, stop_gradient=True)
    bh = helper.create_tmp_variable(dtype, stop_gradient=True)
    bc = helper.create_tmp_variable(dtype, stop_gradient=True)
    helper.append_op(
        "lstmp",
        {"Input": [input.name], "Weight": [weight.name],
         "ProjWeight": [proj_weight.name], "Bias": [bias.name]},
        {"Projection": [proj.name], "Cell": [cell.name],
         "BatchGate": [bg.name], "BatchHidden": [bh.name],
         "BatchCellPreAct": [bc.name]},
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation,
         "proj_activation": proj_activation})
    return proj, cell


def gru_unit(input, hidden, size, weight=None, bias=None, param_attr=None,
             bias_attr=None, activation="tanh",
             gate_activation="sigmoid"):
    """Single GRU step (reference layers/nn.py:693 / gru_unit_op.cc);
    `input` is the projected gate input of width `size` (= 3*hidden)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    h = size // 3
    if weight is None:
        weight = helper.create_parameter(param_attr, [h, 3 * h], dtype,
                                         suffix="w")
    if bias is None:
        bias = helper.create_parameter(bias_attr or {}, [1, 3 * h], dtype,
                                       is_bias=True, suffix="b")
    gate = helper.create_tmp_variable(dtype)
    reset_hidden_pre = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype)
    helper.append_op(
        "gru_unit",
        {"Input": [input.name], "HiddenPrev": [hidden.name],
         "Weight": [weight.name], "Bias": [bias.name]},
        {"Gate": [gate.name], "ResetHiddenPrev": [reset_hidden_pre.name],
         "Hidden": [updated_hidden.name]},
        {"activation": activation, "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step (reference layers/nn.py:1942 / lstm_unit_op.cc):
    gates = fc([x_t, h_prev]); returns (h, c)."""
    helper = LayerHelper("lstm_unit", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    from .tensor import concat
    dtype = x_t.dtype
    size = hidden_t_prev.shape[-1]
    concat_out = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(input=concat_out, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    c = helper.create_tmp_variable(dtype)
    h = helper.create_tmp_variable(dtype)
    helper.append_op(
        "lstm_unit",
        {"X": [fc_out.name], "C_prev": [cell_t_prev.name]},
        {"C": [c.name], "H": [h.name]},
        {"forget_bias": float(forget_bias)})
    return h, c
