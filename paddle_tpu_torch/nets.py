"""Composed network patterns (counterpart of paddle_tpu/nets.py): the
image helpers simple_img_conv_pool and img_conv_group, and multi-head
scaled dot-product attention."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group",
           "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max"):
    """conv2d (+ act) then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """A stack of convs (each optionally batch-normed, the act then after
    the batch norm, and dropped out) then one pool2d; the per-conv
    arguments take a scalar or one value a conv."""
    n = len(conv_num_filter)

    def per_conv(v, kind):
        return [v] * n if isinstance(v, kind) else list(v)

    conv_padding = per_conv(conv_padding, int)
    conv_filter_size = per_conv(conv_filter_size, int)
    conv_with_batchnorm = per_conv(conv_with_batchnorm, bool)
    conv_batchnorm_drop_rate = per_conv(conv_batchnorm_drop_rate,
                                        (float, int))
    tmp = input
    for i, nf in enumerate(conv_num_filter):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr, act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def scaled_dot_product_attention(queries, keys, values,
                                 num_heads=1, dropout_rate=0.0,
                                 causal=False, is_test=False):
    """Multi-head attention on [batch, seq, dim] tensors through the
    `flash_attention` op.  `causal=True` masks future positions.

    Attention-weight dropout in training needs the composed
    matmul/softmax/dropout chain of the JAX package, whose `matmul` op
    is not ported yet; asking for it raises."""
    d_model = int(queries.shape[-1])
    if num_heads < 1:
        raise ValueError("num_heads must be >= 1")
    if d_model % num_heads:
        raise ValueError(
            f"hidden size {d_model} not divisible by num_heads {num_heads}")
    if dropout_rate and not is_test:
        raise NotImplementedError(
            "attention-weight dropout in training is not ported yet")
    d_head = d_model // num_heads

    def split_heads(x):
        # [b, s, d] -> [b, s, h, d/h]
        return layers.reshape(x, shape=[0, 0, num_heads, d_head])

    out = layers.flash_attention(split_heads(queries), split_heads(keys),
                                 split_heads(values), causal=causal)
    return layers.reshape(out, shape=[0, 0, d_model])
