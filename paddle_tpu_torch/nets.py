"""Composed network patterns (counterpart of paddle_tpu/nets.py): the
image helpers simple_img_conv_pool and img_conv_group, multi-head
scaled dot-product attention, and sequence_conv_pool."""
from __future__ import annotations

import math

import numpy as np

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


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


def glu(input, dim=-1):
    """Gated linear unit: split in two along `dim`, the second half a
    sigmoid gate on the first."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    gate = layers.sigmoid(b)
    return layers.elementwise_mul(a, gate)


def scaled_dot_product_attention(queries, keys, values,
                                 num_heads=1, dropout_rate=0.0,
                                 causal=False, is_test=False):
    """Multi-head attention on [batch, seq, dim] tensors.  `causal=True`
    masks future positions.  Without attention-weight dropout (or at
    test, where dropout is a scale) it is the `flash_attention` op;
    training with dropout takes the composed path of the JAX package:
    transpose -> scale -> matmul -> (+ causal mask) -> softmax ->
    dropout -> matmul -> transpose, the [b, h, s, s] weights
    materialised so the dropout can draw over them."""
    d_model = int(queries.shape[-1])
    if num_heads < 1:
        raise ValueError("num_heads must be >= 1")
    if d_model % num_heads:
        raise ValueError(
            f"hidden size {d_model} not divisible by num_heads {num_heads}")
    d_head = d_model // num_heads

    def split_heads(x):
        # [b, s, d] -> [b, s, h, d/h]
        return layers.reshape(x, shape=[0, 0, num_heads, d_head])

    if not dropout_rate or is_test:
        out = layers.flash_attention(split_heads(queries), split_heads(keys),
                                     split_heads(values), causal=causal)
        return layers.reshape(out, shape=[0, 0, d_model])

    q = layers.transpose(split_heads(queries), axis=[0, 2, 1, 3])
    k = layers.transpose(split_heads(keys), axis=[0, 2, 1, 3])
    v = layers.transpose(split_heads(values), axis=[0, 2, 1, 3])
    scaled_q = layers.scale(q, scale=1.0 / math.sqrt(d_head))
    product = layers.matmul(scaled_q, k, transpose_y=True)  # [b, h, s, s]
    if causal:
        seq_q, seq_k = int(queries.shape[1]), int(keys.shape[1])
        mask = np.triu(np.full((seq_q, seq_k), -1e9, dtype=np.float32), k=1)
        product = layers.elementwise_add(product, layers.assign(mask),
                                         axis=2)
    weights = layers.softmax(product)
    weights = layers.dropout(weights, dropout_prob=dropout_rate,
                             is_test=is_test)
    ctx = layers.matmul(weights, v)                  # [b, h, s, d/h]
    ctx = layers.transpose(ctx, axis=[0, 2, 1, 3])   # [b, s, h, d/h]
    return layers.reshape(ctx, shape=[0, 0, d_model])


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
