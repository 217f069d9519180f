"""Composed network patterns (counterpart of paddle_tpu/nets.py):
multi-head scaled dot-product attention."""
from __future__ import annotations

from . import layers

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(queries, keys, values,
                                 num_heads=1, dropout_rate=0.0,
                                 causal=False, is_test=False):
    """Multi-head attention on [batch, seq, dim] tensors through the
    `flash_attention` op.  `causal=True` masks future positions.

    Attention-weight dropout in training needs the composed
    matmul/softmax/dropout chain of the JAX package, whose dropout and
    matmul ops are not ported yet; asking for it raises."""
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
