"""The MoE transformer LM of benchmark/run_moe.py, as a Fluid Program.

Counterpart of `build_moe_lm` and `active_param_count` in the JAX
package's benchmark/run_moe.py: pre-LN causal attention blocks whose
dense FFN is a `moe_ffn` layer (top-1 or top-2 gating, static
capacity), the layers' aux losses averaged and added to the LM loss at
`aux_weight`, trained with Momentum.  It builds the same Program as the
JAX builder, op for op and name for name.
"""
from __future__ import annotations

from .. import layers, nets
from ..core.framework import Program, program_guard
from ..initializer import NormalInitializer
from ..optimizer import Momentum
from .transformer import _pre_ln, _proj

__all__ = ["build_moe_lm", "active_param_count"]


def build_moe_lm(batch, seq, vocab, d_model, n_heads, n_layers, experts,
                 top_k, capacity_factor, aux_weight=0.01):
    """-> (main, startup, loss): the training Program (Momentum, lr
    0.01, mu 0.9) over `ids` [batch, seq] and next-token `lbl`
    [batch, seq, 1] feeds.  `batch` is the feed's batch size; the
    Program itself takes any."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        ids = layers.data(name="ids", shape=[seq], dtype="int64")
        lbl = layers.data(name="lbl", shape=[seq, 1], dtype="int64")
        emb = layers.embedding(
            ids, size=[vocab, d_model],
            param_attr={"initializer": NormalInitializer(0.0, 0.02)})
        pos = layers.create_parameter(
            shape=[seq, d_model], dtype=emb.dtype,
            default_initializer=NormalInitializer(0.0, 0.02))
        x = layers.elementwise_add(emb, pos, axis=1)
        aux_total = None
        for _ in range(n_layers):
            ln_x = _pre_ln(x)
            q = _proj(ln_x, d_model)
            k = _proj(ln_x, d_model)
            v = _proj(ln_x, d_model)
            att = nets.scaled_dot_product_attention(
                q, k, v, num_heads=n_heads, causal=True)
            x = layers.elementwise_add(x, _proj(att, d_model))
            f, aux = layers.moe_ffn(
                _pre_ln(x), num_experts=experts, top_k=top_k,
                capacity_factor=capacity_factor)
            x = layers.elementwise_add(x, f)
            aux_total = (aux if aux_total is None
                         else layers.elementwise_add(aux_total, aux))
        x = _pre_ln(x)
        logits = layers.fc(input=x, size=vocab, num_flatten_dims=2)
        cost = layers.softmax_with_cross_entropy(
            layers.reshape(logits, shape=[-1, vocab]),
            layers.reshape(lbl, shape=[-1, 1]))
        avg = layers.mean(cost)
        aux_mean = layers.scale(aux_total, scale=aux_weight / n_layers)
        loss = layers.elementwise_add(avg, aux_mean)
        Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, loss


def active_param_count(vocab, d_model, n_layers, experts, top_k, seq):
    """Active params per token: 4 attention projections + top_k experts'
    FFN pair (d x 4d twice) + router, + embeddings/classifier."""
    d_inner = 4 * d_model
    per_block = (4 * d_model * d_model
                 + top_k * 2 * d_model * d_inner
                 + d_model * experts)
    return (n_layers * per_block + 2 * vocab * d_model + seq * d_model)
