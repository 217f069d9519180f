"""CTR model family: wide&deep and DeepFM (counterpart of
paddle_tpu/models/ctr.py).

Many categorical slots, one embedding table per slot, built with
`embedding(is_sparse=True)` by default: each table's gradient is a
SelectedRows of the rows a batch touched (core/lod.py), which the
optimizer updates take.  Every categorical slot takes [batch, 1] int64
ids; `dense_input` is [batch, dense_dim] float.
"""
from __future__ import annotations

from .. import layers

__all__ = ["wide_deep", "deepfm"]


def _slot_embeddings(sparse_inputs, vocab_sizes, dim, is_sparse):
    if len(sparse_inputs) != len(vocab_sizes):
        raise ValueError(
            f"{len(sparse_inputs)} sparse slots but "
            f"{len(vocab_sizes)} vocab sizes")
    return [
        layers.embedding(ids, size=[int(v), dim], is_sparse=is_sparse)
        for ids, v in zip(sparse_inputs, vocab_sizes)
    ]


def _wide_part(dense_input, sparse_inputs, vocab_sizes, is_sparse):
    """Linear model: per-category scalar weights + linear dense term."""
    terms = _slot_embeddings(sparse_inputs, vocab_sizes, 1, is_sparse)
    if dense_input is not None:
        terms.append(layers.fc(input=dense_input, size=1, bias_attr=False))
    return layers.sums([layers.reshape(t, shape=[-1, 1]) for t in terms])


def _deep_part(dense_input, embs, hidden_sizes):
    feats = [layers.reshape(e, shape=[0, -1]) for e in embs]
    if dense_input is not None:
        feats.append(dense_input)
    x = layers.concat(feats, axis=1) if len(feats) > 1 else feats[0]
    for h in hidden_sizes:
        x = layers.fc(input=x, size=h, act="relu")
    return layers.fc(input=x, size=1)


def wide_deep(sparse_inputs, vocab_sizes, dense_input=None, embed_dim=8,
              hidden_sizes=(64, 32), is_sparse=True):
    """Wide&Deep CTR model -> (prob, logit), both [batch, 1]."""
    wide = _wide_part(dense_input, sparse_inputs, vocab_sizes, is_sparse)
    embs = _slot_embeddings(sparse_inputs, vocab_sizes, embed_dim,
                            is_sparse)
    deep = _deep_part(dense_input, embs, hidden_sizes)
    logit = layers.elementwise_add(wide, deep)
    return layers.sigmoid(logit), logit


def deepfm(sparse_inputs, vocab_sizes, dense_input=None, embed_dim=8,
           hidden_sizes=(64, 32), is_sparse=True):
    """DeepFM -> (prob, logit): wide (1st order) + FM (2nd order pairwise
    interactions, O(fields*dim)) + deep tower, sharing one set of slot
    embeddings between FM and deep."""
    first = _wide_part(dense_input, sparse_inputs, vocab_sizes, is_sparse)
    embs = _slot_embeddings(sparse_inputs, vocab_sizes, embed_dim,
                            is_sparse)
    flat = [layers.reshape(e, shape=[-1, embed_dim]) for e in embs]
    # FM: 0.5 * sum_k[(sum_i e_ik)^2 - sum_i e_ik^2]
    sum_e = layers.sums(flat)
    sum_sq = layers.square(sum_e)
    sq_sum = layers.sums([layers.square(e) for e in flat])
    fm = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=1,
                          keep_dim=True), scale=0.5)
    deep = _deep_part(dense_input, embs, hidden_sizes)
    logit = layers.sums([first, fm, deep])
    return layers.sigmoid(logit), logit
