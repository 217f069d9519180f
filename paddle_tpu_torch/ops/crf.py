"""Linear-chain CRF ops: linear_chain_crf, crf_decoding, chunk_eval
(counterpart of paddle_tpu/ops/crf.py).

Reference: PaddlePaddle's operators/linear_chain_crf_op.{cc,h} (the
forward alpha recursion), crf_decoding_op.{cc,h} (Viterbi) and
chunk_eval_op.{cc,h} (segment extraction, precision, recall and F1).

The JAX package pads each batch's sequences to [S, T, D] with a static
gather built from the LoD and runs the recursions as `lax.scan` over the
time axis.  Here the same steps are a plain PyTorch loop over the padded
time axis, as ops/rnn.py runs the LSTM: the padded gather, the repack
and the mask are ops/sequence.py's host-built tables in `ctx.tables`, so
a CUDA-graph capture reads them without a host-to-device copy.  The
gradient of linear_chain_crf is autograd's through the loop (the generic
gradient, as the JAX package's is `jax.vjp` of its scan).  The gold
path's scores are contractions with the labels' one-hot rows, not
indexed gathers, so their backward is a product and a sum with no
atomic scatter: the card gives the same bits on every call.

Transition layout, as the reference's (linear_chain_crf_op.h): row 0
the start weights, row 1 the end weights, rows 2..D+1 the [D, D]
transition matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.execution import data_of, one
from ..core.lod import LoDTensor
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape
from .sequence import gather_rows, padded_rows, repack_rows


def _padded(ctx, ev):
    """-> (the emission as [S, T, D], its rows' plan, the mask [S, T] in
    the emission's dtype, the repack plan [S*T] -> packed rows, S, T)."""
    if not (isinstance(ev, LoDTensor) and ev.lod):
        raise ValueError("linear_chain_crf and crf_decoding require a LoD "
                         "emission input")
    lod = ev.lod[0]
    x = ev.data
    rows, mask, t = padded_rows(ctx, lod, x.device)
    s = mask.shape[0]
    em = gather_rows(x, rows).reshape(s, t, x.shape[-1])
    return em, rows, mask.to(x.dtype), repack_rows(ctx, lod, t, x.device), \
        s, t


def _labels(label, rows, s, t):
    """The [N] or [N, 1] int labels gathered to [S, T] (pads read row
    0; every use masks them)."""
    lab = data_of(label)
    if lab.dim() == 2:
        lab = lab[:, 0]
    return lab.to(torch.int64).index_select(0, rows.idx).reshape(s, t)


def _one_hot(lab, d, dtype):
    """[..., D] rows of 0 and 1 (no device-side range check, which
    would wait for the card)."""
    return (lab[..., None] == torch.arange(d, device=lab.device)).to(dtype)


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


@register_op("linear_chain_crf", inputs=("Emission", "Transition", "Label"),
             outputs=("Alpha", "EmissionExps", "TransitionExps",
                      "LogLikelihood"),
             diff_inputs=("Emission", "Transition"),
             diff_outputs=("LogLikelihood",), lod=True)
def linear_chain_crf(ctx, ins, attrs):
    """The negative log-likelihood [S, 1] of each sequence's label path:
    log Z (the alpha recursion's logsumexp) minus the gold path's score
    (start + emissions + transitions + end).  Alpha is each step's alpha
    at the packed rows; EmissionExps the row softmax of the emission;
    TransitionExps exp(transition), as the JAX package outputs them."""
    ev = one(ins, "Emission")
    emission = ev.data
    transition = data_of(one(ins, "Transition"))
    em, rows, mask, repack, s, t = _padded(ctx, ev)
    d = emission.shape[-1]
    start, end, trans = _split_transition(transition)
    lab = _labels(one(ins, "Label"), rows, s, t)

    # the partition function: alpha over time, frozen past each length
    alpha = start[None, :] + em[:, 0, :]
    alphas = [alpha]
    for step in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + em[:, step, :]
        alpha = torch.where(mask[:, step, None] > 0, nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)

    # the gold path's score
    oh = _one_hot(lab, d, emission.dtype)                 # [S, T, D]
    em_score = torch.sum(torch.sum(em * oh, dim=2) * mask, dim=1)
    if t > 1:
        # sum over t >= 1 of trans[lab[t-1], lab[t]], masked
        prev = oh[:, :-1, :] * mask[:, 1:, None]
        tr_score = torch.sum(torch.matmul(prev, trans) * oh[:, 1:, :],
                             dim=(1, 2))
    else:
        tr_score = torch.zeros((s,), dtype=emission.dtype,
                               device=emission.device)
    lens = mask.sum(dim=1).to(torch.int64)
    last = torch.gather(lab, 1, (lens - 1)[:, None])[:, 0]
    score = (em_score + tr_score + torch.matmul(oh[:, 0, :], start)
             + torch.matmul(_one_hot(last, d, emission.dtype), end))
    nll = (log_z - score)[:, None]

    all_alphas = torch.stack(alphas, dim=1).reshape(s * t, d)
    return {
        "Alpha": LoDTensor(gather_rows(all_alphas, repack), ev.lod),
        "EmissionExps": LoDTensor(torch.softmax(emission, dim=-1), ev.lod),
        "TransitionExps": torch.exp(transition),
        "LogLikelihood": nll,
    }


@register_op("crf_decoding", inputs=("Emission", "Transition", "Label"),
             outputs=("ViterbiPath",), not_differentiable=True, lod=True)
def crf_decoding(ctx, ins, attrs):
    """Viterbi decode: a forward loop keeping each step's argmax
    pointers, then a backtrack loop.  Without Label, each row's best tag
    id; with Label, 1 where the decoded tag equals the label, else 0
    (crf_decoding_op.cc).  int64 [N, 1] with the emission's LoD.  Ties
    go to the first maximal index, as `jnp.argmax`'s."""
    ev = one(ins, "Emission")
    emission = ev.data
    transition = data_of(one(ins, "Transition"))
    em, _, mask, repack, s, t = _padded(ctx, ev)
    start, end, trans = _split_transition(transition)

    alpha = start[None, :] + em[:, 0, :]
    ptrs = []
    for step in range(1, t):
        scores = alpha[:, :, None] + trans[None, :, :]   # [S, D, D]
        best = torch.amax(scores, dim=1) + em[:, step, :]
        ptrs.append(torch.argmax(scores, dim=1))         # [S, D]
        alpha = torch.where(mask[:, step, None] > 0, best, alpha)
    # padding froze alpha: it is each sequence's alpha at its last row
    tag = torch.argmax(alpha + end[None, :], dim=1)      # [S]
    tags = [tag]
    for step in range(t - 1, 0, -1):
        prev = torch.gather(ptrs[step - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(mask[:, step] > 0, prev, tag)
        tags.append(tag)
    padded = torch.stack(tags[::-1], dim=1).reshape(s * t, 1)
    path = gather_rows(padded, repack)
    label = one(ins, "Label")
    if label is not None:
        lab = data_of(label)
        if lab.dim() == 2:
            lab = lab[:, 0]
        path = (path[:, 0] == lab.to(torch.int64)).to(torch.int64)[:, None]
    return {"ViterbiPath": LoDTensor(path, ev.lod)}


# ---------------------------------------------------------------------------
# chunk_eval (a host metric op: chunk_eval_op.h GetSegments)
# ---------------------------------------------------------------------------

# (num_tag_types, tag_begin, tag_inside, tag_end, tag_single) per scheme:
# chunk_eval_op.h Compute's scheme table
_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_end(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    """chunk_eval_op.h ChunkEnd."""
    if prev_type == other:
        return False
    if type_ == other:
        return True
    if type_ != prev_type:
        return True
    if prev_tag == tb:
        return tag in (tb, ts)
    if prev_tag == ti:
        return tag in (tb, ts)
    if prev_tag in (te, ts):
        return True
    return False


def _chunk_begin(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    """chunk_eval_op.h ChunkBegin."""
    if prev_type == other:
        return type_ != other
    if type_ == other:
        return False
    if type_ != prev_type:
        return True
    if tag == tb:
        return True
    if tag in (ti, te):
        return prev_tag in (te, ts)
    if tag == ts:
        return True
    return False


def _extract_chunks(tags, scheme, num_chunk_types, excluded):
    """-> the set of (begin, end inclusive, type) chunks of one sequence
    (chunk_eval_op.h GetSegments)."""
    n_tag, tb, ti, te, ts = _SCHEMES[scheme]
    other = num_chunk_types
    chunks = []
    in_chunk = False
    chunk_start = 0
    tag, type_ = -1, other
    for i, t in enumerate(tags):
        prev_tag, prev_type = tag, type_
        t = int(t)
        tag = t % n_tag
        type_ = t // n_tag
        if in_chunk and _chunk_end(prev_tag, prev_type, tag, type_, other,
                                   tb, ti, te, ts):
            chunks.append((chunk_start, i - 1, prev_type))
            in_chunk = False
        if _chunk_begin(prev_tag, prev_type, tag, type_, other,
                        tb, ti, te, ts):
            chunk_start = i
            in_chunk = True
    if in_chunk:
        chunks.append((chunk_start, len(tags) - 1, type_))
    return {c for c in chunks if c[2] not in excluded}


@register_op("chunk_eval", inputs=("Inference", "Label"),
             outputs=("Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"),
             attrs={"chunk_scheme": "IOB", "num_chunk_types": 1,
                    "excluded_chunk_types": []},
             not_differentiable=True, host=True, lod=True)
def chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 over each sequence of the first
    LoD level (a value with no LoD is one sequence), on the host:
    float32 scalars, and the chunk counts as int64 scalars, on the
    inputs' device."""
    inf_v, lab_v = one(ins, "Inference"), one(ins, "Label")
    inf = data_of(inf_v).detach().cpu().numpy().reshape(-1)
    lab = data_of(lab_v).detach().cpu().numpy().reshape(-1)
    offs = inf_v.lod[0] if isinstance(inf_v, LoDTensor) and inf_v.lod \
        else (0, len(inf))
    scheme = attrs["chunk_scheme"]
    n_types = int(attrs["num_chunk_types"])
    excluded = set(attrs.get("excluded_chunk_types") or [])
    n_inf = n_lab = n_cor = 0
    for s in range(len(offs) - 1):
        lo, hi = offs[s], offs[s + 1]
        ci = _extract_chunks(inf[lo:hi], scheme, n_types, excluded)
        cl = _extract_chunks(lab[lo:hi], scheme, n_types, excluded)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = data_of(inf_v).device
    out = {"Precision": np.float32(p), "Recall": np.float32(r),
           "F1-Score": np.float32(f1), "NumInferChunks": np.int64(n_inf),
           "NumLabelChunks": np.int64(n_lab),
           "NumCorrectChunks": np.int64(n_cor)}
    return {k: torch.tensor(v, device=dev) for k, v in out.items()}


# -- build-time shape inference (LoD-dependent) -------------------------------

@register_infer_shape("linear_chain_crf")
def _infer_linear_chain_crf(op, block):
    e = input_var(op, block, "Emission")
    t = input_var(op, block, "Transition")
    if e is None or e.shape is None:
        return
    set_output_shape(op, block, "Alpha", e.shape, e.dtype)
    set_output_shape(op, block, "EmissionExps", e.shape, e.dtype)
    if t is not None and t.shape is not None:
        set_output_shape(op, block, "TransitionExps", t.shape, e.dtype)
    # one log-likelihood row a sequence (their count is in the LoD)
    set_output_shape(op, block, "LogLikelihood", (-1, 1), e.dtype)


@register_infer_shape("crf_decoding")
def _infer_crf_decoding(op, block):
    e = input_var(op, block, "Emission")
    if e is None or e.shape is None:
        return
    set_output_shape(op, block, "ViterbiPath", (e.shape[0], 1), "int64")
