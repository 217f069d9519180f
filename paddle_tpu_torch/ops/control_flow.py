"""Control-flow ops: while, conditional_block, the IfElse split/merge,
tensor arrays, LoD rank tables, beam search, parallel_do and the
recurrence over a step block, `dynamic_rnn` (counterpart of
paddle_tpu/ops/control_flow.py).

Reference: PaddlePaddle's operators/while_op.cc, conditional_block_op.cc,
split_lod_tensor_op.cc, merge_lod_tensor_op.cc,
tensor_array_read_write_op.cc, lod_rank_table_op.cc,
lod_tensor_to_array_op.cc, array_to_lod_tensor_op.cc,
shrink_rnn_memory_op.cc, max_sequence_len_op.cc,
reorder_lod_tensor_by_rank_op.cc, beam_search_op.cc,
beam_search_decode_op.h, parallel_do_op.cc and recurrent_op.cc; and
the rematerialised segment `recompute`, which has no reference
analogue.

The JAX package's design split stays:

  * **Training-time recurrence** is the `dynamic_rnn` op: the user's step
    sub-block runs once per time step over the padded [T, B, ...] view
    of the LoD step inputs, memories masked so a finished sequence keeps
    its last state, the outputs repacked to LoD rows in the original
    batch order.  Where the JAX package traces the step into one
    `lax.scan`, this is a Python loop over the time axis, as
    ops/rnn.py runs `lstm`; the padding and repacking index tables are
    built on the host into `ctx.tables` (ops/sequence.py), so a CUDA
    graph captures the whole loop with no host copy.  Its gradient is
    the generic one: autograd through the loop, for the step inputs,
    the initial memories, the static inputs and the captured parameters
    of the step block.  A `dynamic_rnn` whose block holds no host op is
    a device op, captured into the step's graph (one per LoD).
  * **Decode-time control flow** (`while`, tensor arrays, beam search)
    runs on the host, op by op: beam pruning changes shapes and LoD at
    every step.  Each of these ops is `host=True`, so the Executor runs
    it eagerly between its device segments; its values stay on the
    Executor's device, and what it decides (a condition, an index, the
    rows a mask selects, the beams) it reads back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.execution import DictEnv, data_of, many, one, run_op
from ..core.lod import LoDTensor, TensorArray, lod_from_seq_lens
from ..core.registry import register_infer_shape, register_op
from ..core.types import torch_dtype
from .sequence import gather_rows, padded_rows, repack_rows


def _host(v) -> np.ndarray:
    """A value's data on the host as a numpy array."""
    d = data_of(v)
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


def _scalar_int(v) -> int:
    return int(_host(v).reshape(-1)[0])


def _truthy(v) -> bool:
    return bool(_host(v).reshape(-1)[0])


def _rows(idx, device):
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _run_block(ctx, ops, env):
    """Run the ops of a sub-block against `env`, each in its own context
    derived from `ctx` (op, env and root set, as run_op sets them)."""
    for op in ops:
        run_op(ctx, op, env)


# ---------------------------------------------------------------------------
# while / conditional_block (host interpreters over sub-blocks)
# ---------------------------------------------------------------------------


@register_op("while", inputs=("Condition", "X"), outputs=("Out",),
             attrs={"max_iters": 100000},
             dup_inputs=("X",), dup_outputs=("Out",),
             not_differentiable=True, host=True)
def while_op(ctx, ins, attrs):
    """Run the sub-block until the condition var becomes false (the
    reference while_op.cc).  The body shares the surrounding env, so
    array writes and condition updates persist across iterations; each
    iteration draws its random numbers from the executing context's
    child keyed by the iteration index, as the JAX package's."""
    sub = ctx.op.sub_block()
    env = ctx.env
    cond_name = ctx.op.input("Condition")[0]
    it = 0
    while _truthy(env.get(cond_name)):
        if it >= attrs["max_iters"]:
            raise RuntimeError(
                f"while op exceeded max_iters={attrs['max_iters']}")
        _run_block(ctx.root.child(it), sub.ops, env)
        it += 1
    return {}


@register_op("conditional_block", inputs=("X", "Params"), outputs=("Out",),
             attrs={"is_scalar_condition": False},
             dup_inputs=("X", "Params"), dup_outputs=("Out",),
             not_differentiable=True, host=True)
def conditional_block(ctx, ins, attrs):
    """Run the sub-block iff the condition input is true (scalar
    condition) or every input is non-empty (the reference
    conditional_block_op.cc)."""
    xs = many(ins, "X")
    if attrs.get("is_scalar_condition"):
        go = _truthy(xs[0])
    else:
        go = all(data_of(x).numel() > 0 for x in xs)
    if go:
        _run_block(ctx.root, ctx.op.sub_block().ops, ctx.env)
    return {}


# ---------------------------------------------------------------------------
# split/merge by mask — the IfElse machinery.  Host ops: the mask is data,
# so the row counts are known only at run time.
# ---------------------------------------------------------------------------


def _mask_bools(mask) -> np.ndarray:
    return _host(mask).reshape(-1).astype(bool)


def _branch_rows(xv, m: np.ndarray, level: int):
    """-> (true_rows, false_rows, true_lens, false_lens); the lens are
    None for a dense input.  For a LoD input the mask entries select
    whole level-`level` sequences (split_lod_tensor_op.cc)."""
    if isinstance(xv, LoDTensor) and xv.lod:
        lod = xv.lod[level]
        if len(m) != len(lod) - 1:
            raise ValueError(
                f"split_lod_tensor: mask has {len(m)} entries but input has "
                f"{len(lod) - 1} level-{level} sequences")
        t_rows, f_rows, t_lens, f_lens = [], [], [], []
        for s, take in enumerate(m):
            rows = range(lod[s], lod[s + 1])
            if take:
                t_rows.extend(rows)
                t_lens.append(len(rows))
            else:
                f_rows.extend(rows)
                f_lens.append(len(rows))
        return t_rows, f_rows, t_lens, f_lens
    n = data_of(xv).shape[0]
    if len(m) != n:
        raise ValueError(
            f"split_lod_tensor: mask has {len(m)} entries for {n} rows")
    idx = np.arange(n)
    return idx[m].tolist(), idx[~m].tolist(), None, None


def _branch_out(x, rows, lens):
    out = x.index_select(0, _rows(rows, x.device))
    if lens is None:
        return out
    return LoDTensor(out, [lod_from_seq_lens(lens)])


@register_op("split_lod_tensor", inputs=("X", "Mask"),
             outputs=("OutTrue", "OutFalse"),
             attrs={"level": 0}, diff_inputs=("X",), host=True, lod=True)
def split_lod_tensor(ctx, ins, attrs):
    xv = one(ins, "X")
    m = _mask_bools(one(ins, "Mask"))
    t_rows, f_rows, t_lens, f_lens = _branch_rows(xv, m, attrs["level"])
    x = data_of(xv)
    return {"OutTrue": _branch_out(x, t_rows, t_lens),
            "OutFalse": _branch_out(x, f_rows, f_lens)}


@register_op("split_lod_tensor_grad",
             inputs=("X", "Mask", "OutTrue@GRAD", "OutFalse@GRAD"),
             outputs=("X@GRAD",), attrs={"level": 0}, host=True, lod=True)
def split_lod_tensor_grad(ctx, ins, attrs):
    """Scatter the branch gradients back to the original rows."""
    xv = one(ins, "X")
    m = _mask_bools(one(ins, "Mask"))
    t_rows, f_rows, _, _ = _branch_rows(xv, m, attrs["level"])
    x = data_of(xv)
    gx = torch.zeros_like(x)
    for g, rows in ((many(ins, "OutTrue@GRAD"), t_rows),
                    (many(ins, "OutFalse@GRAD"), f_rows)):
        if g and g[0] is not None and rows:
            gx.index_copy_(0, _rows(rows, x.device), data_of(g[0]).reshape(
                (len(rows),) + tuple(x.shape[1:])).to(x.dtype))
    if isinstance(xv, LoDTensor) and xv.lod:
        gx = LoDTensor(gx, xv.lod)
    return {"X@GRAD": gx}


@register_op("merge_lod_tensor", inputs=("X", "Mask", "InTrue", "InFalse"),
             outputs=("Out",), attrs={"level": 0},
             diff_inputs=("InTrue", "InFalse"), host=True, lod=True)
def merge_lod_tensor(ctx, ins, attrs):
    """Interleave the two branches back into X's sequence order
    (merge_lod_tensor_op.cc); X gives the LoD frame the split used."""
    xv = one(ins, "X")
    m = _mask_bools(one(ins, "Mask"))
    t_rows, f_rows, _, _ = _branch_rows(xv, m, attrs["level"])
    t, f = data_of(one(ins, "InTrue")), data_of(one(ins, "InFalse"))
    src = t if t.numel() or not f.numel() else f
    feat = tuple(src.shape[1:])
    out = torch.zeros((len(t_rows) + len(f_rows),) + feat, dtype=src.dtype,
                      device=src.device)
    for v, rows in ((t, t_rows), (f, f_rows)):
        if rows:
            out = out.index_copy(0, _rows(rows, out.device),
                                 v.reshape((len(rows),) + feat)
                                 .to(out.dtype))
    if isinstance(xv, LoDTensor) and xv.lod:
        out = LoDTensor(out, xv.lod)
    return {"Out": out}


@register_op("merge_lod_tensor_grad",
             inputs=("X", "Mask", "InTrue", "InFalse", "Out@GRAD"),
             outputs=("InTrue@GRAD", "InFalse@GRAD"),
             attrs={"level": 0}, host=True, lod=True)
def merge_lod_tensor_grad(ctx, ins, attrs):
    """Split the merged gradient back into the two branch gradients."""
    xv = one(ins, "X")
    m = _mask_bools(one(ins, "Mask"))
    t_rows, f_rows, t_lens, f_lens = _branch_rows(xv, m, attrs["level"])
    g = data_of(one(ins, "Out@GRAD"))
    return {"InTrue@GRAD": _branch_out(g, t_rows, t_lens),
            "InFalse@GRAD": _branch_out(g, f_rows, f_lens)}


# ---------------------------------------------------------------------------
# tensor arrays (tensor_array_read_write_op.cc)
# ---------------------------------------------------------------------------


@register_op("write_to_array", inputs=("X", "I"), outputs=("Out",),
             not_differentiable=True, host=True, lod=True)
def write_to_array(ctx, ins, attrs):
    """A new array: the output var's old items with X (its LoD kept) at
    index I, the gap padded with None."""
    x = one(ins, "X")
    i = _scalar_int(one(ins, "I"))
    arr = ctx.env.get(ctx.op.output("Out")[0])
    arr = TensorArray(list(arr.tensors) if isinstance(arr, TensorArray)
                      else [])
    while len(arr) <= i:
        arr.append(None)
    arr.tensors[i] = x
    return {"Out": arr}


@register_op("read_from_array", inputs=("X", "I"), outputs=("Out",),
             not_differentiable=True, host=True, lod=True)
def read_from_array(ctx, ins, attrs):
    return {"Out": one(ins, "X")[_scalar_int(one(ins, "I"))]}


@register_op("lod_array_length", inputs=("X",), outputs=("Out",),
             not_differentiable=True, host=True)
def lod_array_length(ctx, ins, attrs):
    return {"Out": torch.full((1,), len(one(ins, "X")), dtype=torch.int64,
                              device=ctx.device)}


# ---------------------------------------------------------------------------
# LoD rank tables (lod_rank_table_op.cc and the ops that read one): the
# length-sorted dynamic-RNN machinery, kept for the API; the recurrence
# itself is `dynamic_rnn` below
# ---------------------------------------------------------------------------


class LoDRankTable:
    """The sequences of one LoD level sorted by descending length, ties
    by index: items[i] = (original sequence index, length)."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def __repr__(self):
        return f"LoDRankTable({self.items})"


@register_op("lod_rank_table", inputs=("X",), outputs=("Out",),
             attrs={"level": 0}, not_differentiable=True, host=True,
             lod=True)
def lod_rank_table(ctx, ins, attrs):
    lens = one(ins, "X").seq_lens(attrs["level"])
    return {"Out": LoDRankTable(sorted(enumerate(lens),
                                       key=lambda t: (-t[1], t[0])))}


@register_op("max_sequence_len", inputs=("RankTable",), outputs=("Out",),
             not_differentiable=True, host=True)
def max_sequence_len(ctx, ins, attrs):
    table = one(ins, "RankTable")
    mx = table.items[0][1] if table.items else 0
    return {"Out": torch.full((1,), mx, dtype=torch.int64,
                              device=ctx.device)}


@register_op("lod_tensor_to_array", inputs=("X", "RankTable"),
             outputs=("Out",), not_differentiable=True, host=True, lod=True)
def lod_tensor_to_array(ctx, ins, attrs):
    """A LoD tensor split into one tensor a time step, the batch
    shrinking as sequences end, sequences in rank-table order
    (lod_tensor_to_array_op.cc)."""
    xv = one(ins, "X")
    table = one(ins, "RankTable")
    lod = xv.lod[-1]
    max_len = table.items[0][1] if table.items else 0
    return {"Out": TensorArray([
        xv.data.index_select(0, _rows(
            [lod[idx] + t for idx, ln in table.items if ln > t],
            xv.data.device))
        for t in range(max_len)])}


@register_op("array_to_lod_tensor", inputs=("X", "RankTable"),
             outputs=("Out",), not_differentiable=True, host=True)
def array_to_lod_tensor(ctx, ins, attrs):
    """The inverse of lod_tensor_to_array: each sequence's rows back in
    the original sequence order (array_to_lod_tensor_op.cc)."""
    arr = one(ins, "X")
    table = one(ins, "RankTable")
    lens = dict(table.items)
    nseq = len(table.items)
    steps = [data_of(t) for t in arr.tensors]
    # the row of each (sequence, step) in the steps concatenated
    at, base = {i: [] for i in range(nseq)}, 0
    for t, step in enumerate(steps):
        active = [idx for idx, ln in table.items if ln > t]
        for k, idx in enumerate(active):
            at[idx].append(base + k)
        base += step.shape[0]
    order = [r for i in range(nseq) for r in at[i]]
    out_lens = [lens.get(i, 0) for i in range(nseq)]
    if order:
        cat = torch.cat(steps)
        data = cat.index_select(0, _rows(order, cat.device))
    else:
        feat = next((tuple(s.shape[1:]) for s in steps if s.numel()), (1,))
        data = torch.zeros((0,) + feat, dtype=torch.float32,
                           device=ctx.device)
    return {"Out": LoDTensor(data, [lod_from_seq_lens(out_lens)])}


@register_op("shrink_rnn_memory", inputs=("X", "RankTable", "I"),
             outputs=("Out",), host=True)
def shrink_rnn_memory(ctx, ins, attrs):
    """The memory's first k rows, k the sequences still running at step
    I (shrink_rnn_memory_op.cc)."""
    table = one(ins, "RankTable")
    i = _scalar_int(one(ins, "I"))
    k = sum(1 for _, ln in table.items if ln > i)
    return {"Out": one(ins, "X")[:k]}


@register_op("reorder_lod_tensor_by_rank", inputs=("X", "RankTable"),
             outputs=("Out",), not_differentiable=True, host=True, lod=True)
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """The sequences (rows of a dense input) in rank-table order."""
    xv = one(ins, "X")
    table = one(ins, "RankTable")
    x = data_of(xv)
    if isinstance(xv, LoDTensor) and xv.lod:
        lod = xv.lod[-1]
        rows = [r for idx, _ in table.items
                for r in range(lod[idx], lod[idx + 1])]
        return {"Out": LoDTensor(
            x.index_select(0, _rows(rows, x.device)),
            [lod_from_seq_lens([ln for _, ln in table.items])])}
    return {"Out": x.index_select(0, _rows([idx for idx, _ in table.items],
                                           x.device))}


# ---------------------------------------------------------------------------
# beam search (beam_search_op.cc, beam_search_decode_op.h: host ops there
# too)
# ---------------------------------------------------------------------------


def _abs_offsets(lod, level):
    """LoD offsets of `level` as absolute row offsets
    (framework::ToAbsOffset)."""
    off = list(lod[level])
    for lower in lod[level + 1:]:
        off = [lower[o] for o in off]
    return off


@register_op("beam_search",
             inputs=("pre_ids", "ids", "scores"),
             outputs=("selected_ids", "selected_scores"),
             attrs={"level": 0, "beam_size": 1, "end_id": 0},
             not_differentiable=True, host=True, lod=True)
def beam_search(ctx, ins, attrs):
    """The top beam_size candidates of each source sentence, the
    candidates of ended prefixes pruned (beam_search_op.cc:24-116), in
    the JAX package's order: a stable sort of a source's (row, id,
    score) items on -score (ties keep row-major candidate order), then
    within each prefix row by (row, id).

    ids/scores: [n_prefix_rows, K] with a 2-level LoD whose level-`level`
    absolute offsets split the prefix rows by source sentence.  The
    outputs' LoD: level 0 those offsets, level 1 each prefix's selected
    candidates.  Ids stay int64."""
    pre_ids = _host(one(ins, "pre_ids")).reshape(-1)
    idsv = one(ins, "ids")
    ids = _host(idsv)
    scores = _host(one(ins, "scores"))
    beam_size, end_id = attrs["beam_size"], attrs["end_id"]

    high = _abs_offsets(idsv.lod, attrs["level"])
    n_rows = high[-1]
    ids2 = ids.reshape(n_rows, -1)
    scores2 = scores.reshape(n_rows, -1)

    per_row = [[] for _ in range(n_rows)]
    for s in range(len(high) - 1):
        items = [(r, int(ids2[r, d]), float(scores2[r, d]))
                 for r in range(high[s], high[s + 1])
                 for d in range(ids2.shape[1])]
        items.sort(key=lambda t: -t[2])
        for it in items[:beam_size]:
            per_row[it[0]].append(it)
    for r in range(n_rows):
        if r < len(pre_ids) and int(pre_ids[r]) == end_id:
            per_row[r] = []

    sel_ids, sel_scores, low = [], [], [0]
    for r in range(n_rows):
        for _, i, sc in sorted(per_row[r], key=lambda t: (t[0], t[1])):
            sel_ids.append(i)
            sel_scores.append(sc)
        low.append(len(sel_ids))
    lod = (tuple(high), tuple(low))
    return {
        "selected_ids": LoDTensor(torch.as_tensor(
            np.asarray(sel_ids, np.int64).reshape(-1, 1),
            device=ctx.device), lod),
        "selected_scores": LoDTensor(torch.as_tensor(
            np.asarray(sel_scores, np.float32).reshape(-1, 1),
            device=ctx.device), lod),
    }


def _make_sentence(node):
    words, scores = [], []
    while node is not None:
        words.append(node[0])
        scores.append(node[1])
        node = node[2]
    return words[::-1], scores[::-1]


@register_op("beam_search_decode", inputs=("Ids", "Scores"),
             outputs=("SentenceIds", "SentenceScores"),
             not_differentiable=True, host=True)
def beam_search_decode(ctx, ins, attrs):
    """Back-track the per-step beam arrays into whole candidate
    sentences (beam_search_decode_op.h PackAllSteps): a prefix with no
    continuation at a step is a finished sentence; the prefixes alive
    after the last step finish there.  Output LoD: (sentences a source,
    tokens a sentence)."""
    step_ids, step_scores = one(ins, "Ids"), one(ins, "Scores")
    steps = [(_host(i).reshape(-1), _host(s).reshape(-1), i.lod)
             for i, s in zip(step_ids.tensors, step_scores.tensors)
             if i is not None]
    if not steps:
        raise ValueError("beam_search_decode needs at least one step")
    src_num = len(steps[0][2][0]) - 1

    prefixes = []   # per source: leaf nodes (word, score, parent)
    sentences = [[] for _ in range(src_num)]
    for ids, scores, lod in steps:
        src_off, cand_off = lod[0], lod[1]
        new_prefixes = []
        for s in range(src_num):
            nodes = []
            if not prefixes:    # the first step: every id starts one
                for r in range(src_off[s], src_off[s + 1]):
                    nodes.append((int(ids[r]), float(scores[r]), None))
            else:
                for p_idx, prefix in enumerate(prefixes[s]):
                    row = src_off[s] + p_idx
                    lo, hi = cand_off[row], cand_off[row + 1]
                    if lo == hi:
                        sentences[s].append(_make_sentence(prefix))
                    for c in range(lo, hi):
                        nodes.append((int(ids[c]), float(scores[c]),
                                      prefix))
            new_prefixes.append(nodes)
        prefixes = new_prefixes
    for s in range(src_num):
        for node in prefixes[s]:
            sentences[s].append(_make_sentence(node))

    id_data, score_data, src_lod, sent_lod = [], [], [0], [0]
    for s in range(src_num):
        for words, scs in sentences[s]:
            id_data.extend(words)
            score_data.extend(scs)
            sent_lod.append(sent_lod[-1] + len(words))
        src_lod.append(src_lod[-1] + len(sentences[s]))
    lod = (tuple(src_lod), tuple(sent_lod))
    return {
        "SentenceIds": LoDTensor(torch.as_tensor(
            np.asarray(id_data, np.int64), device=ctx.device), lod),
        "SentenceScores": LoDTensor(torch.as_tensor(
            np.asarray(score_data, np.float32), device=ctx.device), lod),
    }


# ---------------------------------------------------------------------------
# sub-block ops over a chained env: parallel_do and dynamic_rnn
# ---------------------------------------------------------------------------


class _ChainEnv(DictEnv):
    """A dict env reading through to a fixed outer mapping."""

    def __init__(self, inner, outer):
        super().__init__(inner)
        self.outer = outer

    def get(self, name):
        if name in self.d:
            return self.d[name]
        return self.outer.get(name)

    def has(self, name):
        return name in self.d or name in self.outer


def _captured(ctx, ins):
    """{captured var name: value}: the names the block's ops read, bound
    by the op's own Captured slots (a grad op's are the forward's)."""
    out = dict(zip(ctx.op.input("Captured"), many(ins, "Captured")))
    out.update(zip(ctx.op.input("CapturedNoGrad"),
                   many(ins, "CapturedNoGrad")))
    return out


@register_op(
    "parallel_do",
    inputs=("Inputs", "Captured", "CapturedNoGrad"),
    outputs=("Outs",),
    attrs={"use_nccl": False},
    dup_inputs=("Inputs", "Captured", "CapturedNoGrad"),
    dup_outputs=("Outs",),
    diff_inputs=("Inputs", "Captured"),
    diff_outputs=("Outs",))
def parallel_do(ctx, ins, attrs):
    """The sub-block over the whole batch on the executing device: its
    results are the serial run's, as the JAX package's (whose dp mesh
    only annotates the same computation).  Under a process group of
    several ranks the same holds: ParallelExecutor runs a program with
    sub-blocks in its replicated form, every rank over the global
    batch, so each rank computes the serial result."""
    env = _ChainEnv({}, _captured(ctx, ins))
    for name, v in zip(attrs["input_names"], many(ins, "Inputs")):
        env.set(name, data_of(v))
    _run_block(ctx, ctx.op.sub_block().ops, env)
    return {"Outs": [data_of(env.get(n)) for n in attrs["output_names"]]}


def _memories(spec_list, inits, dynamic, bsz, device):
    """The memories' initial values: an InitMemories value, or a fill of
    the spec's shape (with the batch in front in the dynamic mode)."""
    mems, it = [], iter(inits)
    for spec in spec_list:
        if spec["init"]:
            mems.append(data_of(next(it)))
            continue
        shape = tuple(spec["shape"])
        if dynamic and spec.get("batch_ref", True):
            shape = (bsz,) + shape
        mems.append(torch.full(shape, spec.get("value", 0.0),
                               dtype=torch_dtype(spec.get("dtype",
                                                          "float32")),
                               device=device))
    return mems


@register_op(
    "dynamic_rnn",
    inputs=("StepInputs", "InitMemories", "StaticInputs", "Captured",
            "CapturedNoGrad"),
    outputs=("Outs",),
    attrs={"is_dynamic": True},
    dup_inputs=("StepInputs", "InitMemories", "StaticInputs", "Captured",
                "CapturedNoGrad"),
    dup_outputs=("Outs",),
    diff_inputs=("StepInputs", "InitMemories", "StaticInputs", "Captured"),
    diff_outputs=("Outs",), lod=True)
def dynamic_rnn(ctx, ins, attrs):
    """The step sub-block once per time step.

    Dynamic mode (`is_dynamic`): the step inputs are LoDTensors of one
    LoD, gathered to [T, B, ...] by the LoD's padding table; memory
    updates are masked (m * new + (1 - m) * old, m the [B] mask of step
    t) so a finished sequence keeps its last state; the outputs are
    repacked to the LoD's rows in the original batch order.  Static mode
    (`recurrent`): dense step inputs walked along axis 0, the outputs
    stacked [T, ...].  Step t runs in the context's child keyed by t, so
    a random op draws anew each step, and the gradient's re-run draws
    the forward's numbers."""
    dynamic = attrs.get("is_dynamic", True)
    step_vals = many(ins, "StepInputs")
    if dynamic:
        lod = step_vals[0].lod[-1]
        for sv in step_vals[1:]:
            if sv.lod[-1] != lod:
                raise ValueError(
                    "dynamic_rnn: all step inputs must share one LoD, got "
                    f"{sv.lod[-1]} vs {lod}")
        dev = step_vals[0].data.device
        rows, mask, tmax = padded_rows(ctx, lod, dev)
        bsz = mask.shape[0]
        xs = [gather_rows(v.data, rows).reshape(
            (bsz, tmax) + tuple(v.data.shape[1:])).transpose(0, 1)
            for v in step_vals]
        mask = mask.t()                                  # [T, B]
    else:
        xs = [data_of(v) for v in step_vals]
        tmax, bsz, dev = xs[0].shape[0], None, xs[0].device

    mems = _memories(attrs["memory_specs"], many(ins, "InitMemories"),
                     dynamic, bsz, dev)
    outer = dict(zip(attrs["static_input_names"],
                     [data_of(v) for v in many(ins, "StaticInputs")]))
    # captured vars have no placeholders: the input-slot names ARE the
    # names the step's ops read (the grad op's slots are the forward's)
    outer.update(_captured(ctx, ins))
    sub_ops = ctx.op.sub_block().ops
    step_names, mem_names = attrs["step_input_names"], attrs["memory_names"]
    upd_names, out_names = attrs["memory_update_names"], attrs["output_names"]
    ys = [[] for _ in out_names]
    for t in range(tmax):
        env = _ChainEnv({}, outer)
        for n, x in zip(step_names, xs):
            env.set(n, x[t])
        for n, v in zip(mem_names, mems):
            env.set(n, v)
        _run_block(ctx.child(t), sub_ops, env)
        new_mems = []
        for old, n in zip(mems, upd_names):
            new = data_of(env.get(n))
            if dynamic:
                m = mask[t].reshape((-1,) + (1,) * (new.dim() - 1))
                new = m * new + (1 - m) * old
            new_mems.append(new)
        mems = new_mems
        for y, n in zip(ys, out_names):
            y.append(data_of(env.get(n)))

    if not dynamic:
        return {"Outs": [torch.stack(y) for y in ys]}
    outs = []
    for y in ys:
        padded = torch.stack(y, dim=1)                   # [B, T, ...]
        flat = padded.reshape((bsz * tmax,) + tuple(padded.shape[2:]))
        outs.append(LoDTensor(gather_rows(flat, repack_rows(
            ctx, lod, tmax, flat.device)), step_vals[0].lod))
    return {"Outs": outs}


# `recurrent` (recurrent_op.cc, the static RNN) is dynamic_rnn's lowering
# with is_dynamic=False, registered under both names so reference-shaped
# Programs resolve
register_op("recurrent",
            inputs=("StepInputs", "InitMemories", "StaticInputs",
                    "Captured", "CapturedNoGrad"),
            outputs=("Outs",), attrs={"is_dynamic": False},
            dup_inputs=("StepInputs", "InitMemories", "StaticInputs",
                        "Captured", "CapturedNoGrad"),
            dup_outputs=("Outs",),
            diff_inputs=("StepInputs", "InitMemories", "StaticInputs",
                         "Captured"),
            diff_outputs=("Outs",), lod=True)(dynamic_rnn)


# ---------------------------------------------------------------------------
# recompute (rematerialisation)
# ---------------------------------------------------------------------------


@register_op("recompute", inputs=("X",), outputs=("Out",),
             attrs={"output_names": []},
             dup_inputs=("X",), dup_outputs=("Out",),
             diff_inputs=("X",), diff_outputs=("Out",), lod=True)
def recompute(ctx, ins, attrs):
    """The segment's sub-block over its read-set `X` -> `Out`: the values
    named in `output_names` (the segment's outputs, then the persistables
    it writes, such as batch norm's running statistics).

    The sub-block runs against an env of its own, so none of its
    activations outlives the op: the forward keeps only `Out`.  The
    gradient is the generic one: `generic_grad_lower` re-runs this
    lowering under autograd from `X` and pulls the cotangents back, so
    the segment runs twice forward a step and its activations live only
    inside its gradient op, where the JAX package's `jax.checkpoint`
    does the same.  The re-run draws the forward's random numbers (the
    grad op carries the forward's random-stream tag, and `pure()` keeps
    the seed), and its persistable writes stay in its own env: the
    running statistics are written once a step, by the forward."""
    env = DictEnv(dict(zip(ctx.op.input("X"), many(ins, "X"))))
    _run_block(ctx.child(0), ctx.op.sub_block().ops, env)
    return {"Out": [env.get(n) for n in attrs["output_names"]]}


# ---------------------------------------------------------------------------
# build-time shape inference of the sub-block ops: their outputs' shapes are
# declared by the layer builders that create them, as in the JAX package
# ---------------------------------------------------------------------------


def _infer_via_builder(op, block):
    """Output shapes already declared at construction (layers/)."""


for _t in ("dynamic_rnn", "recurrent", "parallel_do", "recompute"):
    register_infer_shape(_t)(_infer_via_builder)
