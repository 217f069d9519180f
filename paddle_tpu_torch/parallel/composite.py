"""Composed dp x pp x tp training steps with ZeRO-1 and gradient
accumulation: the test oracle of the composed mesh.

Counterpart of paddle_tpu/parallel/composite.py, whose hand-built models
(a Megatron-split MLP stage and a pre-LN transformer LM) stay the
independent twin of PipelineExecutor.  Here each rank of the mesh holds
its blocks: its stage's parameters ('pp'), their column / row blocks
('tp'), and its rows of the momentum state ('dp', ZeRO-1).  A step runs
the GPipe schedule (parallel/pipeline.py `pipeline_local`) on every
accumulation batch, the stage function issuing the tensor-parallel
collectives (parallel/collective.py `copy_to` / `reduce_from`), sums the
gradients over dp in the schedule's backward, and updates the momentum
rows it owns, the new parameter rows all-gathered over dp.

`make_composite_step` and `make_transformer_composite_step` return
(step_fn, params, velocity[, meta]); `step_fn(params, velocity, xs, ys)`
-> (new_params, new_velocity, mean_loss), the pytrees holding this
rank's blocks.  The initial parameters come from the seed the JAX
package draws them from, or from `init` (its stacked numpy arrays), so
a step equals the JAX oracle's.  `collective_counts(step_fn, *args)`
counts the collectives one step issues (its collective record).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .collective import copy_to, gather_from, reduce_from, scatter_to
from .mesh import _blocks, count_collectives
from .pipeline import (_leaves, _unflatten, microbatch, pipeline_local,
                       unmicrobatch)

__all__ = ["make_composite_step", "make_transformer_composite_step",
           "collective_counts"]


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


class _Step:
    """A composed step over this rank's blocks (`p_specs` / `v_specs`:
    the parameters' and the momentum's specs, 'pp' left out); `record`
    holds the collectives of its last call."""

    def __init__(self, groups, loss_fn, p_specs, v_specs, lr, mu):
        self.groups, self.loss_fn = groups, loss_fn
        self.p_specs, self.v_specs, self.lr, self.mu = (p_specs, v_specs,
                                                        lr, mu)
        self.record = []
        for g in groups.values():
            g.record = self.record

    def _zero_dim(self, pspec, vspec):
        """The dim the velocity splits over 'dp' beyond its parameter."""
        for d, (a, b) in enumerate(zip(list(pspec) + [None] * 4, vspec)):
            bs = b if isinstance(b, tuple) else (b,)
            if "dp" in bs:
                return d
        return None

    def __call__(self, params, velocity, xs, ys):
        self.record.clear()
        leaves = [p.detach().clone().requires_grad_(True) for p in
                  _leaves(params)]
        tree = _unflatten(params, leaves)
        n_acc = xs.shape[0]
        loss_sum = 0.0
        for a in range(n_acc):
            loss = self.loss_fn(tree, xs[a], ys[a])
            loss.backward()
            loss_sum += float(loss)
        dp = self.groups.get("dp")
        new_p, new_v = [], []
        with torch.no_grad():
            for p, v, ps, vs in zip(leaves, _leaves(velocity),
                                    _leaves(self.p_specs),
                                    _leaves(self.v_specs)):
                g = p.grad / n_acc
                d = self._zero_dim(ps, vs)
                if d is not None and dp is not None and dp.size > 1:
                    m = v.shape[d]
                    lo = dp.index * m
                    g = g.narrow(d, lo, m)
                    v2 = self.mu * v + g
                    rows = p.detach().narrow(d, lo, m) - self.lr * v2
                    new_p.append(dp.all_gather(rows.contiguous(), d))
                else:
                    v2 = self.mu * v + g
                    new_p.append(p.detach() - self.lr * v2)
                new_v.append(v2)
        return (_unflatten(params, new_p), _unflatten(velocity, new_v),
                loss_sum / n_acc)


def _specs(*specs):
    from .mesh import PartitionSpec

    return tuple(PartitionSpec(*s) for s in specs)


def make_composite_step(mesh, dim: int = 8, hidden: int = 16,
                        n_micro: int = 4, lr: float = 0.05, mu: float = 0.9,
                        seed: int = 0, init=None):
    """The composed step over `mesh` (axes 'dp', 'pp', 'tp'): a
    Megatron-split MLP stage a pipeline stage (w1 column-parallel, w2
    row-parallel, one all-reduce over 'tp'), a mean squared error, the
    momentum rows split over 'dp'.  `init`: the stacked (w1, b1, w2, b2)
    as numpy arrays (default: drawn from `seed` as the JAX package
    draws them).  -> (step_fn, params, velocity), this rank's blocks."""
    pp, dp, tp = mesh.shape["pp"], mesh.shape["dp"], mesh.shape["tp"]
    dim = int(np.lcm(dim, dp))
    hidden = int(np.lcm(hidden, tp * dp))
    if init is None:
        r = np.random.RandomState(seed)
        per = [(np.float32(r.randn(dim, hidden)) * np.float32(0.3),
                np.zeros((hidden,), np.float32),
                np.float32(r.randn(hidden, dim)) * np.float32(0.3),
                np.zeros((dim,), np.float32)) for _ in range(pp)]
        init = tuple(np.stack(c) for c in zip(*per))
    p_specs = _specs(("pp", None, "tp"), ("pp", "tp"), ("pp", "tp", None),
                     ("pp",))
    v_specs = _specs(("pp", "dp", "tp"), ("pp", ("tp", "dp")),
                     ("pp", "tp", "dp"), ("pp", "dp"))
    params = tuple(_blocks(mesh, _f32(a), s)[0]
                   for a, s in zip(init, p_specs))
    velocity = tuple(_blocks(mesh, torch.zeros(np.shape(a)), s)[0]
                     for a, s in zip(init, v_specs))
    p_local = tuple(_drop_pp(s) for s in p_specs)
    v_local = tuple(_drop_pp(s) for s in v_specs)
    groups = {a: mesh.axis_group(a) for a in mesh.axis_names}

    def stage_fn(p, h):
        w1, b1, w2, b2 = p
        u = torch.tanh(copy_to(h, groups["tp"]) @ w1 + b1)
        return reduce_from(u @ w2, groups["tp"]) + b2

    def loss_fn(p, xb, yb):
        x = microbatch(xb, n_micro)
        x = scatter_to(x, groups["dp"], 1) if dp > 1 else x
        out = pipeline_local(stage_fn, p, x, groups["pp"],
                             [groups["dp"]] if dp > 1 else [])
        if dp > 1:
            out = gather_from(out, groups["dp"], 1)
        return torch.mean((unmicrobatch(out) - yb) ** 2)

    def checked(params, velocity, xs, ys):
        if xs.shape[-1] != dim or ys.shape[-1] != dim:
            raise ValueError(
                f"data feature dim {xs.shape[-1]}/{ys.shape[-1]} != "
                f"effective model dim {dim} (requested dim grew to "
                "lcm(dim, dp) for this mesh; size inputs from "
                "params[0].shape[0])")
        return step(params, velocity, torch.as_tensor(xs),
                    torch.as_tensor(ys))

    step = _Step(groups, loss_fn, p_local, v_local, lr, mu)
    checked.record, checked.p_specs, checked.v_specs = (step.record, p_local,
                                                        v_local)
    return checked, params, velocity


def _drop_pp(spec):
    from .mesh import PartitionSpec

    return PartitionSpec(*tuple(spec)[1:])


def _ln(x, s, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * s + b


def make_transformer_composite_step(mesh, vocab: int = 32, n_heads: int = 4,
                                    d_head: int = 8, seq: int = 8,
                                    n_micro: int = 2, lr: float = 0.2,
                                    mu: float = 0.9, seed: int = 0,
                                    init=None):
    """The composed step on a causal transformer LM: one pre-LN block a
    pipeline stage, attention and FFN projections Megatron-split over
    'tp' (the flash attention on the local heads), the embedding and
    classifier outside the trunk, ZeRO-1 momentum rows over 'dp',
    gradient accumulation.  `init`: (outer dict, stacked stage tuple) as
    numpy arrays (default: drawn from `seed` as the JAX package draws
    them).  -> (step_fn, params, velocity, meta); step_fn(params,
    velocity, ids, labels) with [accum, batch, seq] int ids."""
    from ..kernels.flash_attention import flash_attention

    pp, dp, tp = mesh.shape["pp"], mesh.shape["dp"], mesh.shape["tp"]
    base_width = n_heads * d_head
    n_heads = int(np.lcm(n_heads, tp * dp))
    d_model = n_heads * d_head
    lr = lr * base_width / d_model
    d_ffn = 4 * d_model
    vocab = int(np.lcm(vocab, dp))
    if init is None:
        r = np.random.RandomState(seed)

        def rnd(*shape, s=0.05):
            return np.float32(r.randn(*shape)) * np.float32(s)

        z, o = np.zeros, np.ones
        per = [(o((d_model,), np.float32), z((d_model,), np.float32),
                rnd(d_model, d_model), rnd(d_model, d_model),
                rnd(d_model, d_model), rnd(d_model, d_model),
                z((d_model,), np.float32),
                o((d_model,), np.float32), z((d_model,), np.float32),
                rnd(d_model, d_ffn), z((d_ffn,), np.float32),
                rnd(d_ffn, d_model), z((d_model,), np.float32))
               for _ in range(pp)]
        outer = {"emb": rnd(vocab, d_model, s=0.1),
                 "pos": rnd(seq, d_model, s=0.1),
                 "cls_w": rnd(d_model, vocab, s=float(d_model) ** -0.5),
                 "cls_b": z((vocab,), np.float32)}
        init = (outer, tuple(np.stack(c) for c in zip(*per)))
    outer, stack = init
    p_specs = _specs(("pp",), ("pp",), ("pp", None, "tp"),
                     ("pp", None, "tp"), ("pp", None, "tp"),
                     ("pp", "tp", None), ("pp",), ("pp",), ("pp",),
                     ("pp", None, "tp"), ("pp", "tp"), ("pp", "tp", None),
                     ("pp",))
    v_specs = _specs(("pp", "dp"), ("pp", "dp"), ("pp", "dp", "tp"),
                     ("pp", "dp", "tp"), ("pp", "dp", "tp"),
                     ("pp", "tp", "dp"), ("pp", "dp"), ("pp", "dp"),
                     ("pp", "dp"), ("pp", "dp", "tp"), ("pp", ("tp", "dp")),
                     ("pp", "tp", "dp"), ("pp", "dp"))
    o_specs = {"emb": _specs((None,))[0], "pos": _specs(())[0],
               "cls_w": _specs(())[0], "cls_b": _specs(())[0]}
    ov_specs = {"emb": _specs(("dp",))[0], "pos": _specs(())[0],
                "cls_w": _specs(("dp",))[0], "cls_b": _specs(("dp",))[0]}
    stage_p = tuple(_blocks(mesh, _f32(a), s)[0]
                    for a, s in zip(stack, p_specs))
    stage_v = tuple(_blocks(mesh, torch.zeros(np.shape(a)), s)[0]
                    for a, s in zip(stack, v_specs))
    outer_p = {k: _f32(v) for k, v in outer.items()}
    outer_v = {k: _blocks(mesh, torch.zeros(np.shape(v)), ov_specs[k])
               for k, v in outer.items()}
    groups = {a: mesh.axis_group(a) for a in mesh.axis_names}
    g_tp = groups["tp"]

    def stage_fn(params, h):
        (ls1, lb1, wq, wk, wv, wo, bo, ls2, lb2, w1, b1, w2, b2) = params
        mb, S, D = h.shape
        d_loc = wq.shape[1]
        hx = copy_to(_ln(h, ls1, lb1), g_tp)
        q = (hx @ wq).reshape(mb, S, d_loc // d_head, d_head)
        k = (hx @ wk).reshape(mb, S, d_loc // d_head, d_head)
        v = (hx @ wv).reshape(mb, S, d_loc // d_head, d_head)
        att = flash_attention(q, k, v, causal=True).reshape(mb, S, d_loc)
        h = h + reduce_from(att @ wo, g_tp) + bo
        hx = copy_to(_ln(h, ls2, lb2), g_tp)
        u = torch.relu(hx @ w1 + b1)
        return h + reduce_from(u @ w2, g_tp) + b2

    def loss_fn(p, ids, labels):
        o, st = p
        x = o["emb"][ids] + o["pos"][None, :, :]
        x = microbatch(x, n_micro)
        x = scatter_to(x, groups["dp"], 1) if dp > 1 else x
        x = pipeline_local(stage_fn, st, x, groups["pp"],
                           [groups["dp"]] if dp > 1 else [])
        if dp > 1:
            x = gather_from(x, groups["dp"], 1)
        x = unmicrobatch(x)
        x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(
            x.var(-1, keepdim=True, unbiased=False) + 1e-6)
        logits = x @ o["cls_w"] + o["cls_b"]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels[..., None].long())[..., 0].mean()

    step = _Step(groups, loss_fn,
                 (o_specs, tuple(_drop_pp(s) for s in p_specs)),
                 (ov_specs, tuple(_drop_pp(s) for s in v_specs)), lr, mu)

    def run(params, velocity, ids, labels):
        return step(params, velocity, torch.as_tensor(ids),
                    torch.as_tensor(labels))

    run.record, run.p_specs, run.v_specs = (step.record, step.p_specs,
                                            step.v_specs)
    meta = {"vocab": vocab, "d_model": d_model, "seq": seq,
            "n_heads": n_heads}
    return run, (outer_p, stage_p), (outer_v, stage_v), meta


def collective_counts(step_fn, *args) -> Dict[str, int]:
    """{kind: count} of the collectives one call of `step_fn` issues
    (collective-permute = the stage hops, all-reduce = the dp gradient
    sums and the tp all-reduces, all-gather = the ZeRO-1 rows); the
    call runs on the arguments given, which it does not change."""
    step_fn(*args)
    return count_collectives(step_fn.record)
