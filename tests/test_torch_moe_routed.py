"""The MoE gate + dispatch in routing form, against the JAX package, on
the CPU.

The port's `moe_dense` routes in the kernel's form — each capacity slot
its token (`slot_token`) and combine weight (`slot_weight`), each token
its slot per choice (`slot_of`) — and combines by gathering at most two
expert rows a token (`moe_combine`) where the JAX package contracts a
dense [T, E, C] combine.  Held here:

- `moe_dense` (forward, and the `moe_ffn` op's generic gradient) against
  the JAX `moe_dense` and `jax.vjp` with the kernel tier off: top-1 and
  top-2, capacity factors that keep and that drop assignments, E = 1
  and E = 64, tied logits.  Forward 1e-5 absolute (the combine sums
  two products where the einsum sums E * C, mostly exact zeros); aux
  1e-6; gradients 1e-5 * max(1, max|jax|) (the expert and gate products
  sum in another order).
- the routing form against the JAX Pallas kernel in interpret mode:
  expert_in bit-equal (a gather against a one-hot contraction with one
  nonzero term), the dense combine rebuilt from the routing within 1e-6
  (softmax sums in another order), each kept slot's token the Pallas
  combine's only nonzero in that column.
- a CPU model of the CUDA kernel's two passes — per-tile counts, each
  tile's prefix over the earlier tiles, second choices after all first
  choices, ranks within the tile in token order, the empty slots split
  evenly over tiles — equal to the plain routing, at tile sizes that do
  and do not divide T.
- the routing form's VJP (`moe_gate_route_vjp`, the CUDA backward
  kernel's plain version) against `jax.vjp` of the JAX composition
  (moe_gate, the dispatch einsum, each slot's combine weight), 1e-5 *
  max(1, max|jax|).
"""
import numpy as np
import pytest
import torch
import torch.utils._pytree
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.kernels.moe_dispatch import build_moe_gate_dispatch
from paddle_tpu.parallel import moe as jmoe

from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext, generic_grad_lower
from paddle_tpu_torch.core.registry import get_op_info
from paddle_tpu_torch.kernels.moe_dispatch import (
    moe_gate_route, moe_gate_route_reference, moe_gate_route_vjp,
    moe_routing_reference)
from paddle_tpu_torch.parallel import moe as tmoe

T, D, H = 48, 16, 32


@pytest.fixture(autouse=True)
def _fresh_flags():
    tflags.reset_flags()
    yield
    tflags.reset_flags()


def _inputs(e_n, seed=0, ties=False, t_n=T):
    r = np.random.RandomState(seed)
    x = r.standard_normal((t_n, D)).astype(np.float32)
    gw = (r.standard_normal((D, e_n)) * 0.5).astype(np.float32)
    if ties and e_n > 2:       # experts 1 and 2 tie for every token
        gw[:, 2] = gw[:, 1]
    wi = (r.standard_normal((e_n, D, H)) * 0.2).astype(np.float32)
    wo = (r.standard_normal((e_n, H, D)) * 0.2).astype(np.float32)
    return x, gw, wi, wo


def _dense_from_routing(slot_of, slot_weight, t_n):
    """The dense combine [T, E, C] the routing stands for."""
    e_n, c_n = slot_weight.shape
    dense = np.zeros((t_n, e_n * c_n), np.float32)
    sw = slot_weight.reshape(-1)
    for j in range(slot_of.shape[0]):
        for t in range(t_n):
            s = int(slot_of[j, t])
            if s >= 0:
                dense[t, s] = sw[s]
    return dense.reshape(t_n, e_n, c_n)


# (top_k, capacity_factor, experts, ties): 0.5 drops assignments, 1.25
# keeps most; E = 1 puts every choice on one expert (top-2: both)
_DENSE_CASES = [(1, 1.25, 4, False), (2, 1.25, 4, False),
                (1, 0.5, 4, False), (2, 0.5, 4, False),
                (1, 1.25, 1, False), (2, 1.25, 1, False),
                (2, 1.25, 64, False), (1, 0.5, 64, False),
                (2, 1.25, 4, True), (1, 0.5, 4, True)]


@pytest.mark.parametrize("top_k,cf,e_n,ties", _DENSE_CASES)
def test_gather_combine_moe_dense_and_its_gradient_match_jax(top_k, cf, e_n,
                                                             ties):
    x, gw, wi, wo = _inputs(e_n, seed=3, ties=ties)
    r = np.random.RandomState(4)
    dy = r.standard_normal((2, T // 2, D)).astype(np.float32)
    daux = np.array([0.7], np.float32)
    attrs = {"top_k": top_k, "capacity_factor": cf}
    info = get_op_info("moe_ffn")
    ins = {"X": [torch.from_numpy(x.reshape(2, T // 2, D))],
           "GateW": [torch.from_numpy(gw)], "WIn": [torch.from_numpy(wi)],
           "WOut": [torch.from_numpy(wo)]}
    outs = info.lower(ExecContext("cpu"), ins, attrs)
    grad_ins = {**ins, "Out": [outs["Out"]], "AuxLoss": [outs["AuxLoss"]],
                "Out@GRAD": [torch.from_numpy(dy)],
                "AuxLoss@GRAD": [torch.from_numpy(daux)]}
    grads = generic_grad_lower(ExecContext("cpu"), grad_ins, attrs, info)

    def f(x_, gw_, wi_, wo_):
        y, aux = jmoe.moe_dense(x_.reshape(T, D), gw_, wi_, wo_, top_k=top_k,
                                capacity_factor=cf)
        return y.reshape(2, T // 2, D), jnp.reshape(aux, (1,))

    prev = jfluid.core.flags.get_flag("serving_kernels")
    jfluid.core.flags.set_flags({"serving_kernels": "off"})
    try:
        (jy, jaux), vjp = jax.vjp(f, *map(jnp.asarray, (x, gw, wi, wo)))
        jgrads = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    finally:
        jfluid.core.flags.set_flags({"serving_kernels": prev})
    np.testing.assert_allclose(outs["Out"].numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(outs["AuxLoss"].numpy(), np.asarray(jaux),
                               rtol=0, atol=1e-6)
    for slot, want in zip(("X", "GateW", "WIn", "WOut"), jgrads):
        got = grads[slot + "@GRAD"][0].numpy()
        want = np.asarray(want).reshape(got.shape)
        lim = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= lim, slot
    # the kernel tier armed: the kernel's wrapper runs the same plain
    # routing for CPU tensors, bit for bit
    tflags.set_flags({"serving_kernels": "on"})
    armed = info.lower(ExecContext("cpu"), ins, attrs)
    for key in ("Out", "AuxLoss"):
        assert torch.equal(armed[key], outs[key]), key


_ROUTE_CASES = [(1, 4, False), (1, 40, False), (2, 4, False),
                (2, 40, False), (2, 20, True), (1, 1, False)]


@pytest.mark.parametrize("top_k,cap,ties", _ROUTE_CASES)
def test_routing_form_matches_the_jax_kernel_in_interpret_mode(top_k, cap,
                                                               ties):
    e_n = 4
    x, gw, _, _ = _inputs(e_n, seed=2, ties=ties)
    fused = build_moe_gate_dispatch(tokens=T, d_model=D, num_experts=e_n,
                                    capacity=cap, top_k=top_k,
                                    interpret=True)
    jei, jcb, jaux = map(np.asarray, fused(jnp.asarray(x), jnp.asarray(gw)))
    ei, sw, aux, slot_of, slot_token = moe_gate_route(
        torch.from_numpy(x), torch.from_numpy(gw), e_n, cap, top_k)
    slot_of, slot_token = slot_of.numpy(), slot_token.numpy()
    assert slot_of.shape == (top_k, T) and slot_token.shape == (e_n, cap)
    np.testing.assert_array_equal(ei.detach().numpy(), jei)
    np.testing.assert_allclose(
        _dense_from_routing(slot_of, sw.detach().numpy(), T), jcb, rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(aux.detach().numpy(), jaux, rtol=0, atol=1e-6)
    # each kept slot's token is the only nonzero of the Pallas combine's
    # column; empty slots have none and weigh 0
    cols = jcb.reshape(T, -1)
    for s, t in enumerate(slot_token.reshape(-1)):
        nz = np.flatnonzero(cols[:, s])
        assert list(nz) == ([] if t < 0 else [t]), s
        if t < 0:
            assert float(sw.reshape(-1)[s]) == 0.0
    # slot_of and slot_token are inverse maps; a token's kept choices
    # sit with its experts
    _, idx, _ = moe_routing_reference(torch.from_numpy(x),
                                      torch.from_numpy(gw), e_n, cap, top_k)
    for j in range(top_k):
        for t in range(T):
            s = int(slot_of[j, t])
            if s >= 0:
                assert slot_token.reshape(-1)[s] == t
                assert s // cap == int(idx[j, t])
    kept = int((slot_of >= 0).sum())
    assert kept == int((slot_token >= 0).sum())
    if cap == 4:       # 4 slots of 48 tokens over 4 experts overflow
        assert kept < T * top_k


# -- the CUDA kernel's two passes, modelled ----------------------------------

def two_pass_model(idx, e_n, c_n, tile):
    """The arithmetic of csrc/moe_dispatch.cu's route and place kernels
    at `tile` tokens a CTA -> (slot_of [k, T], slot_token [E * C], the
    empty slots each tile zero-fills)."""
    k, t_n = idx.shape
    tiles = -(-t_n // tile)
    # pass 1: each tile's first- and second-choice counts per expert
    counts = np.zeros((tiles, k, e_n), np.int64)
    for b in range(tiles):
        for j in range(k):
            for t in range(b * tile, min(t_n, (b + 1) * tile)):
                counts[b, j, idx[j, t]] += 1
    slot_of = np.full((k, t_n), -1, np.int64)
    slot_token = np.full(e_n * c_n, -1, np.int64)
    fills = []
    for b in range(tiles):
        # pass 2, CTA b: the earlier tiles' counts and all tiles' totals
        below = counts[:b].sum(0)
        total = counts.sum(0)
        first = total[0]
        base = [below[0], first + below[1]] if k == 2 else [below[0]]
        for j in range(k):
            seen = np.zeros(e_n, np.int64)     # rank within the tile
            for t in range(b * tile, min(t_n, (b + 1) * tile)):
                e = idx[j, t]
                pos = base[j][e] + seen[e]
                seen[e] += 1
                if pos < c_n:
                    slot_of[j, t] = e * c_n + pos
                    slot_token[e * c_n + pos] = t
        filled = np.minimum(c_n, total.sum(0))
        zoff = np.concatenate([[0], np.cumsum(c_n - filled)])
        z_n = int(zoff[-1])
        mine = []
        for z in range(z_n * b // tiles, z_n * (b + 1) // tiles):
            e = int(np.searchsorted(zoff, z, side="right") - 1)
            mine.append(e * c_n + int(filled[e]) + z - int(zoff[e]))
        fills.append(mine)
    return slot_of, slot_token, fills


@pytest.mark.parametrize("tile", [5, 7, 32, 48, 64])
@pytest.mark.parametrize("top_k,e_n,cap,ties", [
    (1, 4, 4, False), (1, 4, 40, False), (2, 4, 4, False),
    (2, 4, 15, False), (2, 4, 40, True), (2, 64, 1, False),
    (2, 1, 60, False)])
def test_two_pass_position_model_matches_the_plain_routing(tile, top_k, e_n,
                                                           cap, ties):
    x, gw, _, _ = _inputs(e_n, seed=5, ties=ties)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gw)
    _, idx, _ = moe_routing_reference(tx, tg, e_n, cap, top_k)
    _, _, _, slot_of, slot_token = moe_gate_route_reference(tx, tg, e_n, cap,
                                                            top_k)
    got_of, got_tok, fills = two_pass_model(idx.numpy().astype(np.int64),
                                            e_n, cap, tile)
    np.testing.assert_array_equal(got_of, slot_of.numpy())
    np.testing.assert_array_equal(got_tok, slot_token.numpy().reshape(-1))
    # the tiles' zero-fill shares are the empty slots, each once, evenly
    flat = [s for mine in fills for s in mine]
    assert sorted(flat) == list(np.flatnonzero(got_tok < 0))
    sizes = [len(mine) for mine in fills]
    assert max(sizes) - min(sizes) <= 1


# -- the routing form's VJP --------------------------------------------------

def _jax_route(x_, gw_, e_n, cap, top_k):
    """The JAX composition in routing form: moe_gate, the dispatch
    einsum, and each slot's combine weight (its column's only nonzero)."""
    d, c, a = jmoe.moe_gate(x_, gw_, e_n, cap, top_k)
    return (jnp.einsum("td,tec->ecd", x_, d), jnp.sum(c, axis=0),
            jnp.reshape(a, (1, 1)))


@pytest.mark.parametrize("top_k,cap,ties", [(1, 4, False), (1, 40, False),
                                            (2, 4, False), (2, 40, False),
                                            (2, 20, True)])
@pytest.mark.parametrize("which", ["all", "slot_weight", "aux"])
def test_routing_form_vjp_matches_jax_vjp(top_k, cap, ties, which):
    e_n = 4
    x, gw, _, _ = _inputs(e_n, seed=6, ties=ties)
    r = np.random.RandomState(7)
    cots = [r.standard_normal((e_n, cap, D)).astype(np.float32),
            r.standard_normal((e_n, cap)).astype(np.float32),
            np.array([[0.7]], np.float32)]
    if which != "all":
        keep = {"slot_weight": 1, "aux": 2}[which]
        cots = [c if i == keep else np.zeros_like(c)
                for i, c in enumerate(cots)]
    _, vjp = jax.vjp(lambda a, b: _jax_route(a, b, e_n, cap, top_k),
                     jnp.asarray(x), jnp.asarray(gw))
    want = [np.asarray(w) for w in vjp(tuple(map(jnp.asarray, cots)))]

    tx, tg = torch.from_numpy(x), torch.from_numpy(gw)
    probs, idx, _ = moe_routing_reference(tx, tg, e_n, cap, top_k)
    _, _, _, slot_of, _ = moe_gate_route_reference(tx, tg, e_n, cap, top_k)
    tcots = [None if which != "all" and not c.any() else torch.from_numpy(c)
             for c in cots]
    got = moe_gate_route_vjp(tx, tg, probs, idx, slot_of, *tcots)
    # and autograd through the plain routing form (the CPU path)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tg)]
    outs = moe_gate_route_reference(*leaves, e_n, cap, top_k)[:3]
    auto = torch.autograd.grad(outs, leaves, list(map(torch.from_numpy,
                                                      cots)))
    for name, g, a, w in zip(("dx", "dgate_w"), got, auto, want):
        lim = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= lim, name
        assert float(np.abs(a.numpy() - w).max()) <= lim, name


def test_moe_combine_backward_is_its_forwards_vjp():
    """gradcheck in float64 on a routing with dropped choices, empty
    slots and a token whose two choices share an expert."""
    r = np.random.RandomState(8)
    e_n, cap, d = 3, 4, 5
    slot_of = torch.tensor([[0, 4, -1, 8, 1, 5], [2, -1, 9, 10, 3, 6]])
    slot_token = torch.full((e_n * cap,), -1, dtype=torch.long)
    for j in range(2):
        for t in range(6):
            if slot_of[j, t] >= 0:
                slot_token[slot_of[j, t]] = t
    eo = torch.from_numpy(r.standard_normal((e_n, cap, d))).requires_grad_()
    sw = torch.from_numpy(r.rand(e_n, cap)).requires_grad_()
    st = slot_token.view(e_n, cap)
    assert torch.autograd.gradcheck(
        lambda a, b: tmoe.moe_combine(a, b, slot_of, st), (eo, sw))
    y = tmoe.moe_combine(eo, sw, slot_of, st)
    dense = torch.zeros(6, e_n * cap, dtype=torch.float64)
    for j in range(2):
        for t in range(6):
            s = int(slot_of[j, t])
            if s >= 0:
                dense[t, s] = sw.reshape(-1)[s]
    want = torch.einsum("ecd,tec->td", eo, dense.view(6, e_n, cap))
    assert torch.allclose(y, want, rtol=0, atol=1e-12)


class _LargestTensor(TorchDispatchMode):
    """The largest number of elements of any tensor an op produced."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_dense_forms_no_dense_combine(top_k):
    """Forward and backward of moe_dense build no tensor as large as a
    [T, E, C] combine (every other tensor here is smaller)."""
    x, gw, wi, wo = map(torch.from_numpy, _inputs(4, seed=9))
    leaves = [t.clone().requires_grad_(True) for t in (x, gw, wi, wo)]
    cap = tmoe._capacity(T, 4, 1.25, top_k)
    with _LargestTensor() as watch:
        y, aux = tmoe.moe_dense(*leaves, top_k=top_k)
        torch.autograd.grad((y.sum() + aux), leaves)
    assert 0 < watch.largest < T * 4 * cap
