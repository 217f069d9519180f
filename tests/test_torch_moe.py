"""The port's MoE path against the JAX package, on the CPU.

Routing is integer arithmetic on the same float32 probabilities, so the
dispatch tensors must be equal; combine weights and the aux loss are
float32 sums taken in another order (1e-6 absolute).  The `moe_ffn`
op's generic gradient is held to `jax.vjp` of `moe_dense` with the
kernel tier off — the JAX package's Pallas kernel has no VJP, so that
is the only gradient it takes (1e-5 relative to the largest element:
the combine and expert einsums sum in another order).  The MoE LM of
benchmark/run_moe.py at a tiny width: the same Program, and 3 Momentum
steps from the JAX startup's parameters within 1e-5 relative.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.kernels.moe_dispatch import build_moe_gate_dispatch
from paddle_tpu.parallel import moe as jmoe

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext, generic_grad_lower
from paddle_tpu_torch.core.registry import get_op_info
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.kernels.moe_dispatch import (
    moe_dispatch_supports, moe_gate_dispatch, moe_gate_dispatch_reference,
    moe_gate_dispatch_vjp, moe_routing_reference)
from paddle_tpu_torch.models.moe import build_moe_lm
from paddle_tpu_torch.parallel import moe as tmoe

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark"))
import run_moe  # noqa: E402  (the JAX package's MoE LM builder)

T, D, E, H = 48, 16, 4, 32


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


def _inputs(seed=0, t=T):
    r = np.random.RandomState(seed)
    return (r.standard_normal((t, D)).astype(np.float32),
            (r.standard_normal((D, E)) * 0.5).astype(np.float32),
            (r.standard_normal((E, D, H)) * 0.2).astype(np.float32),
            (r.standard_normal((E, H, D)) * 0.2).astype(np.float32))


# capacity 4 of 48 tokens over 4 experts overflows; 40 does not
_GATE_CASES = [(1, 4), (1, 40), (2, 4), (2, 40)]


@pytest.mark.parametrize("top_k,cap", _GATE_CASES)
def test_moe_gate_matches_jax(top_k, cap):
    x, gw, _, _ = _inputs()
    jd, jc, ja = jmoe.moe_gate(jnp.asarray(x), jnp.asarray(gw), E, cap,
                               top_k)
    td, tc, ta = tmoe.moe_gate(torch.from_numpy(x), torch.from_numpy(gw), E,
                               cap, top_k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    kept = td.sum().item()
    assert (kept < T * top_k) == (cap == 4)


@pytest.mark.parametrize("top_k,cap", _GATE_CASES)
def test_moe_dense_and_drop_rate_match_jax(top_k, cap):
    x, gw, wi, wo = _inputs(1)
    jy, ja = jmoe.moe_dense(*map(jnp.asarray, (x, gw, wi, wo)), top_k=top_k,
                            capacity=cap)
    ty, ta = tmoe.moe_dense(*map(torch.from_numpy, (x, gw, wi, wo)),
                            top_k=top_k, capacity=cap)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)
    jdr = jmoe.drop_rate(jnp.asarray(x), jnp.asarray(gw), top_k=top_k,
                         capacity=cap, shards=2)
    tdr = tmoe.drop_rate(torch.from_numpy(x), torch.from_numpy(gw),
                         top_k=top_k, capacity=cap, shards=2)
    assert tdr["capacity"] == jdr["capacity"]
    for key in ("assignment_drop", "weight_drop"):
        assert abs(tdr[key] - jdr[key]) <= 1e-6, key
    jlb = jmoe.load_balance(jnp.asarray(x), jnp.asarray(gw))
    tlb = tmoe.load_balance(torch.from_numpy(x), torch.from_numpy(gw))
    np.testing.assert_allclose(tlb["frac"].numpy(), np.asarray(jlb["frac"]),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("top_k,cap", _GATE_CASES)
def test_plain_version_matches_the_jax_kernel_in_interpret_mode(top_k, cap):
    """moe_gate_dispatch_reference against the Pallas kernel itself."""
    x, gw, _, _ = _inputs(2)
    fused = build_moe_gate_dispatch(tokens=T, d_model=D, num_experts=E,
                                    capacity=cap, top_k=top_k,
                                    interpret=True)
    jei, jcb, jaux = fused(jnp.asarray(x), jnp.asarray(gw))
    tei, tcb, taux = moe_gate_dispatch_reference(
        torch.from_numpy(x), torch.from_numpy(gw), E, cap, top_k)
    np.testing.assert_array_equal(tei.numpy(), np.asarray(jei))
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=0,
                               atol=1e-6)
    # the wrapper runs the plain version for CPU tensors
    got = moe_gate_dispatch(torch.from_numpy(x), torch.from_numpy(gw), E,
                            cap, top_k)
    for a, b in zip(got, (tei, tcb, taux)):
        assert torch.equal(a, b)


def _cotangents(cap, seed):
    r = np.random.RandomState(seed)
    return (r.standard_normal((E, cap, D)).astype(np.float32),
            r.standard_normal((T, E, cap)).astype(np.float32),
            np.array([[0.7]], np.float32))


@pytest.mark.parametrize("top_k,cap", _GATE_CASES)
def test_kernel_backward_matches_the_jax_vjp(top_k, cap):
    """moe_gate_dispatch_vjp (the kernel Function's backward, at the
    routing the forward chose; here the plain version's) against jax.vjp
    of the JAX package's plain composition: moe_gate plus the dispatch
    einsum."""
    x, gw, _, _ = _inputs(6)
    cots = _cotangents(cap, 7)

    def f(x_, gw_):
        d, c, a = jmoe.moe_gate(x_, gw_, E, cap, top_k)
        return jnp.einsum("td,tec->ecd", x_, d), c, jnp.reshape(a, (1, 1))

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(gw))
    want = vjp(tuple(map(jnp.asarray, cots)))
    tx, tg = torch.from_numpy(x), torch.from_numpy(gw)
    routing = moe_routing_reference(tx, tg, E, cap, top_k)
    got = moe_gate_dispatch_vjp(tx, tg, *routing,
                                *map(torch.from_numpy, cots))
    for name, g, w in zip(("dx", "dgate_w"), got, want):
        w = np.asarray(w)
        lim = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= lim, name


@pytest.mark.parametrize("case", ["ties", "saturated"])
def test_kernel_backward_at_ties_and_a_saturated_router(case):
    """Experts 1 and 2 tied for every token; or a router so sharp that
    the other probabilities underflow to zero and a token's second
    choice coincides with its first.  The VJP at the plain routing
    against autograd of the plain version (1e-6 relative), and the
    cotangents left out count as zeros."""
    x, gw, _, _ = _inputs(8)
    if case == "ties":
        gw[:, 2] = gw[:, 1]
    else:
        gw *= 400.0
    cap = 20
    tx, tg = torch.from_numpy(x), torch.from_numpy(gw)
    probs, idx, slots = moe_routing_reference(tx, tg, E, cap, 2)
    if case == "saturated":
        assert bool((idx[0] == idx[1]).any())
    cots = [torch.from_numpy(c) for c in _cotangents(cap, 9)]
    leaves = [t.clone().requires_grad_(True) for t in (tx, tg)]
    want = torch.autograd.grad(
        moe_gate_dispatch_reference(*leaves, E, cap, 2), leaves, cots)
    got = moe_gate_dispatch_vjp(tx, tg, probs, idx, slots, *cots)
    for g, w in zip(got, want):
        lim = 1e-6 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= lim
    only_aux = moe_gate_dispatch_vjp(tx, tg, probs, idx, slots, None, None,
                                     cots[2])
    want_aux = torch.autograd.grad(
        moe_gate_dispatch_reference(*leaves, E, cap, 2)[2], leaves, cots[2])
    for g, w in zip(only_aux, want_aux):
        assert float((g - w).abs().max()) <= 1e-6 * max(
            1.0, float(w.abs().max()))


def _op_ins(x, gw, wi, wo):
    return {"X": [torch.from_numpy(x.reshape(2, T // 2, D))],
            "GateW": [torch.from_numpy(gw)], "WIn": [torch.from_numpy(wi)],
            "WOut": [torch.from_numpy(wo)]}


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_generic_gradient_matches_jax_vjp(top_k):
    x, gw, wi, wo = _inputs(3)
    r = np.random.RandomState(4)
    dy = r.standard_normal((2, T // 2, D)).astype(np.float32)
    daux = np.array([0.7], np.float32)
    attrs = {"top_k": top_k, "capacity_factor": 1.0}
    info = get_op_info("moe_ffn")
    jinfo = jfluid.core.registry.get_op_info("moe_ffn")
    assert (info.inputs, info.outputs, info.attrs) == \
        (jinfo.inputs, jinfo.outputs, jinfo.attrs)
    assert (info.diff_inputs, info.diff_outputs) == \
        (jinfo.diff_inputs, jinfo.diff_outputs)
    ins = _op_ins(x, gw, wi, wo)
    outs = info.lower(ExecContext("cpu"), ins, attrs)
    grad_ins = {**ins, "Out": [outs["Out"]], "AuxLoss": [outs["AuxLoss"]],
                "Out@GRAD": [torch.from_numpy(dy)],
                "AuxLoss@GRAD": [torch.from_numpy(daux)]}
    grads = generic_grad_lower(ExecContext("cpu"), grad_ins, attrs, info)

    def f(x_, gw_, wi_, wo_):
        y, aux = jmoe.moe_dense(x_.reshape(T, D), gw_, wi_, wo_, top_k=top_k,
                                capacity_factor=1.0)
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
    for slot, want in zip(("X", "GateW", "WIn", "WOut"), jgrads):
        got = grads[slot + "@GRAD"][0].numpy()
        want = np.asarray(want).reshape(got.shape)
        lim = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= lim, slot


def test_armed_tier_on_the_cpu_and_counted_fallback():
    """"on" arms the kernel tier everywhere: a float32 call picks the
    kernel (its wrapper runs the plain version for CPU tensors) and
    gives the disarmed result bit for bit; a bfloat16 call is a counted
    fallback ("dtype"), reclaimed on close."""
    x, gw, wi, wo = map(torch.from_numpy, _inputs(5))
    want = tmoe.moe_dense(x, gw, wi, wo, top_k=2)
    tflags.set_flags({"serving_kernels": "on"})
    sel = kreg.Selection()
    got = tmoe.moe_dense(x, gw, wi, wo, top_k=2, selection=sel)
    assert sel.chosen["moe_gate_dispatch"] == "cuda"
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tmoe.moe_dense(*(t.bfloat16() for t in (x, gw, wi, wo)), top_k=2,
                   selection=sel)
    assert sel.chosen["moe_gate_dispatch"] == "plain:dtype"
    labels = [lb for lb, _ in kreg._M_FALLBACKS.samples()]
    assert {"kernel": "moe_gate_dispatch", "reason": "dtype"} in labels
    sel.close()
    assert {"kernel": "moe_gate_dispatch", "reason": "dtype"} not in \
        [lb for lb, _ in kreg._M_FALLBACKS.samples()]
    assert moe_dispatch_supports(tokens=4096, d_model=1024, num_experts=8,
                                 capacity=1280, top_k=2) is None
    assert moe_dispatch_supports(tokens=8, d_model=4, num_experts=4,
                                 capacity=2, top_k=3) == "top_k"


def test_require_is_the_kernel_whatever_the_flag_says():
    """Selection.require serves the card, where the port has no plain
    path: "off" does not disarm the kernel, and a call it does not take
    raises, naming the reason, instead of counting a fallback."""
    ctx = dict(tokens=64, d_model=32, num_experts=4, capacity=16, top_k=2)
    tflags.set_flags({"serving_kernels": "off"})
    sel = kreg.Selection()
    assert callable(sel.require("moe_gate_dispatch", dtype="float32", **ctx))
    assert sel.chosen["moe_gate_dispatch"] == "cuda"
    for dtype, reason in (("bfloat16", "dtype"), ("float32", "num_experts")):
        bad = dict(ctx, num_experts=65) if reason == "num_experts" else ctx
        with pytest.raises(ValueError, match=reason):
            sel.require("moe_gate_dispatch", dtype=dtype, **bad)
    assert sel._counted == []


# -- the MoE LM of benchmark/run_moe.py --------------------------------------

LM = dict(batch=2, seq=8, vocab=31, d_model=32, n_heads=2, n_layers=2,
          experts=4, top_k=2, capacity_factor=1.25)


def _int_as_int32(d):
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int64":
                v["dtype"] = "int32"
    return d


def _lm_feed(step):
    r = np.random.RandomState(10 + step)
    ids = r.randint(0, LM["vocab"], (LM["batch"], LM["seq"]))
    return {"ids": ids.astype(np.int64),
            "lbl": np.roll(ids, -1, axis=1)[..., None].astype(np.int64)}


def test_moe_lm_program_and_training_match_jax():
    jfw.reset_unique_names()
    jm, js, jl = run_moe.build_moe_lm(**LM)
    tfw.reset_unique_names()
    tm, ts, tl = build_moe_lm(**LM)
    assert _int_as_int32(tm.to_dict()) == _int_as_int32(jm.to_dict())
    assert _int_as_int32(ts.to_dict()) == _int_as_int32(js.to_dict())
    assert [op.type for op in tm.global_block().ops].count("moe_ffn_grad") \
        == LM["n_layers"]

    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js)
    names = sorted(v.name for v in jm.list_vars() if v.persistable)
    jvals = {n: np.asarray(jexecutor.global_scope().find_var(n))
             for n in names}
    texe = tfluid.Executor(CPUPlace())
    texe.run(ts)
    scope_from_numpy(jvals, CPUPlace(), tfluid.global_scope())
    jloss, tloss = [], []
    for step in range(3):
        feed = _lm_feed(step)
        jloss.append(float(jexe.run(jm, feed=feed, fetch_list=[jl])[0][0]))
        tloss.append(float(texe.run(tm, feed=feed, fetch_list=[tl])[0][0]))
    assert np.all(np.isfinite(tloss))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5, atol=0)
    # the for_test clone's forward on both sides
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    feed = _lm_feed(3)
    jv = jexe.run(jtest, feed=feed, fetch_list=[jl])[0]
    tv = texe.run(ttest, feed=feed, fetch_list=[tl])[0]
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=0)
