"""The op-test harness of the port's dense op corpus, modelled on
tests/op_test.py, and the checks of the registry and the harness itself.

Each case of tests/torch_op_cases.py runs three checks:

  1. `check_numpy`: the port's forward (float32, on the CPU) against the
     case's numpy reference, rtol 1e-5 and atol 1e-6 (integer and bool
     outputs exactly);
  2. `check_finite_differences`: the port's generic gradient (autograd
     over the lowering, `core/execution.generic_grad_lower`, the grad
     op's own path) against central finite differences of
     sum(out * cotangent), both in float64 on the CPU (eps 1e-6), rtol
     1e-6 and atol 1e-8;
  3. `check_jax`: the port's forward and generic gradient in float32
     against the JAX package's lowering (`paddle_tpu.core.registry` op
     info `.lower`, called directly) and `jax.vjp` over it, from the same
     numpy inputs and cotangents, rtol 1e-5 and atol 1e-6.

An input given as (array, lod) is a LoDTensor in both packages; each
output's LoD is held to the numpy reference's and the JAX lowering's,
and each gradient to its input's.  Cotangents are seeded per case.  Cases at a kink or a tie (`fd=False`)
skip check 2: there the JAX package's gradient is the reference.  Host
ops whose JAX lowering computes in numpy (`vjp=False`: the IfElse split
and merge) skip check 3's gradient, which jax.vjp cannot trace.  The
tests of each op family sit in tests/test_torch_ops_*.py, parametrised
over the cases, so that `--dist loadfile` spreads them.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.execution import data_of
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import GRAD
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import generic_grad_lower
from paddle_tpu_torch.core.lod import LoDTensor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_op_cases import CASES, rng  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FD_EPS, FD_RTOL, FD_ATOL = 1e-6, 1e-6, 1e-8

# the op types the dense corpus and the LoD slice add (every type with a
# case)
CORPUS = sorted({c.op for c in CASES})
LOD_TYPES = sorted({c.op for c in CASES
                    if c.op in ("lod_reset", "im2sequence", "edit_distance")
                    or c.op.startswith(("sequence_", "lstm", "gru"))})


# -- plumbing ----------------------------------------------------------------

def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _inputs(v):
    """A slot's inputs: a list of them, or one (an array, or an
    (array, lod) tuple)."""
    return v if isinstance(v, list) else [v]


def _arr(a):
    """The array of an input (an (array, lod) tuple's first item)."""
    return a[0] if isinstance(a, tuple) else a


def _lod(v):
    """The LoD of a value of either package, as lists; None without."""
    if isinstance(v, (LoDTensor, JLoDTensor)):
        return [list(level) for level in v.lod]
    if isinstance(v, tuple):
        return [list(level) for level in v[1]]
    return None


def data_of_port(v):
    return v.data if isinstance(v, LoDTensor) else v


def _attrs(info, case):
    return {**info.attrs, **case.attrs}


def _torch_ins(case, dtype=torch.float32):
    """{slot: [tensor]} with float inputs in `dtype`."""
    out = {}
    for slot, v in case.ins.items():
        vals = []
        for a in _inputs(v):
            t = torch.from_numpy(np.array(_arr(a)))
            t = t.to(dtype) if t.is_floating_point() else t
            vals.append(LoDTensor(t, a[1]) if isinstance(a, tuple) else t)
        out[slot] = vals
    return out


def _np(v):
    """A port tensor or JAX array -> numpy (bf16 read as float32; a
    LoDTensor's data)."""
    if isinstance(v, (LoDTensor, JLoDTensor, tuple)):
        v = v[0] if isinstance(v, tuple) else v.data
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _close(got, want, rtol, atol, what):
    assert _lod(got) == _lod(want), f"{what}: LoD {_lod(got)} != " \
                                    f"{_lod(want)}"
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != " \
                                    f"{want.shape}"
    if _is_float(want) or _is_float(got):
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64) if got.dtype
                                      != bool else got,
                                      want.astype(np.int64) if want.dtype
                                      != bool else want, err_msg=what)


def diff_slots(info, ins):
    """The input slots the generic gradient differentiates (its rule)."""
    if info.diff_inputs is not None:
        return [s for s in info.diff_inputs if s in ins]
    return [s for s in info.inputs if s in ins
            and all(_is_float(_arr(a)) for a in _inputs(ins[s]))]


def out_slots(info, outs):
    """The float outputs that take a cotangent."""
    slots = info.diff_outputs if info.diff_outputs is not None \
        else info.outputs
    return [s for s in slots if s in outs
            and all(_is_float(_np(v)) for v in _as_list(outs[s]))]


def has_gradient(case):
    """Whether the case has a gradient to check: a differentiable op with
    a float input slot it differentiates and a float output."""
    info = treg.get_op_info(case.op)
    if info.not_differentiable or case.random:
        return False
    outs = port_forward(case)
    return bool(diff_slots(info, case.ins)) and bool(out_slots(info, outs))


def port_forward(case, dtype=torch.float32):
    info = treg.get_op_info(case.op)
    return info.lower(TExecContext("cpu"), _torch_ins(case, dtype),
                      _attrs(info, case))


def cotangents(case):
    """{out slot: [numpy cotangent]}, seeded by the case."""
    info = treg.get_op_info(case.op)
    outs = port_forward(case)
    r = rng(case.name + "@cot")
    return {s: [r.standard_normal(tuple(v.shape)) for v in _as_list(outs[s])]
            for s in out_slots(info, outs)}


def port_gradient(case, cots, dtype=torch.float32):
    """The port's generic gradient: the "<type>_grad" op's slots fed to
    core/execution.generic_grad_lower -> {in slot: [grad]}."""
    info = treg.get_op_info(case.op)
    attrs = _attrs(info, case)
    ins = _torch_ins(case, dtype)
    outs = info.lower(TExecContext("cpu"), ins, attrs)
    g_ins = dict(ins)
    for s in info.outputs:
        if s in outs:
            g_ins[s] = _as_list(outs[s])
    for s, cs in cots.items():
        g_ins[s + GRAD] = [torch.from_numpy(np.array(c)).to(
            v.dtype if v.is_floating_point() else dtype)
            for c, v in zip(cs, [data_of_port(o) for o in _as_list(outs[s])])]
    res = generic_grad_lower(TExecContext("cpu"), g_ins, attrs, info)
    return {s[:-len(GRAD)]: v for s, v in res.items()}


# -- the three checks --------------------------------------------------------

def check_numpy(case):
    """Check 1: the port's float32 forward against the numpy reference."""
    outs = port_forward(case)

    def as64(a):
        x = np.asarray(_arr(a))
        x = x.astype(np.float64) if _is_float(x) else x
        return (x, a[1]) if isinstance(a, tuple) else x

    ins = {s: ([as64(a) for a in v] if isinstance(v, list) else as64(v))
           for s, v in case.ins.items()}
    info = treg.get_op_info(case.op)
    want = case.ref(ins, _attrs(info, case))
    for slot, w in want.items():
        for i, (g, wi) in enumerate(zip(_as_list(outs[slot]), _inputs(w))):
            _close(g, wi if isinstance(wi, tuple) else np.asarray(wi),
                   RTOL, ATOL, f"{case.name} {slot}[{i}] against numpy")


def check_finite_differences(case):
    """Check 2: the generic gradient against central differences of
    sum(out * cot) in float64."""
    info = treg.get_op_info(case.op)
    attrs = _attrs(info, case)
    cots = cotangents(case)
    grads = port_gradient(case, cots, torch.float64)
    base = _torch_ins(case, torch.float64)

    def loss(ins):
        outs = info.lower(TExecContext("cpu"), ins, attrs)
        total = 0.0
        for s, cs in cots.items():
            for v, c in zip(_as_list(outs[s]), cs):
                total += float((data_of_port(v).double()
                                * torch.from_numpy(c)).sum())
        return total

    for slot in diff_slots(info, case.ins):
        for i, t in enumerate(base[slot]):
            t = data_of_port(t)
            if not t.is_floating_point():
                continue
            num = np.zeros(tuple(t.shape))
            flat = t.reshape(-1)
            for k in range(flat.numel()):
                orig = float(flat[k])
                flat[k] = orig + FD_EPS
                up = loss(base)
                flat[k] = orig - FD_EPS
                down = loss(base)
                flat[k] = orig
                num.reshape(-1)[k] = (up - down) / (2 * FD_EPS)
            np.testing.assert_allclose(
                _np(grads[slot][i]), num, rtol=FD_RTOL, atol=FD_ATOL,
                err_msg=f"{case.name} d{slot}[{i}] against finite "
                        "differences")


def jax_lowering(case, cots=None):
    """The JAX package's lowering of the case -> (outputs {slot: [numpy]},
    gradients {slot: [numpy]} by jax.vjp when `cots` is given)."""
    jinfo = jreg.get_op_info(case.op)
    attrs = {**jinfo.attrs, **case.attrs}
    jins = {s: [JLoDTensor(jnp.asarray(a[0]), a[1]) if isinstance(a, tuple)
                else jnp.asarray(a) for a in _inputs(v)]
            for s, v in case.ins.items()}
    outs = jinfo.lower(JExecContext(), jins, attrs)
    outs = {s: _as_list(v) for s, v in outs.items() if v is not None}
    if cots is None:
        return outs, None
    tinfo = treg.get_op_info(case.op)
    slots = diff_slots(tinfo, case.ins)
    leaves = [(s, i) for s in slots for i, a in enumerate(jins[s])
              if jnp.issubdtype(a.dtype, jnp.floating)]

    def f(*vals):
        ins = {s: list(v) for s, v in jins.items()}
        for (s, i), v in zip(leaves, vals):
            x = ins[s][i]
            ins[s][i] = JLoDTensor(v, x.lod) if isinstance(x, JLoDTensor) \
                else v
        o = jinfo.lower(JExecContext(), ins, attrs)
        return tuple(data_of(x) for s in cots for x in _as_list(o[s]))

    prim, vjp = jax.vjp(f, *[data_of(jins[s][i]) for s, i in leaves])
    flat = [c for s in cots for c in cots[s]]
    got = vjp(tuple(jnp.asarray(c, p.dtype) for c, p in zip(flat, prim)))
    grads = {}
    for (s, i), g in zip(leaves, got):
        x = jins[s][i]   # the gradient carries its input's LoD
        grads.setdefault(s, {})[i] = (JLoDTensor(np.asarray(g), x.lod)
                                      if isinstance(x, JLoDTensor)
                                      else np.asarray(g))
    return outs, {s: [d[i] for i in sorted(d)] for s, d in grads.items()}


def check_jax(case):
    """Check 3: the port's float32 forward and generic gradient against
    the JAX lowering and jax.vjp, from the same inputs and cotangents
    (the forward alone where the JAX lowering is host numpy: `vjp`
    False)."""
    grad = has_gradient(case) and case.vjp
    cots = cotangents(case) if grad else None
    jouts, jgrads = jax_lowering(case, cots)
    touts = {s: v for s, v in port_forward(case).items() if v is not None}
    assert set(touts) == set(jouts), (case.name, set(touts), set(jouts))
    for slot, jv in jouts.items():
        tv = _as_list(touts[slot])
        assert len(tv) == len(jv), (case.name, slot)
        for i, (a, b) in enumerate(zip(tv, jv)):
            _close(a, b, RTOL, ATOL, f"{case.name} {slot}[{i}] against "
                                     "the JAX lowering")
    if not grad:
        return
    tgrads = port_gradient(case, cots)
    assert set(tgrads) == set(jgrads), (case.name, set(tgrads),
                                        set(jgrads))
    for slot, jg in jgrads.items():
        for i, (a, b) in enumerate(zip(tgrads[slot], jg)):
            _close(a, b, RTOL, ATOL,
                   f"{case.name} d{slot}[{i}] against jax.vjp")


def fd_cases(cases):
    return [c for c in cases if c.fd and has_gradient(c)]


def forward_cases(cases):
    return [c for c in cases if c.ref is not None]


def jax_cases(cases):
    return [c for c in cases if not c.random]


# -- the registry and the harness itself -------------------------------------

# the JAX package's op types the port does not register yet, by ROADMAP
# item: A11's distributed ops
NOT_PORTED = {
    "A11": ["listen_and_serv", "recv", "send"],
}


def test_the_corpus_is_the_jax_packages_dense_types():
    """133 op types: every type of the JAX package's activation,
    elementwise, matmul, reduce, manip, creation, loss, metrics and misc
    modules that needs no LoD, SelectedRows or sub-block (89), the 19
    LoD sequence and recurrent types, the IfElse split and merge with
    their gradient ops (4), the 3 CRF types, the 8 device types of CTC,
    the sampled losses and detection (warpctc, hsigmoid, nce,
    prior_box, box_coder, iou_similarity, target_assign, roi_pool), and
    the 10 conv types of tests/test_torch_ops_conv_rest.py.  The port
    registers 230 of the JAX package's 233 in all (with the nine
    optimizer types and split_selected_rows of
    tests/test_torch_optimizers.py, the control-flow types of
    tests/test_torch_control_flow.py, `recompute` of
    tests/test_torch_recompute.py, the detection host ops of
    tests/test_torch_detection.py, ctc_align, the readers, and the six
    io ops of tests/test_torch_io.py, and the seven c_* collectives of
    tests/test_torch_collective.py); the 3 it does not are NOT_PORTED's,
    by name."""
    assert len(CORPUS) == 133
    assert len(LOD_TYPES) == 19
    assert set(CORPUS) <= set(jreg.registered_ops())
    assert len(treg.registered_ops()) == 230
    assert len(jreg.registered_ops()) == 233
    assert set(treg.registered_ops()) <= set(jreg.registered_ops())
    missing = sorted(set(jreg.registered_ops()) - set(treg.registered_ops()))
    assert missing == sorted(n for ns in NOT_PORTED.values() for n in ns)
    assert len(missing) == 3


@pytest.mark.parametrize("op", CORPUS)
def test_registration_matches_the_jax_package(op):
    """Slots, attribute defaults, differentiable slots, in-place aliases
    and the random / host / not-differentiable flags as the JAX
    package registers them."""
    j, t = jreg.get_op_info(op), treg.get_op_info(op)
    for field in ("inputs", "outputs", "dup_inputs", "dup_outputs",
                  "attrs", "inplace", "random", "not_differentiable",
                  "host"):
        assert getattr(t, field) == getattr(j, field), field
    for field in ("diff_inputs", "diff_outputs"):
        jv, tv = getattr(j, field), getattr(t, field)
        assert (tuple(tv) if tv is not None else None) == \
               (tuple(jv) if jv is not None else None), field


def test_the_harness_catches_a_clamp_clip():
    """Mutation check of check 3: a `clip` lowered with torch.clamp (the
    port's lowering before this corpus) passes the numpy forward and
    fails against jax.vjp at its bounds."""
    from torch_op_cases import Case

    info = treg.get_op_info("clip")
    case = Case("clip.clamp", "clip",
                {"X": np.array([-1, 0, 1, 2], np.float32)},
                ref=lambda ins, a: {"Out": np.clip(ins["X"], -1, 1)},
                fd=False)
    lower = info.lower
    info.lower = lambda ctx, ins, attrs: {"Out": torch.clamp(
        ins["X"][0], attrs["min"], attrs["max"])}
    try:
        check_numpy(case)
        with pytest.raises(AssertionError, match="jax.vjp"):
            check_jax(case)
    finally:
        info.lower = lower
    check_jax(case)
