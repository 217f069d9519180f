"""The rest of the conv ops beyond the op-test harness, on the CPU: the
max pools' gradients against jax.vjp, row_conv's per-sequence window,
the layers, the explicit convolution gradients and amp, and a small
DCGAN (chip_smoke.py's `_dcgan_programs` at 16x16, widths 8/16) trained
in the port and in the JAX package.

Tolerances: float32 within 1e-5 of max(1, max|JAX|) (the libraries'
convolutions sum in other orders); the DCGAN's two iterations within
1e-5 relative in every loss and 1e-5 of max(1, |JAX|) in every
persistable; bf16 outputs under amp within one bf16 ulp of max|JAX|.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import amp as jamp
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import GRAD, generic_grad_lower
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy, \
    scope_to_numpy

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
from test_torch_training import _assert_same_program  # noqa: E402

TOL = 1e-5
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    jfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _port(op, ins, attrs, ctx=None):
    info = treg.get_op_info(op)
    return info.lower(ctx or TExecContext("cpu"), ins, {**info.attrs,
                                                        **attrs})


def _jax(op, ins, attrs):
    info = jreg.get_op_info(op)
    return info.lower(JExecContext(), ins, {**info.attrs, **attrs})


# -- the max pools' gradients ------------------------------------------------

POOLS = [
    ("max_pool2d_with_index", "pool2d", (2, 3, 7, 6),
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, False),
    ("max_pool2d_with_index", "pool2d", (2, 3, 7, 6),
     {"ksize": [2, 3], "strides": [2, 3]}, True),
    ("max_pool3d_with_index", "pool3d", (1, 2, 5, 4, 6),
     {"ksize": [2, 3, 3], "strides": [1, 2, 2], "paddings": [1, 1, 0]},
     True),
    ("max_pool3d_with_index", "pool3d", (2, 2, 4, 4, 4),
     {"ksize": [2, 2, 2], "strides": [2, 2, 2]}, False),
]


@pytest.mark.parametrize("op,plain,shape,attrs,ties", POOLS)
def test_max_pool_with_index_gradient_is_jax_vjp_of_the_max_pool(
        op, plain, shape, attrs, ties):
    """The JAX package cannot differentiate its variadic reduce_window
    (the value-and-index pool); its Out is the max pool's, so the port's
    gradient is held to jax.vjp of the JAX package's pool2d / pool3d
    with the same windows (ties included: the first maximum in window
    order takes the cotangent on both sides)."""
    r = np.random.RandomState(11)
    x = (r.randint(0, 3, shape) if ties else r.standard_normal(shape)
         ).astype(np.float32)
    out = _port(op, {"X": [torch.from_numpy(x)]}, attrs)
    cot = r.standard_normal(tuple(out["Out"].shape)).astype(np.float32)
    info = treg.get_op_info(op)
    got = generic_grad_lower(TExecContext("cpu"), {
        "X": [torch.from_numpy(x)], "Out": [out["Out"]],
        "Mask": [out["Mask"]], "Out" + GRAD: [torch.from_numpy(cot)]},
        {**info.attrs, **attrs}, info)["X" + GRAD][0]
    jattrs = {**attrs, "pooling_type": "max"}
    y, vjp = jax.vjp(lambda v: _jax(plain, {"X": [v]}, jattrs)["Out"],
                     jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(y), out["Out"].numpy())
    _close(got.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))


def test_max_pool_backward_of_disjoint_and_overlapping_windows_agree():
    """The copy (disjoint windows) and the sorted segment sum
    (overlapping) routes of `_MaxPool.backward` give the same gradient
    where both apply: stride == ksize taken once as each."""
    from paddle_tpu_torch.ops.conv import _MaxPool

    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (2, 3, 6, 8)).astype(np.float32)).requires_grad_(True)
    vals, _ = _MaxPool.apply(x, (2, 2), (2, 2), (0, 0))
    g = torch.randn(vals.shape, generator=torch.Generator().manual_seed(1))
    a, = torch.autograd.grad(vals, x, g)
    class Ctx:
        def save_for_backward(self, *t):
            self.saved_tensors = t

        def mark_non_differentiable(self, *t):
            pass

    ctx = Ctx()
    _MaxPool.forward(ctx, x.detach(), (2, 2), (2, 2), (0, 0))
    assert ctx.disjoint
    ctx.disjoint = False
    b = _MaxPool.backward(ctx, g, None)[0]
    assert torch.equal(a, b)


# -- row_conv ----------------------------------------------------------------

def test_row_conv_lod_windows_stop_at_each_sequences_end():
    """x = arange(10).reshape(5, 2), LoD [[0, 3, 5]], a lookahead of 1
    (filter all ones): Paddle's row_conv_op gives row 2 = x2 = [4, 5];
    the JAX package reads on into the next sequence's first row and gives
    x2 + x3 = [10, 12] (ROADMAP Queue C).  Every other row agrees."""
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    w = np.ones((2, 2), np.float32)
    lod = [[0, 3, 5]]
    got = _port("row_conv", {"X": [LoDTensor(torch.from_numpy(x), lod)],
                             "Filter": [torch.from_numpy(w)]}, {})["Out"]
    jout = _jax("row_conv", {"X": [JLoDTensor(jnp.asarray(x), lod)],
                             "Filter": [jnp.asarray(w)]}, {})["Out"]
    assert got.lod == ((0, 3, 5),)
    np.testing.assert_array_equal(got.data.numpy()[2], [4, 5])
    np.testing.assert_array_equal(np.asarray(jout.data)[2], [10, 12])
    want = np.array([[2, 4], [6, 8], [4, 5], [14, 16], [8, 9]], np.float32)
    np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(np.delete(np.asarray(jout.data), 2, 0),
                                  np.delete(want, 2, 0))


@pytest.mark.parametrize("kind", ["dense", "one_sequence"])
def test_row_conv_agrees_with_jax_on_dense_and_one_sequence_inputs(kind):
    """Without a sequence boundary inside the input the two packages'
    windows are the same: values and gradients bit for bit."""
    r = np.random.RandomState(5)
    shape = (3, 6, 4) if kind == "dense" else (7, 4)
    x = r.standard_normal(shape).astype(np.float32)
    w = r.standard_normal((3, 4)).astype(np.float32)
    cot = r.standard_normal(shape).astype(np.float32)
    lod = None if kind == "dense" else [[0, 7]]

    def wrap_t(v):
        return LoDTensor(v, lod) if lod else v

    def wrap_j(v):
        return JLoDTensor(v, lod) if lod else v

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = _port("row_conv", {"X": [wrap_t(xt)], "Filter": [wt]}, {})["Out"]
    out = out.data if lod else out
    gx, gw = torch.autograd.grad(out, [xt, wt], torch.from_numpy(cot))

    def f(xv, wv):
        o = _jax("row_conv", {"X": [wrap_j(xv)], "Filter": [wv]}, {})["Out"]
        return o.data if lod else o

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    _close(gx.numpy(), np.asarray(jgx))
    _close(gw.numpy(), np.asarray(jgw))


# -- layers ------------------------------------------------------------------

def _layers_program(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4, 5, 5], dtype="float32")
        a = fluid.layers.conv2d_transpose(x, 3, output_size=11, stride=2,
                                          act="relu")
        b = fluid.layers.conv2d_transpose(x, 2, filter_size=[3, 2],
                                          padding=[1, 0], dilation=2)
        s = fluid.layers.data(name="s", shape=[6], dtype="float32",
                              lod_level=1)
        c = fluid.layers.row_conv(s, future_context_size=2, act="tanh")
    return main, startup, (a, b, c)


def test_layers_build_the_jax_packages_programs_and_run_like_it():
    """conv2d_transpose (filter size from output_size, and given) and
    row_conv: the Program dicts equal the JAX package's, the inferred
    shapes included, and a run from the JAX startup's parameters gives
    its outputs."""
    jmain, jstart, jouts = _layers_program(jfluid, jfw)
    tmain, tstart, touts = _layers_program(tfluid, tfw)
    _assert_same_program(jmain, tmain)
    _assert_same_program(jstart, tstart)
    assert tuple(touts[0].shape) == (-1, 3, 11, 11)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart)
    params = [p.name for p in jmain.global_block().all_parameters()]
    scope_from_numpy({n: np.asarray(jexecutor.global_scope().find_var(n))
                      for n in params}, CPU, tfluid.global_scope())
    r = np.random.RandomState(0)
    x = r.standard_normal((2, 4, 5, 5)).astype(np.float32)
    s = r.standard_normal((5, 6)).astype(np.float32)
    lod = [[0, 5]]
    want = jexe.run(jmain, feed={"x": x, "s": JLoDTensor(s, lod)},
                    fetch_list=list(jouts))
    got = tfluid.Executor(CPU).run(tmain, feed={
        "x": x, "s": LoDTensor(s, lod)}, fetch_list=list(touts))
    for g, w in zip(got, want):
        g = g.data if isinstance(g, LoDTensor) else g
        w = w.data if isinstance(w, JLoDTensor) else w
        _close(g, w)


# -- the convolutions' explicit gradients and amp -----------------------------

CONVS = [
    ("conv3d", (2, 4, 5, 6, 5), (6, 2, 3, 2, 3),
     {"strides": [1, 2, 1], "paddings": [1, 0, 1], "groups": 2}),
    ("conv2d_transpose", (2, 3, 5, 4), (3, 4, 3, 3),
     {"strides": [2, 1], "paddings": [1, 1], "dilations": [1, 2]}),
    ("conv3d_transpose", (1, 3, 3, 4, 3), (3, 2, 2, 2, 2),
     {"strides": [2, 2, 2]}),
]


@pytest.mark.parametrize("op,xs,ws,attrs", CONVS, ids=[c[0] for c in CONVS])
def test_explicit_conv_gradient_equals_autograd_through_the_pinned_conv(
        op, xs, ws, attrs):
    """The grad op's explicit lowering (`convolution_backward`, no
    forward re-run) against the generic gradient (autograd through
    `_PinnedConv`): bit-equal; and within 1e-5 of jax.vjp."""
    r = np.random.RandomState(1)
    x, w = (r.standard_normal(xs).astype(np.float32),
            r.standard_normal(ws).astype(np.float32))
    out = _port(op, {"Input": [torch.from_numpy(x)],
                     "Filter": [torch.from_numpy(w)]}, attrs)["Output"]
    cot = r.standard_normal(tuple(out.shape)).astype(np.float32)
    info = treg.get_op_info(op)
    g_ins = {"Input": [torch.from_numpy(x)], "Filter": [torch.from_numpy(w)],
             "Output": [out], "Output" + GRAD: [torch.from_numpy(cot)]}
    merged = {**info.attrs, **attrs}
    explicit = info.grad_lower(TExecContext("cpu"), g_ins, merged)
    generic = generic_grad_lower(TExecContext("cpu"), g_ins, merged, info)
    y, vjp = jax.vjp(lambda a, b: _jax(op, {"Input": [a], "Filter": [b]},
                                       attrs)["Output"],
                     jnp.asarray(x), jnp.asarray(w))
    _close(out.numpy(), np.asarray(y))
    for slot, jg in zip(("Input", "Filter"), vjp(jnp.asarray(cot))):
        e, g = explicit[slot + GRAD][0], generic[slot + GRAD][0]
        assert torch.equal(e, g), slot
        _close(e.numpy(), np.asarray(jg), what=slot)


@pytest.mark.parametrize("op,xs,ws,attrs", CONVS, ids=[c[0] for c in CONVS])
def test_amp_convolutions_run_in_bf16_like_the_jax_package(op, xs, ws,
                                                           attrs):
    """Under bf16 amp both packages cast the operands to bf16 and return
    bf16; the port's output is within one bf16 ulp of max|JAX|."""
    r = np.random.RandomState(3)
    x, w = (r.standard_normal(xs).astype(np.float32),
            r.standard_normal(ws).astype(np.float32))
    with tamp.bf16_guard():
        got = _port(op, {"Input": [torch.from_numpy(x)],
                         "Filter": [torch.from_numpy(w)]}, attrs)["Output"]
    with jamp.bf16_guard():
        want = _jax(op, {"Input": [jnp.asarray(x)],
                         "Filter": [jnp.asarray(w)]}, attrs)["Output"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert float(np.abs(got.float().numpy() - want).max()) <= ulp


def test_unpool_takes_the_last_write_and_gathers_its_gradient():
    """Overlapping windows name one output twice: the later input element
    is written (the JAX scatter's order), and only it gets that output's
    cotangent; a negative index counts from the end."""
    x = torch.tensor([[[[1.0, 2.0], [3.0, 4.0]]]], requires_grad=True)
    idx = torch.tensor([[[[3, 3], [-1, 0]]]])
    out = _port("unpool", {"X": [x], "Indices": [idx]}, {})["Out"]
    flat = out.detach().reshape(-1)
    assert flat[3] == 2.0 and flat[15] == 3.0 and flat[0] == 4.0
    g, = torch.autograd.grad(out, x, torch.arange(16.0).reshape(out.shape))
    np.testing.assert_array_equal(g.numpy().reshape(-1), [0, 3, 15, 0])


# -- DCGAN -------------------------------------------------------------------

SMALL = dict(z_dim=8, img=16, g_widths=(16, 8), d_widths=(8, 16))


def test_small_dcgan_trains_like_the_jax_package():
    """chip_smoke's `_dcgan_programs` at 16x16 in both packages: the same
    three Programs, and two alternating iterations (G's fake batch, D's
    step, G's step) from the JAX startup's values give the JAX
    package's losses and every persistable within 1e-5."""
    jprogs = chip_smoke._dcgan_programs(jfluid, jfw, **SMALL)
    tprogs = chip_smoke._dcgan_programs(tfluid, tfw, **SMALL)
    for jp, tp in zip(jprogs[:4], tprogs[:4]):
        _assert_same_program(jp, tp)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jprogs[0])
    names = sorted({v.name for p in jprogs[1:4] for v in p.list_vars()
                    if v.persistable})
    texe = tfluid.Executor(CPU)
    texe.run(tprogs[0])
    scope_from_numpy({n: np.asarray(jexecutor.global_scope().find_var(n))
                      for n in names}, CPU, tfluid.global_scope())
    batches = chip_smoke._dcgan_batches(2, 4, z_dim=SMALL["z_dim"],
                                        img=SMALL["img"])
    for b in batches:
        jl = chip_smoke._dcgan_iteration(jexe, jprogs, b)
        tl = chip_smoke._dcgan_iteration(texe, tprogs, b)
        np.testing.assert_allclose(tl, jl, rtol=TOL)
    got = scope_to_numpy(tfluid.global_scope(), names)
    for n in names:
        _close(got[n], np.asarray(jexecutor.global_scope().find_var(n)),
               what=n)
