"""The conv-net ops of the port against the JAX package's lowerings, on
the CPU: conv2d and depthwise_conv2d, pool2d, batch_norm, dropout (test
mode), top_k and accuracy, forward and gradient.

The same seeded numpy inputs go through the JAX op's lowering and the
port's; every output slot is compared.  Tolerances, set from the dtype:

  * float32: within 1e-5 of max(1, max|JAX|) (1e-4 for conv2d and its
    gradients: another library's convolution sums in another order);
  * bfloat16: each element within one bf16 ulp of the larger of the two
    values (both libraries accumulate in float32 and round once; they
    differ where their float32 sums round to neighbouring bf16 values).
    Gradients in bf16 are held within 2 bf16 ulps of max|ref|, ref the
    JAX VJP over the same bf16 values computed in float32: the port sums
    in float32 and rounds once.  The JAX VJP run in bf16 is not the
    reference there: it sums the per-channel reductions (dScale, dBias)
    in bf16, rounding every partial sum, and lands 2-10 ulps from the
    float32 sum over 120 elements a channel.

The explicit `conv2d` and `batch_norm` gradients (the port's
`register_grad_lower`, no forward recompute) and the generic `pool2d`
gradient (autograd over the forward lowering) are held to `jax.vjp` of
the JAX lowering (its generic gradient).  Max pooling at a tied window:
both sides give the whole cotangent to the FIRST maximal element in
row-major window order (XLA's select-and-scatter keeps the first
element that `>=` every later one; torch's argmax keeps the first
maximum), so the gradients are equal bit for bit there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.core.registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.execution import generic_grad_lower as jgrad

import paddle_tpu_torch.core.registry as treg
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import generic_grad_lower as tgrad

F32_TOL, CONV_TOL, BF16_GRAD_ULPS = 1e-5, 1e-4, 2


@pytest.fixture(autouse=True)
def _fresh_flags():
    tflags.reset_flags()
    yield
    tflags.reset_flags()


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(jnp.asarray(v, jnp.float32)
                      if jnp.asarray(v).dtype == jnp.bfloat16 else v)


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else a.dtype)


def _ins(arrays, dtype, to):
    """{slot: array} -> {slot: [value]}; float arrays in `dtype`."""
    return {s: [to(a, dtype if a.dtype == np.float32 else None)]
            for s, a in arrays.items()}


def _forward(op, arrays, attrs, dtype="float32"):
    """-> (JAX outputs, port outputs) of `op` on the same inputs."""
    jinfo, tinfo = jreg.get_op_info(op), treg.get_op_info(op)
    jout = jinfo.lower(JExecContext(), _ins(arrays, dtype, _jax),
                       {**jinfo.attrs, **attrs})
    tout = tinfo.lower(TExecContext("cpu"), _ins(arrays, dtype, _torch),
                       {**tinfo.attrs, **attrs})
    return jout, tout


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _ulp(v):
    top = np.where(v > 0, v, 1.0)
    return np.where(v > 0, 2.0 ** (np.floor(np.log2(top)) - 7), 0.0)


def _assert_close(t, j, dtype, tol, what):
    t, j = _np(_first(t)), _np(_first(j))
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if dtype == "bfloat16":
        top = np.maximum(np.abs(t), np.abs(j))
        assert np.all(np.abs(t - j) <= _ulp(top)), what
    else:
        np.testing.assert_allclose(
            t, j, rtol=0, atol=tol * max(1.0, float(np.abs(j).max())),
            err_msg=what)


def _assert_all_slots(jout, tout, dtype, tol):
    assert set(tout) == set(jout)
    for slot in jout:
        jv, tv = _first(jout[slot]), _first(tout[slot])
        assert str(_np(tv).dtype) == str(_np(jv).dtype) or \
            _np(jv).dtype.kind == _np(tv).dtype.kind, slot
        _assert_close(tv, jv, dtype, tol, slot)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


# -- conv2d ------------------------------------------------------------------

CONV_CASES = [  # (op, x shape, w shape, strides, paddings, dilations, groups, layout)
    ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), [1, 1], [1, 1], [1, 1], 1, "NCHW"),
    ("conv2d", (2, 3, 11, 10), (5, 3, 7, 7), [2, 2], [3, 3], [1, 1], 1,
     "NCHW"),                                     # ResNet's stem
    ("conv2d", (2, 4, 8, 8), (6, 4, 1, 1), [2, 2], [0, 0], [1, 1], 1,
     "NCHW"),                                     # a 1x1 stride-2 shortcut
    ("conv2d", (2, 4, 9, 8), (4, 4, 3, 2), [1, 2], [2, 1], [2, 1], 1,
     "NCHW"),                                     # dilated, asymmetric
    ("conv2d", (2, 6, 8, 8), (6, 2, 3, 3), [1, 1], [1, 1], [1, 1], 3,
     "NCHW"),                                     # grouped
    ("depthwise_conv2d", (2, 4, 8, 8), (4, 1, 3, 3), [1, 1], [1, 1],
     [1, 1], 4, "NCHW"),
    ("depthwise_conv2d", (2, 4, 8, 8), (4, 4, 3, 3), [1, 1], [1, 1],
     [1, 1], 1, "NCHW"),                          # groups 1: a plain conv
    ("conv2d", (2, 9, 9, 3), (4, 3, 3, 3), [2, 2], [1, 1], [1, 1], 1,
     "NHWC"),
    ("conv2d", (2, 8, 8, 6), (6, 2, 3, 3), [1, 1], [1, 1], [1, 1], 3,
     "NHWC"),
]


def _conv_case(case, seed=0):
    op, xs, ws, s, p, d, g, layout = case
    arrays = {"Input": _rand(xs, seed), "Filter": _rand(ws, seed + 1)}
    attrs = {"strides": s, "paddings": p, "dilations": d, "groups": g,
             "data_format": layout}
    return op, arrays, attrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=range(len(CONV_CASES)))
def test_conv_forward_matches_jax(case, dtype):
    op, arrays, attrs = _conv_case(case)
    jout, tout = _forward(op, arrays, attrs, dtype)
    _assert_all_slots(jout, tout, dtype, CONV_TOL)
    assert _first(tout["Output"]).dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("case", [c for c in CONV_CASES if c[-1] == "NCHW"],
                         ids=range(7))
def test_conv_layout_flag_nhwc_equals_nchw(case):
    """conv_layout=NHWC runs an NCHW conv channels-last: the same values
    as the declared layout and as the JAX package, forward and
    gradient; the output stays channels-last in memory."""
    op, arrays, attrs = _conv_case(case)
    info = treg.get_op_info(op)
    ins = _ins(arrays, "float32", _torch)
    ref = info.lower(TExecContext("cpu"), ins, {**info.attrs, **attrs})
    dy = torch.from_numpy(_rand(tuple(ref["Output"].shape), 7))
    gins = {**ins, "Output": [ref["Output"]], "Output@GRAD": [dy]}
    ref_g = info.grad_lower(TExecContext("cpu"), gins,
                            {**info.attrs, **attrs})
    tflags.set_flags({"conv_layout": "NHWC"})
    out = info.lower(TExecContext("cpu"), ins, {**info.attrs, **attrs})
    got_g = info.grad_lower(TExecContext("cpu"), gins,
                            {**info.attrs, **attrs})
    assert out["Output"].is_contiguous(memory_format=torch.channels_last)
    _assert_close(out["Output"], ref["Output"], "float32", CONV_TOL, "out")
    jout, _ = _forward(op, arrays, attrs)
    _assert_close(out["Output"], jout["Output"], "float32", CONV_TOL, "jax")
    for slot in ("Input@GRAD", "Filter@GRAD"):
        _assert_close(got_g[slot], ref_g[slot], "float32", CONV_TOL, slot)


def _grad_both(op, arrays, attrs, dtype, cot_slot, seed=11):
    """The JAX generic gradient (jax.vjp of its lowering) and the port's
    registered gradient (explicit, or its generic one) of `op`: the grad
    op's inputs are the forward's (float ones in `dtype`), the JAX
    lowering's outputs (in their own dtypes) and one seeded cotangent of
    `cot_slot` (in its dtype)."""
    jinfo, tinfo = jreg.get_op_info(op), treg.get_op_info(op)
    jattrs, tattrs = {**jinfo.attrs, **attrs}, {**tinfo.attrs, **attrs}
    fwd = {s: _first(v) for s, v in jinfo.lower(
        JExecContext(), _ins(arrays, dtype, _jax), jattrs).items()}
    typed = {s: (a, dtype if a.dtype == np.float32 else None)
             for s, a in arrays.items()}
    for s, v in fwd.items():
        typed[s] = (_np(v), "bfloat16" if v.dtype == jnp.bfloat16 else None)
    typed[cot_slot + "@GRAD"] = (_rand(fwd[cot_slot].shape, seed),
                                 typed[cot_slot][1])
    jins = {s: [_jax(a, d)] for s, (a, d) in typed.items()}
    tins = {s: [_torch(a, d)] for s, (a, d) in typed.items()}
    jg = jgrad(JExecContext(), jins, jattrs, jinfo)
    if tinfo.grad_lower is not None:
        tg = tinfo.grad_lower(TExecContext("cpu"), tins, tattrs)
    else:
        tg = tgrad(TExecContext("cpu"), tins, tattrs, tinfo)
    # bf16: the JAX VJP again, in float32 over the same (bf16) values
    ref = None if dtype != "bfloat16" else jgrad(
        JExecContext(), {s: [jnp.asarray(_np(v[0]))]
                         for s, v in jins.items()}, jattrs, jinfo)
    return jg, tg, ref


def _max_ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _assert_grads(jg, tg, ref, dtype, tol):
    assert set(tg) == set(jg)
    for slot in jg:
        j, t = _np(_first(jg[slot])), _first(tg[slot])
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32), slot
        t = _np(t)
        assert t.shape == j.shape, slot
        if dtype == "bfloat16":
            r = _np(_first(ref[slot]))
            assert np.abs(t - r).max() <= BF16_GRAD_ULPS * _max_ulp(r), slot
        else:
            np.testing.assert_allclose(
                t, j, rtol=0, atol=tol * max(1.0, float(np.abs(j).max())),
                err_msg=slot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=range(len(CONV_CASES)))
def test_conv_explicit_grad_matches_jax_vjp(case, dtype):
    op, arrays, attrs = _conv_case(case)
    assert treg.get_op_info(op).grad_lower is not None
    jg, tg, ref = _grad_both(op, arrays, attrs, dtype, "Output")
    assert set(tg) == {"Input@GRAD", "Filter@GRAD"}
    _assert_grads(jg, tg, ref, dtype, CONV_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=range(len(CONV_CASES)))
def test_conv_autograd_grad_is_the_explicit_grad(case, dtype):
    """Autograd through the conv lowering (a recompute segment's
    gradient, the generic gradient) runs the explicit gradient's
    `convolution_backward` on the same backend: the same bits."""
    op, arrays, attrs = _conv_case(case)
    tinfo = treg.get_op_info(op)
    tattrs = {**tinfo.attrs, **attrs}
    ins = {s: [_torch(a, dtype)] for s, a in arrays.items()}
    out = _first(tinfo.lower(TExecContext("cpu"), ins, tattrs)["Output"])
    ins["Output"] = [out]
    ins["Output@GRAD"] = [_torch(_rand(tuple(out.shape), 11), dtype)]
    explicit = tinfo.grad_lower(TExecContext("cpu"), ins, tattrs)
    generic = tgrad(TExecContext("cpu"), ins, tattrs, tinfo)
    assert set(generic) == set(explicit) == {"Input@GRAD", "Filter@GRAD"}
    for slot in explicit:
        assert torch.equal(_first(generic[slot]), _first(explicit[slot])), \
            slot


# -- pool2d ------------------------------------------------------------------

POOL_CASES = [  # (x shape, attrs)
    ((2, 3, 8, 8), {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2]}),
    ((2, 3, 9, 9), {"pooling_type": "max", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1]}),   # ResNet's
    ((2, 3, 9, 8), {"pooling_type": "avg", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1]}),
    ((2, 3, 7, 7), {"pooling_type": "avg", "ksize": [3, 2],
                    "strides": [1, 2], "paddings": [1, 0]}),
    ((2, 3, 6, 6), {"pooling_type": "max", "ksize": [3, 3],
                    "strides": [1, 1], "paddings": [2, 2]}),   # pad > k/2
    ((2, 3, 6, 6), {"pooling_type": "avg", "ksize": [3, 3],
                    "strides": [1, 1], "paddings": [2, 2]}),   # pad > k/2
    ((2, 5, 4, 3), {"pooling_type": "avg", "global_pooling": True,
                    "ksize": [2, 2], "paddings": [1, 1]}),
    ((2, 5, 4, 3), {"pooling_type": "max", "global_pooling": True}),
    ((2, 8, 8, 3), {"pooling_type": "max", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1],
                    "data_format": "NHWC"}),
    ((2, 4, 5, 6), {"pooling_type": "avg", "global_pooling": True,
                    "data_format": "NHWC"}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=range(len(POOL_CASES)))
def test_pool2d_matches_jax(case, dtype):
    """bf16 average pooling: the JAX lowering sums a window in bf16,
    rounding at each add, where the port sums in float32 and rounds
    once; the port is held to the JAX lowering over the same bf16 values
    in float32, rounded to bf16, within one bf16 ulp."""
    xs, attrs = case
    arrays = {"X": _rand(xs, 3)}
    jout, tout = _forward("pool2d", arrays, attrs, dtype)
    if dtype == "bfloat16" and attrs["pooling_type"] == "avg":
        x32 = _np(_jax(arrays["X"], dtype))
        jout, _ = _forward("pool2d", {"X": x32}, attrs)
        jout = {"Out": jnp.asarray(jout["Out"], jnp.bfloat16)}
    _assert_all_slots(jout, tout, dtype, F32_TOL)


@pytest.mark.parametrize("case", POOL_CASES, ids=range(len(POOL_CASES)))
def test_pool2d_generic_grad_matches_jax_vjp(case):
    xs, attrs = case
    jg, tg, ref = _grad_both("pool2d", {"X": _rand(xs, 4)}, attrs, "float32",
                        "Out")
    _assert_grads(jg, tg, ref, "float32", F32_TOL)


def test_max_pool_tied_window_gives_the_first_element_the_gradient():
    """A 2x2 window of four equal values: both sides route the whole
    cotangent to its first element (row-major), bit for bit."""
    x = np.array([[[[1.0, 1.0, 0.0, 2.0],
                    [1.0, 1.0, 2.0, 2.0]]]], dtype=np.float32)
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]}
    jg, tg, ref = _grad_both("pool2d", {"X": x}, attrs, "float32", "Out")
    j, t = _np(_first(jg["X@GRAD"])), _np(_first(tg["X@GRAD"]))
    np.testing.assert_array_equal(t, j)
    nz = np.argwhere(t[0, 0] != 0).tolist()
    assert nz == [[0, 0], [0, 3]], nz      # the first of each tied window


# -- batch_norm --------------------------------------------------------------

def _bn_arrays(xs, layout, seed=5):
    c = xs[1] if layout == "NCHW" else xs[-1]
    r = np.random.RandomState(seed)
    # a mean far from 0: the two-pass variance matters in float32
    x = (r.standard_normal(xs) * 2.0 + 3.0).astype(np.float32)
    return {"X": x,
            "Scale": (r.rand(c) + 0.5).astype(np.float32),
            "Bias": r.standard_normal(c).astype(np.float32),
            "Mean": r.standard_normal(c).astype(np.float32) * 0.1,
            "Variance": (r.rand(c) + 0.5).astype(np.float32)}


BN_CASES = [((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"),
            ((8, 5), "NCHW")]       # VGG's batch norm over an fc output


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,layout", BN_CASES)
def test_batch_norm_matches_jax_every_slot(xs, layout, dtype, is_test):
    arrays = _bn_arrays(xs, layout)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    jout, tout = _forward("batch_norm", arrays, attrs, dtype)
    assert set(tout) == {"Y", "MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance"}
    for slot in jout:
        jv, tv = _first(jout[slot]), _first(tout[slot])
        want = torch.bfloat16 if jv.dtype == jnp.bfloat16 else torch.float32
        assert tv.dtype == want, (slot, tv.dtype, jv.dtype)
        # the statistics are float32 on both sides, whatever X's dtype
        stat = slot != "Y" and jv.dtype == jnp.float32
        _assert_close(tv, jv, "float32" if stat else dtype, F32_TOL, slot)


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("xs,layout", BN_CASES)
def test_batch_norm_explicit_grad_matches_jax_vjp(xs, layout, dtype,
                                                  is_test):
    assert treg.get_op_info("batch_norm").grad_lower is not None
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    jg, tg, ref = _grad_both("batch_norm", _bn_arrays(xs, layout), attrs, dtype,
                        "Y")
    assert set(tg) == {"X@GRAD", "Scale@GRAD", "Bias@GRAD"}
    _assert_grads(jg, tg, ref, dtype, F32_TOL)


def test_batch_norm_lowering_is_pure():
    """The generic gradient re-runs forward lowerings: the running
    statistics must come back as new tensors, the inputs untouched."""
    arrays = _bn_arrays((4, 3, 5, 6), "NCHW")
    ins = _ins(arrays, "float32", _torch)
    before = {s: v[0].clone() for s, v in ins.items()}
    info = treg.get_op_info("batch_norm")
    out = info.lower(TExecContext("cpu"), ins, info.attrs)
    for s, v in ins.items():
        assert torch.equal(v[0], before[s]), s
    assert out["MeanOut"] is not ins["Mean"][0]


# -- dropout, top_k, accuracy ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_test_mode_matches_jax(dtype):
    attrs = {"dropout_prob": 0.3, "is_test": True}
    jout, tout = _forward("dropout", {"X": _rand((4, 6), 8)}, attrs, dtype)
    _assert_all_slots(jout, tout, dtype, F32_TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_matches_jax(k):
    x = _rand((6, 9), 9)
    x[2, 4] = x[2, 7] = x[2].max() + 1.0     # a tie: the lower index first
    jout, tout = _forward("top_k", {"X": x}, {"k": k})
    np.testing.assert_array_equal(_np(tout["Out"]), _np(jout["Out"]))
    np.testing.assert_array_equal(_np(tout["Indices"]),
                                  _np(jout["Indices"]))
    assert tout["Indices"].dtype == torch.int64


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy_matches_jax(k):
    x = _rand((16, 5), 10)
    label = np.random.RandomState(11).randint(0, 5, (16, 1)).astype(
        np.int64)
    jtk, ttk = _forward("top_k", {"X": x}, {"k": k})
    arrays = {"Out": _np(ttk["Out"]), "Indices": _np(ttk["Indices"]),
              "Label": label}
    jout, tout = _forward("accuracy", arrays, {})
    for slot, dt in (("Accuracy", torch.float32), ("Correct", torch.int32),
                     ("Total", torch.int32)):
        assert tout[slot].dtype == dt and tuple(tout[slot].shape) == (1,)
        np.testing.assert_array_equal(_np(tout[slot]), _np(jout[slot]))
