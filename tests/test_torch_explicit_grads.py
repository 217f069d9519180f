"""The explicit gradient lowerings of `mul` and `flash_attention` against
`jax.vjp` of the JAX package's lowerings, on the CPU.

Both ops' "<type>_grad" ops stay the generic grad op in the Program
(same type, slots and attrs as the JAX package's); only the port runs
them without re-running the forward (`registry.register_grad_lower`).

mul: dX = dOut2 Y2^T, dY = X2^T dOut2 on the flattened, amp-cast
operands.  Amp off, float32: within 1e-5 relative to the largest
element (another library's GEMM sums in another order).  Amp on: each
element within one bf16 ulp of the larger of the two values — the two
libraries' bf16 products accumulate in float32 and round once, and
differ where their float32 sums round to neighbouring bf16 values.

flash_attention: on CPU tensors the explicit lowering is the plain
composition's autograd gradient (bit-equal to the port's generic
gradient), held to `jax.vjp` of the JAX op at 2e-4 (its own gradient
tolerance, tests/test_torch_flash_attention.py).  `flash_attention_bwd`
— the card's route from Out, dOut and lse, here in its plain version —
is held to the same.  Card-only cases (bit-equality with the generic
route, launch counts) are in tests/test_torch_cuda.py.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.execution import generic_grad_lower as jgrad

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
import paddle_tpu_torch.core.registry as treg
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import generic_grad_lower as tgrad
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_fwd, flash_attention_reference)

F32_RTOL, FLASH_TOL = 1e-5, 2e-4


@pytest.fixture(autouse=True)
def _fresh_flags():
    tflags.reset_flags()
    tfw.reset_unique_names()
    yield
    tflags.reset_flags()


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(op, arrays, attrs, dtypes=None, amp=False):
    """The JAX generic gradient (jax.vjp of its lowering) and the port's
    registered gradient lowering of `op`, on the same inputs."""
    dtypes = dtypes or {}
    jinfo, tinfo = jreg.get_op_info(op), treg.get_op_info(op)
    assert tinfo.grad_lower is not None
    jins = {s: [jnp.asarray(a, dtypes.get(s, a.dtype))]
            for s, a in arrays.items()}
    tins = {s: [torch.from_numpy(a).to(
        torch.bfloat16 if dtypes.get(s) == jnp.bfloat16 else
        torch.from_numpy(a).dtype)] for s, a in arrays.items()}
    jattrs = {**jinfo.attrs, **attrs}
    tattrs = {**tinfo.attrs, **attrs}
    if amp:
        with jfluid.amp.bf16_guard(), tfluid.amp.bf16_guard():
            jg = jgrad(JExecContext(), jins, jattrs, jinfo)
            tg = tinfo.grad_lower(TExecContext("cpu"), tins, tattrs)
    else:
        jg = jgrad(JExecContext(), jins, jattrs, jinfo)
        tg = tinfo.grad_lower(TExecContext("cpu"), tins, tattrs)
    return jg, tg, tins, tattrs, tinfo


# -- mul ----------------------------------------------------------------------

MUL_CASES = [  # (x shape, y shape, x_num_col_dims, y_num_col_dims)
    ((6, 8), (8, 5), 1, 1),
    ((2, 3, 8), (8, 4), 2, 1),          # a [b, s, d] projection
    ((2, 3, 4), (12, 5), 1, 1),         # X flattened over its tail
    ((4, 6), (2, 3, 7), 1, 2),          # Y flattened over its head
]


def _mul_arrays(xs, ys, seed=0):
    r = np.random.RandomState(seed)
    x = r.standard_normal(xs).astype(np.float32)
    y = r.standard_normal(ys).astype(np.float32)
    return x, y


def _mul_case(xs, ys, xd, yd, x_dtype=jnp.float32, amp=False, seed=0):
    x, y = _mul_arrays(xs, ys, seed)
    xr = x.reshape(int(np.prod(xs[:xd])), -1)
    yr = y.reshape(int(np.prod(ys[:yd])), -1)
    out_shape = xs[:xd] + ys[yd:]
    out = (xr @ yr).reshape(out_shape)
    dout = np.random.RandomState(seed + 1).standard_normal(
        out_shape).astype(np.float32)
    attrs = {"x_num_col_dims": xd, "y_num_col_dims": yd}
    out_dt = jnp.bfloat16 if amp or x_dtype == jnp.bfloat16 else jnp.float32
    return _run_both("mul", {"X": x, "Y": y, "Out": out, "Out@GRAD": dout},
                     attrs, {"X": x_dtype, "Out": out_dt,
                             "Out@GRAD": out_dt}, amp=amp)


@pytest.mark.parametrize("xs,ys,xd,yd", MUL_CASES)
def test_mul_grad_matches_jax_vjp_fp32(xs, ys, xd, yd):
    jg, tg, *_ = _mul_case(xs, ys, xd, yd)
    assert set(tg) == set(jg) == {"X@GRAD", "Y@GRAD"}
    for slot in jg:
        j, t = np.asarray(jg[slot][0]), tg[slot][0]
        assert t.dtype == torch.float32 and t.shape == j.shape
        np.testing.assert_allclose(_np(t), j, rtol=0,
                                   atol=F32_RTOL * np.abs(j).max(),
                                   err_msg=slot)


def _assert_bf16_ulp_close(t, j, what):
    a, b = _np(t), _jnp32(j)
    top = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(top > 0, 2.0 ** (np.floor(np.log2(np.where(
        top > 0, top, 1.0))) - 7), 0.0)
    assert np.all(np.abs(a - b) <= ulp), what


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("xs,ys,xd,yd", MUL_CASES)
def test_mul_grad_matches_jax_vjp_under_amp(xs, ys, xd, yd, x_dtype):
    """An f32 or a bf16 activation X times an f32 weight Y under amp:
    the gradients keep their inputs' dtypes (the weight's f32, as the
    VJP of the input-edge cast gives it)."""
    jg, tg, *_ = _mul_case(xs, ys, xd, yd, x_dtype, amp=True, seed=3)
    for slot, want in (("X@GRAD", x_dtype), ("Y@GRAD", jnp.float32)):
        j, t = jg[slot][0], tg[slot][0]
        assert j.dtype == want, (slot, j.dtype)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), slot
        _assert_bf16_ulp_close(t, j, slot)


@pytest.mark.parametrize("amp", [False, True])
def test_mul_grad_equals_the_generic_gradient(amp):
    """Bit for bit on the CPU, amp on or off: the same two products
    autograd takes, and the same casts."""
    for xs, ys, xd, yd in MUL_CASES:
        _, tg, tins, tattrs, tinfo = _mul_case(xs, ys, xd, yd, amp=amp)
        with tfluid.amp.bf16_guard() if amp else contextlib.nullcontext():
            generic = tgrad(TExecContext("cpu"), tins, tattrs, tinfo)
        for slot in tg:
            assert tg[slot][0].dtype == generic[slot][0].dtype, slot
            assert torch.equal(tg[slot][0], generic[slot][0]), slot


# -- flash_attention ----------------------------------------------------------

FLASH_CASES = [  # (batch, seq_q, seq_k, heads, head_dim, causal)
    (2, 16, 16, 2, 16, False),
    (2, 16, 16, 2, 16, True),
    (1, 16, 40, 2, 32, True),       # cross length, top-left causal
    (1, 24, 8, 3, 16, False),
]


def _flash_arrays(b, sq, sk, h, d, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d)


def _flash_case(case, dtype=jnp.float32, scale=None):
    b, sq, sk, h, d, causal = case
    q, k, v, do = _flash_arrays(b, sq, sk, h, d)
    out = _np(flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        scale=scale))
    attrs = {"causal": causal, "scale": 1.0 if scale is None else scale,
             "default_scale": scale is None, "min_seq_k": -1}
    dts = {s: dtype for s in ("Q", "K", "V", "Out", "Out@GRAD")}
    return _run_both("flash_attention",
                     {"Q": q, "K": k, "V": v, "Out": out, "Out@GRAD": do},
                     attrs, dts)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_grad_matches_jax_vjp(case, scale):
    jg, tg, tins, tattrs, tinfo = _flash_case(case, scale=scale)
    assert set(tg) == set(jg) == {"Q@GRAD", "K@GRAD", "V@GRAD"}
    generic = tgrad(TExecContext("cpu"), tins, tattrs, tinfo)
    for slot in jg:
        j, t = np.asarray(jg[slot][0]), tg[slot][0]
        assert t.dtype == torch.float32 and t.shape == j.shape
        np.testing.assert_allclose(_np(t), j, rtol=0, atol=FLASH_TOL,
                                   err_msg=slot)
        # on the CPU the explicit lowering is the generic gradient
        assert torch.equal(t, generic[slot][0]), slot


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_from_out_and_lse_matches_jax_vjp(case):
    """The card's route (`flash_attention_bwd` from the forward's Out,
    lse and dOut, no recompute), in its plain version."""
    jg, _, tins, tattrs, _ = _flash_case(case)
    causal = case[-1]
    q, k, v = (tins[s][0] for s in ("Q", "K", "V"))
    o, lse = flash_attention_fwd(q, k, v, causal)
    grads = flash_attention_bwd(q, k, v, o, tins["Out@GRAD"][0], lse, causal)
    for slot, t in zip(("Q@GRAD", "K@GRAD", "V@GRAD"), grads):
        np.testing.assert_allclose(_np(t), np.asarray(jg[slot][0]), rtol=0,
                                   atol=FLASH_TOL, err_msg=slot)


def test_flash_attention_grad_dtypes_match_jax_in_bf16():
    jg, tg, *_ = _flash_case(FLASH_CASES[2], dtype=jnp.bfloat16)
    for slot in jg:
        assert jg[slot][0].dtype == jnp.bfloat16
        assert tg[slot][0].dtype == torch.bfloat16, slot
        # bf16 inputs: both sides round float32 work to bf16 at other
        # places; a loose check that the values are the same gradient
        j, t = _jnp32(jg[slot][0]), _np(tg[slot][0])
        assert np.abs(t - j).max() <= 0.05 * np.abs(j).max(), slot


# -- the Program keeps the generic grad ops -----------------------------------

def test_grad_ops_keep_the_generic_slots_and_dtypes():
    """Under amp, the mul and flash_attention grad ops of the LM Program
    are the JAX package's (type, slots, attrs, and the var dtypes of
    their outputs): f32 for every weight, bf16 for bf16 activations."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu.core.framework as jfw
    from paddle_tpu.models import transformer as jtr
    from test_torch_training import _lm

    from paddle_tpu_torch.models import transformer as ttr

    with jfluid.amp.bf16_guard(), tfluid.amp.bf16_guard():
        jm, _, _ = _lm(jfluid, jfw, jtr, "momentum")
        tm, _, _ = _lm(tfluid, tfw, ttr, "momentum")

    def grad_ops(prog):
        blk = prog.global_block()
        return [(op.type, op.inputs, op.outputs, op.attrs,
                 {n: blk.var(n).dtype for n in op.output_names()
                  if n != "@EMPTY@"})
                for op in blk.ops
                if op.type in ("mul_grad", "flash_attention_grad")]

    jops, tops = grad_ops(jm), grad_ops(tm)
    assert len(tops) == 13 + 2 and tops == jops
    for typ, ins, outs, _, dts in tops:
        if typ == "mul_grad":
            assert dts[outs["Y@GRAD"][0]] == "float32"
        else:
            assert set(dts.values()) == {"bfloat16"}
