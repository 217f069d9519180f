"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's `flash_attention` runs its plain version
under autograd; the JAX package's runs its Pallas kernels in interpret
mode (`interpret=True`, as tests/test_flash_attention.py does), the
forward and the recomputing dQ and dK/dV kernels through its
custom_vjp.  Both take the same numpy-seeded q, k, v and output
cotangent.  Tolerances are the JAX package's own for its kernel against
its oracle: 2e-5 on the output and 2e-4 on the gradients (float32; the
kernels sum in tiles with an online softmax, the plain version in one
pass).

The op level: both packages' generic `flash_attention_grad` (the grad
op `append_backward` emits) on the same inputs.  On the CPU the JAX op
runs its XLA composition and the port's op its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.core.registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.execution import generic_grad_lower as jgrad
from paddle_tpu.kernels.flash_attention import flash_attention as jflash

import paddle_tpu_torch.core.registry as treg
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import generic_grad_lower as tgrad
from paddle_tpu_torch.kernels.flash_attention import (
    attention_delta, flash_attention, flash_attention_dkv,
    flash_attention_dq, flash_attention_fwd, flash_attention_reference,
    flash_attention_supports)
from paddle_tpu_torch.kernels.registry import FALLBACK_METRIC
from paddle_tpu_torch.observability import metrics as tmetrics

FWD_TOL, GRAD_TOL = 2e-5, 2e-4

CASES = [  # (batch, seq_q, seq_k, heads, head_dim, causal)
    (1, 128, 128, 2, 64, False),
    (2, 128, 128, 2, 64, True),
    (1, 128, 256, 2, 64, True),     # cross length, top-left causal
]


def _inputs(b, sq, sk, h, d, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d)


@pytest.fixture(autouse=True)
def _fresh_flags():
    tflags.reset_flags()
    yield
    tflags.reset_flags()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "b{}_q{}_k{}_{}".format(
    c[0], c[1], c[2], "causal" if c[5] else "full"))
def test_forward_and_gradients_match_the_jax_kernels(case):
    b, sq, sk, h, d, causal = case
    q, k, v, do = _inputs(b, sq, sk, h, d)

    def jfn(q_, k_, v_):
        return jflash(q_, k_, v_, causal=causal, interpret=True)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = flash_attention(tq, tk, tv, causal=causal)
    tout.backward(torch.from_numpy(do))

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=FWD_TOL)
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")

    # the three kernel wrappers on CPU tensors run their plain versions,
    # the functions the kernels are held to on the card
    q_, k_, v_, do_ = (torch.from_numpy(a) for a in (q, k, v, do))
    before = dict(flash_attention.launches)
    o, lse = flash_attention_fwd(q_, k_, v_, causal)
    delta = attention_delta(o, do_)
    dq = flash_attention_dq(q_, k_, v_, do_, lse, delta, causal)
    dk, dv = flash_attention_dkv(q_, k_, v_, do_, lse, delta, causal)
    assert flash_attention.launches == before
    np.testing.assert_allclose(o.numpy(), np.asarray(jout), rtol=0,
                               atol=FWD_TOL)
    for name, t, j in zip("qkv", (dq, dk, dv), jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"plain d{name}")


def test_causal_cross_length_is_top_left_aligned():
    """Query row i sees keys 0..i even when seq_k > seq_q: row 0 is
    exactly v[:, 0]."""
    q, k, v, _ = _inputs(1, 4, 8, 1, 16, seed=1)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_generic_grad_op_matches_jax(causal):
    q, k, v, do = _inputs(2, 16, 24, 2, 16, seed=2)
    attrs = {"causal": causal, "scale": 1.0, "default_scale": True,
             "min_seq_k": -1}
    jinfo = jreg.get_op_info("flash_attention_grad")
    tinfo = treg.get_op_info("flash_attention_grad")
    assert jinfo.type == tinfo.type == "flash_attention"
    out = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    arrays = {"Q": q, "K": k, "V": v, "Out": out.numpy(), "Out@GRAD": do}
    jg = jgrad(JExecContext(), {s: [jnp.asarray(a)] for s, a in arrays.items()},
               {**jinfo.attrs, **attrs}, jinfo)
    tg = tgrad(TExecContext("cpu"),
               {s: [torch.from_numpy(a)] for s, a in arrays.items()},
               {**tinfo.attrs, **attrs}, tinfo)
    assert set(tg) == set(jg) == {"Q@GRAD", "K@GRAD", "V@GRAD"}
    for slot in jg:
        np.testing.assert_allclose(tg[slot][0].numpy(), np.asarray(jg[slot][0]),
                                   rtol=0, atol=GRAD_TOL, err_msg=slot)


def _fallbacks():
    fam = tmetrics.registry().get(FALLBACK_METRIC)
    return {labels["reason"]: child.value for labels, child in fam.samples()
            if labels["kernel"] == "flash_attention"}


def test_op_on_cpu_runs_the_plain_version_uncounted():
    """CPU tensors are not a fallback: the plain version is the plan, so
    nothing is counted, and the op's `min_seq_k` attr changes nothing."""
    q, k, v, _ = _inputs(1, 8, 8, 2, 16)
    ins = {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
           "V": [torch.from_numpy(v)]}
    before = _fallbacks()
    out = treg.get_op_info("flash_attention").lower(
        TExecContext("cpu"), ins,
        {"causal": True, "scale": 1.0, "default_scale": True,
         "min_seq_k": 1 << 20})["Out"]
    want = flash_attention_reference(*(x[0] for x in ins.values()),
                                     causal=True)
    assert torch.equal(out, want)
    assert _fallbacks() == before
    assert flash_attention_supports(ins["Q"][0], ins["K"][0],
                                    ins["V"][0]) == "no_cuda"
