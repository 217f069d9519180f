"""The flash-attention kernels' product arithmetic, on the CPU.

On the card the forward, dQ and dK/dV kernels run every product on the
tensor cores: float32 inputs as 3xTF32 (each operand split into a TF32
big and small part, three TF32 products), bfloat16 inputs as bf16
products, with the float32 operand (P or dS) split into a bf16 hi + lo
pair.  The CUDA kernels cannot run here, so these tests run the plain
math with every product through a model of that arithmetic
(`_split_matmul`, `_bf16_split` and `_round_tf32` in
kernels/flash_attention.py) and hold it to the plain versions with the
card's gates (chip_smoke.py's flash phase):

- float32: 2e-5 * max(1, max|plain|) on the forward's O and lse, 2e-4 *
  max(1, max|plain|) on dQ, dK and dV;
- bfloat16: the largest error at most one bf16 ulp of max|plain|, the
  error's RMS at most 2^-9 of the plain values' RMS (lse, float32 in
  both dtypes, takes the float32 gate).

The forward is modelled as the kernel computes it: key steps of 32 keys
(64 in bf16), an online softmax in the log2 domain, O += P V per step.
A single TF32 product, where the kernels take three, misses the float32
gates.  Inputs: numpy-seeded normal q, k, v, dO at the training shape's
head dim, [2, 512, 2, 128].
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.flash_attention import (
    _bf16_split, _round_tf32, _split_matmul, attention_delta,
    flash_attention_dkv_reference, flash_attention_dq_reference,
    flash_attention_fwd_reference)

SHAPE = (2, 512, 2, 128)
FP32_TOL = 2e-4
FWD_TOL = 2e-5
# keys a forward step takes, as csrc/flash_attention.cu `fwd_keys`
FWD_KEYS = {torch.float32: 32, torch.bfloat16: 64}
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _inputs(dtype, seed=0):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.standard_normal(SHAPE).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _products(mode):
    """(mm_inputs, mm_acc): the model of the products whose operands are
    both inputs (S = Q K^T, dP = dO V^T) and of those with a float32
    left operand (dQ = dS K, dK = dS^T Q, dV = P^T dO)."""
    if mode == "bf16_split":
        def mm_acc(a, b):   # lo first, as the kernel sums them
            hi, lo = _bf16_split(a)
            return lo.float() @ b + hi.float() @ b
        return (lambda a, b: a @ b), mm_acc   # bf16 x bf16 is exact
    terms = {"tf32x3": 3, "tf32x1": 1}[mode]
    mm = lambda a, b: _split_matmul(a, b, terms)   # noqa: E731
    return mm, mm


def _modelled_backward(q, k, v, do, lse, delta, causal, mode):
    """The plain dQ/dK/dV math with every product through the model."""
    b, s, h, d = q.shape
    scale = d ** -0.5
    mm_in, mm_acc = _products(mode)

    def fold(x):
        return x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)

    def unfold(x):
        return x.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)

    qf, kf, vf, dof = map(fold, (q, k, v, do))
    scores = mm_in(qf, kf.transpose(1, 2)) * scale
    if causal:
        keep = torch.arange(s)[:, None] >= torch.arange(s)[None, :]
        scores = scores.masked_fill(~keep, -1e30)
    p = torch.exp(scores - lse.reshape(b * h, s, 1))
    dp = mm_in(dof, vf.transpose(1, 2))
    ds = p * (dp - delta.reshape(b * h, s, 1)) * scale
    return (unfold(mm_acc(ds, kf)), unfold(mm_acc(ds.transpose(1, 2), qf)),
            unfold(mm_acc(p.transpose(1, 2), dof)))


def _plain(q, k, v, do, causal):
    o, lse = flash_attention_fwd_reference(q, k, v, causal)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal)
    return args, (flash_attention_dq_reference(*args),
                  *flash_attention_dkv_reference(*args))


def _fp32_errors(got, want):
    """{name: (max_abs_err, gate)} for dq, dk, dv."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        out[name] = (float((g - w).abs().max()),
                     FP32_TOL * max(1.0, float(w.abs().max())))
    return out


def _bf16_gate(got, want):
    """chip_smoke.py `_close_bf16`: (ok, max err, its limit, RMS, limit)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    lim = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
    rms_lim = 2.0 ** -9 * float(want.pow(2).mean().sqrt())
    err = (got - want).abs()
    rms = float(err.pow(2).mean().sqrt())
    return (float(err.max()) <= lim and rms <= rms_lim, float(err.max()),
            lim, rms, rms_lim)


def test_round_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10          # TF32 keeps 10 explicit mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2e-7,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(_round_tf32(x), want)
    # big + small carries the value to float32 resolution
    r = torch.from_numpy(np.random.RandomState(1).standard_normal(1000)
                         .astype(np.float32))
    big = _round_tf32(r)
    small = _round_tf32(r - big)
    assert float(((big + small) - r).abs().div(r.abs()).max()) < 2.0 ** -21


@pytest.mark.parametrize("mode", ["tf32x3", "bf16_split"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_products_meet_the_card_gates(causal, mode):
    dtype = torch.float32 if mode == "tf32x3" else torch.bfloat16
    q, k, v, do = _inputs(dtype)
    args, want = _plain(q, k, v, do, causal)
    got = _modelled_backward(*args, mode=mode)
    if mode == "tf32x3":
        for name, (err, gate) in _fp32_errors(got, want).items():
            assert err <= gate, f"{name}: {err} > {gate}"
    else:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == torch.bfloat16
            ok, err, lim, rms, rms_lim = _bf16_gate(g, w)
            assert ok, f"{name}: max {err} (limit {lim}), RMS {rms} " \
                       f"(limit {rms_lim})"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_one_tf32_term_misses_the_gate_three_meet(causal):
    q, k, v, do = _inputs(torch.float32)
    args, want = _plain(q, k, v, do, causal)
    three = _fp32_errors(_modelled_backward(*args, mode="tf32x3"), want)
    one = _fp32_errors(_modelled_backward(*args, mode="tf32x1"), want)
    for name in three:
        assert one[name][0] > 50 * three[name][0], (name, one, three)
    assert any(err > gate for err, gate in one.values()), one


def _modelled_forward(q, k, v, causal, mode):
    """The forward kernel's arithmetic: for each step of keys, S through
    the model of the products, the scores scaled into the log2 domain and
    masked, the running max m and sum l rescaled by alpha = 2^(m - m_new),
    O += P V; at the end O / l and lse = m ln(2) + ln(l), float32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    mm_in, mm_acc = _products(mode)
    scale_log2 = torch.tensor(d ** -0.5, dtype=torch.float32) * LOG2E
    qf, kf, vf = (x.float().permute(0, 2, 1, 3).reshape(b * h, -1, d)
                  for x in (q, k, v))
    m = torch.full((b * h, sq), -1e30)
    l = torch.zeros((b * h, sq))
    acc = torch.zeros((b * h, sq, d))
    rows = torch.arange(sq)[:, None]
    step = FWD_KEYS[q.dtype]
    for k0 in range(0, sk, step):
        if causal and k0 > sq - 1:   # above every row's diagonal: skipped
            break
        x = mm_in(qf, kf[:, k0:k0 + step].transpose(1, 2)) * scale_log2
        if causal:
            cols = k0 + torch.arange(x.shape[-1])[None, :]
            x = x.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm_acc(p, vf[:, k0:k0 + step])
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = acc * (1.0 / l_safe)[..., None]
    lse = m * LN2 + torch.log(l_safe)
    return (o.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype),
            lse.reshape(b, h, sq))


def _fwd_errors(got, want):
    """{name: (max_abs_err, gate)} for o and lse (float32 gates)."""
    return {name: (float((g.float() - w.float()).abs().max()),
                   FWD_TOL * max(1.0, float(w.float().abs().max())))
            for name, g, w in zip(("o", "lse"), got, want)}


@pytest.mark.parametrize("mode", ["tf32x3", "bf16_split"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_model_meets_the_card_gates(causal, mode):
    dtype = torch.float32 if mode == "tf32x3" else torch.bfloat16
    q, k, v, _ = _inputs(dtype)
    want = flash_attention_fwd_reference(q, k, v, causal)
    got = _modelled_forward(q, k, v, causal, mode)
    errors = _fwd_errors(got, want)
    if mode == "tf32x3":
        for name, (err, gate) in errors.items():
            assert err <= gate, f"{name}: {err} > {gate}"
    else:
        assert got[0].dtype == torch.bfloat16
        ok, err, lim, rms, rms_lim = _bf16_gate(got[0], want[0])
        assert ok, f"o: max {err} (limit {lim}), RMS {rms} (limit {rms_lim})"
        err, gate = errors["lse"]
        assert err <= gate, f"lse: {err} > {gate}"


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_one_tf32_term_misses_the_gate(causal):
    q, k, v, _ = _inputs(torch.float32)
    want = flash_attention_fwd_reference(q, k, v, causal)
    three = _fwd_errors(_modelled_forward(q, k, v, causal, "tf32x3"), want)
    one = _fwd_errors(_modelled_forward(q, k, v, causal, "tf32x1"), want)
    for name in three:
        assert one[name][0] > 20 * three[name][0], (name, one, three)
        assert one[name][0] > one[name][1], (name, one)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_model_matches_the_jax_kernel(causal):
    """The model against the JAX package's Pallas forward in interpret
    mode, at the JAX kernel tests' 2e-5 (absolute)."""
    import jax.numpy as jnp

    from paddle_tpu.kernels.flash_attention import _fwd_pallas

    b, s, h, d = 1, 128, 2, 64
    r = np.random.RandomState(4)
    q, k, v = (r.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    fold = lambda x: jnp.asarray(  # noqa: E731
        x.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    jo, jlse = _fwd_pallas(fold(q), fold(k), fold(v), d ** -0.5, causal,
                           64, 64, True)
    o, lse = _modelled_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                               causal, "tf32x3")
    np.testing.assert_allclose(
        o.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(), np.asarray(jo),
        rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.reshape(b * h, s).numpy(),
                               np.asarray(jlse)[..., 0], rtol=0,
                               atol=FWD_TOL)
