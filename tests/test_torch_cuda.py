"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and nvcc; without a device they skip.
This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance for paged attention: 1e-5 * max(1, max|plain|), because
dequantization is exact in float32 and only the summation order differs
(the kernel's online softmax against the plain two-pass softmax).
"""
import pytest
import torch

from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention, paged_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(kv_dtype, w_n, d_model, n_heads, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    layers, bs, nb, pool, s_n = 2, 16, 8, 40, 5
    ctx = bs * nb
    positions = torch.tensor([0, 7, 16, 61, ctx - w_n], dtype=torch.int32)
    tables = torch.zeros((s_n, nb), dtype=torch.int32)   # null-block tails
    perm = torch.randperm(pool - 1, generator=gen) + 1
    used = 0
    for s in range(s_n):
        n = -(-(int(positions[s]) + w_n) // bs)
        tables[s, :n] = perm[used:used + n]
        used += n
    shape = (layers, pool, bs, d_model)

    def one():
        if kv_dtype == "int8":
            return (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8).to(dev),
                    (torch.rand((layers, pool), generator=gen) * 0.05
                     + 1e-3).to(dev))
        t = torch.randn(shape, generator=gen)
        return (t.bfloat16() if kv_dtype == "bf16" else t).to(dev)

    q = torch.randn((s_n, w_n, d_model), generator=gen).to(dev)
    return q, one(), one(), tables.to(dev), positions.to(dev)


@pytest.mark.parametrize("d_head", [16, 32, 64, 128])
@pytest.mark.parametrize("w_n", [1, 3, 4])
@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_paged_attention_kernel_matches_plain(dev, kv_dtype, w_n, d_head):
    n_heads = 4
    q, pk, pv, tables, positions = _inputs(kv_dtype, w_n, d_head * n_heads,
                                           n_heads, dev)
    before = paged_attention.launches
    for layer in (0, 1):
        args = (q, pk, pv, tables, positions, layer)
        got = paged_attention(*args, n_heads=n_heads)
        want = paged_attention_reference(*args, n_heads=n_heads)
        torch.cuda.synchronize()
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    assert paged_attention.launches == before + 2


def test_paged_attention_kernel_is_deterministic_per_slot(dev):
    """A slot's result depends only on its own inputs: the same slot
    alone and inside a batch gives the same bits."""
    q, pk, pv, tables, positions = _inputs("fp32", 1, 512, 8, dev, seed=1)
    full = paged_attention(q, pk, pv, tables, positions, 1, n_heads=8)
    for s in range(q.shape[0]):
        one = paged_attention(q[s:s + 1].contiguous(), pk, pv,
                              tables[s:s + 1].contiguous(),
                              positions[s:s + 1].contiguous(), 1, n_heads=8)
        assert torch.equal(one[0], full[s])


def test_paged_attention_rejects_what_the_kernel_does_not_take(dev):
    q, pk, pv, tables, positions = _inputs("fp32", 1, 96, 2, dev)
    with pytest.raises(ValueError, match="d_head"):
        paged_attention(q, pk, pv, tables, positions, 0, n_heads=2)
    q, pk, pv, tables, positions = _inputs("fp32", 1, 64, 4, dev)
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, pk, pv, tables.long(), positions, 0, n_heads=4)


# -- flash attention ---------------------------------------------------------
#
# Each kernel against its plain version on the same inputs (the backward
# kernels get the plain forward's lse and delta), at every head dim and at
# lengths that leave a partial last tile after several full ones (513;
# 300 queries against 700 keys).  Tolerances relative to
# max(1, max|plain|): 2e-5 for the float32 output and 2e-4 for float32
# gradients (tiled online softmax vs one pass, other summation order);
# 2e-2 for bfloat16 (the output and gradients round to bf16).

from paddle_tpu_torch.kernels.flash_attention import (  # noqa: E402
    attention_delta, flash_attention, flash_attention_dkv,
    flash_attention_dkv_reference, flash_attention_dq,
    flash_attention_dq_reference, flash_attention_fwd,
    flash_attention_fwd_reference, flash_attention_reference)


def _flash_inputs(b, sq, sk, h, d, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev, dtype)
            for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                      (b, sq, h, d))]


def _close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    lim = tol * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= lim, f"{what}: max_abs_err {err} > {lim}"


@pytest.mark.parametrize("sq,sk", [(128, 128), (80, 200), (200, 80),
                                   (513, 513), (300, 700)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d_head", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(dev, dtype, d_head, causal, sq, sk):
    q, k, v, do = _flash_inputs(2, sq, sk, 3, d_head, dtype, dev)
    fp32 = dtype == torch.float32
    before = dict(flash_attention.launches)
    o, lse = flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    delta = attention_delta(o_ref, do)
    dq = flash_attention_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = flash_attention_dkv(q, k, v, do, lse_ref, delta, causal)
    dq_ref = flash_attention_dq_reference(q, k, v, do, lse_ref, delta, causal)
    dk_ref, dv_ref = flash_attention_dkv_reference(q, k, v, do, lse_ref,
                                                   delta, causal)
    torch.cuda.synchronize()
    _close(o, o_ref, 2e-5 if fp32 else 2e-2, "o")
    _close(lse, lse_ref, 2e-5 if fp32 else 2e-2, "lse")
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        assert got.dtype == dtype and got.shape == want.shape
        _close(got, want, 2e-4 if fp32 else 2e-2, name)
    assert flash_attention.launches == {
        key: before[key] + 1 for key in ("fwd", "dq", "dkv")}


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_plain_autograd(dev, causal):
    q, k, v, do = _flash_inputs(2, 96, 160, 2, 32, torch.float32, dev, 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_reference(*ref_leaves, causal=causal)
    want = torch.autograd.grad(ref, ref_leaves, do)
    _close(out, ref, 2e-5, "out")
    for name, g, w in zip("qkv", got, want):
        _close(g, w, 2e-4, "d" + name)


@pytest.mark.parametrize("kernels", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_bit_identical_across_calls(dev, dtype, kernels):
    """At the training shape: no atomics, each sum in a fixed order
    (the forward's O and lse; the backward's dQ, dK and dV)."""
    q, k, v, do = _flash_inputs(8, 512, 512, 16, 128, dtype, dev, 2)
    o, lse = flash_attention_fwd(q, k, v, True)
    delta = attention_delta(o, do)

    def run():
        if kernels == "forward":
            return flash_attention_fwd(q, k, v, True)
        return (flash_attention_dq(q, k, v, do, lse, delta, True),
                *flash_attention_dkv(q, k, v, do, lse, delta, True))

    first, again = run(), run()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d_head", [(torch.float32, 64),
                                          (torch.bfloat16, 128)])
def test_flash_reads_strided_inputs(dev, dtype, d_head):
    """q/k/v as views of one fused [b, s, 3, h, d] tensor: read through
    their strides, no copy needed."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, 64, 3, 4, d_head), generator=gen).to(dev, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, _ = flash_attention_fwd(q, k, v, True)
    _close(o, flash_attention_reference(q, k, v, True),
           2e-5 if dtype == torch.float32 else 2e-2, "o")


def test_flash_raises_on_what_the_kernels_do_not_take(dev):
    q, k, v, _ = _flash_inputs(1, 64, 64, 2, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k, v)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 96, torch.float32, dev)
    with pytest.raises(ValueError, match="d_head"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="d_head"):
        flash_attention_fwd(q, k, v)
    q, k, v, do = _flash_inputs(1, 64, 64, 2, 64, torch.float32, dev)
    _, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="backward"):
        flash_attention_dq(q, k, v, do, lse, lse[:, :, :8], False)


def test_flash_op_raises_on_the_card_instead_of_running_plain(dev):
    """The op never gives way to the plain version on the card: a
    head_dim or dtype the kernels do not take raises at the op, with
    nothing launched and nothing counted; a supported shape launches
    the kernel whatever the op's `min_seq_k` attr says."""
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.kernels import registry as kreg

    lower = get_op_info("flash_attention").lower
    attrs = {"causal": True, "scale": 1.0, "default_scale": True,
             "min_seq_k": 1 << 20}
    fam = kreg._M_FALLBACKS
    counted = {tuple(sorted(lb.items())): c.value for lb, c in fam.samples()}
    launches = dict(flash_attention.launches)
    for d_head, dtype, reason in ((96, torch.float32, "d_head"),
                                  (64, torch.float16, "dtype")):
        q, k, v, _ = _flash_inputs(1, 32, 32, 2, d_head, dtype, dev)
        with pytest.raises(ValueError, match=rf"\({reason}\)"):
            lower(ExecContext(dev), {"Q": [q], "K": [k], "V": [v]}, attrs)
    assert flash_attention.launches == launches
    assert {tuple(sorted(lb.items())): c.value
            for lb, c in fam.samples()} == counted
    q, k, v, _ = _flash_inputs(1, 32, 32, 2, 64, torch.float32, dev)
    out = lower(ExecContext(dev), {"Q": [q], "K": [k], "V": [v]},
                attrs)["Out"]
    _close(out, flash_attention_reference(q, k, v, True), 2e-5, "o")
    assert flash_attention.launches["fwd"] == launches["fwd"] + 1


def test_lm_trains_on_cuda_like_on_cpu(dev):
    """A tiny transformer LM, 3 Momentum steps from the same parameters:
    the kernel path on the card against the plain path on the CPU
    (losses within 1e-4 relative: cuBLAS and the CPU sum in other
    orders)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    from paddle_tpu_torch.models.transformer import transformer_lm

    vocab, seq, batch = 29, 32, 4
    tfw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[seq], dtype="int64")
        lbl = fluid.layers.data(name="lbl", shape=[seq, 1], dtype="int64")
        logits = transformer_lm(ids, vocab, d_model=128, n_heads=2,
                                n_layers=2, max_len=seq, return_logits=True)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.reshape(logits, shape=[-1, vocab]),
            fluid.layers.reshape(lbl, shape=[-1, 1])))
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    base = np.arange(batch * seq).reshape(batch, seq) % 97
    losses = {}
    init = None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        prev = texecutor.switch_scope(Scope())
        try:
            exe = fluid.Executor(place, seed=1)
            exe.run(startup)
            if init is None:
                init = scope_to_numpy(fluid.global_scope(), names)
            scope_from_numpy(init, place, fluid.global_scope())
            before = dict(flash_attention.launches)
            out = []
            for step in range(3):
                feed = {"ids": ((base + step) % vocab).astype(np.int64),
                        "lbl": ((base + step + 1) % vocab).astype(
                            np.int64)[..., None]}
                out.append(float(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0][0]))
            launched = {key: flash_attention.launches[key] - before[key]
                        for key in before}
        finally:
            texecutor.switch_scope(prev)
        losses[str(place)] = out
        if str(place) == "CPUPlace":
            assert launched == {"fwd": 0, "dq": 0, "dkv": 0}
        else:   # 2 layers: 2 forward ops + 2 recomputed in the grad ops
            assert launched == {"fwd": 12, "dq": 6, "dkv": 6}
    cpu, gpu = np.array(losses["CPUPlace"]), np.array(losses["CUDAPlace(0)"])
    assert np.all(np.isfinite(gpu))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=0)


# -- fused bucket SGD update -------------------------------------------------
#
# Bit-identical to its plain version (p - lr * g, two roundings): no
# tolerance.

from paddle_tpu_torch.kernels.fused_update import (  # noqa: E402
    fused_bucket_sgd, fused_bucket_sgd_reference)


@pytest.mark.parametrize("numel", [1, 3, 4, 1023, 4096, (1 << 20) + 7])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_update_is_bit_identical_to_plain(dev, numel, offset):
    """Odd sizes, and views starting one element in (not 16-byte
    aligned: the kernel's scalar path); lr a device scalar."""
    gen = torch.Generator().manual_seed(numel)
    p = torch.randn(numel + offset, generator=gen).to(dev)[offset:]
    g = torch.randn(numel + offset, generator=gen).to(dev)[offset:]
    lr = torch.tensor([0.0123], device=dev)
    before = fused_bucket_sgd.launches
    got = fused_bucket_sgd(p, g, lr)
    want = fused_bucket_sgd_reference(p, g, lr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fused_bucket_sgd.launches == before + 1


def test_fused_update_rejects_what_the_kernel_does_not_take(dev):
    p = torch.zeros(8, device=dev)
    lr = torch.tensor([0.1], device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_bucket_sgd(p.double(), p.double(), lr)
    with pytest.raises(ValueError, match="lr"):
        fused_bucket_sgd(p, p, torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="1-D"):
        fused_bucket_sgd(p, p[:4], lr)


# -- MoE gate + dispatch -----------------------------------------------------
#
# Routing is identical and expert_in bit-equal (a gather of x); combine
# and aux within 1e-6 * max(1, max|plain|) (softmax and the aux means
# sum in another order); the Function's gradients equal plain autograd's
# within 1e-5 * max(1, max|plain|) (its backward is the plain version's
# VJP at the kernel's routing, summed in another order).

from paddle_tpu_torch.kernels.moe_dispatch import (  # noqa: E402
    moe_gate_dispatch, moe_gate_dispatch_launch, moe_gate_dispatch_reference,
    moe_routing_reference)


def _moe_inputs(t_n, d, e_n, dev, seed=0, ties=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((t_n, d), generator=gen)
    gw = torch.randn((d, e_n), generator=gen) * 0.05
    if ties:   # experts 1 and 2 identical: every token ties between them
        gw[:, 2] = gw[:, 1]
    return x.to(dev), gw.to(dev)


@pytest.mark.parametrize("t_n,d,e_n,c_n,top_k,ties", [
    (256, 64, 4, 80, 2, False), (256, 64, 4, 20, 2, False),
    (256, 64, 4, 80, 1, False), (256, 64, 4, 30, 1, False),
    (300, 60, 5, 70, 2, True), (1000, 128, 8, 250, 2, False),
    (64, 32, 64, 3, 2, False), (2048, 256, 8, 320, 2, False)])
def test_moe_kernel_matches_plain(dev, t_n, d, e_n, c_n, top_k, ties):
    x, gw = _moe_inputs(t_n, d, e_n, dev, ties=ties)
    ei, cb, aux, _, idx, slots = moe_gate_dispatch_launch(x, gw, e_n, c_n,
                                                          top_k)
    ei_r, cb_r, aux_r = moe_gate_dispatch_reference(x, gw, e_n, c_n, top_k)
    _, idx_r, slots_r = moe_routing_reference(x, gw, e_n, c_n, top_k)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_r)
    assert torch.equal(slots, slots_r)
    assert torch.equal(ei, ei_r)
    _close(cb, cb_r, 1e-6, "combine")
    _close(aux, aux_r, 1e-6, "aux")


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_function_gradient_matches_plain_autograd(dev, top_k):
    x, gw = _moe_inputs(512, 64, 8, dev, seed=1)
    c_n = 100
    gen = torch.Generator().manual_seed(2)
    cots = [torch.randn(s, generator=gen).to(dev)
            for s in ((8, c_n, 64), (512, 8, c_n), (1, 1))]
    leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
    before = moe_gate_dispatch.launches
    outs = moe_gate_dispatch(*leaves, 8, c_n, top_k)
    assert moe_gate_dispatch.launches == before + 1
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
    want = torch.autograd.grad(
        moe_gate_dispatch_reference(*ref_leaves, 8, c_n, top_k), ref_leaves,
        cots)
    for name, g, w in zip(("x", "gate_w"), got, want):
        _close(g, w, 1e-5, "d" + name)


def test_moe_kernel_rejects_what_it_does_not_take(dev):
    x, gw = _moe_inputs(32, 16, 4, dev)
    with pytest.raises(ValueError, match="dtype"):
        moe_gate_dispatch(x.double(), gw.double(), 4, 8, 2)
    with pytest.raises(ValueError, match="top_k"):
        moe_gate_dispatch(x, gw, 4, 8, 3)


def test_moe_dense_has_no_plain_path_on_the_card(dev):
    """On the card moe_dense launches the kernel whatever the
    serving_kernels flag says, and raises for a call the kernel does
    not take (bfloat16) instead of running the plain composition."""
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.parallel.moe import moe_dense

    x, gw = _moe_inputs(64, 32, 4, dev)
    wi = torch.randn((4, 32, 16), device=dev) * 0.1
    wo = torch.randn((4, 16, 32), device=dev) * 0.1
    before = moe_gate_dispatch.launches
    tflags.set_flags({"serving_kernels": "off"})
    try:
        y, aux = moe_dense(x, gw, wi, wo, top_k=2)
    finally:
        tflags.reset_flags()
    assert moe_gate_dispatch.launches == before + 1
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError, match="dtype"):
        moe_dense(*(t.bfloat16() for t in (x, gw, wi, wo)), top_k=2)
    assert moe_gate_dispatch.launches == before + 1


# -- the data-parallel and MoE paths on the card ----------------------------

def test_pe_on_cuda_like_on_cpu(dev):
    """A small MLP through ShardingTranspiler at dp 1, with the fused
    update on the card against the per-op chain on the CPU, from the
    same parameters
    (losses 1e-5 relative, parameters 1e-5 absolute: cuBLAS and the CPU
    sum in other orders); one fused launch per bucket per step."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as tfw

    def build():
        tfw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[64], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(input=x, size=256, act="relu")
            logits = fluid.layers.fc(input=h, size=10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, y))
            fluid.SGD(learning_rate=0.1).minimize(loss)
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                    overlap="bucketed")
        return main, t, loss

    r = np.random.RandomState(0)
    feeds = [{"x": r.rand(32, 64).astype(np.float32),
              "y": r.randint(0, 10, (32, 1)).astype(np.int64)}
             for _ in range(4)]
    res, init = {}, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        main, t, loss = build()
        pe = t.build_executor(["x", "y"], [loss], place=place)
        params = [p.name for p in main.global_block().all_parameters()]
        if init is None:
            init = {n: pe.state(n) for n in params}
        for n in params:
            pe.set_state(n, init[n])
        before = fused_bucket_sgd.launches
        losses = [float(pe.run(f)[0][0]) for f in feeds]
        launched = fused_bucket_sgd.launches - before
        res[str(place)] = (losses, {n: pe.state(n) for n in params})
        on_card = place != fluid.CPUPlace()
        # "auto" arms the kernel tier on the card only
        assert pe.overlap_info["update"] == ("fused" if on_card
                                             else "plain:disarmed")
        assert launched == (4 * pe.overlap_info["buckets"] if on_card
                            else 0)
    (cl, cp), (gl, gp) = res["CPUPlace"], res["CUDAPlace(0)"]
    np.testing.assert_allclose(gl, cl, rtol=1e-5, atol=0)
    for n in cp:
        np.testing.assert_allclose(gp[n], cp[n], rtol=0, atol=1e-5)
    # no flag disarms the kernel on the card: "off" replans, still fused
    from paddle_tpu_torch.core import flags as tflags

    tflags.set_flags({"serving_kernels": "off"})
    try:
        before = fused_bucket_sgd.launches
        pe.run(feeds[0])
    finally:
        tflags.reset_flags()
    assert pe.overlap_info["update"] == "fused"
    assert fused_bucket_sgd.launches == before + pe.overlap_info["buckets"]


def test_moe_lm_trains_on_cuda_like_on_cpu(dev):
    """The MoE LM at a small width, 3 Momentum steps from the same
    parameters: the kernel path on the card against the plain path on
    the CPU (losses within 1e-4 relative); 2 MoE launches per layer per
    step on the card (the forward op and the grad op's recompute)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    from paddle_tpu_torch.models.moe import build_moe_lm

    vocab, seq, batch, n_layers = 61, 32, 4, 2
    tfw.reset_unique_names()
    main, startup, loss = build_moe_lm(batch, seq, vocab, 128, 2, n_layers,
                                       4, 2, 1.25)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    r = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        ids = r.randint(0, vocab, (batch, seq))
        feeds.append({"ids": ids.astype(np.int64),
                      "lbl": np.roll(ids, -1, 1)[..., None].astype(np.int64)})
    losses, init = {}, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        prev = texecutor.switch_scope(Scope())
        try:
            exe = fluid.Executor(place, seed=1)
            exe.run(startup)
            if init is None:
                init = scope_to_numpy(fluid.global_scope(), names)
            scope_from_numpy(init, place, fluid.global_scope())
            before = moe_gate_dispatch.launches
            losses[str(place)] = [
                float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
                for f in feeds]
            launched = moe_gate_dispatch.launches - before
        finally:
            texecutor.switch_scope(prev)
        assert launched == (0 if place == fluid.CPUPlace()
                            else 3 * 2 * n_layers)
    cpu, gpu = np.array(losses["CPUPlace"]), np.array(losses["CUDAPlace(0)"])
    assert np.all(np.isfinite(gpu))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=0)
