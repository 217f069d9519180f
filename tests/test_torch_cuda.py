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


def _edge_inputs(kv_dtype, w_n, dev, nb, seed=2):
    """A context of nb blocks of 16 with cursors whose last visible
    position sits on, one short of and one past the kernel's split
    edges, and at the context's end."""
    from paddle_tpu_torch.kernels.paged_attention import split_len_for

    gen = torch.Generator().manual_seed(seed)
    d_model, layers, bs = 512, 2, 16
    ctx = bs * nb
    sl = split_len_for(ctx)
    ends = [1, sl - 1, sl, sl + 1, 2 * sl, 2 * sl + 1, ctx - 1, ctx]
    positions = torch.tensor(sorted({max(e - w_n, 0) for e in ends}),
                             dtype=torch.int32)
    s_n = positions.numel()
    blocks = [-(-(int(p) + w_n) // bs) for p in positions]
    pool = sum(blocks) + 1
    tables = torch.zeros((s_n, nb), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=gen) + 1
    used = 0
    for s, n in enumerate(blocks):
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


@pytest.mark.parametrize("nb", [16, 264])
@pytest.mark.parametrize("w_n", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16", "int8"])
def test_paged_split_kernel_at_split_edges_is_plain_and_repeatable(
        dev, kv_dtype, w_n, nb):
    """Split-KV at split edges (contexts of 256 and 4224 positions:
    splits of 64 and of 128): within the gate of the plain version, and
    the same bits from call to call (the merge order is fixed; the
    ticket counter only picks the CTA that merges)."""
    q, pk, pv, tables, positions = _edge_inputs(kv_dtype, w_n, dev, nb)
    args = (q, pk, pv, tables, positions, 1)
    before = paged_attention.launches
    first = paged_attention(*args, n_heads=8)
    second = paged_attention(*args, n_heads=8)
    want = paged_attention_reference(*args, n_heads=8)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2
    assert torch.equal(first, second)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((first - want).abs().max()) <= tol


def test_built_paged_wrapper_is_the_direct_call_and_raises(dev):
    """The decoder's wrapper gives the direct call's bits, and a call
    the kernel does not take raises."""
    from paddle_tpu_torch.kernels.paged_attention import (
        build_paged_attention)

    q, pk, pv, tables, positions = _inputs("bf16", 1, 256, 4, dev)
    attend = build_paged_attention(n_heads=4)
    got = attend(q, pk, pv, tables, positions, 0)
    again = attend(q, pk, pv, tables, positions, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, paged_attention(q, pk, pv, tables, positions,
                                            0, n_heads=4))
    assert torch.equal(again, paged_attention(q, pk, pv, tables,
                                              positions, 1, n_heads=4))
    with pytest.raises(ValueError, match="int32"):
        attend(q, pk, pv, tables.long(), positions, 0)
    strided = q.new_empty(q.shape[::-1]).permute(2, 1, 0)
    strided.copy_(q)            # q's shape and values, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        attend(strided, pk, pv, tables, positions, 0)
    with pytest.raises(ValueError, match="layer"):
        attend(q, pk, pv, tables, positions, 2)


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
    orders).  On the card the block runs compiled: the first step
    eagerly, the second captured into a CUDA graph and replayed, the
    third replayed; the wrappers count the first two."""
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
        else:   # 2 layers: the forward op's launch; the grad op runs
            # the backward from the lse the forward saved, no recompute;
            # 2 steps counted (the eager run and the capture)
            assert launched == {"fwd": 4, "dq": 4, "dkv": 4}
            assert exe.graph_stats()["replays"] == 1
    cpu, gpu = np.array(losses["CPUPlace"]), np.array(losses["CUDAPlace(0)"])
    assert np.all(np.isfinite(gpu))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=0)


@pytest.mark.parametrize("sq,sk", [(128, 128), (80, 200)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grad_op_is_the_generic_route_bit_for_bit(dev, dtype, causal,
                                                        sq, sk):
    """The op's explicit gradient runs dQ and dK/dV from the forward's
    Out and the lse it carries: no forward launch, and the bits of the
    generic route (forward recompute + the Function's backward), whose
    forward is the same deterministic kernel.  An Out without an lse
    re-runs the forward kernel."""
    from paddle_tpu_torch.core.execution import (ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info("flash_attention")
    attrs = {**info.attrs, "causal": causal}
    q, k, v, do = _flash_inputs(2, sq, sk, 3, 64, dtype, dev, 5)
    ctx = ExecContext(dev)
    out = info.lower(ctx, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"]
    ins = {"Q": [q], "K": [k], "V": [v], "Out": [out], "Out@GRAD": [do]}
    results = {}
    for route, fn, fwd in (
            ("explicit", lambda: info.grad_lower(ctx, ins, attrs), 0),
            ("generic", lambda: generic_grad_lower(ctx, ins, attrs, info), 1),
            ("no_lse", lambda: info.grad_lower(
                ctx, dict(ins, Out=[out.clone()]), attrs), 1)):
        before = dict(flash_attention.launches)
        results[route] = fn()
        torch.cuda.synchronize()
        assert flash_attention.launches == {
            "fwd": before["fwd"] + fwd, "dq": before["dq"] + 1,
            "dkv": before["dkv"] + 1}, route
    for slot, (g,) in results["explicit"].items():
        assert g.dtype == dtype
        assert torch.equal(g, results["generic"][slot][0]), slot
        assert torch.equal(g, results["no_lse"][slot][0]), slot


@pytest.mark.parametrize("amp", [False, True])
def test_mul_grad_matches_autograd_on_the_card(dev, amp):
    """The explicit `mul` gradient against autograd's matmul backward
    (the generic route) on cuBLAS: within 1e-5 of the largest element in
    float32, one bf16 ulp of the larger value under amp; the weight's
    gradient float32 either way."""
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.core.execution import (ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info("mul")
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((4, 96, 256), generator=gen).to(dev)
    w = torch.randn((256, 384), generator=gen).to(dev)
    ctx = ExecContext(dev)
    with tamp.bf16_guard() if amp else _nullcontext():
        out = info.lower(ctx, {"X": [x], "Y": [w]}, attrs)["Out"]
        assert out.dtype == (torch.bfloat16 if amp else torch.float32)
        dout = torch.randn(tuple(out.shape), generator=gen).to(dev, out.dtype)
        ins = {"X": [x], "Y": [w], "Out": [out], "Out@GRAD": [dout]}
        got = info.grad_lower(ctx, ins, attrs)
        want = generic_grad_lower(ctx, ins, attrs, info)
    for slot in ("X@GRAD", "Y@GRAD"):
        g, r = got[slot][0].float(), want[slot][0].float()
        assert got[slot][0].dtype == want[slot][0].dtype == torch.float32
        if amp:
            top = torch.maximum(g.abs(), r.abs())
            ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30)))
                             - 7)
            assert bool(((g - r).abs() <= ulp).all()), slot
        else:
            _close(g, r, 1e-5, slot)


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


def test_amp_lm_trains_on_cuda_like_on_cpu(dev):
    """The tiny LM under bf16 amp, 3 Momentum steps from the same
    parameters: the card (bf16 flash kernels, cuBLAS bf16) against the
    CPU's plain path, each loss within one bf16 ulp (the card's kernels
    round bf16 at other places, as chip_smoke's LOSS_ULPS_BF16 states);
    every parameter stays float32; one forward launch per layer, counted
    on the eager first step and on the capture (the third step is a
    replay)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                             scope_to_numpy)
    from paddle_tpu_torch.models.transformer import transformer_lm

    vocab, seq, batch = 29, 32, 4
    with fluid.amp.bf16_guard():
        tfw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[seq], dtype="int64")
            lbl = fluid.layers.data(name="lbl", shape=[seq, 1],
                                    dtype="int64")
            logits = transformer_lm(ids, vocab, d_model=128, n_heads=2,
                                    n_layers=2, max_len=seq,
                                    return_logits=True)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                fluid.layers.reshape(logits, shape=[-1, vocab]),
                fluid.layers.reshape(lbl, shape=[-1, 1])))
            fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        base = np.arange(batch * seq).reshape(batch, seq) % 97
        losses, init = {}, None
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
                assert all(fluid.global_scope().find_var(n).dtype
                           == torch.float32 for n in names)
                replays = exe.graph_stats()["replays"]
            finally:
                texecutor.switch_scope(prev)
            losses[str(place)] = out
            assert replays == (0 if str(place) == "CPUPlace" else 1)
            want = 0 if str(place) == "CPUPlace" else 4
            assert launched == {"fwd": want, "dq": want, "dkv": want}
    cpu, gpu = np.array(losses["CPUPlace"]), np.array(losses["CUDAPlace(0)"])
    assert np.all(np.isfinite(gpu))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(cpu))) - 7)
    assert np.all(np.abs(gpu - cpu) <= ulp), (gpu, cpu)


# -- fused bucket SGD update -------------------------------------------------
#
# Bit-identical to its plain version (p - lr * g, two roundings): no
# tolerance.

from paddle_tpu_torch.kernels.fused_update import (  # noqa: E402
    fused_bucket_sgd_, fused_bucket_sgd_reference)


@pytest.mark.parametrize("numel", [1, 3, 4, 1023, 4096, (1 << 20) + 7])
@pytest.mark.parametrize("offset", [0, 1])
def test_fused_update_is_bit_identical_to_plain(dev, numel, offset):
    """In place (one read-write pointer) at odd sizes, and on views
    starting one element in (not 16-byte aligned: the kernel's scalar
    path); lr a device scalar."""
    gen = torch.Generator().manual_seed(numel)
    p = torch.randn(numel + offset, generator=gen).to(dev)[offset:]
    g = torch.randn(numel + offset, generator=gen).to(dev)[offset:]
    lr = torch.tensor([0.0123], device=dev)
    want = fused_bucket_sgd_reference(p, g, lr)
    before = fused_bucket_sgd_.launches
    ptr = p.data_ptr()
    got = fused_bucket_sgd_(p, g, lr)
    torch.cuda.synchronize()
    assert got is p and p.data_ptr() == ptr
    assert torch.equal(p, want)
    assert fused_bucket_sgd_.launches == before + 1


def test_fused_update_rejects_what_the_kernel_does_not_take(dev):
    p = torch.zeros(8, device=dev)
    lr = torch.tensor([0.1], device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_bucket_sgd_(p.double(), p.double(), lr)
    with pytest.raises(ValueError, match="lr"):
        fused_bucket_sgd_(p, p, torch.ones(2, device=dev))
    with pytest.raises(ValueError, match="1-D"):
        fused_bucket_sgd_(p, p[:4], lr)


# -- the dense embedding gradient --------------------------------------------

def test_embedding_grad_is_repeatable_on_the_card(dev):
    """4096 ids drawn from 64 values: two calls give the same W@GRAD
    bits, the bits of the CPU's index_add_ (the same per-id order), and
    within float32 rounding of CUDA's index_add_ (atomics, another
    order: 1e-5 * max(1, max|W@GRAD|))."""
    from paddle_tpu_torch.core.registry import get_op_info

    gen = torch.Generator().manual_seed(0)
    rows, d = 1000, 256
    ids = torch.randint(0, 64, (16, 256), generator=gen)
    og = torch.randn((16, 256, d), generator=gen)
    lower = get_op_info("lookup_table_grad").lower
    attrs = {"is_sparse": False, "padding_idx": 3}

    def run(device):
        ins = {"Ids": [ids.to(device)], "W": [torch.zeros(rows, d,
                                                          device=device)],
               "Out@GRAD": [og.to(device)]}
        return lower(None, ins, attrs)["W@GRAD"]

    first, second = run(dev), run(dev)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), run("cpu"))
    flat = ids.reshape(-1).to(dev)
    og2 = og.reshape(-1, d).to(dev)
    og2 = torch.where((flat == 3)[:, None], torch.zeros((), device=dev), og2)
    atomic = torch.zeros(rows, d, device=dev).index_add_(0, flat, og2)
    tol = 1e-5 * max(1.0, float(atomic.abs().max()))
    assert float((first - atomic).abs().max()) <= tol
    assert not first[3].any() and not first[64:].any()


# -- the SelectedRows gradient -----------------------------------------------

@pytest.mark.parametrize("op", ["sgd", "adam"])
def test_sparse_update_is_repeatable_on_the_card(dev, op):
    """A SelectedRows of 4096 rows drawn from 64 ids into a [1000, 16]
    table: the update gives the same bits on two calls; the densify
    (SelectedRows.to_dense) and sgd's scatter give the CPU's bits
    (ordered segment sums, no atomics), adam's arithmetic is within
    1e-6 * max(1, max|CPU|) of the CPU's (its sqrt and division differ
    by an ulp); sgd leaves the rows no id names untouched."""
    from paddle_tpu_torch.core.lod import SelectedRows
    from paddle_tpu_torch.core.registry import get_op_info

    gen = torch.Generator().manual_seed(1)
    rows, d = 1000, 16
    ids = torch.randint(0, 64, (4096,), generator=gen)
    value = torch.randn((4096, d), generator=gen)
    p = torch.randn((rows, d), generator=gen)
    info = get_op_info(op)
    state = {"Moment1": torch.zeros(rows, d), "Moment2": torch.zeros(rows, d),
             "Beta1Pow": torch.tensor([0.9]),
             "Beta2Pow": torch.tensor([0.999])}

    def run(device):
        ins = {"Param": [p.to(device)],
               "Grad": [SelectedRows(ids.to(device), value.to(device),
                                     rows)],
               "LearningRate": [torch.tensor([0.1], device=device)]}
        if op == "adam":
            ins.update({k: [v.to(device)] for k, v in state.items()})
        return info.lower(None, ins, dict(info.attrs))["ParamOut"]

    first, second = run(dev), run(dev)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    grad = SelectedRows(ids, value, rows)
    assert torch.equal(grad.map(lambda t: t.to(dev)).to_dense().cpu(),
                       grad.to_dense())
    cpu = run("cpu")
    if op == "sgd":
        assert torch.equal(first.cpu(), cpu)
        assert torch.equal(first[64:].cpu(), p[64:])
    else:
        tol = 1e-6 * max(1.0, float(cpu.abs().max()))
        assert float((first.cpu() - cpu).abs().max()) <= tol


# -- MoE gate + dispatch -----------------------------------------------------
#
# Routing is identical (idx, slot_of, slot_token) and expert_in bit-equal
# (a gather of x); slot_weight, the dense combine and aux within 1e-6 *
# max(1, max|plain|) (softmax and the aux means sum in another order);
# the Functions' gradients and the backward kernel equal plain
# autograd's / the plain VJP within 1e-5 * max(1, max|plain|) (the same
# VJP at the kernel's routing, summed in another order).  Two calls of a
# kernel give the same bits.

from paddle_tpu_torch.kernels.moe_dispatch import (  # noqa: E402
    moe_gate_dispatch, moe_gate_dispatch_launch, moe_gate_dispatch_reference,
    moe_gate_route, moe_gate_route_backward, moe_gate_route_launch,
    moe_gate_route_reference, moe_gate_route_vjp, moe_route_backward_launch,
    moe_routing_reference)

_MOE_CASES = [
    (256, 64, 4, 80, 2, False), (256, 64, 4, 20, 2, False),
    (256, 64, 4, 80, 1, False), (256, 64, 4, 30, 1, False),
    (300, 60, 5, 70, 2, True), (1000, 128, 8, 250, 2, False),
    (64, 32, 64, 3, 2, False), (2048, 256, 8, 320, 2, False),
    (100, 1030, 64, 4, 2, False), (77, 33, 3, 40, 1, False)]


def _moe_inputs(t_n, d, e_n, dev, seed=0, ties=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((t_n, d), generator=gen)
    gw = torch.randn((d, e_n), generator=gen) * 0.05
    if ties:   # experts 1 and 2 identical: every token ties between them
        gw[:, 2] = gw[:, 1]
    return x.to(dev), gw.to(dev)


@pytest.mark.parametrize("t_n,d,e_n,c_n,top_k,ties", _MOE_CASES)
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
    bwd = moe_gate_route_backward.launches
    outs = moe_gate_dispatch(*leaves, 8, c_n, top_k)
    assert moe_gate_dispatch.launches == before + 1
    got = torch.autograd.grad(outs, leaves, cots)
    assert moe_gate_route_backward.launches == bwd + 1
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
    want = torch.autograd.grad(
        moe_gate_dispatch_reference(*ref_leaves, 8, c_n, top_k), ref_leaves,
        cots)
    for name, g, w in zip(("x", "gate_w"), got, want):
        _close(g, w, 1e-5, "d" + name)


@pytest.mark.parametrize("t_n,d,e_n,c_n,top_k,ties", _MOE_CASES)
def test_moe_routing_form_matches_plain_and_repeats(dev, t_n, d, e_n, c_n,
                                                    top_k, ties):
    x, gw = _moe_inputs(t_n, d, e_n, dev, ties=ties)
    runs = [moe_gate_route_launch(x, gw, e_n, c_n, top_k, dense=dense)
            for dense in (False, True, False)]
    ei, sw, aux, slot_of, slot_token, probs, idx, first, _ = runs[0]
    ei_r, sw_r, aux_r, slot_of_r, slot_token_r = moe_gate_route_reference(
        x, gw, e_n, c_n, top_k)
    _, idx_r, _ = moe_routing_reference(x, gw, e_n, c_n, top_k)
    _, cb_r, _ = moe_gate_dispatch_reference(x, gw, e_n, c_n, top_k)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_r)
    assert torch.equal(slot_of, slot_of_r)
    assert torch.equal(slot_token, slot_token_r)
    assert torch.equal(ei, ei_r)
    assert torch.equal(first.long(), torch.bincount(idx_r[0].long(),
                                                    minlength=e_n))
    _close(sw, sw_r, 1e-6, "slot_weight")
    _close(aux, aux_r, 1e-6, "aux")
    _close(runs[1][8], cb_r, 1e-6, "combine")
    # the dense contract changes nothing else, and a call repeats bit
    # for bit
    for other in runs[1:]:
        for a, b in zip(runs[0][:8], other[:8]):
            assert torch.equal(a, b)


def _route_cotangents(e_n, c_n, d, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev)
            for s in ((e_n, c_n, d), (e_n, c_n), (1, 1))]


@pytest.mark.parametrize("t_n,d,e_n,c_n,top_k,ties", _MOE_CASES)
@pytest.mark.parametrize("which", ["all", "expert_in", "slot_weight", "aux"])
def test_moe_backward_kernel_matches_plain_vjp(dev, t_n, d, e_n, c_n, top_k,
                                               ties, which):
    x, gw = _moe_inputs(t_n, d, e_n, dev, seed=3, ties=ties)
    (_, _, _, slot_of, _, probs, idx, first,
     _) = moe_gate_route_launch(x, gw, e_n, c_n, top_k)
    cots = _route_cotangents(e_n, c_n, d, dev, 4)
    if which != "all":
        keep = ("expert_in", "slot_weight", "aux").index(which)
        cots = [c if i == keep else None for i, c in enumerate(cots)]
    want = moe_gate_route_vjp(x, gw, probs, idx, slot_of, *cots)
    before = moe_gate_route_backward.launches
    got = moe_gate_route_backward(x, gw, probs, idx, slot_of, first, *cots,
                                  capacity=c_n)
    again = moe_gate_route_backward(x, gw, probs, idx, slot_of, first, *cots,
                                    capacity=c_n)
    assert moe_gate_route_backward.launches == before + 2
    for name, g, w, a in zip(("dx", "dgate_w"), got, want, again):
        _close(g, w, 1e-5, name)
        assert torch.equal(g, a), name
    kern = [moe_route_backward_launch(gw, probs, idx, slot_of, first, *cots,
                                      c_n, d) for _ in range(2)]
    for a, b in zip(*kern):
        assert torch.equal(a, b)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_route_function_gradient_matches_plain_autograd(dev, top_k):
    x, gw = _moe_inputs(512, 64, 8, dev, seed=1)
    c_n = 100
    cots = _route_cotangents(8, c_n, 64, dev, 2)
    leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
    fwd, bwd = moe_gate_dispatch.launches, moe_gate_route_backward.launches
    outs = moe_gate_route(*leaves, 8, c_n, top_k)
    assert moe_gate_dispatch.launches == fwd + 1
    assert [o.requires_grad for o in outs] == [True, True, True, False,
                                               False]
    got = torch.autograd.grad(outs[:3], leaves, cots)
    assert moe_gate_route_backward.launches == bwd + 1
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, gw)]
    want = torch.autograd.grad(
        moe_gate_route_reference(*ref_leaves, 8, c_n, top_k)[:3], ref_leaves,
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


def test_moe_dense_forms_no_dense_combine_on_the_card(dev):
    """moe_dense's forward and backward on the card: one forward and one
    backward kernel launch, and no tensor as large as a [T, E, C]
    combine, neither made by an op nor saved for the backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from paddle_tpu_torch.parallel.moe import _capacity, moe_dense

    class Largest(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    Largest.largest = max(Largest.largest, t.numel())
            return out

    t_n, d, e_n, h = 512, 64, 8, 32
    x, gw = _moe_inputs(t_n, d, e_n, dev, seed=5)
    gen = torch.Generator().manual_seed(6)
    wi = (torch.randn((e_n, d, h), generator=gen) * 0.1).to(dev)
    wo = (torch.randn((e_n, h, d), generator=gen) * 0.1).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, gw, wi, wo)]
    tec = t_n * e_n * _capacity(t_n, e_n, 1.25, 2)
    saved = []
    fwd, bwd = moe_gate_dispatch.launches, moe_gate_route_backward.launches
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        with Largest():
            y, aux = moe_dense(*leaves, top_k=2)
            torch.autograd.grad(y.sum() + aux, leaves)
    torch.cuda.synchronize()
    assert moe_gate_dispatch.launches == fwd + 1
    assert moe_gate_route_backward.launches == bwd + 1
    assert saved and max(saved) < tec
    assert 0 < Largest.largest < tec


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
        before = fused_bucket_sgd_.launches
        losses = [float(pe.run(f)[0][0]) for f in feeds]
        launched = fused_bucket_sgd_.launches - before
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
        before = fused_bucket_sgd_.launches
        pe.run(feeds[0])
    finally:
        tflags.reset_flags()
    assert pe.overlap_info["update"] == "fused"
    assert fused_bucket_sgd_.launches == before + pe.overlap_info["buckets"]


def test_moe_lm_trains_on_cuda_like_on_cpu(dev):
    """The MoE LM at a small width, 3 Momentum steps from the same
    parameters: the kernel path on the card against the plain path on
    the CPU (losses within 1e-4 relative); 2 MoE launches per layer per
    step on the card (the forward op and the grad op's recompute),
    counted on the eager first step and the capture (then a replay)."""
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
            replays = exe.graph_stats()["replays"]
        finally:
            texecutor.switch_scope(prev)
        if place == fluid.CPUPlace():
            assert launched == 0
        else:
            assert launched == 2 * 2 * n_layers
            assert replays == 1
    cpu, gpu = np.array(losses["CPUPlace"]), np.array(losses["CUDAPlace(0)"])
    assert np.all(np.isfinite(gpu))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=0)


# -- the Executor's compiled block as a CUDA graph ---------------------------
#
# The miss runs the plan eagerly, the first hit captures it and every
# later hit replays the graph: same kernels, same order, one stream, so
# the replay must give the interpreter's bits.

def _graph_lm(amp):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.models.transformer import transformer_lm

    vocab, seq = 29, 32
    with (fluid.amp.bf16_guard() if amp else _nullcontext()):
        tfw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[seq], dtype="int64")
            lbl = fluid.layers.data(name="lbl", shape=[seq, 1],
                                    dtype="int64")
            logits = transformer_lm(ids, vocab, d_model=128, n_heads=2,
                                    n_layers=2, max_len=seq,
                                    return_logits=True)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                fluid.layers.reshape(logits, shape=[-1, vocab]),
                fluid.layers.reshape(lbl, shape=[-1, 1])))
            fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, loss


def _graph_feed(step, batch=4, seq=32, vocab=29):
    import numpy as np

    base = np.arange(batch * seq).reshape(batch, seq) % 97
    return {"ids": ((base + step) % vocab).astype(np.int64),
            "lbl": ((base + step + 1) % vocab).astype(np.int64)[..., None]}


def _graph_run(main, startup, loss, init, steps, compiled, amp,
               between=None):
    """`steps` steps from the persistables `init` (None: from the
    startup) -> (losses as bits, {name: final value}, executor)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    prev = texecutor.switch_scope(Scope())
    try:
        with (fluid.amp.bf16_guard() if amp else _nullcontext()):
            scope = fluid.global_scope()
            exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
            if init is None:
                exe.run(startup)
            else:
                for n, v in init.items():
                    scope.set_var(n, v.clone())
            out = []
            for step in range(steps):
                if between is not None:
                    between(step, scope)
                out.append(exe.run(main, feed=_graph_feed(step),
                                   fetch_list=[loss], compiled=compiled,
                                   return_numpy=False)[0])
            torch.cuda.synchronize()
            names = sorted(v.name for v in main.list_vars()
                           if v.persistable)
            final = {n: scope.find_var(n).clone() for n in names}
    finally:
        texecutor.switch_scope(prev)
    return [t.cpu().view(torch.int32).tolist() for t in out], final, exe


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_graph_replay_is_the_interpreter_bit_for_bit(dev, amp):
    main, startup, loss = _graph_lm(amp)
    _, init, _ = _graph_run(main, startup, loss, None, 0, None, amp)
    g_loss, g_final, exe = _graph_run(main, startup, loss, init, 5, None,
                                      amp)
    i_loss, i_final, _ = _graph_run(main, startup, loss, init, 5, False,
                                    amp)
    assert exe.graph_stats()["captures"] == 1
    assert exe.graph_stats()["replays"] == 3
    assert exe.cache_stats()["recompiles_after_warmup"] == 0
    assert g_loss == i_loss
    _same_bits(g_final, i_final)
    exe.close()


def test_graph_replay_reads_a_state_rebound_in_the_scope(dev):
    """After the capture, a weight set anew in the scope (as a checkpoint
    load does) is copied into the graph's buffer before the replay."""
    main, startup, loss = _graph_lm(False)
    _, init, _ = _graph_run(main, startup, loss, None, 0, None, False)
    w = next(p.name for p in main.global_block().all_parameters()
             if len(p.shape) == 2)

    def rebind(step, scope):
        if step == 3:
            scope.set_var(w, torch.full_like(scope.find_var(w), 0.01))

    g_loss, g_final, exe = _graph_run(main, startup, loss, init, 5, None,
                                      False, rebind)
    i_loss, i_final, _ = _graph_run(main, startup, loss, init, 5, False,
                                    False, rebind)
    assert exe.graph_stats()["replays"] == 3
    assert g_loss == i_loss
    _same_bits(g_final, i_final)
    exe.close()


def test_a_replayed_step_makes_no_host_sync(dev):
    """Feeds go through pinned memory, the graph is one launch and the
    fetch a clone on the card: under sync debug mode "error" a replayed
    step raises nothing."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = _graph_lm(False)
    prev = texecutor.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
        exe.run(startup)
        for step in range(2):       # the miss, then the capture
            exe.run(main, feed=_graph_feed(step), fetch_list=[loss])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = exe.run(main, feed=_graph_feed(2), fetch_list=[loss],
                          return_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert exe.graph_stats()["replays"] == 1
        assert torch.isfinite(out[0]).all()
        exe.close()
    finally:
        texecutor.switch_scope(prev)


def test_close_releases_the_graph_pool(dev):
    import gc

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = _graph_lm(False)
    prev = texecutor.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
        exe.run(startup)
        for step in range(3):
            exe.run(main, feed=_graph_feed(step), fetch_list=[loss])
        torch.cuda.synchronize()
        gc.collect()
        held = torch.cuda.memory_reserved()
        assert exe.graph_stats()["graphs"] == 1
        exe.close()
        gc.collect()
        assert exe.graph_stats()["graphs"] == 0
        assert torch.cuda.memory_reserved() < held
    finally:
        texecutor.switch_scope(prev)


def test_segmented_random_op_draws_fresh_on_the_card(dev):
    """A random op between device ops: on the card it runs eagerly
    between two segments (each captured at its first hit, then
    replayed), drawing anew every run, with the interpreter's values."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as tfw

    tfw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.scale(x, scale=3.0)
        blk = main.global_block()
        noise = blk.create_var(name="noise", shape=[2, 4], dtype="float32")
        blk.append_op(type="gaussian_random", outputs={"Out": [noise]},
                      attrs={"shape": [2, 4], "mean": 0.0, "std": 1.0,
                             "dtype": "float32"})
        out = fluid.layers.mean(fluid.layers.elementwise_add(h, noise))
    feed = {"x": np.ones((2, 4), np.float32)}
    got = {}
    for compiled in (None, False):
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=5)
        got[compiled] = [exe.run(main, feed=feed, fetch_list=[out],
                                 compiled=compiled)[0] for _ in range(4)]
        if compiled is None:
            assert exe.cache_stats()["misses"] == 2      # two segments
            assert exe.graph_stats()["captures"] == 2
            assert exe.graph_stats()["replays"] == 4
        exe.close()
    for a, b in zip(got[None], got[False]):
        assert a.tobytes() == b.tobytes()
    assert len({a.tobytes() for a in got[None]}) == 4


# -- conv nets: conv2d, pool2d, batch_norm on the card -----------------------

def _op_on(op, arrays, attrs, device, dtype=torch.float32):
    """Run the port's lowering of `op` on `device` -> {slot: tensor}."""
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info(op)
    ins = {s: [a.to(device, dtype if a.is_floating_point() else a.dtype)]
           for s, a in arrays.items()}
    out = info.lower(ExecContext(device), ins, {**info.attrs, **attrs})
    return {s: (v[0] if isinstance(v, list) else v) for s, v in out.items()}


def _grad_on(op, arrays, attrs, device):
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info(op)
    ins = {s: [a.to(device)] for s, a in arrays.items()}
    out = info.grad_lower(ExecContext(device), ins, {**info.attrs, **attrs})
    return {s: v[0] for s, v in out.items()}


def _close_to_cpu(got, want, tol=1e-5):
    got = got.float().cpu()
    assert got.shape == want.shape
    assert float((got - want.float()).abs().max()) <= \
        tol * max(1.0, float(want.abs().max()))


_CARD_CONVS = [  # (x shape, w shape, strides, paddings, groups, layout)
    ((4, 3, 32, 32), (16, 3, 7, 7), [2, 2], [3, 3], 1, "NCHW"),
    ((4, 16, 16, 16), (32, 16, 3, 3), [1, 1], [1, 1], 1, "NCHW"),
    ((4, 32, 16, 16), (64, 32, 1, 1), [2, 2], [0, 0], 1, "NCHW"),
    ((4, 16, 16, 16), (16, 4, 3, 3), [1, 1], [1, 1], 4, "NCHW"),
    ((4, 16, 16, 16), (32, 16, 3, 3), [1, 1], [1, 1], 1, "NHWC"),
]


@pytest.mark.parametrize("case", _CARD_CONVS, ids=range(len(_CARD_CONVS)))
def test_conv_on_the_card_matches_cpu_with_tf32_switched_on(dev, case):
    """float32 convolution and its explicit gradient: the lowering pins
    full float32 itself, whatever the caller's TF32 switches say."""
    xs, ws, s, p, g, layout = case
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(xs, generator=gen), torch.randn(ws, generator=gen)
    attrs = {"strides": s, "paddings": p, "dilations": [1, 1], "groups": g,
             "data_format": layout}
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        arrays = {"Input": x, "Filter": w}
        cpu = _op_on("conv2d", arrays, attrs, torch.device("cpu"))
        card = _op_on("conv2d", arrays, attrs, dev)
        _close_to_cpu(card["Output"], cpu["Output"])
        dy = torch.randn(cpu["Output"].shape, generator=gen)
        gins = {**arrays, "Output": cpu["Output"], "Output@GRAD": dy}
        g_cpu = _grad_on("conv2d", gins, attrs, torch.device("cpu"))
        g_card = _grad_on("conv2d", gins, attrs, dev)
        for slot in ("Input@GRAD", "Filter@GRAD"):
            _close_to_cpu(g_card[slot], g_cpu[slot])
        assert torch.backends.cudnn.allow_tf32      # the caller's, back
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_grad_matches_cudnn_autograd_on_the_card(dev, dtype):
    """The explicit conv2d gradient against autograd through F.conv2d
    with the same backend settings (cuDNN for bf16, PyTorch's own
    convolution for float32)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.conv import conv_pinned

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((8, 64, 28, 28), generator=gen).to(dev, dtype)
    w = torch.randn((128, 64, 3, 3), generator=gen).to(dev, dtype)
    attrs = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "data_format": "NCHW"}
    with conv_pinned(dtype):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.conv2d(xl, wl, None, 2, 1)
        dy = torch.randn(y.shape, generator=gen).to(dev, dtype)
        dx, dw = torch.autograd.grad(y, [xl, wl], dy)
    got = _grad_on("conv2d", {"Input": x, "Filter": w, "Output": y.detach(),
                              "Output@GRAD": dy}, attrs, dev)
    torch.cuda.synchronize()
    for slot, want in (("Input@GRAD", dx), ("Filter@GRAD", dw)):
        t = got[slot]
        assert t.dtype == dtype
        tol = (1e-5 if dtype == torch.float32 else 2.0 ** -8) * float(
            want.float().abs().max())
        assert float((t.float() - want.float()).abs().max()) <= tol, slot


@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "global_pooling": True}])
def test_pool_on_the_card_matches_cpu(dev, attrs):
    x = torch.randn((4, 8, 15, 15), generator=torch.Generator().manual_seed(2))
    cpu = _op_on("pool2d", {"X": x}, attrs, torch.device("cpu"))
    card = _op_on("pool2d", {"X": x}, attrs, dev)
    _close_to_cpu(card["Out"], cpu["Out"])


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_on_the_card_matches_cpu(dev, is_test):
    gen = torch.Generator().manual_seed(3)
    c = 16
    arrays = {"X": torch.randn((8, c, 12, 12), generator=gen) * 2 + 3,
              "Scale": torch.rand(c, generator=gen) + 0.5,
              "Bias": torch.randn(c, generator=gen),
              "Mean": torch.randn(c, generator=gen) * 0.1,
              "Variance": torch.rand(c, generator=gen) + 0.5}
    attrs = {"is_test": is_test}
    cpu = _op_on("batch_norm", arrays, attrs, torch.device("cpu"))
    card = _op_on("batch_norm", arrays, attrs, dev)
    for slot in cpu:
        _close_to_cpu(card[slot], cpu[slot])
    gins = {**arrays, **cpu,
            "Y@GRAD": torch.randn(cpu["Y"].shape, generator=gen)}
    g_cpu = _grad_on("batch_norm", gins, attrs, torch.device("cpu"))
    g_card = _grad_on("batch_norm", gins, attrs, dev)
    for slot in g_cpu:
        _close_to_cpu(g_card[slot], g_cpu[slot])


def _small_resnet(dtype):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models
    from paddle_tpu_torch.core import framework as tfw

    tfw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        pred = models.resnet_imagenet(img, class_dim=10, depth=18)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                            label=label))
        fluid.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_step_is_repeatable_on_the_card(dev, dtype):
    """Two runs of the same ResNet-18 steps from the same state give the
    same bits (deterministic cuDNN algorithms, a gather-style max-pool
    backward, no atomics), interpreted and as a replayed CUDA graph, and
    the two modes agree bit for bit."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss = _small_resnet(dtype)
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.rand(16, 3, 32, 32).astype(np.float32))
    feed = {"img": x.to(getattr(torch, dtype)),
            "label": r.randint(0, 10, (16, 1)).astype(np.int64)}
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    prev = texecutor.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
        exe.run(startup)
        init = {n: fluid.global_scope().find_var(n).clone() for n in names}
        runs = []
        for compiled in (False, False, None, None):
            texecutor.switch_scope(Scope())
            for n in names:
                fluid.global_scope().set_var(n, init[n].clone())
            exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
            losses = [exe.run(main, feed=feed, fetch_list=[loss],
                              compiled=compiled, return_numpy=False)[0]
                      .float().item() for _ in range(3)]
            runs.append((losses, {n: fluid.global_scope().find_var(n)
                                  .clone() for n in names}))
            if compiled is None:
                assert exe.graph_stats()["replays"] == 1
            exe.close()
    finally:
        texecutor.switch_scope(prev)
    for losses, final in runs[1:]:
        assert losses == runs[0][0]
        _same_bits(final, runs[0][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keyed_dropout_mask_on_the_card_is_the_cpus(dev, dtype):
    """The batch-position-keyed draw in integer ops: the card's mask is
    the CPU's bit for bit, whole and from two halves at their row
    offsets, through several chunks."""
    from paddle_tpu_torch.ops.activation import keyed_uniform_mask

    shape, p, seed = (64, 3, 40, 40), 0.3, 123456789
    cpu = keyed_uniform_mask(shape, p, seed, 0, dtype, "cpu")
    card = keyed_uniform_mask(shape, p, seed, 0, dtype, dev)
    assert torch.equal(card.cpu(), cpu)
    halves = torch.cat([keyed_uniform_mask((32,) + shape[1:], p, seed, r0,
                                           dtype, dev) for r0 in (0, 32)])
    assert torch.equal(halves, card)


def test_lrn_and_concat_on_the_card_match_cpu(dev):
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 9, 9, generator=gen) * 3
    lrn = get_op_info("lrn")
    attrs = {**lrn.attrs, "alpha": 1e-2}
    want = lrn.lower(ExecContext("cpu"), {"X": [x]}, attrs)
    got = lrn.lower(ExecContext(dev), {"X": [x.to(dev)]}, attrs)
    for slot in ("Out", "MidOut"):
        torch.testing.assert_close(got[slot].cpu(), want[slot], rtol=1e-5,
                                   atol=1e-6)
    parts = [x[:, :3], x[:, 3:10], x[:, 10:]]
    cat = get_op_info("concat").lower(
        ExecContext(dev), {"X": [t.to(dev) for t in parts]}, {"axis": 1})
    assert torch.equal(cat["Out"].cpu(), x)


# -- LoD sequences and the recurrence ----------------------------------------

def _lod_grad(op, ins, attrs, dev, seed=0):
    """The generic gradient of `op` on the card for seeded cotangents of
    its Out (Hidden for lstm) -> {slot@GRAD: [tensor]}."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 data_of,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info

    info = get_op_info(op)
    attrs = {**info.attrs, **attrs}
    outs = info.lower(ExecContext(dev), ins, attrs)
    slot = "Hidden" if op == "lstm" else "Out"
    out = data_of(outs[slot])
    gen = torch.Generator().manual_seed(seed)
    g = dict(ins)
    g.update({s: [v] for s, v in outs.items() if v is not None})
    g[slot + GRAD] = [torch.randn(out.shape, generator=gen).to(dev)]
    res = generic_grad_lower(ExecContext(dev), g, attrs, info)
    return {k: [data_of(v) for v in vs] for k, vs in res.items()}


def test_lod_gradients_are_bit_equal_call_to_call(dev):
    """sequence_expand (rows repeated), SUM pooling (segment sums) and
    dynamic_lstm (padded gather, recurrence, repack) give the same
    gradient bits on two calls: no atomics on the path."""
    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    gen = torch.Generator().manual_seed(0)
    lens = [int(n) for n in torch.randint(1, 60, (64,), generator=gen)]
    lod = [lod_from_seq_lens(lens)]
    n, d = sum(lens), 32
    x = torch.randn((n, 4 * d), generator=gen).to(dev)
    cases = [
        ("sequence_expand",
         {"X": [torch.randn((64, 48), generator=gen).to(dev)],
          "Y": [LoDTensor(torch.zeros((n, 1), device=dev), lod)]}, {}),
        ("sequence_pool", {"X": [LoDTensor(x, lod)]}, {"pooltype": "SUM"}),
        ("lstm", {"Input": [LoDTensor(x, lod)],
                  "Weight": [(0.1 * torch.randn((d, 4 * d), generator=gen))
                             .to(dev)],
                  "Bias": [torch.randn((1, 7 * d), generator=gen).to(dev)]},
         {}),
    ]
    for op, ins, attrs in cases:
        a = _lod_grad(op, ins, attrs, dev)
        b = _lod_grad(op, ins, attrs, dev)
        assert set(a) == set(b) and a, op
        for k in a:
            for u, v in zip(a[k], b[k]):
                assert torch.equal(u, v), f"{op} {k}"


def _lod_classifier_runs(feeds, order, compiled, cache_max=None,
                         graphs_max=None):
    """A small LSTM classifier trained on `feeds[i]` for i in `order` on
    the card from a seeded startup, the Executor's bounds set for the
    run -> (losses, graph_stats())."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=words, size=[100, 16])
        proj = fluid.layers.fc(input=emb, size=32)
        h, _ = fluid.layers.dynamic_lstm(input=proj, size=32)
        last = fluid.layers.sequence_pool(h, pool_type="last")
        pred = fluid.layers.fc(input=last, size=2, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.Adam(learning_rate=1e-3).minimize(loss)
    bounds = (executor_mod.CACHE_MAX, executor_mod.GRAPHS_MAX)
    prev = executor_mod.switch_scope(Scope())
    try:
        executor_mod.CACHE_MAX = cache_max or bounds[0]
        executor_mod.GRAPHS_MAX = graphs_max or bounds[1]
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=0)
        torch.manual_seed(0)
        exe.run(startup)
        out = [float(exe.run(main, feed=feeds[i], fetch_list=[loss],
                             compiled=compiled)[0][0]) for i in order]
        stats = exe.graph_stats()
        exe.close()
        return out, stats
    finally:
        executor_mod.CACHE_MAX, executor_mod.GRAPHS_MAX = bounds
        executor_mod.switch_scope(prev)


def _lod_feeds(lengths):
    import numpy as np

    from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens

    r = np.random.RandomState(0)
    feeds = []
    for lens in lengths:
        ids = r.randint(0, 100, (sum(lens), 1)).astype(np.int64)
        feeds.append({"words": LoDTensor(ids, [lod_from_seq_lens(lens)]),
                      "label": r.randint(0, 2, (len(lens), 1))
                      .astype(np.int64)})
    return feeds


@pytest.mark.parametrize("graphs_max", [32, 1], ids=["two_graphs",
                                                   "one_graph_cap"])
def test_lod_feed_is_captured_and_replayed_under_two_lods(dev, graphs_max):
    """One Program, two LoDs fed in turns: a miss and a capture for each
    LoD, replays after, each replay's loss the interpreter's.  With room
    for one graph, the first LoD's graph stays and the other LoD's hits
    run eagerly (one capture, two replays, three eager hits), with the
    same losses."""
    feeds = _lod_feeds(([3, 7, 2, 5], [6, 1, 4, 4]))
    order = [0, 0, 1, 1, 0, 1, 0, 1]
    k_loss, stats = _lod_classifier_runs(feeds, order, None,
                                         graphs_max=graphs_max)
    i_loss, _ = _lod_classifier_runs(feeds, order, False)
    if graphs_max == 1:
        assert stats["captures"] == 1 and stats["replays"] == 2
        assert stats["eager_hits"] == 3 and stats["graphs"] == 1
    else:
        assert stats["captures"] == 2 and stats["replays"] == 4
        assert stats["eager_hits"] == 0
    assert k_loss == i_loss


def test_a_lod_fed_again_after_its_entry_went_is_captured_again(dev):
    """Three LoDs through a cache of two entries: each LoD's entry (its
    graph and index tables with it) goes two LoDs later, so the first
    LoD fed again is a miss that rebuilds its tables, a capture at its
    next hit that reads them, and a replay after, each loss the
    interpreter's."""
    feeds = _lod_feeds(([3, 7, 2, 5], [6, 1, 4, 4], [2, 2, 9, 1]))
    order = [0, 0, 1, 1, 2, 2, 0, 0, 0]
    k_loss, stats = _lod_classifier_runs(feeds, order, None, cache_max=2)
    i_loss, _ = _lod_classifier_runs(feeds, order, False)
    assert stats["captures"] == 4 and stats["replays"] == 1
    assert stats["graphs"] == 2 and stats["eager_hits"] == 0
    assert k_loss == i_loss


def _dyn_rnn_runs(feeds, order, compiled):
    """A DynamicRNN decoder step (book/08's: fc of the word and the
    state, tanh, an fc softmax head) trained with Adam on `feeds[i]` for
    i in `order` on the card from a seeded startup -> (losses,
    graph_stats())."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(input=words, size=[100, 16])
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(emb)
            h = rnn.memory(shape=[32], value=0.0)
            nh = fluid.layers.fc(input=[word, h], size=32, act="tanh")
            rnn.update_memory(h, nh)
            rnn.output(fluid.layers.fc(input=nh, size=100, act="softmax"))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(rnn(), label))
        fluid.Adam(learning_rate=1e-3).minimize(loss)
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=0)
        torch.manual_seed(0)
        exe.run(startup)
        out = [float(exe.run(main, feed=feeds[i], fetch_list=[loss],
                             compiled=compiled)[0][0]) for i in order]
        stats = exe.graph_stats()
        exe.close()
        return out, stats
    finally:
        executor_mod.switch_scope(prev)


def test_dynamic_rnn_step_is_captured_and_replayed_under_two_lods(dev):
    """A training step holding a `dynamic_rnn` (no host op in its block,
    so a device op) is one CUDA graph a LoD: two LoDs fed in turns, a
    miss and a capture each, replays after, every loss the
    interpreter's bit for bit."""
    feeds = _lod_feeds(([3, 7, 2, 5], [6, 1, 4, 4]))
    for f in feeds:
        f["label"] = f["words"]
    order = [0, 0, 1, 1, 0, 1, 0, 1]
    k_loss, stats = _dyn_rnn_runs(feeds, order, None)
    i_loss, _ = _dyn_rnn_runs(feeds, order, False)
    assert stats["captures"] == 2 and stats["replays"] == 4
    assert stats["eager_hits"] == 0 and stats["graphs"] == 2
    assert k_loss == i_loss


def test_while_beam_search_decode_on_the_card_equals_the_cpu(dev):
    """book/08's While + beam_search decoder (chip_smoke's builder at a
    small width) on the card (segmented: the loop a host op, its body op
    by op on the card) and on the CPU from the same parameters: every
    step's selections equal, the same sentences and LoDs, scores within
    1e-5 (chip_smoke's `_decode_verdict`).  The input is tie-free: at
    every step each source's last chosen candidate is apart from its
    first rejected one by far more than the two devices' rounding
    (recorded on the CPU run, checked below)."""
    import numpy as np

    import chip_smoke
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.scope import Scope

    hidden = 16
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        context = fluid.layers.data(name="context", shape=[hidden],
                                    dtype="float32")
        ids, scores = chip_smoke._mt_decoder_decode(
            fluid, context, vocab=12, emb=hidden, hid=hidden, max_len=5,
            beam=2, topk=4)
    n = 3
    lod = [list(range(n + 1))] * 2
    feed = {"context": np.random.RandomState(8).randn(n, hidden)
            .astype(np.float32),
            "init_ids": LoDTensor(np.zeros((n, 1), np.int64), lod),
            "init_scores": LoDTensor(np.ones((n, 1), np.float32), lod)}
    persist = [v.name for v in main.list_vars() if v.persistable]
    out, params = {}, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        prev = executor_mod.switch_scope(Scope())
        try:
            exe = fluid.Executor(place, seed=0)
            if params is None:
                torch.manual_seed(0)
                exe.run(startup)
                params = {p: fluid.global_scope().find_var(p).clone()
                          for p in persist}
            for p, v in params.items():
                fluid.global_scope().set_var(p, v.to(exe.device))
            runs = []
            for _ in range(3):
                steps = []
                with chip_smoke._wrapped_lowering(
                        "beam_search", chip_smoke._beam_record(steps)):
                    runs.append((steps, exe.run(main, feed=feed,
                                                fetch_list=[ids, scores])))
            out[str(place)] = runs
            exe.close()
        finally:
            executor_mod.switch_scope(prev)
    c_steps, c_out = out["CPUPlace"][0]
    assert len(c_out[0].lod[0]) == n + 1 and c_out[0].lod[0][-1] >= n
    for k_steps, k_out in out["CUDAPlace(0)"]:
        ok, rec = chip_smoke._decode_verdict(k_steps, c_steps, k_out, c_out,
                                             1e-5)
        assert ok and rec["decode_equal"], rec
    gap = rec["min_chosen_vs_rejected_gap"]
    assert gap > 1e-3, f"a near tie in the input: smallest gap {gap}"


def _crf_runs(feeds, order, compiled):
    """A tagger step (embedding, fc, linear_chain_crf, SGD) with its
    crf_decoding on `feeds[i]` for i in `order` on the card from a
    seeded startup -> (losses, decoded paths, graph_stats())."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(input=words, size=[100, 16])
        feature = fluid.layers.fc(input=emb, size=7)
        loss = fluid.layers.mean(fluid.layers.linear_chain_crf(
            input=feature, label=label, param_attr={"name": "crfw"}))
        fluid.SGD(learning_rate=0.1).minimize(loss)
        path = fluid.layers.crf_decoding(input=feature,
                                         param_attr={"name": "crfw"})
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=0)
        torch.manual_seed(0)
        exe.run(startup)
        losses, paths = [], []
        for i in order:
            lo, pa = exe.run(main, feed=feeds[i], fetch_list=[loss, path],
                             compiled=compiled)
            losses.append(float(lo[0]))
            paths.append(np.asarray(pa.data).reshape(-1).tolist())
        stats = exe.graph_stats()
        exe.close()
        return losses, paths, stats
    finally:
        executor_mod.switch_scope(prev)


def test_crf_step_is_captured_and_replayed_under_two_lods(dev):
    """linear_chain_crf (forward, generic gradient) and crf_decoding are
    device ops: the step is one CUDA graph a LoD, two LoDs fed in turns,
    a miss and a capture each, replays after, every loss and decoded
    path the interpreter's bit for bit."""
    feeds = _lod_feeds(([3, 7, 2, 5], [6, 1, 4, 4]))
    for f in feeds:
        f["label"] = type(f["words"])(f["words"].data % 7, f["words"].lod)
    order = [0, 0, 1, 1, 0, 1, 0, 1]
    k_loss, k_path, stats = _crf_runs(feeds, order, None)
    i_loss, i_path, _ = _crf_runs(feeds, order, False)
    assert stats["captures"] == 2 and stats["replays"] == 4
    assert stats["eager_hits"] == 0 and stats["graphs"] == 2
    assert k_loss == i_loss and k_path == i_path


def test_sync_bn_form_under_one_nccl_rank_is_the_executor(dev):
    """A conv + batch-norm net through ParallelExecutor(mesh={"dp": 1})
    under a one-rank NCCL group: the sync-BN form, its statistics
    all-reduced through NCCL (two a layer forward, one backward, a
    step), 3 Momentum steps within 1e-5 of the Executor on the card
    (losses relative; parameters, velocities and running statistics
    absolute: a sum over the group then a division, where the Executor
    takes a mean)."""
    import socket

    import numpy as np
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    def build():
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                    dtype="float32")
            label = fluid.layers.data(name="label", shape=[1], dtype="int64")
            h = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                    padding=1)
            h = fluid.layers.batch_norm(input=h, act="relu")
            pred = fluid.layers.fc(input=h, size=4, act="softmax")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
            fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
        return main, startup, loss

    r = np.random.RandomState(0)
    feeds = [{"img": r.rand(16, 3, 8, 8).astype(np.float32),
              "label": r.randint(0, 4, (16, 1)).astype(np.int64)}
             for _ in range(3)]
    main, startup, loss = build()
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=0)
        exe.run(startup)
        init = {v.name: fluid.global_scope().find_var(v.name).clone()
                for v in main.list_vars() if v.persistable}
        want = [float(exe.run(main, feed=f, fetch_list=[loss],
                              compiled=False)[0][0]) for f in feeds]
        want_states = {n: fluid.global_scope().find_var(n).cpu()
                       for n in init}
    finally:
        executor_mod.switch_scope(prev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        pe = fluid.ParallelExecutor(main, ["img", "label"], [loss],
                                    mesh={"dp": 1}, startup_program=startup)
        assert pe.gspmd_form == "sync_bn"
        for n, v in init.items():
            if n in pe._states:
                pe.set_state(n, v)
        got = [float(pe.run(f)[0][0]) for f in feeds]
        assert pe.collective_calls["stat_all_reduce"] == 3 * 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
        for n, v in want_states.items():
            if n in pe._states:
                np.testing.assert_allclose(pe.state(n), v.numpy(), rtol=0,
                                           atol=1e-5, err_msg=n)
    finally:
        dist.destroy_process_group()


def test_sparse_gradient_across_a_host_op_is_captured(dev):
    """tools/torch_tree_probe.py's sparse-host program: an is_sparse
    embedding's SelectedRows gradient reaches its sgd across a host
    `print`, so the update segment's capture takes a SelectedRows input
    (rows and values as two buffers; it raised a TypeError before).
    Three steps in the default mode (a miss, a capture of both device
    segments, a replay of both) against the interpreter bit for bit."""
    import os
    import sys

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from torch_tree_probe import sparse_host_feeds, sparse_host_program

    main, startup, loss = sparse_host_program(fluid)
    params = [p.name for p in main.global_block().all_parameters()]
    res = {}
    for compiled in (None, False):
        prev = executor_mod.switch_scope(Scope())
        try:
            exe = fluid.Executor(fluid.CUDAPlace(0), seed=0)
            torch.manual_seed(0)
            exe.run(startup)
            losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                    compiled=compiled)[0][0])
                      for f in sparse_host_feeds()]
            res[compiled] = (losses, {
                n: fluid.global_scope().find_var(n).cpu() for n in params},
                exe.graph_stats())
            exe.close()
        finally:
            executor_mod.switch_scope(prev)
    (k_loss, k_params, stats), (i_loss, i_params, _) = res[None], res[False]
    assert stats["captures"] == 2 and stats["replays"] == 2
    assert k_loss == i_loss
    for n in params:
        assert torch.equal(k_params[n], i_params[n]), n
    assert np.all(np.isfinite(k_loss))


def test_ssd_step_default_mode_is_the_interpreter_on_the_card(dev):
    """A cut MobileNet-SSD (chip_smoke's `_ssd_program` at 64x64, width 0.25,
    batch 4, up to three boxes an image): three RMSProp steps in the
    default mode (three device segments between the host bipartite_match
    and mine_hard_examples, each captured and replayed) and three
    interpreted from the same state, the losses and every state bit for
    bit."""
    import numpy as np

    import chip_smoke
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss, *_ = chip_smoke._ssd_program(fluid, fw, img=64,
                                                      scale=0.25)
    feed, _ = chip_smoke._ssd_feed(np.random.RandomState(2), 4, img=64,
                                   boxes=(1, 3))
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    prev = executor_mod.switch_scope(Scope())
    try:
        exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
        exe.run(startup)
        init = {n: fluid.global_scope().find_var(n).clone() for n in names}
        runs = []
        for compiled in (None, False):
            executor_mod.switch_scope(Scope())
            for n in names:
                fluid.global_scope().set_var(n, init[n].clone())
            exe = fluid.Executor(fluid.CUDAPlace(0), seed=1)
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                    compiled=compiled)[0].reshape(-1)[0])
                      for _ in range(3)]
            if compiled is None:
                stats = exe.graph_stats()
                assert stats["captures"] == 3 and stats["replays"] == 3
            runs.append((losses, {n: fluid.global_scope().find_var(n)
                                  .clone() for n in names}))
            exe.close()
    finally:
        executor_mod.switch_scope(prev)
    assert runs[0][0] == runs[1][0]
    assert runs[0][0][-1] < runs[0][0][0]
    _same_bits(runs[0][1], runs[1][1])


def _a73_grad_cases():
    """(op, inputs, attrs) of the new ops with a gradient, at small
    working shapes with repeated rows (tree nodes, sampled classes,
    overlapping ROIs) so a scatter-add would collide."""
    import numpy as np

    from paddle_tpu_torch.core.lod import LoDTensor

    r = np.random.RandomState(0)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        r.standard_normal(s).astype(np.float32))
    lod = [[0, 9, 20, 32]]
    t_lens = [9, 11, 12]
    logits = LoDTensor(f32(sum(t_lens), 12), lod)
    labels = LoDTensor(torch.from_numpy(
        r.randint(1, 12, (9, 1)).astype(np.int64)), [[0, 3, 5, 9]])
    rois = torch.from_numpy(np.concatenate([
        r.uniform(0, 300, (64, 2)), r.uniform(320, 600, (64, 2))],
        1).astype(np.float32))
    return [
        ("warpctc", {"Logits": logits, "Label": labels},
         {"blank": 0, "norm_by_times": True}),
        ("hsigmoid", {"X": f32(256, 32), "W": f32(999, 32),
                      "Bias": f32(999),
                      "Label": torch.from_numpy(r.randint(
                          0, 1000, (256, 1)).astype(np.int64))},
         {"num_classes": 1000}),
        ("nce", {"Input": f32(256, 32), "Weight": f32(50, 32),
                 "Bias": f32(50), "Label": torch.from_numpy(r.randint(
                     0, 50, (256, 1)).astype(np.int64))},
         {"num_total_classes": 50, "num_neg_samples": 10}),
        ("roi_pool", {"X": f32(2, 16, 38, 50),
                      "ROIs": LoDTensor(rois, [[0, 30, 64]])},
         {"pooled_height": 7, "pooled_width": 7,
          "spatial_scale": 1.0 / 16}),
    ]


@pytest.mark.parametrize("case", _a73_grad_cases(), ids=lambda c: c[0])
def test_new_gradients_are_repeatable_on_the_card(dev, case):
    """warpctc, hsigmoid, nce and roi_pool: the generic gradient twice on
    the card gives the same bits (fixed-order sums, no atomics), and the
    CPU's within 1e-5 of its largest."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.registry import get_op_info

    op, ins, attrs = case
    info = get_op_info(op)
    attrs = {**info.attrs, **attrs}

    def run(device):
        vals = {k: [v.map(lambda t: t.to(device)) if isinstance(v, LoDTensor)
                    else v.to(device)] for k, v in ins.items()}
        ctx = ExecContext(device, seed=5)
        outs = info.lower(ctx, vals, attrs)
        out_slot = info.diff_outputs[0]
        o = outs[out_slot]
        o = o.data if isinstance(o, LoDTensor) else o
        g = dict(vals, **{s: [v] for s, v in outs.items()})
        g[out_slot + GRAD] = [torch.ones_like(o)]
        res = generic_grad_lower(ctx, g, attrs, info)
        return {k: (v[0].data if isinstance(v[0], LoDTensor) else v[0])
                .cpu() for k, v in res.items()}

    a, b, cpu = run(dev), run(dev), run("cpu")
    _same_bits(a, b)
    for k in a:
        tol = 1e-5 * max(1.0, float(cpu[k].abs().max()))
        assert float((a[k] - cpu[k]).abs().max()) <= tol, k


def test_reader_outputs_land_on_the_card(dev):
    """The random -> shuffle -> batch reader chain made by a startup
    program and read by main on a CUDAPlace: each batch on cuda:0, equal
    to the CPU chain's bit for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    def chain(place):
        main, startup = fluid.Program(), fluid.Program()
        sb, mb = startup.global_block(), main.global_block()
        for n in ("raw", "shuf", "batch"):
            sb.create_var(name=n, persistable=True)
            mb.create_var(name=n, persistable=True)
        out = mb.create_var(name="x", dtype="float32")
        sb.append_op("create_random_data_generator", {}, {"Out": ["raw"]},
                     {"shape_concat": [3, 8, 8], "ranks": [3],
                      "lod_levels": [0], "min": 0.0, "max": 1.0, "seed": 3})
        sb.append_op("create_shuffle_reader", {"UnderlyingReader": ["raw"]},
                     {"Out": ["shuf"]}, {"buffer_size": 16})
        sb.append_op("create_batch_reader", {"UnderlyingReader": ["shuf"]},
                     {"Out": ["batch"]}, {"batch_size": 8})
        mb.append_op("read", {"Reader": ["batch"]}, {"Out": [out.name]}, {})
        prev = executor_mod.switch_scope(Scope())
        try:
            exe = fluid.Executor(place)
            exe.run(startup)
            return [exe.run(main, fetch_list=[out], return_numpy=False)[0]
                    for _ in range(3)]
        finally:
            executor_mod.switch_scope(prev)

    card, cpu = chain(fluid.CUDAPlace(0)), chain(fluid.CPUPlace())
    for a, b in zip(card, cpu):
        assert a.device == torch.device("cuda", 0)
        assert torch.equal(a.cpu(), b)


# -- recompute, program_to_fn and InferenceServer (A4b, A6) -------------------

def _remat_lm(amp):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import flags

    flags.set_flags({"remat": True})
    try:
        return _graph_lm(amp)
    finally:
        flags.set_flags({"remat": False})


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_remat_step_captured_equals_its_interpreter(dev, amp):
    """A transformer LM with every block a recompute segment: the
    default mode's captured and replayed step equals the interpreter bit
    for bit, and its eager run and capture each launch the flash forward
    twice a layer (forward and the gradient's re-run) and dQ, dK/dV once
    (the wrapper's autograd inside the segment)."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    main, startup, loss = _remat_lm(amp)
    assert [op.type for op in main.global_block().ops].count(
        "recompute") == 2
    _, init, _ = _graph_run(main, startup, loss, None, 0, None, amp)
    for k in flash_attention.launches:
        flash_attention.launches[k] = 0
    g_loss, g_final, exe = _graph_run(main, startup, loss, init, 5, None,
                                      amp)
    assert dict(flash_attention.launches) == {"fwd": 8, "dq": 4, "dkv": 4}
    i_loss, i_final, _ = _graph_run(main, startup, loss, init, 5, False,
                                    amp)
    assert exe.graph_stats()["captures"] == 1
    assert exe.graph_stats()["replays"] == 3
    assert g_loss == i_loss
    _same_bits(g_final, i_final)
    exe.close()


def test_inference_server_replays_only_graphs_captured_at_construction(dev):
    """Every bucket is captured while the server is built; dispatches
    only replay, and their outputs equal the Executor's run of the same
    images."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.io import prune
    from paddle_tpu_torch.serving import InferenceServer

    tfw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 16, 16])
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   act="relu")
        bn = fluid.layers.batch_norm(input=conv)
        pred = fluid.layers.fc(input=bn, size=10, act="softmax")
    scope = Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    infer = prune(main, [pred], for_test=True)
    imgs = np.random.RandomState(0).rand(11, 3, 16, 16).astype(np.float32)
    srv = InferenceServer(infer, "img", pred, scope, buckets=(1, 2, 4, 8),
                          window_ms=5.0)
    try:
        built = srv.graph_stats()
        assert built == {"eager_runs": 4, "captures": 4, "replays": 0}
        futs = [srv.submit(imgs[i]) for i in range(11)]
        outs = np.concatenate([f.result(timeout=60) for f in futs])
        after = srv.graph_stats()
        assert after["captures"] == 4 and after["eager_runs"] == 4
        assert after["replays"] == srv.stats()["dispatches"] > 0
    finally:
        srv.close()
    direct = np.concatenate([exe.run(infer, feed={"img": imgs[i:i + 1]},
                                     fetch_list=[pred], scope=scope)[0]
                             for i in range(11)])
    np.testing.assert_allclose(outs, direct, rtol=1e-5, atol=1e-6)


def test_generators_read_nothing_back_per_token(dev):
    """Greedy decoding with the full-forward generator, the kv decoder
    and beam search raises no synchronising call under the sync debug
    mode once warm, and the kv decoder's ids equal the full forward's."""
    import numpy as np

    from paddle_tpu_torch.core import framework as tfw
    from paddle_tpu_torch.models import transformer as tr

    V, L = 64, 32
    built = {}
    for name in ("build_lm_generator", "build_lm_kv_decoder"):
        tfw.reset_unique_names()
        built[name] = getattr(tr, name)(V, L, d_model=64, n_heads=2,
                                        n_layers=2)[1]
    tfw.reset_unique_names()
    beam = tr.build_lm_beam_search(V, L, beam_size=4, d_model=64,
                                   n_heads=2, n_layers=2)[1]
    rng = np.random.RandomState(0)
    states = {n: torch.as_tensor(rng.normal(0, 0.5, s).astype(np.float32),
                                 device=dev)
              for n, s in built["build_lm_kv_decoder"].state_shapes.items()}
    prompt = torch.as_tensor(rng.randint(0, V, (4, 4)), device=dev)
    full = built["build_lm_generator"](states, prompt, 20)   # warm-up
    kv = built["build_lm_kv_decoder"](states, prompt, 20)
    beam(states, prompt, 20)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        full2 = built["build_lm_generator"](states, prompt, 20)
        kv2 = built["build_lm_kv_decoder"](states, prompt, 20)
        beam(states, prompt, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(full, full2) and torch.equal(kv, kv2)
    assert torch.equal(kv, full)


def _momentum_program():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework as tfw

    tfw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        test = main.clone(for_test=True)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss, test, pred


def test_program_to_fn_states_advance_through_replays(dev):
    """`states = fn(feed, states)[1]` on the card: from the third call
    the function replays its graph, whose new states are its own output
    tensors, rewritten by every replay without a version bump.  Each
    call's loss and states follow the interpreted Executor step for
    step, and every state written moves at every call."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss, _, _ = _momentum_program()
    scope = Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    fn = texecutor.program_to_fn(main, ["x", "y"], [loss])
    states = {n: scope.find_var(n).clone() for n in fn.state_in_names}
    rng = np.random.RandomState(0)
    for call in range(6):
        feed = {"x": rng.rand(4, 6).astype(np.float32),
                "y": rng.rand(4, 1).astype(np.float32)}
        want, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                        compiled=False, return_numpy=False)
        before = {n: v.clone() for n, v in states.items()}
        fetches, states = fn(feed, states)
        torch.testing.assert_close(fetches[loss.name], want, rtol=1e-6,
                                   atol=1e-7)
        for n in fn.state_in_names:
            torch.testing.assert_close(states[n], scope.find_var(n),
                                       rtol=1e-6, atol=1e-7, msg=n)
        for n in fn.state_out_names:
            assert not torch.equal(states[n], before[n]), (call, n)
    assert fn.stats == {"eager_runs": 1, "captures": 1, "replays": 4}
    fn.close()


def test_program_to_fn_reads_states_an_executor_graph_rewrote(dev):
    """A forward function reading the scope's states between default-mode
    training steps: the Executor's replays write the new states into the
    same tensors without a version bump, and each call of the function
    sees the states of that moment."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    main, startup, loss, test, pred = _momentum_program()
    scope = Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    fn = texecutor.program_to_fn(test, ["x"], [pred])
    rng = np.random.RandomState(1)
    probe = rng.rand(4, 6).astype(np.float32)
    seen = []
    for step in range(6):
        feed = {"x": rng.rand(4, 6).astype(np.float32),
                "y": rng.rand(4, 1).astype(np.float32)}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        states = {n: scope.find_var(n) for n in fn.state_in_names}
        got = fn({"x": probe}, states)[0][pred.name].clone()
        want, = exe.run(test, feed={"x": probe}, fetch_list=[pred],
                        scope=scope, compiled=False, return_numpy=False)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        assert not any(torch.equal(got, s) for s in seen), step
        seen.append(got)
    assert exe.graph_stats()["replays"] >= 4
    assert fn.stats["replays"] >= 3
    fn.close()
    exe.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_conv_autograd_grad_is_the_explicit_grad_on_the_card(dev, dtype):
    """Under PyTorch's default global cuDNN flags (TF32 allowed,
    non-deterministic algorithms allowed), autograd through the conv2d
    lowering, as a recompute segment's gradient takes it, gives the
    explicit gradient's bits: its backward runs on the same pinned
    backend."""
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.execution import generic_grad_lower

    c = torch.backends.cudnn
    old = (c.allow_tf32, c.deterministic, c.benchmark)
    c.allow_tf32, c.deterministic, c.benchmark = True, False, False
    try:
        gen = torch.Generator().manual_seed(0)
        info = treg.get_op_info("conv2d")
        attrs = {**info.attrs, "strides": [1, 1], "paddings": [1, 1]}
        ins = {"Input": [torch.randn((8, 64, 56, 56), generator=gen)
                         .to(dev, dtype)],
               "Filter": [torch.randn((64, 64, 3, 3), generator=gen)
                          .mul(0.05).to(dev, dtype)]}
        ctx = ExecContext(dev)
        out = info.lower(ctx, ins, attrs)["Output"]
        out = out[0] if isinstance(out, (list, tuple)) else out
        ins["Output"] = [out]
        ins["Output@GRAD"] = [torch.randn(tuple(out.shape), generator=gen)
                              .to(dev, dtype)]
        explicit = info.grad_lower(ctx, ins, attrs)
        generic = generic_grad_lower(ctx, ins, attrs, info)
    finally:
        c.allow_tf32, c.deterministic, c.benchmark = old
    for slot in ("Input@GRAD", "Filter@GRAD"):
        assert torch.equal(generic[slot][0], explicit[slot][0]), slot


def _conv_rest_cases():
    gen = torch.Generator().manual_seed(3)

    def f32(*shape):
        return torch.randn(shape, generator=gen)

    pool = {"ksize": [3, 3, 3], "strides": [2, 2, 2], "paddings": [1, 1, 1]}
    return [
        ("conv3d", {"Input": f32(2, 8, 8, 16, 16),
                    "Filter": f32(16, 8, 3, 3, 3) * 0.1},
         {"paddings": [1, 1, 1]}),
        ("conv2d_transpose", {"Input": f32(8, 64, 8, 8),
                              "Filter": f32(64, 32, 4, 4) * 0.05},
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv3d_transpose", {"Input": f32(2, 32, 4, 8, 8),
                              "Filter": f32(32, 16, 2, 2, 2) * 0.1},
         {"strides": [2, 2, 2]}),
        ("pool3d", {"X": f32(2, 8, 8, 16, 16)}, pool),
        ("max_pool3d_with_index", {"X": f32(2, 8, 8, 16, 16)}, pool),
        ("max_pool2d_with_index", {"X": f32(2, 8, 33, 47)},
         {"ksize": [3, 3], "strides": [2, 2]}),
        ("unpool", {"X": f32(2, 8, 16, 23),
                    "Indices": torch.randint(0, 33 * 47, (2, 8, 16, 23),
                                             generator=gen)},
         {"ksize": [3, 3], "strides": [2, 2]}),
    ]


@pytest.mark.parametrize("case", _conv_rest_cases(), ids=lambda c: c[0])
def test_conv_rest_routes_are_repeatable_on_the_card(dev, case):
    """The float32 conv routes (cuDNN off: ATen's own convolutions, TF32
    off) and the windowed pools' and unpool's gradient-by-gather routes:
    the forward and the gradient twice on the card give the same bits
    (no atomics), and the CPU's within 1e-5 of its largest."""
    from paddle_tpu_torch.core.execution import (GRAD, ExecContext,
                                                 generic_grad_lower)
    from paddle_tpu_torch.core.registry import get_op_info

    op, ins, attrs = case
    info = get_op_info(op)
    attrs = {**info.attrs, **attrs}

    def run(device):
        vals = {k: [v.to(device)] for k, v in ins.items()}
        ctx = ExecContext(device)
        outs = info.lower(ctx, vals, attrs)
        slot = (info.diff_outputs or info.outputs)[0]
        g = dict(vals, **{s: [v] for s, v in outs.items()})
        g[slot + GRAD] = [torch.cos(outs[slot])]
        grad = info.grad_lower or (lambda c, i, a: generic_grad_lower(
            c, i, a, info))
        res = {k: v[0].cpu() for k, v in grad(ctx, g, attrs).items()}
        res.update({k: v.cpu() for k, v in outs.items()})
        return res

    a, b, cpu = run(dev), run(dev), run("cpu")
    _same_bits(a, b)
    for k in a:
        if not a[k].is_floating_point():
            assert torch.equal(a[k], cpu[k]), k
            continue
        tol = 1e-5 * max(1.0, float(cpu[k].abs().max()))
        assert float((a[k] - cpu[k]).abs().max()) <= tol, k


def test_a_snapshot_loaded_into_a_captured_graph_replays_like_a_fresh_run(
        dev, tmp_path):
    """An Adam MLP trained 4 steps in the default mode (captured at step
    2), step 2's snapshot loaded into the same scope and Executor: steps
    3-4 replayed again give the first time's losses and states, and a
    fresh process's resume (a new scope and Executor) gives the same."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core import executor as executor_mod
    from paddle_tpu_torch.core.scope import Scope

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="relu")
        p = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(p, y))
        fluid.Adam(1e-3).minimize(loss)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    gen = torch.Generator().manual_seed(0)
    feeds = [{"x": torch.randn((8, 16), generator=gen).numpy(),
              "y": torch.randint(0, 4, (8, 1), generator=gen).numpy()}
             for _ in range(4)]
    prev = executor_mod.switch_scope(Scope())
    try:
        scope = fluid.global_scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        losses, states = [], []
        for i, f in enumerate(feeds):
            losses.append(float(exe.run(main, feed=f,
                                        fetch_list=[loss])[0][0]))
            states.append({n: scope.find_var(n).clone() for n in names})
            if i == 1:
                io.save_persistables(exe, str(tmp_path), main)
        assert exe.graph_stats()["captures"] == 1
        io.load_persistables(exe, str(tmp_path), main)
        again = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
                 for f in feeds[2:]]
        assert again == losses[2:]
        for n in names:
            assert torch.equal(scope.find_var(n), states[3][n]), n
        executor_mod.switch_scope(Scope())
        fresh = fluid.Executor(fluid.CUDAPlace(0))
        io.load_persistables(fresh, str(tmp_path), main)
        resumed = [float(fresh.run(main, feed=f, fetch_list=[loss])[0][0])
                   for f in feeds[2:]]
        assert resumed == losses[2:]
        for n in names:
            assert torch.equal(fluid.global_scope().find_var(n),
                               states[3][n]), n
        exe.close()
        fresh.close()
    finally:
        executor_mod.switch_scope(prev)


def test_prefetched_feeds_are_complete_when_the_consumer_reads_them(dev):
    """prefetch_feeder copies each batch from pinned memory on its
    worker's own stream; the consumer's stream waits on the copy's
    event, so a kernel it launches at once reads the whole batch: every
    batch's sum on the card equals the host's, and each batch is a CUDA
    tensor."""
    import numpy as np

    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.reader import prefetch_feeder

    batches = [np.full((4096, 4096), i + 1, np.float32) for i in range(6)]

    def reader():
        for b in batches:
            yield {"x": b}

    sums = []
    for feed in prefetch_feeder(reader, None, CUDAPlace(0), depth=2)():
        assert feed["x"].is_cuda
        sums.append(feed["x"].sum(dtype=torch.float64))
    assert [float(t) for t in sums] == [float(b.sum(dtype=np.float64))
                                        for b in batches]


# -- A10b: the kernels as ops, the AOT artifact, the C ABI on the card -------

def test_kernel_ops_launch_the_kernels_like_the_direct_calls(dev):
    """The ops paddle_tpu_torch::flash_attention_fwd and
    paddle_tpu_torch::moe_gate_route launch the same kernels as the
    direct calls (bit-equal results, one count a call)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import moe_dispatch as md

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 64, 4, 64), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = fa.flash_attention.launches["fwd"]
    o1, l1 = fa.flash_attention_fwd(q, k, v, True, 0.125)
    o2, l2 = fa.flash_attention_fwd_op(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert fa.flash_attention.launches["fwd"] == before + 2
    x = torch.randn((96, 32), generator=g, device=dev)
    gw = torch.randn((32, 8), generator=g, device=dev) * 0.5
    before = md.moe_gate_dispatch.launches
    got = md.moe_gate_route_op(x, gw, 8, 24, 2)
    want = md.moe_gate_route_launch(x, gw, 8, 24, 2)[:5]
    torch.cuda.synchronize()
    assert md.moe_gate_dispatch.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _small_lm(fluid, amp):
    from paddle_tpu_torch.core import framework as fw
    from paddle_tpu_torch.models.transformer import transformer_lm

    fw.reset_unique_names()
    if amp:
        fluid.amp.enable_bf16()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[64], dtype="int64")
            logits = transformer_lm(ids, 100, d_model=128, n_heads=2,
                                    n_layers=3, max_len=64,
                                    return_logits=True)
    finally:
        if amp:
            fluid.amp.disable_bf16()
    return main, startup, logits


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_exported_lm_launches_the_flash_kernel_after_a_reload(dev, amp,
                                                             tmp_path):
    """A 3-layer LM exported on the card and reloaded: 3 flash op nodes,
    3 forward launches a call, logits bit-equal to the Executor's
    eager forward (the same kernels and ops)."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    main, startup, logits = _small_lm(fluid, amp)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), Scope()
    exe.run(startup, scope=scope)
    ids = np.random.RandomState(0).randint(0, 100, (2, 64)).astype(np.int64)
    if amp:
        fluid.amp.enable_bf16()
    try:
        io.export_aot_model(str(tmp_path), {"ids": ([2, 64], "int64")},
                            [logits], exe, main_program=main, scope=scope)
        want = exe.run(io.get_inference_program([logits], main),
                       feed={"ids": ids}, fetch_list=[logits], scope=scope,
                       return_numpy=False)[0]
    finally:
        if amp:
            fluid.amp.disable_bf16()
    call, _, _ = io.load_aot_model(str(tmp_path))
    nodes = [str(n.target) for n in call.exported_program.graph.nodes]
    assert nodes.count("paddle_tpu_torch.flash_attention_fwd.default") == 3
    before = fa.flash_attention.launches["fwd"]
    got = call({"ids": ids})[0]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches["fwd"] == before + 3
    assert got.is_cuda and torch.equal(got, want)
    exe.close()


def test_artifacts_move_between_the_cpu_and_the_card(dev, tmp_path):
    """An artifact exported on the CPU runs on the card (its flash op then
    launches the kernel) and one exported on the card runs on the CPU
    (the plain version), both within 1e-4 of the other device's."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.kernels import flash_attention as fa

    main, startup, logits = _small_lm(fluid, False)
    ids = np.random.RandomState(1).randint(0, 100, (2, 64)).astype(np.int64)
    cpu_exe, scope = fluid.Executor(fluid.CPUPlace()), Scope()
    cpu_exe.run(startup, scope=scope)
    io.export_aot_model(str(tmp_path / "cpu"), {"ids": ([2, 64], "int64")},
                        [logits], cpu_exe, main_program=main, scope=scope)
    card_exe = fluid.Executor(fluid.CUDAPlace(0))
    card_scope = Scope()
    for n in scope.local_names():
        card_scope.set_var(n, scope.find_var(n).to(dev))
    io.export_aot_model(str(tmp_path / "card"), {"ids": ([2, 64], "int64")},
                        [logits], card_exe, main_program=main,
                        scope=card_scope)
    before = fa.flash_attention.launches["fwd"]
    on_card = io.load_aot_model(str(tmp_path / "cpu"))[0]({"ids": ids})[0]
    torch.cuda.synchronize()
    assert on_card.is_cuda and fa.flash_attention.launches["fwd"] == \
        before + 3
    on_cpu = io.load_aot_model(str(tmp_path / "card"),
                               fluid.CPUPlace())[0]({"ids": ids})[0]
    assert on_cpu.device.type == "cpu"
    tol = 1e-4 * max(1.0, float(on_cpu.abs().max()))
    assert float((on_card.cpu() - on_cpu).abs().max()) <= tol
    card_exe.close()


def test_capi_session_runs_on_the_card_by_default(dev, tmp_path,
                                                  monkeypatch):
    """The port's C ABI, driven through ctypes in this process: the
    session's Executor is on cuda:0 and its output equals the
    Executor's run of the same model."""
    import ctypes

    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import capi_runtime, io, native
    from paddle_tpu_torch.core.scope import Scope

    monkeypatch.delenv("PADDLE_TPU_CAPI_PLACE", raising=False)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.fc(input=fluid.layers.fc(x, 8, act="relu"),
                              size=3, act="softmax")
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), Scope()
    exe.run(startup, scope=scope)
    io.save_inference_model(str(tmp_path), ["x"], [out], exe,
                            main_program=main, scope=scope)
    xv = np.random.RandomState(2).rand(2, 4).astype(np.float32)
    want = exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)[0]
    lib = ctypes.CDLL(native.capi_library())
    i64 = ctypes.c_int64
    lib.paddle_tpu_inference_create.restype = i64
    lib.paddle_tpu_inference_create.argtypes = [ctypes.c_char_p]
    lib.paddle_tpu_inference_feed.argtypes = [
        i64, ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(i64),
        ctypes.c_int, ctypes.c_int]
    lib.paddle_tpu_inference_run.argtypes = [i64]
    lib.paddle_tpu_inference_fetch.restype = i64
    lib.paddle_tpu_inference_fetch.argtypes = [
        i64, ctypes.c_int, ctypes.POINTER(ctypes.c_float), i64,
        ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int)]
    lib.paddle_tpu_inference_destroy.argtypes = [i64]
    lib.paddle_tpu_last_error.restype = ctypes.c_char_p
    sid = lib.paddle_tpu_inference_create(str(tmp_path).encode())
    assert sid > 0, lib.paddle_tpu_last_error()
    assert capi_runtime._sessions[sid].exe.device == dev
    dims = (i64 * 2)(2, 4)
    assert lib.paddle_tpu_inference_feed(
        sid, b"x", xv.ctypes.data_as(ctypes.c_void_p), dims, 2, 0) == 0
    assert lib.paddle_tpu_inference_run(sid) == 1
    buf, odims, ondim = (ctypes.c_float * 6)(), (i64 * 8)(), ctypes.c_int()
    assert lib.paddle_tpu_inference_fetch(sid, 0, buf, 6, odims,
                                          ctypes.byref(ondim)) == 6
    np.testing.assert_array_equal(np.ctypeslib.as_array(buf).reshape(2, 3),
                                  want)
    assert lib.paddle_tpu_inference_destroy(sid) == 0
    exe.close()


# -- the user-facing tools (A10c): checkgrad and the device profiler ---------

_CHECKGRAD_CONFIG = """
import numpy as np
import paddle_tpu_torch as fluid

def build():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        r = np.random.RandomState(0)
        w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
        for _ in range(8):
            xb = r.rand(16, 4).astype(np.float32)
            yield {"x": xb, "y": xb @ w}

    return {"loss": loss, "reader": reader,
            "optimizer": fluid.SGD(learning_rate=0.1),
            "infer_targets": [pred], "feed_order": ["x", "y"]}
"""


def test_checkgrad_default_mode_equals_the_interpreter_on_the_card(
        dev, tmp_path):
    """`--job=checkgrad` on the card: the default mode (each perturbed
    loss a replay of one captured graph, the parameter set anew in the
    scope between replays) gives the interpreter's numeric gradients
    bit for bit, and both pass; a replay reading a stale parameter would
    give numeric gradients of 0."""
    import numpy as np

    from paddle_tpu_torch import cli
    from paddle_tpu_torch.core import flags

    cfg = tmp_path / "config.py"
    cfg.write_text(_CHECKGRAD_CONFIG)
    argv = ["--config", str(cfg), "--job", "checkgrad"]
    default = cli.main(argv)
    assert default["exe"].graph_stats()["replays"] > 0
    flags.set_flags({"jit_granularity": "op"})
    try:
        interp = cli.main(argv)
    finally:
        flags.set_flags({"jit_granularity": "block"})
    assert interp["exe"].graph_stats()["captures"] == 0
    for name, d in default["params"].items():
        i = interp["params"][name]
        assert np.array_equal(d["indices"], i["indices"])
        assert np.array_equal(d["numeric"], i["numeric"]), name
        assert np.all(d["numeric"] != 0), name
    assert default["worst"] < 1e-2 and interp["worst"] < 1e-2


def test_profile_compiled_ops_scopes_a_replayed_flash_step(dev):
    """profile_compiled_ops over replayed steps of a 2-layer LM: each
    flash kernel (forward, dQ, dK/dV) shows once a layer a step under
    its op's scope (flash_attention:… for the forward,
    flash_attention_grad:… for the backward), and the table's scoped
    device time is nearly all of it."""
    from paddle_tpu_torch import profiler

    main, startup, loss = _graph_lm(False)
    _, init, _ = _graph_run(main, startup, loss, None, 0, None, False)
    _, _, exe = _graph_run(main, startup, loss, init, 3, None, False)
    assert exe.graph_stats()["replays"] == 1
    from paddle_tpu_torch.core import executor as texecutor
    from paddle_tpu_torch.core.scope import Scope

    scope = Scope()
    for n, v in init.items():
        scope.set_var(n, v.clone())
    prev = texecutor.switch_scope(scope)
    try:
        for step in range(2):
            exe.run(main, feed=_graph_feed(step), fetch_list=[loss])
        rows = profiler.profile_compiled_ops(
            lambda: exe.run(main, feed=_graph_feed(0), fetch_list=[loss],
                            return_numpy=False), steps=3,
            print_table=False)
    finally:
        texecutor.switch_scope(prev)
    assert rows == sorted(rows, key=lambda r: -r["total"])
    for kind, op in (("fwd_kernel", "flash_attention:"),
                     ("dq_kernel", "flash_attention_grad:"),
                     ("dkv_kernel", "flash_attention_grad:")):
        mine = [r for r in rows if kind in r["name"]]
        assert sum(r["calls"] for r in mine) == 3 * 2, (kind, mine)
        assert all(r["scope"].startswith(op) for r in mine), mine
    total = sum(r["total"] for r in rows)
    scoped = sum(r["total"] for r in rows if r["scope"])
    assert scoped >= 0.95 * total
    exe.close()


def test_verify_error_stops_a_bad_program_before_any_launch(dev):
    """Under PADDLE_TPU_VERIFY=error the Executor's pre-flight rejects a
    use-before-def program placed on CUDAPlace(0) before any op runs:
    no flash kernel launches and nothing is allocated on the card; off,
    the same program reaches the card and fails at the missing var."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.analysis import ProgramVerificationError
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    p = fluid.Program()
    b = p.global_block()
    for n in ("q", "k"):
        b.create_var(name=n, shape=[2, 128, 4, 64], dtype="bfloat16")
    b.append_op("flash_attention",
                {"Q": ["q"], "K": ["k"], "V": ["v_never_made"]},
                {"Out": ["o"]}, {"causal": True})
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = {n: torch.randn(2, 128, 4, 64, device=dev,
                           dtype=torch.bfloat16) for n in ("q", "k")}
    torch.cuda.synchronize()
    before = dict(flash_attention.launches)
    allocated = torch.cuda.memory_allocated()
    flags.set_flags({"verify": "error"})
    try:
        with pytest.raises(ProgramVerificationError,
                           match="def-before-use"):
            exe.run(p, feed=feed, fetch_list=["o"])
    finally:
        flags.set_flags({"verify": "off"})
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    assert torch.cuda.memory_allocated() == allocated
    with pytest.raises(Exception) as ei:
        exe.run(p, feed=feed, fetch_list=["o"])
    assert not isinstance(ei.value, ProgramVerificationError)


_TP_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from paddle_tpu_torch.parallel import collective as coll
from paddle_tpu_torch.parallel.mesh import Mesh

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank)
mesh = Mesh({"dp": 2, "tp": 2}, dist.group.WORLD)
tp = mesh.axis_group("tp")
res = {}
v = torch.arange(4.0, device="cuda") + 10 * rank
c = float(rank + 1)
for kind in ("copy_to", "reduce_from", "gather_from", "scatter_to"):
    leaf = v.clone().requires_grad_(True)
    fn = getattr(coll, kind)
    y = fn(leaf, tp, 0) if kind in ("gather_from", "scatter_to") \
        else fn(leaf, tp)
    y = y * (torch.arange(8.0, device="cuda") if kind == "gather_from"
             else c)
    y.sum().backward()
    res[kind] = {"fwd": y.detach().cpu().tolist(),
                 "grad": leaf.grad.cpu().tolist(),
                 "device": str(leaf.grad.device)}
res["permute"] = tp.permute(v, 1).cpu().tolist()
dist.destroy_process_group()
if rank in (0, 3):
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
"""


def test_tp_autograd_collectives_on_cuda_tensors(dev, tmp_path):
    """Megatron's regions as autograd Functions, four gloo ranks on the
    one card (a dp2 x tp2 mesh, its tp groups {0, 1} and {2, 3}): the
    forward and the conjugate backward on CUDA tensors, the gradients
    left on the card; a permute over tp (send/recv through host copies
    on gloo)."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = str(tmp_path / "tp")
    procs = [subprocess.Popen([sys.executable, "-c", _TP_WORKER, str(r),
                               str(port), out], env=env, cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log[-3000:]
    for rank in (0, 3):
        with open(f"{out}.{rank}") as f:
            res = json.load(f)
        mates = [rank - rank % 2, rank - rank % 2 + 1]
        i, c = rank % 2, rank + 1.0
        v = {m: [float(j + 10 * m) for j in range(4)] for m in mates}
        assert res["copy_to"]["fwd"] == [x * c for x in v[rank]]
        assert res["copy_to"]["grad"] == [sum(m + 1.0 for m in mates)] * 4
        assert res["reduce_from"]["fwd"] == [
            (a + b) * c for a, b in zip(v[mates[0]], v[mates[1]])]
        assert res["reduce_from"]["grad"] == [c] * 4
        assert res["gather_from"]["fwd"] == [
            x * j for j, x in enumerate(v[mates[0]] + v[mates[1]])]
        assert res["gather_from"]["grad"] == [float(j) for j in
                                              range(4 * i, 4 * i + 4)]
        assert res["scatter_to"]["fwd"] == [x * c for x in
                                            v[rank][2 * i:2 * i + 2]]
        assert res["scatter_to"]["grad"] == [mates[0] + 1.0] * 2 + [
            mates[1] + 1.0] * 2
        assert all(res[k]["device"].startswith("cuda") for k in
                   ("copy_to", "reduce_from", "gather_from", "scatter_to"))
        assert res["permute"] == v[mates[1 - i]]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_on_local_heads_is_the_full_heads_result(dev, dtype):
    """A tensor-parallel rank's attention: the kernels on each half of
    the heads (the LM's local [4, 512, 8, 128] at tp 2) give the full
    [4, 512, 16, 128] call's output and gradients, bit for bit (a head
    is a grid slice of its own)."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn((4, 512, 16, 128), generator=gen)
                  .to(dev, dtype) for _ in range(4))

    def run(q, k, v, g):
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = flash_attention(q, k, v, causal=True)
        out.backward(g)
        return [out.detach(), q.grad, k.grad, v.grad]

    full = run(q, k, v, g)
    halves = [run(*(t[:, :, h:h + 8].contiguous() for t in (q, k, v, g)))
              for h in (0, 8)]
    for a, b, want in zip(*halves, full):
        assert torch.equal(torch.cat([a, b], dim=2), want)


# -- A9: pipeline, sequence and expert parallelism on the card ----------------

_A9_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import paddle_tpu_torch as fluid
import paddle_tpu_torch.core.framework as fw
from paddle_tpu_torch.models.transformer import transformer_lm
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.parallel.ring_attention import ring_attention_local

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
res = {}
try:
    # ring attention on CUDA tensors against the same ring on the CPU
    gen = torch.Generator().manual_seed(11)
    q, k, v, g = (torch.randn((2, 128, 4, 64), generator=gen)
                  for _ in range(4))
    grp = make_mesh({"sp": 2}).axis_group("sp")
    ring = {}
    for where in ("cpu", "cuda"):
        ts = [t.narrow(1, rank * 64, 64).to(where).requires_grad_(True)
              for t in (q, k, v)]
        o = ring_attention_local(*ts, grp, causal=True)
        (o * g.narrow(1, rank * 64, 64).to(where)).sum().backward()
        ring[where] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    res["ring_device"] = str(o.device)
    res["ring_err"] = max(float((a - b).abs().max())
                          for a, b in zip(ring["cpu"], ring["cuda"]))

    # a GPipe step of a small LM at pp 2 on the card against the CPU
    def build():
        fw.reset_unique_names()
        pm, ps = fluid.Program(), fluid.Program()
        with fluid.program_guard(pm, ps):
            ids = fluid.layers.data(name="ids", shape=[64], dtype="int64")
            lab = fluid.layers.data(name="lab", shape=[64, 1], dtype="int64")
            lg = transformer_lm(ids, 50, d_model=64, n_heads=2, n_layers=2,
                                max_len=64, return_logits=True,
                                pipeline_stages=2)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(
                    fluid.layers.reshape(lg, shape=[-1, 50]),
                    fluid.layers.reshape(lab, shape=[-1, 1])))
            fluid.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
        return pm, ps, loss

    r = np.random.RandomState(0)
    feed = {"ids": r.randint(0, 50, (4, 64)).astype(np.int64),
            "lab": r.randint(0, 50, (4, 64, 1)).astype(np.int64)}
    runs = {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        pm, ps, loss = build()
        pe = fluid.PipelineExecutor(pm, ["ids", "lab"], [loss],
                                    mesh={"dp": 1, "pp": 2},
                                    startup_program=ps, n_micro=2,
                                    place=place)
        if "cpu" in runs:
            for n, v in runs["cpu"]["init"].items():
                pe.set_state(n, v)
        init = {n: pe.state(n) for n in sorted(pe._meta)}
        l = float(pe.run(feed)[0][0])
        runs["cuda" if isinstance(place, fluid.CUDAPlace) else "cpu"] = {
            "init": init, "loss": l,
            "params": {p.name: pe.state(p.name)
                       for p in pm.global_block().all_parameters()},
            "devices": sorted({str(v.device) for v in pe._states.values()})}
    res["pp_loss"] = [runs["cpu"]["loss"], runs["cuda"]["loss"]]
    res["pp_param_err"] = max(
        float(np.abs(runs["cpu"]["params"][n] - v).max())
        for n, v in runs["cuda"]["params"].items())
    res["pp_devices"] = runs["cuda"]["devices"]
finally:
    dist.destroy_process_group()
with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f)
"""


def test_a9_ring_and_gpipe_on_cuda_are_the_cpu_result(dev, tmp_path):
    """Two gloo ranks on the one card: ring attention (its K/V shifts
    through host copies) on CUDA tensors gives its CPU result and
    gradients; a GPipe step of a small staged LM on CUDAPlace gives the
    CPU run's loss and parameters from the same states."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    out = str(tmp_path / "a9")
    procs = [subprocess.Popen([sys.executable, "-c", _A9_WORKER, str(r),
                               str(port), out], env=env, cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log[-3000:]
    for rank in range(2):
        with open(f"{out}.{rank}") as f:
            res = json.load(f)
        assert res["ring_device"].startswith("cuda")
        assert res["ring_err"] < 1e-5, res["ring_err"]
        cpu, cuda = res["pp_loss"]
        assert abs(cpu - cuda) <= 1e-4 * abs(cpu), res["pp_loss"]
        assert res["pp_param_err"] < 1e-4, res["pp_param_err"]
        assert all(d.startswith("cuda") for d in res["pp_devices"])


@pytest.mark.parametrize("top_k", [1, 2])
def test_ep_rule_route_kernel_at_world_one_is_moe_dense(dev, top_k):
    """The ep rule's form (`moe_ep_local`) over an 'ep' axis of one, the
    route kernel's path, gives moe_dense's output and gradients on the
    card; the forward kernel and the backward kernel each launch."""
    from paddle_tpu_torch.kernels.moe_dispatch import (
        moe_gate_dispatch, moe_gate_route_backward)
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.moe import moe_dense, moe_ep_local

    gen = torch.Generator().manual_seed(5)
    t_n, d, e_n, h = 256, 128, 8, 256
    x, gw, wi, wo, g = (torch.randn(s, generator=gen) * c for s, c in (
        ((t_n, d), 1.0), ((d, e_n), 0.1), ((e_n, d, h), 0.1),
        ((e_n, h, d), 0.1), ((t_n, d), 1.0)))
    group = make_mesh({"ep": 1}).axis_group("ep")
    res = {}
    for name, fn in (("dense", moe_dense),
                     ("ep", lambda *a, **kw: moe_ep_local(*a, group,
                                                          **kw))):
        ts = [t.to(dev).requires_grad_(True) for t in (x, gw, wi, wo)]
        before = (moe_gate_dispatch.launches,
                  moe_gate_route_backward.launches)
        y, aux = fn(*ts, capacity_factor=1.25, top_k=top_k)
        ((y * g.to(dev)).sum() + aux).backward()
        res[name] = [y.detach(), aux.detach()] + [t.grad for t in ts]
        assert moe_gate_dispatch.launches > before[0]
        assert moe_gate_route_backward.launches > before[1]
    for a, b in zip(res["ep"], res["dense"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- A11's wire: trainers on the card, pservers on the host ------------------

def _ps_cluster(build, n_pservers=2, trainers=1):
    """`build(fluid)` -> (main, startup, loss, optimize ops, params and
    grads), transpiled over `n_pservers` host pservers served from
    threads of this process -> (transpiler, endpoints, stop)."""
    import socket
    import threading
    import time

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.pserver import VariableClient

    eps = []
    for _ in range(n_pservers):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            eps.append(f"127.0.0.1:{sk.getsockname()[1]}")
    main, startup, loss, opt_ops, pg = build(fluid)
    t = fluid.DistributeTranspiler()
    with fluid.program_guard(main, startup):
        t.transpile(optimize_ops=opt_ops, params_grads=pg,
                    trainers=trainers, pservers=",".join(eps))
    threads = []
    for ep in eps:
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(t.get_startup_program(ep),
                                             scope=scope)
        th = threading.Thread(target=lambda p=t.get_pserver_program(ep),
                              s=scope: fluid.Executor(fluid.CPUPlace())
                              .run(p, scope=s), daemon=True)
        th.start()
        threads.append(th)
    for ep in eps:
        host, port = ep.rsplit(":", 1)
        for _ in range(500):
            try:
                socket.create_connection((host, int(port)), 0.2).close()
                break
            except OSError:
                time.sleep(0.02)

    def stop():
        from paddle_tpu_torch.ops.distributed import reset_clients

        for ep in eps:
            VariableClient(ep).stop_server()
        for th in threads:
            th.join(timeout=10)
        reset_clients()

    return (main, startup, loss, pg), t, eps, stop


def _ps_mlp(is_sparse):
    def build(fluid):
        from paddle_tpu_torch.core import framework as fw

        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            emb = fluid.layers.embedding(ids, size=[50, 8],
                                         is_sparse=is_sparse)
            h = fluid.layers.fc(
                input=fluid.layers.concat(
                    [fluid.layers.reshape(emb, shape=[-1, 8]), x], axis=1),
                size=16, act="relu")
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                input=fluid.layers.fc(input=h, size=1), label=y))
            opt_ops, pg = fluid.Adam(learning_rate=0.01).minimize(loss)
        return main, startup, loss, opt_ops, pg
    return build


def _ps_feeds(n):
    import numpy as np

    r = np.random.RandomState(3)
    return [{"ids": r.randint(0, 50, (32, 1)).astype(np.int64),
             "x": r.rand(32, 8).astype(np.float32),
             "y": r.rand(32, 1).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("is_sparse", [False, True], ids=["dense", "sparse"])
def test_pserver_rounds_on_the_card_are_the_serial_executors(dev, is_sparse):
    """A trainer on the card over two host pservers: its startup's recv
    ops leave it the pservers' parameters (not the card's own draws);
    every round — the eager first, the capture, then replays — reads
    the parameters the previous round pulled into the same tensors
    (their storage never moves), and the losses and parameters are the
    serial Executor's on the card from the same start.  With is_sparse
    the embedding's gradient crosses the host as a SelectedRows of the
    card's rows and values."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.pserver import VariableClient

    (main, startup, loss, pg), t, eps, stop = _ps_cluster(
        _ps_mlp(is_sparse))
    names = [p.name for p, _ in pg]
    try:
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        pulled = {}
        for ep in eps:
            mine = [p.name for p, _ in t._pairs_by_ep[ep]]
            c = VariableClient(ep)
            pulled.update(zip(mine, c.get_vars(mine)))
            c.close()
        for n in names:
            v = scope.find_var(n)
            assert v.device.type == "cuda"
            assert torch.equal(v.cpu(), pulled[n]), n
        init = {n: scope.find_var(n).clone() for n in names}
        ptrs = {n: scope.find_var(n).data_ptr() for n in names}
        feeds = _ps_feeds(5)
        losses = [float(np.asarray(exe.run(
            t.get_trainer_program(), feed=f, fetch_list=[loss],
            scope=scope)[0]).reshape(-1)[0]) for f in feeds]
        assert {n: scope.find_var(n).data_ptr() for n in names} == ptrs
        assert exe.graph_stats()["replays"] >= 3
        final = {n: scope.find_var(n).clone() for n in names}
    finally:
        stop()
    s_main, s_startup, s_loss, _, _ = _ps_mlp(is_sparse)(fluid)
    s_scope = fluid.Scope()
    s_exe = fluid.Executor(fluid.CUDAPlace(0))
    s_exe.run(s_startup, scope=s_scope)
    for n, v in init.items():
        s_scope.find_var(n).copy_(v)
    s_losses = [float(np.asarray(s_exe.run(
        s_main, feed=f, fetch_list=[s_loss], scope=s_scope)[0])
        .reshape(-1)[0]) for f in feeds]
    np.testing.assert_allclose(losses, s_losses, rtol=2e-4, atol=1e-5)
    for n in names:
        torch.testing.assert_close(final[n], s_scope.find_var(n),
                                   rtol=2e-4, atol=1e-5)


def test_a_bf16_card_tensor_crosses_the_wire_bit_for_bit(dev):
    """bf16 on the card: serialized as its bits under "bfloat16", held by
    a host pserver, pulled back and copied onto the card — the same bits,
    and a SelectedRows of card rows and values likewise."""
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.lod import SelectedRows
    from paddle_tpu_torch.parallel import pserver as ps

    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 33, generator=g).bfloat16().to(dev)
    back = ps.deserialize_var(ps.serialize_var(x)).to(dev)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    srv = ps.VariableServer(None, fluid.Scope(), None)
    c = ps.VariableClient(f"127.0.0.1:{srv.serve(0)}")
    try:
        c.put_vars([("w", x), ("sr", SelectedRows(
            torch.tensor([3, 1, 3], device=dev), x[:3], 64))])
        w, sr = c.get_vars(["w", "sr"])
    finally:
        c.close()
        srv.stop()
    assert torch.equal(w.to(dev).view(torch.int16), x.view(torch.int16))
    assert sr.rows.tolist() == [3, 1, 3] and sr.height == 64
    assert np.array_equal(sr.value.view(torch.int16).numpy(),
                          x[:3].cpu().view(torch.int16).numpy())


def test_the_card_sqrt_is_torch_sqrt_on_the_device(dev, monkeypatch):
    """The host's correctly rounded sqrt (ops/_math.py) leaves the card
    path as it was: on a CUDA tensor the sqrt op and adam call
    torch.sqrt on the device, never a float64 copy."""
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.ops import _math

    real, seen = torch.sqrt, []

    def spy(x, *a, **kw):
        seen.append((x.device.type, x.dtype))
        return real(x, *a, **kw)

    monkeypatch.setattr(torch, "sqrt", spy)
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(1 << 16, generator=g) * 1e-6).to(dev)
    out = _math.sqrt(x)
    assert seen == [("cuda", torch.float32)]
    assert torch.equal(out, real(x))
    seen.clear()
    got = get_op_info("sqrt").lower(None, {"X": [x]}, {})["Out"]
    got = got[0] if isinstance(got, (list, tuple)) else got
    assert torch.equal(got, real(x)) and seen == [("cuda", torch.float32)]
    seen.clear()
    ins = {"Param": x, "Grad": x, "Moment1": x, "Moment2": x,
           "LearningRate": torch.tensor([1e-4], device=dev),
           "Beta1Pow": torch.tensor([0.9], device=dev),
           "Beta2Pow": torch.tensor([0.999], device=dev)}
    get_op_info("adam").lower(None, {k: [v] for k, v in ins.items()},
                              {"beta1": 0.9, "beta2": 0.999,
                               "epsilon": 1e-8})
    assert seen and all(s == ("cuda", torch.float32) for s in seen)


# -- the serving warm-start artifact: the kernels' build cache -------------

_WARM_PROBE = r"""
import json, sys
from paddle_tpu_torch import CUDAPlace
from paddle_tpu_torch.serving import server_from_model_dir
srv = server_from_model_dir(sys.argv[1], place=CUDAPlace(0),
                            warm_start=sys.argv[2] == "warm")
tokens = srv.generate([1, 2, 3], 6, timeout=300)
st = srv.stats()
print(json.dumps(dict(srv.warmup_stats, warm_start=st["warm_start"],
                      decode_kernel=st["decode_kernel"],
                      launches=st["paged_attention_launches"],
                      tokens=tokens)))
srv.close()
"""


def test_warm_start_artifact_loads_the_kernels_it_built(dev, tmp_path):
    """save_generation_model(warm_start=True) on the card puts the
    paged-attention library (copied from this process's build, or built)
    into the model dir's kernel_cache beside a manifest naming its key
    and the card; a fresh process serving the dir loads it (hits, no
    miss, no compile), and one with the build dir empty and the artifact
    ignored compiles it; both decode on the kernel (its launches after
    warmup counted in the server's stats), the same tokens."""
    import json
    import os
    import subprocess
    import sys

    import paddle_tpu_torch.core.framework as fw
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.kernels import cuda_build
    from paddle_tpu_torch.models.transformer import build_lm_paged_decoder
    from paddle_tpu_torch.serving import save_generation_model
    from paddle_tpu_torch.serving.generation import (WARM_START_DIRNAME,
                                                     WARM_START_MANIFEST)

    fw.reset_unique_names()
    _, dec = build_lm_paged_decoder(64, 16, 4, d_model=64, n_heads=2,
                                    n_layers=1, place=CUDAPlace(0))
    gen = torch.Generator().manual_seed(0)
    states = {n: (torch.randn(s, generator=gen) * 0.02).numpy()
              for n, s in dec.state_shapes.items()}
    d = save_generation_model(
        str(tmp_path / "m"), states,
        {"vocab_size": 64, "d_model": 64, "n_heads": 2, "n_layers": 1,
         "block_size": 16, "max_blocks_per_seq": 4, "slots": 2,
         "kv_blocks": 16}, warm_start=True, place=CUDAPlace(0))
    cache = os.path.join(d, WARM_START_DIRNAME)
    with open(os.path.join(cache, WARM_START_MANIFEST)) as f:
        manifest = json.load(f)
    key = cuda_build.source_key("paged_attention.cu")
    assert manifest["sources"] == {"paged_attention.cu": key}
    assert manifest["compute_capability"] == list(
        torch.cuda.get_device_capability(0))
    assert os.path.exists(os.path.join(cache,
                                       f"paged_attention-{key}.so"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PADDLE_TPU_COMPILATION_CACHE_DIR", None)
    runs = {}
    for mode, extra in (("warm", {}), ("cold", {
            "PADDLE_TPU_COMPILATION_CACHE_DIR": str(tmp_path / "empty")})):
        res = subprocess.run(
            [sys.executable, "-c", _WARM_PROBE, d, mode], cwd=root,
            env=dict(env, **extra), capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        runs[mode] = json.loads(res.stdout.strip().splitlines()[-1])
    warm, cold = runs["warm"], runs["cold"]
    assert warm["warm_start"] and warm["decode_kernel"] == "cuda"
    assert (warm["compiles"], warm["cache_misses"]) == (0, 0)
    assert warm["cache_hits"] >= 1
    assert not cold["warm_start"] and cold["decode_kernel"] == "cuda"
    assert cold["compiles"] >= 1 and cold["cache_misses"] >= 1
    assert warm["launches"] >= 5 and cold["launches"] >= 5
    assert warm["tokens"] == cold["tokens"]
