"""The LSTM models of benchmark/run_rnn.py and benchmark/run_seq2seq.py
(`--model rnn`) in the port against the JAX package, on the CPU, at a
small width, and the LoDTensor plumbing they ride on.

  * run_rnn's Program (run_rnn.py:33-50: embedding, fc to 4 x hidden,
    dynamic_lstm with peepholes, the last step, fc softmax, cross
    entropy, Adam 2e-3) at vocab 50, embedding 16, hidden 8, batch 4,
    ragged lengths 1-7, with a float32 and a bfloat16 embedding (run_rnn's
    `--dtype`): the Programs equal, var dtypes included, and 3 steps
    from the JAX startup's parameters give the JAX package's per-step
    losses within 1e-5 relative plus 5e-7, each package in its default
    mode;
  * the rnn seq2seq (run_seq2seq.py:63-103: an LSTM encoder, its last
    step expanded over the target and concatenated to the target
    embedding, an LSTM decoder, fc softmax) at vocab 40, hidden and
    embedding 8, with and without bf16 amp, the same way;
  * K distinct LoDs over N steps make K cache entries
    (tests/test_bucketing.py:53), and a LoD seen again replays its
    entry;
  * the LoD is kept through embedding, fc (mul, elementwise_add, the
    activation), the sequence and recurrent ops exactly where the JAX
    package keeps it, and a fetched LoDTensor comes back as one.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.lod import LoDTensor, lod_from_seq_lens
from paddle_tpu_torch.core.scope import Scope

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (_assert_same_program,  # noqa: E402
                                 _start_both)

LOSS_RTOL, LOSS_ATOL = 1e-5, 5e-7
V, E, HID, B = 50, 16, 8, 4
S_V, S_H = 40, 8


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()
    jfluid.amp.disable_bf16()


def rnn_classifier(fluid, fw, dtype="float32", vocab=V, emb_dim=E,
                   hidden=HID, lr=2e-3):
    """run_rnn.py:33-50's Program."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=data, size=[vocab, emb_dim],
                                     dtype=dtype)
        proj = fluid.layers.fc(input=emb, size=hidden * 4)
        lstm_out, _ = fluid.layers.dynamic_lstm(input=proj, size=hidden * 4)
        last = fluid.layers.sequence_pool(lstm_out, pool_type="last")
        predict = fluid.layers.fc(input=last, size=2, act="softmax")
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg = fluid.layers.mean(cost)
        fluid.Adam(learning_rate=lr).minimize(avg)
    return main, startup, avg


def rnn_seq2seq(fluid, fw, vocab=S_V, hidden=S_H, emb_dim=S_H, lr=1e-4):
    """run_seq2seq.py:63-103's `--model rnn` Program."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src", shape=[1], dtype="int64",
                                lod_level=1)
        tgt = fluid.layers.data(name="tgt", shape=[1], dtype="int64",
                                lod_level=1)
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64",
                                lod_level=1)
        src_emb = fluid.layers.embedding(input=src, size=[vocab, emb_dim])
        enc_in = fluid.layers.fc(input=src_emb, size=hidden * 4, act="tanh")
        enc, _ = fluid.layers.dynamic_lstm(input=enc_in, size=hidden * 4,
                                           use_peepholes=False)
        context = fluid.layers.sequence_last_step(input=enc)
        tgt_emb = fluid.layers.embedding(input=tgt, size=[vocab, emb_dim])
        ctx_exp = fluid.layers.sequence_expand(x=context, y=tgt_emb)
        dec_in = fluid.layers.concat([tgt_emb, ctx_exp], axis=1)
        dec_proj = fluid.layers.fc(input=dec_in, size=hidden * 4,
                                   act="tanh")
        dec, _ = fluid.layers.dynamic_lstm(input=dec_proj, size=hidden * 4,
                                           use_peepholes=False)
        probs = fluid.layers.fc(input=dec, size=vocab, act="softmax")
        cost = fluid.layers.cross_entropy(input=probs, label=lbl)
        avg = fluid.layers.mean(cost)
        fluid.Adam(learning_rate=lr).minimize(avg)
    return main, startup, avg


def _seq(r, vocab, lens):
    return (r.randint(0, vocab, (int(sum(lens)), 1)).astype(np.int64),
            [lod_from_seq_lens(lens)])


def rnn_feeds(steps, seed=0, batch=B, vocab=V, lo=1, hi=7):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        lens = r.randint(lo, hi + 1, batch)
        out.append({"words": _seq(r, vocab, lens),
                    "label": r.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


def s2s_feeds(steps, seed=0, batch=B, vocab=S_V):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        src = r.randint(1, 7, batch)
        tgt = r.randint(1, 7, batch)
        out.append({"src": _seq(r, vocab, src), "tgt": _seq(r, vocab, tgt),
                    "lbl": _seq(r, vocab, tgt)})
    return out


def _feed(pkg, feed):
    """A feed of (array, lod) items as either package's LoDTensors."""
    lod_t = JLoDTensor if pkg == "jax" else LoDTensor
    return {k: lod_t(*v) if isinstance(v, tuple) else v
            for k, v in feed.items()}


def _train_both(builder, feeds, amp=False, **kw):
    if amp:
        jfluid.amp.enable_bf16()
        tfluid.amp.enable_bf16()
    jmain, jstart, jloss = builder(jfluid, jfw, **kw)
    tmain, tstart, tloss = builder(tfluid, tfw, **kw)
    _assert_same_program(jmain, tmain)
    jexe, texe, _ = _start_both(jmain, jstart, tmain, tstart)
    jl, tl = [], []
    for f in feeds:
        jl.append(float(np.asarray(jexe.run(jmain, feed=_feed("jax", f),
                                             fetch_list=[jloss])[0])
                        .reshape(-1)[0]))
        tl.append(float(texe.run(tmain, feed=_feed("torch", f),
                                 fetch_list=[tloss])[0].reshape(-1)[0]))
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    return jl, tl, texe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_rnn_program_trains_as_the_jax_package(dtype):
    _, tl, texe = _train_both(rnn_classifier, rnn_feeds(3), dtype=dtype)
    assert texe.cache_stats()["misses"] == 4   # the startup, three LoDs


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_rnn_seq2seq_trains_as_the_jax_package(amp):
    _train_both(rnn_seq2seq, s2s_feeds(3), amp=amp)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_lstm_weights_and_hidden_stay_float32(amp):
    """With run_rnn's bf16 embedding, and under amp, the LSTM's weights
    and bias are float32 Program vars and its Hidden a float32 tensor at
    run time, in both packages."""
    if amp:
        jfluid.amp.enable_bf16()
        tfluid.amp.enable_bf16()
    hidden = {}
    for pkg, fluid, fw in (("jax", jfluid, jfw), ("torch", tfluid, tfw)):
        main, startup, _ = rnn_classifier(fluid, fw, dtype="bfloat16")
        blk = main.global_block()
        op = next(o for o in blk.ops if o.type == "lstm")
        for slot in ("Weight", "Bias"):
            assert blk.var(op.input(slot)[0]).dtype == "float32", pkg
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        out, = exe.run(main, feed=_feed(pkg, rnn_feeds(1)[0]),
                       fetch_list=[op.output("Hidden")[0]],
                       return_numpy=False, compiled=False)
        hidden[pkg] = str(out.data.dtype)
    assert hidden == {"jax": "float32", "torch": "torch.float32"}


def test_distinct_lods_make_one_cache_entry_each():
    """K distinct LoDs over N steps: K entries, K misses, N - K hits."""
    tmain, tstart, tloss = rnn_classifier(tfluid, tfw)
    exe = tfluid.Executor(CPUPlace())
    exe.run(tstart)
    base = exe.cache_stats()["entries"]
    feeds = rnn_feeds(3, seed=1)
    order = [0, 1, 0, 2, 1, 0, 2, 2]
    for i in order:
        exe.run(tmain, feed=_feed("torch", feeds[i]), fetch_list=[tloss])
    stats = exe.cache_stats()
    assert stats["entries"] - base == 3
    assert stats["misses"] - base == 3
    assert stats["hits"] == len(order) - 3


def test_the_cache_is_bounded():
    """More distinct LoDs than CACHE_MAX: the least recently used entries
    go, and a LoD seen again after its entry went is a miss again."""
    tmain, tstart, tloss = rnn_classifier(tfluid, tfw)
    exe = tfluid.Executor(CPUPlace())
    exe.run(tstart)
    old = texecutor.CACHE_MAX
    texecutor.CACHE_MAX = 3
    try:
        feeds = rnn_feeds(4, seed=2)
        for i in (0, 1, 2, 3, 0):
            exe.run(tmain, feed=_feed("torch", feeds[i]), fetch_list=[tloss])
        stats = exe.cache_stats()
        assert stats["entries"] == 3
        assert stats["misses"] == 6     # the startup, 4 LoDs, then 0 again
    finally:
        texecutor.CACHE_MAX = old


def test_an_entry_owns_the_index_tables_its_runs_read():
    """The index tables a LoD's plan builds live in that LoD's cache
    entry: its first run builds them, a later run of the LoD reads the
    same tensors (what a capture at the first hit reads), another LoD's
    entry holds its own, and the tables go when their entry goes."""
    tmain, tstart, tloss = rnn_classifier(tfluid, tfw)
    exe = tfluid.Executor(CPUPlace())
    exe.run(tstart)
    feeds = rnn_feeds(3, seed=3)
    exe.run(tmain, feed=_feed("torch", feeds[0]), fetch_list=[tloss])
    first = list(exe._cache.values())[-1]
    built = dict(first.tables)
    assert any(k[0] == "sequence" for k in built)
    exe.run(tmain, feed=_feed("torch", feeds[0]), fetch_list=[tloss])
    assert list(exe._cache.values())[-1] is first
    assert first.tables.keys() == built.keys()
    assert all(first.tables[k] is v for k, v in built.items())
    exe.run(tmain, feed=_feed("torch", feeds[1]), fetch_list=[tloss])
    second = list(exe._cache.values())[-1]
    assert second is not first and second.tables is not first.tables
    assert not set(second.tables) & {k for k in built if k[0] == "sequence"}
    old = texecutor.CACHE_MAX
    texecutor.CACHE_MAX = 1
    try:
        exe.run(tmain, feed=_feed("torch", feeds[2]), fetch_list=[tloss])
    finally:
        texecutor.CACHE_MAX = old
    (last,) = exe._cache.values()
    assert last is not first and last is not second


def _lod_of(v):
    if isinstance(v, (LoDTensor, JLoDTensor)):
        return [list(level) for level in v.lod]
    return None


def test_lod_is_kept_where_the_jax_package_keeps_it():
    """Every var of run_rnn's and the seq2seq's forward and backward
    (the gradients of the explicit `mul` and `lookup_table` gradient ops
    among them), fetched in both packages' interpreters: a LoDTensor in
    the port exactly where it is one in the JAX package, with the same
    LoD and values."""
    for builder, feed in ((rnn_classifier, rnn_feeds(1)[0]),
                          (rnn_seq2seq, s2s_feeds(1)[0])):
        jmain, jstart, jloss = builder(jfluid, jfw)
        tmain, tstart, tloss = builder(tfluid, tfw)
        jexe, texe, _ = _start_both(jmain, jstart, tmain, tstart)
        names = []
        for op in tmain.global_block().ops:
            if op.type in ("adam", "scale"):
                break
            names += [n for slot, ns in op.outputs.items() for n in ns
                      if slot != "MaxIndex" and n not in names]
        jv = jexe.run(jmain, feed=_feed("jax", feed), fetch_list=names,
                      compiled=False)
        tv = texe.run(tmain, feed=_feed("torch", feed), fetch_list=names,
                      compiled=False)
        kept = 0
        for n, a, b in zip(names, jv, tv):
            assert _lod_of(b) == _lod_of(a), n
            kept += _lod_of(b) is not None
            a = a.data if isinstance(a, JLoDTensor) else a
            b = b.data if isinstance(b, LoDTensor) else b
            np.testing.assert_allclose(
                np.asarray(b, np.float64), np.asarray(a, np.float64),
                rtol=1e-5, atol=1e-6, err_msg=n)
        assert kept >= 12


def test_segmented_mode_keys_a_segment_on_its_lod():
    """A host op (sequence_erase) makes a LoD from the data between two
    device segments: the segment after it is one cache entry per LoD it
    is given, and each step's loss is the interpreter's."""
    tfw.reset_unique_names()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        words = tfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=1)
        erased = main.global_block().create_var(
            name="erased", dtype="int64", lod_level=1)
        main.global_block().append_op(
            type="sequence_erase", inputs={"X": [words.name]},
            outputs={"Out": [erased.name]}, attrs={"tokens": [0]})
        emb = tfluid.layers.embedding(input=erased, size=[V, E])
        pooled = tfluid.layers.sequence_pool(emb, pool_type="sum")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=pooled, size=1))
    exe = tfluid.Executor(CPUPlace())
    exe.run(startup)
    r = np.random.RandomState(3)
    feeds = []
    for lens in ([3, 4], [3, 4], [2, 5]):
        ids = r.randint(0, 3, (sum(lens), 1)).astype(np.int64)
        feeds.append(_feed("torch", {"words": (ids, [lod_from_seq_lens(
            lens)])}))
    base = exe.cache_stats()
    got = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
           for f in feeds]
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          compiled=False)[0][0]) for f in feeds]
    assert got == want
    lods = {tuple(tuple(lv) for lv in exe.run(
        main, feed=f, fetch_list=["erased"], return_numpy=True,
        compiled=False)[0].lod) for f in feeds}
    stats = exe.cache_stats()
    # the erase runs first, on the host; the device segment after it is
    # one entry per LoD the erase made (an empty sequence among them)
    assert len(lods) == 3
    assert stats["entries"] - base["entries"] == len(lods)
