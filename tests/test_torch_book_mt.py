"""book/08 (tests/book/test_machine_translation.py) in the port against
the JAX package, on the CPU: the book file's own functions build each
Program with each package as their `fluid`, and the Programs must be
equal op for op (the DynamicRNN's and the While loop's sub-blocks
included).

  * `decoder_train` (the DynamicRNN decoder) and
    `decoder_train_attention` (its attention variant, BASELINE.json:10's
    configuration, source padded to the book's 6): 10 Adam steps (the
    book's lr 0.01) over the book's `_make_batch` data, from the JAX
    startup's parameters, every step's loss within test_torch_book.py's
    limits (1e-5 relative plus 5e-7), and falling;
  * `decoder_decode` (the While + beam_search decoder) on the book's own
    decode feed (:149-183): the sentences' ids and their two-level LoD
    equal, their scores within 1e-5 relative;
  * chip_smoke's card-vs-CPU decode verdict on hand-built beam records:
    a differing decode passes only at a flipped near tie.
"""
import importlib.util
import os
import sys
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.scope import Scope

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_training import (_assert_same_program,  # noqa: E402
                                 _start_both)

LOSS_RTOL, LOSS_ATOL = 1e-5, 5e-7
SCORE_RTOL = 1e-5
STEPS, MAXS = 10, 6


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


def _book(fluid):
    """The book file, its `fluid` being `fluid`."""
    spec = importlib.util.spec_from_file_location(
        "test_machine_translation",
        os.path.join(HERE, "book", "test_machine_translation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fluid = fluid
    return mod


def _port_feed(feed):
    return {k: LoDTensor(np.asarray(v.data), v.lod)
            if isinstance(v, JLoDTensor) else v for k, v in feed.items()}


def _train_program(fluid, fw, attention):
    book = _book(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if attention:
            enc_seq, context = book._encoder_full_seq()
            out = book.decoder_train_attention(enc_seq, context, MAXS)
        else:
            out = book.decoder_train(book.encoder())
        label = fluid.layers.data(name="target_language_next_word",
                                  shape=[1], dtype="int64", lod_level=1)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=out,
                                                            label=label))
        fluid.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss, book


def _feeds(book, attention):
    """The book's four batches (RandomState(0)), cycled; the attention
    test's validity mask beside each."""
    r = np.random.RandomState(0)
    batches = []
    for _ in range(4):
        src, trg, nxt = book._make_batch(r)
        feed = {"src_word_id": src, "target_language_word": trg,
                "target_language_next_word": nxt}
        if attention:
            lens = np.diff(src.lod[0])
            m = np.zeros((len(lens), MAXS), np.float32)
            for i, ln in enumerate(lens):
                m[i, :ln] = 1.0
            feed["att_mask"] = m
        batches.append(feed)
    return [batches[i % 4] for i in range(STEPS)]


@pytest.mark.parametrize("attention", [False, True],
                         ids=["decoder_train", "decoder_train_attention"])
def test_book08_decoder_trains_like_jax(attention):
    jm, js, jl, book = _train_program(jfluid, jfw, attention)
    tm, ts, tl, _ = _train_program(tfluid, tfw, attention)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("dynamic_rnn") == types.count("dynamic_rnn_grad") \
        == 1
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _feeds(book, attention):
        jloss.append(float(np.asarray(
            jexe.run(jm, feed=feed, fetch_list=[jl])[0]).reshape(-1)[0]))
        tloss.append(float(texe.run(tm, feed=_port_feed(feed),
                                    fetch_list=[tl])[0].reshape(-1)[0]))
    assert np.all(np.isfinite(tloss))
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert tloss[-1] < tloss[0]


def _decode_program(fluid, fw):
    book = _book(fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids, scores = book.decoder_decode(book.encoder())
    return main, startup, [ids, scores], book


def test_book08_decoder_decode_like_jax():
    """The book's decode test's feed (three sources, <s> starts, scores
    1): both packages' While + beam_search loops give the same sentences
    from the JAX startup's parameters."""
    jm, js, jf, book = _decode_program(jfluid, jfw)
    tm, ts, tf, _ = _decode_program(tfluid, tfw)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    for main in (jm, tm):
        assert [op.type for op in main.blocks[1].ops].count(
            "beam_search") == 1
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    src, _, _ = book._make_batch(np.random.RandomState(1), n=3)
    lod = [list(range(4)), list(range(4))]
    feed = {"src_word_id": src,
            "init_ids": JLoDTensor(np.full((3, 1), book.START, np.int64),
                                   lod),
            "init_scores": JLoDTensor(np.ones((3, 1), np.float32), lod)}
    j_ids, j_scores = jexe.run(jm, feed=feed, fetch_list=jf)
    t_ids, t_scores = texe.run(tm, feed=_port_feed(feed), fetch_list=tf)
    assert t_ids.lod == tuple(tuple(lv) for lv in j_ids.lod)
    assert t_scores.lod == t_ids.lod
    assert len(t_ids.lod[0]) - 1 == 3 and t_ids.lod[0][-1] >= 3
    np.testing.assert_array_equal(t_ids.data,
                                  np.asarray(j_ids.data).astype(np.int64))
    assert t_ids.data.dtype == np.int64
    np.testing.assert_allclose(t_scores.data, np.asarray(j_scores.data),
                               rtol=SCORE_RTOL)
    sent = t_ids.lod[1]
    assert all(1 <= b - a <= book.MAX_LEN + 1 for a, b in zip(sent, sent[1:]))


def _verdict_steps():
    """Two beam_search steps over two sources, as chip_smoke's
    `_beam_record` keeps them: (ids, candidates a prefix, scores, gap);
    step 1's first source is a near tie (gap 4e-6)."""
    f = lambda *v: np.asarray(v, np.float32)  # noqa: E731
    return [[((3, 5), (1, 1), f(.5, .4), .2), ((2, 7), (2,), f(.6, .3), .3)],
            [((4, 1), (1, 1), f(.7, .2), 4e-6), ((6, 6), (1, 1),
                                                 f(.4, .1), .5)]]


def _verdict_decode(ids):
    lod = ((0, 2, 4), (0, 2, 4, 6, 8))
    return (types.SimpleNamespace(lod=lod, data=np.asarray(ids, np.int64)),
            types.SimpleNamespace(lod=lod, data=np.linspace(
                .1, .8, 8).astype(np.float32)))


def _flip(steps, t, s):
    ids, counts, scores, gap = steps[t][s]
    steps[t][s] = ((ids[1], ids[0] + 1), counts, scores, gap)


@pytest.mark.parametrize("case, passes", [
    ("equal", True), ("near_tie_flipped", True), ("wide_gap_flipped", False),
    ("score_off", False), ("decode_differs", False)])
def test_card_vs_cpu_decode_verdict(case, passes):
    """chip_smoke's card-vs-CPU decode check: a decode that differs from
    the reference passes only where its first differing step flipped a
    near tie (that source's chosen-vs-rejected gap within the limit);
    a flip at a wide gap, a score off by more than the limit, or equal
    steps that decode to other sentences fail."""
    import chip_smoke

    want, got = _verdict_steps(), _verdict_steps()
    got_out = _verdict_decode(range(8))
    if case == "near_tie_flipped":
        _flip(got, 1, 0)
    elif case == "wide_gap_flipped":
        _flip(got, 0, 1)
    elif case == "score_off":
        ids, counts, scores, gap = got[1][1]
        got[1][1] = (ids, counts, scores * np.float32(1 + 1e-4), gap)
    elif case == "decode_differs":
        got_out = _verdict_decode([0, 1, 2, 3, 4, 5, 7, 6])
    ok, rec = chip_smoke._decode_verdict(got, want, got_out,
                                         _verdict_decode(range(8)), 1e-5)
    assert ok == passes, rec
    assert rec["min_chosen_vs_rejected_gap"] == 4e-6
    if case.endswith("flipped"):
        assert rec["first_differing_step"] == (1 if passes else 0)
