"""book/07 (tests/book/test_label_semantic_roles.py) and book/04
(tests/book/test_word2vec.py) in the port against the JAX package, on
the CPU.  Each book's network is built with each package (book/07's
lines 58-90: embedding, fc, dynamic_lstm, linear_chain_crf sharing
`crfw` with crf_decoding, chunk_eval; book/04's lines 20-55: four
embeddings sharing one table, concat, two fc, cross entropy), and the
two Programs must be equal op for op.  From the JAX startup's
parameters:

  * book/07 trains 12 SGD steps (the book's lr 0.05) over the book
    file's own `make_batch` data (loaded with each package as its
    `fluid`), and its eval program (`fluid.io.get_inference_program` of
    F1, precision and recall, as the book builds it) gives the same
    precision, recall and F1 on a fresh batch;
  * book/04 trains 30 Adam steps (the book's lr 0.01) on the book's
    batches.  Its save/load half is
    tests/test_torch_io.py::test_inference_model_round_trip_across_packages.

Every step's loss within tests/test_torch_book.py's limits (1e-5
relative plus 5e-7 absolute), and falling.
"""
import importlib.util
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
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.scope import Scope

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_torch_training import (_assert_same_program,  # noqa: E402
                                 _start_both)

LOSS_RTOL, LOSS_ATOL = 1e-5, 5e-7
SRL_STEPS, W2V_STEPS = 12, 30


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


def _book(name, fluid):
    """The book file, its `fluid` being `fluid`."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "book", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fluid = fluid
    return mod


def _srl_program(fluid, fw):
    """tests/book/test_label_semantic_roles.py:58-90."""
    book = _book("test_label_semantic_roles", fluid)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        word = fluid.layers.data(name="word", shape=[1], dtype="int64",
                                 lod_level=1)
        target = fluid.layers.data(name="target", shape=[1], dtype="int64",
                                   lod_level=1)
        emb = fluid.layers.embedding(input=word, size=[book.WORD_N, 32])
        hidden = fluid.layers.fc(input=emb, size=64, act="tanh")
        lstm, _cell = fluid.layers.dynamic_lstm(
            input=fluid.layers.fc(input=hidden, size=64 * 4), size=64 * 4)
        feature_out = fluid.layers.fc(input=[hidden, lstm], size=book.TAG_N)
        crf_cost = fluid.layers.linear_chain_crf(
            input=feature_out, label=target, param_attr={"name": "crfw"})
        avg_cost = fluid.layers.mean(crf_cost)
        fluid.SGD(learning_rate=0.05).minimize(avg_cost)
        crf_decode = fluid.layers.crf_decoding(
            input=feature_out, param_attr={"name": "crfw"})
        precision, recall, f1, *_ = fluid.layers.chunk_eval(
            input=crf_decode, label=target, chunk_scheme="IOB",
            num_chunk_types=2)
    eval_prog = fluid.io.get_inference_program([f1, precision, recall],
                                               main)
    r = np.random.RandomState(0)
    batches = [book.make_batch(r) for _ in range(6)]
    feeds = [{"word": w, "target": t} for w, t in batches]
    w, t = book.make_batch(r)
    return (main, startup, avg_cost, eval_prog, [f1, precision, recall],
            [feeds[i % len(feeds)] for i in range(SRL_STEPS)],
            {"word": w, "target": t})


def _port_feed(feed):
    """A JAX package feed's LoDTensors as the port's."""
    return {k: tfluid.LoDTensor(np.asarray(v.data), v.lod)
            if isinstance(v, JLoDTensor) else v for k, v in feed.items()}


def _losses(exe, main, feeds, loss):
    return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])
                  .reshape(-1)[0]) for f in feeds]


def _held(tloss, jloss):
    assert np.all(np.isfinite(tloss))
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert tloss[-1] < tloss[0]


def test_book07_tagger_trains_and_evaluates_like_jax():
    jm, js, jl, jeval, jt, jfeeds, jfresh = _srl_program(jfluid, jfw)
    tm, ts, tl, teval, tt, tfeeds, tfresh = _srl_program(tfluid, tfw)
    _assert_same_program(jm, tm)
    _assert_same_program(jeval, teval)
    types = [op.type for op in tm.global_block().ops]
    assert {"linear_chain_crf", "linear_chain_crf_grad", "crf_decoding",
            "chunk_eval"} <= set(types)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    jloss = _losses(jexe, jm, jfeeds, jl)
    tloss = _losses(texe, tm, [_port_feed(f) for f in jfeeds], tl)
    _held(tloss, jloss)
    jres = [float(np.asarray(v)) for v in
            jexe.run(jeval, feed=jfresh, fetch_list=jt)]
    tres = [float(np.asarray(v)) for v in
            texe.run(teval, feed=_port_feed(jfresh), fetch_list=tt)]
    assert tres == jres, (tres, jres)


def _w2v_program(fluid, fw):
    """tests/book/test_word2vec.py:20-55 and its batches."""
    dict_n, emb_n = 32, 16
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
                 for i in range(4)]
        next_word = fluid.layers.data(name="next", shape=[1], dtype="int64")
        embeds = [fluid.layers.embedding(input=w, size=[dict_n, emb_n],
                                         param_attr={"name": "shared_w"})
                  for w in words]
        concat = fluid.layers.concat(input=embeds, axis=1)
        hidden = fluid.layers.fc(input=concat, size=64, act="sigmoid")
        predict = fluid.layers.fc(input=hidden, size=dict_n, act="softmax")
        cost = fluid.layers.cross_entropy(input=predict, label=next_word)
        avg_cost = fluid.layers.mean(cost)
        fluid.Adam(learning_rate=0.01).minimize(avg_cost)
    r = np.random.RandomState(0)
    feeds = []
    for _ in range(W2V_STEPS):
        base = r.randint(0, dict_n, (64, 1)).astype(np.int64)
        feed = {f"w{i}": (base + i) % dict_n for i in range(4)}
        feed["next"] = (base + 4) % dict_n
        feeds.append(feed)
    return main, startup, avg_cost, feeds


def test_book04_word2vec_trains_like_jax():
    jm, js, jl, feeds = _w2v_program(jfluid, jfw)
    tm, ts, tl, _ = _w2v_program(tfluid, tfw)
    _assert_same_program(jm, tm)
    jexe, texe, _ = _start_both(jm, js, tm, ts)
    _held(_losses(texe, tm, feeds, tl), _losses(jexe, jm, feeds, jl))
