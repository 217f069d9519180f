"""The linear-chain CRF ops (paddle_tpu/ops/crf.py) in the port against
the JAX package and against exact path enumeration, on the CPU, from the
same numpy inputs, as tests/test_crf_ops.py holds the JAX package:

  * linear_chain_crf's negative log-likelihood against the enumeration
    of every tag path (tests/test_crf_ops.py `enumerate_crf`,
    `gold_score`) in float64 within 1e-9 relative, and against the JAX
    op in float32 within 1e-6 relative; its generic gradient (autograd
    through the loop) against `jax.vjp` of the JAX op within 1e-5;
  * crf_decoding's ids exactly: against the enumeration's best paths,
    with and without Label, with T = 1 sequences, and on integer scores
    full of ties against the JAX op (both take the first maximal index);
  * chunk_eval exactly, every scheme, with excluded chunk types;
  * the op-test harness (tests/test_torch_op_test.py) over the `crf`
    group of tests/torch_op_cases.py: numpy forward, finite differences
    and the JAX lowering;
  * the layers through the Executor, and `fluid.io`'s pruning.
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
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import LoDTensor as JLoDTensor

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import ExecContext
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.scope import Scope

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from test_crf_ops import enumerate_crf, gold_score  # noqa: E402
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("crf")
NLL_RTOL, GRAD_RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    tflags.reset_flags()


# -- the op-test harness -------------------------------------------------------

@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)


# -- the lowerings on their own ------------------------------------------------

# (lod, tags): sequences of lengths 1 to 5, T = 1 among them
LODS = {"mixed": [(0, 3, 4, 9, 11)], "t1": [(0, 1, 2, 3)],
        "long": [(0, 5, 6, 8)]}


def _inputs(key, d=3, dtype=np.float64, ints=False):
    r = np.random.RandomState(len(key) * 7 + d)
    lod = LODS[key]
    n = lod[0][-1]
    if ints:
        em = r.randint(0, 2, (n, d)).astype(dtype)
        tr = r.randint(0, 2, (d + 2, d)).astype(dtype)
    else:
        em = r.standard_normal((n, d)).astype(dtype)
        tr = (0.5 * r.standard_normal((d + 2, d))).astype(dtype)
    lab = r.randint(0, d, (n, 1)).astype(np.int64)
    return em, tr, lab, lod


def _port(op, em, tr, lab, lod, grad=False):
    ins = {"Emission": [LoDTensor(torch.from_numpy(em).requires_grad_(grad),
                                  lod)],
           "Transition": [torch.from_numpy(tr).requires_grad_(grad)]}
    if lab is not None:
        ins["Label"] = [LoDTensor(torch.from_numpy(lab), lod)]
    info = treg.get_op_info(op)
    return info.lower(ExecContext("cpu"), ins, dict(info.attrs)), ins


def _jax(op, em, tr, lab, lod):
    ins = {"Emission": [JLoDTensor(jnp.asarray(em), lod)],
           "Transition": [jnp.asarray(tr)]}
    if lab is not None:
        ins["Label"] = [JLoDTensor(jnp.asarray(lab), lod)]
    info = jreg.get_op_info(op)
    return info.lower(JExecContext(), ins, dict(info.attrs))


@pytest.mark.parametrize("key", sorted(LODS))
def test_nll_is_the_enumeration_and_the_jax_ops(key):
    em, tr, lab, lod = _inputs(key)
    logz, _, _ = enumerate_crf(em, tr, lod)
    want = logz - gold_score(em, tr, lod, lab)
    got, _ = _port("linear_chain_crf", em, tr, lab, lod)
    np.testing.assert_allclose(got["LogLikelihood"].numpy()[:, 0], want,
                               rtol=1e-9)
    em32, tr32 = em.astype(np.float32), tr.astype(np.float32)
    got, _ = _port("linear_chain_crf", em32, tr32, lab, lod)
    jout = _jax("linear_chain_crf", em32, tr32, lab, lod)
    np.testing.assert_allclose(got["LogLikelihood"].numpy(),
                               np.asarray(jout["LogLikelihood"]),
                               rtol=NLL_RTOL)
    np.testing.assert_allclose(got["Alpha"].data.numpy(),
                               np.asarray(jout["Alpha"].data),
                               rtol=NLL_RTOL, atol=1e-6)
    assert got["Alpha"].lod == tuple(tuple(x) for x in lod)


@pytest.mark.parametrize("key", sorted(LODS))
def test_gradient_is_jax_vjp(key):
    em, tr, lab, lod = _inputs(key, d=4, dtype=np.float32)
    cot = np.random.RandomState(1).standard_normal(
        (len(lod[0]) - 1, 1)).astype(np.float32)
    out, ins = _port("linear_chain_crf", em, tr, lab, lod, grad=True)
    got = torch.autograd.grad(out["LogLikelihood"],
                              [ins["Emission"][0].data,
                               ins["Transition"][0]],
                              torch.from_numpy(cot))

    def f(e, t):
        return _jax("linear_chain_crf", e, t, lab, lod)["LogLikelihood"]

    _, vjp = jax.vjp(f, jnp.asarray(em), jnp.asarray(tr))
    want = vjp(jnp.asarray(cot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=1e-6)


@pytest.mark.parametrize("key", sorted(LODS))
@pytest.mark.parametrize("with_label", [False, True])
def test_decoding_is_the_enumerations_best_path(key, with_label):
    em, tr, lab, lod = _inputs(key)
    _, paths, _ = enumerate_crf(em, tr, lod)
    want = np.concatenate([np.asarray(p) for p in paths])
    got, _ = _port("crf_decoding", em.astype(np.float32),
                   tr.astype(np.float32), lab if with_label else None, lod)
    path = got["ViterbiPath"]
    assert path.data.dtype == torch.int64 and path.data.shape == (len(em), 1)
    assert path.lod == tuple(tuple(x) for x in lod)
    if with_label:
        want = (want == lab[:, 0]).astype(np.int64)
    np.testing.assert_array_equal(path.data.numpy()[:, 0], want)


@pytest.mark.parametrize("key", sorted(LODS))
def test_tied_scores_decode_as_the_jax_op(key):
    """Integer scores of 0 and 1: many paths tie, and both packages
    take the first maximal index at every step."""
    em, tr, _, lod = _inputs(key, d=4, dtype=np.float32, ints=True)
    got, _ = _port("crf_decoding", em, tr, None, lod)
    jout = _jax("crf_decoding", em, tr, None, lod)
    np.testing.assert_array_equal(got["ViterbiPath"].data.numpy(),
                                  np.asarray(jout["ViterbiPath"].data))


def test_chunk_extraction_is_the_reference_semantics():
    """tests/test_crf_ops.py's pinned ChunkBegin/ChunkEnd cases."""
    from paddle_tpu.ops.crf import _extract_chunks as jextract
    from paddle_tpu_torch.ops.crf import _extract_chunks

    cases = [([2, 1], "IOB", 1, {(1, 1, 0)}),
             ([0, 3], "IOB", 2, {(0, 0, 0), (1, 1, 1)}),
             ([0, 0], "IOE", 1, {(0, 1, 0)}),
             ([0, 1], "IOBES", 1, {(0, 1, 0)}),
             ([3, 4, 0, 1, 2], "IOBES", 1, {(0, 0, 0), (2, 4, 0)})]
    for tags, scheme, n, want in cases:
        assert _extract_chunks(tags, scheme, n, set()) == want
        assert jextract(tags, scheme, n, set()) == want
    r = np.random.RandomState(0)
    for scheme, k in (("IOB", 2), ("IOE", 2), ("IOBES", 4), ("plain", 1)):
        for _ in range(50):
            tags = r.randint(0, 3 * k + 1, r.randint(1, 12))
            for excluded in (set(), {1}):
                assert _extract_chunks(tags, scheme, 3, excluded) == \
                    jextract(tags, scheme, 3, excluded)


# -- the layers through the Executor -------------------------------------------

def test_layers_decode_and_evaluate_through_the_executor():
    """tests/test_crf_ops.py's layer cases in the port: crf_decoding
    with a fed transition against the enumeration, and chunk_eval's IOB
    example (P = R = F1 = 0.5 from 4, 4 and 2 chunks)."""
    fluid = tfluid
    d, lod = 3, [(0, 2, 6, 7)]
    r = np.random.RandomState(3)
    emission = r.standard_normal((7, d)).astype(np.float32)
    transition = (r.standard_normal((d + 2, d)) * 0.7).astype(np.float32)
    _, paths, _ = enumerate_crf(emission.astype(np.float64),
                                transition.astype(np.float64), lod)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        em = fluid.layers.data(name="em", shape=[d], dtype="float32",
                               lod_level=1)
        path = fluid.layers.crf_decoding(input=em,
                                         param_attr={"name": "tr"})
        i = fluid.layers.data(name="i", shape=[1], dtype="int64",
                              lod_level=1)
        lab = fluid.layers.data(name="l", shape=[1], dtype="int64",
                                lod_level=1)
        outs = fluid.layers.chunk_eval(input=i, label=lab,
                                       chunk_scheme="IOB",
                                       num_chunk_types=2)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    inf = np.array([0, 1, 4, 2, 2, 0, 4, 4])[:, None].astype(np.int64)
    label = np.array([0, 1, 4, 2, 3, 0, 4, 2])[:, None].astype(np.int64)
    clod = [(0, 5, 8)]
    res = exe.run(main, feed={"em": fluid.LoDTensor(emission, lod),
                              "tr": transition,
                              "i": fluid.LoDTensor(inf, clod),
                              "l": fluid.LoDTensor(label, clod)},
                  fetch_list=[path] + list(outs))
    np.testing.assert_array_equal(res[0].data.reshape(-1),
                                  np.concatenate(paths))
    precision, recall, f1, n_inf, n_lab, n_cor = res[1:]
    assert (int(n_inf), int(n_lab), int(n_cor)) == (4, 4, 2)
    assert n_inf.dtype == np.int64 and f1.dtype == np.float32
    np.testing.assert_allclose([precision, recall, f1], 0.5)


def _tagger(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        word = fluid.layers.data(name="word", shape=[1], dtype="int64",
                                 lod_level=1)
        target = fluid.layers.data(name="target", shape=[1], dtype="int64",
                                   lod_level=1)
        emb = fluid.layers.embedding(input=word, size=[10, 4])
        feature = fluid.layers.fc(input=emb, size=5)
        cost = fluid.layers.linear_chain_crf(input=feature, label=target,
                                             param_attr={"name": "crfw"})
        avg = fluid.layers.mean(cost)
        fluid.SGD(learning_rate=0.1).minimize(avg)
        decode = fluid.layers.crf_decoding(input=feature,
                                           param_attr={"name": "crfw"})
        p, r, f1, *_ = fluid.layers.chunk_eval(
            input=decode, label=target, chunk_scheme="IOB",
            num_chunk_types=2)
    return main, startup, [f1, p, r]


def test_get_inference_program_prunes_as_the_jax_package():
    """The eval program is the JAX package's prune of the same Program:
    the same ops and variables.  The decode reads `crfw`, which the
    update writes, so the update and the ops it needs stay (as in
    framework/prune.cc); the ops nothing needed reads go."""
    jm, _, jt = _tagger(jfluid, jfw)
    tm, _, tt = _tagger(tfluid, tfw)
    jp = jfluid.io.get_inference_program(jt, jm)
    tp = tfluid.io.get_inference_program(tt, tm)
    types = [op.type for op in tp.global_block().ops]
    assert types == [op.type for op in jp.global_block().ops]
    assert types[-2:] == ["crf_decoding", "chunk_eval"]
    assert len(types) < len(tm.global_block().ops)
    assert sorted(tp.global_block().vars) == sorted(jp.global_block().vars)
    assert [op.type for op in tm.global_block().ops][-1] == "chunk_eval"


def _loop_program(fluid):
    """A While loop adding y = 2x to `acc`; the loop op lists `acc` as its
    output, and its sub-block reads y."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        y = fluid.layers.scale(x, scale=2.0)
        unused = fluid.layers.scale(x, scale=3.0)
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=2)
        acc = fluid.layers.fill_constant(shape=[1, 2], dtype="float32",
                                         value=0.0)
        cond = fluid.layers.less_than(i, n)
        loop = fluid.layers.While(cond=cond)
        with loop.block():
            fluid.layers.assign(fluid.layers.elementwise_add(acc, y), acc)
            fluid.layers.increment(i, in_place=True)
            fluid.layers.less_than(i, n, cond=cond)
    op = next(o for o in main.global_block().ops if o.type == "while")
    op.outputs["Out"] = [acc.name]
    return main, acc, y, unused


def test_prune_keeps_an_op_with_a_sub_block_whole():
    """An op with a sub-block is kept whole when an output is needed,
    and the names its sub-block reads keep their block-0 producers, as
    the JAX package prunes the same Program; the pruned loop runs."""
    jm, jacc, _, _ = _loop_program(jfluid)
    tm, acc, y, unused = _loop_program(tfluid)
    jp, tp = jfluid.io.prune(jm, [jacc]), tfluid.io.prune(tm, [acc])
    types = [op.type for op in tp.global_block().ops]
    assert types == [op.type for op in jp.global_block().ops]
    assert "while" in types and types.count("scale") == 1
    assert sorted(tp.global_block().vars) == sorted(jp.global_block().vars)
    assert unused.name not in tp.global_block().vars
    assert y.name in tp.global_block().vars
    exe = tfluid.Executor(tfluid.CPUPlace())
    out, = exe.run(tp, feed={"x": np.ones((1, 2), np.float32)},
                   fetch_list=[acc])
    np.testing.assert_array_equal(out, [[4.0, 4.0]])
