"""The port's SelectedRows gradient against the JAX package, on the CPU.

An embedding built with `is_sparse=True` gets a SelectedRows gradient
(`paddle_tpu_torch/core/lod.py`): the flat ids as rows, the output
gradient's rows with padding_idx's zeroed as values, the table's height.
Each piece that makes, takes or passes one is held here to the JAX
package's lowering on the same seeded inputs, duplicate ids and a
padding_idx included: `lookup_table_grad`, `sum` (all sparse, and mixed
with dense), `SelectedRows.to_dense`, `split_selected_rows`, sparse
`sgd`, an L2-decayed sparse gradient, and a table shared by two
lookups.  Where the JAX package raises (gradient clipping of a sparse
gradient) the port raises too, naming the op.

Tolerances (tests/test_torch_training.py): op outputs atol 1e-6, losses
1e-5 relative, parameters atol 1e-5.  Rows are compared by value: the
JAX package's are int32 (x64 is off), the port's int64.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.execution import ExecContext as JExecContext
from paddle_tpu.core.lod import SelectedRows as JSelectedRows

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.execution import ExecContext as TExecContext
from paddle_tpu_torch.core.execution import dense_of
from paddle_tpu_torch.core.lod import SelectedRows, Tensor
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,
                                         scope_to_numpy)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_training import (  # noqa: E402
    _assert_losses_close, _assert_params_close, _assert_same_program,
    _start_both)

OP_ATOL = 1e-6
HEIGHT, DIM = 10, 4
# duplicates (1 three times, 3 twice) and the padding row 2
IDS = np.array([1, 3, 1, 7, 2, 3, 1, 9], np.int64)
PAD = 2


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


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _jlower(op, ins, attrs):
    info = jreg.get_op_info(op)
    return info.lower(JExecContext(), ins, {**info.attrs, **attrs})


def _tlower(op, ins, attrs):
    info = treg.get_op_info(op)
    return info.lower(TExecContext("cpu"), ins, {**info.attrs, **attrs})


def _jsr(rows, value, height):
    return JSelectedRows(jnp.asarray(rows, jnp.int32), jnp.asarray(value),
                         height)


def _tsr(rows, value, height):
    return SelectedRows(torch.as_tensor(np.asarray(rows, np.int64)),
                        torch.as_tensor(np.asarray(value)), height)


def _assert_sr_equal(t, j, atol=OP_ATOL):
    """A port SelectedRows against a JAX one: rows by value, the same
    height, values within atol."""
    assert isinstance(t, SelectedRows) and isinstance(j, JSelectedRows)
    assert t.rows.dtype == torch.int64
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    assert t.height == j.height
    np.testing.assert_allclose(t.value.numpy(), np.asarray(j.value),
                               rtol=0, atol=atol)


# -- the ops -----------------------------------------------------------------

@pytest.mark.parametrize("pad", [-1, PAD])
def test_lookup_table_grad_sparse_matches_jax(pad):
    w = _rand(HEIGHT, DIM)
    og = _rand(len(IDS), 1, DIM, seed=1)
    ids = IDS.reshape(-1, 1)
    attrs = {"is_sparse": True, "padding_idx": pad}
    j = _jlower("lookup_table_grad", {
        "Ids": [jnp.asarray(ids)], "W": [jnp.asarray(w)],
        "Out@GRAD": [jnp.asarray(og)]}, attrs)["W@GRAD"]
    t = _tlower("lookup_table_grad", {
        "Ids": [torch.as_tensor(ids)], "W": [torch.as_tensor(w)],
        "Out@GRAD": [torch.as_tensor(og)]}, attrs)["W@GRAD"]
    _assert_sr_equal(t, j)
    if pad >= 0:
        assert not t.value[torch.as_tensor(IDS) == pad].any()
    # made dense, it is the dense gradient bit for bit
    dense = _tlower("lookup_table_grad", {
        "Ids": [torch.as_tensor(ids)], "W": [torch.as_tensor(w)],
        "Out@GRAD": [torch.as_tensor(og)]},
        {**attrs, "is_sparse": False})["W@GRAD"]
    assert torch.equal(t.to_dense(), dense)


def test_to_dense_sums_duplicates_like_jax():
    value = _rand(len(IDS), DIM)
    t = _tsr(IDS, value, HEIGHT).to_dense()
    j = _jsr(IDS, value, HEIGHT).to_dense()
    assert tuple(t.shape) == (HEIGHT, DIM)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                               atol=OP_ATOL)
    # in the order they occur: row 1 is ((v0 + v2) + v6)
    v = torch.as_tensor(value)
    assert torch.equal(t[1], (v[0] + v[2]) + v[6])
    assert dense_of(t) is t


@pytest.mark.parametrize("kinds", ["ss", "sss", "sd", "dss", "dsd"])
def test_sum_sparse_and_mixed_matches_jax(kinds):
    """All sparse in: a SelectedRows, rows and values concatenated; any
    dense in: the dense sum in input order."""
    tins, jins = [], []
    for i, k in enumerate(kinds):
        if k == "s":
            rows = IDS[i:i + 5]
            value = _rand(len(rows), DIM, seed=i)
            tins.append(_tsr(rows, value, HEIGHT))
            jins.append(_jsr(rows, value, HEIGHT))
        else:
            d = _rand(HEIGHT, DIM, seed=10 + i)
            tins.append(torch.as_tensor(d))
            jins.append(jnp.asarray(d))
    t = _tlower("sum", {"X": tins}, {})["Out"]
    j = _jlower("sum", {"X": jins}, {})["Out"]
    if "d" in kinds:
        assert isinstance(t, torch.Tensor)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=OP_ATOL)
    else:
        _assert_sr_equal(t, j)


@pytest.mark.parametrize("sections", [[4, 6], [3, 3, 4], [10]])
def test_split_selected_rows_matches_jax(sections):
    value = _rand(len(IDS), DIM)
    attrs = {"height_sections": sections}
    t = _tlower("split_selected_rows", {"X": [_tsr(IDS, value, HEIGHT)]},
                attrs)["Out"]
    j = _jlower("split_selected_rows", {"X": [_jsr(IDS, value, HEIGHT)]},
                attrs)["Out"]
    assert len(t) == len(j) == len(sections)
    for a, b in zip(t, j):
        _assert_sr_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_sgd_matches_jax(dtype):
    """Only the named rows move; a duplicate row takes its updates in
    order.  bf16 storage computes in float32 as the JAX package does."""
    p = _rand(HEIGHT, DIM)
    value = _rand(len(IDS), DIM, seed=1)
    lr = np.array([0.1], np.float32)
    tp = torch.as_tensor(p).to(getattr(torch, dtype))
    jp = jnp.asarray(p).astype(dtype)
    t = _tlower("sgd", {"Param": [tp], "Grad": [_tsr(IDS, value, HEIGHT)],
                        "LearningRate": [torch.as_tensor(lr)]},
                {})["ParamOut"]
    j = _jlower("sgd", {"Param": [jp], "Grad": [_jsr(IDS, value, HEIGHT)],
                        "LearningRate": [jnp.asarray(lr)]}, {})["ParamOut"]
    assert t.dtype == tp.dtype
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j).astype(np.float32))
    untouched = sorted(set(range(HEIGHT)) - set(IDS.tolist()))
    assert torch.equal(t[untouched], tp[untouched])


@pytest.mark.parametrize("dim", [1, DIM])
def test_the_cards_ordered_routes_give_the_cpus_bits(dim):
    """The card's routes run on CPU tensors here: the sorted segment sum
    (SelectedRows.to_dense, the dense gradient) and the ordered row
    scatter (sparse sgd) give index_add_'s bits, duplicates and
    untouched rows included."""
    from paddle_tpu_torch.ops.embedding import sorted_segment_sum
    from paddle_tpu_torch.ops.optimizer_ops import ordered_scatter_add_rows

    rows = torch.as_tensor(np.random.RandomState(2).zipf(1.1, 64) % HEIGHT)
    upd = torch.as_tensor(_rand(64, dim, seed=3))
    p = torch.as_tensor(_rand(HEIGHT, dim, seed=4))
    p[0] = -0.0     # a signed zero no id may name keeps its sign
    assert torch.equal(sorted_segment_sum(rows, upd, HEIGHT),
                       torch.zeros(HEIGHT, dim).index_add_(0, rows, upd))
    got = ordered_scatter_add_rows(p, rows, upd)
    assert torch.equal(got, p.index_add(0, rows, upd))
    if 0 not in rows.tolist():
        assert torch.signbit(got[0]).all()


def test_an_op_that_cannot_take_a_selected_rows_names_itself():
    """No silent densify: `scale` of a SelectedRows raises, naming the
    op and the value."""
    block = tfw.Program().global_block()
    for n in ("g", "out"):
        block.create_var(name=n, shape=(HEIGHT, DIM), dtype="float32")
    op = block.append_op("scale", {"X": ["g"]}, {"Out": ["out"]},
                         {"scale": 2.0})
    from paddle_tpu_torch.core.execution import DictEnv, run_op

    env = DictEnv({"g": _tsr(IDS, _rand(len(IDS), DIM), HEIGHT)})
    with pytest.raises(TypeError, match="op 'scale' cannot take the "
                                        "SelectedRows 'g'"):
        run_op(TExecContext("cpu"), op, env)


def test_tensor_container_round_trips():
    t = Tensor()
    assert t.shape() == []
    t.set(np.arange(6, dtype=np.float32).reshape(2, 3), CPUPlace())
    assert t.shape() == [2, 3]
    np.testing.assert_array_equal(np.asarray(t),
                                  np.arange(6).reshape(2, 3))


# -- Programs: regularized, shared and clipped sparse gradients --------------

def _emb_program(fluid, fw, case):
    """An is_sparse embedding (padding_idx 2) -> fc -> mean square
    error, SGD.  `l2`: L2Decay on the table (sum of a SelectedRows and a
    dense decay); `shared`: a second lookup of the same table (the sum
    backward inserts gets two SelectedRows); `clip_*`: gradient
    clipping, which takes no SelectedRows."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        attr = fluid.ParamAttr(name="table")
        emb = fluid.layers.embedding(ids, size=[HEIGHT, DIM],
                                     is_sparse=True, padding_idx=PAD,
                                     param_attr=attr)
        if case == "shared":
            ids2 = fluid.layers.data(name="ids2", shape=[1], dtype="int64")
            emb = fluid.layers.elementwise_add(
                emb, fluid.layers.embedding(ids2, size=[HEIGHT, DIM],
                                            is_sparse=True,
                                            param_attr=attr))
        pred = fluid.layers.fc(input=emb, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        clips = {"clip_value": "GradientClipByValue",
                 "clip_norm": "GradientClipByNorm",
                 "clip_global": "GradientClipByGlobalNorm"}
        if case in clips:
            fluid.clip.set_gradient_clip(getattr(fluid.clip, clips[case])(
                0.1))
        reg = fluid.regularizer.L2Decay(0.05) if case == "l2" else None
        fluid.SGD(learning_rate=0.1, regularization=reg).minimize(loss)
    return main, startup, loss


def _emb_feeds(steps):
    r = np.random.RandomState(0)
    for _ in range(steps):
        yield {"ids": r.randint(0, HEIGHT, (12, 1)).astype(np.int64),
               "ids2": r.randint(0, HEIGHT, (12, 1)).astype(np.int64),
               "y": r.standard_normal((12, 1)).astype(np.float32)}


@pytest.mark.parametrize("case", ["plain", "l2", "shared"])
@pytest.mark.parametrize("compiled", [False, True])
def test_sparse_embedding_trains_like_jax(case, compiled):
    jm, js, jl = _emb_program(jfluid, jfw, case)
    tm, ts, tl = _emb_program(tfluid, tfw, case)
    _assert_same_program(jm, tm)
    _assert_same_program(js, ts)
    # the table's gradient goes through a sum unless plain
    assert any(op.type == "sum" and op.output("Out")[0].startswith(
        "table@GRAD") for op in tm.global_block().ops) == (case != "plain")
    jexe, texe, names = _start_both(jm, js, tm, ts)
    jloss, tloss = [], []
    for feed in _emb_feeds(6):
        if case != "shared":
            feed.pop("ids2")
        jloss.append(jexe.run(jm, feed=feed, fetch_list=[jl],
                              compiled=compiled)[0][0])
        tloss.append(texe.run(tm, feed=feed, fetch_list=[tl],
                              compiled=compiled)[0][0])
    _assert_losses_close(jloss, tloss)
    assert tloss[-1] < tloss[0]
    _assert_params_close(names)
    # the padding row's gradient is zero: unregularized, it never moves
    if case == "plain":
        init = np.asarray(jexecutor.global_scope().find_var("table"))
        assert np.array_equal(
            tfluid.global_scope().find_var("table")[PAD].numpy(),
            init[PAD])


def test_shared_table_gradient_is_one_selected_rows():
    """The sum backward inserts for a shared table takes two
    SelectedRows and gives one, fetched as numpy rows and values in
    both modes.  Backward visits the second lookup first, so its rows
    come first."""
    tm, ts, tl = _emb_program(tfluid, tfw, "shared")
    sums = [op for op in tm.global_block().ops if op.type == "sum"
            and op.output("Out")[0].startswith("table@GRAD")]
    assert len(sums) == 1 and len(sums[0].input("X")) == 2
    total = sums[0].output("Out")[0]
    exe = tfluid.Executor(CPUPlace())
    exe.run(ts)
    names = [v.name for v in tm.list_vars() if v.persistable]
    init = scope_to_numpy(tfluid.global_scope(), names)
    feed = next(_emb_feeds(1))
    got = []
    for compiled in (False, True):     # each from the startup's state
        scope_from_numpy(init, CPUPlace(), tfluid.global_scope())
        got.append(exe.run(tm, feed=feed, fetch_list=[total],
                           compiled=compiled)[0])
    for g in got:
        assert isinstance(g, SelectedRows)
        assert isinstance(g.rows, np.ndarray)
        assert isinstance(g.value, np.ndarray)
        np.testing.assert_array_equal(
            g.rows, np.concatenate([feed["ids2"], feed["ids"]]).ravel())
        assert g.value.shape == (24, DIM) and g.height == HEIGHT
    np.testing.assert_array_equal(got[0].value, got[1].value)


@pytest.mark.parametrize("case", ["clip_value", "clip_norm",
                                  "clip_global"])
def test_clipping_a_sparse_gradient_raises_as_in_jax(case):
    """The JAX package's clip ops take no SelectedRows (jnp raises a
    TypeError); the port's raise a TypeError naming the op."""
    jm, js, jl = _emb_program(jfluid, jfw, case)
    tm, ts, tl = _emb_program(tfluid, tfw, case)
    _assert_same_program(jm, tm)
    feed = next(_emb_feeds(1))
    feed.pop("ids2")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js)
    with pytest.raises(TypeError):
        jexe.run(jm, feed=feed, fetch_list=[jl])
    texe = tfluid.Executor(CPUPlace())
    texe.run(ts)
    op = {"clip_value": "clip", "clip_norm": "clip_by_norm",
          "clip_global": "square"}[case]
    with pytest.raises(TypeError, match=f"op '{op}' cannot take the "
                                        "SelectedRows 'table@GRAD'"):
        texe.run(tm, feed=feed, fetch_list=[tl])


def test_a_sparse_gradient_under_data_parallelism_raises_as_in_jax():
    """The JAX package's bucketed dp step cannot ravel a SelectedRows (a
    TypeError); the port's raises a TypeError naming that rule: the
    bucketed step takes dense gradients only."""
    def build(fluid, fw):
        fw.reset_unique_names()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            emb = fluid.layers.embedding(ids, size=[HEIGHT, DIM],
                                         is_sparse=True)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(
                fluid.layers.fc(emb, 1), y))
            fluid.SGD(learning_rate=0.1).minimize(loss)
        t = fluid.ShardingTranspiler()
        t.transpile(program=main, startup_program=startup, mesh={"dp": 1},
                    overlap="bucketed", shard_optimizer_states=False)
        return startup, loss, t

    feed = {"ids": IDS.reshape(-1, 1), "y": np.ones((len(IDS), 1),
                                                   np.float32)}
    startup, loss, t = build(jfluid, jfw)
    jfluid.Executor(jfluid.CPUPlace()).run(startup)
    with pytest.raises(TypeError):
        t.build_executor(["ids", "y"], [loss]).run(feed)
    startup, loss, t = build(tfluid, tfw)
    tfluid.Executor(CPUPlace()).run(startup)
    pe = t.build_executor(["ids", "y"], [loss], place=CPUPlace())
    with pytest.raises(TypeError, match="SelectedRows.*dense gradients "
                                        "only, as the JAX package's"):
        pe.run(feed)


# -- a sparse gradient across a host op between device segments ---------------

def test_capture_buffers_hold_a_selected_rows_as_two_buffers():
    """A SelectedRows input of a captured segment (a sparse gradient that
    crossed a host op) is held as two buffers, its rows and its values:
    a view is cloned into a buffer of its own, a replay copies a new
    value's rows and values into them (and rebinds the name), and the
    buffers themselves pass without a copy.  Before, the capture refused
    it with a TypeError, on the card only."""
    from paddle_tpu_torch.core.executor import _copy_inputs, _input_buffers

    ids = torch.tensor([9, 1, 3, 1])
    sr = SelectedRows(ids[1:], torch.ones(3, DIM), HEIGHT)
    dense = torch.zeros(2, DIM)
    bufs, lods, sparse, rebind = _input_buffers({"g": sr, "x": dense}, "t")
    assert set(bufs) == {"x"} and bufs["x"] is dense and set(sparse) == {"g"}
    held = sparse["g"]
    assert held.value is sr.value and held.height == HEIGHT
    assert held.rows is not sr.rows and torch.equal(held.rows, sr.rows)
    assert rebind == {"g": held}
    new = SelectedRows(torch.tensor([4, 5, 6]), torch.full((3, DIM), 2.0),
                       HEIGHT)
    got = _copy_inputs({"g": new, "x": dense}, bufs, lods, sparse)
    assert got == {"g": held}
    assert torch.equal(held.rows, new.rows)
    assert torch.equal(held.value, new.value)
    assert _copy_inputs({"g": held, "x": dense}, bufs, lods, sparse) == {}
    with pytest.raises(TypeError, match="not a tensor"):
        _input_buffers({"a": object()}, "t")


@pytest.mark.parametrize("compiled", [None, False],
                         ids=["default", "interpreted"])
def test_sparse_gradient_across_a_host_op_trains_like_jax(compiled):
    """tools/torch_tree_probe.py's sparse-host program (an is_sparse
    embedding whose gradient reaches its sgd across a `print` of the
    loss): three steps in both packages, from the JAX startup's values,
    in the port's default (segmented) mode and interpreted."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from torch_tree_probe import sparse_host_feeds, sparse_host_program

    jfw.reset_unique_names()
    jm, js, jl = sparse_host_program(jfluid)
    tfw.reset_unique_names()
    tm, ts, tl = sparse_host_program(tfluid)
    _assert_same_program(jm, tm)
    types = [op.type for op in tm.global_block().ops]
    assert types.index("lookup_table_grad") < types.index("print") \
        < types.index("sgd")
    jexe, texe, names = _start_both(jm, js, tm, ts)
    feeds = sparse_host_feeds()
    jl_ = [float(np.asarray(jexe.run(jm, feed=f, fetch_list=[jl])[0])[0])
           for f in feeds]
    tl_ = [float(texe.run(tm, feed=f, fetch_list=[tl],
                          compiled=compiled)[0][0]) for f in feeds]
    _assert_losses_close(jl_, tl_)
    _assert_params_close(names)
