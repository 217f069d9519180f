"""Persistence in the port against the JAX package, on the CPU: the io
ops (save, load, save_combine, load_combine, feed, fetch), `io`'s
save/load of variables and of inference models, `Parameters`' tar, and
the checkpoints.

Tensor files: the two packages write the same bytes for float32, int32,
bfloat16 and LoD values, one file a variable and combined, and each
reads the other's.  Models cross in both directions: a Program trained
and saved by one package (`save_persistables`, `save_inference_model`)
is loaded by the other, whose inference outputs must be the saver's
within 1e-6 (float32, the same ops on the same values; the two
libraries' GEMMs round alike at these widths, atol 1e-6).  The
inference-model round trips are the book tests' own
(tests/book/test_recognize_digits.py:78, test_fit_a_line.py:59-66,
test_word2vec.py:58), the models built by the same code in each
package.
"""
import io as pyio
import json
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import io as jio
from paddle_tpu.core import executor as jexecutor
from paddle_tpu.core.lod import LoDTensor as JLoDTensor
from paddle_tpu.ops import io_ops as jio_ops
from paddle_tpu.parameters import Parameters as JParameters

import paddle_tpu_torch as tfluid
import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.lod import LoDTensor
from paddle_tpu_torch.core.resilience import fault_injector
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
from paddle_tpu_torch.ops import io_ops as tio_ops
from paddle_tpu_torch.parameters import Parameters

RTOL, ATOL = 1e-6, 1e-6
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    old_scope = texecutor.switch_scope(Scope())
    old_jscope = jexecutor.switch_scope(jfluid.Scope())
    tfw.reset_unique_names()
    jfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    texecutor.switch_scope(old_scope)
    jexecutor.switch_scope(old_jscope)
    tflags.reset_flags()
    fault_injector().clear()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# -- tensor files ------------------------------------------------------------

_R = np.random.RandomState(7)
_F32 = _R.standard_normal((3, 5)).astype(np.float32)
_I32 = _R.randint(-9, 9, (4, 2)).astype(np.int32)
_BF16 = _R.standard_normal((2, 7)).astype(np.float32).astype(
    ml_dtypes.bfloat16)
_SCALAR = np.asarray(0.25, np.float32)
_LOD = (_R.standard_normal((5, 3)).astype(np.float32), [[0, 2, 5]])
_LOD2 = (_R.randint(0, 9, (6, 1)).astype(np.int32), [[0, 1, 3], [0, 2, 3,
                                                                 6]])


def _jax_value(v):
    if isinstance(v, tuple):
        return JLoDTensor(jnp.asarray(v[0]), v[1])
    return jnp.asarray(v)


def _port_value(v):
    if isinstance(v, tuple):
        return LoDTensor(_port_value(v[0]), v[1])
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(v.copy())


VALUES = {"float32": _F32, "int32": _I32, "bfloat16": _BF16,
          "scalar": _SCALAR, "lod": _LOD, "lod2_int": _LOD2}


@pytest.mark.parametrize("kind", sorted(VALUES))
def test_tensor_files_are_the_jax_packages_bytes(kind, tmp_path):
    """One value, written by each package's `save` file writer: the same
    bytes; and each package reads the other's file to the same values
    and LoD (a 0-d value as shape [1]: the JAX package's
    `np.ascontiguousarray` writes it so, and the port follows)."""
    v = VALUES[kind]
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jio_ops.save_tensor_to_file(jpath, _jax_value(v))
    tio_ops.save_tensor_to_file(tpath, _port_value(v))
    assert _read(jpath) == _read(tpath)
    got = tio_ops.load_tensor_from_file(jpath)
    want = _port_value(v)
    if isinstance(want, LoDTensor):
        assert isinstance(got, LoDTensor) and got.lod == want.lod
        got, want = got.data, want.data
    want = want.reshape(1) if want.dim() == 0 else want
    assert got.dtype == want.dtype and torch.equal(got, want)
    back = jio_ops.load_tensor_from_file(tpath)
    arr = back.data if isinstance(back, JLoDTensor) else back
    np.testing.assert_array_equal(
        np.asarray(arr).view(np.uint16) if kind == "bfloat16"
        else np.asarray(arr), (v[0] if isinstance(v, tuple) else v).view(
            np.uint16) if kind == "bfloat16"
        else (v[0] if isinstance(v, tuple) else v))


def _save_program(fluid, names, op, dirname, filename=None):
    return fluid.io._build_save_load_program(op, names, dirname, filename)


def test_save_combine_file_is_the_jax_packages_and_loads_by_name(tmp_path):
    """save_combine run by each Executor over the same four variables
    (float32, int32, bf16, LoD): the same bytes.  load_combine takes
    each output by its name in the file, so a reordered output list
    still gets its own values; with names missing, by position."""
    names = ["a", "b", "c", "d"]
    vals = [_F32, _I32, _BF16, _LOD]
    jscope = jfluid.Scope()
    for n, v in zip(names, vals):
        jscope.set_var(n, _jax_value(v))
    tscope = Scope()
    for n, v in zip(names, vals):
        tscope.set_var(n, _port_value(v))
    jfluid.Executor(jfluid.CPUPlace()).run(
        _save_program(jfluid, names, "save", str(tmp_path / "j"), "all"),
        scope=jscope)
    exe = tfluid.Executor(CPU)
    exe.run(_save_program(tfluid, names, "save", str(tmp_path / "t"),
                          "all"), scope=tscope)
    assert _read(str(tmp_path / "j" / "all")) == \
        _read(str(tmp_path / "t" / "all"))
    loaded = Scope()
    exe.run(_save_program(tfluid, ["d", "a", "c", "b"], "load",
                          str(tmp_path / "j"), "all"), scope=loaded)
    for n in names:
        a, b = loaded.find_var(n), tscope.find_var(n)
        if isinstance(b, LoDTensor):
            assert a.lod == b.lod
            a, b = a.data, b.data
        assert a.dtype == b.dtype and torch.equal(a, b), n
    by_pos = Scope()
    exe.run(_save_program(tfluid, ["x", "y"], "load", str(tmp_path / "j"),
                          "all"), scope=by_pos)
    assert torch.equal(by_pos.find_var("x"), tscope.find_var("a"))
    assert torch.equal(by_pos.find_var("y"), tscope.find_var("b"))


def test_save_refuses_overwrite_and_an_uninitialized_variable(tmp_path):
    exe = tfluid.Executor(CPU)
    scope = Scope()
    scope.set_var("w", torch.ones(2))
    path = str(tmp_path / "w")
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name="w", dtype=None, persistable=True)
    blk.append_op("save", inputs={"X": ["w"]},
                  attrs={"file_path": path, "overwrite": False})
    exe.run(prog, scope=scope)
    with pytest.raises(IOError, match="overwrite"):
        exe.run(prog, scope=scope)
    with pytest.raises(RuntimeError, match="no value"):
        tio.save_vars(exe, str(tmp_path / "x"), vars=["missing"],
                      scope=scope)


def test_feed_and_fetch_ops_pass_values_and_lods():
    from paddle_tpu_torch.core.execution import ExecContext
    from paddle_tpu_torch.core.registry import get_op_info

    v = LoDTensor(torch.arange(6.0).reshape(3, 2), [[0, 1, 3]])
    out = get_op_info("feed").lower(ExecContext("cpu"),
                                    {"X": [[torch.ones(1), v]]}, {"col": 1})
    assert out["Out"] is v
    assert get_op_info("fetch").lower(ExecContext("cpu"), {"X": [v]},
                                      {})["Out"] is v
    for op in ("feed", "fetch", "save", "load", "save_combine",
               "load_combine"):
        assert get_op_info(op).host


def test_load_keeps_the_files_dtype_a_jax_int64_arriving_as_int32(
        tmp_path):
    """The JAX package runs without x64, so its int64 variable is saved
    as int32; the port's load keeps the file's dtype (values match)."""
    jscope = jfluid.Scope()
    jscope.set_var("ids", jnp.asarray(np.arange(5, dtype=np.int64)))
    jfluid.Executor(jfluid.CPUPlace()).run(
        _save_program(jfluid, ["ids"], "save", str(tmp_path), None),
        scope=jscope)
    scope = Scope()
    tfluid.Executor(CPU).run(
        _save_program(tfluid, ["ids"], "load", str(tmp_path), None),
        scope=scope)
    got = scope.find_var("ids")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.arange(5))


# -- models across the two packages -----------------------------------------

def _mlp_program(fluid, fw):
    """A small classifier with Adam (so persistables include both
    moments, the beta-pow accumulators and the learning rate)."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            input=pred, label=y))
        fluid.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, pred, loss


def _mlp_feeds(n, seed):
    r = np.random.RandomState(seed)
    return [{"x": r.standard_normal((8, 6)).astype(np.float32),
             "y": r.randint(0, 4, (8, 1)).astype(np.int64)}
            for _ in range(n)]


def _train_jax(steps=3):
    main, startup, pred, loss = _mlp_program(jfluid, jfw)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    for feed in _mlp_feeds(steps, 0):
        exe.run(main, feed=feed, fetch_list=[loss])
    return exe, main, pred


def _train_port(steps=3):
    main, startup, pred, loss = _mlp_program(tfluid, tfw)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    for feed in _mlp_feeds(steps, 0):
        exe.run(main, feed=feed, fetch_list=[loss])
    return exe, main, pred


def _infer_feed():
    return {"x": np.random.RandomState(9).standard_normal(
        (5, 6)).astype(np.float32)}


@pytest.mark.parametrize("filename", [None, "params"])
def test_jax_save_persistables_loads_into_the_port(filename, tmp_path):
    """A checkpoint written by paddle_tpu.io.save_persistables loads into
    the port (one file a variable, or combined) and gives the JAX
    package's inference outputs; every persistable is the JAX value."""
    jexe, jmain, jpred = _train_jax()
    jio.save_persistables(jexe, str(tmp_path), jmain, filename=filename)
    want = jexe.run(jio.get_inference_program([jpred], jmain),
                    feed=_infer_feed(), fetch_list=[jpred.name])[0]
    tmain, tstartup, tpred, _ = _mlp_program(tfluid, tfw)
    exe = tfluid.Executor(CPU)
    names = tio.load_persistables(exe, str(tmp_path), tmain,
                                  filename=filename)
    assert names == sorted(v.name for v in jmain.list_vars()
                           if v.persistable)
    for n in names:
        np.testing.assert_array_equal(
            tfluid.global_scope().find_var(n).numpy(),
            np.asarray(jexecutor.global_scope().find_var(n)), err_msg=n)
    got = exe.run(tio.get_inference_program([tpred], tmain),
                  feed=_infer_feed(), fetch_list=[tpred.name])[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("filename", [None, "params"])
def test_port_save_persistables_loads_into_the_jax_package(filename,
                                                           tmp_path):
    """The reverse direction: the port trains and saves; the JAX package
    loads and infers the port's outputs."""
    texe, tmain, tpred = _train_port()
    tio.save_persistables(texe, str(tmp_path), tmain, filename=filename)
    want = texe.run(tio.get_inference_program([tpred], tmain),
                    feed=_infer_feed(), fetch_list=[tpred.name])[0]
    jmain, _, jpred, _ = _mlp_program(jfluid, jfw)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jio.load_persistables(jexe, str(tmp_path), jmain, filename=filename)
    got = jexe.run(jio.get_inference_program([jpred], jmain),
                   feed=_infer_feed(), fetch_list=[jpred.name])[0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def _digits(fluid, fw):
    """tests/book/test_recognize_digits.py:78's conv model."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("digits", os.path.join(
        os.path.dirname(__file__), "book", "test_recognize_digits.py"))
    book = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(book)
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28],
                                dtype="float32")
        c1 = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act="relu")
        c2 = fluid.nets.simple_img_conv_pool(
            input=c1, filter_size=5, num_filters=16, pool_size=2,
            pool_stride=2, act="relu")
        pred = fluid.layers.fc(input=c2, size=book.CLS, act="softmax")
    x, _ = book._make_data(np.random.RandomState(1), n=4, conv=True)
    return main, startup, ["img"], pred, {"img": x}


def _fit_a_line(fluid, fw):
    """tests/book/test_fit_a_line.py:59-66's regression."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, act=None)
    r = np.random.RandomState(0)
    return main, startup, ["x"], pred, {
        "x": r.randn(16, 13).astype(np.float32)}


def _word2vec(fluid, fw):
    """tests/book/test_word2vec.py:58's embedding model."""
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
                 for i in range(4)]
        embeds = [fluid.layers.embedding(input=w, size=[32, 16],
                                         param_attr={"name": "shared_w2"})
                  for w in words]
        concat = fluid.layers.concat(input=embeds, axis=1)
        hidden = fluid.layers.fc(input=concat, size=32, act="sigmoid")
        pred = fluid.layers.fc(input=hidden, size=32, act="softmax")
    r = np.random.RandomState(2)
    return main, startup, [f"w{i}" for i in range(4)], pred, {
        f"w{i}": r.randint(0, 32, (6, 1)).astype(np.int64)
        for i in range(4)}


BOOKS = {"book02_recognize_digits": _digits, "book01_fit_a_line": _fit_a_line,
         "book04_word2vec": _word2vec}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("book", sorted(BOOKS))
def test_inference_model_round_trip_across_packages(book, direction,
                                                    tmp_path):
    """save_inference_model in one package, load_inference_model in the
    other: the same feed and fetch names, and the saver's outputs."""
    build = BOOKS[book]
    d = str(tmp_path / "model")
    if direction == "jax_to_port":
        main, startup, feeds, pred, feed = build(jfluid, jfw)
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        want = np.asarray(exe.run(main, feed=feed, fetch_list=[pred])[0])
        jio.save_inference_model(d, feeds, [pred], exe, main_program=main)
        lexe, scope = tfluid.Executor(CPU), Scope()
        prog, lfeeds, fetches = tio.load_inference_model(d, lexe,
                                                         scope=scope)
    else:
        main, startup, feeds, pred, feed = build(tfluid, tfw)
        exe = tfluid.Executor(CPU)
        exe.run(startup)
        want = exe.run(main, feed=feed, fetch_list=[pred])[0]
        tio.save_inference_model(d, feeds, [pred], exe, main_program=main)
        lexe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        prog, lfeeds, fetches = jio.load_inference_model(d, lexe,
                                                         scope=scope)
    assert lfeeds == feeds and fetches == [pred.name]
    got = np.asarray(lexe.run(prog, feed=feed, fetch_list=fetches,
                              scope=scope)[0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_inference_model_in_the_port_round_trips_with_both_layouts(
        tmp_path):
    """The port alone: one file a variable and params_filename, loaded
    into a fresh scope, give the in-memory test program's outputs bit
    for bit; a loaded model's variables are on the executor's place."""
    main, startup, feeds, pred, feed = _digits(tfluid, tfw)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    want = exe.run(main.clone(for_test=True), feed=feed,
                   fetch_list=[pred])[0]
    for params_filename in (None, "__params__"):
        d = str(tmp_path / str(params_filename))
        tio.save_inference_model(d, feeds, [pred], exe, main_program=main,
                                 params_filename=params_filename)
        files = set(os.listdir(d))
        assert tio.MODEL_FILENAME in files
        if params_filename:
            assert files == {tio.MODEL_FILENAME, params_filename}
        scope = Scope()
        prog, _, fetches = tio.load_inference_model(
            d, exe, params_filename=params_filename, scope=scope)
        got = exe.run(prog, feed=feed, fetch_list=fetches, scope=scope)[0]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["warn", "error"])
def test_verification_of_a_loaded_model_raises_naming_a12(mode, tmp_path):
    main, startup, feeds, pred, _ = _fit_a_line(tfluid, tfw)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    tio.save_inference_model(str(tmp_path), feeds, [pred], exe,
                             main_program=main)
    tflags.set_flags({"verify": mode})
    with pytest.raises(NotImplementedError, match="A12"):
        tio.load_inference_model(str(tmp_path), exe, scope=Scope())


def test_aot_export_raises_naming_a10b(tmp_path):
    with pytest.raises(NotImplementedError, match="A10b"):
        tio.export_aot_model(str(tmp_path), {}, [], None)
    with pytest.raises(NotImplementedError, match="A10b"):
        tio.load_aot_model(str(tmp_path))


def test_entry_points_default_to_the_card():
    """With no place, the Executor a user builds for io is CUDAPlace(0),
    which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor()


# -- Parameters --------------------------------------------------------------

def _param_program(fluid, fw):
    fw.reset_unique_names()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        fluid.layers.fc(input=x, size=2)
    blk = main.global_block()
    blk.create_parameter("bf16_w", [2, 3], "bfloat16")
    return main


def _jax_params():
    main = _param_program(jfluid, jfw)
    r = np.random.RandomState(3)
    scope = jfluid.Scope()
    vals = {"fc_0.w_0": r.standard_normal((3, 2)).astype(np.float32),
            "fc_0.b_0": r.standard_normal((2,)).astype(np.float32),
            "bf16_w": r.standard_normal((2, 3)).astype(np.float32).astype(
                ml_dtypes.bfloat16)}
    for n, v in vals.items():
        scope.set_var(n, jnp.asarray(v))
    return JParameters(main, scope), vals


def test_a_jax_parameters_tar_reads_into_the_port_and_writes_back_the_same_bytes():
    """The JAX package's tar (np.save of a bf16 array records the raw
    2-byte type `<V2`; meta.json says bfloat16) read by `from_tar` and
    `init_from_tar`: the same values, bf16 kept; the port's `to_tar` of
    them is the JAX tar, byte for byte."""
    jparams, vals = _jax_params()
    jbuf = pyio.BytesIO()
    jparams.to_tar(jbuf)
    p = Parameters.from_tar(pyio.BytesIO(jbuf.getvalue()))
    assert p.names() == sorted(vals)
    t = p._tensor("bf16_w")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(
        np.uint16), vals["bf16_w"].view(np.uint16))
    np.testing.assert_array_equal(p.get("fc_0.w_0"), vals["fc_0.w_0"])
    tbuf = pyio.BytesIO()
    p.to_tar(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()

    main = _param_program(tfluid, tfw)
    scope = Scope()
    scope_from_numpy({"fc_0.w_0": np.zeros((3, 2), np.float32),
                      "fc_0.b_0": np.zeros(2, np.float32)}, CPU, scope)
    scope.set_var("bf16_w", torch.zeros(2, 3, dtype=torch.bfloat16))
    live = Parameters(main, scope)
    live.init_from_tar(pyio.BytesIO(jbuf.getvalue()))
    assert torch.equal(scope.find_var("bf16_w"), t)
    np.testing.assert_array_equal(live["fc_0.b_0"], vals["fc_0.b_0"])
    # and the JAX package reads the port's tar back
    back = JParameters.from_tar(pyio.BytesIO(tbuf.getvalue()))
    np.testing.assert_array_equal(back.get("fc_0.w_0"), vals["fc_0.w_0"])


def test_parameters_set_checks_names_and_shapes_and_keeps_the_dtype():
    main = _param_program(tfluid, tfw)
    scope = Scope()
    scope.set_var("fc_0.w_0", torch.zeros(3, 2))
    p = Parameters(main, scope)
    assert len(p) == 3 and "fc_0.b_0" in p and p.get_shape("bf16_w") == (2,
                                                                         3)
    p["fc_0.w_0"] = np.ones((3, 2), np.float64)
    assert scope.find_var("fc_0.w_0").dtype == torch.float32
    with pytest.raises(ValueError, match="shape"):
        p.set("fc_0.w_0", np.ones((2, 3)))
    with pytest.raises(KeyError):
        p.set("nope", np.ones(1))
    with pytest.raises(KeyError, match="startup"):
        p.get("fc_0.b_0")


# -- checkpoints -------------------------------------------------------------

def _linear():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(input=x, size=1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            input=pred, label=y))
        tfluid.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(startup)
    return exe, main


def test_checkpoint_meta_latest_pointer_and_md5_fallback(tmp_path):
    exe, main = _linear()
    d = str(tmp_path)
    first = tio.save_checkpoint(exe, d, main, trainer_args={"step": 1})
    second = tio.save_checkpoint(exe, d, main, trainer_args={"step": 2})
    with open(os.path.join(d, tio.LATEST_FILENAME)) as f:
        assert f.read() == second
    cp, meta = tio.latest_checkpoint(d)
    assert meta["uuid"] == second and meta["trainer_args"] == {"step": 2}
    assert set(meta) == {"uuid", "md5", "timestamp", "trainer_args"}
    assert meta["md5"] == tio._md5_of_dir(cp)
    # the pointer wins over timestamps
    with open(os.path.join(d, tio.LATEST_FILENAME), "w") as f:
        f.write(first)
    assert tio.latest_checkpoint(d)[1]["uuid"] == first
    # a corrupt snapshot is skipped with a RuntimeWarning
    victim = os.path.join(d, f"checkpoint_{first}", "fc_0.w_0")
    with open(victim, "ab") as f:
        f.write(b"bitrot")
    with pytest.warns(RuntimeWarning, match="md5"):
        meta = tio.load_checkpoint(exe, d, main)
    assert meta["uuid"] == second


def test_checkpoint_gc_keeps_the_newest_and_young_incomplete_snapshots(
        tmp_path):
    exe, main = _linear()
    d = str(tmp_path)
    young = os.path.join(d, "checkpoint_young")
    old = os.path.join(d, "checkpoint_old")
    for p in (young, old):
        os.makedirs(p)
    stale = time.time() - tio._GC_INCOMPLETE_GRACE_S - 60
    os.utime(old, (stale, stale))
    uuids = [tio.save_checkpoint(exe, d, main, max_keep=2)
             for _ in range(3)]
    left = set(os.listdir(d))
    assert f"checkpoint_{uuids[0]}" not in left
    assert {f"checkpoint_{u}" for u in uuids[1:]} <= left
    assert "checkpoint_young" in left and "checkpoint_old" not in left
    with pytest.raises(ValueError):
        tio.save_checkpoint(exe, d, main, max_keep=-1)


def test_checkpoint_save_fault_site_and_telemetry(tmp_path):
    from paddle_tpu_torch.observability import metrics, tracing

    exe, main = _linear()
    fault_injector().inject("checkpoint.save", "error", nth=1,
                            exc=OSError("disk gone"))
    with pytest.raises(OSError, match="disk gone"):
        tio.save_checkpoint(exe, str(tmp_path), main)
    assert tio.latest_checkpoint(str(tmp_path)) == (None, None)
    fault_injector().clear()
    tracing.set_enabled(True)
    tflags.set_flags({"metrics": True})
    try:
        tracing.clear()
        h = metrics.histogram("paddle_tpu_checkpoint_load_seconds")
        n = h.count
        tio.save_checkpoint(exe, str(tmp_path), main)
        assert tio.load_checkpoint(exe, str(tmp_path), main) is not None
        names = {s["name"] for s in tracing.finished_spans()}
        assert {"checkpoint.save", "checkpoint.load"} <= names
        assert h.count == n + 1
    finally:
        tracing.set_enabled(False)
        tracing.clear()


def test_a_jax_checkpoint_directory_resumes_in_the_port(tmp_path):
    """paddle_tpu.io.save_checkpoint's snapshot (meta, md5, pointer)
    passes the port's verification and loads the JAX values."""
    jexe, jmain, _ = _train_jax()
    jio.save_checkpoint(jexe, str(tmp_path), jmain,
                        trainer_args={"step": 3})
    tmain, _, _, _ = _mlp_program(tfluid, tfw)
    meta = tio.load_checkpoint(tfluid.Executor(CPU), str(tmp_path), tmain)
    assert meta["trainer_args"] == {"step": 3}
    for v in jmain.list_vars():
        if v.persistable:
            np.testing.assert_array_equal(
                tfluid.global_scope().find_var(v.name).numpy(),
                np.asarray(jexecutor.global_scope().find_var(v.name)))
    with open(os.path.join(str(tmp_path), jio.LATEST_FILENAME)) as f:
        assert json.load(open(os.path.join(
            str(tmp_path), f"checkpoint_{f.read()}",
            jio.META_FILENAME)))["md5"] == meta["md5"]
