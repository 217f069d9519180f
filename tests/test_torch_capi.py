"""The port's C inference ABI (native/src/capi.cc + capi_runtime.py)
held to the JAX package's.

Both libraries export the same six extern-C functions, so one ctypes
binding drives either.  A model the JAX package saved runs through the
JAX package's `_capi.so` (its session on the CPU by default) and the
port's (`PADDLE_TPU_CAPI_PLACE=cpu`; the port's session runs on the
card by default): the outputs agree within 1e-6 and with the JAX
Executor's, and a bad model directory is reported the same way by both.
The port's library also drives a standalone C host (src/capi_host.c,
linked with gcc) where the interpreter has a shared libpython.
"""
import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

import paddle_tpu as jfluid

from paddle_tpu_torch import capi_runtime, native
from paddle_tpu_torch.core.executor import CPUPlace, CUDAPlace

JAX_SO = os.path.join(os.path.dirname(jfluid.__file__), "native",
                      "_capi.so")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_sessions(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CAPI_PLACE", "cpu")


def _jax_so():
    if not os.path.exists(JAX_SO):
        subprocess.run(["make", "_capi.so"], check=True,
                       cwd=os.path.dirname(JAX_SO))
    return JAX_SO


def _bind(path):
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    lib.paddle_tpu_inference_create.restype = i64
    lib.paddle_tpu_inference_create.argtypes = [ctypes.c_char_p]
    lib.paddle_tpu_inference_feed.restype = ctypes.c_int
    lib.paddle_tpu_inference_feed.argtypes = [
        i64, ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(i64),
        ctypes.c_int, ctypes.c_int]
    lib.paddle_tpu_inference_run.restype = ctypes.c_int
    lib.paddle_tpu_inference_run.argtypes = [i64]
    lib.paddle_tpu_inference_fetch.restype = i64
    lib.paddle_tpu_inference_fetch.argtypes = [
        i64, ctypes.c_int, ctypes.POINTER(ctypes.c_float), i64,
        ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int)]
    lib.paddle_tpu_inference_destroy.restype = ctypes.c_int
    lib.paddle_tpu_inference_destroy.argtypes = [i64]
    lib.paddle_tpu_last_error.restype = ctypes.c_char_p
    return lib


def _save_jax_model(dirname):
    """The JAX package's tiny classifier, saved as an inference model ->
    (main, scope, out) for its own Executor's reference."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="x", shape=[4], dtype="float32")
        hidden = jfluid.layers.fc(input=x, size=8, act="relu")
        out = jfluid.layers.fc(input=hidden, size=3, act="softmax")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    jfluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                   main_program=main, scope=scope)
    return main, scope, out


def _infer(lib, model_dir, x):
    sid = lib.paddle_tpu_inference_create(model_dir.encode())
    assert sid > 0, lib.paddle_tpu_last_error().decode()
    dims = (ctypes.c_int64 * x.ndim)(*x.shape)
    rc = lib.paddle_tpu_inference_feed(
        sid, b"x", x.ctypes.data_as(ctypes.c_void_p), dims, x.ndim, 0)
    assert rc == 0, lib.paddle_tpu_last_error().decode()
    assert lib.paddle_tpu_inference_run(sid) == 1, \
        lib.paddle_tpu_last_error().decode()
    buf = (ctypes.c_float * 64)()
    odims = (ctypes.c_int64 * 8)()
    ondim = ctypes.c_int()
    count = lib.paddle_tpu_inference_fetch(sid, 0, buf, 64, odims,
                                           ctypes.byref(ondim))
    assert count > 0, lib.paddle_tpu_last_error().decode()
    shape = list(odims[:ondim.value])
    out = np.ctypeslib.as_array(buf)[:count].reshape(shape).copy()
    assert lib.paddle_tpu_inference_destroy(sid) == 0
    return out


def test_both_c_abis_run_a_model_the_jax_package_saved(tmp_path,
                                                       cpu_sessions):
    model_dir = str(tmp_path / "model")
    main, scope, out = _save_jax_model(model_dir)
    x = np.random.RandomState(7).rand(2, 4).astype(np.float32)
    want = np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[out], scope=scope)[0])
    got_jax = _infer(_bind(_jax_so()), model_dir, x)
    got_port = _infer(_bind(native.capi_library()), model_dir, x)
    assert got_port.shape == got_jax.shape == (2, 3)
    np.testing.assert_allclose(got_port, got_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_port, want, rtol=0, atol=1e-6)
    assert not capi_runtime._sessions   # destroyed sessions leave it


def test_error_reporting_matches_the_jax_packages(tmp_path, cpu_sessions):
    missing = str(tmp_path / "does_not_exist").encode()
    msgs = []
    for path in (_jax_so(), native.capi_library()):
        lib = _bind(path)
        assert lib.paddle_tpu_inference_create(missing) == 0
        msgs.append(lib.paddle_tpu_last_error().decode())
    assert msgs[0] and msgs[0] == msgs[1]
    # a run with a feed missing: both name it
    model_dir = str(tmp_path / "model")
    _save_jax_model(model_dir)
    msgs = []
    for path in (_jax_so(), native.capi_library()):
        lib = _bind(path)
        sid = lib.paddle_tpu_inference_create(model_dir.encode())
        assert sid > 0
        assert lib.paddle_tpu_inference_run(sid) == -1
        msgs.append(lib.paddle_tpu_last_error().decode())
        assert lib.paddle_tpu_inference_destroy(sid) == 0
    assert msgs[0] == msgs[1] == "missing feeds: ['x']"


def test_session_place_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CAPI_PLACE", raising=False)
    assert capi_runtime.capi_place() == CUDAPlace(0)
    monkeypatch.setenv("PADDLE_TPU_CAPI_PLACE", "cpu")
    assert capi_runtime.capi_place() == CPUPlace()
    monkeypatch.setenv("PADDLE_TPU_CAPI_PLACE", "tpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        capi_runtime.capi_place()


def test_capi_library_takes_its_flags_from_sysconfig():
    cflags, link = native._python_flags()
    assert cflags == [f"-I{sysconfig.get_paths()['include']}"]
    libpy = native.shared_libpython()
    if libpy is None:
        assert link == []
    else:
        assert f"-L{os.path.dirname(libpy)}" in link
    so = native.capi_library()
    assert os.path.dirname(so) == native.BUILD_DIR
    syms = ctypes.CDLL(so)
    for fn in ("paddle_tpu_inference_create", "paddle_tpu_inference_feed",
               "paddle_tpu_inference_run", "paddle_tpu_inference_fetch",
               "paddle_tpu_inference_destroy", "paddle_tpu_last_error"):
        assert hasattr(syms, fn), fn


def test_standalone_c_host_runs_the_model(tmp_path):
    """A C program linked with gcc against the port's library embeds the
    interpreter and runs a model the JAX package saved (the session on
    the CPU here), within 1e-6 of the JAX Executor."""
    if native.shared_libpython() is None:
        pytest.skip("the interpreter has no shared libpython to embed")
    model_dir = str(tmp_path / "model")
    main, scope, out = _save_jax_model(model_dir)
    x = np.random.RandomState(3).rand(5, 4).astype(np.float32)
    want = np.asarray(jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[out], scope=scope)[0])
    src, dst = str(tmp_path / "in.f32"), str(tmp_path / "out.f32")
    x.tofile(src)
    import site

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, *site.getsitepackages()])
    env["PADDLE_TPU_CAPI_PLACE"] = "cpu"
    res = subprocess.run([native.build_capi_host(), model_dir, "x", src,
                          dst, "5", "4"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok 2 5 3"
    got = np.fromfile(dst, dtype=np.float32).reshape(5, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a bad model directory: the ABI's error, exit 1
    res = subprocess.run([native.build_capi_host(), str(tmp_path / "no"),
                          "x", src, dst, "5", "4"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 1 and "error create" in res.stdout


def test_a_bf16_program_takes_float32_from_c(tmp_path, cpu_sessions):
    """C has no bf16: a float32 feed is cast to the dtype the program
    declares, and the fetch comes back as float32."""
    import paddle_tpu_torch as tfluid
    import torch

    from paddle_tpu_torch.core.scope import Scope

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[4], dtype="bfloat16")
        out = tfluid.layers.fc(input=x, size=3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    model_dir = str(tmp_path / "bf16")
    tfluid.io.save_inference_model(model_dir, ["x"], [out], exe,
                                   main_program=main, scope=scope)
    xv = np.random.RandomState(5).rand(3, 4).astype(np.float32)
    want = exe.run(main, feed={"x": torch.from_numpy(xv).bfloat16()},
                   fetch_list=[out], scope=scope)[0]
    got = _infer(_bind(native.capi_library()), model_dir, xv)
    np.testing.assert_array_equal(got, want)
