"""The port's `paddle train` CLI (paddle_tpu_torch/cli.py) on the CPU,
in-process (`cli.main(argv)`), against the JAX package's.

tests/test_cli.py's six cases (train and save, test's required model
path, test, time, checkgrad, merge) on the port, and the round trips
between the packages on the same config: a pass the JAX CLI saved is
tested and trained on by the port's (its avg cost and per-batch costs
the JAX package's at 1e-5, SGD, no dropout), checkgrad passes in both
from the same parameters with the same sampled indices and analytic
gradients equal at 1e-5, and a model the port merged loads in the JAX
package's load_inference_model with the port's outputs at 1e-5.  The
subcommands that wait for unported items raise naming them.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.core.framework as jfw
from paddle_tpu import cli as jcli
from paddle_tpu_torch import cli

CONFIG = """
import numpy as np
import {package} as fluid

def build():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=8, act="relu")
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))

    def reader():
        r = np.random.RandomState(0)
        w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
        for _ in range(8):
            xb = r.rand(16, 4).astype(np.float32)
            yield {{"x": xb, "y": xb @ w}}

    def test_reader():
        r = np.random.RandomState(1)
        w = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
        for _ in range(3):
            xb = r.rand(16, 4).astype(np.float32)
            yield {{"x": xb, "y": xb @ w}}

    return {{"loss": loss, "reader": reader, "test_reader": test_reader,
            "optimizer": fluid.SGD(learning_rate=0.1),
            "infer_targets": [pred], "feed_order": ["x", "y"]}}
"""


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for tag, package in (("jax", "paddle_tpu"), ("port", "paddle_tpu_torch")):
        p = d / f"config_{tag}.py"
        p.write_text(CONFIG.format(package=package))
        out[tag] = str(p)
    return out


@pytest.fixture(scope="module")
def jax_pass(configs, tmp_path_factory):
    """A pass the JAX package's CLI trained and saved."""
    save = str(tmp_path_factory.mktemp("jax_saved"))
    jfw.reset_unique_names()
    jcli.main(["--config", configs["jax"], "--job", "train", "--use_tpu",
               "0", "--save_dir", save])
    return os.path.join(save, "pass-00000")


def _port(configs, *args):
    return cli.main(["--config", configs["port"], "--use_gpu", "0",
                     *args])


def _jax_cfg(configs, init, minimize):
    """The JAX CLI's program and an executor on `init`, as its jobs
    build them."""
    jfw.reset_unique_names()
    cfg = jcli._build(jcli._load_config(configs["jax"]))
    if minimize:
        with jfluid.program_guard(cfg["main"], cfg["startup"]):
            cfg["optimizer"].minimize(cfg["loss"])
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(cfg["startup"])
    jfluid.io.load_persistables(exe, init, main_program=cfg["main"])
    return cfg, exe


def _jax_costs(cfg, exe, program, reader):
    return [float(np.asarray(exe.run(program, feed=feed,
                                     fetch_list=[cfg["loss"]])[0])
                  .reshape(-1)[0]) for feed in reader()]


def test_cli_train_and_save(configs, tmp_path, capsys):
    save = str(tmp_path / "out")
    res = _port(configs, "--job", "train", "--num_passes", "2",
                "--log_period", "4", "--save_dir", save)
    out = capsys.readouterr().out
    assert "pass 1 done" in out and "pass 0 batch 4 cost" in out
    assert os.path.isdir(os.path.join(save, "pass-00001"))
    c0, c1 = (np.mean(c) for c in res["costs"])
    assert c1 < c0
    assert res["exe"].device.type == "cpu"


def test_cli_test_requires_model_path(configs):
    with pytest.raises(SystemExit, match="init_model_path"):
        _port(configs, "--job", "test")


def test_cli_test_job_with_init_model(configs, jax_pass, capsys):
    """The JAX package's saved pass, tested by the port: its avg cost."""
    res = _port(configs, "--job", "test", "--init_model_path", jax_pass)
    assert "avg cost" in capsys.readouterr().out
    cfg, exe = _jax_cfg(configs, jax_pass, minimize=False)
    want = _jax_costs(cfg, exe, cfg["main"].clone(for_test=True),
                      cfg["test_reader"])
    assert len(res["costs"]) == 3
    np.testing.assert_allclose(res["costs"], want, rtol=1e-5)
    np.testing.assert_allclose(res["avg_cost"], np.mean(want), rtol=1e-5)


def test_cli_train_from_a_jax_pass_matches_the_jax_package(configs,
                                                           jax_pass):
    res = _port(configs, "--job", "train", "--init_model_path", jax_pass)
    cfg, exe = _jax_cfg(configs, jax_pass, minimize=True)
    want = _jax_costs(cfg, exe, cfg["main"], cfg["reader"])
    assert len(res["costs"][0]) == 8
    np.testing.assert_allclose(res["costs"][0], want, rtol=1e-5)


def test_cli_time_job(configs, capsys):
    res = _port(configs, "--job", "time", "--batches_per_pass", "3")
    assert "ms/batch over 3 batches" in capsys.readouterr().out
    assert res["ms_per_batch"] > 0 and res["batches"] == 3


def test_cli_checkgrad_job(configs, jax_pass, capsys):
    """Both packages pass from the same parameters; the same indices,
    and analytic gradients equal at 1e-5."""
    res = _port(configs, "--job", "checkgrad", "--init_model_path",
                jax_pass)
    assert "checkgrad passed" in capsys.readouterr().out
    jfw.reset_unique_names()
    jcli.main(["--config", configs["jax"], "--job", "checkgrad",
               "--use_tpu", "0", "--init_model_path", jax_pass])
    assert "checkgrad passed" in capsys.readouterr().out
    cfg, exe = _jax_cfg(configs, jax_pass, minimize=False)
    params = cfg["main"].global_block().all_parameters()
    with jfluid.program_guard(cfg["main"], cfg["startup"]):
        grads = jfluid.calc_gradient(cfg["loss"], params)
    feed = next(iter(cfg["reader"]()))
    fetched = exe.run(cfg["main"], feed=feed,
                      fetch_list=[cfg["loss"]] + list(grads))
    rng = np.random.RandomState(0)
    assert list(res["params"]) == [p.name for p in params]
    for p, g in zip(params, fetched[1:]):
        np.testing.assert_allclose(res["analytic"][p.name], np.asarray(g),
                                   rtol=1e-5, atol=1e-7)
        got = res["params"][p.name]
        size = int(np.prod(p.shape))
        want_idx = rng.choice(size, size=min(8, size), replace=False)
        np.testing.assert_array_equal(got["indices"], want_idx)
        assert got["max_rel_err"] < 1e-2


def test_cli_merge_job(configs, jax_pass, tmp_path):
    """A model the port merged serves in the port and in the JAX
    package's load_inference_model, with the same outputs at 1e-5."""
    import paddle_tpu_torch as tfluid

    out = str(tmp_path / "merged")
    _port(configs, "--job", "merge", "--init_model_path", jax_pass,
          "--save_dir", out)
    assert os.path.exists(os.path.join(out, "__model__"))
    assert os.path.exists(os.path.join(out, "__params__"))
    r = np.random.RandomState(2)
    feed = {"x": r.rand(5, 4).astype(np.float32),
            "y": np.zeros((5, 1), np.float32)}
    texe = tfluid.Executor(tfluid.CPUPlace())
    prog, feeds, fetches = tfluid.io.load_inference_model(
        out, texe, model_filename="__model__", params_filename="__params__")
    assert feeds == ["x", "y"]
    got, = texe.run(prog, feed=feed, fetch_list=fetches)
    assert got.shape == (5, 1)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jprog, jfeeds, jfetches = jfluid.io.load_inference_model(
        out, jexe, model_filename="__model__", params_filename="__params__")
    assert jfeeds == feeds
    want, = jexe.run(jprog, feed=feed, fetch_list=jfetches)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sub,item", [
    ("metrics", "A12's second part"), ("trace", "A12's second part"),
    ("top", "A12's second part"), ("slo", "A12's second part"),
    ("why", "A12's second part"), ("trace-of", "A12's second part"),
    ("serve", "A11"), ("autoscale", "A11")])
def test_unported_subcommands_raise_naming_their_item(sub, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main([sub, "x"])


def test_the_default_device_is_the_card(configs):
    """--use_gpu defaults to 1 (CUDAPlace(0)); --use_tpu is its alias."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for flag in ([], ["--use_tpu", "1"]):
        with pytest.raises(RuntimeError, match="CUDAPlace"):
            cli.main(["--config", configs["port"], "--job", "time", *flag])
    res = cli.main(["--config", configs["port"], "--job", "time",
                    "--use_tpu", "0", "--batches_per_pass", "1"])
    assert res["exe"].device.type == "cpu"
