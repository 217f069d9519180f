"""The creation ops (paddle_tpu/ops/creation.py), the losses
(paddle_tpu/ops/loss.py), the metrics (paddle_tpu/ops/metrics.py) and
the misc ops (paddle_tpu/ops/misc.py), held by the op-test harness
(tests/test_torch_op_test.py); the random batch-size-like draw by
distribution, and `print` by its printed line."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("creation", "loss", "metrics", "misc")


@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)


def test_uniform_random_batch_size_like_by_distribution():
    """The batch-size-like uniform draw, in both packages: the shape
    from Input's dim, the range, and the mean and variance of U[-2, 3)
    over 200,000 draws within 4 sigma (the draws differ by design: a
    torch generator, threefry keys)."""
    import jax
    import numpy as np
    import torch

    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.execution import ExecContext as JExecContext
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.execution import ExecContext

    case = next(c for c in CASES if c.random)
    tinfo = treg.get_op_info(case.op)
    jinfo = jreg.get_op_info(case.op)
    ins = case.ins["Input"]
    t = tinfo.lower(ExecContext("cpu", seed=5), {"Input": [
        torch.from_numpy(ins)]}, {**tinfo.attrs, **case.attrs})["Out"]
    j = jinfo.lower(JExecContext(jax.random.key(5)), {"Input": [ins]},
                    {**jinfo.attrs, **case.attrs})["Out"]
    lo, hi = case.attrs["min"], case.attrs["max"]
    for v in (t.numpy(), np.asarray(j)):
        assert v.shape == (4000, 50) and v.dtype == np.float32
        assert v.min() >= lo and v.max() < hi
        n = v.size
        mu, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
        assert abs(v.mean() - mu) <= 4 * np.sqrt(var / n)
        # the sample variance's sigma for a uniform: var * sqrt(0.8 / n)
        assert abs(v.var() - var) <= 4 * var * np.sqrt(0.8 / n)
    again = tinfo.lower(ExecContext("cpu", seed=5), {"Input": [
        torch.from_numpy(ins)]}, {**tinfo.attrs, **case.attrs})["Out"]
    assert torch.equal(again, t)


def test_print_writes_the_jax_packages_line(capsys):
    """`print` through an Executor in each package: the same line
    (message, name, shape, dtype, data), the input passed through; a
    host op in the port's segmented mode."""
    import numpy as np

    import paddle_tpu as jfluid
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.core.executor import Executor

    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 4
    lines = []
    for fluid, exe in ((jfluid, jfluid.Executor(jfluid.CPUPlace())),
                       (tfluid, Executor(tfluid.CPUPlace()))):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            blk = main.global_block()
            blk.create_var(name="x", shape=(2, 3), dtype="float32")
            blk.create_var(name="y", shape=(2, 3), dtype="float32")
            blk.append_op("print", {"In": ["x"]}, {"Out": ["y"]},
                          {"message": "step", "summarize": 4})
        got = exe.run(main, feed={"x": x}, fetch_list=["y"])[0]
        np.testing.assert_array_equal(got, x)
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1]
    assert lines[1].startswith("step name=x shape=(2, 3) dtype=float32")
    assert tfluid.core.registry.get_op_info("print").host
