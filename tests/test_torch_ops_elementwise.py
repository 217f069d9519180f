"""The elementwise min and pow, the comparisons and logicals
(paddle_tpu/ops/elementwise.py), `matmul` and `bilinear_tensor_product`
(paddle_tpu/ops/matmul.py), held by the op-test harness
(tests/test_torch_op_test.py); and the repaired `clip` gradient at its
bounds against the JAX package's."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("elementwise", "matmul")


@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)


def test_clip_gradient_at_its_bounds_is_the_jax_packages():
    """The fault the port's `clip` had: at x = [-1, 0, 1, 2] with bounds
    -1 and 1 and a cotangent of ones, jax.vjp of the JAX lowering gives
    [0.5, 1, 0.5, 0] (jnp.clip splits a tie between its two sides);
    torch.clamp's autograd gave [1, 1, 1, 0]."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.execution import ExecContext as JExecContext
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.execution import ExecContext, GRAD
    from paddle_tpu_torch.core.execution import generic_grad_lower

    x = np.array([-1.0, 0.0, 1.0, 2.0], np.float32)
    attrs = {"min": -1.0, "max": 1.0}
    jlower = jreg.get_op_info("clip").lower
    _, vjp = jax.vjp(lambda v: jlower(JExecContext(), {"X": [v]},
                                      attrs)["Out"], jnp.asarray(x))
    want = np.asarray(vjp(jnp.ones(4, jnp.float32))[0])
    np.testing.assert_array_equal(want, [0.5, 1.0, 0.5, 0.0])
    info = treg.get_op_info("clip")
    xt = torch.from_numpy(x)
    out = info.lower(ExecContext("cpu"), {"X": [xt]}, attrs)["Out"]
    got = generic_grad_lower(
        ExecContext("cpu"), {"X": [xt], "Out": [out],
                             "Out" + GRAD: [torch.ones(4)]}, attrs,
        info)["X" + GRAD][0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), [-1.0, 0.0, 1.0, 1.0])
