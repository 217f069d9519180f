"""The rest of the conv ops (conv3d, the transposed convolutions,
pool3d, the max pools with index, spp, unpool, conv_shift, row_conv)
through the op-test harness (tests/test_torch_op_test.py): the numpy
reference, finite differences and the JAX lowering with jax.vjp."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("conv_rest")


@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)
