"""The LoD sequence ops (paddle_tpu/ops/sequence.py: every pooltype,
MAX's ties and empty sequences, a 2-level sequence_expand, the host ops
sequence_erase, sequence_slice and sequence_unpad), the recurrent ops
(paddle_tpu/ops/rnn.py: lstm with and without peepholes, reversed, with
H0/C0; lstmp, gru and the two unit steps) and edit_distance, held by the
op-test harness (tests/test_torch_op_test.py) with LoDTensor inputs."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_op_test import (check_finite_differences, check_jax,  # noqa: E402
                                check_numpy, fd_cases, forward_cases,
                                jax_cases)
from torch_op_cases import cases_of  # noqa: E402

CASES = cases_of("sequence", "rnn")


@pytest.mark.parametrize("case", forward_cases(CASES), ids=str)
def test_forward_matches_numpy(case):
    check_numpy(case)


@pytest.mark.parametrize("case", fd_cases(CASES), ids=str)
def test_gradient_matches_finite_differences(case):
    check_finite_differences(case)


@pytest.mark.parametrize("case", jax_cases(CASES), ids=str)
def test_matches_the_jax_lowering(case):
    check_jax(case)
