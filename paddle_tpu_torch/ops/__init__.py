"""Op corpus: importing this package registers the op lowerings.

Counterpart of paddle_tpu/ops/.  This package carries the ops that the
transformer LM's training Program contains (forward ops, losses, the
small ops backward and the optimizers emit, the optimizer updates and
the startup initializers) and the MoE FFN, each lowered once in
PyTorch.
"""
from . import (  # noqa: F401
    activation,
    attention,
    creation,
    elementwise,
    embedding,
    loss,
    manip,
    matmul,
    misc,
    moe,
    norm,
    optimizer_ops,
    reduce,
)
