"""Op corpus: importing this package registers the op lowerings.

Counterpart of paddle_tpu/ops/.  This package carries the ops that the
transformer LM's training Program contains (forward ops, losses, the
small ops backward and the optimizers emit, the optimizer updates and
the startup initializers), the MoE FFN, and the conv nets' ops
(convolution, pooling, batch norm, dropout, top_k and accuracy), each
lowered once in PyTorch.
"""
from . import (  # noqa: F401
    activation,
    attention,
    conv,
    creation,
    elementwise,
    embedding,
    loss,
    manip,
    matmul,
    metrics,
    misc,
    moe,
    norm,
    optimizer_ops,
    reduce,
)
