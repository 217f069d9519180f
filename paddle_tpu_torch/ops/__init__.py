"""Op corpus: importing this package registers the op lowerings.

Counterpart of paddle_tpu/ops/.  This package carries the ops that the
transformer LM's training Program contains (forward ops, losses, the
small ops backward and the optimizers emit, the optimizer updates and
the startup initializers), the MoE FFN, the conv nets' ops
(convolution, pooling, batch norm, lrn, dropout, top_k and accuracy),
and the dense op corpus of the JAX package's activation, elementwise,
matmul, reduce, manip, creation, loss, metrics and misc modules (every
type there that needs no LoD, SelectedRows or sub-block), the LoD
sequence ops, the recurrent ops and the control-flow ops (while,
conditional blocks, tensor arrays, rank tables, beam search and the
recurrence over a step block), the linear-chain CRF ops, CTC, the
sampled losses (hsigmoid, nce), the detection ops and the readers, each
lowered once in PyTorch.
"""
from . import (  # noqa: F401
    activation,
    attention,
    control_flow,
    conv,
    creation,
    crf,
    ctc,
    detection,
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
    reader,
    reduce,
    rnn,
    sampling,
    sequence,
)
