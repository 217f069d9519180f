"""Program pruning for inference (counterpart of paddle_tpu/io.py's
`prune` and `get_inference_program`).

Reference: python/paddle/v2/fluid/io.py's get_inference_program and
framework/prune.cc (drop the ops the fetch targets do not need).
Saving and loading variables and the inference-model format are not
ported yet (ROADMAP A10).
"""
from __future__ import annotations

from typing import Sequence

from .core.framework import Program, Variable, default_main_program

__all__ = ["prune", "get_inference_program"]


def prune(program: Program, targets: Sequence,
          for_test: bool = False) -> Program:
    """A clone of `program` whose block 0 keeps only the ops needed to
    compute `targets`.  An op with sub-blocks is kept whole if any of its
    outputs is needed, and the names read anywhere inside its sub-blocks
    count as its own reads, so their block-0 producers are kept too."""
    target_names = {
        t.name if isinstance(t, Variable) else str(t) for t in targets
    }
    pruned = program.clone(for_test=for_test)

    def op_reads(op):
        names = set(op.input_names())
        for attr in op.attrs:
            sub = op.sub_block(attr) if attr.endswith("block") else None
            if sub is not None:
                for sub_op in sub.ops:
                    names.update(op_reads(sub_op))
        return names

    block = pruned.global_block()
    needed = set(target_names)
    keep = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            needed.update(op_reads(op))
    keep.reverse()
    block.ops = keep
    referenced = set(target_names)
    for op in keep:
        referenced.update(op_reads(op))
        referenced.update(op.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    pruned.bump_version()
    return pruned


def get_inference_program(target_vars, main_program=None) -> Program:
    """The test-mode program that computes `target_vars` alone."""
    program = main_program or default_main_program()
    return prune(program, target_vars, for_test=True)
