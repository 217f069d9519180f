"""Stateful evaluators that accumulate a metric over mini-batches
(counterpart of paddle_tpu/evaluator.py).

Reference: python/paddle/v2/fluid/evaluator.py: an Evaluator keeps
persistable state variables that ops appended to the main program
update every batch; `eval()` runs a small program computing the metric
from them; `reset()` zeroes them.
"""
from __future__ import annotations

import numpy as np

from . import layers
from .core.framework import (Program, default_main_program,
                             default_startup_program, program_guard,
                             unique_name)

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator"]


class Evaluator:
    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper_name = unique_name(name)
        self.main_program = kwargs.get("main_program") or \
            default_main_program()
        self.startup_program = kwargs.get("startup_program") or \
            default_startup_program()

    def _create_state(self, suffix, dtype, shape):
        """A persistable accumulator, zeroed by the startup program."""
        name = unique_name(f"{self.helper_name}.{suffix}")
        state = self.main_program.global_block().create_var(
            name=name, shape=shape, dtype=dtype, persistable=True)
        sb = self.startup_program.global_block()
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": list(shape), "dtype": dtype, "value": 0.0})
        self.states.append(state)
        return state

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        block = reset_program.global_block()
        for state in self.states:
            block.create_var(name=state.name, shape=state.shape,
                             dtype=state.dtype, persistable=True)
            block.append_op("fill_constant", {}, {"Out": [state.name]},
                            {"shape": list(state.shape),
                             "dtype": state.dtype, "value": 0.0})
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def _accumulate(self, state, delta):
        """state += delta inside the main program."""
        block = self.main_program.global_block()
        tmp = block.create_var(name=unique_name(state.name + ".acc"),
                               dtype=state.dtype)
        block.append_op("elementwise_add",
                        {"X": [state.name], "Y": [delta.name]},
                        {"Out": [tmp.name]})
        block.append_op("assign", {"X": [tmp.name]}, {"Out": [state.name]})

    def _state_vars(self, eval_program):
        block = eval_program.global_block()
        for state in self.states:
            block.create_var(name=state.name, shape=state.shape,
                             dtype=state.dtype, persistable=True)
        return block


class Accuracy(Evaluator):
    """Classification accuracy accumulated over batches."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        self.total = self._create_state("total", "float32", (1,))
        self.correct = self._create_state("correct", "float32", (1,))
        block = self.main_program.current_block
        correct = block.create_var(name=unique_name("acc_correct"),
                                   dtype="int32", stop_gradient=True)
        total = block.create_var(name=unique_name("acc_total"),
                                 dtype="int32", stop_gradient=True)
        acc = layers.accuracy(input=input, label=label, k=k,
                              correct=correct, total=total)
        self._accumulate(self.total, layers.cast(total, "float32"))
        self._accumulate(self.correct, layers.cast(correct, "float32"))
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        eval_program = eval_program or Program()
        block = self._state_vars(eval_program)
        out = block.create_var(name=unique_name("accuracy_out"),
                               dtype="float32")
        block.append_op("elementwise_div",
                        {"X": [self.correct.name], "Y": [self.total.name]},
                        {"Out": [out.name]})
        return executor.run(eval_program, fetch_list=[out.name])[0]


class ChunkEvaluator(Evaluator):
    """Chunk precision, recall and F1 accumulated over batches."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super().__init__("chunk_eval", **kwargs)
        self.num_infer_chunks = self._create_state(
            "num_infer_chunks", "float32", (1,))
        self.num_label_chunks = self._create_state(
            "num_label_chunks", "float32", (1,))
        self.num_correct_chunks = self._create_state(
            "num_correct_chunks", "float32", (1,))
        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self._accumulate(self.num_infer_chunks,
                         layers.cast(num_infer, "float32"))
        self._accumulate(self.num_label_chunks,
                         layers.cast(num_label, "float32"))
        self._accumulate(self.num_correct_chunks,
                         layers.cast(num_correct, "float32"))
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program=None):
        """-> float32 [precision, recall, F1] over the batches so far."""
        eval_program = eval_program or Program()
        block = self._state_vars(eval_program)
        ni = block.var(self.num_infer_chunks.name)
        nl = block.var(self.num_label_chunks.name)
        nc = block.var(self.num_correct_chunks.name)

        def floor(v):
            return layers.elementwise_max(
                v, layers.fill_constant(shape=[1], dtype="float32",
                                        value=1e-6))

        with program_guard(eval_program, Program()):
            precision = layers.elementwise_div(layers.cast(nc, "float32"),
                                               floor(layers.cast(
                                                   ni, "float32")))
            recall = layers.elementwise_div(layers.cast(nc, "float32"),
                                            floor(layers.cast(
                                                nl, "float32")))
            two_pr = layers.scale(layers.elementwise_mul(precision, recall),
                                  scale=2.0)
            f1 = layers.elementwise_div(
                two_pr, floor(layers.elementwise_add(precision, recall)))
        p, r, f = executor.run(eval_program,
                               fetch_list=[precision, recall, f1])
        return np.asarray([p[0], r[0], f[0]], np.float32)
