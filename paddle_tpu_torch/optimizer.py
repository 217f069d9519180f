"""Optimizers: program rewrites appending backward + update ops.

Counterpart of paddle_tpu/optimizer.py (PaddlePaddle fluid
optimizer.py): the `Optimizer` base (global learning-rate var,
per-parameter accumulators, `minimize` = append_backward + clipping +
regularization + the optimization pass) and SGD, Momentum and Adam.
The other optimizers and ModelAverage are ROADMAP A2's remainder.
"""
from __future__ import annotations

from typing import Dict

from .backward import append_backward
from .core.framework import (
    Variable,
    default_startup_program,
    unique_name,
)
from .regularizer import append_regularization_ops

__all__ = [
    "Optimizer",
    "SGD",
    "SGDOptimizer",
    "Momentum",
    "MomentumOptimizer",
    "Adam",
    "AdamOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None,
                 global_step=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._global_step = global_step
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var = None
        self._startup_program = None  # set by create_optimization_pass

    # -- learning rate -------------------------------------------------------
    def _create_lr_var(self, program):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        name = unique_name("learning_rate")
        gb = program.global_block()
        self._lr_var = gb.create_var(
            name=name, shape=(1,), dtype="float32", persistable=True,
            stop_gradient=True)
        sb = (self._startup_program or
              default_startup_program()).global_block()
        sb.create_var(name=name, shape=(1,), dtype="float32",
                      persistable=True)
        sb.append_op("fill_constant", {}, {"Out": [name]},
                     {"shape": [1], "dtype": "float32",
                      "value": float(self._learning_rate)})

    def _lr_for(self, param):
        return self._lr_var

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        acc_name = f"{param.name}_{name}_acc"
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        gb = param.block.program.global_block()
        acc = gb.create_var(name=acc_name, shape=shape, dtype=dtype,
                            persistable=True, stop_gradient=True)
        sb = (self._startup_program or
              default_startup_program()).global_block()
        sb.create_var(name=acc_name, shape=tuple(shape), dtype=dtype,
                      persistable=True)
        sb.append_op("fill_constant", {}, {"Out": [acc_name]},
                     {"shape": shape, "dtype": dtype,
                      "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _append_update_hooks(self, block, param):
        """Parameter update hooks (reference
        parameter/ParameterUpdaterHook.cpp, attached via ParameterConfig
        update_hooks).  'pruning': a static mask from the initial weight
        magnitudes re-applied after every optimizer step."""
        for hook in getattr(param, "update_hooks", None) or ():
            if hook.get("type") != "pruning":
                raise ValueError(f"unknown update hook {hook!r}")
            mask_name = f"{param.name}_prune_mask"
            gb = block.program.global_block()
            if not gb.has_var(mask_name):
                gb.create_var(name=mask_name, shape=list(param.shape),
                              dtype=param.dtype, persistable=True,
                              stop_gradient=True)
                sb = (self._startup_program or
                      default_startup_program()).global_block()
                sb.create_var(name=mask_name, shape=list(param.shape),
                              dtype=param.dtype, persistable=True)
                sb.append_op("pruning_mask", {"Param": [param.name]},
                             {"Mask": [mask_name]},
                             {"sparsity_ratio":
                              float(hook.get("sparsity_ratio", 0.6))})
                # static pruning starts from a pruned net
                sb.append_op("elementwise_mul",
                             {"X": [param.name], "Y": [mask_name]},
                             {"Out": [param.name]}, {"axis": -1})
            block.append_op("elementwise_mul",
                            {"X": [param.name], "Y": [mask_name]},
                            {"Out": [param.name]}, {"axis": -1})

    # -- hooks ---------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # -- main entry ----------------------------------------------------------
    def create_optimization_pass(self, params_grads, loss,
                                 startup_program=None):
        if not params_grads:
            return []
        block = loss.block
        program = block.program
        # init ops (LR, accumulators) go into the caller's startup program —
        # falling back to the ambient default only when none was given
        # (reference optimizer.py threads startup_program the same way)
        self._startup_program = startup_program
        self._create_lr_var(program)
        self._create_accumulators(block, [p for p, _ in params_grads])
        start = len(block.ops)
        for p, g in params_grads:
            if g is None:
                continue
            self._append_optimize_op(block, (p, g))
            self._append_update_hooks(block, p)
        self._finish_update(block)
        if self._global_step is not None:
            block.append_op("increment",
                            {"X": [self._global_step.name]},
                            {"Out": [self._global_step.name]},
                            {"step": 1.0})
        # the ops this pass appended — what DistributeTranspiler moves to
        # the pserver program (reference optimizer.py returns them too)
        return block.ops[start:]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        # gradient clipping between backward and regularization, matching
        # reference optimizer.py minimize ordering (clip.py:236)
        from .clip import append_gradient_clip_ops

        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self.create_optimization_pass(params_grads, loss,
                                                     startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        p, g = pg
        block.append_op(
            "sgd",
            {"Param": [p.name], "Grad": [g.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        block.append_op(
            "momentum",
            {"Param": [p.name], "Grad": [g.name], "Velocity": [v.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name], "VelocityOut": [v.name]},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        # global beta powers (reference optimizer.py AdamOptimizer).
        # ALWAYS f32: with bf16 params, a bf16 beta2_pow rounds 0.999 to
        # 1.0 and stays there (the scale-op update is outside the f32
        # optimizer-arithmetic wrapper), making lr_t exactly 0.
        self._beta1_pow = self._add_accumulator(
            "beta1_pow", parameters[0], fill_value=self._beta1, shape=[1],
            dtype="float32")
        self._beta2_pow = self._add_accumulator(
            "beta2_pow", parameters[0], fill_value=self._beta2, shape=[1],
            dtype="float32")

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        block.append_op(
            "adam",
            {"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
             "Moment2": [m2.name],
             "LearningRate": [self._lr_for(p).name],
             "Beta1Pow": [self._beta1_pow.name],
             "Beta2Pow": [self._beta2_pow.name]},
            {"ParamOut": [p.name], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op("scale", {"X": [self._beta1_pow.name]},
                        {"Out": [self._beta1_pow.name]},
                        {"scale": self._beta1})
        block.append_op("scale", {"X": [self._beta2_pow.name]},
                        {"Out": [self._beta2_pow.name]},
                        {"scale": self._beta2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
