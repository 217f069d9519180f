"""Optimizers: program rewrites appending backward + update ops.

Counterpart of paddle_tpu/optimizer.py (PaddlePaddle fluid
optimizer.py): the `Optimizer` base (global learning-rate var,
per-parameter accumulators, `minimize` = append_backward + clipping +
regularization + the optimization pass); SGD, Momentum, Adagrad, Adam,
Adamax, DecayedAdagrad, Adadelta, RMSProp and Ftrl; and ModelAverage,
which appends windowed parameter sums and swaps the parameters for
their average inside `apply()`.
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
    "Adagrad",
    "AdagradOptimizer",
    "Adam",
    "AdamOptimizer",
    "Adamax",
    "AdamaxOptimizer",
    "DecayedAdagrad",
    "DecayedAdagradOptimizer",
    "Adadelta",
    "AdadeltaOptimizer",
    "RMSProp",
    "RMSPropOptimizer",
    "Ftrl",
    "FtrlOptimizer",
    "ModelAverage",
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        block.append_op(
            "adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name], "MomentOut": [m.name]},
            {"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
        # f32 for the same reason as Adam's beta pows
        self._beta1_pow = self._add_accumulator(
            "beta1_pow", parameters[0], fill_value=self._beta1, shape=[1],
            dtype="float32")

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        block.append_op(
            "adamax",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "InfNorm": [inf.name],
             "LearningRate": [self._lr_for(p).name],
             "Beta1Pow": [self._beta1_pow.name]},
            {"ParamOut": [p.name], "MomentOut": [m.name],
             "InfNormOut": [inf.name]},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op("scale", {"X": [self._beta1_pow.name]},
                        {"Out": [self._beta1_pow.name]},
                        {"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        block.append_op(
            "decayed_adagrad",
            {"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name], "MomentOut": [m.name]},
            {"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._get_accumulator("avg_squared_grad", p)
        asu = self._get_accumulator("avg_squared_update", p)
        block.append_op(
            "adadelta",
            {"Param": [p.name], "Grad": [g.name],
             "AvgSquaredGrad": [asg.name],
             "AvgSquaredUpdate": [asu.name]},
            {"ParamOut": [p.name], "AvgSquaredGradOut": [asg.name],
             "AvgSquaredUpdateOut": [asu.name]},
            {"rho": self._rho, "epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6,
                 momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum", p)
        block.append_op(
            "rmsprop",
            {"Param": [p.name], "Grad": [g.name],
             "MeanSquare": [ms.name], "Moment": [mom.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name], "MeanSquareOut": [ms.name],
             "MomentOut": [mom.name]},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        block.append_op(
            "ftrl",
            {"Param": [p.name], "SquaredAccumulator": [sq.name],
             "LinearAccumulator": [lin.name], "Grad": [g.name],
             "LearningRate": [self._lr_for(p).name]},
            {"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
             "LinearAccumOut": [lin.name]},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


_AVG_SUMS = ("sum_1", "sum_2", "sum_3")
_AVG_COUNTS = ("num_accumulates", "old_num_accumulates", "num_updates")


class ModelAverage(Optimizer):
    """Windowed parameter averaging for evaluation (the legacy
    AverageOptimizer).  Appends one `average_accumulates` op per
    parameter to the main program (after the update ops, so build it
    after `minimize`); `apply()` swaps each parameter for its window
    average inside a `with` block and `restore()` puts the trained
    values back.

        model_average = fluid.optimizer.ModelAverage(0.15)
        ... train ...
        with model_average.apply(exe):
            evaluate()
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, program=None,
                 startup_program=None, **kw):
        super().__init__(0.0, **kw)
        from .core.framework import Parameter, default_main_program

        self._avg_window = float(average_window_rate)
        self._min_window = int(min_average_window)
        self._max_window = int(max_average_window)
        program = program or default_main_program()
        self._program = program
        self._startup_program = startup_program
        gb = program.global_block()
        self._params = sorted(
            (v for v in gb.vars.values() if isinstance(v, Parameter)
             and getattr(v, "do_model_average", None) is not False),
            key=lambda v: v.name)
        self._restore_backup = None
        for p in self._params:
            for n in _AVG_SUMS:
                self._add_accumulator(n, p, dtype="float32")
            for n in _AVG_COUNTS:
                self._add_accumulator(n, p, shape=[1], dtype="int32")
            acc = {n: [self._get_accumulator(n, p).name]
                   for n in _AVG_SUMS + _AVG_COUNTS}
            gb.append_op(
                "average_accumulates",
                {"Param": [p.name], "InSum1": acc["sum_1"],
                 "InSum2": acc["sum_2"], "InSum3": acc["sum_3"],
                 "InNumAccumulates": acc["num_accumulates"],
                 "InOldNumAccumulates": acc["old_num_accumulates"],
                 "InNumUpdates": acc["num_updates"]},
                {"OutSum1": acc["sum_1"], "OutSum2": acc["sum_2"],
                 "OutSum3": acc["sum_3"],
                 "OutNumAccumulates": acc["num_accumulates"],
                 "OutOldNumAccumulates": acc["old_num_accumulates"],
                 "OutNumUpdates": acc["num_updates"]},
                {"average_window": self._avg_window,
                 "min_average_window": self._min_window,
                 "max_average_window": self._max_window})
        program.bump_version()

    def _averaged_value(self, p, scope):
        """(sum_1 + sum_2 + sum_3) / (num_accumulates +
        old_num_accumulates), in float64 on the host and stored in the
        parameter's dtype on its device; None before any update."""
        from .core.types import torch_dtype

        def host(n):
            return scope.find_var(
                self._get_accumulator(n, p).name).cpu().double()

        cnt = sum(int(host(n).reshape(())) for n in _AVG_COUNTS[:2])
        if cnt == 0:
            return None
        s = sum(host(n) for n in _AVG_SUMS)
        return (s / cnt).to(scope.find_var(p.name).device,
                            torch_dtype(p.dtype))

    def apply(self, executor=None, need_restore=True, scope=None):
        """Context manager: parameters <- their window average inside,
        the original values back on exit (when need_restore)."""
        import contextlib

        from .core.executor import global_scope

        scope = scope or global_scope()

        @contextlib.contextmanager
        def _ctx():
            backup = {}
            for p in self._params:
                avg = self._averaged_value(p, scope)
                if avg is None:
                    continue
                # a clone: a compiled run may update the held tensor in
                # place (a CUDA graph's state buffer)
                backup[p.name] = scope.find_var(p.name).clone()
                scope.set_var(p.name, avg)
            self._restore_backup = backup
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor, scope=scope)

        return _ctx()

    def restore(self, executor=None, scope=None):
        from .core.executor import global_scope

        scope = scope or global_scope()
        for name, value in (self._restore_backup or {}).items():
            scope.set_var(name, value)
        self._restore_backup = None


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
