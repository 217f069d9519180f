"""LayerHelper: shared parameter/bias/activation plumbing for layers
(counterpart of paddle_tpu/layer_helper.py).  Parameters are created in
BOTH the main program's global block (as inputs to compute ops) and the
startup program (where their init ops run once)."""
from __future__ import annotations

from .amp import is_bf16_enabled
from .core.framework import (
    default_main_program,
    default_startup_program,
    unique_name,
)
from .initializer import ConstantInitializer, XavierInitializer

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if kwargs.get("name") is None:
            self.name = unique_name(layer_type)
        else:
            self.name = kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block

    @property
    def param_attr(self):
        return self.kwargs.get("param_attr")

    @property
    def bias_attr(self):
        return self.kwargs.get("bias_attr")

    def input(self, name="input"):
        return self.kwargs[name]

    def multiple_input(self, name="input"):
        v = self.kwargs[name]
        return list(v) if isinstance(v, (list, tuple)) else [v]

    # -- var/param creation --------------------------------------------------
    def create_tmp_variable(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), dtype=dtype,
            stop_gradient=stop_gradient)

    def create_variable(self, name, **kw):
        return self.block.create_var(name=name, **kw)

    def create_global_variable(self, name=None, persistable=False,
                               dtype="float32", shape=None,
                               stop_gradient=True):
        return self.main_program.global_block().create_var(
            name=name or unique_name(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None, suffix="w"):
        attr = dict(attr or {})
        name = attr.get("name") or unique_name(f"{self.name}.{suffix}")
        init = attr.get("initializer") or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        shape = [int(s) for s in shape]
        # amp master weights: a layer whose input is a bf16 amp
        # intermediate still makes an f32 parameter (bf16 optimizer
        # state is numerically unsound)
        if is_bf16_enabled() and str(dtype) == "bfloat16":
            dtype = "float32"
        main_p = self.main_program.global_block().create_parameter(
            name, shape, dtype,
            trainable=attr.get("trainable", True),
            regularizer=attr.get("regularizer"),
            gradient_clip_attr=attr.get("gradient_clip_attr"),
            optimize_attr={"learning_rate": attr.get("learning_rate", 1.0)},
            update_hooks=attr.get("update_hooks"),
            do_model_average=attr.get("do_model_average"),
        )
        # mirror into startup program + emit its init op there
        sb = self.startup_program.global_block()
        sv = sb.create_parameter(name, shape, dtype)
        init(sv, sb)
        return main_p

    # -- common layer plumbing ----------------------------------------------
    def append_op(self, *a, **kw):
        return self.block.append_op(*a, **kw)

    # mixed float widths are legal under amp (an embedding path stays
    # f32 while a mul path emits bf16); the widest wins, so parameters
    # made from it stay f32.  Any other mix (float64, int with float)
    # raises
    _FLOAT_WIDTH = {"float32": 3, "bfloat16": 2, "float16": 1}

    def input_dtype(self, name="input"):
        dtype = None
        for v in self.multiple_input(name):
            if dtype is None or dtype == v.dtype:
                dtype = v.dtype
            elif str(dtype) in self._FLOAT_WIDTH \
                    and str(v.dtype) in self._FLOAT_WIDTH:
                if self._FLOAT_WIDTH[str(v.dtype)] \
                        > self._FLOAT_WIDTH[str(dtype)]:
                    dtype = v.dtype
            else:
                raise ValueError(
                    f"all inputs must have the same dtype, or mix only "
                    f"the amp float widths float16/bfloat16/float32 "
                    f"(got {dtype} and {v.dtype})")
        return dtype

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """+bias over dims [dim_start, dim_end) of the input shape.
        bias_attr=None means a DEFAULT bias is created; only
        bias_attr=False disables it."""
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        if bias_attr is None or bias_attr is True:
            bias_attr = {}
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True,
                                  suffix="b")
        tmp = self.create_tmp_variable(input_var.dtype)
        self.append_op(
            "elementwise_add", {"X": [input_var.name], "Y": [b.name]},
            {"Out": [tmp.name]}, {"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(input_var.dtype)
        self.append_op(act_type, {"X": [input_var.name]},
                       {"Out": [tmp.name]}, act)
        return tmp
