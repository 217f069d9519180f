"""Gradient / error clipping.

Counterpart of paddle_tpu/clip.py (PaddlePaddle fluid clip.py) —
ErrorClipByValue (clips activation error "@GRAD" vars during backward),
GradientClipByValue / GradientClipByNorm / GradientClipByGlobalNorm
(rewrite (param, grad) pairs before the optimizer ops), `set_gradient_clip`
and `append_gradient_clip_ops` called from Optimizer.minimize.
"""
from __future__ import annotations

from . import layers

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
    "error_clip_callback",
]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.min = float(min) if min is not None else -max
        self.max = max

    def append_clip_op(self, block, grad_name):
        block.append_op("clip", {"X": [grad_name]}, {"Out": [grad_name]},
                        {"min": self.min, "max": self.max})


def error_clip_callback(block, op):
    """Apply each output var's error_clip attr to its @GRAD var (reference
    clip.py error_clip_callback, invoked per grad op in backward)."""
    for grad_n in op.output_names():
        if not grad_n.endswith("@GRAD"):
            continue
        fwd_name = grad_n[: -len("@GRAD")]
        if not block.has_var(fwd_name):
            continue
        fwd_var = block.var(fwd_name)
        clip_attr = getattr(fwd_var, "error_clip", None)
        if clip_attr is not None:
            clip_attr.append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.min = float(min) if min is not None else -max
        self.max = max

    def create_operators(self, param, grad):
        new_grad = layers.clip(grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        new_grad = layers.clip_by_norm(grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale all grads by clip_norm / max(global_norm, clip_norm)
    (reference clip.py:120-180)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def process_context(self, context, param, grad):
        grads = context.setdefault(self.group_name, [])
        grads.append(grad)

    def create_operators(self, param, grad, context):
        # scale var computed once per group by finalize_group; looked up in
        # the SHARED context so distinct instances with one group_name work
        scale_var = context[self.group_name + "@scale"]
        new_grad = layers.elementwise_mul(grad, scale_var)
        return param, new_grad

    def finalize_group(self, context):
        grads = context.get(self.group_name, [])
        sq_sums = []
        for g in grads:
            sq = layers.reduce_sum(layers.square(g))
            sq_sums.append(sq)
        global_norm = layers.sqrt(layers.sums(sq_sums))
        clip_var = layers.fill_constant(shape=[1], dtype="float32",
                                        value=self.clip_norm)
        denom = layers.elementwise_max(global_norm, clip_var)
        context[self.group_name + "@scale"] = layers.elementwise_div(
            clip_var, denom)


_GRADIENT_CLIP_ATTR = "gradient_clip_attr"


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach a clip attr to parameters (all trainable ones by default)."""
    from .core.framework import default_main_program

    program = program or default_main_program()
    if param_list is None:
        params = program.global_block().all_parameters()
    else:
        params = [
            program.global_block().var(p) if isinstance(p, str) else p
            for p in param_list
        ]
    for p in params:
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    """Rewrite (param, grad) pairs through each param's clip attr
    (reference clip.py append_gradient_clip_ops)."""
    context = {}
    attrs = []
    for p, g in param_grad:
        clip_attr = getattr(p, _GRADIENT_CLIP_ATTR, None) or \
            NullGradientClipAttr()
        attrs.append(clip_attr)
        clip_attr.process_context(context, p, g)
    finalized = set()
    for a in attrs:
        if isinstance(a, GradientClipByGlobalNorm) and \
                a.group_name not in finalized:
            a.finalize_group(context)
            finalized.add(a.group_name)
    res = []
    for (p, g), a in zip(param_grad, attrs):
        if isinstance(a, GradientClipByGlobalNorm):
            res.append(a.create_operators(p, g, context))
        else:
            res.append(a.create_operators(p, g))
    return res
