"""Learning-rate decay schedules built as ops in the program
(counterpart of paddle_tpu/learning_rate_decay.py).

exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay and piecewise_decay: each is graph ops over a global
step counter (cast, scale, floor, ceil, exp, reciprocal, elementwise
pow/min/max, less_than, fill_constant), so the learning-rate math runs
inside the compiled block with the step; pass the returned variable as
`learning_rate=` to an optimizer.
"""
from __future__ import annotations

from . import layers

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
]


def float_global_step(global_step):
    return layers.cast(global_step, "float32")


def _div_steps(global_step, decay_steps, staircase):
    div = layers.scale(float_global_step(global_step),
                       scale=1.0 / decay_steps)
    return layers.floor(div) if staircase else div


def exponential_decay(learning_rate, global_step, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (global_step / decay_steps)"""
    div = _div_steps(global_step, decay_steps, staircase)
    return layers.scale(
        layers.elementwise_pow(
            layers.fill_constant(shape=[1], dtype="float32",
                                 value=float(decay_rate)), div),
        scale=float(learning_rate))


def natural_exp_decay(learning_rate, global_step, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * global_step / decay_steps)"""
    div = _div_steps(global_step, decay_steps, staircase)
    return layers.scale(layers.exp(layers.scale(div, scale=-decay_rate)),
                        scale=float(learning_rate))


def inverse_time_decay(learning_rate, global_step, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * global_step / decay_steps)"""
    div = _div_steps(global_step, decay_steps, staircase)
    denom = layers.scale(div, scale=float(decay_rate), bias=1.0)
    return layers.scale(layers.reciprocal(denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, global_step, decay_steps,
                     end_learning_rate=0.0001, power=1.0, cycle=False):
    """(lr - end_lr) * (1 - step/decay_steps)^power + end_lr"""
    step = float_global_step(global_step)
    if cycle:
        div = layers.ceil(layers.scale(step, scale=1.0 / decay_steps))
        # step 0 -> div 1
        one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
        div = layers.elementwise_max(div, one)
        decay_steps_var = layers.scale(div, scale=float(decay_steps))
        frac = layers.elementwise_div(step, decay_steps_var)
    else:
        capped = layers.elementwise_min(
            step, layers.fill_constant(shape=[1], dtype="float32",
                                       value=float(decay_steps)))
        frac = layers.scale(capped, scale=1.0 / decay_steps)
    base = layers.scale(frac, scale=-1.0, bias=1.0)  # 1 - frac
    powed = layers.elementwise_pow(
        base, layers.fill_constant(shape=[1], dtype="float32",
                                   value=float(power)))
    return layers.scale(powed, scale=float(learning_rate - end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(global_step, boundaries, values):
    """Step function: values[i] while global_step < boundaries[i],
    values[-1] after the last boundary."""
    assert len(values) == len(boundaries) + 1
    step = float_global_step(global_step)
    lr = layers.fill_constant(shape=[1], dtype="float32",
                              value=float(values[-1]))
    # from the last interval backwards, each a select by (step < b)
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        below = layers.cast(
            layers.less_than(
                step, layers.fill_constant(shape=[1], dtype="float32",
                                           value=float(b))),
            "float32")
        v_var = layers.fill_constant(shape=[1], dtype="float32",
                                     value=float(v))
        lr = layers.elementwise_add(
            layers.elementwise_mul(below, v_var),
            layers.elementwise_mul(
                layers.scale(below, scale=-1.0, bias=1.0), lr))
    return lr
