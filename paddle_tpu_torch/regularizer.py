"""Weight-decay regularizers appended onto gradients.

Counterpart of paddle_tpu/regularizer.py (PaddlePaddle fluid
regularizer.py).
"""
from __future__ import annotations

from .core.framework import unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(name=unique_name(param.name + "_l2decay"),
                                 dtype=param.dtype)
        block.append_op("scale", {"X": [param.name]},
                        {"Out": [decay.name]}, {"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(name=unique_name(param.name + "_sign"),
                                dtype=param.dtype)
        # sign(x) = x / |x|; implemented as clip(x*1e9, -1, 1) for stability
        block.append_op("scale", {"X": [param.name]}, {"Out": [sign.name]},
                        {"scale": 1e9})
        clipped = block.create_var(name=unique_name(param.name + "_signc"),
                                   dtype=param.dtype)
        block.append_op("clip", {"X": [sign.name]}, {"Out": [clipped.name]},
                        {"min": -1.0, "max": 1.0})
        decay = block.create_var(name=unique_name(param.name + "_l1decay"),
                                 dtype=param.dtype)
        block.append_op("scale", {"X": [clipped.name]},
                        {"Out": [decay.name]}, {"scale": self._coeff})
        return decay


def append_regularization_ops(params_grads, regularization=None):
    """grad += decay(param) for each param with a regularizer
    (reference regularizer.py append_regularization_ops)."""
    out = []
    for param, grad in params_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is None or regularizer is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = regularizer.append_regularization_op(param, grad, block)
        new_grad = block.create_var(
            name=unique_name(grad.name + "_reg"), dtype=param.dtype)
        block.append_op("sum", {"X": [grad.name, decay.name]},
                        {"Out": [new_grad.name]})
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
