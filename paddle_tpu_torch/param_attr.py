"""ParamAttr — structured parameter attributes (counterpart of
paddle_tpu/param_attr.py).  Layers accept plain dicts for parameter
attributes; ParamAttr subclasses dict so both spellings work
interchangeably.  WeightNormParamAttr makes LayerHelper.create_parameter
reparameterize the weight as w = g * v / ||v|| (Salimans & Kingma)."""
from __future__ import annotations

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr(dict):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None, update_hooks=None):
        super().__init__()
        if name is not None:
            self["name"] = name
        if initializer is not None:
            self["initializer"] = initializer
        self["learning_rate"] = learning_rate
        if regularizer is not None:
            self["regularizer"] = regularizer
        self["trainable"] = trainable
        if gradient_clip is not None:
            self["gradient_clip_attr"] = gradient_clip
        if do_model_average is not None:
            self["do_model_average"] = do_model_average
        if update_hooks is not None:
            self["update_hooks"] = update_hooks


class WeightNormParamAttr(ParamAttr):
    """`dim`: the dimension KEPT by the norm (g has shape [shape[dim]];
    None means one scalar g over the whole tensor)."""

    # the JAX package keeps this class-level list for import
    # compatibility and never grows it: the reparameterized weights are
    # tracked per Program (`program.params_with_weight_norm`)
    params_with_weight_norm = []

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
        self["weight_norm_dim"] = -1 if dim is None else int(dim)
