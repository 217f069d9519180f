"""Seeded cases for the dense op corpus: one table for the CPU op tests
(tests/test_torch_op_test.py and tests/test_torch_ops_*.py) and for
chip_smoke.py's ops phase.  numpy only: it imports neither torch nor
JAX, so the card's script can read it.

A case names an op type, its inputs ({slot: array or [arrays], or
(array, lod) for a LoDTensor; float32 unless the op takes ints or
bools}), its attributes (over the op's
registered defaults), and a numpy reference of the forward in float64
(`ref(ins, attrs) -> {slot: array or (array, lod)}`, the slots it gives
are compared; a LoD input reaches it as (array, lod)).
`fd=False` marks an input at a kink or a tie (a threshold, |x| at 0, a
repeated maximum): there the gradient is held to `jax.vjp` only, since a
finite difference straddles the kink.  Inputs of the other cases keep
at least 0.05 away from every kink.  `random=True` marks an op whose
values are drawn: it is held by distribution.  `vjp=False` marks a host
op whose JAX lowering computes in numpy, which `jax.vjp` cannot trace
(the IfElse split and merge): its generic gradient is held to finite
differences only, and the explicit gradient op the Program runs is a
case of its own.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["Case", "CASES", "cases_of", "rng"]


class Case:
    def __init__(self, name, op, ins, attrs=None, ref=None, fd=True,
                 random=False, vjp=True):
        self.name, self.op, self.ins = name, op, ins
        self.attrs = dict(attrs or {})
        self.ref, self.fd, self.random, self.vjp = ref, fd, random, vjp

    def __repr__(self):
        return self.name


def rng(name):
    """The case's own stream: independent of the table's order."""
    return np.random.RandomState(zlib.crc32(name.encode()) & 0x7FFFFFFF)


def _f32(a):
    return np.asarray(a, np.float32)


def _away(x, points, gap=0.05):
    """x with every element within `gap` of a kink moved 2 * gap up."""
    x = np.array(x, np.float64)
    for p in points:
        near = np.abs(x - p) < gap
        x[near] = x[near] + 2 * gap
    return _f32(x)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


# -- activations (paddle_tpu/ops/activation.py:27-75, :88) -------------------

# op -> (numpy forward, input sampler(r, attrs), kinks(attrs))
_ACT = {
    "sigmoid": (lambda x, a: _sig(x), None, None),
    "logsigmoid": (lambda x, a: -np.logaddexp(0.0, -x), None, None),
    "exp": (lambda x, a: np.exp(x), None, None),
    "tanh": (lambda x, a: np.tanh(x), None, None),
    "tanh_shrink": (lambda x, a: x - np.tanh(x), None, None),
    "softshrink": (lambda x, a: np.where(
        x > a["lambda"], x - a["lambda"],
        np.where(x < -a["lambda"], x + a["lambda"], 0.0)),
        None, lambda a: [a["lambda"], -a["lambda"]]),
    "abs": (lambda x, a: np.abs(x), None, lambda a: [0.0]),
    "ceil": (lambda x, a: np.ceil(x), None,
             lambda a: list(np.arange(-4.0, 5.0))),
    "floor": (lambda x, a: np.floor(x), None,
              lambda a: list(np.arange(-4.0, 5.0))),
    "round": (lambda x, a: np.round(x), None,
              lambda a: list(np.arange(-4.5, 5.0, 0.5))),
    "reciprocal": (lambda x, a: 1.0 / x, "pos", None),
    "log": (lambda x, a: np.log(x), "pos", None),
    "softplus": (lambda x, a: np.logaddexp(x, 0.0), None, None),
    "softsign": (lambda x, a: x / (1 + np.abs(x)), None, None),
    "brelu": (lambda x, a: np.clip(x, a["t_min"], a["t_max"]), "wide",
              lambda a: [a["t_min"], a["t_max"]]),
    "leaky_relu": (lambda x, a: np.where(x > 0, x, a["alpha"] * x), None,
                   lambda a: [0.0]),
    "soft_relu": (lambda x, a: np.log1p(np.exp(
        np.clip(x, -a["threshold"], a["threshold"]))), None,
        lambda a: [a["threshold"], -a["threshold"]]),
    "elu": (lambda x, a: np.where(x > 0, x, a["alpha"] * np.expm1(x)),
            None, lambda a: [0.0]),
    "relu6": (lambda x, a: np.clip(x, 0.0, a["threshold"]), "wide",
              lambda a: [0.0, a["threshold"]]),
    "pow": (lambda x, a: np.power(x, a["factor"]), "pos", None),
    "stanh": (lambda x, a: a["scale_b"] * np.tanh(a["scale_a"] * x), None,
              None),
    "hard_shrink": (lambda x, a: np.where(np.abs(x) > a["threshold"], x,
                                          0.0), None,
                    lambda a: [a["threshold"], -a["threshold"]]),
    "thresholded_relu": (lambda x, a: np.where(x > a["threshold"], x, 0.0),
                         None, lambda a: [a["threshold"]]),
    "hard_sigmoid": (lambda x, a: np.clip(a["slope"] * x + a["offset"],
                                          0.0, 1.0), "wide",
                     lambda a: [-a["offset"] / a["slope"],
                                (1 - a["offset"]) / a["slope"]]),
    "swish": (lambda x, a: x * _sig(a["beta"] * x), None, None),
}

_ACT_DEFAULTS = {
    "softshrink": {"lambda": 0.5}, "brelu": {"t_min": 0.0, "t_max": 24.0},
    "leaky_relu": {"alpha": 0.02}, "soft_relu": {"threshold": 40.0},
    "elu": {"alpha": 1.0}, "relu6": {"threshold": 6.0},
    "pow": {"factor": 1.0},
    "stanh": {"scale_a": 2.0 / 3.0, "scale_b": 1.7159},
    "hard_shrink": {"threshold": 0.5}, "thresholded_relu": {"threshold": 1.0},
    "hard_sigmoid": {"slope": 0.2, "offset": 0.5}, "swish": {"beta": 1.0},
}

# attribute cases beside the defaults
_ACT_ATTRS = {
    "softshrink": [{"lambda": 1.2}],
    "brelu": [{"t_min": -1.0, "t_max": 1.5}],
    "leaky_relu": [{"alpha": 0.3}],
    "soft_relu": [{"threshold": 1.5}],
    "elu": [{"alpha": 0.5}],
    "relu6": [{"threshold": 2.0}],
    "pow": [{"factor": 2.5}, {"factor": -1.5}],
    "stanh": [{"scale_a": 1.5, "scale_b": 0.5}],
    "hard_shrink": [{"threshold": 1.5}],
    "thresholded_relu": [{"threshold": -0.5}],
    "hard_sigmoid": [{"slope": 0.5, "offset": 0.25}],
    "swish": [{"beta": 2.0}],
}

# inputs exactly at the kinks: held to jax.vjp, not to finite
# differences.  Ties with the JAX package's gradient: a clip bound gives
# 1/2, |x| at 0 gives 1, a `where` keeps its comparison's branch
_ACT_EDGES = {
    "brelu": [({"t_min": -1.0, "t_max": 1.0}, [-2, -1, 0, 1, 2]),
              ({}, [-1, 0, 12, 24, 30])],
    "relu6": [({}, [-1, 0, 3, 6, 7])],
    "hard_sigmoid": [({}, [-3, -2.5, 0, 2.5, 3])],
    "hard_shrink": [({}, [-0.5, -0.2, 0, 0.5, 0.7])],
    "thresholded_relu": [({}, [0, 0.5, 1, 1.5])],
    "softshrink": [({}, [-0.5, -0.2, 0, 0.5, 0.7])],
    "leaky_relu": [({}, [-1, 0, 1])],
    "elu": [({}, [-1, 0, 1])],
    "abs": [({}, [-1, 0, 1])],
    "soft_relu": [({"threshold": 1.0}, [-2, -1, 0, 1, 2])],
    "round": [({}, [-1.5, -0.5, 0.5, 1.5, 2.5])],
}


def _act_input(name, sampler, kinks, attrs):
    r = rng(name)
    if sampler == "pos":
        return _f32(r.uniform(0.2, 2.0, (3, 4)))
    scale = 3.0
    if sampler == "wide":
        hi = max(abs(k) for k in kinks(attrs))
        scale = max(3.0, 1.3 * hi)
    x = r.uniform(-scale, scale, (3, 4))
    return _away(x, kinks(attrs)) if kinks else _f32(x)


def _activation_cases():
    out = []
    for op, (fn, sampler, kinks) in _ACT.items():
        defaults = _ACT_DEFAULTS.get(op, {})
        for i, attrs in enumerate([{}] + _ACT_ATTRS.get(op, [])):
            name = f"{op}.{i}"
            a = {**defaults, **attrs}
            x = _act_input(name, sampler, kinks, a)
            out.append(Case(name, op, {"X": x}, attrs,
                            ref=lambda ins, a, fn=fn: {"Out": fn(ins["X"],
                                                                 a)}))
        for j, (attrs, xs) in enumerate(_ACT_EDGES.get(op, [])):
            out.append(Case(f"{op}.edge{j}", op, {"X": _f32(xs)}, attrs,
                            ref=lambda ins, a, fn=fn: {"Out": fn(ins["X"],
                                                                 a)},
                            fd=False))
    r = rng("prelu")
    x = _away(r.uniform(-2, 2, (3, 4)), [0.0])
    prelu = lambda ins, a: {"Out": np.where(  # noqa: E731
        ins["X"] > 0, ins["X"], ins["Alpha"].reshape(()) * ins["X"])}
    out.append(Case("prelu.0", "prelu", {"X": x, "Alpha": _f32([0.25])},
                    ref=prelu))
    out.append(Case("prelu.edge0", "prelu",
                    {"X": _f32([-1, 0, 1]), "Alpha": _f32([0.25])},
                    ref=prelu, fd=False))
    return out


# -- elementwise (paddle_tpu/ops/elementwise.py) ------------------------------

def _bcast_y(x, y, axis):
    """numpy form of the ops' axis broadcast (_broadcast_y)."""
    if x.shape == y.shape:
        return y
    axis = x.ndim - y.ndim if axis == -1 else axis
    ys = list(y.shape)
    while ys and ys[-1] == 1 and len(ys) > 1:
        ys = ys[:-1]
    return y.reshape([1] * axis + ys + [1] * (x.ndim - axis - len(ys)))


def _binary_ref(fn):
    return lambda ins, a: {"Out": fn(ins["X"], _bcast_y(ins["X"], ins["Y"],
                                                        a["axis"]))}


_COMPARE = {"less_than": np.less, "less_equal": np.less_equal,
            "greater_than": np.greater, "greater_equal": np.greater_equal,
            "equal": np.equal, "not_equal": np.not_equal}
_LOGICAL = {"logical_and": np.logical_and, "logical_or": np.logical_or,
            "logical_xor": np.logical_xor}


def _elementwise_cases():
    out = []
    r = rng("elementwise_min")
    # on grids 0.1 apart at least: no element near a tie
    out.append(Case("elementwise_min.0", "elementwise_min",
                    {"X": _f32(r.randint(-4, 5, (2, 3, 4)) * 0.25 + 0.1),
                     "Y": _f32(r.randint(-4, 5, (3, 4)) * 0.25)},
                    ref=_binary_ref(np.minimum)))
    out.append(Case("elementwise_min.1", "elementwise_min",
                    {"X": _f32(r.uniform(1, 2, (2, 3, 4))),
                     "Y": _f32(r.uniform(-1, 0, (3,)))}, {"axis": 1},
                    ref=_binary_ref(np.minimum)))
    # a tie in every other element: the cotangent splits in half
    t = _f32(r.standard_normal((3, 4)))
    u = t.copy()
    u[:, ::2] += 1.0
    out.append(Case("elementwise_min.edge0", "elementwise_min",
                    {"X": t, "Y": u}, ref=_binary_ref(np.minimum),
                    fd=False))
    r = rng("elementwise_pow")
    out.append(Case("elementwise_pow.0", "elementwise_pow",
                    {"X": _f32(r.uniform(0.5, 2, (3, 4))),
                     "Y": _f32(r.uniform(-1.5, 2, (3, 4)))},
                    ref=_binary_ref(np.power)))
    out.append(Case("elementwise_pow.1", "elementwise_pow",
                    {"X": _f32(r.uniform(0.5, 2, (2, 3, 4))),
                     "Y": _f32(r.uniform(0.5, 2, (4,)))},
                    ref=_binary_ref(np.power)))
    for op, fn in _COMPARE.items():
        r = rng(op)
        x = _f32(r.randint(-2, 3, (2, 3, 4)))
        out.append(Case(f"{op}.0", op,
                        {"X": x, "Y": _f32(r.randint(-2, 3, (3, 4)))},
                        ref=_binary_ref(fn)))
        out.append(Case(f"{op}.1", op,
                        {"X": x, "Y": _f32(r.randint(-2, 3, (3,)))},
                        {"axis": 1}, ref=_binary_ref(fn)))
    for op, fn in _LOGICAL.items():
        r = rng(op)
        out.append(Case(f"{op}.0", op,
                        {"X": r.rand(3, 4) > 0.5, "Y": r.rand(3, 4) > 0.5},
                        ref=lambda ins, a, fn=fn: {"Out": fn(ins["X"],
                                                             ins["Y"])}))
    r = rng("logical_not")
    out.append(Case("logical_not.0", "logical_not",
                    {"X": r.rand(3, 4) > 0.5},
                    ref=lambda ins, a: {"Out": np.logical_not(ins["X"])}))
    return out


# -- matmul (paddle_tpu/ops/matmul.py:41-86) ----------------------------------

def _matmul_ref(ins, a):
    x, y = ins["X"], ins["Y"]
    tx, ty = a["transpose_X"], a["transpose_Y"]
    sq_first = sq_last = False
    if x.ndim == 1:
        x, tx, sq_first = (x[:, None] if tx else x[None, :]), False, True
    if y.ndim == 1:
        y, ty, sq_last = (y[None, :] if ty else y[:, None]), False, True
    if tx:
        x = np.swapaxes(x, -1, -2)
    if ty:
        y = np.swapaxes(y, -1, -2)
    out = np.matmul(x, y) * a["alpha"]
    if sq_first:
        out = out.squeeze(-2)
    if sq_last:
        out = out.squeeze(-1)
    return {"Out": out}


_MATMUL = [
    ((3, 4), (4, 5), {}),
    ((4, 3), (4, 5), {"transpose_X": True}),
    ((3, 4), (5, 4), {"transpose_Y": True, "alpha": 0.5}),
    ((2, 4, 3), (2, 5, 4), {"transpose_X": True, "transpose_Y": True}),
    ((2, 3, 3, 4), (4, 5), {}),
    ((2, 1, 3, 4), (3, 4, 2), {}),
    ((4,), (4, 5), {}),
    ((3, 4), (4,), {}),
    ((4,), (4,), {}),
    ((2, 3, 4), (4,), {"alpha": 2.0}),
]


def _matmul_cases():
    out = []
    for i, (xs, ys, attrs) in enumerate(_MATMUL):
        r = rng(f"matmul.{i}")
        out.append(Case(f"matmul.{i}", "matmul",
                        {"X": _f32(r.standard_normal(xs)),
                         "Y": _f32(r.standard_normal(ys))}, attrs,
                        ref=_matmul_ref))
    bilinear = lambda ins, a: {"Out": np.einsum(  # noqa: E731
        "bm,kmn,bn->bk", ins["X"], ins["Weight"], ins["Y"])
        + (ins["Bias"] if "Bias" in ins else 0.0)}
    r = rng("bilinear_tensor_product")
    base = {"X": _f32(r.standard_normal((4, 3))),
            "Y": _f32(r.standard_normal((4, 5))),
            "Weight": _f32(r.standard_normal((2, 3, 5)))}
    out.append(Case("bilinear_tensor_product.0", "bilinear_tensor_product",
                    base, ref=bilinear))
    out.append(Case("bilinear_tensor_product.1", "bilinear_tensor_product",
                    {**base, "Bias": _f32(r.standard_normal((1, 2)))},
                    ref=bilinear))
    return out


# -- reductions (paddle_tpu/ops/reduce.py) ------------------------------------

def _reduce_ref(fn):
    def ref(ins, a):
        x = ins["X"]
        if a["reduce_all"]:
            out = fn(x, axis=None, keepdims=a["keep_dim"])
        else:
            out = fn(x, axis=tuple(d if d >= 0 else d + x.ndim
                                   for d in a["dim"]),
                     keepdims=a["keep_dim"])
        out = np.asarray(out)
        return {"Out": out.reshape(1) if out.ndim == 0 else out}
    return ref


_REDUCE = {"reduce_mean": np.mean, "reduce_max": np.max,
           "reduce_min": np.min, "reduce_prod": np.prod}
_REDUCE_ATTRS = [{"dim": [1]}, {"dim": [0, 2], "keep_dim": True},
                 {"reduce_all": True}, {"dim": [-1]},
                 {"reduce_all": True, "keep_dim": True}]


def _cumsum_ref(ins, a):
    x, ax = ins["X"], a["axis"]
    if a["reverse"]:
        x = np.flip(x, ax)
    out = np.cumsum(x, axis=ax)
    if a["exclusive"]:
        out = out - x
    if a["reverse"]:
        out = np.flip(out, ax)
    return {"Out": out}


def _maxout_ref(ins, a):
    x = ins["X"]
    n, c, h, w = x.shape
    g = a["groups"]
    return {"Out": x.reshape(n, c // g, g, h, w).max(axis=2)}


def _reduce_cases():
    out = []
    for op, fn in _REDUCE.items():
        for i, attrs in enumerate(_REDUCE_ATTRS):
            r = rng(f"{op}.{i}")
            x = (r.uniform(0.6, 1.5, (2, 3, 4)) if op == "reduce_prod"
                 else r.permutation(24).reshape(2, 3, 4) * 0.25
                 + r.uniform(-0.05, 0.05, (2, 3, 4)))
            out.append(Case(f"{op}.{i}", op, {"X": _f32(x)},
                            {"dim": [0], "keep_dim": False,
                             "reduce_all": False, **attrs},
                            ref=_reduce_ref(fn)))
    ties = _f32([[[1, 3, 3, 0], [2, 2, 2, 2], [5, -1, 5, 5]],
                 [[0, 0, 0, 0], [-4, 7, 7, 1], [3, 3, -2, -2]]])
    for op in ("reduce_max", "reduce_min"):
        for i, attrs in enumerate([{"dim": [-1]}, {"dim": [0, 2]},
                                   {"reduce_all": True}]):
            out.append(Case(f"{op}.ties{i}", op, {"X": ties},
                            {"dim": [0], "keep_dim": False,
                             "reduce_all": False, **attrs},
                            ref=_reduce_ref(_REDUCE[op]), fd=False))
    r = rng("cumsum")
    x = _f32(r.standard_normal((3, 4)))
    for i, attrs in enumerate([{}, {"axis": 0, "exclusive": True},
                               {"reverse": True},
                               {"axis": 0, "exclusive": True,
                                "reverse": True}]):
        out.append(Case(f"cumsum.{i}", "cumsum", {"X": x},
                        attrs, ref=_cumsum_ref))
    out.append(Case("l1_norm.0", "l1_norm",
                    {"X": _away(r.standard_normal((3, 4)), [0.0])},
                    ref=lambda ins, a: {"Out": np.abs(ins["X"]).sum()
                                        .reshape(1)}))
    out.append(Case("l1_norm.edge0", "l1_norm", {"X": _f32([-1, 0, 2])},
                    ref=lambda ins, a: {"Out": np.abs(ins["X"]).sum()
                                        .reshape(1)}, fd=False))
    out.append(Case("squared_l2_norm.0", "squared_l2_norm",
                    {"X": _f32(r.standard_normal((3, 4)))},
                    ref=lambda ins, a: {"Out": np.square(ins["X"]).sum()
                                        .reshape(1)}))
    sqd = lambda ins, a: {  # noqa: E731
        "sub_result": ins["X"] - ins["Y"],
        "Out": np.square(ins["X"] - ins["Y"]).sum(axis=1).reshape(-1, 1)}
    out.append(Case("squared_l2_distance.0", "squared_l2_distance",
                    {"X": _f32(r.standard_normal((4, 3))),
                     "Y": _f32(r.standard_normal((4, 3)))}, ref=sqd))
    out.append(Case("squared_l2_distance.1", "squared_l2_distance",
                    {"X": _f32(r.standard_normal((4, 3))),
                     "Y": _f32(r.standard_normal((1, 3)))}, ref=sqd))
    norm = lambda ins, a: {"Out": ins["X"] / np.sqrt(  # noqa: E731
        np.square(ins["X"]).sum(axis=1, keepdims=True) + a["epsilon"])
        * ins["Scale"].reshape(1, -1, 1, 1)}
    out.append(Case("norm.0", "norm",
                    {"X": _f32(r.standard_normal((2, 3, 2, 2))),
                     "Scale": _f32(r.uniform(0.5, 2, (3,)))}, ref=norm))
    for i, axis in enumerate((-1, 0)):
        out.append(Case(f"argmax.{i}", "argmax",
                        {"X": _f32(r.randint(0, 4, (3, 5)))}, {"axis": axis},
                        ref=lambda ins, a: {"Out": np.argmax(
                            ins["X"], axis=a["axis"])}))
    mx = r.permutation(32).reshape(2, 4, 2, 2) * 0.25
    out.append(Case("maxout.0", "maxout", {"X": _f32(mx)}, {"groups": 2},
                    ref=_maxout_ref))
    out.append(Case("maxout.1", "maxout", {"X": _f32(mx)}, {"groups": 4},
                    ref=_maxout_ref))
    return out


# -- manipulation (paddle_tpu/ops/manip.py) -----------------------------------

def _pad_ref(ins, a):
    p = a["paddings"]
    return {"Out": np.pad(ins["X"], [(p[2 * i], p[2 * i + 1])
                                     for i in range(ins["X"].ndim)],
                          constant_values=a["pad_value"])}


def _crop_ref(ins, a):
    x = ins["X"]
    shape = ins["Y"].shape if "Y" in ins else tuple(a["shape"])
    offs = a["offsets"] or [0] * x.ndim
    idx = tuple(slice(min(max(o, 0), d - n), min(max(o, 0), d - n) + n)
                for o, d, n in zip(offs, x.shape, shape))
    return {"Out": x[idx]}


def _split_ref(ins, a):
    x = ins["X"]
    if a["sections"]:
        parts = np.split(x, np.cumsum(a["sections"])[:-1], axis=a["axis"])
    else:
        parts = np.split(x, a["num"], axis=a["axis"])
    return {"Out": parts}


def _manip_cases():
    r = rng("manip")
    x3 = _f32(r.standard_normal((2, 3, 4)))
    out = [
        Case("transpose.0", "transpose", {"X": x3}, {"axis": [0, 2, 1]},
             ref=lambda ins, a: {"Out": np.transpose(ins["X"], a["axis"])}),
        Case("transpose.1", "transpose", {"X": x3}, {"axis": []},
             ref=lambda ins, a: {"Out": np.transpose(ins["X"])}),
        Case("split.0", "split", {"X": x3}, {"axis": 2, "num": 2},
             ref=_split_ref),
        Case("split.1", "split", {"X": x3}, {"axis": 1, "sections": [1, 2]},
             ref=_split_ref),
        Case("expand.0", "expand", {"X": x3}, {"expand_times": [2, 1, 3]},
             ref=lambda ins, a: {"Out": np.tile(ins["X"],
                                                a["expand_times"])}),
        Case("pad.0", "pad", {"X": x3},
             {"paddings": [1, 0, 0, 2, 1, 1], "pad_value": 0.5},
             ref=_pad_ref),
        Case("crop.0", "crop", {"X": x3, "Y": _f32(np.zeros((1, 2, 3)))},
             {"offsets": [1, 1, 0]}, ref=_crop_ref),
        Case("crop.1", "crop", {"X": x3},
             {"offsets": [0, 2, 3], "shape": [2, 2, 2]}, ref=_crop_ref),
        Case("gather.0", "gather",
             {"X": _f32(r.standard_normal((5, 3))),
              "Index": np.array([3, 0, 3, 1], np.int64)},
             ref=lambda ins, a: {"Out": ins["X"][ins["Index"]]}),
        Case("scatter.0", "scatter",
             {"X": _f32(r.standard_normal((5, 3))),
              "Ids": np.array([4, 1], np.int64),
              "Updates": _f32(r.standard_normal((2, 3)))},
             ref=lambda ins, a: {"Out": _scatter(ins)}),
        Case("unsqueeze.0", "unsqueeze", {"X": x3}, {"axes": [3, 0]},
             ref=lambda ins, a: {"Out": ins["X"][None, :, :, None, :]}),
        Case("squeeze.0", "squeeze",
             {"X": _f32(r.standard_normal((2, 1, 3, 1)))}, {"axes": [1]},
             ref=lambda ins, a: {"Out": ins["X"].squeeze(1)}),
        Case("squeeze.1", "squeeze",
             {"X": _f32(r.standard_normal((2, 1, 3, 1)))},
             ref=lambda ins, a: {"Out": ins["X"].squeeze()}),
        Case("stack.0", "stack",
             {"X": [_f32(r.standard_normal((2, 3))) for _ in range(3)]},
             {"axis": 1},
             ref=lambda ins, a: {"Out": np.stack(ins["X"], axis=1)}),
        Case("flatten.0", "flatten", {"X": x3}, {"axis": 2},
             ref=lambda ins, a: {"Out": ins["X"].reshape(6, 4)}),
        Case("flatten.1", "flatten", {"X": x3}, {"axis": 0},
             ref=lambda ins, a: {"Out": ins["X"].reshape(1, 24)}),
        Case("reverse.0", "reverse", {"X": x3}, {"axis": [0, 2]},
             ref=lambda ins, a: {"Out": np.flip(ins["X"], (0, 2))}),
        Case("reverse.1", "reverse", {"X": x3}, {"axis": 1},
             ref=lambda ins, a: {"Out": np.flip(ins["X"], 1)}),
    ]
    return out


def _scatter(ins):
    out = ins["X"].copy()
    out[ins["Ids"]] = ins["Updates"]
    return out


# -- creation (paddle_tpu/ops/creation.py) ------------------------------------

def _one_hot_ref(ins, a):
    x = ins["X"]
    if x.ndim > 1 and x.shape[-1] == 1:
        x = x[..., 0]
    return {"Out": (x[..., None] == np.arange(a["depth"])).astype(
        np.float32)}


def _creation_cases():
    r = rng("creation")
    x = _f32(r.uniform(-3, 3, (3, 4)))
    cast = lambda ins, a: {"Out": ins["X"].astype(  # noqa: E731
        a["out_dtype"])}
    vals = [float(v) for v in r.standard_normal(6).astype(np.float32)]
    return [
        # a cast to float32 or bf16 rounds below a finite difference's
        # step: its gradient is held by the float64 case and jax.vjp
        Case("cast.0", "cast", {"X": x}, {"out_dtype": "float32"}, ref=cast,
             fd=False),
        Case("cast.5", "cast", {"X": x}, {"out_dtype": "float64"}, ref=cast),
        Case("cast.1", "cast", {"X": x}, {"out_dtype": "int32"}, ref=cast),
        Case("cast.2", "cast", {"X": np.array([[3, -1], [0, 7]], np.int64)},
             {"out_dtype": "float32"}, ref=cast),
        Case("cast.3", "cast", {"X": x}, {"out_dtype": "bfloat16"},
             fd=False),
        Case("cast.4", "cast", {"X": r.rand(2, 3) > 0.5},
             {"out_dtype": "float32"}, ref=cast),
        Case("assign_value.0", "assign_value", {},
             {"shape": [2, 3], "dtype": "float32", "values": vals},
             ref=lambda ins, a: {"Out": np.asarray(a["values"]).reshape(
                 2, 3)}),
        Case("assign_value.1", "assign_value", {},
             {"shape": [4], "dtype": "int32", "values": [3, -2, 0, 9]},
             ref=lambda ins, a: {"Out": np.asarray(a["values"])}),
        Case("one_hot.0", "one_hot",
             {"X": np.array([[1], [0], [4], [7], [-1]], np.int64)},
             {"depth": 5}, ref=_one_hot_ref),
        Case("one_hot.1", "one_hot", {"X": np.array([2, 0, 1], np.int64)},
             {"depth": 3}, ref=_one_hot_ref),
        Case("shape.0", "shape", {"Input": _f32(np.zeros((2, 3, 4)))},
             ref=lambda ins, a: {"Out": np.array([2, 3, 4])}),
        Case("isfinite.0", "isfinite", {"X": [x, x[:1]]},
             ref=lambda ins, a: {"Out": np.array(True)}),
        Case("isfinite.1", "isfinite",
             {"X": [x, _f32([1.0, np.inf])]},
             ref=lambda ins, a: {"Out": np.array(False)}),
        Case("isfinite.2", "isfinite", {"X": [_f32([np.nan, 1.0])]},
             ref=lambda ins, a: {"Out": np.array(False)}),
        Case("fill_constant_batch_size_like.0",
             "fill_constant_batch_size_like",
             {"Input": _f32(np.zeros((5, 3)))},
             {"shape": [-1, 7], "value": 1.5},
             ref=lambda ins, a: {"Out": np.full((5, 7), 1.5)}),
        Case("fill_constant_batch_size_like.1",
             "fill_constant_batch_size_like",
             {"Input": _f32(np.zeros((5, 3)))},
             {"shape": [2, -1], "value": -4.0, "dtype": "int64",
              "input_dim_idx": 1, "output_dim_idx": 1},
             ref=lambda ins, a: {"Out": np.full((2, 3), -4)}),
        Case("uniform_random_batch_size_like.0",
             "uniform_random_batch_size_like",
             {"Input": _f32(np.zeros((4000, 3)))},
             {"shape": [-1, 50], "min": -2.0, "max": 3.0}, random=True),
    ]


# -- losses (paddle_tpu/ops/loss.py) ------------------------------------------

def _smooth_l1_ref(ins, a):
    s2 = a["sigma"] ** 2
    diff = ins["X"] - ins["Y"]
    if "InsideWeight" in ins:
        diff = diff * ins["InsideWeight"]
    ad = np.abs(diff)
    val = np.where(ad < 1.0 / s2, 0.5 * s2 * diff ** 2, ad - 0.5 / s2)
    if "OutsideWeight" in ins:
        val = val * ins["OutsideWeight"]
    return {"Diff": diff, "Out": val.sum(axis=1).reshape(-1, 1)}


def _huber_ref(ins, a):
    r = ins["Y"] - ins["X"]
    d = a["delta"]
    return {"Residual": r,
            "Out": np.where(np.abs(r) <= d, 0.5 * r * r,
                            d * (np.abs(r) - 0.5 * d))}


def _modified_huber_ref(ins, a):
    z = (2 * ins["Y"] - 1) * ins["X"]
    return {"IntermediateVal": z,
            "Out": np.where(z < -1, -4 * z,
                            np.where(z < 1, (1 - z) ** 2, 0.0))}


def _loss_cases():
    r = rng("loss")
    bits = lambda *s: _f32(r.randint(0, 2, s))  # noqa: E731
    sce = lambda ins, a: {"Out": np.maximum(ins["X"], 0)  # noqa: E731
                          - ins["X"] * ins["Label"]
                          + np.log1p(np.exp(-np.abs(ins["X"])))}
    hinge = lambda ins, a: {"Loss": np.maximum(  # noqa: E731
        1 - (2 * ins["Labels"] - 1) * ins["Logits"], 0)}
    margin = lambda ins, a: {  # noqa: E731
        "Out": np.maximum(-ins["Label"] * (ins["X1"] - ins["X2"])
                          + a["margin"], 0)}
    logits = _away(r.uniform(-3, 3, (6, 1)), [-1.0, 1.0])
    y_h = bits(6, 1)
    x_mh = _away(r.uniform(-3, 3, (8, 1)), [-1.0, 1.0])
    x1, x2 = _f32(r.standard_normal((5, 1))), _f32(r.standard_normal((5, 1)))
    lbl_m = _f32(np.where(r.rand(5, 1) > 0.5, 1.0, -1.0))
    x2 = _f32(np.where(np.abs(-lbl_m * (x1 - x2) + 0.1) < 0.05, x2 + 0.3,
                       x2))
    hx = _f32(r.standard_normal((5, 1)))
    hy = _f32(hx + _away(r.uniform(-2, 2, (5, 1)), [-1.0, 1.0, -0.5, 0.5]))
    return [
        Case("sigmoid_cross_entropy_with_logits.0",
             "sigmoid_cross_entropy_with_logits",
             {"X": _away(r.uniform(-3, 3, (4, 5)), [0.0]),
              "Label": _f32(r.rand(4, 5))}, ref=sce),
        Case("sigmoid_cross_entropy_with_logits.edge0",
             "sigmoid_cross_entropy_with_logits",
             {"X": _f32([[0.0, -1.0, 2.0]]), "Label": _f32([[1, 0, 1]])},
             ref=sce, fd=False),
        Case("hinge_loss.0", "hinge_loss",
             {"Logits": logits, "Labels": y_h}, ref=hinge),
        Case("hinge_loss.edge0", "hinge_loss",
             {"Logits": _f32([[1.0], [-1.0], [0.5]]),
              "Labels": _f32([[1], [0], [1]])}, ref=hinge, fd=False),
        Case("huber_loss.0", "huber_loss", {"X": hx, "Y": hy}, ref=_huber_ref),
        Case("huber_loss.1", "huber_loss", {"X": hx, "Y": hy},
             {"delta": 0.5}, ref=_huber_ref),
        Case("log_loss.0", "log_loss",
             {"Predicted": _f32(r.uniform(0.05, 0.95, (6, 1))),
              "Labels": bits(6, 1)},
             ref=lambda ins, a: {"Loss": -ins["Labels"] * np.log(
                 ins["Predicted"] + a["epsilon"]) - (1 - ins["Labels"])
                 * np.log(1 - ins["Predicted"] + a["epsilon"])}),
        Case("margin_rank_loss.0", "margin_rank_loss",
             {"X1": x1, "X2": x2, "Label": lbl_m}, {"margin": 0.1},
             ref=margin),
        Case("modified_huber_loss.0", "modified_huber_loss",
             {"X": x_mh, "Y": bits(8, 1)}, ref=_modified_huber_ref),
        Case("rank_loss.0", "rank_loss",
             {"Label": bits(5, 1), "Left": _f32(r.standard_normal((5, 1))),
              "Right": _f32(r.standard_normal((5, 1)))},
             ref=lambda ins, a: {"Out": np.log1p(np.exp(
                 ins["Left"] - ins["Right"])) - ins["Label"]
                 * (ins["Left"] - ins["Right"])}),
        Case("smooth_l1_loss.0", "smooth_l1_loss",
             {"X": _f32(r.standard_normal((4, 3))),
              "Y": _f32(r.standard_normal((4, 3)))}, {"sigma": 2.0},
             ref=_smooth_l1_ref),
        Case("smooth_l1_loss.1", "smooth_l1_loss",
             {"X": _f32(r.standard_normal((4, 3))),
              "Y": _f32(r.standard_normal((4, 3))),
              "InsideWeight": _f32(r.uniform(0.5, 1.5, (4, 3))),
              "OutsideWeight": _f32(r.uniform(0.5, 1.5, (4, 3)))},
             ref=_smooth_l1_ref),
    ]


# -- metrics (paddle_tpu/ops/metrics.py) --------------------------------------

def _auc_ref(ins, a):
    pos = ins["Out"][:, -1]
    is_pos = ins["Label"].reshape(-1) > 0
    thr = np.linspace(0.0, 1.0, a["num_thresholds"], dtype=np.float32)
    pred = pos[None, :] > thr[:, None]
    tp = (pred & is_pos).sum(axis=1)
    fp = (pred & ~is_pos).sum(axis=1)
    tpr = tp / max(is_pos.sum(), 1)
    fpr = fp / max((~is_pos).sum(), 1)
    return {"AUC": np.array([np.sum((fpr[:-1] - fpr[1:])
                                    * (tpr[:-1] + tpr[1:]) / 2)])}


def _pr_metrics(s):
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rc = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(p + rc > 0, 2 * p * rc / (p + rc), 0.0)
    mp = tp.sum() / max((tp + fp).sum(), 1e-9)
    mr = tp.sum() / max((tp + fn).sum(), 1e-9)
    mf = 2 * mp * mr / (mp + mr) if mp + mr > 0 else 0.0
    return np.array([p.mean(), rc.mean(), f1.mean(), mp, mr, mf])


def _pr_ref(ins, a):
    c = a["class_number"]
    idx = ins["Indices"].reshape(-1)
    lbl = ins["Labels"].reshape(-1)
    w = (ins["Weights"].reshape(-1) if "Weights" in ins
         else np.ones(len(idx)))
    st = np.zeros((c, 4))
    for i, l, wi in zip(idx, lbl, w):
        for k in range(c):
            if i == k and l == k:
                st[k, 0] += wi
            elif i == k:
                st[k, 1] += wi
            elif l == k:
                st[k, 3] += wi
            else:
                st[k, 2] += wi
    acc = st + ins["StatesInfo"] if "StatesInfo" in ins else st
    return {"BatchMetrics": _pr_metrics(st), "AccumMetrics": _pr_metrics(acc),
            "AccumStatesInfo": acc}


def _pnp_ref(ins, a):
    s = ins["Score"][:, a["column"]]
    lbl, q = ins["Label"].reshape(-1), ins["QueryID"].reshape(-1)
    w = ins["Weight"].reshape(-1) if "Weight" in ins else np.ones(len(s))
    pos = neg = neu = 0.0
    for i in range(len(s)):
        for j in range(i + 1, len(s)):
            if q[i] != q[j] or lbl[i] == lbl[j]:
                continue
            wij = (w[i] + w[j]) / 2
            if (s[i] - s[j]) * (lbl[i] - lbl[j]) > 0:
                pos += wij
            else:
                neg += wij
            if s[i] == s[j]:
                neu += wij
    if "AccumulatePositivePair" in ins:
        pos += ins["AccumulatePositivePair"][0]
        neg += ins["AccumulateNegativePair"][0]
        neu += ins["AccumulateNeutralPair"][0]
    return {"PositivePair": np.array([pos]), "NegativePair": np.array([neg]),
            "NeutralPair": np.array([neu])}


def _metric_cases():
    r = rng("metrics")
    p1 = r.rand(20)
    probs = _f32(np.stack([1 - p1, p1], axis=1))
    auc_ins = {"Out": probs, "Indices": np.zeros((20, 1), np.int64),
               "Label": r.randint(0, 2, (20, 1)).astype(np.int64)}
    pr = {"MaxProbs": _f32(r.rand(10, 1)),
          "Indices": r.randint(0, 3, (10, 1)).astype(np.int64),
          "Labels": r.randint(0, 3, (10, 1)).astype(np.int64)}
    score = _f32(np.round(r.rand(12, 2) * 4) / 4)     # ties within queries
    pnp = {"Score": score, "Label": _f32(r.randint(0, 3, (12, 1))),
           "QueryID": np.repeat(np.arange(3), 4).reshape(12, 1)
           .astype(np.int64)}
    return [
        Case("auc.0", "auc", auc_ins, ref=_auc_ref),
        Case("auc.1", "auc", auc_ins, {"num_thresholds": 50}, ref=_auc_ref),
        Case("precision_recall.0", "precision_recall", pr,
             {"class_number": 3}, ref=_pr_ref),
        Case("precision_recall.1", "precision_recall",
             {**pr, "Weights": _f32(r.uniform(0.5, 2, (10, 1))),
              "StatesInfo": _f32(r.randint(0, 5, (3, 4)))},
             {"class_number": 3}, ref=_pr_ref),
        Case("positive_negative_pair.0", "positive_negative_pair", pnp,
             {"column": 0}, ref=_pnp_ref),
        Case("positive_negative_pair.1", "positive_negative_pair",
             {**pnp, "Weight": _f32(r.uniform(0.5, 2, (12, 1))),
              "AccumulatePositivePair": _f32([1.5]),
              "AccumulateNegativePair": _f32([2.0]),
              "AccumulateNeutralPair": _f32([0.5])},
             {"column": 1}, ref=_pnp_ref),
    ]


# -- misc (paddle_tpu/ops/misc.py) --------------------------------------------

def _cos_sim_ref(ins, a):
    x, y = ins["X"], ins["Y"]
    xn = np.sqrt((x * x).sum(-1, keepdims=True))
    yn = np.sqrt((y * y).sum(-1, keepdims=True))
    return {"Out": (x * y).sum(-1, keepdims=True) / (xn * yn),
            "XNorm": xn, "YNorm": yn}


def _label_smooth_ref(ins, a):
    x, e = ins["X"], a["epsilon"]
    prior = ins["PriorDist"].reshape(1, -1) if "PriorDist" in ins \
        else 1.0 / x.shape[-1]
    return {"Out": (1 - e) * x + e * prior}


def _misc_cases():
    r = rng("misc")
    xs = [_f32(r.standard_normal((4, 5))) for _ in range(3)]
    onehot = _f32(np.eye(5)[r.randint(0, 5, 4)])
    return [
        Case("cos_sim.0", "cos_sim",
             {"X": xs[0], "Y": xs[1]}, ref=_cos_sim_ref),
        Case("cos_sim.1", "cos_sim",
             {"X": xs[0], "Y": _f32(r.standard_normal((1, 5)))},
             ref=_cos_sim_ref),
        Case("sign.0", "sign", {"X": _away(r.standard_normal((3, 4)), [0.0])},
             ref=lambda ins, a: {"Out": np.sign(ins["X"])}),
        Case("sign.edge0", "sign", {"X": _f32([-2, 0, 3])},
             ref=lambda ins, a: {"Out": np.sign(ins["X"])}, fd=False),
        Case("minus.0", "minus", {"X": xs[0], "Y": xs[1]},
             ref=lambda ins, a: {"Out": ins["X"] - ins["Y"]}),
        Case("fill.0", "fill", {},
             {"shape": [2, 3], "value": [1.5, -2, 0, 4, 0.25, 7]},
             ref=lambda ins, a: {"Out": np.asarray(a["value"]).reshape(
                 2, 3)}),
        Case("fill.1", "fill", {},
             {"shape": [3], "value": [4, 0, -1], "dtype": "int64"},
             ref=lambda ins, a: {"Out": np.asarray(a["value"])}),
        Case("label_smooth.0", "label_smooth", {"X": onehot},
             {"epsilon": 0.1}, ref=_label_smooth_ref),
        Case("label_smooth.1", "label_smooth",
             {"X": onehot, "PriorDist": _f32(r.dirichlet(np.ones(5)))},
             {"epsilon": 0.2}, ref=_label_smooth_ref),
        Case("multiplex.0", "multiplex",
             {"Ids": np.array([[2], [0], [1], [2]], np.int64), "X": xs},
             ref=lambda ins, a: {"Out": np.stack(ins["X"])[
                 ins["Ids"].reshape(-1), np.arange(4)]}),
        Case("is_empty.0", "is_empty", {"X": _f32(np.zeros((0, 3)))},
             ref=lambda ins, a: {"Out": np.array(True)}),
        Case("is_empty.1", "is_empty", {"X": xs[0]},
             ref=lambda ins, a: {"Out": np.array(False)}),
        Case("print.0", "print", {"In": xs[0]},
             {"print_tensor_name": False, "message": "op-case"},
             ref=lambda ins, a: {"Out": ins["In"]}),
    ]


# -- LoD sequences and recurrences (paddle_tpu/ops/sequence.py, rnn.py,
# metrics.py edit_distance) ---------------------------------------------------

def _lens(lod):
    return np.diff(np.asarray(lod, np.int64))


def _segments(x, lod):
    return [x[lod[i]:lod[i + 1]] for i in range(len(lod) - 1)]


def _pool_ref(ins, a):
    x, lods = ins["X"]
    lod, pt = lods[-1], a["pooltype"].upper()
    out = []
    for seg in _segments(x, lod):
        n = max(len(seg), 1)
        if pt == "MAX":
            out.append(seg.max(0) if len(seg) else
                       np.full(x.shape[1:], np.finfo(np.float32).min))
        elif pt == "LAST":
            out.append(seg[-1])
        elif pt == "FIRST":
            out.append(seg[0])
        else:
            div = {"SUM": 1.0, "AVERAGE": n, "SQRT": np.sqrt(n)}[pt]
            out.append(seg.sum(0) / div)
    out = np.stack(out)
    return {"Out": (out, lods[:-1]) if len(lods) > 1 else out}


def _softmax_ref(ins, a):
    x, lods = ins["X"]
    out = np.concatenate([np.exp(s - s.max()) / np.exp(s - s.max()).sum()
                          for s in _segments(x.reshape(-1), lods[-1])])
    return {"Out": (out.reshape(x.shape), lods)}


def _expand_ref(ins, a):
    x = ins["X"][0] if isinstance(ins["X"], tuple) else ins["X"]
    y, ylods = ins["Y"]
    return {"Out": (np.repeat(x, _lens(ylods[-1]), axis=0), ylods)}


def _seq_concat_ref(ins, a):
    (x0, l0), (x1, l1) = ins["X"]
    parts, lens = [], []
    for s0, s1 in zip(_segments(x0, l0[-1]), _segments(x1, l1[-1])):
        parts += [s0, s1]
        lens.append(len(s0) + len(s1))
    return {"Out": (np.concatenate(parts), [list(np.cumsum([0] + lens))])}


def _erase_ref(ins, a):
    x, lods = ins["X"]
    keep = [s[~np.isin(s.reshape(-1), a["tokens"])]
            for s in _segments(x, lods[-1])]
    return {"Out": (np.concatenate(keep),
                    [list(np.cumsum([0] + [len(k) for k in keep]))])}


def _slice_ref(ins, a):
    x, lods = ins["X"]
    off, ln = ins["Offset"].reshape(-1), ins["Length"].reshape(-1)
    segs = _segments(x, lods[-1])
    return {"Out": (np.concatenate([s[o:o + n] for s, o, n in
                                    zip(segs, off, ln)]),
                    [list(np.cumsum([0] + list(ln)))])}


def _seq_conv_ref(ins, a):
    x, lods = ins["X"]
    w, c_len, c_start = ins["Filter"], a["contextLength"], a["contextStart"]
    rows = []
    for lo, hi in zip(lods[-1][:-1], lods[-1][1:]):
        for r in range(lo, hi):
            ctx = [x[r + c_start + j] if lo <= r + c_start + j < hi
                   else np.zeros(x.shape[1]) for j in range(c_len)]
            rows.append(np.concatenate(ctx))
    return {"Out": (np.stack(rows) @ w, lods)}


def _seq_pad_ref(ins, a):
    x, lods = ins["X"]
    segs = _segments(x, lods[-1])
    t = max(a["padded_length"], max(len(s) for s in segs))
    out = np.full((len(segs), t) + x.shape[1:], a["pad_value"])
    for i, s in enumerate(segs):
        out[i, :len(s)] = s
    return {"Out": out, "Length": _lens(lods[-1])}


def _unpad_ref(ins, a):
    x, lens = ins["X"], ins["Length"].reshape(-1)
    return {"Out": (np.concatenate([x[i, :n] for i, n in enumerate(lens)]),
                    [list(np.cumsum([0] + list(lens)))])}


def _edit_ref(ins, a):
    out = []
    for h, r in zip(_segments(ins["Hyps"][0].reshape(-1), ins["Hyps"][1][0]),
                    _segments(ins["Refs"][0].reshape(-1),
                              ins["Refs"][1][0])):
        d = np.arange(len(r) + 1, dtype=np.float64)
        for i in range(1, len(h) + 1):
            prev, d[0] = d.copy(), i
            for j in range(1, len(r) + 1):
                d[j] = min(prev[j] + 1, d[j - 1] + 1,
                           prev[j - 1] + (h[i - 1] != r[j - 1]))
        out.append(d[-1] / len(r) if a["normalized"] and len(r) else d[-1])
    return {"Out": np.asarray(out).reshape(-1, 1),
            "SequenceNum": np.asarray([len(out)])}


def _lstm_unit_ref(ins, a):
    gi, gf, go, gc = np.split(ins["X"], 4, axis=1)
    c = _sig(gf + a["forget_bias"]) * ins["C_prev"] + _sig(gi) * np.tanh(gc)
    return {"C": c, "H": _sig(go) * np.tanh(c)}


def _gru_unit_ref(ins, a):
    x = ins["Input"] + ins["Bias"].reshape(-1)
    h, w = ins["HiddenPrev"], ins["Weight"]
    d = h.shape[1]
    ur = _sig(x[:, :2 * d] + h @ w[:, :2 * d])
    u, r = ur[:, :d], ur[:, d:]
    cand = np.tanh(x[:, 2 * d:] + (r * h) @ w[:, 2 * d:])
    return {"Gate": np.concatenate([u, r, cand], 1), "ResetHiddenPrev": r * h,
            "Hidden": h + u * (cand - h)}


def _sequence_cases():
    r = rng("sequence")
    lod = [[0, 2, 5, 9]]
    x = _f32(r.standard_normal((9, 3)))
    empty = [[0, 3, 3, 7]]
    xe = _f32(r.standard_normal((7, 2)))
    ties = _f32([[1, 2], [3, 2], [3, 0], [-1, 5], [-1, 5], [0, 0]])
    nested = [[0, 2, 3], [0, 2, 5, 9]]
    cases = []
    for pt in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        cases.append(Case(f"sequence_pool.{pt.lower()}", "sequence_pool",
                          {"X": (x, lod)}, {"pooltype": pt}, ref=_pool_ref))
    cases += [
        Case("sequence_pool.max_ties", "sequence_pool",
             {"X": (ties, [[0, 3, 6]])}, {"pooltype": "MAX"}, ref=_pool_ref,
             fd=False),
        Case("sequence_pool.max_empty", "sequence_pool",
             {"X": (xe, empty)}, {"pooltype": "MAX"}, ref=_pool_ref,
             fd=False),
        Case("sequence_pool.sum_empty", "sequence_pool",
             {"X": (xe, empty)}, {"pooltype": "SUM"}, ref=_pool_ref),
        Case("sequence_pool.average_nested", "sequence_pool",
             {"X": (x, nested)}, {"pooltype": "AVERAGE"}, ref=_pool_ref),
        Case("sequence_softmax.0", "sequence_softmax",
             {"X": (_f32(r.standard_normal((9, 1))), lod)},
             ref=_softmax_ref),
        Case("sequence_expand.0", "sequence_expand",
             {"X": _f32(r.standard_normal((3, 2))),
              "Y": (_f32(np.zeros((6, 1))), [[0, 1, 4, 6]])},
             ref=_expand_ref),
        Case("sequence_expand.2level", "sequence_expand",
             {"X": (_f32(r.standard_normal((3, 2))), [[0, 1, 3]]),
              "Y": (_f32(np.zeros((7, 1))), [[0, 2, 3], [0, 3, 4, 7]])},
             ref=_expand_ref),
        Case("sequence_concat.0", "sequence_concat",
             {"X": [(_f32(r.standard_normal((4, 2))), [[0, 2, 3, 4]]),
                    (_f32(r.standard_normal((5, 2))), [[0, 1, 1, 5]])]},
             ref=_seq_concat_ref),
        Case("sequence_reshape.0", "sequence_reshape",
             {"X": (_f32(r.standard_normal((4, 6))), [[0, 1, 4]])},
             {"new_dim": 3},
             ref=lambda ins, a: {"Out": (ins["X"][0].reshape(-1, 3),
                                         [[0, 2, 8]])}),
        Case("sequence_erase.0", "sequence_erase",
             {"X": (np.array([[2], [1], [5], [2], [3], [4], [5], [6]],
                             np.int64), [[0, 3, 3, 8]])},
             {"tokens": [2, 5]}, ref=_erase_ref),
        Case("sequence_slice.0", "sequence_slice",
             {"X": (_f32(r.standard_normal((7, 2))), [[0, 3, 7]]),
              "Offset": np.array([[1], [0]], np.int64),
              "Length": np.array([[2], [3]], np.int64)}, ref=_slice_ref),
        Case("lod_reset.attr", "lod_reset",
             {"X": _f32(r.standard_normal((5, 2)))},
             {"target_lod": [0, 2, 5]},
             ref=lambda ins, a: {"Out": (ins["X"], [[0, 2, 5]])}),
        Case("lod_reset.y_lod", "lod_reset",
             {"X": (_f32(r.standard_normal((5, 2))), [[0, 5]]),
              "Y": (_f32(np.zeros((5, 1))), [[0, 1, 3, 5]])},
             ref=lambda ins, a: {"Out": (ins["X"][0], [[0, 1, 3, 5]])}),
        Case("lod_reset.y_values", "lod_reset",
             {"X": _f32(r.standard_normal((5, 2))),
              "Y": np.array([0, 4, 5], np.int64)},
             ref=lambda ins, a: {"Out": (ins["X"], [[0, 4, 5]])}),
        Case("im2sequence.0", "im2sequence",
             {"X": _f32(r.standard_normal((2, 2, 5, 5)))},
             {"kernels": [2, 3], "strides": [1, 2],
              "paddings": [0, 1, 1, 0]}),
        Case("sequence_conv.0", "sequence_conv",
             {"X": (x, lod), "Filter": _f32(r.standard_normal((9, 4)))},
             ref=_seq_conv_ref),
        Case("sequence_conv.start0", "sequence_conv",
             {"X": (x, lod), "Filter": _f32(r.standard_normal((6, 2)))},
             {"contextLength": 2, "contextStart": 0}, ref=_seq_conv_ref),
        Case("sequence_pad.0", "sequence_pad", {"X": (x, lod)},
             {"pad_value": 0.5}, ref=_seq_pad_ref),
        Case("sequence_pad.fixed", "sequence_pad", {"X": (x, lod)},
             {"padded_length": 6}, ref=_seq_pad_ref),
        Case("sequence_unpad.0", "sequence_unpad",
             {"X": _f32(r.standard_normal((3, 4, 2))),
              "Length": np.array([2, 4, 1], np.int64)}, ref=_unpad_ref),
        Case("sequence_mask.0", "sequence_mask",
             {"X": np.array([1, 3, 2], np.int64)}, {"maxlen": 4},
             ref=lambda ins, a: {"Y": np.arange(4)[None, :]
                                 < ins["X"][:, None]}),
        Case("sequence_mask.longest", "sequence_mask",
             {"X": np.array([1, 3, 2], np.int64)},
             ref=lambda ins, a: {"Y": np.arange(3)[None, :]
                                 < ins["X"][:, None]}),
        Case("edit_distance.0", "edit_distance",
             {"Hyps": (np.array([1, 2, 3, 4, 5, 6, 7], np.int64)
                       .reshape(-1, 1), [[0, 3, 7]]),
              "Refs": (np.array([1, 3, 3, 5, 6, 8], np.int64)
                       .reshape(-1, 1), [[0, 2, 6]])}, ref=_edit_ref),
        Case("edit_distance.normalized", "edit_distance",
             {"Hyps": (np.array([1, 2, 3, 4, 5], np.int64).reshape(-1, 1),
                       [[0, 0, 5]]),
              "Refs": (np.array([2, 3, 4, 1, 1, 1], np.int64).reshape(-1, 1),
                       [[0, 3, 6]])}, {"normalized": True}, ref=_edit_ref),
    ]
    return cases


def _rnn_cases():
    r = rng("rnn")
    d, p = 3, 2
    lod = [[0, 2, 5, 9]]
    n = lod[0][-1]

    def w(*shape, scale=0.5):
        return _f32(scale * r.standard_normal(shape))

    gates4 = w(n, 4 * d, scale=1.0)
    return [
        Case("lstm.peepholes", "lstm",
             {"Input": (gates4, lod), "Weight": w(d, 4 * d),
              "Bias": w(1, 7 * d)}),
        Case("lstm.no_peepholes", "lstm",
             {"Input": (gates4, lod), "Weight": w(d, 4 * d),
              "Bias": w(1, 4 * d)}, {"use_peepholes": False}),
        Case("lstm.reverse", "lstm",
             {"Input": (gates4, lod), "Weight": w(d, 4 * d),
              "Bias": w(1, 7 * d)}, {"is_reverse": True}),
        Case("lstm.h0_c0", "lstm",
             {"Input": (gates4, lod), "H0": w(3, d), "C0": w(3, d),
              "Weight": w(d, 4 * d), "Bias": w(1, 7 * d)},
             {"candidate_activation": "identity"}),
        Case("lstmp.0", "lstmp",
             {"Input": (gates4, lod), "Weight": w(p, 4 * d),
              "ProjWeight": w(d, p), "Bias": w(1, 7 * d)}),
        Case("lstmp.reverse", "lstmp",
             {"Input": (gates4, lod), "Weight": w(p, 4 * d),
              "ProjWeight": w(d, p), "Bias": w(1, 4 * d)},
             {"is_reverse": True, "use_peepholes": False}),
        Case("gru.0", "gru",
             {"Input": (w(n, 3 * d, scale=1.0), lod), "Weight": w(d, 3 * d),
              "Bias": w(1, 3 * d)}),
        Case("gru.h0_reverse", "gru",
             {"Input": (w(n, 3 * d, scale=1.0), lod), "H0": w(3, d),
              "Weight": w(d, 3 * d), "Bias": w(1, 3 * d)},
             {"is_reverse": True}),
        Case("lstm_unit.0", "lstm_unit",
             {"X": w(3, 4 * d, scale=1.0), "C_prev": w(3, d)},
             {"forget_bias": 0.5}, ref=_lstm_unit_ref),
        Case("gru_unit.0", "gru_unit",
             {"Input": w(3, 3 * d, scale=1.0), "HiddenPrev": w(3, d),
              "Weight": w(d, 3 * d), "Bias": w(1, 3 * d)},
             ref=_gru_unit_ref),
    ]


# -- control flow: the IfElse split and merge (paddle_tpu/ops/
# control_flow.py:101-221; tests/test_ifelse.py's OpTest cases) ------------

def _branches(x, mask, level):
    """(true rows, false rows, true lens, false lens; lens None for a
    dense input) of split_lod_tensor."""
    m = np.asarray(mask).reshape(-1).astype(bool)
    if isinstance(x, tuple):
        offs = x[1][level]
        rows = [list(range(offs[s], offs[s + 1])) for s in range(len(m))]
        pick = lambda k: [r for s, rs in enumerate(rows)  # noqa: E731
                          if m[s] == k for r in rs]
        lens = lambda k: [len(rs) for s, rs in enumerate(rows)  # noqa: E731
                          if m[s] == k]
        return pick(True), pick(False), lens(True), lens(False)
    idx = np.arange(len(m))
    return idx[m].tolist(), idx[~m].tolist(), None, None


def _branch(a, rows, lens):
    out = a[rows]
    return out if lens is None else (out, [_offsets(lens)])


def _offsets(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(int).tolist()


def _split_lod_ref(ins, a):
    t, f, tl, fl = _branches(ins["X"], ins["Mask"], a["level"])
    x = _arr_of(ins["X"])
    return {"OutTrue": _branch(x, t, tl), "OutFalse": _branch(x, f, fl)}


def _merge_lod_ref(ins, a):
    t, f, _, _ = _branches(ins["X"], ins["Mask"], a["level"])
    vt, vf = _arr_of(ins["InTrue"]), _arr_of(ins["InFalse"])
    out = np.zeros((len(t) + len(f),) + vt.shape[1:], vt.dtype)
    out[t], out[f] = vt, vf
    x = ins["X"]
    return {"Out": (out, x[1]) if isinstance(x, tuple) else out}


def _split_grad_ref(ins, a):
    t, f, _, _ = _branches(ins["X"], ins["Mask"], a["level"])
    x = ins["X"]
    g = np.zeros_like(_arr_of(x))
    g[t] = _arr_of(ins["OutTrue@GRAD"])
    g[f] = _arr_of(ins["OutFalse@GRAD"])
    return {"X@GRAD": (g, x[1]) if isinstance(x, tuple) else g}


def _merge_grad_ref(ins, a):
    t, f, tl, fl = _branches(ins["X"], ins["Mask"], a["level"])
    g = ins["Out@GRAD"]
    return {"InTrue@GRAD": _branch(g, t, tl),
            "InFalse@GRAD": _branch(g, f, fl)}


def _arr_of(v):
    return v[0] if isinstance(v, tuple) else v


def _control_flow_cases():
    r = rng("control_flow")
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    mask = (np.arange(10) % 3 == 0).reshape(10, 1)
    lod = [[0, 3, 5, 7]]
    seq_mask = np.array([[1], [0], [1]], bool)
    m6 = np.array([1, 0, 0, 1, 1, 0], bool).reshape(6, 1)
    return [
        Case("split_lod_tensor.dense", "split_lod_tensor",
             {"X": x, "Mask": mask}, ref=_split_lod_ref, vjp=False),
        Case("split_lod_tensor.lod", "split_lod_tensor",
             {"X": (_f32(r.standard_normal((7, 2))), lod),
              "Mask": seq_mask}, ref=_split_lod_ref, vjp=False),
        Case("merge_lod_tensor.dense", "merge_lod_tensor",
             {"X": np.zeros((6, 3), np.float32), "Mask": m6,
              "InTrue": _f32(r.rand(3, 3)), "InFalse": _f32(r.rand(3, 3))},
             ref=_merge_lod_ref, vjp=False),
        Case("merge_lod_tensor.lod", "merge_lod_tensor",
             {"X": (np.zeros((7, 1), np.float32), lod), "Mask": seq_mask,
              "InTrue": (_f32(r.standard_normal((5, 2))), [[0, 3, 5]]),
              "InFalse": (_f32(r.standard_normal((2, 2))), [[0, 2]])},
             ref=_merge_lod_ref, vjp=False),
        Case("split_lod_tensor_grad.dense", "split_lod_tensor_grad",
             {"X": x, "Mask": mask,
              "OutTrue@GRAD": _f32(r.standard_normal((4, 2))),
              "OutFalse@GRAD": _f32(r.standard_normal((6, 2)))},
             ref=_split_grad_ref, vjp=False),
        Case("split_lod_tensor_grad.lod", "split_lod_tensor_grad",
             {"X": (_f32(r.standard_normal((7, 2))), lod),
              "Mask": seq_mask,
              "OutTrue@GRAD": (_f32(r.standard_normal((5, 2))),
                               [[0, 3, 5]]),
              "OutFalse@GRAD": (_f32(r.standard_normal((2, 2))), [[0, 2]])},
             ref=_split_grad_ref, vjp=False),
        Case("merge_lod_tensor_grad.dense", "merge_lod_tensor_grad",
             {"X": np.zeros((6, 3), np.float32), "Mask": m6,
              "InTrue": _f32(r.rand(3, 3)), "InFalse": _f32(r.rand(3, 3)),
              "Out@GRAD": _f32(r.standard_normal((6, 3)))},
             ref=_merge_grad_ref, vjp=False),
        Case("merge_lod_tensor_grad.lod", "merge_lod_tensor_grad",
             {"X": (np.zeros((7, 1), np.float32), lod), "Mask": seq_mask,
              "InTrue": (_f32(r.standard_normal((5, 2))), [[0, 3, 5]]),
              "InFalse": (_f32(r.standard_normal((2, 2))), [[0, 2]]),
              "Out@GRAD": _f32(r.standard_normal((7, 2)))},
             ref=_merge_grad_ref, vjp=False),
    ]



# -- the linear-chain CRF ops (paddle_tpu/ops/crf.py:47-281) -----------------

def _crf_parts(ins):
    x, lods = ins["Emission"]
    tr = np.asarray(ins["Transition"], np.float64)
    return np.asarray(x, np.float64), lods[0], tr[0], tr[1], tr[2:]


def _crf_nll_ref(ins, a):
    """The forward algorithm a sequence at a time, in float64."""
    x, lod, start, end, trans = _crf_parts(ins)
    lab = np.asarray(_arr_of(ins["Label"])).reshape(-1)
    alpha_rows, nll = np.zeros_like(x), []
    for s in range(len(lod) - 1):
        em, tags = x[lod[s]:lod[s + 1]], lab[lod[s]:lod[s + 1]]
        alpha = start + em[0]
        alpha_rows[lod[s]] = alpha
        for t in range(1, len(em)):
            z = alpha[:, None] + trans
            m = z.max(0)
            alpha = m + np.log(np.exp(z - m).sum(0)) + em[t]
            alpha_rows[lod[s] + t] = alpha
        z = alpha + end
        log_z = z.max() + np.log(np.exp(z - z.max()).sum())
        gold = (start[tags[0]] + end[tags[-1]] + em[np.arange(len(em)),
                                                    tags].sum()
                + sum(trans[tags[t - 1], tags[t]]
                      for t in range(1, len(em))))
        nll.append(log_z - gold)
    ex = np.exp(x - x.max(1, keepdims=True))
    return {"LogLikelihood": np.asarray(nll)[:, None],
            "Alpha": (alpha_rows, [lod]),
            "EmissionExps": (ex / ex.sum(1, keepdims=True), [lod]),
            "TransitionExps": np.exp(np.asarray(ins["Transition"]))}


def _viterbi_ref(ins, a):
    """Viterbi a sequence at a time, ties to the first index."""
    x, lod, start, end, trans = _crf_parts(ins)
    path = np.zeros(len(x), np.int64)
    for s in range(len(lod) - 1):
        em = x[lod[s]:lod[s + 1]]
        alpha, ptrs = start + em[0], []
        for t in range(1, len(em)):
            z = alpha[:, None] + trans
            ptrs.append(z.argmax(0))
            alpha = z.max(0) + em[t]
        tag = int((alpha + end).argmax())
        tags = [tag]
        for p in reversed(ptrs):
            tag = int(p[tag])
            tags.append(tag)
        path[lod[s]:lod[s + 1]] = tags[::-1]
    if "Label" in ins:
        lab = np.asarray(_arr_of(ins["Label"])).reshape(-1)
        path = (path == lab).astype(np.int64)
    return {"ViterbiPath": (path[:, None], [lod])}


def _crf_cases():
    r = rng("crf")
    d = 3

    def crf_ins(lod, label_2d=True, ints=False):
        n = lod[0][-1]
        em = (r.randint(0, 2, (n, d)) if ints
              else r.standard_normal((n, d)))
        tr = (r.randint(0, 2, (d + 2, d)) if ints
              else 0.5 * r.standard_normal((d + 2, d)))
        lab = r.randint(0, d, (n, 1) if label_2d else (n,)).astype(np.int64)
        return {"Emission": (_f32(em), lod), "Transition": _f32(tr),
                "Label": (lab, lod)}

    def decode_ins(lod, label=False, ints=False):
        ins = crf_ins(lod, ints=ints)
        if not label:
            del ins["Label"]
        return ins

    # IOB, IOE, IOBES and plain tags over 2 chunk types (O = the last)
    def tags(n_tag, n):
        return r.randint(0, 2 * n_tag + 1, (n, 1)).astype(np.int64)

    lod = [[0, 4, 5, 11, 14]]
    chunk = [Case(f"chunk_eval.{scheme}", "chunk_eval",
                  {"Inference": (tags(k, 14), lod),
                   "Label": (tags(k, 14), lod)},
                  {"chunk_scheme": scheme, "num_chunk_types": 2})
             for scheme, k in (("IOB", 2), ("IOE", 2), ("IOBES", 4),
                               ("plain", 1))]
    chunk.append(Case("chunk_eval.excluded", "chunk_eval",
                      {"Inference": (tags(2, 14), lod),
                       "Label": (tags(2, 14), lod)},
                      {"chunk_scheme": "IOB", "num_chunk_types": 2,
                       "excluded_chunk_types": [1]}))
    return [
        Case("linear_chain_crf.0", "linear_chain_crf",
             crf_ins([[0, 3, 5, 9]]), ref=_crf_nll_ref),
        Case("linear_chain_crf.t1_label_1d", "linear_chain_crf",
             crf_ins([[0, 1, 2, 5]], label_2d=False), ref=_crf_nll_ref),
        Case("linear_chain_crf.all_t1", "linear_chain_crf",
             crf_ins([[0, 1, 2, 3]]), ref=_crf_nll_ref),
        Case("crf_decoding.0", "crf_decoding", decode_ins([[0, 2, 6, 7]]),
             ref=_viterbi_ref),
        Case("crf_decoding.label", "crf_decoding",
             decode_ins([[0, 2, 6, 7]], label=True), ref=_viterbi_ref),
        Case("crf_decoding.ties", "crf_decoding",
             decode_ins([[0, 4, 9, 10]], ints=True), ref=_viterbi_ref),
        Case("crf_decoding.all_t1", "crf_decoding",
             decode_ins([[0, 1, 2]]), ref=_viterbi_ref),
    ] + chunk

# -- CTC, the sampled losses and the detection geometry (paddle_tpu/ops/
# ctc.py:42-124, sampling.py:22-106, detection.py:34-249 and :387-444) --------

def _ctc_ref(ins, a):
    """The CTC loss a sequence at a time: the alpha recursion over the
    blank-extended labels in float64 probabilities."""
    x, (lod,) = ins["Logits"]
    lab, (llod,) = ins["Label"]
    lab = np.asarray(lab).reshape(-1)
    blank, loss = a["blank"], []
    for i in range(len(lod) - 1):
        z = x[lod[i]:lod[i + 1]]
        p = np.exp(z - z.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        ext = [blank]
        for v in lab[llod[i]:llod[i + 1]]:
            ext += [int(v), blank]
        s = len(ext)
        alpha = np.zeros(s)
        alpha[0] = p[0, ext[0]]
        if s > 1:
            alpha[1] = p[0, ext[1]]
        for t in range(1, len(z)):
            nxt = alpha.copy()
            nxt[1:] += alpha[:-1]
            for k in range(2, s):
                if ext[k] != blank and ext[k] != ext[k - 2]:
                    nxt[k] += alpha[k - 2]
            alpha = nxt * p[t, ext]
        nll = -np.log(alpha[-1] + (alpha[-2] if s > 1 else 0.0))
        loss.append(nll / len(z) if a["norm_by_times"] else nll)
    return {"Loss": np.asarray(loss)[:, None],
            "WarpCTCGrad": (np.zeros_like(x), [list(lod)])}


def _ctc_cases():
    r = rng("ctc")

    def ins(t_lens, l_lens, c=5, blank=0, repeat=False, dtype=np.int64):
        lod = [list(np.cumsum([0] + t_lens))]
        llod = [list(np.cumsum([0] + l_lens))]
        labels = [b for b in range(c) if b != blank]
        lab = r.choice(labels, sum(l_lens))
        if repeat:      # every other label its predecessor's
            lab[1::2] = lab[0::2][:len(lab[1::2])]
        return {"Logits": (_f32(r.standard_normal((sum(t_lens), c))), lod),
                "Label": (lab.astype(dtype).reshape(-1, 1), llod)}

    return [
        Case("warpctc.ragged", "warpctc", ins([5, 3, 7], [2, 1, 3]),
             ref=_ctc_ref),
        Case("warpctc.repeats_blank_last", "warpctc",
             ins([6, 8], [3, 4], blank=4, repeat=True), {"blank": 4},
             ref=_ctc_ref),
        Case("warpctc.empty_labels", "warpctc", ins([3, 4], [0, 2]),
             ref=_ctc_ref),
        Case("warpctc.all_empty", "warpctc", ins([3, 2], [0, 0]),
             ref=_ctc_ref),
        Case("warpctc.t1", "warpctc", ins([1, 1], [1, 0], dtype=np.int32),
             ref=_ctc_ref),
        Case("warpctc.norm_by_times", "warpctc", ins([4, 6, 2], [2, 3, 1]),
             {"norm_by_times": True}, ref=_ctc_ref),
    ]


def _hsigmoid_ref(ins, a):
    x, w = ins["X"], ins["W"]
    k = a["num_classes"]
    bias = ins.get("Bias")
    cost, pre_all = [], []
    max_len = max((k - 1).bit_length(), 1)
    for b, lab in enumerate(np.asarray(ins["Label"]).reshape(-1)):
        c = int(lab) + k
        length = c.bit_length() - 1
        pre = np.zeros(max_len)
        total = 0.0
        for j in range(length):
            node = (c >> (j + 1)) - 1
            v = x[b] @ w[node] + (bias.reshape(-1)[node] if bias is not None
                                  else 0.0)
            v = min(max(v, -40.0), 40.0)
            pre[j] = v
            total += np.logaddexp(v, 0.0) - ((c >> j) & 1) * v
        cost.append(total)
        pre_all.append(pre)
    return {"Out": np.asarray(cost)[:, None], "PreOut": np.asarray(pre_all)}


def _sampling_cases():
    r = rng("sampling")

    def hs(b, d, k, bias=True):
        out = {"X": _f32(0.5 * r.standard_normal((b, d))),
               "W": _f32(0.5 * r.standard_normal((k - 1, d))),
               "Label": r.randint(0, k, (b, 1)).astype(np.int64)}
        if bias:
            out["Bias"] = _f32(0.1 * r.standard_normal((k - 1,)))
        return out

    def nce_ins(b, d, v, true=1, weight=False):
        out = {"Input": _f32(0.5 * r.standard_normal((b, d))),
               "Label": r.randint(0, v, (b, true)).astype(np.int64),
               "Weight": _f32(0.5 * r.standard_normal((v, d))),
               "Bias": _f32(0.1 * r.standard_normal((v,)))}
        if weight:
            out["SampleWeight"] = _f32(r.uniform(0.5, 1.5, (b, 1)))
        return out

    return [
        Case("hsigmoid.0", "hsigmoid", hs(6, 4, 8), {"num_classes": 8},
             ref=_hsigmoid_ref),
        Case("hsigmoid.k11", "hsigmoid", hs(7, 3, 11), {"num_classes": 11},
             ref=_hsigmoid_ref),
        Case("hsigmoid.no_bias", "hsigmoid", hs(5, 4, 6, bias=False),
             {"num_classes": 6}, ref=_hsigmoid_ref),
        Case("nce.0", "nce", nce_ins(6, 4, 20), {"num_total_classes": 20,
                                                  "num_neg_samples": 5},
             random=True),
        Case("nce.two_true_weighted", "nce", nce_ins(5, 3, 12, 2, True),
             {"num_total_classes": 12, "num_neg_samples": 4}, random=True),
    ]


def _center(b):
    return ((b[..., 2] + b[..., 0]) / 2, (b[..., 3] + b[..., 1]) / 2,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


def _box_coder_ref(ins, a):
    prior, var = ins["PriorBox"], ins["PriorBoxVar"]
    t = _arr_of(ins["TargetBox"])
    pcx, pcy, pw, ph = _center(prior)
    if a["code_type"] == "encode_center_size":
        tcx, tcy, tw, th = _center(t)
        out = np.stack([(tcx[:, None] - pcx) / pw / var[:, 0],
                        (tcy[:, None] - pcy) / ph / var[:, 1],
                        np.log(np.abs(tw[:, None] / pw)) / var[:, 2],
                        np.log(np.abs(th[:, None] / ph)) / var[:, 3]], -1)
    else:
        cx = var[:, 0] * t[..., 0] * pw + pcx
        cy = var[:, 1] * t[..., 1] * ph + pcy
        w = np.exp(var[:, 2] * t[..., 2]) * pw
        h = np.exp(var[:, 3] * t[..., 3]) * ph
        out = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return {"OutputBox": out}


def _iou_np64(a, b):
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    union = (((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[:, None]
             + ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))[None, :] - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def _iou_ref(ins, a):
    x = ins["X"]
    out = _iou_np64(_arr_of(x), ins["Y"])
    return {"Out": (out, x[1]) if isinstance(x, tuple) else out}


def _target_assign_ref(ins, a):
    x, lod = ins["X"]
    if x.ndim == 2:
        x = x[:, None, :]
    match = np.asarray(ins["MatchIndices"])
    n, m = match.shape
    p = x.shape[1]
    out = np.full((n, m, x.shape[2]), float(a["mismatch_value"]))
    wt = np.zeros((n, m, 1))
    for i in range(n):
        for j in range(m):
            if match[i, j] > -1:
                out[i, j] = x[lod[0][i] + match[i, j], j % p]
                wt[i, j] = 1.0
    if "NegIndices" in ins:
        neg, nlod = ins["NegIndices"]
        for i in range(len(nlod[0]) - 1):
            for row in np.asarray(neg).reshape(-1)[nlod[0][i]:nlod[0][i + 1]]:
                out[i, row] = float(a["mismatch_value"])
                wt[i, row] = 1.0
    return {"Out": out.astype(x.dtype), "OutWeight": wt}


def _roi_pool_ref(ins, a):
    """Each bin's first maximum in row-major order, a bin at a time."""
    x = ins["X"]
    rois, lod = ins["ROIs"]
    ph, pw = a["pooled_height"], a["pooled_width"]
    _, c, h, w = x.shape
    out = np.zeros((len(rois), c, ph, pw))
    arg = np.zeros((len(rois), c, ph, pw), np.int64)
    for k, roi in enumerate(rois):
        img = np.searchsorted(lod[0], k, side="right") - 1
        x1, y1, x2, y2 = np.round(np.float32(roi) * np.float32(
            a["spatial_scale"]))
        bh = np.float32(max(y2 - y1 + 1, 1.0)) / np.float32(ph)
        bw = np.float32(max(x2 - x1 + 1, 1.0)) / np.float32(pw)
        for i in range(ph):
            hs, he = np.floor(i * bh) + y1, np.ceil((i + 1) * bh) + y1
            for j in range(pw):
                ws, we = np.floor(j * bw) + x1, np.ceil((j + 1) * bw) + x1
                hh = [v for v in range(h) if hs <= v < he]
                ww = [v for v in range(w) if ws <= v < we]
                if not hh or not ww:
                    continue
                blk = x[img][:, hh][:, :, ww].reshape(c, -1)
                best = blk.argmax(1)
                out[k, :, i, j] = blk[np.arange(c), best]
                arg[k, :, i, j] = (np.asarray(hh)[best // len(ww)] * w
                                   + np.asarray(ww)[best % len(ww)])
    return {"Out": out, "Argmax": arg}


def _boxes(r, n, lo=0.0, hi=1.0):
    """n corner boxes with positive sides."""
    a = r.uniform(lo, hi, (n, 2))
    b = a + r.uniform(0.05, 0.5, (n, 2))
    return _f32(np.concatenate([a, b], 1))


def _detection_cases():
    r = rng("detection")
    prior = _boxes(r, 6)
    pvar = _f32(np.tile([0.5, 0.5, 1.0, 1.0], (6, 1)))
    gt = _boxes(r, 3)
    lod = [[0, 2, 3]]
    match = np.asarray([[1, -1, 0, -1, -1, 0], [-1, 0, -1, -1, 0, -1]],
                       np.int32)
    roi_x = _f32(r.standard_normal((2, 2, 7, 9)))
    rois = _f32([[0, 0, 10, 8], [2.4, 1.6, 6.2, 7.7], [5, 3, 5, 3],
                 [8, 6, 14, 12], [-3, -2, 1, 1]])
    tie_x = _f32(r.randint(0, 3, (1, 2, 6, 7)))
    return [
        Case("prior_box.0", "prior_box",
             {"Input": np.zeros((1, 2, 3, 4), np.float32),
              "Image": np.zeros((1, 3, 30, 40), np.float32)},
             {"min_sizes": [8.0], "max_sizes": [16.0],
              "aspect_ratios": [2.0, 3.0]}),
        Case("prior_box.steps_no_clip", "prior_box",
             {"Input": np.zeros((1, 2, 2, 2), np.float32),
              "Image": np.zeros((1, 3, 20, 20), np.float32)},
             {"min_sizes": [6.0, 12.0], "aspect_ratios": [2.0],
              "flip": False, "clip": False, "step_w": 11.0, "step_h": 9.0,
              "offset": 0.25}),
        Case("box_coder.encode", "box_coder",
             {"PriorBox": prior, "PriorBoxVar": pvar, "TargetBox": gt},
             ref=_box_coder_ref),
        Case("box_coder.decode", "box_coder",
             {"PriorBox": prior, "PriorBoxVar": pvar,
              "TargetBox": _f32(0.5 * r.standard_normal((2, 6, 4)))},
             {"code_type": "decode_center_size"}, ref=_box_coder_ref),
        Case("iou_similarity.lod", "iou_similarity",
             {"X": (gt, lod), "Y": prior}, ref=_iou_ref),
        Case("iou_similarity.touching", "iou_similarity",
             {"X": _f32([[0, 0, 1, 1], [1, 1, 2, 2], [0, 0, 0, 0]]),
              "Y": _f32([[1, 0, 2, 1], [0, 0, 2, 2]])}, ref=_iou_ref),
        Case("target_assign.boxes", "target_assign",
             {"X": (_f32(r.standard_normal((3, 6, 4))), lod),
              "MatchIndices": match}, {"mismatch_value": 0},
             ref=_target_assign_ref),
        Case("target_assign.labels_neg", "target_assign",
             {"X": (r.randint(1, 5, (3, 1, 1)).astype(np.int64), lod),
              "MatchIndices": match,
              "NegIndices": (np.asarray([[1], [3], [0], [2], [5]], np.int32),
                             [[0, 2, 5]])},
             {"mismatch_value": 7}, ref=_target_assign_ref),
        Case("roi_pool.0", "roi_pool",
             {"X": roi_x, "ROIs": (rois, [[0, 3, 5]])},
             {"pooled_height": 3, "pooled_width": 2}, ref=_roi_pool_ref),
        Case("roi_pool.scaled", "roi_pool",
             {"X": roi_x, "ROIs": (_f32(rois * 2 + 1), [[0, 2, 5]])},
             {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
             ref=_roi_pool_ref),
        Case("roi_pool.ties", "roi_pool",
             {"X": tie_x, "ROIs": (_f32([[0, 0, 6, 5], [1, 1, 4, 4]]),
                                   [[0, 2]])},
             {"pooled_height": 2, "pooled_width": 2}, ref=_roi_pool_ref,
             fd=False),
    ]


# -- the rest of the conv ops (paddle_tpu/ops/conv.py:82-336) ----------------

def _np_windows(x, k, s, p, value):
    """[N, C, *out, prod(k)] windows of x padded by p with `value`, and
    each window element's flat plane index (-1 in the padding)."""
    r = len(k)
    sp = x.shape[2:]
    pad = ((0, 0), (0, 0)) + tuple((q, q) for q in p)
    xp = np.pad(x, pad, constant_values=value)
    ip = np.pad(np.arange(int(np.prod(sp))).reshape(sp), pad[2:],
                constant_values=-1)
    out = tuple((sp[i] + 2 * p[i] - k[i]) // s[i] + 1 for i in range(r))
    wins = np.zeros(x.shape[:2] + out + (int(np.prod(k)),), x.dtype)
    idx = np.zeros(out + (int(np.prod(k)),), np.int64)
    for o in np.ndindex(*out):
        sl = tuple(slice(o[i] * s[i], o[i] * s[i] + k[i]) for i in range(r))
        wins[(Ellipsis,) + o + (slice(None),)] = xp[(Ellipsis,) + sl] \
            .reshape(x.shape[:2] + (-1,))
        idx[o] = ip[sl].reshape(-1)
    return wins, idx


def _np_pool(x, a, rank):
    k = tuple(a["ksize"])
    s, p = tuple(a["strides"]), tuple(a["paddings"])
    if a.get("global_pooling"):
        k, s, p = x.shape[2:], (1,) * rank, (0,) * rank
    if a.get("pooling_type", "max") == "max":
        wins, idx = _np_windows(x, k, s, p, -np.inf)
        arg = wins.argmax(-1)     # the first maximum
        vals = np.take_along_axis(wins, arg[..., None], -1)[..., 0]
        mask = np.take_along_axis(np.broadcast_to(idx, wins.shape),
                                  arg[..., None], -1)[..., 0]
        return vals, np.where(vals == -np.inf, -1, mask)
    sums = _np_windows(x, k, s, p, 0.0)[0].sum(-1)
    cnt = _np_windows(np.ones((1, 1) + x.shape[2:]), k, s, p, 0.0)[0] \
        .sum(-1)
    with np.errstate(invalid="ignore"):
        return sums / cnt, None


def _np_conv(x, w, s, p, d, g=1):
    """Direct convolution, any rank: w [M, C/g, k...]."""
    r = x.ndim - 2
    n, c = x.shape[:2]
    m, cg = w.shape[:2]
    k = w.shape[2:]
    xp = np.pad(x, ((0, 0), (0, 0)) + tuple((q, q) for q in p))
    out_sp = tuple((x.shape[2 + i] + 2 * p[i] - d[i] * (k[i] - 1) - 1)
                   // s[i] + 1 for i in range(r))
    out = np.zeros((n, m) + out_sp)
    mg = m // g
    for o in np.ndindex(*out_sp):
        sl = tuple(slice(o[i] * s[i], o[i] * s[i] + d[i] * (k[i] - 1) + 1,
                         d[i]) for i in range(r))
        patch = xp[(slice(None), slice(None)) + sl]      # [N, C, k...]
        for gi in range(g):
            pg = patch[:, gi * cg:(gi + 1) * cg].reshape(n, -1)
            wg = w[gi * mg:(gi + 1) * mg].reshape(mg, -1)
            out[(slice(None), slice(gi * mg, (gi + 1) * mg)) + o] = \
                pg @ wg.T
    return out


def _np_conv_transpose(x, w, s, p, d):
    """Each input element scatters x * w into the output, then the
    padding is cut: w [C, M, k...]."""
    r = x.ndim - 2
    n = x.shape[0]
    m, k = w.shape[1], w.shape[2:]
    full = tuple((x.shape[2 + i] - 1) * s[i] + d[i] * (k[i] - 1) + 1
                 for i in range(r))
    out = np.zeros((n, m) + full)
    for o in np.ndindex(*x.shape[2:]):
        for kk in np.ndindex(*k):
            pos = tuple(o[i] * s[i] + kk[i] * d[i] for i in range(r))
            out[(slice(None), slice(None)) + pos] += np.einsum(
                "nc,cm->nm", x[(slice(None), slice(None)) + o],
                w[(slice(None), slice(None)) + kk])
    return out[(slice(None), slice(None)) + tuple(
        slice(p[i], full[i] - p[i]) for i in range(r))]


def _conv3d_ref(ins, a):
    return {"Output": _np_conv(ins["Input"], ins["Filter"], a["strides"],
                               a["paddings"], a["dilations"], a["groups"])}


def _conv_t_ref(ins, a):
    return {"Output": _np_conv_transpose(ins["Input"], ins["Filter"],
                                         a["strides"], a["paddings"],
                                         a["dilations"])}


def _pool3d_ref(ins, a):
    return {"Out": _np_pool(ins["X"], a, 3)[0]}


def _max_index_ref(rank):
    def ref(ins, a):
        out, mask = _np_pool(ins["X"], {**a, "pooling_type": "max"}, rank)
        return {"Out": out, "Mask": mask}
    return ref


def _spp_ref(ins, a):
    x = ins["X"]
    n, c, h, w = x.shape
    outs = []
    for level in range(a["pyramid_height"]):
        b = 2 ** level
        kh, kw = -(-h // b), -(-w // b)
        pool = {"pooling_type": a["pooling_type"], "ksize": [kh, kw],
                "strides": [kh, kw], "paddings": [(kh * b - h + 1) // 2,
                                                  (kw * b - w + 1) // 2]}
        outs.append(_np_pool(x, pool, 2)[0].reshape(n, -1))
    return {"Out": np.concatenate(outs, 1)}


def _unpool_ref(ins, a):
    """Written in order, so a later element overwrites an earlier one at
    a shared index; negative indices count from the end."""
    x, idx = ins["X"], ins["Indices"]
    n, c, h, w = x.shape
    k, s, p = a["ksize"], a["strides"], a["paddings"]
    oh, ow = (h - 1) * s[0] - 2 * p[0] + k[0], (w - 1) * s[1] - 2 * p[1] + k[1]
    out = np.zeros((n, c, oh * ow))
    for i in range(n):
        for j in range(c):
            for v, t in zip(x[i, j].reshape(-1), idx[i, j].reshape(-1)):
                t = t + oh * ow if t < 0 else t
                if 0 <= t < oh * ow:
                    out[i, j, t] = v
    return {"Out": out.reshape(n, c, oh, ow)}


def _conv_shift_ref(ins, a):
    x, y = ins["X"], ins["Y"]
    n, m = x.shape[1], y.shape[1]
    out = np.zeros(x.shape)
    for j in range(n):
        for k in range(m):
            out[:, j] += x[:, (j + k - m // 2) % n] * y[:, k]
    return {"Out": out}


def _row_conv_ref(ins, a):
    """Paddle's row_conv_op: each row's window stops at the end of its
    sequence."""
    xv, w = ins["X"], ins["Filter"]
    x, lod = xv if isinstance(xv, tuple) else (xv, None)
    if lod is None:
        return {"Out": np.stack([_row_conv_ref(
            {"X": (xi, [[0, len(xi)]]), "Filter": w}, a)["Out"][0]
            for xi in x])}
    out = np.zeros(x.shape)
    offs = lod[-1]
    for b, e in zip(offs[:-1], offs[1:]):
        for t in range(b, e):
            for i in range(min(len(w), e - t)):
                out[t] += x[t + i] * w[i]
    return {"Out": (out, lod)}


def _conv_rest_cases():
    r = rng("conv_rest")
    x3 = _f32(r.standard_normal((2, 4, 4, 5, 5)))
    tie3 = _f32(r.randint(0, 3, (1, 2, 4, 4, 4)))
    tie2 = _f32(r.randint(0, 3, (2, 2, 5, 6)))
    x2 = _f32(r.standard_normal((2, 3, 6, 7)))
    pooled = _f32(r.standard_normal((1, 2, 2, 3)))
    return [
        Case("conv3d.0", "conv3d",
             {"Input": x3, "Filter": _f32(0.3 * r.standard_normal(
                 (3, 4, 3, 3, 2)))},
             {"strides": [1, 2, 1], "paddings": [1, 0, 1]}, ref=_conv3d_ref),
        Case("conv3d.groups_dilated", "conv3d",
             {"Input": x3, "Filter": _f32(0.3 * r.standard_normal(
                 (4, 2, 2, 2, 2)))},
             {"groups": 2, "dilations": [1, 2, 2], "paddings": [0, 1, 1]},
             ref=_conv3d_ref),
        Case("conv2d_transpose.0", "conv2d_transpose",
             {"Input": x2, "Filter": _f32(0.3 * r.standard_normal(
                 (3, 2, 3, 2)))},
             {"strides": [2, 1], "paddings": [1, 0]}, ref=_conv_t_ref),
        Case("conv2d_transpose.dcgan", "conv2d_transpose",
             {"Input": _f32(r.standard_normal((2, 4, 3, 3))),
              "Filter": _f32(0.3 * r.standard_normal((4, 3, 4, 4)))},
             {"strides": [2, 2], "paddings": [1, 1]}, ref=_conv_t_ref),
        Case("conv2d_transpose.dilated", "conv2d_transpose",
             {"Input": x2, "Filter": _f32(0.3 * r.standard_normal(
                 (3, 2, 2, 3)))},
             {"dilations": [2, 1], "strides": [1, 2]}, ref=_conv_t_ref),
        Case("conv3d_transpose.unet", "conv3d_transpose",
             {"Input": _f32(r.standard_normal((2, 3, 2, 3, 2))),
              "Filter": _f32(0.3 * r.standard_normal((3, 2, 2, 2, 2)))},
             {"strides": [2, 2, 2]}, ref=_conv_t_ref),
        Case("conv3d_transpose.padded", "conv3d_transpose",
             {"Input": _f32(r.standard_normal((1, 2, 3, 3, 2))),
              "Filter": _f32(0.3 * r.standard_normal((2, 3, 3, 2, 3)))},
             {"strides": [1, 2, 1], "paddings": [1, 0, 1],
              "dilations": [1, 1, 2]}, ref=_conv_t_ref),
        Case("pool3d.max", "pool3d", {"X": x3},
             {"ksize": [2, 3, 2], "strides": [2, 1, 2],
              "paddings": [1, 1, 0]}, ref=_pool3d_ref),
        Case("pool3d.avg_padded", "pool3d", {"X": x3},
             {"pooling_type": "avg", "ksize": [3, 3, 3],
              "strides": [2, 2, 2], "paddings": [1, 1, 1]},
             ref=_pool3d_ref),
        Case("pool3d.global_avg", "pool3d", {"X": x3},
             {"pooling_type": "avg", "global_pooling": True},
             ref=_pool3d_ref),
        Case("pool3d.ties", "pool3d", {"X": tie3},
             {"ksize": [3, 3, 3], "strides": [1, 2, 1]}, ref=_pool3d_ref,
             fd=False),
        Case("max_pool2d_with_index.0", "max_pool2d_with_index", {"X": x2},
             {"ksize": [2, 2], "strides": [2, 2]}, ref=_max_index_ref(2),
             vjp=False),
        Case("max_pool2d_with_index.padded", "max_pool2d_with_index",
             {"X": x2}, {"ksize": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1]}, ref=_max_index_ref(2),
             vjp=False),
        Case("max_pool2d_with_index.ties", "max_pool2d_with_index",
             {"X": tie2}, {"ksize": [3, 3], "strides": [2, 2]},
             ref=_max_index_ref(2), fd=False, vjp=False),
        Case("max_pool3d_with_index.0", "max_pool3d_with_index", {"X": x3},
             {"ksize": [2, 2, 2], "strides": [2, 2, 2]},
             ref=_max_index_ref(3), vjp=False),
        Case("max_pool3d_with_index.padded_ties", "max_pool3d_with_index",
             {"X": tie3}, {"ksize": [2, 3, 3], "strides": [2, 2, 2],
                           "paddings": [1, 1, 1]},
             ref=_max_index_ref(3), fd=False, vjp=False),
        Case("spp.max", "spp", {"X": x2}, {"pyramid_height": 3},
             ref=_spp_ref),
        Case("spp.avg", "spp", {"X": x2},
             {"pyramid_height": 2, "pooling_type": "avg"}, ref=_spp_ref),
        # 5 rows in 4 bins: ksize 2 and padding 2, so the first bin of
        # each axis lies wholly in the padding (-inf for max, NaN for avg)
        Case("spp.all_padding_max", "spp",
             {"X": _f32(r.standard_normal((1, 2, 5, 5)))},
             {"pyramid_height": 3}, ref=_spp_ref, fd=False),
        Case("spp.all_padding_avg", "spp",
             {"X": _f32(r.standard_normal((1, 2, 5, 5)))},
             {"pyramid_height": 3, "pooling_type": "avg"}, ref=_spp_ref,
             fd=False),
        Case("unpool.0", "unpool",
             {"X": pooled, "Indices": np.asarray(
                 [[[[1, 2, 13], [16, 27, 23]], [[0, 3, 5], [17, 18, 28]]]],
                 np.int64)}, ref=_unpool_ref),
        # 3x3 windows at stride 2 share rows and columns: 9 and 22 are
        # two windows' maximum, and the later write wins
        Case("unpool.overlapping", "unpool",
             {"X": pooled, "Indices": np.asarray(
                 [[[[9, 9, 4], [22, 22, 9]], [[0, -1, 5], [40, 22, 22]]]],
                 np.int64)}, {"ksize": [3, 3], "strides": [2, 2]},
             ref=_unpool_ref),
        Case("conv_shift.0", "conv_shift",
             {"X": _f32(r.standard_normal((3, 7))),
              "Y": _f32(r.standard_normal((3, 3)))}, ref=_conv_shift_ref),
        Case("conv_shift.wide", "conv_shift",
             {"X": _f32(r.standard_normal((2, 5))),
              "Y": _f32(r.standard_normal((2, 5)))}, ref=_conv_shift_ref),
        Case("row_conv.dense", "row_conv",
             {"X": _f32(r.standard_normal((2, 5, 3))),
              "Filter": _f32(r.standard_normal((3, 3)))}, ref=_row_conv_ref),
        Case("row_conv.one_sequence", "row_conv",
             {"X": (_f32(r.standard_normal((6, 4))), [[0, 6]]),
              "Filter": _f32(r.standard_normal((3, 4)))}, ref=_row_conv_ref),
        Case("row_conv.one_row", "row_conv",
             {"X": (_f32(r.standard_normal((1, 4))), [[0, 1]]),
              "Filter": _f32(r.standard_normal((2, 4)))}, ref=_row_conv_ref),
    ]


GROUPS = {
    "activation": _activation_cases,
    "elementwise": _elementwise_cases,
    "matmul": _matmul_cases,
    "reduce": _reduce_cases,
    "manip": _manip_cases,
    "creation": _creation_cases,
    "loss": _loss_cases,
    "metrics": _metric_cases,
    "misc": _misc_cases,
    "sequence": _sequence_cases,
    "rnn": _rnn_cases,
    "control_flow": _control_flow_cases,
    "crf": _crf_cases,
    "ctc": _ctc_cases,
    "sampling": _sampling_cases,
    "detection": _detection_cases,
    "conv_rest": _conv_rest_cases,
}

CASES = [c for make in GROUPS.values() for c in make()]
assert len({c.name for c in CASES}) == len(CASES), "case names repeat"


def cases_of(*groups):
    return [c for g in groups for c in GROUPS[g]()]
