"""Static cost model over the Program IR: roofline, peak memory, comm
volume (counterpart of paddle_tpu/analysis/cost_model.py).

The Program IR carries everything a first-order answer needs: op descs,
declared shapes/dtypes, the memory layer's liveness machinery and the
sharding propagation's `SpmdPlan`.  This module is the compile-free
estimator over that information:

  * `estimate_op` / `estimate_program` — per-op FLOP and memory-traffic
    estimates driven by cost metadata on the registry `OpInfo`
    (`cost_kind` estimator classes + exact `cost_fn` overrides for the
    dense hot ops), rolled up per block and per program into a static
    roofline row (arithmetic intensity vs the card's ridge point).  Ops
    with no metadata report as **unknown** — coverage is part of the
    result, never a silent zero.
  * `estimate_peak_hbm` — static peak live device memory of one step,
    reusing the memory layer's liveness (`ControlFlowGraph` last-touch
    — the same analysis behind `plan_dead_frees`) and the donation
    rules of `plan_donation`, so the number reflects dead-var freeing
    and buffer donation the way the executors run the step.
  * `estimate_comm` — per-mesh-axis communication VOLUME: gradient-sync
    all-reduce bytes over the batch axis (the bucketed overlap
    lowering's payload), row-parallel psums from `SpmdPlan.reduce_ops`,
    explicit `c_*` collective payloads, resharding-hotspot gather bytes,
    and pserver send-op wire bytes.
  * serving-kernel cost entries (`SERVING_KERNELS`) — the decode-path
    kernels that never appear as Program ops (paged decode `step` /
    `step_window`, gather-through-block-table attention, the
    hand-written CUDA kernels) registered with their shape metadata so
    `cli analyze` answers for generation model dirs too.

Byte convention: **traffic** (per-op reads + writes).  It over-counts
what a fused kernel keeps in registers or shared memory (every op
boundary counts), which is why a measured step is banded against this
estimate rather than held equal to it.  Collective bytes are logical
payload bytes (the operand tensor).

The chip table `DEVICE_SPECS` holds the NVIDIA cards this package runs
on, by the name fragment `torch.cuda.get_device_name` reports;
`device_for_card` resolves a card name to its row.

Two analysis passes surface the model through the verifier
(`cost-model`, `comm-volume`); `python -m paddle_tpu_torch.cli analyze`
prints the tables and gates them against checked-in budgets
(docs/analysis.md).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import registry as op_registry
from ..core.framework import EMPTY_VAR_NAMES, Parameter, grad_var_name
from ..core.registry import register_op_cost, set_op_cost_kind
from ..core.types import np_dtype
from .registry import register_pass

__all__ = [
    "OpCost",
    "ProgramCostEstimate",
    "CommEstimate",
    "estimate_op",
    "estimate_program",
    "estimate_peak_hbm",
    "estimate_comm",
    "ridge_point",
    "roofline_seconds",
    "DEVICE_SPECS",
    "DEFAULT_DEVICE",
    "device_for_card",
    "DEFAULT_BATCH",
    "SERVING_KERNELS",
    "register_serving_kernel",
    "serving_kernel_cost",
    "analyze_generation_spec",
    "check_budget",
]

_GRAD = "_grad"

# assumed batch when a -1 dim has no runtime context (cli --batch / the
# calibration path pass the real one); reported in every summary so a
# roofline row is never mistaken for a measured number
DEFAULT_BATCH = 32

# device ridge points (bf16 dense tensor-core peak FLOP/s, HBM bytes/s;
# NVIDIA data sheets, without sparsity) — the ONE chip table; chip_smoke.py
# reads its bandwidth and bf16 columns too, so the measured bounds and
# this compile-free estimate share every ridge point.  Keys are the
# fragments of `torch.cuda.get_device_name` (device_for_card); the
# default is the H100 SXM card
DEVICE_SPECS: Dict[str, Tuple[float, float]] = {
    "H100": (989e12, 3.35e12),        # H100 SXM5 80GB HBM3
    "H100 PCIe": (756e12, 2.0e12),
    "H100 NVL": (835e12, 3.9e12),
    "H200": (989e12, 4.8e12),
}
DEFAULT_DEVICE = "H100"


def device_for_card(name: str) -> str:
    """The `DEVICE_SPECS` key of a card named as `torch.cuda.
    get_device_name` names it ("NVIDIA H100 80GB HBM3" -> "H100"): the
    longest key found in the name, so "H100 PCIe" and "H100 NVL" win
    over the bare "H100".  KeyError for a card the table lacks."""
    hits = [k for k in DEVICE_SPECS if k in str(name)]
    if not hits:
        raise KeyError(f"no DEVICE_SPECS row for card {name!r}; known: "
                       f"{sorted(DEVICE_SPECS)}")
    return max(hits, key=len)


def ridge_point(device: str = DEFAULT_DEVICE) -> float:
    """flop/byte at which `device` flips memory- to compute-bound."""
    peak, hbm = DEVICE_SPECS[device]
    return peak / hbm


def roofline_seconds(flops: float, bytes_: float,
                     device: str = DEFAULT_DEVICE) -> float:
    """Static roofline floor in SECONDS for work doing `flops` FLOPs
    and moving `bytes_` HBM bytes on `device` — max of the compute
    floor and the bandwidth floor.  The time-attribution plane
    publishes this per phase (``*_phase_static_seconds``) so the
    collector can band measured phase time against the static model
    (``paddle_tpu_calibration_ratio``; docs/observability.md "Time
    attribution")."""
    peak, hbm = DEVICE_SPECS[device]
    return max(float(flops) / peak, float(bytes_) / hbm)


@dataclasses.dataclass
class OpCost:
    """Static cost of one op desc.

    `flops` — floating-point operations (2*MACs for dense ops);
    `bytes` — HBM traffic: operand reads + result writes;
    `kind` — estimator class that produced the numbers ("unknown" when
    the registry carries no cost metadata for the type — the caller must
    surface these, they are NOT zero-cost);
    `note` — human detail (e.g. "2*M*K*N = 2*32*64*128").
    """

    flops: float = 0.0
    bytes: float = 0.0
    kind: str = "unknown"
    note: str = ""

    @property
    def known(self) -> bool:
        return self.kind != "unknown"


# ---------------------------------------------------------------------------
# estimator-class table for the registered op corpus
# ---------------------------------------------------------------------------

# flops per OUTPUT element by class ("reduction" counts INPUT elements);
# order-of-magnitude constants — the dense classes (matmul/conv/
# attention/moe, exact fns below) dominate every real model
_FLOPS_PER_ELEM = {
    "elementwise": 1.0,
    "optimizer": 4.0,   # axpy-ish update + accumulator math
    "norm": 8.0,        # mean/var/rsqrt/scale/shift
    "reduction": 2.0,
    "random": 2.0,
    "data": 0.0,
    "free": 0.0,
    "collective": 0.0,
    "embedding": 0.0,
    "host": 0.0,
    "control": 0.0,
}

_ELEMENTWISE = (
    "elementwise_add elementwise_sub elementwise_mul elementwise_div "
    "elementwise_max elementwise_min elementwise_pow relu tanh sigmoid "
    "exp abs square softsign reciprocal sqrt log softplus scale clip "
    "leaky_relu elu relu6 pow stanh hard_shrink soft_shrink brelu "
    "softshrink ceil floor round sign logsigmoid hard_sigmoid swish "
    "soft_relu tanh_shrink thresholded_relu prelu maxout minus cast "
    "equal not_equal less_than less_equal greater_than greater_equal "
    "logical_and logical_or logical_not logical_xor isfinite "
    "fill_zeros_like label_smooth increment assign clip_by_norm "
    "cumsum sum dropout cos_sim huber_loss hinge_loss log_loss "
    "rank_loss margin_rank_loss modified_huber_loss smooth_l1_loss "
    "squared_l2_distance bilinear_tensor_product lrn conv_shift "
    "row_conv"
).split()

_OPTIMIZER = ("sgd momentum adam adamax adagrad adadelta rmsprop ftrl "
              "decayed_adagrad proximal_adagrad proximal_gd "
              "average_accumulates pruning_mask").split()

_NORM = "batch_norm layer_norm l1_norm norm squared_l2_norm".split()

_REDUCTION = (
    "reduce_sum reduce_mean reduce_max reduce_min reduce_prod mean "
    "softmax sequence_softmax softmax_with_cross_entropy cross_entropy "
    "sigmoid_cross_entropy_with_logits accuracy argmax top_k "
    "sequence_pool pool2d pool3d max_pool2d_with_index "
    "max_pool3d_with_index spp roi_pool unpool auc precision_recall "
    "chunk_eval edit_distance one_hot nce hsigmoid warpctc "
    "linear_chain_crf crf_decoding ctc_align detection_map "
    "multiclass_nms mine_hard_examples bipartite_match iou_similarity "
    "positive_negative_pair"
).split()

_RANDOM = ("uniform_random gaussian_random "
           "uniform_random_batch_size_like").split()

# layout/movement ops: no flops, real traffic
_DATA = (
    "transpose concat split gather scatter pad slice crop expand stack "
    "reverse multiplex sequence_concat sequence_expand sequence_pad "
    "sequence_unpad sequence_slice sequence_erase sequence_reshape "
    "sequence_mask im2sequence beam_search beam_search_decode "
    "lod_reset lod_tensor_to_array array_to_lod_tensor write_to_array "
    "read_from_array merge_lod_tensor split_lod_tensor "
    "split_selected_rows reorder_lod_tensor_by_rank box_coder "
    "prior_box target_assign assign_value fill fill_constant "
    "fill_constant_batch_size_like"
).split()

# metadata-only / bitcast ops: neither flops nor HBM traffic
_FREE = (
    "reshape flatten squeeze unsqueeze shape is_empty lod_rank_table "
    "lod_array_length max_sequence_len shrink_rnn_memory "
    "rnn_memory_helper get_places feed fetch"
).split()

_COLLECTIVE = ("c_allreduce_sum c_allreduce_mean c_allreduce_max "
               "c_allgather c_reducescatter c_broadcast "
               "c_ppermute").split()

# recurrent / control-flow op families: bodies live in sub-blocks (the
# program walk costs those blocks directly), cells are elementwise-ish
_CONTROL = ("while cond conditional_block parallel_do recurrent "
            "dynamic_rnn recompute").split()
_RNN_CELL = ("lstm lstm_unit lstmp gru gru_unit".split())

# lookup_table_grad is its own registration (SelectedRows path) — the
# dense table-grad write is real traffic, costed generically
_EMBEDDING = ("lookup_table", "lookup_table_grad")


def _build_kind_table() -> Dict[str, str]:
    table: Dict[str, str] = {}
    for names, kind in (
        (_ELEMENTWISE, "elementwise"),
        (_OPTIMIZER, "optimizer"),
        (_NORM, "norm"),
        (_REDUCTION, "reduction"),
        (_RANDOM, "random"),
        (_DATA, "data"),
        (_FREE, "free"),
        (_COLLECTIVE, "collective"),
        (_CONTROL, "control"),
        (_RNN_CELL, "elementwise"),
        (_EMBEDDING, "embedding"),
        (("mul", "matmul"), "matmul"),
        (("conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d",
          "conv3d_transpose", "sequence_conv"), "conv"),
        (("flash_attention",), "attention"),
        (("moe_ffn",), "moe"),
    ):
        for n in names:
            table[n] = kind
    return table


_KIND_TABLE = _build_kind_table()


def _install_kind_table():
    """Write the estimator classes onto the registry OpInfo corpus (the
    per-op metadata surface); explicit `cost=` kwargs on register_op and
    `register_op_cost` fns take precedence and are never overwritten.
    Called at import AND lazily from `estimate_op` — op modules that
    register after this module imports still get their metadata."""
    for n, kind in _KIND_TABLE.items():
        set_op_cost_kind(n, kind)


# backward work per forward FLOP by class: a dense op's backward is two
# GEMMs per forward GEMM; pointwise backward is ~the forward
_GRAD_MULT = {"matmul": 2.0, "conv": 2.0, "attention": 2.5, "moe": 2.0}


# ---------------------------------------------------------------------------
# shape resolution
# ---------------------------------------------------------------------------


def _dtype_bytes(dtype) -> int:
    if dtype is None:
        return 4
    try:
        return int(np_dtype(dtype).itemsize)
    except Exception:
        return 4


def _make_resolver(block, batch):
    """resolve(name) -> (shape, dtype) with -1 dims already substituted
    (ancestor-chain lookup, None for unresolvable/undeclared).

    Build-time inference substitutes a prime sentinel for unknown dims
    (core/shape_inference._SENTINEL) and only maps EXACT sentinel dims
    back to -1 — a reshape that folds the batch into another dim leaves
    `sentinel * k` concrete on the var.  Those dims are batch-dependent
    too: map them to `batch * k` here, or one contaminated reshape
    inflates the whole roofline by 8191/batch."""
    from ..core.shape_inference import _SENTINEL

    def fix(d):
        if d < 0:
            return batch
        d = int(d)
        if d >= _SENTINEL and d % _SENTINEL == 0:
            return (d // _SENTINEL) * batch
        return d

    def resolve(name):
        b = block
        seen = set()
        while b is not None and b.idx not in seen:
            seen.add(b.idx)
            v = b.vars.get(name)
            if v is not None:
                if v.shape is None:
                    return None
                return tuple(fix(d) for d in v.shape), v.dtype
            b = b.parent
        return None

    return resolve


def _slot_bytes(op, resolve, slots) -> Tuple[float, int]:
    """(bytes, unresolved-count) over the named vars of `slots`."""
    total, missing = 0.0, 0
    for names in slots.values():
        for n in names:
            if n in EMPTY_VAR_NAMES:
                continue
            r = resolve(n)
            if r is None:
                missing += 1
                continue
            shape, dtype = r
            total += float(np.prod(shape, dtype=np.float64) if shape
                           else 1.0) * _dtype_bytes(dtype)
    return total, missing


def _generic_bytes(op, resolve) -> float:
    rb, _ = _slot_bytes(op, resolve, op.inputs)
    wb, _ = _slot_bytes(op, resolve, op.outputs)
    return rb + wb


def _out_elems(op, resolve) -> float:
    n = 0.0
    for names in op.outputs.values():
        for nm in names:
            if nm in EMPTY_VAR_NAMES:
                continue
            r = resolve(nm)
            if r is not None:
                n += float(np.prod(r[0], dtype=np.float64) if r[0]
                           else 1.0)
    return n


def _in_elems(op, resolve) -> float:
    n = 0.0
    for names in op.inputs.values():
        for nm in names:
            if nm in EMPTY_VAR_NAMES:
                continue
            r = resolve(nm)
            if r is not None:
                n += float(np.prod(r[0], dtype=np.float64) if r[0]
                           else 1.0)
    return n


# ---------------------------------------------------------------------------
# exact estimators for the dense hot ops
# ---------------------------------------------------------------------------


@register_op_cost("mul")
def _mul_cost(op, resolve):
    """Flatten-to-2D GEMM: flops = 2*M*K*N with M = prod(x[:xd]),
    K = prod(x[xd:]), N = prod(y[yd:])."""
    rx, ry = resolve(op.input("X")[0]), resolve(op.input("Y")[0])
    if rx is None or ry is None:
        return OpCost(kind="unknown", note="mul operand shape undeclared")
    xs, ys = rx[0], ry[0]
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    m = float(np.prod(xs[:xd], dtype=np.float64)) if xd else 1.0
    k = float(np.prod(xs[xd:], dtype=np.float64))
    n = float(np.prod(ys[yd:], dtype=np.float64))
    return OpCost(2.0 * m * k * n, _generic_bytes(op, resolve), "matmul",
                  f"2*{m:.0f}*{k:.0f}*{n:.0f}")


@register_op_cost("matmul")
def _matmul_cost(op, resolve):
    rx, ry = resolve(op.input("X")[0]), resolve(op.input("Y")[0])
    if rx is None or ry is None:
        return OpCost(kind="unknown",
                      note="matmul operand shape undeclared")
    xs = list(rx[0]) or [1]
    ys = list(ry[0]) or [1]
    if op.attrs.get("transpose_X"):
        xs[-2:] = xs[-2:][::-1] if len(xs) >= 2 else xs
    if op.attrs.get("transpose_Y"):
        ys[-2:] = ys[-2:][::-1] if len(ys) >= 2 else ys
    m = float(xs[-2]) if len(xs) >= 2 else 1.0
    k = float(xs[-1])
    n = float(ys[-1]) if len(ys) >= 2 else 1.0
    batch = max(
        float(np.prod(xs[:-2], dtype=np.float64)) if len(xs) > 2 else 1.0,
        float(np.prod(ys[:-2], dtype=np.float64)) if len(ys) > 2 else 1.0)
    return OpCost(2.0 * batch * m * k * n, _generic_bytes(op, resolve),
                  "matmul", f"2*{batch:.0f}*{m:.0f}*{k:.0f}*{n:.0f}")


def _conv_cost(op, resolve):
    """2 * out_elems * (Cin/groups) * prod(kernel) — Output shape from
    build-time inference, filter gives kernel + channel counts."""
    fil = (op.input("Filter") or [None])[0]
    outs = [n for n in op.output_names() if n not in EMPTY_VAR_NAMES]
    rf = resolve(fil) if fil else None
    ro = resolve(outs[0]) if outs else None
    if rf is None or ro is None:
        return OpCost(kind="unknown", note="conv shapes undeclared")
    fshape = rf[0]
    groups = int(op.attrs.get("groups", 1) or 1)
    # conv filter [Cout, Cin/g, *k]; transpose filter [Cin, Cout/g, *k]
    cin_per_group = float(fshape[1])
    kernel = float(np.prod(fshape[2:], dtype=np.float64))
    out_elems = float(np.prod(ro[0], dtype=np.float64))
    del groups  # Cin/g is already the per-group contraction depth
    flops = 2.0 * out_elems * cin_per_group * kernel
    return OpCost(flops, _generic_bytes(op, resolve), "conv",
                  f"2*{out_elems:.0f}*{cin_per_group:.0f}*{kernel:.0f}")


for _t in ("conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose"):
    register_op_cost(_t)(_conv_cost)


@register_op_cost("flash_attention")
def _flash_attention_cost(op, resolve):
    """Q/K/V [B, S, H, Dh]: 2 GEMMs (QK^T, att*V) = 4*B*H*Sq*Sk*Dh
    flops (halved causal); bytes are q/k/v/out ONLY — the fused kernel
    never materializes the Sq x Sk score matrix (the training-side memory
    point of the hand-written flash kernels)."""
    rq = resolve(op.input("Q")[0])
    rk = resolve(op.input("K")[0])
    if rq is None or rk is None:
        return OpCost(kind="unknown",
                      note="attention operand shape undeclared")
    b, sq = rq[0][0], rq[0][1]
    h = rq[0][2] if len(rq[0]) > 2 else 1
    dh = rq[0][3] if len(rq[0]) > 3 else rq[0][-1]
    sk = rk[0][1]
    flops = 4.0 * b * h * sq * sk * dh
    if op.attrs.get("causal"):
        flops *= 0.5
    return OpCost(flops, _generic_bytes(op, resolve), "attention",
                  f"4*{b}*{h}*{sq}*{sk}*{dh}"
                  + (" causal/2" if op.attrs.get("causal") else ""))


@register_op_cost("moe_ffn")
def _moe_ffn_cost(op, resolve):
    """GShard dense form (parallel/moe.py): gating GEMM + dispatch/
    combine einsums + E experts x capacity tokens through the FFN pair,
    capacity = cf * top_k * T / E."""
    rx = resolve(op.input("X")[0])
    rwi = resolve(op.input("WIn")[0])
    if rx is None or rwi is None:
        return OpCost(kind="unknown", note="moe operand shape undeclared")
    xs = rx[0]
    t = float(np.prod(xs[:-1], dtype=np.float64))
    d = float(xs[-1])
    e, _, di = (float(rwi[0][0]), float(rwi[0][1]), float(rwi[0][2]))
    top_k = int(op.attrs.get("top_k", 1) or 1)
    cf = float(op.attrs.get("capacity_factor", 1.25) or 1.25)
    cap = max(1.0, cf * top_k * t / e)
    gate = 2.0 * t * d * e
    dispatch = 2.0 * 2.0 * t * e * cap * d      # td,tec->ecd and back
    experts = 2.0 * e * cap * (2.0 * d * di)    # FFN pair on capacity
    return OpCost(gate + dispatch + experts, _generic_bytes(op, resolve),
                  "moe",
                  f"E={e:.0f} cap={cap:.0f} top_k={top_k} cf={cf}")


@register_op_cost("lookup_table")
def _lookup_table_cost(op, resolve):
    """Gather: reads the touched rows + ids, writes the vectors — the
    table itself is not streamed."""
    rw = resolve(op.input("W")[0])
    rids = resolve(op.input("Ids")[0])
    if rw is None or rids is None:
        return OpCost(kind="unknown",
                      note="lookup operand shape undeclared")
    n_ids = float(np.prod(rids[0], dtype=np.float64))
    width = float(rw[0][-1])
    row_bytes = width * _dtype_bytes(rw[1])
    return OpCost(0.0, n_ids * (2.0 * row_bytes + 8.0), "embedding",
                  f"{n_ids:.0f} rows x {width:.0f}")


# ---------------------------------------------------------------------------
# per-op / per-program estimation
# ---------------------------------------------------------------------------


class _FwdShim:
    """Forward-shaped view of a generic '<t>_grad' desc: a grad desc
    binds the forward's inputs AND outputs as its own inputs, so the
    forward cost fn can run against it with the slots re-partitioned."""

    def __init__(self, grad_op, fwd_info):
        self.type = fwd_info.type
        self.attrs = grad_op.attrs
        self.inputs = {s: grad_op.inputs.get(s, [])
                       for s in fwd_info.inputs}
        self.outputs = {s: grad_op.inputs.get(s, [])
                        for s in fwd_info.outputs}

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]


def _fwd_shim(grad_op, fwd_info):
    return _FwdShim(grad_op, fwd_info)


def estimate_op(op, block, batch_size: int = DEFAULT_BATCH) -> OpCost:
    """Static cost of one op desc (shapes resolved against `block`'s
    ancestor chain, -1 dims -> `batch_size`).  Unregistered or
    metadata-less types return kind="unknown" — never a silent zero."""
    resolve = _make_resolver(block, batch_size)
    try:
        info = op_registry.get_op_info(op.type)
    except KeyError:
        return OpCost(kind="unknown", note="op type not registered")

    is_grad = op.type.endswith(_GRAD) and info.type != op.type
    if info.cost_fn is not None:
        target = _fwd_shim(op, info) if is_grad else op
        cost = info.cost_fn(target, resolve)
        if is_grad and cost.known:
            mult = _GRAD_MULT.get(cost.kind, 1.0)
            cost = OpCost(cost.flops * mult, _generic_bytes(op, resolve),
                          cost.kind, cost.note + f" (grad x{mult})")
        return cost

    kind = info.cost_kind
    if kind is None and info.type in _KIND_TABLE:
        kind = _KIND_TABLE[info.type]
        info.cost_kind = kind  # memoize onto the registry metadata
    if kind is None and info.type.endswith(_GRAD):
        # explicitly-registered grad lowerings (dropout_grad,
        # split/merge_lod_tensor_grad) resolve to their OWN OpInfo, so
        # the forward-op fallback in get_op_info never fires — inherit
        # the forward type's class instead of reporting unknown
        base = _KIND_TABLE.get(info.type[: -len(_GRAD)])
        if base is not None:
            kind = info.cost_kind = base
    if kind is None:
        if info.host:
            kind = "host"
        elif any(isinstance(v, dict) and "__block__" in v
                 for v in op.attrs.values()):
            kind = "control"
        else:
            return OpCost(kind="unknown",
                          note=f"no cost metadata for {op.type!r}")
    if kind in ("free", "host", "control"):
        return OpCost(0.0, 0.0, kind)
    per_elem = _FLOPS_PER_ELEM.get(kind, 1.0)
    elems = (_in_elems(op, resolve) if kind == "reduction"
             else _out_elems(op, resolve))
    flops = per_elem * elems
    if is_grad:
        flops *= _GRAD_MULT.get(kind, 1.0)
    return OpCost(flops, _generic_bytes(op, resolve), kind)


@dataclasses.dataclass
class ProgramCostEstimate:
    """Roll-up of `estimate_op` over every block of one program."""

    batch_size: int
    device: str
    rows: List[tuple]                 # (block_idx, op_idx, op_type, OpCost)
    block_totals: Dict[int, Tuple[float, float]]   # {blk: (flops, bytes)}
    total_flops: float
    total_bytes: float
    unknown_types: Dict[str, int]     # {op_type: count} with no metadata
    n_ops: int
    peak_hbm: Dict                    # estimate_peak_hbm result

    @property
    def ai(self) -> Optional[float]:
        if not self.total_bytes:
            return None
        return self.total_flops / self.total_bytes

    def roofline(self) -> Dict:
        """Static roofline fields in the benchmark vocabulary: AI vs the
        device ridge point, the two ms floors, and the verdict."""
        peak, hbm = DEVICE_SPECS[self.device]
        out = {
            "device": self.device,
            "batch_size": self.batch_size,
            "est_flops": self.total_flops,
            "est_hbm_traffic_gb": round(self.total_bytes / 1e9, 3),
            "est_peak_hbm_gb": round(
                self.peak_hbm.get("peak_bytes", 0) / 1e9, 3),
            "n_ops": self.n_ops,
            "unknown_ops": sum(self.unknown_types.values()),
            "unknown_types": sorted(self.unknown_types),
        }
        if self.total_bytes:
            ai = self.total_flops / self.total_bytes
            out["ai_flop_per_byte"] = round(ai, 1)
            out["ridge_flop_per_byte"] = round(peak / hbm, 1)
            out["hbm_floor_ms"] = round(self.total_bytes / hbm * 1000, 3)
            out["compute_floor_ms"] = round(
                self.total_flops / peak * 1000, 3)
            out["bound"] = ("memory" if out["hbm_floor_ms"]
                            >= out["compute_floor_ms"] else "compute")
        return out

    def top_memory_bound(self, n: int = 5) -> List[tuple]:
        """The ranked worklist for the kernel tier: known-cost ops by
        traffic, with per-op AI (lowest-AI heavy ops first)."""
        ranked = sorted(
            (r for r in self.rows if r[3].known and r[3].bytes > 0),
            key=lambda r: -r[3].bytes)
        return [(blk, idx, t,
                 round(c.flops / c.bytes, 1) if c.bytes else 0.0,
                 c.bytes) for blk, idx, t, c in ranked[:n]]


def estimate_program(program, batch_size: int = DEFAULT_BATCH,
                     feed_names: Optional[Sequence[str]] = None,
                     fetch_names: Optional[Sequence[str]] = None,
                     device: str = DEFAULT_DEVICE) -> ProgramCostEstimate:
    """Walk every block, cost every op, and fold in the static peak-HBM
    estimate.  Sub-block ops are counted ONCE (a while body's trip count
    is not statically known — the summary says so via the 'control' ops
    in the table)."""
    rows: List[tuple] = []
    block_totals: Dict[int, Tuple[float, float]] = {}
    unknown: Dict[str, int] = {}
    tf = tb = 0.0
    n_ops = 0
    for block in program.blocks:
        bf = bb = 0.0
        for idx, op in enumerate(block.ops):
            c = estimate_op(op, block, batch_size)
            rows.append((block.idx, idx, op.type, c))
            n_ops += 1
            if not c.known:
                unknown[op.type] = unknown.get(op.type, 0) + 1
                continue
            bf += c.flops
            bb += c.bytes
        block_totals[block.idx] = (bf, bb)
        tf += bf
        tb += bb
    peak = estimate_peak_hbm(program, batch_size=batch_size,
                             feed_names=feed_names,
                             fetch_names=fetch_names)
    return ProgramCostEstimate(
        batch_size=batch_size, device=device, rows=rows,
        block_totals=block_totals, total_flops=tf, total_bytes=tb,
        unknown_types=unknown, n_ops=n_ops, peak_hbm=peak)


# ---------------------------------------------------------------------------
# static peak HBM (liveness + donation, the memory layer's machinery)
# ---------------------------------------------------------------------------


def estimate_peak_hbm(program, batch_size: int = DEFAULT_BATCH,
                      feed_names: Optional[Sequence[str]] = None,
                      fetch_names: Optional[Sequence[str]] = None) -> Dict:
    """Static peak live HBM of one step of the global block.

    Persistables count once (read-write state is donated by the
    executors — `plan_donation.states` — so old and new buffers never
    coexist).  Temporaries live from first def to last touch (the
    `ControlFlowGraph` liveness behind `plan_dead_frees`); fetch targets
    and sub-block-referenced names live to the end; a feed outside the
    donation plan (fetched / never consumed) also survives the whole
    step.  Returns {peak_bytes, persistable_bytes, peak_temp_bytes,
    peak_op_idx, no_free_peak_bytes} — `no_free_peak_bytes` is the same
    walk with every temp held to the end, i.e. what the step would cost
    without dead-var freeing."""
    from ..memory_optimization_transpiler import (ControlFlowGraph,
                                                  _sub_block_names,
                                                  plan_donation)

    block = program.global_block()
    resolve = _make_resolver(block, batch_size)

    def nbytes(name) -> float:
        r = resolve(name)
        if r is None:
            return 0.0
        shape, dtype = r
        return float(np.prod(shape, dtype=np.float64) if shape
                     else 1.0) * _dtype_bytes(dtype)

    persistable = set()
    persist_bytes = 0.0
    for v in program.list_vars():
        if ((v.persistable or isinstance(v, Parameter))
                and v.name not in persistable):
            persistable.add(v.name)
            persist_bytes += nbytes(v.name)

    ops = block.ops
    n = len(ops)
    if n == 0:
        return {"peak_bytes": persist_bytes,
                "persistable_bytes": persist_bytes,
                "peak_temp_bytes": 0.0, "peak_op_idx": 0,
                "no_free_peak_bytes": persist_bytes}

    cfg = ControlFlowGraph(ops)
    last = cfg.last_touch()
    first_def: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for nm in op.output_names():
            if nm and nm not in EMPTY_VAR_NAMES:
                first_def.setdefault(nm, i)

    produced = set(first_def)
    if feed_names is None:
        # feeds: consumed, never produced, not persistable
        feed_names = [nm for nm in last
                      if nm not in produced and nm not in persistable
                      and nm not in EMPTY_VAR_NAMES]
    fetch = {str(f) for f in (fetch_names or ())}
    protected = _sub_block_names(program) | fetch
    plan = plan_donation(program, feed_names, fetch)

    delta = np.zeros(n + 1, dtype=np.float64)
    nofree = 0.0
    for name in set(last) | produced:
        if (not name or name in EMPTY_VAR_NAMES
                or name in persistable):
            continue
        b = nbytes(name)
        if not b:
            continue
        nofree += b
        lo = first_def.get(name, 0)  # feeds live from step entry
        if name in protected or (name in (feed_names or ())
                                 and name not in plan.feeds):
            hi = n - 1  # survives the step (fetched / non-donatable)
        else:
            hi = last.get(name, lo)
        delta[lo] += b
        delta[hi + 1] -= b
    live = np.cumsum(delta[:n])
    peak_idx = int(np.argmax(live)) if n else 0
    peak_temp = float(live[peak_idx]) if n else 0.0
    return {
        "peak_bytes": persist_bytes + peak_temp,
        "persistable_bytes": persist_bytes,
        "peak_temp_bytes": peak_temp,
        "peak_op_idx": peak_idx,
        "no_free_peak_bytes": persist_bytes + nofree,
    }


# ---------------------------------------------------------------------------
# communication volume (the sharding plan, quantified)
# ---------------------------------------------------------------------------

_COLLECTIVE_KIND = {
    "c_allreduce_sum": "all_reduce", "c_allreduce_mean": "all_reduce",
    "c_allreduce_max": "all_reduce", "c_allgather": "all_gather",
    "c_reducescatter": "reduce_scatter", "c_broadcast": "broadcast",
    "c_ppermute": "permute",
}


@dataclasses.dataclass
class CommEstimate:
    """Per-mesh-axis communication volume of one step.

    `rows`: (axis, kind, bytes, detail) — kind in {all_reduce,
    all_gather, reduce_scatter, broadcast, permute, all_to_all, reshard,
    wire}.  Bytes are logical payload bytes (the operand tensor), the
    same payload the bucketed-overlap lowering hands its all-reduces.
    """

    rows: List[tuple] = dataclasses.field(default_factory=list)

    def add(self, axis, kind, nbytes, detail=""):
        if nbytes:
            self.rows.append((str(axis), kind, float(nbytes), detail))

    def by_axis(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for axis, kind, b, _ in self.rows:
            out.setdefault(axis, {})
            out[axis][kind] = out[axis].get(kind, 0.0) + b
        return out

    def total_bytes(self) -> float:
        return sum(b for _, _, b, _ in self.rows)


def estimate_comm(program, mesh_axes: Optional[Dict[str, int]] = None,
                  batch_axis: str = "dp",
                  batch_size: int = DEFAULT_BATCH,
                  fetch_names: Optional[Sequence[str]] = None,
                  ) -> CommEstimate:
    """Static per-axis comm volume for `program` on a mesh.

    Sources, in order: explicit `c_*` collective ops (payload = output
    tensor); gradient sync over `batch_axis` for training programs
    (payload = every trainable param's grad + each scalar mean-combined
    fetch — exactly the bucketed-overlap all-reduce payload); pending
    psums from the sharding propagation (`SpmdPlan.reduce_ops`, the
    row-parallel matmul reductions); resharding hotspots quantified
    (bytes of the operand that must be gathered); pserver `send` ops as
    wire bytes.  With no mesh (none declared on the program, none
    passed) only the explicit-collective and wire rows apply."""
    from ..parallel.spmd import has_annotations, propagate_sharding

    block = program.global_block()
    resolve = _make_resolver(block, batch_size)
    mesh = dict(mesh_axes) if mesh_axes is not None else (
        dict(program.mesh_axes) if program.mesh_axes else None)
    est = CommEstimate()

    def nbytes(name) -> float:
        r = resolve(name)
        if r is None:
            return 0.0
        return float(np.prod(r[0], dtype=np.float64) if r[0]
                     else 1.0) * _dtype_bytes(r[1])

    # 1. explicit collectives, any block
    for blk in program.blocks:
        for op in blk.ops:
            kind = _COLLECTIVE_KIND.get(op.type)
            if kind is None:
                continue
            try:
                info = op_registry.get_op_info(op.type)
                attrs = {**info.attrs, **op.attrs}
            except KeyError:
                attrs = op.attrs
            ring = attrs.get("ring_id", "?")
            names = op.output_names() or op.input_names()
            b = sum(nbytes(nm) for nm in names
                    if nm not in EMPTY_VAR_NAMES)
            est.add(ring, kind, b, f"{op.type} (block {blk.idx})")

    # 2. gradient sync over the batch axis (training program on a mesh)
    if mesh and int(mesh.get(batch_axis, 1)) > 1:
        produced = {nm for op in block.ops for nm in op.output_names()}
        grad_bytes, n_grads = 0.0, 0
        for v in block.vars.values():
            if isinstance(v, Parameter) and getattr(v, "trainable", True):
                if grad_var_name(v.name) in produced:
                    grad_bytes += nbytes(v.name)
                    n_grads += 1
        if n_grads:
            est.add(batch_axis, "all_reduce", grad_bytes,
                    f"gradient sync ({n_grads} grads)")
        for f in fetch_names or ():
            v = block.vars.get(str(f))
            if v is None or (v.shape and v.shape[0] == -1):
                continue  # per-row fetches stay sharded
            if v.op is not None and v.op.type in ("mean", "accuracy"):
                est.add(batch_axis, "all_reduce", nbytes(v.name),
                        f"fetch combine ({v.name})")

    # 3. sharding-annotation derived rows
    if has_annotations(block):
        plan = propagate_sharding(program, mesh_axes=mesh,
                                  batch_axis=batch_axis)
        for idx, axes in sorted(plan.reduce_ops.items()):
            op = block.ops[idx]
            out = (op.outputs.get("Out") or [None])[0]
            b = nbytes(out) if out else 0.0
            for ax in axes:
                est.add(ax, "all_reduce", b,
                        f"row-parallel {op.type} psum (op {idx})")
        for f in plan.findings:
            if f.severity != "warning" or "all-gather" not in f.message:
                continue
            m = re.search(r"input '([^']+)'", f.message)
            if not m or f.op_idx is None:
                continue
            operand = m.group(1)
            from ..core.framework import sharding_axes

            # the gather is over the FEATURE dim — attribute its bytes
            # to the feature entry's axes, not the batch sharding that
            # rode along on dim 0
            spec = plan.var_specs.get(operand)
            feat = spec[-1] if spec else None
            axes = (sharding_axes((feat,)) if feat is not None
                    else sharding_axes(spec)) or ["?"]
            est.add(",".join(sorted(set(axes))), "reshard",
                    nbytes(operand),
                    f"{f.op_type} gathers {operand!r} (op {f.op_idx})")

    # 4. pserver wire traffic
    for op in block.ops:
        if op.type != "send":
            continue
        sent = sum(nbytes(nm) for nm in op.input("X")
                   if nm not in EMPTY_VAR_NAMES)
        pulled = sum(nbytes(nm) for nm in op.output("Out")
                     if nm not in EMPTY_VAR_NAMES)
        est.add("wire", "wire", sent + pulled,
                f"send op ({len(op.input('X'))} grads out, "
                f"{len(op.output('Out'))} params back)")
    return est


# ---------------------------------------------------------------------------
# serving-path kernels (never Program ops — spec-driven entries)
# ---------------------------------------------------------------------------

SERVING_KERNELS: Dict[str, Callable] = {}


def register_serving_kernel(name: str):
    """Register `fn(spec, **kw) -> dict` as the cost entry for a named
    serving kernel (the decode-path functions that never appear as
    Program ops).  The entry documents its operand shapes in the
    returned dict (`shapes` key) so `cli analyze` can print them."""

    def deco(fn):
        SERVING_KERNELS[name] = fn
        return fn

    return deco


def serving_kernel_cost(name: str, spec: Dict, **kw) -> Dict:
    if name not in SERVING_KERNELS:
        raise KeyError(f"serving kernel {name!r} has no cost entry; "
                       f"known: {sorted(SERVING_KERNELS)}")
    return SERVING_KERNELS[name](spec, **kw)


def _kv_elem_bytes(kv_dtype: str, block_size: int, d_model: int) -> float:
    """Resident bytes per K/V element, matching the paged decoder's own
    accounting (models/transformer.build_lm_paged_decoder
    `bytes_per_block`): int8 stores one f32 scale per (layer, block), so
    the per-element overhead is 4/(block_size*d_model) — NOT a flat
    surcharge."""
    if kv_dtype == "bf16":
        return 2.0
    if kv_dtype == "int8":
        return 1.0 + 4.0 / (block_size * d_model)
    return 4.0


def _spec_dims(spec: Dict):
    d = int(spec["d_model"])
    h = int(spec["n_heads"])
    layers = int(spec["n_layers"])
    v = int(spec["vocab_size"])
    di = int(spec.get("d_inner") or 4 * d)
    bs = int(spec.get("block_size", 16))
    nb = int(spec.get("max_blocks_per_seq", 64))
    return d, h, layers, v, di, bs, nb


def _lm_param_bytes(spec: Dict) -> float:
    """f32 parameter bytes of the paged-decoder LM (models/transformer
    `_lm_param_structure`): token embedding + position table + per-layer
    4 attention projections + FFN pair + layer norms + logits."""
    d, _, layers, v, di, bs, nb = _spec_dims(spec)
    max_len = bs * nb
    per_layer = 4 * (d * d + d) + (d * di + di) + (di * d + d) + 4 * d
    return 4.0 * (v * d + max_len * d + layers * per_layer
                  + 2 * d + d * v + v)


@register_serving_kernel("paged_attention_gather")
def _paged_attention_gather_cost(spec: Dict, slots: int = 1,
                                 context: Optional[int] = None,
                                 kv_dtype: str = "fp32", **_) -> Dict:
    """Gather-through-block-table attention for ONE query position per
    slot: K/V [n_layers, blocks, block_size, d_model] gathered through
    the table to `context` logical positions, dequantized, then QK^T +
    att*V (2*ctx*d each, per layer).

    Bytes charge BOTH legs of the composition: the pool reads in
    storage precision AND the logical-order f32 gathered copy the plain
    path materializes (written, then re-read by the einsums) — the
    traffic the fused `paged_attention_decode` kernel deletes."""
    d, h, layers, v, di, bs, nb = _spec_dims(spec)
    ctx = int(context if context is not None else bs * nb)
    kvb = _kv_elem_bytes(kv_dtype, bs, d)
    flops = slots * layers * 4.0 * ctx * d
    pool_bytes = slots * layers * 2.0 * ctx * d * kvb
    copy_bytes = slots * layers * 2.0 * ctx * d * 8.0
    return {
        "kernel": "paged_attention_gather",
        "shapes": {"pool": f"[{layers}, blocks, {bs}, {d}] x2 ({kv_dtype})",
                   "tables": f"[{slots}, {nb}] int32",
                   "query": f"[{slots}, {h}, {d // max(h, 1)}]"},
        "flops": flops, "bytes": pool_bytes + copy_bytes,
        "pool_bytes": pool_bytes, "copy_bytes": copy_bytes,
        "context": ctx, "slots": slots,
    }


@register_serving_kernel("paged_attention_decode")
def _paged_attention_decode_cost(spec: Dict, slots: int = 1,
                                 context: Optional[int] = None,
                                 kv_dtype: str = "fp32",
                                 window: int = 1, **_) -> Dict:
    """The hand-written CUDA decode-attention kernel
    (kernels/paged_attention.py, csrc/paged_attention.cu): K/V blocks
    stream through the block table straight into registers and shared
    memory, dequantized there, split over the context — same flops as
    the gather composition, and the same pool bytes, but the plain
    path's logical-order f32 copy of the gathered context (written then
    re-read in device memory) never exists.  `gather_copy_bytes_avoided`
    quantifies that saved traffic."""
    d, h, layers, v, di, bs, nb = _spec_dims(spec)
    ctx = int(context if context is not None else bs * nb)
    kvb = _kv_elem_bytes(kv_dtype, bs, d)
    flops = slots * window * layers * 4.0 * ctx * d
    # pool-block reads only, in storage precision: q/out traffic is the
    # step row's act_bytes, and the oracle's logical-order f32 copy
    # (write + re-read) simply never exists on this path
    pool_bytes = slots * layers * 2.0 * ctx * d * kvb
    return {
        "kernel": "paged_attention_decode",
        "backend": "cuda",
        "shapes": {"pool": f"[{layers}, blocks, {bs}, {d}] x2 ({kv_dtype})",
                   "tables": f"[{slots}, {nb}] int32",
                   "query": f"[{slots}, {window}, {d}]"},
        "flops": flops, "bytes": pool_bytes,
        # what the oracle pays on top: the dequantized logical-order
        # copy, f32, materialized (write) and consumed (read) per layer
        "gather_copy_bytes_avoided": slots * layers * 2.0 * ctx * d
        * 8.0,
        "fused_dequant": kv_dtype != "fp32",
        "context": ctx, "slots": slots, "window": window,
    }


@register_serving_kernel("moe_gate_dispatch")
def _moe_gate_dispatch_cost(spec: Dict, tokens: int = 0,
                            num_experts: int = 0, capacity: int = 0,
                            top_k: int = 1, **_) -> Dict:
    """The fused MoE gate+dispatch kernel (kernels/moe_dispatch.py,
    csrc/moe_dispatch.cu): gate logits, softmax, top-k routing,
    capacity cumsum and the dispatch contraction in one pass.  Emits only expert_in/combine;
    `routing_bytes_avoided` is the [T, E]/[T, E, C] routing traffic the
    plain version materializes in device memory between its ~15
    ops."""
    d, _, _, _, _, _, _ = _spec_dims(spec)
    T = int(tokens or spec.get("tokens") or 0)
    E = int(num_experts or spec.get("num_experts") or 0)
    C = int(capacity or max(1, int(1.25 * top_k * T / max(E, 1))))
    flops = (2.0 * T * d * E              # gate logits
             + 2.0 * T * E * C * d * top_k)  # dispatch contraction
    bytes_ = 4.0 * (T * d + d * E + E * C * d + T * E * C)
    return {
        "kernel": "moe_gate_dispatch",
        "backend": "cuda",
        "shapes": {"x": f"[{T}, {d}]", "gate_w": f"[{d}, {E}]",
                   "expert_in": f"[{E}, {C}, {d}]",
                   "combine": f"[{T}, {E}, {C}]"},
        "flops": flops, "bytes": bytes_,
        "routing_bytes_avoided": 4.0 * (T * E * C + 6.0 * T * E),
        "tokens": T, "num_experts": E, "capacity": C, "top_k": top_k,
    }


@register_serving_kernel("fused_bucket_update")
def _fused_bucket_update_cost(spec: Dict, numel: int = 0,
                              n_params: int = 1, **_) -> Dict:
    """The fused per-bucket optimizer update (kernels/fused_update.py,
    csrc/fused_update.cu):
    p -= lr*g over one concatenated flat bucket — the bytes are the
    same as the per-parameter chain (read p, read g, write p), the win
    is `launches_replaced` dispatches collapsing into one."""
    n = int(numel or spec.get("numel") or 0)
    return {
        "kernel": "fused_bucket_update",
        "backend": "cuda",
        "shapes": {"flat_params": f"[{n}] f32",
                   "flat_grads": f"[{n}] f32"},
        "flops": 2.0 * n, "bytes": 12.0 * n,
        "launches_replaced": int(n_params),
        "numel": n,
    }


@register_serving_kernel("paged_decode_step")
def _paged_decode_step_cost(spec: Dict, slots: int = 1,
                            context: Optional[int] = None,
                            kv_dtype: str = "fp32",
                            window: int = 1,
                            device: str = DEFAULT_DEVICE,
                            backend: str = "plain", **_) -> Dict:
    """One decode tick: `window` teacher-forced positions per slot in a
    single dispatch (window=1 is `decoder.step`, window=k+1 is the
    speculative-verify / chunked-prefill `step_window`).  Parameters
    stream from HBM ONCE per dispatch — which is why AI scales with
    slots*window and speculative decoding pays: the roofline argument,
    statically.

    `backend` picks the attention sub-cost: "plain" (default) is the
    gather composition (the decoder's plain PyTorch path), "cuda" the
    hand-written paged-attention kernel — the row then reflects what
    the serving-kernel tier actually runs."""
    d, h, layers, v, di, bs, nb = _spec_dims(spec)
    ctx = int(context if context is not None else bs * nb)
    kvb = _kv_elem_bytes(kv_dtype, bs, d)
    per_pos = layers * (8.0 * d * d + 4.0 * d * di) + 2.0 * d * v
    if backend == "cuda":
        att = serving_kernel_cost("paged_attention_decode", spec,
                                  slots=slots, context=ctx,
                                  kv_dtype=kv_dtype, window=window)
    else:
        att = serving_kernel_cost("paged_attention_gather", spec,
                                  slots=slots * window, context=ctx,
                                  kv_dtype=kv_dtype)
    flops = slots * window * per_pos + att["flops"]
    param_bytes = _lm_param_bytes(spec)
    kv_write = slots * window * layers * 2.0 * d * kvb
    act_bytes = slots * window * (d * 8.0 + v * 4.0)
    tbytes = param_bytes + att["bytes"] + kv_write + act_bytes
    ai = flops / tbytes if tbytes else 0.0
    peak, hbm = DEVICE_SPECS[device]
    return {
        "kernel": ("paged_decode_step" if window == 1
                   else f"paged_decode_step_window(W={window})"),
        "backend": backend,
        "shapes": {"tokens": f"[{slots}, {window}] int32",
                   "positions": f"[{slots}] int32",
                   "logits": f"[{slots}, {window}, {v}]"},
        "flops": flops, "bytes": tbytes,
        "param_bytes": param_bytes,
        "ai_flop_per_byte": round(ai, 2),
        "ridge_flop_per_byte": round(peak / hbm, 1),
        "bound": "memory" if ai < peak / hbm else "compute",
        "flops_per_token": flops / max(slots * window, 1),
        "slots": slots, "window": window, "kv_dtype": kv_dtype,
    }


def _resolve_decode_backend(spec: Dict, kv_dtype: str) -> str:
    """What the serving-kernel tier would actually run for this spec on
    THIS process's platform (docs/performance.md "Serving kernels") —
    so the analyze report's rows reflect reality, not aspiration.

    -> "cuda" when the kernel registry arms the tier on the platform
    torch reports ("cuda" with a card, else "cpu") and the hand-written
    paged-attention kernel supports the spec's geometry — the label
    `decoder.kernels["paged_attention_decode"]` carries for that
    kernel; else "plain", the gather composition of the decoder's plain
    PyTorch path (its label there is "plain:<reason>").  Best-effort:
    a static analyzer must never fail on registry absence."""
    try:
        import torch

        from ..kernels import registry as kreg
        from ..kernels.paged_attention import paged_attention_supports

        platform = "cuda" if torch.cuda.is_available() else "cpu"
        if not kreg.kernels_armed(platform):
            return "plain"
        d, h, layers, v, di, bs, nb = _spec_dims(spec)
        reason = paged_attention_supports(
            d_model=d, n_heads=h, block_size=bs,
            max_blocks_per_seq=nb, kv_dtype=kv_dtype,
            platform=platform)
        return "plain" if reason else "cuda"
    except Exception:
        return "plain"


def analyze_generation_spec(spec: Dict, slots: Optional[int] = None,
                            kv_dtype: Optional[str] = None,
                            device: str = DEFAULT_DEVICE) -> Dict:
    """Static cost report for a generation model dir's `generation.json`
    spec: decode-step rows at window=1 and at the speculative window
    (spec_k+1 when armed), the gather-attention term, and KV-block
    sizing — everything `cli analyze MODEL_DIR` prints without building
    a decoder or compiling a step."""
    d, h, layers, v, di, bs, nb = _spec_dims(spec)
    s = int(slots or spec.get("slots") or 8)
    kd = str(kv_dtype or spec.get("kv_dtype") or "fp32")
    ctx = bs * nb
    backend = _resolve_decode_backend(spec, kd)
    rows = [serving_kernel_cost("paged_decode_step", spec, slots=s,
                                context=ctx // 2, kv_dtype=kd,
                                device=device, backend=backend)]
    spec_k = int(spec.get("spec_k") or 0)
    if spec.get("draft") or spec_k:
        rows.append(serving_kernel_cost(
            "paged_decode_step", spec, slots=s, context=ctx // 2,
            kv_dtype=kd, window=(spec_k or 4) + 1, device=device,
            backend=backend))
    if backend == "cuda":
        rows.append(serving_kernel_cost("paged_attention_decode",
                                        spec, slots=s,
                                        context=ctx // 2,
                                        kv_dtype=kd))
    rows.append(serving_kernel_cost("paged_attention_gather", spec,
                                    slots=s, context=ctx // 2,
                                    kv_dtype=kd))
    bytes_per_block = 2.0 * layers * bs * d * _kv_elem_bytes(kd, bs, d)
    return {
        "model": {"d_model": d, "n_heads": h, "n_layers": layers,
                  "vocab_size": v, "d_inner": di, "block_size": bs,
                  "max_blocks_per_seq": nb, "kv_dtype": kd, "slots": s},
        "param_bytes": _lm_param_bytes(spec),
        "bytes_per_block": bytes_per_block,
        "kernels": rows,
    }


# ---------------------------------------------------------------------------
# budget gate
# ---------------------------------------------------------------------------


def check_budget(report: Dict, budget: Dict) -> List[str]:
    """Compare one program's analyze report against its budget entry;
    returns human-readable violations (empty = within budget).

    Budget keys (all optional): `max_flops_g`, `max_hbm_traffic_gb`,
    `max_peak_hbm_gb`, `bound` ("memory"/"compute" — the verdict must
    match), `max_comm_gb` ({axis: GB} over the comm table),
    `max_unknown_ops` (cost-metadata coverage floor, default 0 when the
    key is present).  See docs/analysis.md for the file format."""
    out = []

    def over(key, actual, limit, unit="GB"):
        if limit is not None and actual > float(limit):
            out.append(f"{key}: {actual:.3f} {unit} exceeds budget "
                       f"{float(limit):.3f} {unit}")

    roof = report.get("roofline", {})
    if "max_flops_g" in budget:
        over("flops", roof.get("est_flops", 0.0) / 1e9,
             budget["max_flops_g"], "GFLOP")
    if "max_hbm_traffic_gb" in budget:
        over("hbm_traffic", roof.get("est_hbm_traffic_gb", 0.0),
             budget["max_hbm_traffic_gb"])
    if "max_peak_hbm_gb" in budget:
        over("peak_hbm", roof.get("est_peak_hbm_gb", 0.0),
             budget["max_peak_hbm_gb"])
    want_bound = budget.get("bound")
    if want_bound and roof.get("bound") and roof["bound"] != want_bound:
        out.append(f"bound verdict changed: {roof['bound']!r} "
                   f"(budget expects {want_bound!r})")
    if "max_unknown_ops" in budget:
        actual = int(roof.get("unknown_ops", 0))
        if actual > int(budget["max_unknown_ops"]):
            out.append(
                f"unknown-cost ops: {actual} exceed budget "
                f"{int(budget['max_unknown_ops'])} "
                f"(types: {roof.get('unknown_types')})")
    limits = budget.get("max_comm_gb") or {}
    comm = report.get("comm", {})
    for axis, limit in limits.items():
        actual = sum(comm.get(axis, {}).values()) / 1e9
        over(f"comm[{axis}]", actual, limit)
    return out


# ---------------------------------------------------------------------------
# analysis passes: cost-model + comm-volume
# ---------------------------------------------------------------------------


@register_pass("cost-model", order=85)
def check_cost_model(ctx):
    """Static roofline summary (info) + cost-metadata coverage: the
    per-op estimators roll up into program FLOPs, HBM traffic, AI vs
    the default device's ridge point, and the liveness-based peak-HBM
    estimate (batch assumed when feeds carry -1 dims).  Ops without
    cost metadata are reported (info) — they are excluded from the
    totals, never silently zero (docs/analysis.md)."""
    est = estimate_program(ctx.program,
                           feed_names=ctx.feed_names,
                           fetch_names=ctx.fetch_names)
    if (not est.total_flops and not est.total_bytes
            and not est.unknown_types):
        return  # startup / empty programs carry no roofline signal
    roof = est.roofline()
    if est.total_flops or est.total_bytes:
        msg = (f"static roofline (batch {est.batch_size} assumed): "
               f"{est.total_flops / 1e9:.2f} GFLOP, "
               f"{est.total_bytes / 1e9:.3f} GB traffic")
        if "ai_flop_per_byte" in roof:
            msg += (f", AI {roof['ai_flop_per_byte']} vs ridge "
                    f"{roof['ridge_flop_per_byte']} flop/B "
                    f"({est.device}) -> {roof['bound']}-bound")
        msg += f"; est peak HBM {roof['est_peak_hbm_gb']} GB"
        yield ctx.diag("info", msg, ctx.program.blocks[0])
    if est.unknown_types:
        kinds = ", ".join(f"{t} x{c}"
                          for t, c in sorted(est.unknown_types.items()))
        yield ctx.diag(
            "info",
            f"{sum(est.unknown_types.values())} op(s) have no cost "
            f"metadata and are excluded from the totals: {kinds}",
            ctx.program.blocks[0],
            hint="register metadata via core.registry.register_op_cost "
                 "(or cost= on register_op) so the roofline covers them")


@register_pass("comm-volume", order=86)
def check_comm_volume(ctx):
    """Quantified communication volume (info): per-mesh-axis bytes
    all-reduced / gathered / resharded, from explicit collectives, the
    gradient-sync payload, and the sharding propagation's pending psums
    + resharding hotspots — the byte counts behind the qualitative
    `sharding-consistency` warnings.  Programs with no mesh, no
    annotations, and no collective/send ops skip the pass."""
    from ..parallel.spmd import has_annotations

    program = ctx.program
    block = program.global_block()
    has_coll = any(op.type in _COLLECTIVE_KIND or op.type == "send"
                   for blk in program.blocks for op in blk.ops)
    if (not program.mesh_axes and not has_annotations(block)
            and not has_coll):
        return
    est = estimate_comm(program, fetch_names=ctx.fetch_names)
    for axis, kinds in sorted(est.by_axis().items()):
        detail = ", ".join(f"{k} {b / 1e6:.3f} MB"
                           for k, b in sorted(kinds.items()))
        yield ctx.diag(
            "info",
            f"comm volume over {axis!r} per step: {detail}",
            block)


_install_kind_table()
