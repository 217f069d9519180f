"""Recurrent ops: lstm (dynamic_lstm), lstmp, gru (dynamic_gru),
lstm_unit and gru_unit (counterpart of paddle_tpu/ops/rnn.py).

Reference: PaddlePaddle's operators/{lstm,lstmp,gru,lstm_unit,
gru_unit}_op.cc and math/{lstm,gru}_compute.

The JAX package pads the sequences to [B, T, .] with a static index and
mask built from the LoD and runs the recurrence as one `lax.scan` with
masked state updates.  Here the same step is a plain PyTorch loop over
the padded time axis (one matmul and the gate math a step), the padded
gather and the repack being ops/sequence.py's host-built, deterministic
row plans.  Its gradient is autograd's through the loop
(core/execution.generic_grad_lower).  Not `torch.nn.LSTM`/`GRU` or
cuDNN's RNN: they have no peepholes, no choice of gate activation, and
cuDNN's GRU applies the reset gate after the product.

Gate layouts (as the JAX package's, for checkpoint portability):
  lstm Input/Weight 4D blocks: [i, f, c (candidate), o]; Bias [1, 4D],
       or [1, 7D] with the peepholes w_ic, w_fc, w_oc after the gates;
  gru  Input 3D blocks: [u (update), r (reset), c (candidate)];
       Weight = [D, 2D] (u, r) beside [D, D] (candidate), applied to
       r * h_prev.
H0/C0 rows are in LoD order (sequence i's initial state is row i).
"""
from __future__ import annotations

import torch

from ..core.execution import data_of, one
from ..core.lod import LoDTensor
from ..core.registry import register_infer_shape, register_op
from ..core.shape_inference import input_var, set_output_shape
from .sequence import gather_rows, padded_rows, repack_rows

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _mm(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _padded(ctx, xv: LoDTensor, reverse=False):
    """-> (the input as [T, B, W], the mask as [T, B, 1], B, T)."""
    lod = xv.lod[-1]
    rows, mask, t = padded_rows(ctx, lod, xv.data.device, reverse)
    b = mask.shape[0]
    x = gather_rows(xv.data, rows).reshape((b, t) + tuple(xv.data.shape[1:]))
    return x.transpose(0, 1), mask.t()[:, :, None], b, t


def _repack(ctx, steps, xv, reverse=False):
    """[T] step outputs [B, W] -> the packed rows of xv's LoD."""
    lod = xv.lod[-1]
    padded = torch.stack(steps, dim=1)              # [B, T, W]
    b, t = padded.shape[:2]
    flat = padded.reshape((b * t,) + tuple(padded.shape[2:]))
    return LoDTensor(gather_rows(flat, repack_rows(ctx, lod, t, flat.device,
                                                   reverse)), xv.lod)


@register_op("lstm",
             inputs=("Input", "H0", "C0", "Weight", "Bias"),
             outputs=("Hidden", "Cell", "BatchGate", "BatchCellPreAct"),
             attrs={"use_peepholes": True, "is_reverse": False,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh"},
             diff_inputs=("Input", "H0", "C0", "Weight", "Bias"),
             diff_outputs=("Hidden", "Cell"), lod=True)
def lstm(ctx, ins, attrs):
    xv = one(ins, "Input")                   # LoDTensor [N, 4D]
    w = data_of(one(ins, "Weight"))          # [D, 4D]
    bias = one(ins, "Bias")                  # [1, 4D] or [1, 7D]
    d = w.shape[0]
    gact = _ACT[attrs["gate_activation"]]
    cact = _ACT[attrs["cell_activation"]]
    candact = _ACT[attrs["candidate_activation"]]
    peep = attrs.get("use_peepholes", True)
    rev = attrs.get("is_reverse", False)

    xs, ms, bsz, t = _padded(ctx, xv, rev)
    w_ic = w_fc = w_oc = None
    if bias is not None:
        b = data_of(bias).reshape(-1)
        xs = xs + b[:4 * d]
        if peep and b.shape[0] >= 7 * d:
            w_ic, w_fc, w_oc = b[4 * d:5 * d], b[5 * d:6 * d], b[6 * d:7 * d]
    if w_ic is None:
        w_ic = w_fc = w_oc = torch.zeros((d,), dtype=xs.dtype,
                                         device=xs.device)
    h0, c0 = one(ins, "H0"), one(ins, "C0")
    h = (data_of(h0) if h0 is not None
         else torch.zeros((bsz, d), dtype=xs.dtype, device=xs.device))
    c = (data_of(c0) if c0 is not None
         else torch.zeros((bsz, d), dtype=xs.dtype, device=xs.device))
    hs, cs, gs = [], [], []
    for step in range(t):
        m = ms[step]
        gates = xs[step] + _mm(h, w)         # [B, 4D]
        gi, gf, gc, go = torch.split(gates, d, dim=1)
        i = gact(gi + w_ic * c)
        f = gact(gf + w_fc * c)
        c_new = f * c + i * candact(gc)
        o = gact(go + w_oc * c_new)
        h_new = o * cact(c_new)
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
        gs.append(gates)
    hidden, cell = _repack(ctx, hs, xv, rev), _repack(ctx, cs, xv, rev)
    return {"Hidden": hidden, "Cell": cell,
            "BatchGate": _repack(ctx, gs, xv, rev), "BatchCellPreAct": cell}


@register_op("lstmp",
             inputs=("Input", "H0", "C0", "Weight", "ProjWeight", "Bias"),
             outputs=("Projection", "Cell", "BatchGate",
                      "BatchHidden", "BatchCellPreAct"),
             attrs={"use_peepholes": True, "is_reverse": False,
                    "gate_activation": "sigmoid",
                    "cell_activation": "tanh",
                    "candidate_activation": "tanh",
                    "proj_activation": "tanh"},
             diff_inputs=("Input", "Weight", "ProjWeight", "Bias"),
             diff_outputs=("Projection",), lod=True)
def lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection (the reference lstmp_op.cc):
    r_t = proj_act(h_t @ P) is the recurrent input.  As the JAX
    package's: no peepholes, zero initial states."""
    xv = one(ins, "Input")                    # [N, 4D]
    w = data_of(one(ins, "Weight"))           # [P, 4D]
    pw = data_of(one(ins, "ProjWeight"))      # [D, P]
    bias = one(ins, "Bias")
    d, p_dim = pw.shape
    gact = _ACT[attrs["gate_activation"]]
    cact = _ACT[attrs["cell_activation"]]
    candact = _ACT[attrs["candidate_activation"]]
    pact = _ACT[attrs["proj_activation"]]
    rev = attrs.get("is_reverse", False)
    xs, ms, bsz, t = _padded(ctx, xv, rev)
    if bias is not None:
        xs = xs + data_of(bias).reshape(-1)[:4 * d]
    r = torch.zeros((bsz, p_dim), dtype=xs.dtype, device=xs.device)
    c = torch.zeros((bsz, d), dtype=xs.dtype, device=xs.device)
    rs, cs = [], []
    for step in range(t):
        m = ms[step]
        gates = xs[step] + _mm(r, w)
        gi, gf, gc, go = torch.split(gates, d, dim=1)
        c_new = gact(gf) * c + gact(gi) * candact(gc)
        r_new = pact(_mm(gact(go) * cact(c_new), pw))
        r = m * r_new + (1 - m) * r
        c = m * c_new + (1 - m) * c
        rs.append(r)
        cs.append(c)
    proj, cell = _repack(ctx, rs, xv, rev), _repack(ctx, cs, xv, rev)
    return {"Projection": proj, "Cell": cell, "BatchGate": proj,
            "BatchHidden": proj, "BatchCellPreAct": cell}


@register_op("gru",
             inputs=("Input", "H0", "Weight", "Bias"),
             outputs=("Hidden", "BatchGate", "BatchResetHiddenPrev",
                      "BatchHidden"),
             attrs={"is_reverse": False, "gate_activation": "sigmoid",
                    "activation": "tanh"},
             diff_inputs=("Input", "H0", "Weight", "Bias"),
             diff_outputs=("Hidden",), lod=True)
def gru(ctx, ins, attrs):
    xv = one(ins, "Input")                    # [N, 3D]
    w = data_of(one(ins, "Weight"))           # [D, 3D]: [u, r | cand]
    bias = one(ins, "Bias")
    d = w.shape[0]
    gact = _ACT[attrs["gate_activation"]]
    act = _ACT[attrs["activation"]]
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    rev = attrs.get("is_reverse", False)
    xs, ms, bsz, t = _padded(ctx, xv, rev)
    if bias is not None:
        xs = xs + data_of(bias).reshape(-1)
    h0 = one(ins, "H0")
    h = (data_of(h0) if h0 is not None
         else torch.zeros((bsz, d), dtype=xs.dtype, device=xs.device))
    hs = []
    for step in range(t):
        m, x_t = ms[step], xs[step]
        ur = gact(x_t[:, :2 * d] + _mm(h, w_ur))
        u, r = torch.split(ur, d, dim=1)
        cand = act(x_t[:, 2 * d:] + _mm(r * h, w_c))
        # the reference gru_compute: h = h_prev + u * (cand - h_prev)
        h_new = h + u * (cand - h)
        h = m * h_new + (1 - m) * h
        hs.append(h)
    hidden = _repack(ctx, hs, xv, rev)
    return {"Hidden": hidden, "BatchGate": hidden,
            "BatchResetHiddenPrev": hidden, "BatchHidden": hidden}


@register_op("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"),
             attrs={"forget_bias": 0.0})
def lstm_unit(ctx, ins, attrs):
    """One LSTM step on dense tensors (the reference lstm_unit_op.cc;
    gate order i, f, o, c as its kernel's)."""
    x = one(ins, "X")                         # [B, 4D]
    c_prev = one(ins, "C_prev")               # [B, D]
    gi, gf, go, gc = torch.chunk(x, 4, dim=1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(go)
    c = f * c_prev + i * torch.tanh(gc)
    return {"C": c, "H": o * torch.tanh(c)}


@register_op("gru_unit",
             inputs=("Input", "HiddenPrev", "Weight", "Bias"),
             outputs=("Gate", "ResetHiddenPrev", "Hidden"),
             attrs={"activation": "tanh", "gate_activation": "sigmoid"},
             diff_outputs=("Hidden",))
def gru_unit(ctx, ins, attrs):
    x = one(ins, "Input")                     # [B, 3D]
    h_prev = one(ins, "HiddenPrev")           # [B, D]
    w = one(ins, "Weight")                    # [D, 3D]
    d = h_prev.shape[1]
    bias = one(ins, "Bias")
    if bias is not None:
        x = x + bias.reshape(-1)
    gact = _ACT[attrs["gate_activation"]]
    act = _ACT[attrs["activation"]]
    ur = gact(x[:, :2 * d] + _mm(h_prev, w[:, :2 * d]))
    u, r = torch.split(ur, d, dim=1)
    rh = r * h_prev
    cand = act(x[:, 2 * d:] + _mm(rh, w[:, 2 * d:]))
    h = h_prev + u * (cand - h_prev)
    return {"Gate": torch.cat([u, r, cand], dim=1), "ResetHiddenPrev": rh,
            "Hidden": h}


# ---------------------------------------------------------------------------
# explicit build-time shape inference: row counts follow the input rows,
# widths the weights
# ---------------------------------------------------------------------------


@register_infer_shape("lstm")
def _infer_lstm(op, block):
    x = input_var(op, block, "Input")
    w = input_var(op, block, "Weight")
    if x is None or x.shape is None or w is None or w.shape is None:
        return
    n, d = x.shape[0], w.shape[0]
    set_output_shape(op, block, "Hidden", (n, d), x.dtype)
    set_output_shape(op, block, "Cell", (n, d), x.dtype)
    set_output_shape(op, block, "BatchGate", (n, 4 * d), x.dtype)
    set_output_shape(op, block, "BatchCellPreAct", (n, d), x.dtype)


@register_infer_shape("lstmp")
def _infer_lstmp(op, block):
    x = input_var(op, block, "Input")
    w = input_var(op, block, "Weight")          # [P, 4D]
    pw = input_var(op, block, "ProjWeight")     # [D, P]
    if any(v is None or v.shape is None for v in (x, w, pw)):
        return
    n, d, p = x.shape[0], w.shape[1] // 4, pw.shape[1]
    set_output_shape(op, block, "Projection", (n, p), x.dtype)
    set_output_shape(op, block, "Cell", (n, d), x.dtype)
    set_output_shape(op, block, "BatchGate", (n, 4 * d), x.dtype)
    set_output_shape(op, block, "BatchHidden", (n, d), x.dtype)
    set_output_shape(op, block, "BatchCellPreAct", (n, d), x.dtype)


@register_infer_shape("gru")
def _infer_gru(op, block):
    x = input_var(op, block, "Input")
    w = input_var(op, block, "Weight")          # [D, 3D]
    if x is None or x.shape is None or w is None or w.shape is None:
        return
    n, d = x.shape[0], w.shape[0]
    set_output_shape(op, block, "Hidden", (n, d), x.dtype)
    set_output_shape(op, block, "BatchGate", (n, 3 * d), x.dtype)
    set_output_shape(op, block, "BatchResetHiddenPrev", (n, d), x.dtype)
    set_output_shape(op, block, "BatchHidden", (n, d), x.dtype)
