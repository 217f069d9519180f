"""Distributed variable-transfer ops: send / recv / listen_and_serv
(counterpart of paddle_tpu/ops/distributed.py).

Reference: Paddle's paddle/fluid/operators/send_op.cc:44-94,
recv_op.cc:28-53, listen_and_serv_op.cc:56-185.  Host ops over the
parallel.pserver TCP transport (the gRPC layer's stand-in), with the
JAX package's slots, attributes and wire.

A trainer's `send` or `recv` writes each pulled parameter INTO the
tensor the scope already holds for it (`copy_`, a host-to-device copy
on a card), so a captured CUDA graph of the next step, which reads that
tensor at its captured address, reads the new values; a name the scope
holds no tensor of the same size for gets the pulled value on the
op's device.
"""
from __future__ import annotations

import torch

from ..core.execution import data_of, many
from ..core.lod import LoDTensor, SelectedRows
from ..core.registry import register_op


def reset_clients():
    from ..parallel.comm import reset_comm_pool

    reset_comm_pool()


def _run_scope(ctx):
    """The scope an op's executor runs against: the root of its env's
    scope chain (the env of a run is a local scope under it), else the
    global scope."""
    scope = getattr(getattr(ctx, "env", None), "scope", None)
    if scope is None:
        from ..core.executor import global_scope

        return global_scope()
    while scope.parent is not None:
        scope = scope.parent
    return scope


def _current(ctx, name):
    env = getattr(ctx, "env", None)
    if env is None:
        return None
    try:
        return env.get(name)
    except RuntimeError:    # a persistable with no value yet
        return None


def _to_host(v):
    """A grad as host tensors: one device-to-host copy a tensor (a
    SelectedRows' rows and values, a LoDTensor's data)."""
    from ..parallel.pserver import host_tensor

    if isinstance(v, (LoDTensor, SelectedRows)):
        return v.map(host_tensor)
    return host_tensor(v)


def _into_scope(ctx, names, pulled):
    """Pulled values -> the op's outputs: each copied into the tensor the
    scope holds under its name where it has one of the same shape (its
    dtype kept: a JAX pserver's int32 becomes the port's int64), else
    moved to the op's device."""
    outs = []
    for name, v in zip(names, pulled):
        cur = _current(ctx, name)
        if (isinstance(v, torch.Tensor) and isinstance(cur, torch.Tensor)
                and tuple(cur.shape) == tuple(v.shape)):
            cur.copy_(v)
            outs.append(cur)
        elif isinstance(v, (LoDTensor, SelectedRows)):
            outs.append(v.map(lambda t: t.to(ctx.device)))
        else:
            outs.append(v.to(ctx.device))
    return outs


@register_op("send", inputs=("X",), outputs=("Out",),
             attrs={"endpoints": [], "epmap": [], "out_epmap": [],
                    "bucket_bytes": -1},
             dup_inputs=("X",), dup_outputs=("Out",),
             not_differentiable=True, host=True, sparse=True)
def send(ctx, ins, attrs):
    """Push grads to their endpoints, barrier, pull updated params
    (send_op.cc:44-94: AsyncSendVariable / SendBatchBarrier /
    AsyncGetVariable).  Grads are packed into arrival-order buckets
    (SEND_BATCH frames, cap = `bucket_bytes` attr or the
    comm_bucket_bytes flag) and each endpoint's send→barrier→pull
    chain runs on its own pooled connection, so pservers are served
    concurrently instead of one serial round per endpoint.  A round
    on a card is three host steps: every grad copied to the host (a
    SelectedRows one as its rows and its values), the wire round, and
    the pulled params copied into the scope's tensors."""
    from ..parallel.comm import elastic_round

    xs = many(ins, "X")
    in_names = ctx.op.input("X")
    out_names = ctx.op.output("Out")
    epmap = attrs["epmap"] or [attrs["endpoints"][0]] * len(in_names)
    out_epmap = (attrs.get("out_epmap") or
                 [attrs["endpoints"][0]] * len(out_names))
    bucket = int(attrs.get("bucket_bytes", -1))

    # cluster views place PARAMS; the fused op aligns X grads with
    # their Out params positionally (DistributeTranspiler), so grad i's
    # placement key is out_names[i] — with a grad-only tail (or a
    # legacy non-fused op) fall back to stripping the @GRAD suffix
    def param_key(i):
        if i < len(out_names):
            return out_names[i]
        n = in_names[i]
        return n[:-len("@GRAD")] if n.endswith("@GRAD") else n

    xs = [_to_host(data_of(v)) for v in xs]
    outs = elastic_round(
        [(param_key(i), n, v, ep)
         for i, (n, v, ep) in enumerate(zip(in_names, xs, epmap))],
        [(n, n, ep) for n, ep in zip(out_names, out_epmap)],
        bucket_bytes=None if bucket < 0 else bucket,
        scope=_run_scope(ctx))
    return {"Out": _into_scope(ctx, out_names, outs)}


@register_op("recv", inputs=("X",), outputs=("Out",),
             attrs={"endpoint": ""},
             dup_inputs=("X",), dup_outputs=("Out",),
             not_differentiable=True, host=True)
def recv(ctx, ins, attrs):
    """Standalone param fetch (recv_op.cc:28-53), batched into
    GET_BATCH frames.  The pserver transpiler puts one a pserver at the
    end of a trainer's startup program (parallel/pserver.py)."""
    from ..parallel.comm import elastic_round

    out_names = ctx.op.output("Out")
    ep = attrs["endpoint"]
    outs = elastic_round([], [(n, n, ep) for n in out_names])
    return {"Out": _into_scope(ctx, out_names, outs)}


@register_op("listen_and_serv", inputs=("X",), outputs=(),
             attrs={"endpoint": "127.0.0.1:0", "Fanin": 1,
                    "sync_mode": True},
             dup_inputs=("X",),
             not_differentiable=True, host=True)
def listen_and_serv(ctx, ins, attrs):
    """Run a VariableServer over this op's sub-block as the optimize
    program (listen_and_serv_op.cc:56-185), in an
    ``Executor(CPUPlace())`` over the run's scope: the pserver's shard
    and its optimizer ops live on the host, as in the reference.
    Blocks until a client sends STOP — run it from a dedicated
    thread/process like the reference's send_recv_op_test.cc does."""
    import time

    from ..core.executor import CPUPlace, Executor
    from ..core.framework import Program
    from ..parallel.pserver import VariableServer

    # wrap the optimize sub-block into a standalone single-block program
    # (the reference hands the block to a nested Executor, :160)
    sub = ctx.op.sub_block()
    prog = Program()
    blk = prog.global_block()
    for v in sub.vars.values():
        if not blk.has_var(v.name):
            blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                           persistable=True)
    for op_ in sub.ops:
        blk.append_op(op_.type, dict(op_.inputs), dict(op_.outputs),
                      dict(op_.attrs))
    server = VariableServer(prog if sub.ops else None, _run_scope(ctx),
                            Executor(CPUPlace()),
                            fan_in=attrs.get("Fanin", 1),
                            sync=attrs.get("sync_mode", True))
    endpoint = attrs["endpoint"]
    port = int(endpoint.rsplit(":", 1)[1])
    server.serve(port)
    ctx.env.set("__listen_and_serv_port__", server.port)
    while not server._stopping:
        time.sleep(0.05)
    return {}
