"""Data-declaration and distributed-IO layers (counterpart of
paddle_tpu/layers/io.py; reference: Paddle's python/paddle/v2/fluid/
layers/io.py `data()`, `ListenAndServ`, `Send`, `Recv`)."""
from __future__ import annotations

import contextlib

from ..core.framework import default_main_program

__all__ = ["data", "ListenAndServ", "Send", "Recv"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         main_program=None, stop_gradient=True, type=None, donate=False,
         sharding=None):
    """Declare a feed variable.  `append_batch_size=True` prepends -1.
    `donate` and `sharding` are carried on the Variable so Programs
    serialize like the JAX package's."""
    prog = main_program or default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    kw = {}
    if type is not None:
        kw["type"] = type
    return prog.global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, donate=donate, sharding=sharding,
        **kw)


class ListenAndServ:
    """Pserver-side block: serve variables, run the block as the optimize
    program after `fan_in` barriers (reference layers/io.py ListenAndServ /
    listen_and_serv_op.cc).

    Usage:
        serv = ListenAndServ("127.0.0.1:6174", fan_in=1)
        with serv.do():
            ...optimize ops on served vars...
        exe.run(main)   # blocks serving until a client sends STOP
    """

    def __init__(self, endpoint, inputs=None, fan_in=1, optimizer_mode=True,
                 sync_mode=True):
        self.endpoint = endpoint
        self.fan_in = fan_in
        self.inputs = inputs or []
        del optimizer_mode  # reference flag; the block is always the program
        # sync_mode=False: ASGD pserver (grads apply on arrival, no
        # barrier round — go/pserver semantics)
        self.sync_mode = sync_mode
        self.sub = None

    @contextlib.contextmanager
    def do(self):
        program = default_main_program()
        parent = program.current_block
        self.sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        parent.append_op(
            "listen_and_serv",
            {"X": [v.name for v in self.inputs]},
            {},
            {"sub_block": {"__block__": self.sub.idx},
             "endpoint": self.endpoint,
             "Fanin": self.fan_in,
             "sync_mode": self.sync_mode})


def Send(endpoint, send_vars, get_vars, epmap=None, out_epmap=None):
    """Push `send_vars`, barrier, pull `get_vars` (reference layers Send /
    send_op.cc:44).  `endpoint` may be one 'host:port' or a list; with
    several, `epmap`/`out_epmap` route each var to its pserver.  An
    omitted `out_epmap` follows `epmap` when the arities line up (each
    param pulled from the server its grad went to — the transpiler
    pairing), else everything defaults to the first endpoint.  The
    runtime fuses each endpoint's vars into bucketed frames and serves
    endpoints concurrently (parallel/comm.py)."""
    eps = [endpoint] if isinstance(endpoint, str) else list(endpoint)
    epmap = list(epmap) if epmap else [eps[0]] * len(send_vars)
    if out_epmap:
        out_epmap = list(out_epmap)
    elif len(epmap) == len(get_vars):
        out_epmap = list(epmap)
    else:
        out_epmap = [eps[0]] * len(get_vars)
    helper_block = default_main_program().current_block
    helper_block.append_op(
        "send",
        {"X": [v.name for v in send_vars]},
        {"Out": [v.name for v in get_vars]},
        {"endpoints": eps,
         "epmap": epmap,
         "out_epmap": out_epmap})
    return get_vars


def Recv(endpoint, get_vars):
    """Fetch `get_vars` from `endpoint` (reference recv_op.cc:28)."""
    block = default_main_program().current_block
    block.append_op(
        "recv",
        {"X": []},
        {"Out": [v.name for v in get_vars]},
        {"endpoint": endpoint})
    return get_vars
