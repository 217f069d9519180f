"""Parameter-server variable transport: send/recv/listen_and_serv
(counterpart of paddle_tpu/parallel/pserver.py).

Reference: Paddle's paddle/fluid/operators/send_op.cc:44, recv_op.cc:28,
listen_and_serv_op.cc:56 and detail/{grpc_client,grpc_server,
send_recv.proto,sendrecvop_utils.cc} — trainers push grad blocks to
pservers, a fan-in barrier triggers the optimize block, then trainers
pull updated params.  Transport is a length-prefixed JSON+raw frame
over TCP instead of gRPC VariableMessage; semantics (per-trainer grad
rename `%s.trainer_%d`, batch barrier fan-in, blocking Get until the
optimize block ran) mirror listen_and_serv_op.cc:78-175.

**The wire is the JAX package's, byte for byte.**  A frame is
``<I head length><I payload length><JSON head><payload>``; a variable's
payload is ``<I length><JSON var head><raw bytes>``, its head naming
the numpy dtype (``"float32"``, ``"int64"``, ``"bfloat16"``), the shape
and the LoD (SelectedRows: the rows' dtype and count, then the values).
A port client speaks to a JAX `VariableServer` and a JAX client to a
port one.  Values are CPU tensors viewed as bytes: a send writes each
tensor's own memory with scatter-gather (`_sendall_parts`), never a
`tobytes()` concatenation, and a receive views one frame buffer
(`torch.frombuffer`).  A tensor on a card is copied to the host once,
where it is serialized; bfloat16 crosses as its bits under the name
``"bfloat16"`` (numpy needs no bf16 type for that).  Rows decode to
int64 whatever their wire dtype: the JAX package sends int32 rows (it
never enables x64), the port int64 ones, and each side decodes the
other's.

**The pserver runs on the host, as the JAX package's does.**  A
`VariableServer` holds its shard in a scope of CPU tensors and runs the
optimize program through the executor its caller gives it; the
`listen_and_serv` op (ops/distributed.py) hands it an
``Executor(CPUPlace())``, as the reference's listen_and_serv hands its
sub-block to a nested CPU executor.  That is the reference's design
(the optimizer ops run where the shard lives), not a fallback: the
trainers' forward and backward run on their cards, and only gradients
and parameters cross the wire.

**Trainers start from the pservers' parameters.**  The port's random
initializers draw from the generator of the device they run on, so a
startup program run on a trainer's card and the same program run on a
pserver's CPU give different parameters (the JAX package's threefry
draws do not depend on the device, so its trainers and pservers start
equal).  The pserver transpiler (parallel/executor.py) therefore
appends to the trainer's startup program one `recv` op a pserver,
pulling every parameter that pserver owns right after the
initializers: round 1's gradient is taken at the pservers' own
parameters, as in the JAX package, with no change to the trainer
program or to the wire.  `get_startup_program(endpoint)` hands the
pservers the startup program without those ops.
"""
from __future__ import annotations

import atexit
import json
import os
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.lod import LoDTensor, SelectedRows
from ..core.resilience import (RetryPolicy, fault_injector,
                               sched_fault_armed as _sched_fault)
from ..observability import attribution as obs_attr
from ..observability import flightrecorder
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from ..observability.collector import maybe_announce as obs_maybe_announce

__all__ = ["VariableServer", "VariableClient", "BarrierTimeoutError",
           "serialize_var", "deserialize_var", "serialize_var_parts",
           "serialize_batch_parts", "deserialize_batch",
           "prebind_endpoint", "discard_prebound", "host_tensor"]

_HDR = struct.Struct("<I")

# transport telemetry (gated by PADDLE_TPU_METRICS); trace context rides
# the frame head's optional "trace" field, so a trainer-side span and
# the pserver-side handling span share one trace id
_M_BYTES_SENT = obs_metrics.counter(
    "paddle_tpu_pserver_bytes_sent_total",
    "frame bytes written to pserver connections (both roles)")
_M_BYTES_RECV = obs_metrics.counter(
    "paddle_tpu_pserver_bytes_recv_total",
    "frame bytes read from pserver connections (both roles)")
_M_REQUESTS = obs_metrics.counter(
    "paddle_tpu_pserver_requests_total",
    "server-side requests handled, by verb", ("verb",))
_M_BARRIER_WAIT = obs_metrics.histogram(
    "paddle_tpu_pserver_barrier_wait_seconds",
    "client wall time blocked in send_batch_barrier (fan-in + optimize)")
_M_OPTIMIZE_SECONDS = obs_metrics.histogram(
    "paddle_tpu_pserver_optimize_seconds",
    "server-side fan-in grad merge + optimize-program latency")
# fused-transfer telemetry (parallel/comm.py carries the per-round
# latency/bytes histograms; these profile the bucket packer itself)
_M_BUCKET_VARS = obs_metrics.histogram(
    "paddle_tpu_comm_bucket_vars",
    "variables fused into one SEND_BATCH bucket",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_M_BUCKET_FILL = obs_metrics.histogram(
    "paddle_tpu_comm_bucket_fill",
    "bucket payload bytes / comm_bucket_bytes cap (>1: one oversized "
    "var shipped alone)",
    buckets=(0.0625, 0.125, 0.25, 0.5, 0.75, 1.0, 2.0))
_M_BATCH_FALLBACK = obs_metrics.counter(
    "paddle_tpu_comm_batch_fallback_total",
    "batch-capable clients that dropped to per-var frames after a "
    "legacy server rejected SEND_BATCH/GET_BATCH")

_KNOWN_VERBS = frozenset(
    {"HELLO", "SEND", "SEND_BATCH", "BARRIER", "GET", "GET_BATCH",
     "STOP", "OK", "ERR", "VAR", "VARS",
     # elastic cluster runtime (docs/resilience.md "Elastic clusters"):
     # PUT_BATCH installs values under their CANONICAL names (shard
     # migration / trainer-held recovery), DROP erases migrated-away
     # vars, HAVE probes which names a member holds (bootstrap-copy
     # consolidation), FENCE/COMMIT are the controller's two-phase
     # view change
     "PUT_BATCH", "DROP", "HAVE", "FENCE", "COMMIT",
     # STATE (the port's): the optimizer state an elastic server keeps
     # beside each named parameter, which a migration moves with it;
     # the JAX package's server answers ERR and parameters move alone
     "STATE",
     # FLIGHT returns the process flight-recorder ring on demand
     # (observability/flightrecorder.py) — post-mortems of a LIVE but
     # misbehaving pserver without attaching a debugger
     "FLIGHT"})

# frame-length sanity: a header larger than 1 MiB or a payload larger
# than 2 GiB is protocol desync / corruption, not a real request —
# reject instead of allocating huge buffers or blocking on bytes that
# will never arrive
_MAX_HEAD = 1 << 20
_MAX_PAYLOAD = 1 << 31

# endpoint -> bound+listening socket, held from address PUBLICATION to
# serve(): registry-discovered pservers bind FIRST and register the
# already-owned port (the reference's etcd flow — pserver.go binds the
# service then publishes), so no other process can take it in between
_prebound: Dict[int, socket.socket] = {}


def prebind_endpoint(host: str = "127.0.0.1") -> str:
    """Bind+listen an OS-assigned port NOW and park the socket for the
    VariableServer that will later `serve(port)`; returns 'host:port'."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    s.listen(16)
    port = s.getsockname()[1]
    _prebound[port] = s
    return f"{host}:{port}"


def _adopt_prebound(port: int):
    return _prebound.pop(port, None) if port else None


def discard_prebound(endpoint: Optional[str] = None):
    """Close parked sockets a VariableServer never adopted (one endpoint,
    or all of them) — a prebound pserver slot that was abandoned would
    otherwise hold its port until process exit."""
    if endpoint is not None:
        ports = [int(endpoint.rsplit(":", 1)[1])]
    else:
        ports = list(_prebound)
    for port in ports:
        s = _prebound.pop(port, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass


atexit.register(discard_prebound)


# ---------------------------------------------------------------------------
# wire format (reference sendrecvop_utils.cc SerializeToMessage)
# ---------------------------------------------------------------------------

# the dtypes a value may cross the wire in, by their numpy names (the
# JAX package's `str(array.dtype)`)
_WIRE_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_WIRE_NAMES = {t: n for n, t in _WIRE_DTYPES.items()}


def host_tensor(value) -> torch.Tensor:
    """A value as a contiguous CPU tensor: a tensor on a card is copied
    to the host once; a host tensor or a numpy array (bfloat16 ones
    included) is shared where it is contiguous."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return t.contiguous()
    from ..core.scope import tensor_from_numpy

    return tensor_from_numpy(value)


def _as_u8(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 view of a contiguous CPU tensor's bytes — no copy."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _wire_name(t: torch.Tensor) -> str:
    name = _WIRE_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"pserver wire: dtype {t.dtype} cannot cross the "
                        f"wire (one of {sorted(_WIRE_DTYPES)})")
    return name


def _blen(part) -> int:
    return part.nbytes if hasattr(part, "nbytes") else len(part)


def _join_parts(parts) -> bytes:
    return b"".join(p if isinstance(p, (bytes, bytearray)) else bytes(p)
                    for p in parts)


def serialize_var_parts(value):
    """-> (head dict, [flat-uint8 buffers]): the zero-copy wire form.
    The buffers are views over the value's own memory (its host copy,
    for a tensor on a card), written with scatter-gather
    (`_sendall_parts`) instead of `tobytes()` concat; joining `parts`
    after the JSON head reproduces the `serialize_var` payload
    byte-for-byte."""
    if isinstance(value, SelectedRows):
        # sparse message: rows + row values + dense height — the
        # reference's large-model path ships sparse rows to pservers
        # (ParameterServer2::getParameterSparse, sendrecvop_utils.cc
        # SerializeToMessage's SELECTED_ROWS branch)
        rows = host_tensor(value.rows)
        data = host_tensor(value.value)
        head = {
            "kind": "selected_rows", "height": int(value.height),
            "rows_dtype": _wire_name(rows), "n_rows": int(rows.shape[0]),
            "dtype": _wire_name(data), "shape": list(data.shape),
        }
        return head, [_as_u8(rows), _as_u8(data)]
    if isinstance(value, LoDTensor):
        data = host_tensor(value.data)
        lod = [list(map(int, lvl)) for lvl in value.lod]
    else:
        data = host_tensor(value)
        lod = None
    head = {"dtype": _wire_name(data), "shape": list(data.shape),
            "lod": lod}
    return head, [_as_u8(data)]


def _var_payload_parts(head: dict, parts) -> list:
    hb = json.dumps(head).encode()
    return [_HDR.pack(len(hb)) + hb, *parts]


def serialize_var(value) -> bytes:
    head, parts = serialize_var_parts(value)
    return _join_parts(_var_payload_parts(head, parts))


def _batch_payload_parts(prepared) -> list:
    """`prepared`: [(name, head, parts, nbytes)] -> scatter-gather
    buffer list for one batch payload: HDR(len(bh)) + bh + concatenated
    var bytes, bh = {"vars": [{"name", "nbytes", **var_head}, ...]}."""
    heads = [{"name": n, "nbytes": nb, **h} for n, h, _, nb in prepared]
    bh = json.dumps({"vars": heads}).encode()
    out = [_HDR.pack(len(bh)), bh]
    for _, _, parts, _ in prepared:
        out.extend(parts)
    return out


def _prepare_vars(items):
    """[(name, value)] -> [(name, head, parts, nbytes)] (no copies of
    host values)."""
    prepared = []
    for n, v in items:
        head, parts = serialize_var_parts(v)
        prepared.append((n, head, parts, sum(_blen(p) for p in parts)))
    return prepared


def _pack_buckets(prepared, cap):
    """DDP-style packing shared by SEND_BATCH and PUT_BATCH: arrival
    order, close a bucket when the next var would push it past the cap
    (an oversized var ships alone)."""
    buckets, cur, cur_b = [], [], 0
    for it in prepared:
        if cur and cur_b + it[3] > cap:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(it)
        cur_b += it[3]
    if cur:
        buckets.append(cur)
    return buckets


def serialize_batch_parts(items) -> list:
    """[(name, value)] -> buffer list for one SEND_BATCH/VARS payload."""
    return _batch_payload_parts(_prepare_vars(items))


def _tensor_from_raw(raw, dtype_name: str, shape, copy: bool):
    """A CPU tensor of `dtype_name` from the bytes `raw`: a view of them
    when copy=False and they are writable (`torch.frombuffer` keeps the
    buffer alive), else a copy."""
    dt = _WIRE_DTYPES.get(dtype_name)
    if dt is None:
        raise TypeError(f"pserver wire: unknown dtype {dtype_name!r}")
    mv = memoryview(raw)
    item = torch.empty((), dtype=dt).element_size()
    n = mv.nbytes // item
    if copy or mv.readonly or n == 0:
        t = torch.empty(n, dtype=dt)
        if n:
            _as_u8(t)[:] = np.frombuffer(mv, np.uint8)
    else:
        t = torch.frombuffer(mv, dtype=dt)
    return t.reshape(list(shape))


def _value_from_head(head: dict, raw, copy: bool = True):
    """Value from a var head + its raw bytes (`raw` may be a memoryview
    slice of a larger frame; copy=False returns tensors viewing it)."""
    if head.get("kind") == "selected_rows":
        n_rows = int(head["n_rows"])
        split = n_rows * torch.empty(
            (), dtype=_WIRE_DTYPES[head["rows_dtype"]]).element_size()
        rows = _tensor_from_raw(raw[:split], head["rows_dtype"],
                                [n_rows], copy)
        if rows.dtype != torch.int64:
            rows = rows.long()
        data = _tensor_from_raw(raw[split:], head["dtype"], head["shape"],
                                copy)
        return SelectedRows(rows, data, head["height"])
    data = _tensor_from_raw(raw, head["dtype"], head["shape"], copy)
    if head.get("lod") is not None:
        return LoDTensor(data, [tuple(lvl) for lvl in head["lod"]])
    return data


def deserialize_var(payload, copy: bool = True):
    """copy=False skips the defensive copy for payloads the CALLER
    owns (each frame's payload is a fresh buffer, so the wire paths pass
    False); keep the default for buffers that are reused after the
    call — the returned tensors would silently change under the
    reader."""
    mv = memoryview(payload)
    (hlen,) = _HDR.unpack_from(mv)
    head = json.loads(bytes(mv[_HDR.size:_HDR.size + hlen]))
    return _value_from_head(head, mv[_HDR.size + hlen:], copy=copy)


def deserialize_batch(payload, copy: bool = False):
    """Batch payload -> [(name, value)].  Default copy=False: values
    slice ONE frame buffer instead of copying per var (the buffer is
    fresh per frame on both ends, so views are safe and keep the whole
    bucket alive only as long as its vars are)."""
    mv = memoryview(payload)
    (hlen,) = _HDR.unpack_from(mv)
    bh = json.loads(bytes(mv[_HDR.size:_HDR.size + hlen]))
    off = _HDR.size + hlen
    out = []
    for h in bh["vars"]:
        n = int(h["nbytes"])
        out.append((h["name"],
                    _value_from_head(h, mv[off:off + n], copy=copy)))
        off += n
    return out


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly n bytes into ONE preallocated buffer via recv_into
    (the old `bytes += chunk` loop was O(n^2) and re-copied the prefix
    on every chunk)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf


# sendmsg iovec batching: IOV_MAX is 1024 on Linux; stay well under it
_IOV_CHUNK = 64

# names per GET_BATCH frame.  A count cap alone cannot bound the reply
# payload (param sizes are unknown client-side), so the server answers
# ERR "batch too large" for a chunk that would overflow _MAX_PAYLOAD
# and the client re-fetches that chunk per-var.
_GET_BATCH_CHUNK = 256


def _sendall_parts(sock: socket.socket, parts) -> int:
    """Write a list of buffers without concatenating them: scatter-
    gather via sendmsg where available, sequential sendall otherwise.
    Returns total bytes written."""
    views, total = [], 0
    for p in parts:
        v = memoryview(p)
        if v.itemsize != 1:
            v = v.cast("B")
        total += v.nbytes
        if v.nbytes:
            views.append(v)
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return total
    i = 0
    while i < len(views):
        sent = sock.sendmsg(views[i:i + _IOV_CHUNK])
        while sent > 0:
            v = views[i]
            if sent >= v.nbytes:
                sent -= v.nbytes
                i += 1
            else:
                views[i] = v[sent:]
                sent = 0
    return total


def _frame_parts(verb: str, name: str = "", payload_parts=(),
                 trace=None) -> list:
    """Scatter-gather frame: [8-byte lengths + head, *payload buffers].
    `trace` is an optional tracing.inject() dict; the field is simply
    absent for untraced senders, so peers predating it (and frames it
    never saw) parse unchanged — wire-compatible both directions."""
    head_d = {"verb": verb, "name": name}
    if trace is not None:
        head_d["trace"] = trace
    head = json.dumps(head_d).encode()
    plen = sum(_blen(p) for p in payload_parts)
    return [_HDR.pack(len(head)) + _HDR.pack(plen) + head,
            *payload_parts]


def _frame_bytes(verb: str, name: str = "", payload: bytes = b"",
                 trace=None) -> bytes:
    return _join_parts(_frame_parts(verb, name, [payload], trace))


def _send_frame(sock: socket.socket, verb: str, name: str = "",
                payload: bytes = b"", trace=None):
    frame = _frame_bytes(verb, name, payload, trace)
    _M_BYTES_SENT.inc(len(frame))
    sock.sendall(frame)


def _send_frame_parts(sock: socket.socket, verb: str, name: str = "",
                      payload_parts=(), trace=None) -> int:
    n = _sendall_parts(sock, _frame_parts(verb, name, payload_parts,
                                          trace))
    _M_BYTES_SENT.inc(n)
    return n


def _bucket_cap(bucket_bytes=None) -> int:
    """Effective SEND bucket size cap: explicit arg, else the
    comm_bucket_bytes flag (PADDLE_TPU_COMM_BUCKET_BYTES)."""
    if bucket_bytes is not None:
        return int(bucket_bytes)
    from ..core.flags import get_flag
    return int(get_flag("comm_bucket_bytes"))


def _recv_frame(sock: socket.socket):
    """-> (verb, name, payload, trace) — `trace` is the propagated trace
    header dict, or None for frames that lack it (older peers)."""
    (hlen,) = _HDR.unpack(_read_exact(sock, 4))
    (plen,) = _HDR.unpack(_read_exact(sock, 4))
    if hlen > _MAX_HEAD or plen > _MAX_PAYLOAD:
        raise ValueError(
            f"frame lengths (head {hlen}, payload {plen}) exceed sanity "
            f"caps ({_MAX_HEAD}, {_MAX_PAYLOAD}): protocol desync or "
            "corrupt frame")
    head = json.loads(_read_exact(sock, hlen))
    payload = _read_exact(sock, plen) if plen else b""
    _M_BYTES_RECV.inc(8 + hlen + plen)
    return head["verb"], head["name"], payload, head.get("trace")


class _HashedStream:
    """A write-only, unseekable file object: each chunk written goes to
    `f` and, on another thread, into an md5 (hashlib releases the GIL),
    so a file's digest costs no pass of its own after the write.
    Unseekable, a zip writer puts each member's sizes after its data (a
    data descriptor) instead of seeking back.  Chunks are hashed as
    written, not copied: a buffer handed to `write` must stay unchanged
    until `hexdigest` (np.savez hands over new bytes objects)."""

    def __init__(self, f, head: bytes):
        import hashlib
        import queue

        self._f, self._n = f, 0
        self._md5 = hashlib.md5(head)
        self._chunks = queue.Queue(maxsize=8)
        self._hasher = threading.Thread(target=self._hash, daemon=True)
        self._hasher.start()

    def _hash(self):
        while True:
            chunk = self._chunks.get()
            if chunk is None:
                return
            self._md5.update(chunk)

    def write(self, b) -> int:
        n = self._f.write(b)
        self._chunks.put(b)
        self._n += n
        return n

    def tell(self) -> int:
        return self._n

    def read(self, *_):
        # np.savez takes an object with `read` for a file object
        raise OSError("a write-only stream")

    def flush(self):
        self._f.flush()

    def hexdigest(self) -> str:
        self._chunks.put(None)
        self._hasher.join()
        return self._md5.hexdigest()


def _savez_hashed(f, name: str, arrays) -> str:
    """np.savez of `arrays` into the open file `f` -> the md5 of the
    snapshot directory holding it as `name` (io._md5_of_dir's: the
    name's bytes, then the file's), taken while writing."""
    stream = _HashedStream(f, name.encode())
    try:
        np.savez(stream, **arrays)
    finally:
        digest = stream.hexdigest()
    return digest


class VariableServer:
    """Holds a scope; applies the optimize program after `fan_in` barriers.

    Round protocol (listen_and_serv_op.cc:114-175): trainers SEND grad
    vars (stored as `<name>.trainer_<i>` — the per-trainer rename at :82),
    then send BARRIER; once `fan_in` barriers arrive the optimize program
    runs in the server scope and blocked GETs are released.
    """

    def __init__(self, optimize_program, scope, executor, fan_in: int = 1,
                 sync: bool = True, snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0, enable_batch: bool = True,
                 elastic: bool = False):
        self.program = optimize_program
        self.scope = scope
        self.exe = executor
        self.fan_in = fan_in
        # elastic=True: this server participates in membership-driven
        # rebalancing (cloud/cluster.py).  It holds the FULL optimize
        # program but at each sync round runs only the per-grad slices
        # of grads that actually arrived — ownership is decided by what
        # trainers send per the current cluster view, so parameters can
        # migrate in/out at runtime without rebuilding the program.  The
        # controller drives the FENCE/COMMIT two-phase view change and
        # PUT_BATCH/DROP shard migration verbs.
        self.elastic = elastic
        self._fenced = False
        self._view_epoch = 0
        # elastic: param -> the persistable state its slice writes
        # beside it (an Adam parameter's moments and its own copies of
        # the epilogue's state, the beta powers); grad -> {private copy:
        # the shared var it starts from} (_build_async_slices)
        self._companions: Dict[str, list] = {}
        self._private: Dict[str, Dict[str, str]] = {}
        # rounds a COMMIT released without their optimize (a barrier
        # reply says "released" for them, "applied" otherwise)
        self._released: set = set()
        # enable_batch=False turns off the fused SEND_BATCH/GET_BATCH
        # verbs, making this server answer exactly like one predating
        # them (ERR "unknown verb") — the wire-compat tests pin the
        # batch-capable client's fallback against it
        self.enable_batch = enable_batch
        # per-shard checkpointing (reference go/pserver/service.go:
        # 120-203,346: each pserver snapshots ITS OWN shard with
        # {uuid, md5, timestamp} meta and restores on restart).  Each
        # server gets its OWN snapshot_dir; every `snapshot_every`
        # optimize rounds (sync) / applied updates (async) the shard's
        # persistables are written through io.publish_checkpoint.  On
        # construction an existing valid snapshot is restored into the
        # scope automatically — a replacement pserver claiming the slot
        # resumes the shard where its predecessor died.
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        self._updates_since_snapshot = 0
        # sync=False: ASGD — each received grad applies immediately, no
        # barrier round (reference go/pserver SendGrad semantics /
        # legacy --async_pserver; sync barriers become no-ops)
        self.sync = sync
        self._async_progs: Dict[str, object] = {}
        self._async_built = False
        self._async_seen: set = set()
        self._lock = threading.Condition()
        self._barriers = 0
        self._round = 0
        self._trainer_ids: Dict[str, int] = {}
        self._next_trainer = 0
        self._sock: Optional[socket.socket] = None
        self._threads = []
        # live trainer connections: stop() shuts them down, so a stopped
        # server answers nothing (as a killed one), not only no new
        # connection
        self._conns: set = set()
        self._stopping = False
        self.port = None
        if snapshot_dir:
            self.restore_snapshot()
        if (not sync or elastic) and self.program is not None:
            # validate the optimize program HERE, where the user can see
            # the error — a raise inside a handler thread would surface to
            # trainers only as a dropped connection.  Elastic sync mode
            # needs the same per-grad slices: a round must update only
            # the params whose grads arrived (this server's current
            # shard), never the whole program.
            self._build_async_slices()

    # -- lifecycle ----------------------------------------------------------
    def serve(self, port: int = 0) -> int:
        sock = _adopt_prebound(port)
        if sock is not None:
            self._sock = sock
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(("127.0.0.1", port))
            self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        # fleet telemetry: with PADDLE_TPU_TELEMETRY_REGISTRY set, the
        # JAX package's first server publishes its /metrics endpoint
        # for the TelemetryCollector; the port raises instead (no-op
        # without the variable)
        obs_maybe_announce("pserver")
        return self.port

    def register_with(self, registry, kind: str = "pserver",
                      ttl_s: float = 3.0, host: str = "127.0.0.1"):
        """Publish this server in a TTL-lease registry (cloud.registry) so
        trainers discover it and a replacement can claim the slot if this
        process dies (reference go/cmd/pserver/pserver.go:34-45).  Returns
        the live Lease; its `.index` is this pserver's cluster index and
        `.lost` flips if the registry revokes the slot."""
        from ..cloud.registry import Lease

        if self.port is None:
            raise RuntimeError("serve() before register_with()")
        self._lease = Lease(registry, kind, f"{host}:{self.port}", ttl_s)
        return self._lease

    def stop(self):
        self._stopping = True
        lease = getattr(self, "_lease", None)
        if lease is not None and not lease.lost:
            lease.release()
        try:
            if self._sock is not None:
                # shutdown BEFORE close: close() alone may not abort a
                # blocked accept() on every kernel, leaving a grace
                # window where a stopped server accepts (and serves!)
                # one more connection — fatal for crash simulations and
                # wrong for real shutdown
                if not _sched_fault("pserver.accept-stop-race"):
                    try:
                        self._sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                self._sock.close()
        except OSError:
            pass
        if not _sched_fault("pserver.accept-stop-race"):
            # and the live connections, so a stopped server answers
            # nothing, as a killed one (the armed fault is the old
            # behaviour, for the schedule checker's pin)
            for conn in list(self._conns):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except (OSError, AttributeError):
                    pass
        with self._lock:
            self._lock.notify_all()

    # -- internals ----------------------------------------------------------
    def _accept_loop(self):
        while not self._stopping:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            if self._stopping and not _sched_fault(
                    "pserver.accept-stop-race"):
                # accept raced stop(): a dead server must not answer.
                # (The _sched_fault toggle reintroduces the old race
                # for the schedule checker's regression pin —
                # tests/test_torch_concurrency_analysis.py; always
                # False otherwise.)
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._conns.add(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _trainer_id(self, peer: str) -> int:
        with self._lock:
            if peer not in self._trainer_ids:
                self._trainer_ids[peer] = self._next_trainer
                self._next_trainer += 1
            return self._trainer_ids[peer]

    def _serve_conn(self, conn: socket.socket):
        peer = None
        try:
            while True:
                try:
                    verb, name, payload, trace = _recv_frame(conn)
                except (ValueError, KeyError, TypeError) as e:
                    # malformed frame (bad lengths / non-JSON head): the
                    # byte stream is desynced, so this CONNECTION is done,
                    # but the server must keep serving everyone else — the
                    # sender reconnects and resends (truncated frames from
                    # a crashed sender land here as ConnectionError via
                    # _read_exact and are equally non-fatal)
                    try:
                        _send_frame(conn, "ERR", f"malformed frame: {e}")
                    except OSError:
                        pass
                    return
                _M_REQUESTS.labels(
                    verb=verb if verb in _KNOWN_VERBS else "other").inc()
                # chaos hook: a delay fault here makes THIS server a
                # straggler — every frame it serves stalls, which the
                # client-side per-endpoint round histogram attributes
                # to this endpoint alone (the straggler drill's lever)
                fault_injector().fire("pserver.serve")
                try:
                    # the handler BUFFERS its reply and sends it only
                    # after the span context manager has exited: the
                    # reply frame is the client's wake-up, so recording
                    # first makes "client saw the reply => the server
                    # span is in the buffer" an invariant.  (Sending
                    # inside the span left a scheduling window where a
                    # loaded host could park this thread between
                    # sendall and the span record while the client — and
                    # a test/collector behind it — already read the
                    # trace: the 1-in-4 wire-propagation flake PRs 11
                    # and 12 logged.)
                    reply = None        # (verb, name, payload_bytes)
                    reply_parts = None  # (verb, name, iovec parts)
                    stop_after = False
                    # the propagated trace context (when the frame has
                    # one) parents this server-side span under the
                    # remote caller's span: one trace id across the wire
                    with obs_tracing.activate(obs_tracing.extract(trace)), \
                            obs_tracing.span(
                                "pserver." + str(verb).lower(),
                                var=name):
                        if verb == "HELLO":
                            peer = name
                            reply = ("OK", "", b"")
                        elif verb == "SEND":
                            tid = self._trainer_id(peer or "anon")
                            with obs_attr.phase("pserver", "recv"):
                                value = deserialize_var(
                                    payload, copy=False)
                                if self.sync:
                                    with self._lock:
                                        # per-trainer grad rename
                                        # (listen_and_serv :82)
                                        self.scope.set_var(
                                            f"{name}.trainer_{tid}",
                                            value)
                                else:
                                    self._apply_async(name, value)
                            reply = ("OK", "", b"")
                        elif verb == "SEND_BATCH" and self.enable_batch:
                            tid = self._trainer_id(peer or "anon")
                            # deserialize the whole bucket OUTSIDE the
                            # lock (views over the frame buffer, no
                            # per-var copies), apply under ONE
                            # acquisition
                            with obs_attr.phase("pserver", "recv"):
                                pairs = deserialize_batch(payload)
                                if self.sync:
                                    with self._lock:
                                        for n, v in pairs:
                                            self.scope.set_var(
                                                f"{n}.trainer_{tid}",
                                                v)
                                else:
                                    self._apply_async_bucket(pairs)
                            reply = ("OK", "", b"")
                        elif verb == "GET_BATCH" and self.enable_batch:
                            names = json.loads(bytes(payload))
                            vals = self._blocking_get_many(names)
                            parts = serialize_batch_parts(
                                list(zip(names, vals)))
                            if sum(_blen(p)
                                   for p in parts) > _MAX_PAYLOAD:
                                # chunking is by NAME count, so huge
                                # params can overflow the frame cap —
                                # tell the client to fetch this chunk
                                # per-var instead of shipping a frame
                                # its parser must reject
                                reply = (
                                    "ERR",
                                    f"batch too large: {len(names)} "
                                    "vars exceed the frame payload cap",
                                    b"")
                            else:
                                reply_parts = ("VARS", "", parts)
                        elif verb == "PUT_BATCH":
                            # shard migration / recovery install: values
                            # land under their CANONICAL names (vs
                            # SEND's per-trainer grad rename) — the
                            # controller and trainer-held recovery both
                            # write params, not grads.  Allowed while
                            # fenced: migration RUNS during the fence.
                            # NOT gated on enable_batch: this is an
                            # elastic verb shipping with FENCE/COMMIT/
                            # DROP, not a batch-compat verb — the client
                            # has no per-var fallback for it.
                            pairs = deserialize_batch(payload)
                            with self._lock:
                                for n, v in pairs:
                                    self.scope.set_var(n, v)
                            reply = ("OK", "", b"")
                        elif verb == "DROP":
                            names = json.loads(bytes(payload))
                            # the param, its canonical grad, and stale
                            # per-trainer slots of EITHER must all go —
                            # a migrated-away param's leftover grads
                            # must not feed a later optimize round.
                            # ONE scope pass total (not per name): a
                            # per-trainer slot is `<base>.trainer_<i>`,
                            # so stripping that suffix maps every scope
                            # name onto the doomed set
                            doomed = set()
                            for n in names:
                                doomed.add(n)
                                doomed.add(n + "@GRAD")
                                # an elastic server's state of the
                                # param goes with it (its new owner
                                # holds it now)
                                doomed.update(self._companions.get(n, ()))
                            with self._lock:
                                for sn in list(
                                        self.scope.local_names()):
                                    base = sn
                                    if ".trainer_" in sn:
                                        base = sn.rsplit(
                                            ".trainer_", 1)[0]
                                    if base in doomed:
                                        self.scope.erase(sn)
                            reply = ("OK", "", b"")
                        elif verb == "HAVE":
                            # bootstrap-copy probe: which of these
                            # names does this member hold?  Used by the
                            # controller's initial-placement
                            # consolidation (fenced, read-only)
                            names = json.loads(bytes(payload))
                            with self._lock:
                                held = [n for n in names
                                        if self.scope.has_var(n)]
                            reply = ("OK", "",
                                     json.dumps(held).encode())
                        elif verb == "STATE":
                            # which persistables travel with each named
                            # parameter (empty off elastic mode)
                            names = json.loads(bytes(payload))
                            reply = ("OK", "", json.dumps(
                                {n: self._companions.get(n, [])
                                 for n in names}).encode())
                        elif verb == "FENCE":
                            self._apply_fence(int(name))
                            reply = ("OK", "", b"")
                        elif verb == "COMMIT":
                            attrs = (json.loads(bytes(payload))
                                     if payload else {})
                            self._apply_commit(int(name),
                                               attrs.get("fan_in"))
                            reply = ("OK", "", b"")
                        elif verb == "BARRIER":
                            outcome = "applied"
                            if self.sync:
                                with obs_attr.phase("pserver",
                                                    "barrier"):
                                    outcome = self._barrier()
                            # "released": a COMMIT let this barrier go
                            # without the round's optimize (a JAX
                            # client reads only the verb)
                            reply = ("OK", outcome, b"")
                        elif verb == "GET":
                            val = self._blocking_get(name)
                            reply_parts = (
                                "VAR", name,
                                _var_payload_parts(
                                    *serialize_var_parts(val)))
                        elif verb == "FLIGHT":
                            # on-demand flight-recorder dump (the ring
                            # of recent spans/events/metric snapshots)
                            reply = ("OK", "", json.dumps(
                                flightrecorder.dump_dict(
                                    reason="wire"),
                                default=str).encode())
                        elif verb == "STOP":
                            reply = ("OK", "", b"")
                            stop_after = True
                        else:
                            reply = ("ERR", f"unknown verb {verb}",
                                     b"")
                    if reply_parts is not None:
                        _send_frame_parts(conn, *reply_parts)
                    elif reply is not None:
                        _send_frame(conn, *reply)
                    if stop_after:
                        self.stop()
                        return
                except (ConnectionError, OSError):
                    raise
                except Exception as e:
                    # a bad REQUEST (undecodable payload, unknown var)
                    # is the client's error to hear about — killing the
                    # connection silently left it hanging in recv
                    _send_frame(conn, "ERR",
                                f"{type(e).__name__}: {e}")
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(conn)
            conn.close()

    # -- per-shard snapshot (go/pserver/service.go:120-203) -----------------
    def _shard_vars(self):
        if self.program is None:
            return {}
        out = {}
        names = [v.name for v in self.program.list_vars() if v.persistable]
        for priv in self._private.values():
            names.extend(priv)
        for name in names:
            if not self.scope.has_var(name):
                continue
            val = self.scope.find_var(name)
            if not isinstance(val, torch.Tensor):
                continue
            val = val.detach().cpu()
            if val.dtype == torch.bfloat16:
                # npz has no bfloat16: widened without loss, narrowed
                # back to the scope's dtype on restore
                val = val.float()
            out[name] = val.numpy().copy()
        return out

    def snapshot(self, max_keep: int = 3) -> Optional[str]:
        """Write this server's shard (its persistable params +
        accumulators) under snapshot_dir with {uuid, md5, timestamp}
        meta.  Returns the uuid, or None when no snapshot_dir is set."""
        if not self.snapshot_dir:
            return None
        with self._lock:
            data = (self._shard_vars(), self._round)
        return self._write_snapshot(data, max_keep)

    def _write_snapshot(self, data, max_keep: int = 3) -> str:
        """Disk side of snapshot(): runs WITHOUT the lock (npz write +
        md5-of-dir can take seconds on a big shard; trainer handler
        threads must not stall behind it)."""
        import uuid as uuid_mod

        from .. import io as _io

        from .checkpoint import PSERVER_SHARD_FILENAME

        host, rnd = data
        cp_uuid = uuid_mod.uuid4().hex
        cp_dir = os.path.join(self.snapshot_dir,
                              f"{_io.CHECKPOINT_PREFIX}_{cp_uuid}")
        os.makedirs(cp_dir, exist_ok=True)
        t0 = time.perf_counter()
        with open(os.path.join(cp_dir, PSERVER_SHARD_FILENAME), "wb") as f:
            digest = _savez_hashed(f, PSERVER_SHARD_FILENAME, host)
        _io.publish_checkpoint(self.snapshot_dir, cp_uuid, cp_dir,
                               {"round": rnd}, max_keep, md5=digest)
        flightrecorder.note("pserver.snapshot", round=rnd,
                            seconds=time.perf_counter() - t0,
                            bytes=sum(v.nbytes for v in host.values()))
        return cp_uuid

    def restore_snapshot(self):
        """Load the latest valid shard snapshot (if any) into the scope.
        Returns the snapshot meta or None."""
        from .checkpoint import latest_pserver_shard

        data, rnd, meta = latest_pserver_shard(self.snapshot_dir)
        if data is None:
            return None
        from ..core.scope import tensor_from_numpy

        for n, v in data.items():
            t = tensor_from_numpy(v).clone()
            old = (self.scope.find_var(n) if self.scope.has_var(n)
                   else None)
            if isinstance(old, torch.Tensor):
                t = t.to(old.dtype)
            elif not (t.is_floating_point() or t.dtype == torch.bool):
                t = t.long()   # the port's id type (a JAX shard's int32)
            self.scope.set_var(n, t)
        self._round = rnd
        return meta

    def _maybe_snapshot_data(self):
        """Host copies of the shard when a snapshot is due (caller holds
        self._lock); the caller performs the disk write AFTER releasing
        the lock so trainer handler threads never stall behind I/O."""
        if not self.snapshot_dir or self.snapshot_every <= 0:
            return None
        self._updates_since_snapshot += 1
        if self._updates_since_snapshot < self.snapshot_every:
            return None
        self._updates_since_snapshot = 0
        return (self._shard_vars(), self._round)

    def _barrier(self) -> str:
        """-> "applied" when the round's optimize ran, "released" when a
        COMMIT let the barrier go without it (its grads were cleared as
        pre-view state)."""
        snap = None
        with self._lock:
            # view-change fence: no optimize step may straddle a
            # placement change, so barriers arriving mid-rebalance hold
            # until the controller COMMITs the new view (reads and the
            # migration verbs stay live — the fence only quiesces the
            # round machinery).  The COMMIT clears the grads this
            # barrier stands for, so it is released uncounted: counting
            # it would run an optimize of nothing, or of a peer's
            # later grads
            if self._fenced:
                while self._fenced and not self._stopping:
                    self._lock.wait(timeout=0.1)
                return "released"
            self._barriers += 1
            if self._barriers >= self.fan_in:
                try:
                    self._run_optimize()
                except Exception:
                    # the round is refused whole (an elastic server
                    # checks before it runs a slice): its grads go, its
                    # waiters are released without it, and the error
                    # reaches this barrier's trainer, which replays
                    self._clear_round()
                    raise
                self._barriers = 0
                self._round += 1
                snap = self._maybe_snapshot_data()
                self._lock.notify_all()
            else:
                rnd = self._round
                while self._round == rnd and not self._stopping:
                    self._lock.wait(timeout=0.1)
                if rnd in self._released:
                    return "released"
        if snap is not None:
            self._write_snapshot(snap)
        return "applied"

    # -- two-phase view change (cloud/cluster.py ClusterController) ---------
    def _apply_fence(self, epoch: int):
        """Phase 1: quiesce the round machinery.  Acquiring the server
        lock waits out any optimize in flight; once set, new BARRIERs
        block until COMMIT, so shard migration runs against frozen
        state and no optimize mixes old and new placements."""
        with self._lock:
            self._fenced = True
            self._view_epoch = max(self._view_epoch, epoch)

    def _apply_commit(self, epoch: int, fan_in=None):
        """Phase 2: adopt the new view.  Updates fan_in to the live
        trainer count, clears per-trainer grad slots (a half-arrived
        round under the OLD placement must not leak into the new
        epoch), and releases every waiter — trainers blocked mid-round
        (e.g. behind a SIGKILLed peer's missing barrier) get their
        BARRIER answered and simply lose that round's update, which
        at-least-once sync SGD tolerates."""
        with self._lock:
            self._view_epoch = max(self._view_epoch, epoch)
            if fan_in:
                self.fan_in = int(fan_in)
            for n in list(self.scope.local_names()):
                if ".trainer_" in n:
                    self.scope.erase(n)
            if self._barriers:
                # release mid-round waiters without an optimize: their
                # grads were just cleared as pre-view state
                self._clear_round()
            self._barriers = 0
            self._fenced = False
            self._lock.notify_all()

    def _clear_round(self):
        """Release the round in progress without its optimize (caller
        holds self._lock): its grad slots go, its waiters hear
        "released"."""
        for n in list(self.scope.local_names()):
            if ".trainer_" in n:
                self.scope.erase(n)
        self._released = {r for r in self._released
                          if r > self._round - 64}
        self._released.add(self._round)
        self._round += 1
        self._barriers = 0
        self._lock.notify_all()

    def _slice_program(self, keep, rename=None):
        """A Program of the ops `keep`, declaring the vars they use (as
        persistables); `rename` maps a var name to the name the slice
        reads and writes instead (an elastic slice's private copy of
        shared epilogue state)."""
        from ..core.framework import Program

        rename = rename or {}
        src = self.program.global_block()
        prog = Program()
        blk = prog.global_block()
        used = [n for op_ in keep for d in (op_.inputs, op_.outputs)
                for ns in d.values() for n in ns]
        for n in dict.fromkeys(used):
            v = src.vars.get(n)
            if v is not None:
                blk.create_var(name=rename.get(n, n), shape=v.shape,
                               dtype=v.dtype, persistable=True)
        for op_ in keep:
            def slots(d):
                return {k: [rename.get(n, n) for n in ns]
                        for k, ns in d.items()}
            blk.append_op(op_.type, slots(op_.inputs), slots(op_.outputs),
                          dict(op_.attrs))
        return prog

    def _build_async_slices(self):
        """Per-grad program slices (the per-parameter optimizer instance
        of the reference's async pserver, go/pserver/service.go SendGrad)
        plus the EPILOGUE: ops reachable from no gradient (Adam/Adamax
        beta-pow scale ops, global-step increment).  The epilogue runs
        once per full sweep of distinct grads so shared schedule state
        advances at the sync round rate, not once per SEND."""
        src = self.program.global_block()
        grads = {n for op_ in src.ops
                 for n in op_.inputs.get("Grad", [])}
        kept = {}
        claimed = set()
        claimed_by = {}  # id(op) -> first grad slice that claimed it
        for g in sorted(grads):
            keep, produced = [], set()
            for op_ in src.ops:
                ins = {n for ns in op_.inputs.values() for n in ns}
                if g in ins or (produced & ins):
                    prev = claimed_by.setdefault(id(op_), g)
                    if prev != g:
                        # an op reading multiple grads (e.g. a global-norm
                        # clip) would re-execute per arriving grad against
                        # stale peer grads — refuse rather than silently
                        # duplicate; such programs need sync_mode=True
                        raise ValueError(
                            f"async pserver: op {op_.type!r} is reachable "
                            f"from both grad {prev!r} and grad {g!r}; "
                            "multi-grad ops cannot run grads-on-arrival — "
                            "use sync_mode=True for this optimize program")
                    keep.append(op_)
                    claimed.add(id(op_))
                    produced.update(n for ns in op_.outputs.values()
                                    for n in ns)
            kept[g] = keep
        epilogue = [op_ for op_ in src.ops if id(op_) not in claimed]
        self._async_grads = grads
        self._async_built = True
        if self.elastic:
            self._elastic_slices(src, kept, epilogue)
            return
        self._async_progs = {g: self._slice_program(k)
                             for g, k in kept.items()}
        self._async_epilogue = (self._slice_program(epilogue)
                                if epilogue else None)

    def _elastic_slices(self, src, kept, epilogue):
        """Elastic slices own all their state.  A parameter's slice runs
        the epilogue's ops too (Adam's beta-power scales, a decay's
        step), on its own copies of the state they write, named
        ``<var>@<param>`` and started from the shared var; the shared
        epilogue goes.  Every round still advances that state once for
        each parameter updated, as the shared epilogue did, but the
        state now moves with its parameter: a migrated parameter takes
        its step count to its new owner, and a round replayed for some
        parameters advances only theirs.  Records each parameter's
        companions (the persistables its slice writes besides it, for
        the STATE verb and DROP) and each slice's private copies."""
        written = {n for op_ in epilogue for ns in op_.outputs.values()
                   for n in ns}
        persistable = {v.name for v in src.vars.values() if v.persistable}
        order = {id(op_): i for i, op_ in enumerate(src.ops)}
        self._async_progs, self._companions, self._private = {}, {}, {}
        for g, ops in kept.items():
            param = next((op_.inputs["Param"][0] for op_ in ops
                          if op_.inputs.get("Param")), None)
            if param is None:
                param = g[:-len("@GRAD")] if g.endswith("@GRAD") else g
            rename = {n: f"{n}@{param}" for n in sorted(written)}
            keep = sorted(ops + epilogue, key=lambda o: order[id(o)])
            self._async_progs[g] = self._slice_program(keep, rename)
            self._private[g] = {p: n for n, p in rename.items()}
            outs = {n for op_ in ops for ns in op_.outputs.values()
                    for n in ns if n in persistable and n != param
                    and n not in written}
            self._companions[param] = sorted(outs) + sorted(
                rename.values())
        self._async_epilogue = None

    def _apply_async(self, name, value):
        self._apply_async_bucket([(name, value)])

    def _apply_async_bucket(self, pairs):
        """ASGD application for one or many grads under ONE lock
        acquisition (a SEND_BATCH bucket must not interleave with other
        trainers' grads mid-bucket)."""
        snaps = []
        with self._lock:
            for name, value in pairs:
                snap = self._apply_async_locked(name, value)
                if snap is not None:
                    snaps.append(snap)
        for snap in snaps:
            self._write_snapshot(snap)

    def _apply_async_locked(self, name, value):
        self.scope.set_var(name, value)
        if self.program is None:
            return None
        assert self._async_built  # built (and validated) in __init__
        snap = None
        prog = self._async_progs.get(name)
        if prog is not None:
            self.exe.run(prog, scope=self.scope)
            self._async_seen.add(name)
            snap = self._maybe_snapshot_data()
            if isinstance(value, SelectedRows):
                # applied rows must not survive to the next arrival
                self.scope.erase(name)
        # epilogue fires once per full sweep of DISTINCT grads (Adam
        # beta pows / global step advance at the sync round rate);
        # non-grad sends and resends don't advance the cadence
        if (self._async_epilogue is not None and self._async_grads
                and self._async_seen >= self._async_grads):
            self.exe.run(self._async_epilogue, scope=self.scope)
            self._async_seen.clear()
        return snap

    def _run_optimize(self):
        import time as _time

        t0 = _time.perf_counter()
        with obs_tracing.span("pserver.optimize", round=self._round):
            self._run_optimize_inner()
        dt = _time.perf_counter() - t0
        _M_OPTIMIZE_SECONDS.observe(dt)
        obs_attr.observe_phase("pserver", "optimize", dt)
        # flight ring: the optimize cadence is the first thing a
        # post-mortem of a killed pserver reads (no-op unless armed)
        flightrecorder.note("pserver.optimize", round=self._round,
                            seconds=dt)

    def _run_optimize_inner(self):
        # sum per-trainer grads into the canonical grad var, then run the
        # optimize program (the reference generates sum ops in the pserver
        # program; here the fan-in sum is part of the serving contract).
        # SelectedRows parts merge by row concatenation — duplicate rows
        # are summed by the optimizer's scatter-add, same as the
        # reference's merge_selected_rows.
        names = {}
        for n in list(self.scope.local_names()):
            if ".trainer_" in n:
                base = n.split(".trainer_")[0]
                names.setdefault(base, []).append(n)
        sparse = []
        for base, parts in names.items():
            vals = [self.scope.find_var(p) for p in parts]
            if any(isinstance(v, SelectedRows) for v in vals):
                srs = [v for v in vals if isinstance(v, SelectedRows)]
                if len(srs) != len(vals):
                    # a mixed round would silently drop the dense parts —
                    # heterogeneous trainer programs are a config error
                    raise RuntimeError(
                        f"grad {base!r}: some trainers sent SelectedRows "
                        "and others dense tensors; all trainers must use "
                        "the same is_sparse setting")
                merged = SelectedRows(
                    torch.cat([s.rows for s in srs]),
                    torch.cat([s.value for s in srs]),
                    srs[0].height)
                self.scope.set_var(base, merged)
                sparse.append((base, parts))
            else:
                # in arrival order, left to right, as numpy's sum over
                # axis 0 adds them in the JAX package
                total = vals[0]
                for v in vals[1:]:
                    total = total + v
                self.scope.set_var(base, total)
        if self.program is not None:
            if self.elastic:
                # run only the slices of grads that ARRIVED this round:
                # this server's shard is whatever the current view
                # placed on it, and params migrated away (DROPped) must
                # not be touched by stale program ops
                # (each slice carries its parameter's share of the
                # epilogue's state: _elastic_slices).  A grad whose
                # parameter this server does not hold (a trainer routed
                # by a view older than a migration) refuses the round
                # before any slice runs, so no round is half applied
                absent = sorted(
                    b for b in names if b in self._async_progs
                    and not self.scope.has_var(
                        b[:-len("@GRAD")] if b.endswith("@GRAD") else b))
                if absent:
                    raise KeyError(
                        f"pserver does not hold the parameters of "
                        f"{absent[:3]} (placed elsewhere by the current "
                        "view)")
                for base in sorted(names):
                    prog = self._async_progs.get(base)
                    if prog is not None:
                        self._ensure_state(base)
                        self.exe.run(prog, scope=self.scope)
            else:
                self.exe.run(self.program, scope=self.scope)
        # per-iteration sparse-row clearing (listen_and_serv_op.cc:171):
        # a round's rows must not be re-applied next round if a slower
        # trainer's SEND hasn't replaced the slot yet
        for base, parts in sparse:
            self.scope.erase(base)
            for p in parts:
                self.scope.erase(p)

    def _ensure_state(self, grad: str):
        """Before an elastic slice runs: its private copies of the
        epilogue's state start from the shared vars, and state a DROP
        took with an earlier copy of the parameter (a parameter
        installed again by recovery, with no state to carry) starts as
        the optimizer's accumulators do, at zeros of the parameter's
        shape."""
        for priv, shared in self._private.get(grad, {}).items():
            if not self.scope.has_var(priv) and self.scope.has_var(shared):
                self.scope.set_var(priv, self.scope.find_var(shared).clone())
        param = grad[:-len("@GRAD")] if grad.endswith("@GRAD") else grad
        if not self.scope.has_var(param):
            return
        like = self.scope.find_var(param)
        for n in self._companions.get(param, ()):
            if not self.scope.has_var(n) and isinstance(like, torch.Tensor):
                self.scope.set_var(n, torch.zeros_like(like))

    def _blocking_get(self, name: str):
        # The fan-in optimize runs atomically under the server lock, so a
        # GET serializes either fully before or fully after a round's
        # update — and a trainer only GETs after its own barrier returned,
        # i.e. after its round completed.  Reading under the lock is
        # therefore both torn-read-free and deadlock-free (waiting on
        # `_barriers == 0` here could deadlock: a fast trainer's next-round
        # barrier would block a slow trainer's GET forever).
        with self._lock:
            v = self.scope.find_var(name)
        if v is None:
            raise KeyError(f"pserver has no variable {name!r}")
        return v

    def _blocking_get_many(self, names):
        """GET_BATCH read: all names under ONE lock acquisition, so the
        whole bucket reads from the same round's state (a per-name loop
        could straddle an optimize)."""
        with self._lock:
            vals = []
            for n in names:
                # absent names raise KeyError in find_var; declared-
                # but-unset vars come back None — same curated error
                # for both
                v = (self.scope.find_var(n)
                     if self.scope.has_var(n) else None)
                if v is None:
                    raise KeyError(f"pserver has no variable {n!r}")
                vals.append(v)
        return vals


# ---------------------------------------------------------------------------
# client (grpc_client.h AsyncSendVariable/AsyncGetVariable/SendBatchBarrier)
# ---------------------------------------------------------------------------


class BarrierTimeoutError(TimeoutError):
    """A BARRIER response did not arrive within barrier_timeout — in
    sync-SGD fan-in that means some trainer never sent its barrier this
    round, i.e. a lost/wedged trainer (the reference surfaces this as a
    gRPC deadline on SendBatchBarrier)."""


class VariableClient:
    """Trainer-side transport with crash recovery: SEND/GET reconnect and
    resend through a RetryPolicy (both are idempotent — SEND overwrites
    this trainer's grad slot, GET is a read), while BARRIER resends only
    when the write provably never completed (the server counts barrier
    arrivals, so resending after a lost RESPONSE could double-count a
    round) and supports a timeout that detects a lost trainer.

    Note async (sync=False) servers apply a SEND on arrival, so a resent
    grad whose first copy DID land applies twice — inherent to
    at-least-once delivery over ASGD, which is already tolerant of
    reordered/duplicated updates; pass retry_policy=None-like
    max_attempts=1 to forbid it."""

    def __init__(self, endpoint: str, client_id: str = "",
                 connect_timeout: float = 180.0,
                 request_timeout: Optional[float] = None,
                 barrier_timeout: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None):
        import os as _os
        import uuid as _uuid

        self.endpoint = endpoint
        self._host, port = endpoint.rsplit(":", 1)
        self._port = int(port)
        # requests block indefinitely by default: a BARRIER response
        # legitimately waits for straggler trainers + the first
        # optimize-program compile (sync-SGD semantics, like the
        # reference's gRPC client Wait())
        self.request_timeout = request_timeout
        self.barrier_timeout = barrier_timeout
        self.connect_timeout = connect_timeout
        self._policy = retry_policy or RetryPolicy.from_env(
            "PSERVER_RETRY", max_attempts=5, base_delay=0.2,
            max_delay=2.0, deadline=30.0)
        # process-unique id: id(self) can collide ACROSS processes, which
        # would alias two trainers to one per-trainer grad slot.  A
        # reconnect re-HELLOs with the SAME id, so the server keeps
        # routing this trainer to its original grad slot.
        self._cid = client_id or f"{_os.getpid()}-{_uuid.uuid4().hex[:8]}"
        self.sock: Optional[socket.socket] = None
        # None = capability unknown (probe on first batch verb); False =
        # the server answered ERR "unknown verb" once, so every later
        # call goes straight to per-var frames without re-probing
        self._batch_supported: Optional[bool] = None
        # per-instance accounting of serialized PAYLOAD bytes by
        # direction (frame heads excluded, so the two directions are
        # comparable) — comm.CommPool deltas these around a round to
        # feed the round-bytes histogram without double-serializing
        self.bytes_sent = 0
        self.bytes_recv = 0
        # completed roundtrips by verb (the smoke's frames-a-round
        # figure reads deltas of it, as CommPool reads the bytes)
        self.frames: Dict[str, int] = {}
        self._connect(connect_timeout)

    def _connect(self, connect_timeout: Optional[float] = None):
        import time as _time

        deadline = _time.monotonic() + (connect_timeout
                                        if connect_timeout is not None
                                        else 30.0)
        while True:
            try:
                fault_injector().fire("pserver.connect")
                self.sock = socket.create_connection(
                    (self._host, self._port), timeout=5)
                break
            except OSError:
                # server process may still be booting (torch import +
                # program build); retry until the deadline
                self.sock = None
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.2)
        self.sock.settimeout(None)
        _send_frame(self.sock, "HELLO", self._cid)
        verb, name, _, _ = _recv_frame(self.sock)
        if verb != "OK":
            raise RuntimeError(f"pserver error: {name or verb}")

    def _drop_sock(self):
        s, self.sock = self.sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _request(self, verb: str, name: str = "", payload: bytes = b"",
                 idempotent: bool = True,
                 timeout: Optional[float] = None, payload_parts=None):
        """One framed roundtrip.  Connection-level failures (peer died,
        truncated frame, request timeout) reconnect + resend when
        `idempotent`; protocol-level ERR replies raise RuntimeError
        without retry (retrying a rejected request can't succeed).

        Non-idempotent verbs (BARRIER) still retry failures in the SEND
        phase — an incomplete write provably never reached the server's
        frame parser, so the request was not counted — and only
        propagate failures after the frame was fully handed to the
        kernel, where "applied but response lost" is indistinguishable
        from "never arrived"."""
        timeout = self.request_timeout if timeout is None else timeout
        state = self._policy.begin()
        # the client-side span covers the whole request (reconnects and
        # resends included); its context rides the frame head, so the
        # server-side handling span is its child in the same trace
        with obs_tracing.span("pserver.client." + verb.lower(),
                              endpoint=self.endpoint, var=name):
            trace = obs_tracing.inject()
            return self._request_attempts(state, verb, name, payload,
                                          idempotent, timeout, trace,
                                          payload_parts)

    def _request_attempts(self, state, verb, name, payload, idempotent,
                          timeout, trace, payload_parts=None):
        while True:
            sent = False
            try:
                if self.sock is None:
                    # reconnects cap the boot patience at 30s; clients
                    # built for elastic clusters pass a much smaller
                    # connect_timeout so a dead endpoint fails the
                    # round fast instead of spinning on refusals
                    self._connect(min(self.connect_timeout, 30.0))
                fault_injector().fire("pserver.request")
                self.sock.settimeout(timeout)
                try:
                    if (payload_parts is not None
                            and not fault_injector().rules()):
                        # zero-copy path: the frame never exists as one
                        # contiguous buffer — lengths + head in the
                        # first iovec, value views after it
                        n = _sendall_parts(
                            self.sock,
                            _frame_parts(verb, name, payload_parts,
                                         trace))
                        _M_BYTES_SENT.inc(n)
                        payload_n = sum(_blen(p)
                                        for p in payload_parts)
                    else:
                        # chaos rules mangle whole frames, so join the
                        # parts when the injector is armed
                        if payload_parts is not None:
                            payload = _join_parts(payload_parts)
                        frame = _frame_bytes(verb, name, payload, trace)
                        data = fault_injector().mangle(
                            "pserver.send", frame)
                        _M_BYTES_SENT.inc(len(data))
                        self.sock.sendall(data)
                        payload_n = len(payload)
                        if data != frame:
                            # injected mid-write crash / wire
                            # corruption: the server got a mangled
                            # frame; fail our side like the sender
                            # process died
                            raise ConnectionError(
                                "fault injection: mangled frame")
                    sent = True
                    rverb, rname, rpayload, _ = _recv_frame(self.sock)
                    # account the COMPLETED roundtrip only — a counted
                    # failed attempt would break sent/recv symmetry
                    self.bytes_sent += payload_n
                    self.bytes_recv += len(rpayload)
                    self.frames[verb] = self.frames.get(verb, 0) + 1
                finally:
                    if self.sock is not None:
                        self.sock.settimeout(None)
                if rverb == "ERR":
                    if rname.startswith("malformed frame"):
                        # the server is closing this desynced connection;
                        # for idempotent requests a fresh connection +
                        # resend is the recovery path
                        raise ConnectionError(
                            f"pserver rejected frame: {rname}")
                    raise RuntimeError(f"pserver error: {rname}")
                return rverb, rname, rpayload
            except (ConnectionError, OSError,  # incl. timeouts
                    ValueError, KeyError, TypeError) as e:
                # the Value/Key/TypeError arm is a malformed RESPONSE
                # (corrupt lengths / non-JSON head): the stream is
                # desynced, so the socket must be dropped either way —
                # reusing it would parse garbage as the next frame header
                timed_out = isinstance(e, (socket.timeout, TimeoutError))
                self._drop_sock()
                if not idempotent and sent:
                    raise
                state.record(e, what=(f"pserver {self.endpoint}: "
                                      f"{verb} {name}".rstrip()))
                if timed_out and timeout is not None:
                    # the deadline already consumed the patience budget
                    state._next_delay = 0.0
                state.sleep()

    def send_var(self, name: str, value):
        head, parts = serialize_var_parts(value)
        rverb, _, _ = self._request(
            "SEND", name, payload_parts=_var_payload_parts(head, parts))
        if rverb != "OK":
            raise RuntimeError(f"pserver error sending {name!r}: {rverb}")

    # -- fused transfers (SEND_BATCH/GET_BATCH with legacy fallback) --------
    def send_vars(self, items, bucket_bytes: Optional[int] = None):
        """Fused SEND: pack `[(name, value)]` into arrival-order buckets
        capped at `bucket_bytes` (default: the comm_bucket_bytes flag /
        PADDLE_TPU_COMM_BUCKET_BYTES) and ship each bucket as ONE
        SEND_BATCH frame.  Falls back to per-var legacy SENDs against a
        server that answers ERR (wire compat both ways) or when
        bucketing is disabled (cap <= 0)."""
        items = list(items)
        cap = _bucket_cap(bucket_bytes)
        if cap <= 0 or self._batch_supported is False or len(items) <= 1:
            for n, v in items:
                self.send_var(n, v)
            return
        prepared = _prepare_vars(items)
        buckets = _pack_buckets(prepared, cap)
        for bi, bucket in enumerate(buckets):
            if not self._send_bucket(bucket, cap):
                # legacy server: this and every later bucket per-var
                for later in buckets[bi:]:
                    for n, head, parts, _ in later:
                        rverb, _, _ = self._request(
                            "SEND", n,
                            payload_parts=_var_payload_parts(head,
                                                             parts))
                        if rverb != "OK":
                            raise RuntimeError(
                                f"pserver error sending {n!r}: {rverb}")
                return

    def _send_bucket(self, bucket, cap: int) -> bool:
        """One SEND_BATCH frame; False (nothing sent) when the server
        does not speak batch."""
        if self._batch_supported is False:
            return False
        try:
            rverb, _, _ = self._request(
                "SEND_BATCH", "",
                payload_parts=_batch_payload_parts(bucket))
        except RuntimeError as e:
            if "unknown verb" in str(e):
                self._batch_supported = False
                _M_BATCH_FALLBACK.inc()
                return False
            raise
        if rverb != "OK":
            raise RuntimeError(f"pserver error on SEND_BATCH: {rverb}")
        self._batch_supported = True
        _M_BUCKET_VARS.observe(len(bucket))
        _M_BUCKET_FILL.observe(sum(it[3] for it in bucket) / cap)
        return True

    def get_vars(self, names, bucket_bytes: Optional[int] = None):
        """Fused GET: one GET_BATCH frame per `_GET_BATCH_CHUNK` names
        (the reply slices a single buffer — no per-var copies); per-var
        GETs against a legacy server, or whenever fusion is disabled
        (cap <= 0 — the same switch send_vars honors, so
        comm_bucket_bytes=0 really is the whole legacy wire path).
        Returns values in `names` order."""
        names = list(names)
        fused = _bucket_cap(bucket_bytes) > 0
        out = []
        i = 0
        while i < len(names):
            if (not fused or self._batch_supported is False
                    or len(names) - i == 1):
                out.append(self.get_var(names[i]))
                i += 1
                continue
            chunk = names[i:i + _GET_BATCH_CHUNK]
            try:
                rverb, _, rpayload = self._request(
                    "GET_BATCH", "", json.dumps(chunk).encode())
            except RuntimeError as e:
                msg = str(e)
                if "unknown verb" in msg:
                    self._batch_supported = False
                    _M_BATCH_FALLBACK.inc()
                    continue  # redo this chunk per-var
                if "batch too large" in msg:
                    # this chunk's params overflow one reply frame —
                    # per-var GETs for IT only; the endpoint still
                    # speaks batch
                    out.extend(self.get_var(n) for n in chunk)
                    i += len(chunk)
                    continue
                raise
            if rverb != "VARS":
                raise RuntimeError(
                    f"pserver error on GET_BATCH: {rverb}")
            pairs = deserialize_batch(rpayload)
            got = [n for n, _ in pairs]
            if got != chunk:
                raise RuntimeError(
                    f"GET_BATCH answered vars {got[:3]}... for request "
                    f"{chunk[:3]}...: protocol desync")
            self._batch_supported = True
            out.extend(v for _, v in pairs)
            i += len(chunk)
        return out

    # -- elastic cluster verbs (cloud/cluster.py view changes) --------------
    def put_vars(self, items, bucket_bytes: Optional[int] = None) -> int:
        """Install values under their CANONICAL names (shard migration /
        trainer-held recovery — NOT grads: SEND's per-trainer rename is
        deliberately bypassed).  Buckets like send_vars; returns payload
        bytes shipped.  Elastic servers always speak PUT_BATCH (the verb
        ships with FENCE/COMMIT), so there is no legacy fallback."""
        prepared = _prepare_vars(list(items))
        cap = _bucket_cap(bucket_bytes)
        if cap <= 0:
            cap = 1 << 62  # bucketing off: one bucket, still PUT_BATCH
        buckets = _pack_buckets(prepared, cap)
        total = 0
        for bucket in buckets:
            rverb, _, _ = self._request(
                "PUT_BATCH", "", payload_parts=_batch_payload_parts(bucket))
            if rverb != "OK":
                raise RuntimeError(f"pserver error on PUT_BATCH: {rverb}")
            total += sum(it[3] for it in bucket)
        return total

    def drop_vars(self, names):
        """Erase vars (and their per-trainer grad slots) migrated away
        from this server by a rebalance."""
        rverb, _, _ = self._request("DROP", "",
                                    json.dumps(list(names)).encode())
        if rverb != "OK":
            raise RuntimeError(f"pserver error on DROP: {rverb}")

    def have_vars(self, names):
        """The subset of `names` this server currently holds — the
        controller's bootstrap-copy probe before initial placement."""
        rverb, _, rpayload = self._request(
            "HAVE", "", json.dumps(list(names)).encode())
        if rverb != "OK":
            raise RuntimeError(f"pserver error on HAVE: {rverb}")
        return set(json.loads(bytes(rpayload)))

    def state_of(self, names):
        """{param: the persistables an elastic server keeps beside it}
        (its optimizer state, which a migration moves with it).  A
        server that does not speak STATE raises RuntimeError."""
        rverb, _, rpayload = self._request(
            "STATE", "", json.dumps(list(names)).encode())
        if rverb != "OK":
            raise RuntimeError(f"pserver error on STATE: {rverb}")
        return json.loads(bytes(rpayload))

    def fence(self, epoch: int):
        """Two-phase view change, phase 1: quiesce rounds (idempotent —
        re-fencing an already-fenced server just renews the epoch)."""
        rverb, _, _ = self._request("FENCE", str(int(epoch)))
        if rverb != "OK":
            raise RuntimeError(f"pserver error on FENCE: {rverb}")

    def commit(self, epoch: int, fan_in: Optional[int] = None):
        """Two-phase view change, phase 2: adopt the view (new fan_in,
        cleared pre-view grad slots, fence released)."""
        payload = json.dumps({"fan_in": fan_in}).encode()
        rverb, _, _ = self._request("COMMIT", str(int(epoch)), payload)
        if rverb != "OK":
            raise RuntimeError(f"pserver error on COMMIT: {rverb}")

    def send_batch_barrier(self, timeout: Optional[float] = None) -> str:
        """Sync-round barrier -> the server's word on the round:
        "applied" (its optimize ran), "released" (a view change let the
        barrier go without it) or "" (a server that does not say, the
        JAX package's).  `timeout` (or the instance-level
        barrier_timeout) bounds the wait; expiry raises
        BarrierTimeoutError — the sync-SGD signature of a trainer that
        died before barriering this round."""
        import time as _time

        timeout = self.barrier_timeout if timeout is None else timeout
        t0 = _time.perf_counter()
        try:
            rverb, rname, _ = self._request("BARRIER", idempotent=False,
                                            timeout=timeout)
            _M_BARRIER_WAIT.observe(_time.perf_counter() - t0)
        except (socket.timeout, TimeoutError) as e:
            raise BarrierTimeoutError(
                f"pserver {self.endpoint}: no barrier release within "
                f"{timeout}s — a trainer in this round is lost or "
                "wedged") from e
        if rverb != "OK":
            raise RuntimeError(f"pserver error at barrier: {rverb}")
        return rname

    def get_var(self, name: str):
        rverb, _, rpayload = self._request("GET", name)
        if rverb != "VAR":
            raise RuntimeError(f"pserver error fetching {name!r}: {rverb}")
        # the reply buffer is this frame's alone — a view is safe
        return deserialize_var(rpayload, copy=False)

    def get_flight_record(self) -> dict:
        """On-demand flight-recorder dump of the SERVER process
        (observability/flightrecorder.py): its ring of recent spans,
        structured events and metric snapshots.  Works against any
        live server; one that never armed a recorder answers an honest
        empty ring (``armed: false``)."""
        rverb, rname, rpayload = self._request("FLIGHT")
        if rverb != "OK":
            raise RuntimeError(
                f"pserver error on FLIGHT: {rname or rverb}")
        return json.loads(bytes(rpayload))

    def stop_server(self):
        rverb, _, _ = self._request("STOP", idempotent=False)
        if rverb != "OK":
            raise RuntimeError(f"pserver error on stop: {rverb}")

    def close(self):
        self._drop_sock()

    def __del__(self):
        try:
            self._drop_sock()
        except Exception:
            pass
