"""Model persistence: saving and loading variables, the
inference-model format, checkpoints, and inference pruning (counterpart
of paddle_tpu/io.py).

Reference: python/paddle/v2/fluid/io.py (save_vars/save_params/
save_persistables, save_inference_model/load_inference_model) and
framework/prune.cc (drop the ops the fetch targets do not need).

The layout is the JAX package's, so either package reads what the other
wrote: one file per variable named after it inside `dirname` (or one
combined file when `filename` is given), written by the io ops
(ops/io_ops.py) in a small Program the Executor runs, and a
`__model__` file holding the pruned test-mode Program as JSON
(core/framework.py to_dict/from_dict) with its feed and fetch names.

Checkpoints (the Go pserver's protocol, go/pserver/service.go:120-203,
346, and doc/design/cluster_train/checkpointing.md): a snapshot
directory `checkpoint_<uuid>` of persistables with a {uuid, md5,
timestamp, trainer_args} meta record, an atomically replaced
`__latest__` pointer, md5 verification with a fall back to an older
snapshot (and a RuntimeWarning), and GC of old snapshots that spares
incomplete ones younger than 30 minutes (another writer may be mid-
save).

The AOT artifact (`export_aot_model`, `load_aot_model`) is a
`torch.export` program of the pruned inference block, its parameters
passed in as arguments from a side-car snapshot that keeps every bit,
its hand-written kernels recorded as their PyTorch ops.  A loaded
inference model is verified under PADDLE_TPU_VERIFY=warn|error
(analysis.preflight) before its parameters load.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid as uuid_mod
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.framework import (Parameter, Program, Variable,
                             default_main_program)
from .core.scope import tensor_from_numpy

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "export_aot_model",
    "load_aot_model",
    "save_checkpoint",
    "publish_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "prune",
    "get_inference_program",
]

MODEL_FILENAME = "__model__"


def is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _build_save_load_program(op_type, var_names, dirname, filename):
    """A small Program of save or load ops, which the Executor runs: one
    op a variable, or one combined op when `filename` is given."""
    prog = Program()
    block = prog.global_block()
    for name in var_names:
        block.create_var(name=name, dtype=None, persistable=True)
    if filename is None:
        for name in var_names:
            path = os.path.join(dirname, name)
            if op_type == "save":
                block.append_op("save", inputs={"X": [name]},
                                attrs={"file_path": path})
            else:
                block.append_op("load", outputs={"Out": [name]},
                                attrs={"file_path": path})
    else:
        path = os.path.join(dirname, filename)
        if op_type == "save":
            block.append_op("save_combine", inputs={"X": list(var_names)},
                            attrs={"file_path": path})
        else:
            block.append_op("load_combine",
                            outputs={"Out": list(var_names)},
                            attrs={"file_path": path})
    return prog


def _select_vars(program, predicate, vars):
    if vars is not None:
        return [v.name if isinstance(v, Variable) else str(v) for v in vars]
    return sorted(v.name for v in program.list_vars() if predicate(v))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=is_persistable, filename=None, scope=None):
    """Save the variables `vars` names, or those of `main_program` that
    `predicate` selects, into `dirname` -> their names."""
    program = main_program or default_main_program()
    names = _select_vars(program, predicate, vars)
    os.makedirs(dirname, exist_ok=True)
    executor.run(_build_save_load_program("save", names, dirname, filename),
                 scope=scope)
    return names


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=is_persistable, filename=None, scope=None):
    """Load the selected variables from `dirname` into `scope` (the
    global scope when None), each on the executor's device with the
    dtype and LoD its file holds -> their names."""
    program = main_program or default_main_program()
    names = _select_vars(program, predicate, vars)
    executor.run(_build_save_load_program("load", names, dirname, filename),
                 scope=scope)
    return names


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def prune(program: Program, targets: Sequence,
          for_test: bool = False) -> Program:
    """A clone of `program` whose block 0 keeps only the ops needed to
    compute `targets`.  An op with sub-blocks is kept whole if any of its
    outputs is needed, and the names read anywhere inside its sub-blocks
    count as its own reads, so their block-0 producers are kept too."""
    target_names = {
        t.name if isinstance(t, Variable) else str(t) for t in targets
    }
    pruned = program.clone(for_test=for_test)

    def op_reads(op):
        names = set(op.input_names())
        for attr in op.attrs:
            sub = op.sub_block(attr) if attr.endswith("block") else None
            if sub is not None:
                for sub_op in sub.ops:
                    names.update(op_reads(sub_op))
        return names

    block = pruned.global_block()
    needed = set(target_names)
    keep = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_names()):
            keep.append(op)
            needed.update(op_reads(op))
    keep.reverse()
    block.ops = keep
    referenced = set(target_names)
    for op in keep:
        referenced.update(op_reads(op))
        referenced.update(op.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    pruned.bump_version()
    return pruned


def get_inference_program(target_vars, main_program=None) -> Program:
    """The test-mode program that computes `target_vars` alone."""
    program = main_program or default_main_program()
    return prune(program, target_vars, for_test=True)


def save_inference_model(dirname, feeded_var_names: Sequence[str],
                         target_vars, executor, main_program=None,
                         model_filename=None, params_filename=None,
                         scope=None) -> List[str]:
    """Prune to the fetch targets in test mode, write `__model__` (the
    Program, the feed and the fetch names) and the pruned Program's
    persistables -> the fetch names."""
    program = main_program or default_main_program()
    inference_program = get_inference_program(target_vars, program)
    fetch_names = [t.name if isinstance(t, Variable) else str(t)
                   for t in target_vars]
    os.makedirs(dirname, exist_ok=True)
    payload = {"program": inference_program.to_dict(),
               "feed_var_names": list(feeded_var_names),
               "fetch_var_names": fetch_names}
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "w") as f:
        json.dump(payload, f)
    save_persistables(executor, dirname, inference_program,
                      filename=params_filename, scope=scope)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """-> (inference Program, feed names, fetch names), the persistables
    loaded into `scope` on the executor's device."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        payload = json.load(f)
    program = Program.from_dict(payload["program"])
    # PADDLE_TPU_VERIFY pre-flight (off by default): a deserialized bad
    # program fails here, before any parameter is loaded
    from .analysis import preflight

    preflight(program, feed_names=payload.get("feed_var_names"),
              fetch_names=payload.get("fetch_var_names"))
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    return (program, payload["feed_var_names"],
            payload["fetch_var_names"])


AOT_FILENAME = "__aot_torch_export__"


class _InferenceModule(torch.nn.Module):
    """A pruned inference block as a module for torch.export:
    `forward(params, feeds)` -> the fetches, a tuple.  It runs the
    block's resolved plan eagerly (`_Plan.run`, the path an Executor or
    `program_to_fn` takes at a cache miss), never a CUDA-graph capture or
    replay."""

    def __init__(self, plan, fetch_names, device, seed):
        super().__init__()
        self.plan, self.fetch_names = plan, list(fetch_names)
        self.device, self.seed = device, seed

    def forward(self, params, feeds):
        from .core.execution import ExecContext

        env = self.plan.run(ExecContext(self.device, seed=self.seed),
                            {**params, **feeds})
        return tuple(env[n] for n in self.fetch_names)


def _check_exportable(block, feed_names, fetch_names, device):
    """Raise on what an exported graph cannot carry: a host op (run
    eagerly between device segments: control flow, tensor arrays, a
    CPU-placed op, a random op on a card), a LoD feed, a fetch no op
    produces."""
    from .core.executor import _op_is_host

    for op in block.ops:
        if _op_is_host(op, device):
            raise ValueError(
                f"export_aot_model: op {op.type!r} (outputs "
                f"{op.output_names()}) runs on the host between device "
                "segments, which an exported graph cannot hold; export a "
                "program without it")
    for n in feed_names:
        var = block.vars.get(n)
        if var is None:
            raise ValueError(f"export_aot_model: feed {n!r} is not a "
                             "variable of the program")
        if var.lod_level:
            raise ValueError(
                f"export_aot_model: feed {n!r} has lod_level "
                f"{var.lod_level}; an exported graph takes dense tensors "
                "of fixed shapes only")
    written = {m for op in block.ops for m in op.output_names()}
    missing = [n for n in fetch_names if n not in written
               and n not in feed_names]
    if missing:
        raise ValueError(f"export_aot_model: fetch variable(s) {missing} "
                         "are produced by no op of the pruned program")


def _param_bits(t):
    """A parameter as a numpy array holding its exact bits: bf16 (which
    numpy lacks) as its int16 view."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _param_from_bits(arr, dtype_name):
    from .core.types import torch_dtype

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name == "bfloat16":
        return t.view(torch.bfloat16)
    return t.to(torch_dtype(dtype_name))


def export_aot_model(dirname, feed_specs: dict, target_vars, executor,
                     main_program=None, scope=None) -> str:
    """AOT-export the pruned inference function as a `torch.export`
    program plus a side-car weights snapshot (counterpart of the JAX
    package's StableHLO export).

    The program is pruned to `target_vars` in test mode
    (`get_inference_program`) and its block run through its resolved
    plan (`_Plan.run`) under `torch.export.export(..., strict=False)` at
    the concrete `feed_specs` shapes, on the executor's device.  The
    hand-written kernels on the path are recorded as their PyTorch ops
    (`paddle_tpu_torch::flash_attention_fwd`,
    `paddle_tpu_torch::moe_gate_route`), so the loaded graph launches
    them on a card; on the CPU the same ops run their plain versions.
    The flags the lowerings read (amp, conv_layout) are taken as they
    stand and fixed in the graph.

    Params are ARGUMENTS (ordered by the `param_names` list of the meta
    json), their values snapshotted bit for bit to
    `<artifact>.params.npz` (bf16 as its int16 bits, the dtype in the
    meta json): baking them in as constants would copy the full
    parameter size into the graph.  A program with a host op (control
    flow, tensor arrays, a CPU-placed op, a random op on a card) or a
    LoD feed raises here, naming it.

    `feed_specs`: {feed_name: (shape, dtype)}.  Writes
    `<dirname>/__aot_torch_export__` (torch.export.save), its `.json`
    meta (`feed_specs`, `param_names`, `param_dtypes`,
    `fetch_var_names`, `device`) and its `.params.npz` -> the artifact
    path."""
    from .core.executor import (_Plan, _analyze_states, _sub_names,
                                global_scope)
    from .core.types import canonical_dtype, torch_dtype

    program = main_program or default_main_program()
    inference_program = get_inference_program(target_vars, program)
    block = inference_program.global_block()
    fetch_names = [t.name if isinstance(t, Variable) else str(t)
                   for t in target_vars]
    feed_names = list(feed_specs)
    device = executor.device
    _check_exportable(block, feed_names, fetch_names, device)
    scope = scope or global_scope()
    param_names, _ = _analyze_states(inference_program, block, feed_names)
    params = {}
    for n in param_names:
        v = scope.find_var(n) if scope.has_var(n) else None
        if not isinstance(v, torch.Tensor):
            raise RuntimeError(
                f"export_aot_model: persistable {n!r} has no tensor value "
                "in scope — run the startup program (or load the model) "
                "first")
        params[n] = v.to(device)
    feeds = {n: torch.zeros(tuple(int(d) for d in shape),
                            dtype=torch_dtype(dtype), device=device)
             for n, (shape, dtype) in feed_specs.items()}
    persistable = frozenset(v.name for v in inference_program.list_vars()
                            if v.persistable)
    plan = _Plan(block.ops, persistable, _sub_names(inference_program))
    module = _InferenceModule(plan, fetch_names, device,
                              inference_program.seed or 0)
    with torch.no_grad():
        exported = torch.export.export(module, (params, feeds),
                                       strict=False)
    _conv_pin(exported)     # one conv backend for the whole graph
    # the trace's example inputs are the parameters themselves: saved
    # with the graph they would write every weight a second time
    exported.example_inputs = None
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, AOT_FILENAME)
    with open(path, "wb") as f:   # a file object: any name will do
        torch.export.save(exported, f)
    np.savez(path + ".params.npz",
             **{n: _param_bits(v) for n, v in params.items()})
    with open(path + ".json", "w") as f:
        json.dump({"feed_specs": {n: [[int(d) for d in s],
                                      canonical_dtype(d_)]
                                  for n, (s, d_) in feed_specs.items()},
                   "param_names": list(param_names),
                   "param_dtypes": {n: canonical_dtype(v.dtype)
                                    for n, v in params.items()},
                   "fetch_var_names": fetch_names,
                   "device": device.type}, f)
    return path


def _conv_pin(exported):
    """The dtype whose pinned convolution backend (ops/conv.py
    `conv_pinned`) the graph's convolutions ran under when traced, or
    None when it has none.  The backend is a global setting, not a node
    of the graph, so the loaded callable sets it around each call; a
    graph whose convolutions would need two backends raises."""
    from .ops.conv import conv_pinned_class

    dtypes = set()
    for node in exported.graph.nodes:
        if node.op == "call_function" and "convolution" in str(node.target):
            val = node.args[0].meta.get("val")
            if val is not None:
                dtypes.add(val.dtype)
    classes = {conv_pinned_class(d) for d in dtypes}
    if len(classes) > 1:
        raise ValueError(
            "export_aot_model: the graph's convolutions run in "
            f"{sorted(str(d) for d in dtypes)}, which pin different "
            "convolution backends; an artifact runs under one")
    return next(iter(dtypes)) if dtypes else None


def load_aot_model(dirname, place=None):
    """-> (callable(feeds) -> [fetch tensors], feed_specs,
    fetch_var_names).  Loads the `torch.export` artifact that
    `export_aot_model` wrote and its side-car weights snapshot — no
    Program, Scope or op registry involved, only the kernels' ops.  It
    runs on `place`'s device (None = CUDAPlace(0), raising with no
    card); an artifact exported on the other device is moved there
    (`torch.export.passes.move_to_device_pass`).  `feeds` is {name:
    array or tensor} of the exported shapes; the fetches come back as
    tensors on that device.  The callable carries the loaded
    ExportedProgram as `call.exported_program`."""
    from contextlib import nullcontext

    from .core.executor import resolve_place
    from .core.types import torch_dtype
    from .ops.conv import conv_pinned

    device = resolve_place(place)
    path = os.path.join(dirname, AOT_FILENAME)
    with open(path + ".json") as f:
        meta = json.load(f)
    with open(path, "rb") as f:
        exported = torch.export.load(f)
    if meta.get("device", device.type) != device.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    with np.load(path + ".params.npz") as z:
        params = {n: _param_from_bits(z[n], meta["param_dtypes"][n]).to(
            device) for n in meta["param_names"]}
    specs = {n: (tuple(shape), torch_dtype(dt))
             for n, (shape, dt) in meta["feed_specs"].items()}
    pin = _conv_pin(exported)
    module = exported.module()

    def call(feeds):
        missing = [n for n in specs if n not in feeds]
        if missing:
            raise KeyError(f"load_aot_model: missing feeds {missing}")
        args = {}
        for n, (shape, dtype) in specs.items():
            v = feeds[n]
            t = v if isinstance(v, torch.Tensor) else tensor_from_numpy(v)
            if tuple(t.shape) != shape:
                raise ValueError(f"load_aot_model: feed {n!r} has shape "
                                 f"{tuple(t.shape)}; the artifact was "
                                 f"exported at {shape}")
            args[n] = t.to(device=device, dtype=dtype)
        with torch.no_grad(), (conv_pinned(pin) if pin is not None
                               else nullcontext()):
            return list(module(params, args))

    call.exported_program = exported
    return call, meta["feed_specs"], meta["fetch_var_names"]


# ---------------------------------------------------------------------------
# checkpoints: {uuid, md5, timestamp, trainer_args}, `__latest__`, GC
# ---------------------------------------------------------------------------

CHECKPOINT_PREFIX = "checkpoint"
LATEST_FILENAME = "__latest__"
META_FILENAME = "__meta__"
# incomplete (meta-less) snapshots younger than this are taken for
# another writer's save in progress and left alone
_GC_INCOMPLETE_GRACE_S = 30 * 60


def _md5_of_dir(path: str) -> str:
    """md5 over the snapshot's files (names and bytes, in name order),
    the `__`-prefixed meta files left out."""
    h = hashlib.md5()
    for name in sorted(os.listdir(path)):
        if name.startswith("__"):
            continue
        h.update(name.encode())
        with open(os.path.join(path, name), "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def save_checkpoint(executor, dirname, main_program=None, trainer_args=None,
                    scope=None, max_keep: int = 3) -> str:
    """Snapshot the persistables (parameters, optimizer accumulators,
    learning rates) into `dirname/checkpoint_<uuid>/`, publish it as the
    latest and GC beyond `max_keep` -> the snapshot's uuid.  The
    `checkpoint.save` fault site fires first."""
    from .core.resilience import fault_injector
    from .observability import metrics as obs_metrics
    from .observability import tracing as obs_tracing

    if max_keep < 0:
        raise ValueError(f"max_keep must be >= 0, got {max_keep}")
    fault_injector().fire("checkpoint.save")
    t0 = time.perf_counter()
    with obs_tracing.span("checkpoint.save", dirname=dirname):
        cp_uuid = uuid_mod.uuid4().hex
        cp_dir = os.path.join(dirname, f"{CHECKPOINT_PREFIX}_{cp_uuid}")
        os.makedirs(cp_dir, exist_ok=True)
        save_persistables(executor, cp_dir, main_program, scope=scope)
        publish_checkpoint(dirname, cp_uuid, cp_dir, trainer_args,
                           max_keep)
    obs_metrics.histogram(
        "paddle_tpu_checkpoint_save_seconds",
        "save_checkpoint wall latency (persistables + md5 publish)"
    ).observe(time.perf_counter() - t0)
    return cp_uuid


def publish_checkpoint(dirname, cp_uuid, cp_dir, trainer_args=None,
                       max_keep: int = 3, md5: Optional[str] = None) -> dict:
    """Finish a snapshot directory: its meta record, the atomic
    `__latest__` pointer (written to a temporary, then renamed), GC ->
    the meta record.  `md5`: the directory's digest (`_md5_of_dir`'s),
    when the writer took it while writing; else read back here."""
    meta = {"uuid": cp_uuid, "md5": md5 or _md5_of_dir(cp_dir),
            "timestamp": time.time(), "trainer_args": trainer_args or {}}
    with open(os.path.join(cp_dir, META_FILENAME), "w") as f:
        json.dump(meta, f)
    latest_tmp = os.path.join(dirname, LATEST_FILENAME + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(cp_uuid)
    os.replace(latest_tmp, os.path.join(dirname, LATEST_FILENAME))
    _gc_checkpoints(dirname, keep=max_keep, always_keep={cp_uuid})
    return meta


def _checkpoints_by_time(dirname):
    """[(timestamp, dir name, meta)] of the complete snapshots, oldest
    first."""
    out = []
    for name in os.listdir(dirname):
        if not name.startswith(CHECKPOINT_PREFIX + "_"):
            continue
        try:
            with open(os.path.join(dirname, name, META_FILENAME)) as f:
                meta = json.load(f)
            out.append((meta["timestamp"], name, meta))
        except (OSError, ValueError, KeyError):
            continue  # partly written: a GC candidate
    out.sort()
    return out


def _gc_checkpoints(dirname, keep: int, always_keep=()):
    """Remove all but the newest `keep` complete snapshots and the
    incomplete ones older than the grace period; `always_keep` uuids
    stay whatever their timestamps say (a clock step must not sort the
    snapshot just published oldest)."""
    if keep < 0:
        raise ValueError(f"max_keep must be >= 0, got {keep}")
    complete = _checkpoints_by_time(dirname)
    keep_names = {name for _, name, _ in complete[-keep:]} if keep else set()
    keep_names |= {f"{CHECKPOINT_PREFIX}_{u}" for u in always_keep}
    complete_names = {name for _, name, _ in complete}
    now = time.time()
    for name in os.listdir(dirname):
        if not name.startswith(CHECKPOINT_PREFIX + "_") or name in keep_names:
            continue
        path = os.path.join(dirname, name)
        if name not in complete_names:
            try:
                if now - os.path.getmtime(path) < _GC_INCOMPLETE_GRACE_S:
                    continue
            except OSError:
                continue
        shutil.rmtree(path, ignore_errors=True)


def latest_checkpoint(dirname):
    """-> (snapshot dir, meta) of the newest valid snapshot, or (None,
    None): the `__latest__` pointer's first, then the rest newest first;
    a snapshot whose md5 does not match its record is skipped with a
    RuntimeWarning."""
    if not os.path.isdir(dirname):
        return None, None
    latest = os.path.join(dirname, LATEST_FILENAME)
    candidates = []
    if os.path.exists(latest):
        with open(latest) as f:
            candidates.append(f.read().strip())
    candidates.extend(meta["uuid"] for _, _, meta
                      in reversed(_checkpoints_by_time(dirname)))
    seen = set()
    for cp_uuid in candidates:
        if cp_uuid in seen:
            continue
        seen.add(cp_uuid)
        cp_dir = os.path.join(dirname, f"{CHECKPOINT_PREFIX}_{cp_uuid}")
        try:
            with open(os.path.join(cp_dir, META_FILENAME)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if _md5_of_dir(cp_dir) == meta.get("md5"):
            return cp_dir, meta
        warnings.warn(
            f"checkpoint {cp_uuid} under {dirname} failed md5 "
            "verification (corrupt or torn write); falling back to an "
            "older snapshot", RuntimeWarning, stacklevel=2)
    return None, None


def load_checkpoint(executor, dirname, main_program=None, scope=None):
    """Restore the persistables from the newest valid snapshot under
    `dirname` -> its meta record, or None when there is none."""
    from .observability import metrics as obs_metrics
    from .observability import tracing as obs_tracing

    t0 = time.perf_counter()
    with obs_tracing.span("checkpoint.load", dirname=dirname):
        cp_dir, meta = latest_checkpoint(dirname)
        if cp_dir is None:
            return None
        load_persistables(executor, cp_dir, main_program, scope=scope)
    obs_metrics.histogram(
        "paddle_tpu_checkpoint_load_seconds",
        "load_checkpoint wall latency (restore of the newest valid "
        "snapshot)").observe(time.perf_counter() - t0)
    return meta
