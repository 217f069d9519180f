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

Not ported: the AOT export (`export_aot_model`, `load_aot_model`: a
`torch.export` artifact, ROADMAP A10b) and the static verification a
loaded model gets under PADDLE_TPU_VERIFY=warn|error (the analysis
passes, ROADMAP A12); both raise NotImplementedError naming the item.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import uuid as uuid_mod
import warnings
from typing import List, Sequence

from .core.framework import (Parameter, Program, Variable,
                             default_main_program)

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


def _preflight(program):
    """The JAX package's `analysis.preflight` of a loaded Program: off by
    default; its passes are not ported."""
    from .core.flags import get_flag

    mode = str(get_flag("verify") or "off").lower()
    if mode == "off":
        return
    if mode not in ("warn", "error"):
        raise ValueError(
            f"PADDLE_TPU_VERIFY must be off|warn|error, got {mode!r}")
    raise NotImplementedError(
        f"PADDLE_TPU_VERIFY={mode}: the static verification of a loaded "
        "inference model needs the analysis passes, which are not ported "
        "yet (ROADMAP A12); set it to 'off'")


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """-> (inference Program, feed names, fetch names), the persistables
    loaded into `scope` on the executor's device."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        payload = json.load(f)
    program = Program.from_dict(payload["program"])
    _preflight(program)
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    return (program, payload["feed_var_names"],
            payload["fetch_var_names"])


def export_aot_model(dirname, feed_specs, target_vars, executor,
                     main_program=None, scope=None):
    """The AOT artifact (a `torch.export` program with its weights) is
    not ported yet: ROADMAP A10b."""
    raise NotImplementedError(
        "export_aot_model: the AOT artifact (torch.export) is not ported "
        "yet (ROADMAP A10b)")


def load_aot_model(dirname):
    """Not ported yet: ROADMAP A10b."""
    raise NotImplementedError(
        "load_aot_model: the AOT artifact (torch.export) is not ported "
        "yet (ROADMAP A10b)")


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
                       max_keep: int = 3) -> dict:
    """Finish a snapshot directory: its meta record, the atomic
    `__latest__` pointer (written to a temporary, then renamed), GC ->
    the meta record."""
    meta = {"uuid": cp_uuid, "md5": _md5_of_dir(cp_dir),
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
