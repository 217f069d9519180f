"""Program / Block / Operator / Variable graph IR.

Counterpart of paddle_tpu/core/framework.py, field for field: a Program
built here serializes (`to_dict`) to exactly what the JAX package's
builders produce for the same model, which the tests pin.  The IR is
framework-neutral Python; only build-time shape inference
(core/shape_inference.py) touches torch, through the ops' lowerings on
meta tensors.
"""
from __future__ import annotations

import contextlib
import copy
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import registry
from .types import VarType, canonical_dtype

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "EMPTY_VAR_NAMES",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "unique_name",
    "grad_var_name",
    "pipeline_stage",
    "current_pipeline_stage",
]

GRAD_SUFFIX = "@GRAD"


def normalize_sharding(spec):
    """Canonical form of a GSPMD-style sharding annotation: a tuple with
    one entry per tensor dim — `None` (replicated dim), a mesh-axis name
    string, or a tuple of axis names (dim split over their product).
    Accepts lists or the canonical form itself; returns None for "no
    annotation"."""
    if spec is None:
        return None
    if isinstance(spec, str):
        # a bare "dp" would iterate as ('d', 'p') — an unintended rank-2
        # split over nonexistent axes; demand the explicit per-dim form
        raise ValueError(
            f"sharding spec must have one entry per tensor dim — got the "
            f"bare string {spec!r}; write ({spec!r},) to shard dim 0")
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, str):
            out.append(e)
        elif isinstance(e, (list, tuple)):
            bad = [a for a in e if not isinstance(a, str)]
            if bad:
                raise ValueError(
                    f"sharding spec entry {e!r}: grouped axes must be "
                    "mesh-axis names")
            out.append(tuple(e))
        else:
            raise ValueError(
                f"sharding spec entry {e!r} is not None, an axis name, "
                "or a tuple of axis names")
    return tuple(out)


def sharding_axes(spec):
    """Flat list of mesh-axis names referenced by a normalized spec (a
    repeated name appears repeatedly — callers detect duplicates)."""
    axes = []
    for e in spec or ():
        if isinstance(e, str):
            axes.append(e)
        elif isinstance(e, tuple):
            axes.extend(e)
    return axes

# sentinel "no variable here" slot entries (reference: kEmptyVarName) —
# grad descs use them for inputs that need no gradient; every name-based
# walk (execution dispatch, backward, the analysis passes) skips them
EMPTY_VAR_NAMES = ("", "@EMPTY@")


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

_name_counters: Dict[str, int] = {}


def unique_name(prefix: str) -> str:
    idx = _name_counters.get(prefix, 0)
    _name_counters[prefix] = idx + 1
    return f"{prefix}_{idx}"


def reset_unique_names():
    _name_counters.clear()


# ---------------------------------------------------------------------------
# pipeline stage annotation
# ---------------------------------------------------------------------------

_pipeline_stage_stack: List[int] = []


class pipeline_stage:
    """`with fluid.pipeline_stage(i): ...` — tag the ops built inside the
    block with pipeline stage `i`.

    This is the DSL surface of pipeline parallelism: a stage annotation
    on Program ops (attrs["pipeline_stage"]), consumed by
    parallel/pipeline_program.py's PipelineExecutor (the op's gradient
    op carries it too).
    """

    def __init__(self, idx: int):
        self.idx = int(idx)

    def __enter__(self):
        _pipeline_stage_stack.append(self.idx)
        return self

    def __exit__(self, *exc):
        _pipeline_stage_stack.pop()
        return False


def current_pipeline_stage() -> Optional[int]:
    return _pipeline_stage_stack[-1] if _pipeline_stage_stack else None


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------


class Variable:
    """A named slot in a Block (reference framework.py:127).

    `shape` may contain -1 (batch / data-dependent dims); concrete shapes are
    only fixed when the executor binds real arrays.
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: str = "float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        type: str = VarType.LOD_TENSOR,
        initializer=None,
        donate: bool = False,
        sharding=None,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.initializer = initializer
        # donation hint for executors that reuse a feed's buffer;
        # carried so Programs serialize like the JAX package's
        self.donate = bool(donate)
        # sharding annotation (normalize_sharding form): one entry per
        # dim naming the mesh axis (or axis tuple) that dim is split
        # over, None = replicated.  Inert in this package; carried so
        # Programs serialize like the JAX package's.
        self.sharding = normalize_sharding(sharding)
        # op that produced this var most recently (set by append_op)
        self.op: Optional["Operator"] = None

    # -- sugar used by layers ------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
            "donate": self.donate,
            "sharding": (None if self.sharding is None
                         else [list(e) if isinstance(e, tuple) else e
                               for e in self.sharding]),
        }

    def __repr__(self):
        return (
            f"Var({self.name}, shape={self.shape}, dtype={self.dtype}, "
            f"type={self.type}{', persistable' if self.persistable else ''})"
        )


class Parameter(Variable):
    """A persistable, trainable Variable (reference framework.py:988)."""

    def __init__(self, block, name, shape, dtype, **kw):
        self.trainable = kw.pop("trainable", True)
        self.optimize_attr = kw.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kw.pop("regularizer", None)
        self.gradient_clip_attr = kw.pop("gradient_clip_attr", None)
        self.do_model_average = kw.pop("do_model_average", None)
        # [{"type": "pruning", "sparsity_ratio": r}, ...] — reference
        # ParameterUpdaterHook.cpp (ParameterConfig.update_hooks)
        self.update_hooks = kw.pop("update_hooks", None)
        super().__init__(
            block, name, shape=shape, dtype=dtype, persistable=True, **kw
        )


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


def _as_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


class Operator:
    """An op desc: type + named input/output var lists + attrs.

    Reference framework.py:362 / framework.proto:104 (OpDesc).  Attrs may hold
    python scalars, lists, strings, numpy arrays, or Block indices (for
    control-flow sub-blocks, stored as {"__block__": idx}).
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            k: _as_name_list(v) for k, v in (inputs or {}).items()
        }
        self.outputs: Dict[str, List[str]] = {
            k: _as_name_list(v) for k, v in (outputs or {}).items()
        }
        self.attrs: Dict = dict(attrs or {})
        stage = current_pipeline_stage()
        if stage is not None:
            self.attrs.setdefault("pipeline_stage", stage)

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def dist_attr(self) -> Dict:
        """Distributed attributes of this op desc — a plain dict rider
        under attrs["dist_attr"] (so it serializes through
        to_dict/from_dict with every other attr).  Reading never inserts
        the attr (op descs stay fingerprint-stable); write through
        set_dist_attr."""
        return self.attrs.get("dist_attr", {})

    def set_dist_attr(self, key: str, value) -> None:
        self.attrs.setdefault("dist_attr", {})[key] = value

    def sub_block(self, attr_name="sub_block") -> Optional["Block"]:
        ref = self.attrs.get(attr_name)
        if ref is None:
            return None
        idx = ref["__block__"] if isinstance(ref, dict) else int(ref)
        return self.block.program.blocks[idx]

    def to_dict(self):
        def enc_attr(v):
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v

        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: enc_attr(v) for k, v in self.attrs.items()},
        }

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs})}}"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    """A straight-line list of ops + a var table (reference framework.py:630)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- vars ---------------------------------------------------------------
    def create_var(self, name=None, **kw) -> Variable:
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            existing = self.vars[name]
            # a second create_var for the same name used to silently hand
            # back the existing var even when the caller asked for a
            # DIFFERENT shape/dtype — the caller then builds ops against
            # a type it never gets.  Explicitly conflicting kwargs raise.
            conflicts = []
            shape = kw.get("shape")
            if (shape is not None and existing.shape is not None
                    and tuple(int(s) for s in shape) != existing.shape):
                conflicts.append(
                    f"shape {list(shape)} vs existing "
                    f"{list(existing.shape)}")
            dtype = kw.get("dtype")
            if dtype is not None and existing.dtype is not None:
                if canonical_dtype(dtype) != existing.dtype:
                    conflicts.append(
                        f"dtype {dtype} vs existing {existing.dtype}")
            if conflicts:
                raise ValueError(
                    f"create_var({name!r}) collides with an existing "
                    f"variable in block {self.idx}: "
                    + "; ".join(conflicts)
                    + " — use a unique name (unique_name) or match the "
                    "existing declaration")
            return existing
        v = Variable(self, name, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype, **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        """Find var in this block or ancestors (scope-style lookup)."""
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"variable '{name}' not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self._post_insert(op)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self._post_insert(op)
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self._post_insert(op)
        return op

    def _post_insert(self, op: Operator):
        self.program.bump_version()
        # auto-create missing output vars (backward/transpiler convenience)
        for n in op.output_names():
            if n not in ("", "@EMPTY@") and not self.has_var(n):
                self.create_var(name=n, dtype=None)
        # record producer + run build-time shape inference when available
        info = None
        try:
            info = registry.get_op_info(op.type)
        except KeyError:
            pass
        if info is not None:
            from . import shape_inference

            try:
                if info.infer_shape is not None and info.type == op.type:
                    info.infer_shape(op, self)
                elif op.type.endswith("_grad"):
                    shape_inference.infer_grad_shapes(op, self)
                else:
                    shape_inference.default_infer_shape(op, self)
            except KeyError:
                pass  # vars created later (e.g. grad rewrites fill them in)
        for n in op.output_names():
            if n in self.vars:
                self.vars[n].op = op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    """A list of Blocks; block 0 is global (reference framework.py:827)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.seed = 0  # program-level RNG seed (0 = derive from executor)
        # declared device-mesh axes ({name: size}) for the sharding
        # annotations on this program's vars
        self.mesh_axes: Optional[Dict[str, int]] = None
        self._version = 0  # bumped on mutation -> invalidates compile cache

    # -- block management ---------------------------------------------------
    @property
    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def global_block(self) -> Block:
        return self.blocks[0]

    def create_block(self, parent_idx=None) -> Block:
        parent_idx = (
            self._current_block_idx if parent_idx is None else parent_idx
        )
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self):
        self._current_block_idx = self.current_block.parent_idx

    @contextlib.contextmanager
    def block_guard(self, block: Block):
        prev = self._current_block_idx
        self._current_block_idx = block.idx
        try:
            yield block
        finally:
            self._current_block_idx = prev

    # -- mutation tracking ---------------------------------------------------
    def bump_version(self):
        self._version += 1

    def fingerprint(self) -> str:
        """Stable hash of the whole program for compile-cache keys."""
        payload = json.dumps(self.to_dict(), sort_keys=True, default=str)
        import hashlib

        return hashlib.sha1(payload.encode()).hexdigest()

    # -- static analysis -----------------------------------------------------
    def verify(self, level: Optional[str] = "error", passes=None,
               feed_names=None, fetch_names=None):
        """Run the static analyzer (paddle_tpu_torch.analysis) over this
        program and return every Diagnostic.

        `level`: raise ProgramVerificationError when any diagnostic is
        at or above this severity ("error" default; "warn"/"warning",
        "info"); None or "off" never raises — inspect the returned list.
        `passes`: restrict to specific pass ids (docs/analysis.md).
        `feed_names`/`fetch_names`: optional runtime context that
        sharpens the def-before-use and dead-op passes.
        """
        from ..analysis import verify_program

        return verify_program(self, level=level, passes=passes,
                              feed_names=feed_names,
                              fetch_names=fetch_names)

    # -- clone / serialization ----------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program.  `for_test=True` flips is_test attrs
        (dropout/batch_norm switch to inference behavior), mirroring
        reference framework.py Program.clone."""
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in _op_declared_attrs(op.type):
                        op.attrs["is_test"] = True
        p.bump_version()
        return p

    def to_dict(self):
        d = {"blocks": [b.to_dict() for b in self.blocks],
             "seed": self.seed}
        if self.mesh_axes is not None:
            d["mesh_axes"] = dict(self.mesh_axes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Program":
        """Reconstruct a Program from `to_dict()` output — the deserialization
        half of the model format (reference: ProgramDesc parsed back from the
        `__model__` protobuf in inference/io.cc:?Load; here the schema is
        JSON, framework.py to_dict)."""
        p = cls()
        p.seed = d.get("seed", 0)
        ma = d.get("mesh_axes")
        p.mesh_axes = ({str(k): int(v) for k, v in ma.items()}
                       if ma is not None else None)
        # materialize blocks first so sub_block attr refs resolve
        for bd in d["blocks"][1:]:
            b = Block(p, bd["idx"], bd.get("parent_idx", -1))
            p.blocks.append(b)
        for bd in d["blocks"]:
            b = p.blocks[bd["idx"]]
            for vd in bd.get("vars", []):
                kw = dict(
                    shape=vd.get("shape"),
                    dtype=vd.get("dtype"),
                    lod_level=vd.get("lod_level", 0),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    type=vd.get("type", VarType.LOD_TENSOR),
                    donate=vd.get("donate", False),
                    sharding=vd.get("sharding"),
                )
                if vd.get("is_parameter"):
                    kw.pop("persistable")
                    v = Parameter(b, vd["name"], kw.pop("shape"),
                                  kw.pop("dtype"),
                                  trainable=vd.get("trainable", True), **kw)
                else:
                    v = Variable(b, vd["name"], **kw)
                b.vars[vd["name"]] = v
            for od in bd.get("ops", []):
                attrs = {
                    k: _dec_attr(v) for k, v in od.get("attrs", {}).items()
                }
                op = Operator(b, od["type"], od.get("inputs"),
                              od.get("outputs"), attrs)
                b.ops.append(op)
                for n in op.output_names():
                    if n in b.vars:
                        b.vars[n].op = op
        p._current_block_idx = 0
        p.bump_version()
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"-- block {b.idx} (parent {b.parent_idx}) --")
            lines.extend(f"  {op}" for op in b.ops)
        return "\n".join(lines)

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()


def _dec_attr(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=np.dtype(v["dtype"]))
    return v


def _op_declared_attrs(type):
    try:
        return registry.get_op_info(type).attrs
    except KeyError:
        return {}


# ---------------------------------------------------------------------------
# default programs + guards (reference framework.py:1046-1120)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, p
    return prev


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, p
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
