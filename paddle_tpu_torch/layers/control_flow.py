"""Control-flow DSL: While, StaticRNN, DynamicRNN, IfElse, Switch,
ConditionalBlock, ParallelDo, tensor arrays, LoD rank tables and the
beam-search wiring (counterpart of paddle_tpu/layers/control_flow.py).

The same public API and the same Programs as the JAX package: the
recurrent constructs build one `dynamic_rnn` op over a step sub-block
(ops/control_flow.py), and `While` is the host-interpreted loop of the
decoders (beam search).  `less_than` and `equal` (with the in-place
`cond` idiom of While loops) shadow the generated wrappers of
layers/ops.py in `fluid.layers`, as in the JAX package.  `recompute`
builds a rematerialised segment (the `recompute` op).
"""
from __future__ import annotations

import contextlib

from ..core.framework import Variable, unique_name
from ..core.types import VarType, is_float_dtype
from ..layer_helper import LayerHelper
from .tensor import increment  # noqa: F401  (layers.increment, as there)

__all__ = [
    "While",
    "Switch",
    "ConditionalBlock",
    "Print",
    "StaticRNN",
    "DynamicRNN",
    "IfElse",
    "ParallelDo",
    "get_places",
    "split_lod_tensor",
    "merge_lod_tensor",
    "less_than",
    "equal",
    "increment",
    "array_write",
    "array_read",
    "array_length",
    "create_array",
    "lod_rank_table",
    "max_sequence_len",
    "lod_tensor_to_array",
    "array_to_lod_tensor",
    "shrink_memory",
    "reorder_lod_tensor_by_rank",
    "beam_search",
    "beam_search_decode",
    "recompute",
]


def _compare(op_type, x, y, cond):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_tmp_variable("bool")
        cond.stop_gradient = True
    helper.append_op(op_type, {"X": [x.name], "Y": [y.name]},
                     {"Out": [cond.name]})
    return cond


def less_than(x, y, cond=None, **ignored):
    """x < y elementwise; written into `cond` when given."""
    return _compare("less_than", x, y, cond)


def equal(x, y, cond=None, **ignored):
    """x == y elementwise; written into `cond` when given."""
    return _compare("equal", x, y, cond)


# -- tensor arrays -------------------------------------------------------------


def create_array(dtype):
    helper = LayerHelper("array")
    return helper.block.create_var(
        name=unique_name("array"), dtype=dtype,
        type=VarType.LOD_TENSOR_ARRAY)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    if array.shape is None:
        array.shape = x.shape   # the element shape, for later layers
    helper.append_op("write_to_array", {"X": [x.name], "I": [i.name]},
                     {"Out": [array.name]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype)
    out.shape = array.shape
    helper.append_op("read_from_array", {"X": [array.name], "I": [i.name]},
                     {"Out": [out.name]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64")
    out.stop_gradient = True
    helper.append_op("lod_array_length", {"X": [array.name]},
                     {"Out": [out.name]})
    return out


# -- LoD rank tables -------------------------------------------------------------


def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table")
    table = helper.block.create_var(
        name=unique_name("lod_rank_table"), dtype=None,
        type=VarType.LOD_RANK_TABLE)
    helper.append_op("lod_rank_table", {"X": [x.name]},
                     {"Out": [table.name]}, {"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_len")   # sic, the reference's name
    out = helper.create_tmp_variable("int64", stop_gradient=True)
    helper.append_op("max_sequence_len", {"RankTable": [rank_table.name]},
                     {"Out": [out.name]})
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.block.create_var(
        name=unique_name("lod_tensor_to_array"), dtype=x.dtype,
        type=VarType.LOD_TENSOR_ARRAY)
    helper.append_op("lod_tensor_to_array",
                     {"X": [x.name], "RankTable": [table.name]},
                     {"Out": [array.name]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("array_to_lod_tensor",
                     {"X": [x.name], "RankTable": [table.name]},
                     {"Out": [out.name]})
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("shrink_rnn_memory",
                     {"X": [x.name], "I": [i.name],
                      "RankTable": [table.name]},
                     {"Out": [out.name]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("reorder_lod_tensor_by_rank",
                     {"X": [x.name], "RankTable": [rank_table.name]},
                     {"Out": [out.name]})
    return out


# -- beam search -----------------------------------------------------------------


def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0):
    """One beam-search step -> (selected_ids, selected_scores), both with
    a 2-level LoD."""
    helper = LayerHelper("beam_search")
    selected_ids = helper.create_tmp_variable("int64", stop_gradient=True)
    selected_scores = helper.create_tmp_variable("float32",
                                                 stop_gradient=True)
    selected_ids.lod_level = selected_scores.lod_level = 2
    helper.append_op(
        "beam_search",
        {"pre_ids": [pre_ids.name], "ids": [ids.name],
         "scores": [scores.name]},
        {"selected_ids": [selected_ids.name],
         "selected_scores": [selected_scores.name]},
        {"level": int(level), "beam_size": int(beam_size),
         "end_id": int(end_id)})
    return selected_ids, selected_scores


def beam_search_decode(ids, scores):
    """The per-step id and score arrays back-tracked into sentences."""
    helper = LayerHelper("beam_search_decode")
    sentence_ids = helper.create_tmp_variable("int64", stop_gradient=True)
    sentence_scores = helper.create_tmp_variable("float32",
                                                 stop_gradient=True)
    sentence_ids.lod_level = sentence_scores.lod_level = 2
    helper.append_op(
        "beam_search_decode",
        {"Ids": [ids.name], "Scores": [scores.name]},
        {"SentenceIds": [sentence_ids.name],
         "SentenceScores": [sentence_scores.name]})
    return sentence_ids, sentence_scores


# -- places and ParallelDo -------------------------------------------------------


def get_places(device_count=None, device_type=None):
    """The places a ParallelDo spans: every CUDA device of this host, or
    `[CPUPlace()]` on a host without one (a Program built there runs on
    whichever place its Executor is given).  A built Program records only
    their number; the `get_places` op gives the executing device's."""
    import torch

    from ..core.executor import CPUPlace, CUDAPlace

    del device_type     # one device kind a process
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    places = [CUDAPlace(i) for i in range(n)] or [CPUPlace()]
    return places[:device_count] if device_count else places


def _sub_block_reads(sub, parent):
    """The parent-block names the sub-block's ops read, in first-read
    order."""
    local = set(sub.vars.keys())
    captured = []
    for op in sub.ops:
        for n in op.input_names():
            if n in ("", "@EMPTY@") or n in local or n in captured:
                continue
            if parent.has_var(n):
                captured.append(n)
    return captured


def _split_captured(sub, parent):
    """(float captured names -> Captured, the rest -> CapturedNoGrad)."""
    cap_f, cap_i = [], []
    for n in _sub_block_reads(sub, parent):
        v = parent.var(n)
        (cap_f if v.dtype is not None and is_float_dtype(v.dtype)
         else cap_i).append(n)
    return cap_f, cap_i


class ParallelDo:
    """Data parallelism over a block (the reference ParallelDo): one
    `parallel_do` op over the sub-block, run over the whole batch on the
    Executor's device, so its results equal the serial run's.

        places = layers.get_places()
        pd = layers.ParallelDo(places)
        with pd.do():
            x_ = pd.read_input(x)
            pd.write_output(layers.fc(input=x_, size=n))
        out = pd()
    """

    def __init__(self, places, use_nccl=False, name=None):
        self.helper = LayerHelper("parallel_do", name=name)
        self.places = list(places)
        self.use_nccl = use_nccl
        self.sub = self.parent = self._result_vars = None
        self._inputs = []    # (parent var, placeholder)
        self._outputs = []   # sub-block vars
        self._finalized = False

    @contextlib.contextmanager
    def do(self):
        with _sub_block(self.helper) as (self.parent, self.sub):
            yield
        self._finalize()

    def read_input(self, var):
        assert self.sub is not None, "read_input must be called in do()"
        ph = self.sub.create_var(name=unique_name("pdo_in"), shape=var.shape,
                                 dtype=var.dtype)
        self._inputs.append((var, ph))
        return ph

    def write_output(self, var):
        self._outputs.append(var)

    def __call__(self):
        assert self._finalized, "use `with pd.do():` before pd()"
        if len(self._result_vars) == 1:
            return self._result_vars[0]
        return list(self._result_vars)

    def _finalize(self):
        assert self._outputs, "parallel_do block must write_output"
        cap_f, cap_i = _split_captured(self.sub, self.parent)
        out_vars = [self.parent.create_var(name=unique_name("pdo_out"),
                                           shape=ov.shape, dtype=ov.dtype)
                    for ov in self._outputs]
        self.parent.append_op(
            "parallel_do",
            {"Inputs": [x.name for x, _ in self._inputs],
             "Captured": cap_f, "CapturedNoGrad": cap_i},
            {"Outs": [v.name for v in out_vars]},
            {"sub_block": {"__block__": self.sub.idx},
             "use_nccl": self.use_nccl,
             "num_places": len(self.places),
             "input_names": [p.name for _, p in self._inputs],
             "output_names": [v.name for v in self._outputs]})
        self._result_vars = out_vars
        self._finalized = True


# -- IfElse ----------------------------------------------------------------------


def split_lod_tensor(input, mask, level=0):
    """`input`'s rows (or level-`level` sequences) split into the true
    and false branches of the bool column `mask`."""
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_tmp_variable(dtype=input.dtype)
    out_false = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        "split_lod_tensor", {"X": [input.name], "Mask": [mask.name]},
        {"OutTrue": [out_true.name], "OutFalse": [out_false.name]},
        {"level": level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """The inverse of split_lod_tensor: the branches interleaved back
    into `x`'s row order."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_tmp_variable(dtype=in_true.dtype)
    helper.append_op(
        "merge_lod_tensor",
        {"X": [x.name], "Mask": [mask.name],
         "InTrue": [in_true.name], "InFalse": [in_false.name]},
        {"Out": [out.name]}, {"level": level})
    return out


class IfElse:
    """A batch-row conditional: the rows where `cond` is true flow
    through the true block, the others through the false block, and the
    outputs are merged back into batch order.  As in the JAX package the
    branch ops go into the current block, on the split rows (a branch
    with no row computes on 0-row tensors), so the construct is
    differentiable through the split and merge gradients."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = ([], [])  # (false_outs, true_outs)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside a block")
        if id(x) not in self.input_table:
            self.input_table[id(x)] = split_lod_tensor(x, self.cond)
        out_true, out_false = self.input_table[id(x)]
        return (out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
                else out_false)

    @contextlib.contextmanager
    def _block(self, is_true):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("cannot nest IfElse blocks")
        self.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if is_true
                       else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
        try:
            yield
        finally:
            self.status = IfElse.OUT_IF_ELSE_BLOCKS
        if len(self.output_table[1 if is_true else 0]) == 0:
            raise ValueError("must call output() inside the block")

    def true_block(self):
        return self._block(True)

    def false_block(self):
        return self._block(False)

    def output(self, *outs):
        if self.status == self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() can only be called inside a block")
        from .tensor import assign

        table = self.output_table[
            1 if self.status == self.IN_IF_ELSE_TRUE_BLOCKS else 0]
        for each in outs:
            if not isinstance(each, Variable):
                raise TypeError("each output must be a Variable")
            table.append(assign(each))

    def __call__(self):
        if self.status != self.OUT_IF_ELSE_BLOCKS:
            raise ValueError("__call__ must be outside the blocks")
        false_len, true_len = map(len, self.output_table)
        if false_len == 0 and true_len == 0:
            raise ValueError("must call true_block/false_block before "
                             "__call__")
        if false_len != true_len and false_len != 0 and true_len != 0:
            raise ValueError("true/false blocks must set the same number "
                             "of outputs")
        if false_len == 0 or true_len == 0:
            return self.output_table[0 if false_len != 0 else 1]
        return [merge_lod_tensor(in_true=t, in_false=f, x=self.cond,
                                 mask=self.cond)
                for f, t in zip(*self.output_table)]


# -- While, ConditionalBlock, Switch -------------------------------------------------


@contextlib.contextmanager
def _sub_block(helper):
    """-> (parent, sub): a new block of the main program, current inside
    the `with`."""
    program = helper.main_program
    parent = program.current_block
    sub = program.create_block()
    try:
        yield parent, sub
    finally:
        program.rollback()


class While:
    """A host-interpreted loop over a sub-block (the reference
    layers.While / while_op.cc), run while `cond` is true.  The body
    runs in the surrounding variable environment, so condition updates
    and array writes persist."""

    def __init__(self, cond, name=None):
        if cond.dtype not in ("bool",):
            raise TypeError("While condition must be a bool variable")
        self.cond = cond
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        with _sub_block(self.helper) as (parent, sub):
            yield
        parent.append_op("while", {"Condition": [self.cond.name], "X": []},
                         {"Out": []}, {"sub_block": {"__block__": sub.idx}})


class ConditionalBlock:
    """The conditional_block op (the reference ConditionalBlock): the
    block runs iff every input is true (scalar) or non-empty."""

    def __init__(self, inputs, name=None, is_scalar_condition=False):
        self.inputs = list(inputs)
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        with _sub_block(self.helper) as (parent, sub):
            yield
        parent.append_op(
            "conditional_block",
            {"X": [v.name for v in self.inputs], "Params": []}, {"Out": []},
            {"sub_block": {"__block__": sub.idx},
             "is_scalar_condition": self.is_scalar_condition})


class Switch:
    """A scalar-condition case chain: the FIRST case whose condition is
    true runs; default() runs when none did.

        with Switch() as switch:
            with switch.case(cond1): ...
            with switch.case(cond2): ...
            with switch.default(): ...
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []
        self.inside = False

    @contextlib.contextmanager
    def case(self, condition):
        if not self.inside:
            raise ValueError("case() must be inside `with Switch()`")
        from .ops import logical_and, logical_not

        if self.pre_not_conditions:
            cond = logical_and(x=self.pre_not_conditions[-1], y=condition)
        else:
            cond = condition
        not_cond = logical_not(x=condition)
        if self.pre_not_conditions:
            not_cond = logical_and(x=self.pre_not_conditions[-1],
                                   y=not_cond)
        self.pre_not_conditions.append(not_cond)
        with ConditionalBlock([cond], is_scalar_condition=True).block():
            yield

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise ValueError("default() requires at least one case()")
        with ConditionalBlock([self.pre_not_conditions[-1]],
                              is_scalar_condition=True).block():
            yield

    def __enter__(self):
        self.inside = True
        return self

    def __exit__(self, *a):
        self.inside = False
        return False


# -- the recurrences: StaticRNN and DynamicRNN both build `dynamic_rnn` ------------


class _RNNBase:
    _is_dynamic = True

    def __init__(self, name=None):
        self.helper = LayerHelper(
            "dynamic_rnn" if self._is_dynamic else "static_rnn", name=name)
        self.sub = self.parent = self._result_vars = None
        self._step_inputs = []     # (parent var, placeholder)
        self._static_inputs = []   # (parent var, placeholder)
        self._memories = []        # dicts: ph, init_var, init, shape, ...
        self._mem_updates = {}     # placeholder name -> update var name
        self._outputs = []         # sub-block vars
        self._finalized = False

    @contextlib.contextmanager
    def block(self):
        with _sub_block(self.helper) as (self.parent, self.sub):
            yield
        self._finalize()    # on a clean exit only: keep a body's error

    def step_input(self, x):
        assert self.sub is not None, "step_input must be called in block()"
        # dynamic: a step sees [B, ...feature]; static: axis 0 is time
        ph_shape = ((-1,) + tuple(x.shape[1:]) if self._is_dynamic
                    else tuple(x.shape[1:]))
        ph = self.sub.create_var(name=unique_name("rnn_step_in"),
                                 shape=ph_shape, dtype=x.dtype)
        self._step_inputs.append((x, ph))
        return ph

    def static_input(self, x):
        ph = self.sub.create_var(name=unique_name("rnn_static_in"),
                                 shape=x.shape, dtype=x.dtype)
        self._static_inputs.append((x, ph))
        return ph

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False, batch_ref=None, init_value=None,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        if init is not None:
            ph = self.sub.create_var(name=unique_name("rnn_mem"),
                                     shape=init.shape, dtype=init.dtype)
            self._memories.append({"ph": ph, "init_var": init, "init": True})
            return ph
        assert shape is not None, "memory needs init= or shape="
        if init_value is not None:
            value = init_value
        # dynamic: the value is [B, ...shape]; static: exactly shape
        mem_shape = ((-1,) + tuple(shape) if self._is_dynamic
                     else tuple(shape))
        ph = self.sub.create_var(name=unique_name("rnn_mem"),
                                 shape=mem_shape, dtype=dtype)
        self._memories.append({
            "ph": ph, "init_var": None, "init": False,
            "shape": [int(s) for s in shape], "value": float(value),
            "dtype": dtype})
        return ph

    def update_memory(self, mem, new):
        self._mem_updates[mem.name] = new.name

    def output(self, *outputs):
        self._outputs.extend(outputs)

    step_output = output

    def __call__(self, *a, **kw):
        assert self._finalized, "use `with rnn.block():` before rnn()"
        if len(self._result_vars) == 1:
            return self._result_vars[0]
        return list(self._result_vars)

    def _finalize(self):
        """One `dynamic_rnn` op: float captured vars go to Captured (the
        generic gradient differentiates them: the step's parameters),
        the others to CapturedNoGrad, with the attrs the op reads."""
        assert self._outputs, "rnn block must declare at least one output"
        assert self._mem_updates.keys() == {
            m["ph"].name for m in self._memories
        }, "every memory needs exactly one update_memory call"
        cap_f, cap_i = _split_captured(self.sub, self.parent)
        mem_specs, init_vars = [], []
        for m in self._memories:
            if m["init"]:
                mem_specs.append({"init": True})
                init_vars.append(m["init_var"].name)
            else:
                mem_specs.append({
                    "init": False, "shape": m["shape"],
                    "value": m["value"], "dtype": m["dtype"],
                    "batch_ref": self._is_dynamic})
        lod_level = (self._step_inputs[0][0].lod_level
                     if self._is_dynamic else 0)
        out_vars = [self.parent.create_var(
            name=unique_name("rnn_out"), shape=ov.shape, dtype=ov.dtype,
            lod_level=lod_level) for ov in self._outputs]
        self.parent.append_op(
            "dynamic_rnn",
            {"StepInputs": [x.name for x, _ in self._step_inputs],
             "InitMemories": init_vars,
             "StaticInputs": [x.name for x, _ in self._static_inputs],
             "Captured": cap_f,
             "CapturedNoGrad": cap_i},
            {"Outs": [v.name for v in out_vars]},
            {"sub_block": {"__block__": self.sub.idx},
             "is_dynamic": self._is_dynamic,
             "step_input_names": [p.name for _, p in self._step_inputs],
             "static_input_names": [p.name for _, p in self._static_inputs],
             "memory_names": [m["ph"].name for m in self._memories],
             "memory_update_names": [
                 self._mem_updates[m["ph"].name] for m in self._memories],
             "memory_specs": mem_specs,
             "output_names": [v.name for v in self._outputs]})
        self._result_vars = out_vars
        self._finalized = True


class DynamicRNN(_RNNBase):
    """A variable-length RNN over LoD step inputs (the reference
    DynamicRNN): one `dynamic_rnn` op, padded and masked."""

    _is_dynamic = True


class StaticRNN(_RNNBase):
    """A fixed-length RNN stepping axis 0 of dense inputs (the reference
    StaticRNN / recurrent_op.cc)."""

    _is_dynamic = False

    @contextlib.contextmanager
    def step(self):
        with self.block():
            yield


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print a tensor when the op runs (the reference print_op.cc); an
    identity otherwise."""
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "print", {"In": [input.name]}, {"Out": [out.name]},
        {"first_n": first_n, "message": message or "",
         "summarize": summarize,
         "print_tensor_name": print_tensor_name,
         "print_tensor_type": print_tensor_type,
         "print_tensor_shape": print_tensor_shape,
         "print_tensor_lod": print_tensor_lod,
         "print_phase": print_phase.upper()})
    return out


def recompute(fn, name=None):
    """Build `fn()`'s layers inside a rematerialised segment: the
    segment's activations are recomputed in the backward instead of
    stored (the `recompute` op, ops/control_flow.py).  `fn` takes no
    arguments, reads enclosing-scope Variables, and returns a Variable
    or a list of them.

        h = fluid.layers.recompute(lambda: big_ffn_stack(x))

    The op reads every outer name the segment references, nested
    sub-blocks included (`X`), and writes the segment's outputs and the
    persistables written inside it (batch norm's running statistics),
    which would otherwise be lost with the segment's env."""
    helper = LayerHelper("recompute", name=name)
    program = helper.main_program
    parent = program.current_block
    sub = program.create_block()
    try:
        result = fn()
    finally:
        program.rollback()
    single = not isinstance(result, (list, tuple))
    out_vars = [result] if single else list(result)
    for v in out_vars:
        if v.name not in sub.vars:
            raise ValueError(
                f"recompute: output {v.name!r} was not produced inside "
                "the segment")

    # read-set: names referenced inside (nested sub-blocks included)
    # but defined outside the segment
    reads, defined = [], set()

    def walk(block):
        defined.update(block.vars)
        for op in block.ops:
            for names in op.inputs.values():
                for n in names:
                    if n not in defined and n not in reads:
                        reads.append(n)
            for names in op.outputs.values():
                defined.update(names)
            for a in op.attrs.values():
                if isinstance(a, dict) and "__block__" in a:
                    walk(program.blocks[a["__block__"]])

    walk(sub)

    outs = []
    for v in out_vars:
        pv = parent.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                               lod_level=getattr(v, "lod_level", 0))
        pv.stop_gradient = v.stop_gradient
        outs.append(pv)
    # persistable writes inside the segment, at any depth, carried out
    # as extra outputs
    result_names = {v.name for v in out_vars}
    state_writes = []

    def collect_state(block):
        for op_ in block.ops:
            for n in op_.output_names():
                try:
                    prog_var = block.var(n)  # ancestor-walking lookup
                except KeyError:
                    continue
                if (prog_var.persistable and n not in result_names
                        and n not in state_writes):
                    state_writes.append(n)
            for a in op_.attrs.values():
                if isinstance(a, dict) and "__block__" in a:
                    collect_state(program.blocks[a["__block__"]])

    collect_state(sub)
    parent.append_op(
        "recompute",
        {"X": reads},
        {"Out": [v.name for v in outs] + state_writes},
        {"sub_block": {"__block__": sub.idx},
         "output_names": [v.name for v in outs] + state_writes})
    return outs[0] if single else outs
