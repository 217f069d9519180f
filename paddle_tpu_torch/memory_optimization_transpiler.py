"""Memory-optimization transpiler: the whole-program memory layer
(counterpart of paddle_tpu/memory_optimization_transpiler.py, the same
rules; the port keeps its own copy).

  * `memory_optimize` — the liveness-based rename pass: each newly
    defined temporary is renamed onto a dead variable of the same shape
    and dtype, so consecutive ops reuse names instead of growing the
    scope (the interpreted and segmented modes under the
    `memory_optimize` flag).
  * `plan_donation` — which feed and state buffers of a step die inside
    it, and every unsafe `donate=True` request (a fetched variable, a
    read-only state, a variable nothing reads) refused at build time
    with a `DonationError`.
  * `plan_dead_frees` — per op index, the names whose last use has
    passed, so the interpreted and segmented modes drop them from the
    local scope mid-run.

Protected everywhere: fetch targets, persistables and Parameters, and
every name a sub-block references (a sub-block resolves names against
its parent's values at run time).  Reuse needs the exact shape and
dtype (level 0).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

from .core.framework import Parameter, Program

__all__ = ["ControlFlowGraph", "memory_optimize", "DonationPlan",
           "DonationError", "plan_donation", "plan_dead_frees",
           "dead_frees"]


class DonationError(ValueError):
    """A requested buffer donation is provably unsafe (the buffer is
    needed after the step).  Raised at plan/build time — before any
    op runs — so the failure names the variable and the reason instead
    of surfacing as a clobbered value mid-train."""


class ControlFlowGraph:
    """Def/use + liveness over one straight-line block (reference :33).

    live_out[i] = union of live_in of successors (straight line: i+1);
    live_in[i]  = use[i] | (live_out[i] - def[i]).
    """

    def __init__(self, ops):
        self.ops = list(ops)
        n = len(self.ops)
        self.uses: List[Set[str]] = [set() for _ in range(n)]
        self.defs: List[Set[str]] = [set() for _ in range(n)]
        for i, op in enumerate(self.ops):
            for names in op.inputs.values():
                self.uses[i].update(n_ for n_ in names if n_)
            for names in op.outputs.values():
                self.defs[i].update(n_ for n_ in names if n_)
        self.live_in: List[Set[str]] = [set() for _ in range(n)]
        self.live_out: List[Set[str]] = [set() for _ in range(n)]
        self._dataflow()

    def _dataflow(self):
        for i in range(len(self.ops) - 1, -1, -1):
            self.live_out[i] = (set(self.live_in[i + 1])
                                if i + 1 < len(self.ops) else set())
            self.live_in[i] = self.uses[i] | (self.live_out[i]
                                              - self.defs[i])

    def last_touch(self) -> Dict[str, int]:
        """name -> index of the op that last reads OR writes it; past
        that index the name's buffer is finished."""
        return _last_touch(self.ops)


def _last_touch(ops) -> Dict[str, int]:
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        uses: Set[str] = set()
        defs: Set[str] = set()
        for names in op.inputs.values():
            uses.update(n for n in names if n)
        for names in op.outputs.values():
            defs.update(n for n in names if n)
        for name in uses | defs:
            last[name] = i
    return last


def _sub_block_names(program: Program) -> Set[str]:
    """All names referenced anywhere in non-global blocks: sub-blocks
    resolve names against the parent scope, so renaming/freeing them
    out from under a sub-block is unsafe."""
    names: Set[str] = set()
    for block in program.blocks[1:]:
        names.update(block.vars.keys())
        for op in block.ops:
            for ns in op.inputs.values():
                names.update(ns)
            for ns in op.outputs.values():
                names.update(ns)
    return names


def _normalize_names(vars_or_names) -> List[str]:
    """Uniform skip/fetch list handling: accepts a bare name, a bare
    Variable, or any mix of both inside an iterable."""
    if vars_or_names is None:
        return []
    if isinstance(vars_or_names, str) or not hasattr(vars_or_names,
                                                     "__iter__"):
        vars_or_names = [vars_or_names]  # bare name/Variable
    return [v if isinstance(v, str) else v.name for v in vars_or_names]


# ---------------------------------------------------------------------------
# donation planning
# ---------------------------------------------------------------------------


class DonationPlan:
    """Result of `plan_donation`: which buffers of one step die inside
    it, so the step may reuse their memory.

    `feeds`  — feed names whose last use is inside the step (not fetched,
               actually consumed): their device buffers are dead once the
               step returns.
    `states` — read-write persistable names: the step returns the NEW
               value, so the OLD buffer is dead (the in-place parameter
               update the reference gets via Param->ParamOut aliasing).
    `rejected` — {name: reason} for every REQUESTED donation that is
               provably unsafe; `check()` raises DonationError on any.
    """

    def __init__(self, feeds: Iterable[str], states: Iterable[str],
                 rejected: Optional[Dict[str, str]] = None):
        self.feeds = frozenset(feeds)
        self.states = frozenset(states)
        self.rejected = dict(rejected or {})

    def check(self):
        """Raise DonationError if any explicitly requested donation was
        rejected (build-time failure, never a runtime crash)."""
        if self.rejected:
            detail = "; ".join(f"{n!r}: {r}"
                               for n, r in sorted(self.rejected.items()))
            raise DonationError(
                f"unsafe buffer donation(s) rejected at build time — "
                f"{detail}.  Remove the donate hint, or stop using the "
                "buffer after the step (drop it from fetch_list)")
        return self

    def __repr__(self):
        return (f"DonationPlan(feeds={sorted(self.feeds)}, "
                f"states={sorted(self.states)}, "
                f"rejected={self.rejected})")


def plan_donation(program: Program,
                  feed_names: Iterable[str],
                  fetch_names: Iterable[str] = (),
                  state_rw_names: Iterable[str] = (),
                  requested: Iterable[str] = ()) -> DonationPlan:
    """Derive the per-program donation plan from liveness.

    A buffer is donatable when its last use is inside the step:
      * a feed var that some op consumes and that is NOT a fetch target
        (a fetched feed must survive the call — its buffer is the
        return value the caller reads);
      * a read-write state (`state_rw_names`, from
        `Executor._analyze_states`): the step returns the updated
        value, so the pre-step buffer dies with the call.

    `requested` names (explicit `donate=True` hints on variables) are
    validated strictly: a request for a fetched var, a read-only
    persistable, a Parameter that is never rewritten, or a var the
    program never consumes lands in `plan.rejected` — call
    `plan.check()` to turn that into a build-time DonationError.
    """
    feed_names = set(_normalize_names(feed_names))
    fetch_names = set(_normalize_names(fetch_names))
    state_rw = set(_normalize_names(state_rw_names))
    requested = _normalize_names(requested)

    block = program.global_block()
    consumed: Set[str] = set()
    for blk in program.blocks:
        for op in blk.ops:
            for ns in op.inputs.values():
                consumed.update(ns)

    feeds = {n for n in feed_names
             if n in consumed and n not in fetch_names}
    states = set(state_rw)  # old buffer dead once the new value returns

    rejected: Dict[str, str] = {}
    for n in requested:
        if n in feeds or n in states:
            continue
        if n in fetch_names:
            rejected[n] = ("fetched after the step — the caller reads "
                           "this buffer once the executable returns")
            continue
        v = block.vars.get(n)
        if v is not None and (isinstance(v, Parameter)
                              or getattr(v, "persistable", False)):
            rejected[n] = ("read-only persistable state — the next step "
                           "reads the same buffer again")
            continue
        if n not in consumed:
            rejected[n] = ("never consumed by the program — the "
                           "donation could not be fulfilled")
            continue
        rejected[n] = "not provably dead inside the step"
    return DonationPlan(feeds, states, rejected)


# ---------------------------------------------------------------------------
# dead-variable freeing
# ---------------------------------------------------------------------------


def plan_dead_frees(program: Program,
                    fetch_names: Iterable[str] = ()) -> Dict[int, List[str]]:
    """{op index -> [names]} safe to drop from the local scope right
    after that op runs: the liveness pass proves nothing later reads
    them.  Protected: fetch targets (read after the last op),
    persistables/Parameters (scope-carried state), and any name
    referenced from a sub-block (resolved dynamically against the
    parent scope).  Consumed by the interpreter and segmented executor
    paths so scope footprint tracks LIVE values, not program size."""
    protected = set(_normalize_names(fetch_names)) | _sub_block_names(program)
    for v in program.list_vars():
        if v.persistable or isinstance(v, Parameter):
            protected.add(v.name)
    return dead_frees(program.global_block().ops, protected)


def dead_frees(ops, protected) -> Dict[int, List[str]]:
    """{op index -> [names]} whose last read or write is that op, less
    the names in `protected` (the one rule behind `plan_dead_frees` and
    the compiled mode's frees inside a run of ops)."""
    frees: Dict[int, List[str]] = {}
    for name, idx in _last_touch(ops).items():
        if name not in protected:
            frees.setdefault(idx, []).append(name)
    return frees


# ---------------------------------------------------------------------------
# liveness-based rename (buffer reuse for the interpreter path)
# ---------------------------------------------------------------------------


def memory_optimize(program: Program,
                    skip_vars: Optional[Sequence] = None,
                    level: int = 0) -> int:
    """Rewrite `program` in place so dead temporaries are reused; returns
    the number of variables eliminated.

    skip_vars: names or Variables (any mix) never to optimize — pass
    everything you intend to fetch after the final op (same contract as
    the reference: fetch targets must survive to the end of the run).
    When the executor invokes this pass itself (`memory_optimize` flag),
    it passes the current feed and fetch lists automatically.
    level=0 requires exact shape+dtype match for reuse (reference
    memory_optimization_transpiler.py level semantics).
    """
    del level  # only exact-match (level 0) reuse is implemented
    block = program.global_block()
    skip: Set[str] = set(_normalize_names(skip_vars))
    skip |= _sub_block_names(program)

    cfg = ControlFlowGraph(block.ops)

    # a name's buffer is finished once past its last def AND last use
    last_touch = cfg.last_touch()
    defined: Set[str] = set()
    for d in cfg.defs:
        defined |= d

    def eligible(name: str) -> bool:
        if name in skip or name not in defined or not block.has_var(name):
            return False
        v = block.var(name)
        if isinstance(v, Parameter) or getattr(v, "persistable", False):
            return False
        if v.shape is None or v.dtype is None:
            return False
        return True

    def key_of(name):
        v = block.var(name)
        return tuple(v.shape), str(v.dtype)

    pool: List[str] = []          # finished var names, buffers reusable
    rename: Dict[str, str] = {}   # original name -> reused name
    eliminated = 0

    for i, op in enumerate(cfg.ops):
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(nm, nm) for nm in names]

        for slot, names in op.outputs.items():
            out = []
            for name in names:
                if name in rename:
                    out.append(rename[name])
                    continue
                if eligible(name):
                    for cand in pool:
                        if key_of(cand) == key_of(name):
                            pool.remove(cand)
                            rename[name] = cand
                            block.vars.pop(name, None)
                            eliminated += 1
                            name = cand
                            break
                out.append(name)
            op.outputs[slot] = out

        # buffers finished at this op become reusable for later ops (for a
        # renamed var the reuse target carries the buffer, so check THAT)
        for name in cfg.uses[i] | cfg.defs[i]:
            if last_touch.get(name) != i:
                continue
            cur = rename.get(name, name)
            if eligible(cur) and cur not in pool:
                pool.append(cur)

    program.bump_version()
    return eliminated
