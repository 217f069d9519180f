"""Whole-package AST concurrency analyzer: lock-order / race / hygiene
lint (counterpart of paddle_tpu/analysis/concurrency.py, the same rules,
suppression syntax and socket allowlist).

The threaded runtimes of this package — the serving scheduler
(serving/generation.py), the inference server (serving/), the prefetch
pipeline and the native reader pipeline (reader/), the CSP channels
(concurrency.py), the kernel build lock (kernels/cuda_build.py) — share
the same hand-caught bug classes: lock-order inversions, blocking calls
made with a lock held, attributes shared across threads without their
lock, and thread-lifecycle leaks.  This module finds them as a
SOURCE-level analysis (no imports, no execution — plain `ast`), the
concurrency sibling of the Program-IR passes in passes.py/cost_model.py.
CUDA streams and events (`torch.cuda.Event`, `torch.cuda.Stream`) are
not thread primitives: an event's `wait` orders device work and does
not block the host, so they are never locks, events or waits here.

Rule catalog (docs/analysis.md "Concurrency analysis"):

  ``lock-order``        [error]  the inter-lock acquisition-order graph
      (edge A->B when B is acquired — directly or through an intra-class
      call chain — while A is held) must be acyclic; a cycle is a static
      deadlock.  Nested acquisition of the SAME non-reentrant Lock /
      Condition is a self-deadlock (error when syntactically nested,
      warning when reached through a call chain, which may be guarded by
      state the analysis cannot see).
  ``blocking-under-lock`` [error]  no blocking call while holding a
      lock: raw socket send*/recv* and the pserver frame helpers (the
      old tools/lint.py rule 4, which now delegates here), plus
      `Thread.join`, blocking `Queue.get/put`, `subprocess` calls,
      `time.sleep`, and waiting on a Condition/Event OTHER than the one
      (sole lock) being held — one stalled peer convoys every thread
      behind the lock, and waiting on B while holding A is the classic
      lost-wakeup/deadlock shape.  The per-endpoint worker pattern
      (`*conn_lock`/`*ep_lock`/`*endpoint_lock` names) stays allowlisted
      for the socket family, exactly as rule 4 had it.
  ``unguarded-attr``    [warning]  RacerD-style ownership inference: an
      instance attribute WRITTEN under a lock in one method but accessed
      with no lock in a method reachable from a different thread
      entrypoint is a data race candidate.  Plain bool/None flag writes
      (`self._stop = True`) demote to info — the CPython store is
      atomic and the pattern is idiomatic for cooperative shutdown.
  ``thread-join``       [error]  a non-daemon `threading.Thread` that is
      never `.join()`ed anywhere in its file keeps the process alive
      after main exits.
  ``thread-start-order`` [error]  `self.<t>.start()` before an
      attribute the thread's target reads is first assigned (in the
      same function body): the thread can observe the attribute missing.

Suppression convention (mirrors lint rule 4): put
``# lint: <rule>-ok`` — e.g. ``# lint: lock-order-ok`` or
``# lint: blocking-under-lock-ok`` — with a rationale on the flagged
line or on the `with` line whose lock scope contains it; the finding
demotes to info and does not gate CI.  ``# lint: send-under-lock-ok``
is honored as a legacy alias for the socket family.

Entry points:
  * `analyze_source(src, filename)` — one source string (tests/fixtures);
  * `analyze_paths(paths)` — files/dirs, whole-`paddle_tpu_torch` by
    default;
  * `to_diagnostics(findings)` — the verifier's Diagnostic model (file/line
    carried in the new source-location fields);
  * `python -m paddle_tpu_torch.cli concurrency [--json]` — the CLI
    surface; module scope here stays stdlib-only, so the module can be
    file-loaded standalone (no package import).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "RULES",
    "analyze_source",
    "analyze_file",
    "analyze_paths",
    "to_diagnostics",
    "DEFAULT_PATHS",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATHS = (os.path.join(_REPO_ROOT, "paddle_tpu_torch"),)

RULES = ("lock-order", "blocking-under-lock", "unguarded-attr",
         "thread-join", "thread-start-order")

# threading constructors -> primitive kind.  "reentrant" kinds may be
# re-acquired by the holder; everything else self-deadlocks.
_PRIMITIVE_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "Event": "event",
    "Semaphore": "semaphore",
    "BoundedSemaphore": "semaphore",
    "Barrier": "barrier",
}
_LOCKISH_KINDS = ("lock", "rlock", "condition")
_REENTRANT = ("rlock",)

_QUEUE_CTORS = ("Queue", "LifoQueue", "PriorityQueue", "SimpleQueue")

# rule 4's socket family, verbatim (tools/lint.py delegates here)
_SOCKET_BLOCKING = frozenset(
    "send sendall sendmsg sendto recv recv_into recvfrom recvmsg "
    "_send_frame _send_frame_parts _recv_frame _read_exact "
    "_sendall_parts".split())
_SUBPROCESS_BLOCKING = frozenset(
    "run call check_call check_output communicate".split())
_PER_ENDPOINT_LOCK = ("conn_lock", "ep_lock", "endpoint_lock")

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*([a-z-]+)-ok")


@dataclasses.dataclass
class Finding:
    """One concurrency finding, located at source level (unlike the
    Program-IR Diagnostic, which locates by block/op)."""

    rule: str            # one of RULES
    severity: str        # "error" | "warning" | "info"
    file: str            # path as given to the analyzer
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False   # a `# lint: <rule>-ok` comment demoted it

    def __str__(self):
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.file}:{self.line}: [{self.severity}] "
                f"{self.rule}: {self.message}{tag}")


# ---------------------------------------------------------------------------
# per-file model extraction
# ---------------------------------------------------------------------------


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted rendering of an attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _primitive_kind(value: ast.AST) -> Optional[str]:
    """threading.Lock() / Condition(...) / queue.Queue() -> kind
    (`torch.cuda.Event()` / `cuda.Stream()`: None, not a primitive)."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if "cuda" in _dotted(f).split(".")[:-1]:
        return None
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else "")
    if name in _PRIMITIVE_KINDS:
        return _PRIMITIVE_KINDS[name]
    if name in _QUEUE_CTORS:
        return "queue"
    if name == "Thread":
        return "thread"
    if name == "ThreadPoolExecutor":
        return "executor"
    return None


def _thread_target(call: ast.Call) -> Optional[str]:
    """`Thread(target=self.m, ...)` -> "m" (self-method targets only)."""
    for kw in call.keywords:
        if kw.arg == "target":
            t = kw.value
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return t.attr
    return None


def _thread_daemon(call: ast.Call) -> Optional[bool]:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return None


@dataclasses.dataclass
class _Access:
    attr: str
    is_write: bool
    held: frozenset      # lock ids held at the access
    line: int
    flag_write: bool = False   # write of a bool/None constant


@dataclasses.dataclass
class _Acquire:
    lock: str            # lock id
    held_before: frozenset
    line: int
    with_line: int       # header line of the with-statement


@dataclasses.dataclass
class _BlockingCall:
    kind: str            # "socket"|"join"|"queue"|"subprocess"|"sleep"|"wait"
    name: str
    receiver: str        # dotted receiver ("" when none)
    held: frozenset
    line: int
    with_lines: Tuple[int, ...]   # header lines of the enclosing lockish withs


@dataclasses.dataclass
class _Call:
    method: str          # self.<method> intra-class call
    held: frozenset
    line: int
    with_lines: Tuple[int, ...]


@dataclasses.dataclass
class _ThreadDecl:
    name: str            # "self._worker" or local name
    target: Optional[str]
    daemon: Optional[bool]
    line: int
    started_line: Optional[int] = None
    joined: bool = False


class _MethodModel:
    def __init__(self, name: str):
        self.name = name
        self.accesses: List[_Access] = []
        self.acquires: List[_Acquire] = []
        self.blocking: List[_BlockingCall] = []
        self.calls: List[_Call] = []
        self.stmt_events: List[Tuple[int, str, str]] = []  # start-order


class _ClassModel:
    def __init__(self, name: str):
        self.name = name
        self.locks: Dict[str, Tuple[str, int]] = {}    # attr -> (kind, line)
        self.threads: Dict[str, _ThreadDecl] = {}      # attr/local key
        self.methods: Dict[str, _MethodModel] = {}
        self.thread_targets: Set[str] = set()          # self-method names


def _lock_id(cls: Optional[_ClassModel], module_locks: Dict[str, str],
             expr: ast.AST, scope: str = "") -> Optional[str]:
    """Resolve a with-context expression to a lock identity string, or
    None when it is not a known/lockish primitive.

    Identities: "Class.attr" for `self._x`, "<module>.name" for
    globals, "<local:Class.method>.name" for function locals that
    merely LOOK like locks (the rule-4 name heuristic keeps working on
    code whose constructor the file never shows).  Locals are scoped
    PER FUNCTION: two functions' same-named locals are different
    objects and must not forge cross-function ordering edges."""
    name = _dotted(expr)
    if name.startswith("self.") and name.count(".") == 1 and cls:
        attr = name.split(".", 1)[1]
        kind = cls.locks.get(attr, (None, 0))[0]
        if kind in _LOCKISH_KINDS:
            return f"{cls.name}.{attr}"
        if kind is not None:
            return None   # known non-lock primitive (event/queue/...)
        if _looks_lockish(attr):
            return f"{cls.name}.{attr}"
        return None
    if name and "." not in name:
        if module_locks.get(name) in _LOCKISH_KINDS:
            return f"<module>.{name}"
        if name in module_locks:
            return None
        if _looks_lockish(name):
            return f"<local:{scope}>.{name}"
        return None
    # dotted non-self expression (other.lock): use the name heuristic
    if name and _looks_lockish(name.rsplit(".", 1)[-1]):
        return f"<other>.{name}"
    return None


def _looks_lockish(name: str) -> bool:
    parts = [p for p in re.split(r"[^a-z]+", name.lower()) if p]
    if any(p in ("lock", "cond", "cv", "mutex") for p in parts):
        return True
    return name.lower().endswith(("lock", "cond"))


def _is_per_endpoint(lock_id: str) -> bool:
    return lock_id.rsplit(".", 1)[-1].lower().endswith(_PER_ENDPOINT_LOCK)


class _FunctionScanner(ast.NodeVisitor):
    """Walk one function body tracking the stack of held locks; record
    attribute accesses, lock acquisitions, intra-class calls, blocking
    calls, and thread starts/joins.  Nested def/lambda bodies are code
    that runs LATER (after the lock is released) — not descended with
    the held set; they are scanned separately with an empty stack."""

    def __init__(self, owner: "_FileScanner", cls: Optional[_ClassModel],
                 model: _MethodModel):
        self.owner = owner
        self.cls = cls
        self.model = model
        self.held: List[str] = []
        self.with_lines: List[int] = []
        self._local_threads: Dict[str, _ThreadDecl] = {}

    # -- helpers ------------------------------------------------------------
    def _heldset(self) -> frozenset:
        return frozenset(self.held)

    def _thread_decl_for(self, dotted: str) -> Optional[_ThreadDecl]:
        if self.cls and dotted.startswith("self."):
            return self.cls.threads.get(dotted)
        return self._local_threads.get(dotted)

    # -- statements ----------------------------------------------------------
    def _scope_tag(self) -> str:
        return f"{self.cls.name if self.cls else ''}.{self.model.name}"

    def visit_With(self, node: ast.With):
        acquired = []
        for item in node.items:
            # context expressions are EVALUATED (with the previous
            # items' locks already held) — calls inside them must feed
            # the blocking/call-chain analyses like any other code
            self.visit(item.context_expr)
            lid = _lock_id(self.cls, self.owner.module_locks,
                           item.context_expr, self._scope_tag())
            if lid is not None:
                # `with a, b:` acquires left-to-right: a is already
                # held when b is taken, so record-then-extend per item
                self.model.acquires.append(_Acquire(
                    lid, self._heldset(), item.context_expr.lineno
                    if hasattr(item.context_expr, "lineno")
                    else node.lineno, node.lineno))
                acquired.append(lid)
                self.held.append(lid)
        if acquired:
            self.with_lines.append(node.lineno)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            self.with_lines.pop()
        # drop OUR acquisitions specifically (a manual x.acquire() in
        # the body may have interleaved entries onto the held stack)
        for lid in reversed(acquired):
            self._drop_held(lid)

    def visit_FunctionDef(self, node):
        # nested def: its body runs AFTER the enclosing lock scope, on
        # whoever calls it — scan it as its own (uncallable-by-name)
        # model so its blocking calls neither read as under-lock nor
        # mark the ENCLOSING method as a blocking helper
        sub = _MethodModel(f"{self.model.name}.<locals>.{node.name}")
        owner_cls = self.cls
        if owner_cls is None:
            owner_cls = self.owner.classes.setdefault(
                "<module-fns>", _ClassModel("<module-fns>"))
        owner_cls.methods[sub.name] = sub
        sc = _FunctionScanner(self.owner, self.cls, sub)
        for stmt in node.body:
            sc.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass   # same reasoning; lambda bodies are expression-only

    def visit_Assign(self, node: ast.Assign):
        for tgt in node.targets:
            self._record_target(tgt, node.value)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record_target(node.target, None, aug=True)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._record_target(node.target, node.value)
            self.visit(node.value)

    def _record_target(self, tgt: ast.AST, value: Optional[ast.AST],
                       aug: bool = False):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._record_target(e, None)
            return
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self" and self.cls is not None):
            kind = _primitive_kind(value) if value is not None else None
            if kind in ("thread",):
                decl = _ThreadDecl(f"self.{tgt.attr}",
                                   _thread_target(value),
                                   _thread_daemon(value), tgt.lineno)
                self.cls.threads[f"self.{tgt.attr}"] = decl
                t = _thread_target(value)
                if t:
                    self.cls.thread_targets.add(t)
            elif kind is not None:
                self.cls.locks.setdefault(tgt.attr, (kind, tgt.lineno))
            else:
                flag = (isinstance(value, ast.Constant)
                        and (value.value is None
                             or isinstance(value.value, bool)))
                self.model.accesses.append(_Access(
                    tgt.attr, True, self._heldset(), tgt.lineno,
                    flag_write=flag and not aug))
            # `self.t.daemon = True` handled via Attribute-of-Attribute
        elif isinstance(tgt, ast.Name) and value is not None:
            kind = _primitive_kind(value)
            if kind == "thread":
                decl = _ThreadDecl(tgt.id, _thread_target(value),
                                   _thread_daemon(value), tgt.lineno)
                self._local_threads[tgt.id] = decl
                # local threads share the never-joined check
                self.owner.local_threads.append(decl)
                t = _thread_target(value)
                if t and self.cls is not None:
                    self.cls.thread_targets.add(t)
        elif isinstance(tgt, ast.Subscript):
            # container mutation (`self._m[k] = v`): a WRITE to the
            # underlying attribute for the race analysis — shared
            # dict/list state is the common shape in this repo
            self._record_root_write(tgt.value)
            self.visit(tgt.slice)
        elif (isinstance(tgt, ast.Attribute) and tgt.attr == "daemon"):
            decl = self._thread_decl_for(_dotted(tgt.value))
            if decl is not None and isinstance(value, ast.Constant):
                decl.daemon = bool(value.value)
        elif isinstance(tgt, ast.Attribute):
            # `self.a.b = v` mutates the object held in self.a
            self._record_root_write(tgt.value)

    def _record_root_write(self, node: ast.AST):
        """Record the `self.<attr>` root of a mutation-target chain
        (subscripts/attributes) as a write access."""
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and self.cls is not None):
                self.model.accesses.append(_Access(
                    node.attr, True, self._heldset(), node.lineno))
                return
            node = node.value

    # -- expressions ----------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and isinstance(node.ctx, ast.Load)
                and self.cls is not None):
            self.model.accesses.append(_Access(
                node.attr, False, self._heldset(), node.lineno))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        name = _call_name(node)
        recv = (_dotted(node.func.value)
                if isinstance(node.func, ast.Attribute) else "")
        held = self._heldset()
        wl = tuple(self.with_lines)

        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self" and self.cls is not None):
            self.model.calls.append(_Call(name, held, node.lineno, wl))
        elif isinstance(node.func, ast.Name):
            # bare-name call: may hit a module-level helper — recorded
            # for the one-hop transitive blocking check
            self.model.calls.append(_Call(name, held, node.lineno, wl))

        decl = self._thread_decl_for(recv) if recv else None
        if name == "start" and decl is not None:
            decl.started_line = node.lineno
            self.model.stmt_events.append((node.lineno, "start", recv))
        if name == "join":
            if decl is not None:
                decl.joined = True
            # `self.X.join()` may join a thread declared in another
            # method of the same class — resolve lazily at report time
            self.owner.joined_names.add(recv)

        # explicit lock.acquire()/release(): linear-scan tracking so
        # manually-managed locks contribute ordering edges and a held
        # set just like `with` statements (conservative: a conditional
        # acquire counts as held through the rest of the function)
        if name in ("acquire", "release") \
                and isinstance(node.func, ast.Attribute):
            lid = _lock_id(self.cls, self.owner.module_locks,
                           node.func.value, self._scope_tag())
            if lid is not None:
                if name == "acquire":
                    self.model.acquires.append(_Acquire(
                        lid, self._heldset(), node.lineno,
                        node.lineno))
                    self.held.append(lid)
                else:
                    self._drop_held(lid)

        # record blocking-class calls even with NO lock held: the
        # one-hop transitive check needs to know which helpers block
        self._classify_blocking(node, name, recv, held, wl)
        self.generic_visit(node)

    def _drop_held(self, lid: str):
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i] == lid:
                del self.held[i]
                return

    def _classify_blocking(self, node: ast.Call, name: str, recv: str,
                           held: frozenset, wl: Tuple[int, ...]):
        add = self.model.blocking.append
        if name in _SOCKET_BLOCKING:
            add(_BlockingCall("socket", name, recv, held, node.lineno, wl))
            return
        if name == "sleep" and recv in ("time", ""):
            add(_BlockingCall("sleep", name, recv, held, node.lineno, wl))
            return
        if recv == "subprocess" and (name in _SUBPROCESS_BLOCKING
                                     or name == "Popen"):
            add(_BlockingCall("subprocess", name, recv, held,
                              node.lineno, wl))
            return
        if name in ("wait", "communicate") and recv.startswith(
                "subprocess."):
            add(_BlockingCall("subprocess", name, recv, held,
                              node.lineno, wl))
            return
        if name == "join":
            decl = self._thread_decl_for(recv) if recv else None
            known_thread = decl is not None or (
                self.cls is not None and recv in self.cls.threads)
            if known_thread:
                add(_BlockingCall("join", name, recv, held,
                                  node.lineno, wl))
            return
        if name in ("get", "put") and self._is_known_queue(recv):
            if not _nonblocking_kwargs(node, name):
                add(_BlockingCall("queue", name, recv, held,
                                  node.lineno, wl))
            return
        if name in ("wait", "wait_for"):
            lid = _lock_id(self.cls, self.owner.module_locks,
                           node.func.value, self._scope_tag()) \
                if isinstance(node.func, ast.Attribute) else None
            kind = self._primitive_kind_of(recv)
            if kind == "event" or (lid is not None and lid in held
                                   and len(held) > 1):
                # waiting on an Event with ANY lock held, or on the
                # held condition while ALSO holding another lock:
                # the other lock stays held for the whole wait
                add(_BlockingCall("wait", name, recv, held,
                                  node.lineno, wl))
            elif (kind == "condition" and lid is not None
                  and lid not in held):
                # waiting on a condition NOT held -> runtime error
                # anyway, but flag it as blocking misuse
                add(_BlockingCall("wait", name, recv, held,
                                  node.lineno, wl))

    def _primitive_kind_of(self, recv: str) -> Optional[str]:
        if recv.startswith("self.") and self.cls is not None:
            return self.cls.locks.get(recv.split(".", 1)[1],
                                      (None, 0))[0]
        if recv in self.owner.module_locks:
            return self.owner.module_locks[recv]
        return None

    def _is_known_queue(self, recv: str) -> bool:
        return self._primitive_kind_of(recv) == "queue"


def _nonblocking_kwargs(node: ast.Call, method: str = "get") -> bool:
    for kw in node.keywords:
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
        if kw.arg == "timeout":
            # bounded wait: convoy is time-boxed — but an explicit
            # timeout=None is the infinite default spelled out
            if not (isinstance(kw.value, ast.Constant)
                    and kw.value.value is None):
                return True
    # positional block=False: q.get(False) / q.put(item, False) —
    # put's first positional is the ITEM, its block flag is second
    block_pos = 1 if method == "put" else 0
    if len(node.args) > block_pos \
            and isinstance(node.args[block_pos], ast.Constant) \
            and node.args[block_pos].value is False:
        return True
    return False


class _FileScanner:
    """Extract the concurrency model of one source file."""

    def __init__(self, tree: ast.AST, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.module_locks: Dict[str, str] = {}
        self.classes: Dict[str, _ClassModel] = {}
        self.local_threads: List[_ThreadDecl] = []
        self.joined_names: Set[str] = set()
        self.module_model = _MethodModel("<module>")

        for node in tree.body:
            self._scan_top(node)

    def _scan_top(self, node: ast.AST):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            kind = _primitive_kind(node.value)
            if kind is not None:
                self.module_locks[node.targets[0].id] = kind
        if isinstance(node, ast.ClassDef):
            cls = _ClassModel(node.name)
            self.classes[node.name] = cls
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    self.scan_function(cls, sub)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.scan_function(None, node)
        else:
            # module-level statements (incl. if __main__ blocks)
            sc = _FunctionScanner(self, None, self.module_model)
            sc.visit(node)

    def scan_function(self, cls: Optional[_ClassModel], node):
        model = _MethodModel(node.name)
        if cls is not None:
            cls.methods[node.name] = model
        else:
            # module-level functions live in a synthetic class so
            # the rule checkers traverse one uniform shape
            self.classes.setdefault("<module-fns>",
                                    _ClassModel("<module-fns>"))
            self.classes["<module-fns>"].methods[node.name] = model
        sc = _FunctionScanner(self, cls, model)
        for stmt in node.body:
            sc.visit(stmt)

    def suppressed(self, rule: str, *lines: int) -> bool:
        """`# lint: <rule>-ok` on any of the given source lines, or on
        a pure-comment line block immediately above one of them."""
        aliases = {rule}
        if rule == "blocking-under-lock":
            aliases.add("send-under-lock")

        def match(ln: int) -> bool:
            if not 0 < ln <= len(self.lines):
                return False
            return any(m.group(1) in aliases
                       for m in _SUPPRESS_RE.finditer(self.lines[ln - 1]))

        for ln in lines:
            if match(ln):
                return True
            above = ln - 1
            while (0 < above <= len(self.lines)
                   and self.lines[above - 1].lstrip().startswith("#")):
                if match(above):
                    return True
                above -= 1
        return False


# ---------------------------------------------------------------------------
# rule evaluation
# ---------------------------------------------------------------------------


def _method_acquires(cls: _ClassModel) -> Dict[str, Set[str]]:
    """Fixed point: locks each method may acquire, directly or through
    intra-class calls."""
    acq = {m: {a.lock for a in mm.acquires}
           for m, mm in cls.methods.items()}
    changed = True
    while changed:
        changed = False
        for m, mm in cls.methods.items():
            for c in mm.calls:
                extra = acq.get(c.method)
                if extra and not extra <= acq[m]:
                    acq[m] |= extra
                    changed = True
    return acq


def _check_lock_order(sc: _FileScanner, findings: List[Finding]):
    # edges: (held_lock, acquired_lock) -> first evidence site
    edges: Dict[Tuple[str, str], Tuple[int, int, str]] = {}
    kinds: Dict[str, str] = {f"<module>.{n}": k
                             for n, k in sc.module_locks.items()}

    for cls in sc.classes.values():
        for attr, (kind, _ln) in cls.locks.items():
            kinds[f"{cls.name}.{attr}"] = kind
        acq = _method_acquires(cls)
        for mname, mm in cls.methods.items():
            for a in mm.acquires:
                for h in a.held_before:
                    if h == a.lock:
                        # direct nested re-acquisition of one lock
                        if kinds.get(h, "lock") not in _REENTRANT:
                            sup = sc.suppressed("lock-order", a.line,
                                                a.with_line)
                            findings.append(Finding(
                                "lock-order",
                                "info" if sup else "error",
                                sc.path, a.line,
                                f"nested acquisition of non-reentrant "
                                f"{h} ({kinds.get(h, 'lock')}) — "
                                "self-deadlock",
                                hint="use an RLock, or split the "
                                "locked region so the inner with is "
                                "not reached with the lock held",
                                suppressed=sup))
                    else:
                        edges.setdefault(
                            (h, a.lock),
                            (a.line, a.with_line, cls.name))
            # call-through acquisition: calling m2 (which acquires B)
            # while holding A
            for c in mm.calls:
                for b in acq.get(c.method, ()):
                    for h in c.held:
                        if h == b:
                            if kinds.get(h, "lock") not in _REENTRANT:
                                sup = sc.suppressed(
                                    "lock-order", c.line, *c.with_lines)
                                findings.append(Finding(
                                    "lock-order",
                                    "info" if sup else "warning",
                                    sc.path, c.line,
                                    f"call to self.{c.method}() while "
                                    f"holding {h}, which it "
                                    "re-acquires — self-deadlock if "
                                    "this path runs",
                                    hint="add a *_locked variant that "
                                    "assumes the lock, or release "
                                    "before the call",
                                    suppressed=sup))
                        else:
                            edges.setdefault(
                                (h, b), (c.line, c.line, cls.name))

    # cycle detection over the inter-lock graph
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    for cycle in _find_cycles(graph):
        # evidence: one edge of the cycle (the lexically first)
        pairs = list(zip(cycle, cycle[1:] + cycle[:1]))
        sites = [edges[p] for p in pairs if p in edges]
        line, with_line, _cls = min(sites) if sites else (0, 0, "")
        sup = any(sc.suppressed("lock-order", s[0], s[1])
                  for s in sites)
        findings.append(Finding(
            "lock-order", "info" if sup else "error", sc.path, line,
            "lock-order cycle: " + " -> ".join(cycle + [cycle[0]])
            + " — two threads taking these locks in different orders "
            "deadlock",
            hint="pick one global order (document it in the class "
            "docstring) and re-acquire in that order, or collapse to "
            "one lock; a deliberate ordering-safe design can be "
            "annotated `# lint: lock-order-ok` with a rationale",
            suppressed=sup))


def _find_cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Elementary cycles via DFS over SCCs (small graphs; Tarjan then a
    simple walk per SCC is plenty)."""
    index = {}
    low = {}
    stack: List[str] = []
    on = set()
    sccs = []
    counter = [0]

    def strongconnect(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in graph.get(v, ()):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def _check_blocking(sc: _FileScanner, findings: List[Finding]):
    hints = {
        "socket": "move the IO outside the lock (snapshot under it, "
        "send after), or use a per-endpoint `*_conn_lock`",
        "join": "set a deadline and join outside the lock — the "
        "joined thread may need this very lock to finish",
        "queue": "use get_nowait/put_nowait or a timeout, or move the "
        "queue op outside the lock",
        "subprocess": "run the subprocess outside the lock; keep only "
        "the state update under it",
        "sleep": "sleep outside the lock, or use cond.wait(timeout) "
        "so waiters can be woken",
        "wait": "wait only on the lock you hold: release other locks "
        "first (waiting on B while holding A is the lost-wakeup/"
        "deadlock shape)",
    }
    # which functions/methods make a DIRECT blocking call anywhere in
    # their body (for the one-hop transitive check below)
    fn_blocks: Dict[Tuple[str, str], Set[str]] = {}
    all_models: List[Tuple[str, _MethodModel]] = [
        ("", sc.module_model)]
    for cls in sc.classes.values():
        for mm in cls.methods.values():
            all_models.append((cls.name, mm))
            kinds = {b.kind for b in mm.blocking}
            if kinds:
                fn_blocks[(cls.name, mm.name)] = kinds
                if cls.name == "<module-fns>":
                    fn_blocks[("", mm.name)] = kinds

    def report(b: _BlockingCall):
        if b.kind == "socket":
            # rule 4's per-endpoint allowlist: every held lock is a
            # per-endpoint connection lock
            if all(_is_per_endpoint(h) for h in b.held):
                return
        sup = sc.suppressed("blocking-under-lock", b.line,
                            *b.with_lines)
        held = ", ".join(sorted(b.held))
        findings.append(Finding(
            "blocking-under-lock",
            "info" if sup else "error", sc.path, b.line,
            f"blocking {b.kind} call "
            f"{(b.receiver + '.') if b.receiver else ''}"
            f"{b.name}() while holding {held} — every thread "
            "needing the lock convoys behind it",
            hint=hints[b.kind], suppressed=sup))

    for cname, mm in all_models:
        for b in mm.blocking:
            if b.held:
                report(b)
        # one hop transitive: calling a same-file helper that itself
        # makes a direct blocking call, with a lock held (warning: the
        # helper may have its own discipline the analysis cannot see)
        for c in mm.calls:
            if not c.held:
                continue
            kinds = fn_blocks.get((cname, c.method)) \
                or fn_blocks.get(("", c.method)) \
                or fn_blocks.get(("<module-fns>", c.method))
            if not kinds:
                continue
            sup = sc.suppressed("blocking-under-lock", c.line,
                                *c.with_lines)
            findings.append(Finding(
                "blocking-under-lock",
                "info" if sup else "warning", sc.path, c.line,
                f"call to {c.method}(), which makes a blocking "
                f"{'/'.join(sorted(kinds))} call, while holding "
                + ", ".join(sorted(c.held)),
                hint="the helper blocks with the lock held — move "
                "the call outside the lock or annotate why the "
                "convoy is acceptable",
                suppressed=sup))


def _check_races(sc: _FileScanner, findings: List[Finding]):
    for cls in sc.classes.values():
        if not cls.thread_targets or cls.name == "<module-fns>":
            continue   # single-threaded class: nothing to race
        # background set: thread targets + methods reachable from them
        bg = set(cls.thread_targets)
        changed = True
        while changed:
            changed = False
            for m in list(bg):
                mm = cls.methods.get(m)
                if mm is None:
                    continue
                for c in mm.calls:
                    if c.method in cls.methods and c.method not in bg:
                        bg.add(c.method)
                        changed = True

        # methods reachable ONLY from __init__ run pre-publication (no
        # other thread can hold the object yet) — same exemption as
        # __init__ itself
        callers: Dict[str, Set[str]] = {}
        for mname, mm in cls.methods.items():
            for c in mm.calls:
                callers.setdefault(c.method, set()).add(mname)
        init_only: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for m in cls.methods:
                if m in init_only or m == "__init__" or m in bg:
                    continue
                cs = callers.get(m)
                if cs and cs <= ({"__init__"} | init_only):
                    init_only.add(m)
                    changed = True
        pre_pub = {"__init__"} | init_only

        # guarded attrs: written under some lock outside __init__
        guards: Dict[str, Set[str]] = {}
        writers: Dict[str, Set[str]] = {}
        all_writes_flag: Dict[str, bool] = {}
        for mname, mm in cls.methods.items():
            for a in mm.accesses:
                if not a.is_write:
                    continue
                all_writes_flag[a.attr] = (
                    all_writes_flag.get(a.attr, True) and a.flag_write)
                if mname not in pre_pub and a.held:
                    guards.setdefault(a.attr, set()).update(a.held)
                    writers.setdefault(a.attr, set()).add(mname)
        skip = set(cls.locks) | {t.split(".", 1)[-1]
                                 for t in cls.threads} \
            | set(cls.methods)
        for mname, mm in cls.methods.items():
            if mname in pre_pub:
                continue
            if mname.endswith("_locked"):
                # naming convention: the caller holds the lock — the
                # bare accesses inside are the point of the helper
                continue
            for a in mm.accesses:
                if a.attr not in guards or a.attr in skip or a.held:
                    continue
                # bare access in a method on the other side of a thread
                # boundary from some locked writer
                other_side = any(
                    (w in bg) != (mname in bg)
                    for w in writers.get(a.attr, ()))
                if not other_side:
                    continue
                sup = sc.suppressed("unguarded-attr", a.line)
                # pure bool/None flag attrs (`self._stop = True`):
                # the CPython store/load is atomic and the pattern is
                # idiomatic cooperative shutdown — info, not warning
                flagish = all_writes_flag.get(a.attr, False) or (
                    a.is_write and a.flag_write)
                findings.append(Finding(
                    "unguarded-attr",
                    "info" if (sup or flagish) else "warning",
                    sc.path, a.line,
                    f"{cls.name}.{a.attr} is written under "
                    f"{'/'.join(sorted(guards[a.attr]))} in "
                    f"{'/'.join(sorted(writers[a.attr]))} but "
                    f"{'written' if a.is_write else 'read'} with no "
                    f"lock in {mname}(), which runs on a different "
                    "thread — data race candidate",
                    hint="take the attribute's lock here too, or "
                    "annotate `# lint: unguarded-attr-ok` with why "
                    "the bare access is safe (atomic flag, "
                    "happens-before via join, ...)",
                    suppressed=sup))


def _check_thread_hygiene(sc: _FileScanner, findings: List[Finding]):
    decls: List[Tuple[Optional[_ClassModel], _ThreadDecl]] = []
    for cls in sc.classes.values():
        for decl in cls.threads.values():
            decls.append((cls, decl))
    for decl in sc.local_threads:
        decls.append((None, decl))

    for cls, decl in decls:
        if decl.daemon is True:
            continue
        joined = decl.joined or decl.name in sc.joined_names
        if not joined:
            sup = sc.suppressed("thread-join", decl.line)
            findings.append(Finding(
                "thread-join", "info" if sup else "error",
                sc.path, decl.line,
                f"non-daemon thread {decl.name} is never joined — it "
                "keeps the process alive after main exits (and its "
                "failures are never observed)",
                hint="pass daemon=True (fire-and-forget workers) or "
                "join it on the shutdown path",
                suppressed=sup))

    # start-before-state: a thread started in a method whose target
    # reads attrs first assigned AFTER the start() in that same method
    for cls in sc.classes.values():
        for decl in cls.threads.values():
            if decl.started_line is None or not decl.target:
                continue
            target = cls.methods.get(decl.target)
            if target is None:
                continue
            reads = {a.attr for a in target.accesses if not a.is_write}
            # plus attrs read by the target's callees (one hop deep is
            # where the real bugs live; full closure adds noise)
            for c in target.calls:
                callee = cls.methods.get(c.method)
                if callee:
                    reads |= {a.attr for a in callee.accesses
                              if not a.is_write}
            for mname, mm in cls.methods.items():
                assigns: Dict[str, int] = {}
                for a in mm.accesses:
                    if a.is_write and a.attr not in assigns:
                        assigns[a.attr] = a.line
                start_here = any(
                    ln == decl.started_line
                    for (ln, ev, recv) in mm.stmt_events
                    if ev == "start" and recv == decl.name)
                if not start_here:
                    continue
                late = sorted(
                    (ln, attr) for attr, ln in assigns.items()
                    if attr in reads and ln > decl.started_line)
                if late:
                    ln, attr = late[0]
                    sup = sc.suppressed("thread-start-order",
                                        decl.started_line, ln)
                    findings.append(Finding(
                        "thread-start-order",
                        "info" if sup else "error",
                        sc.path, decl.started_line,
                        f"{decl.name}.start() runs "
                        f"{decl.target}() which reads self.{attr}, "
                        f"first assigned at line {ln} — after the "
                        "start: the thread can observe it missing",
                        hint="assign every attribute the thread reads "
                        "before start(), or gate the thread body on "
                        "an Event set when initialization completes",
                        suppressed=sup))


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def analyze_source(source: str, filename: str = "<source>",
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze one source string; `rules` restricts the checks run."""
    tree = ast.parse(source, filename=filename)
    sc = _FileScanner(tree, filename, source)
    findings: List[Finding] = []
    rules = set(rules or RULES)
    if "lock-order" in rules:
        _check_lock_order(sc, findings)
    if "blocking-under-lock" in rules:
        _check_blocking(sc, findings)
    if "unguarded-attr" in rules:
        _check_races(sc, findings)
    if "thread-join" in rules or "thread-start-order" in rules:
        hygiene: List[Finding] = []
        _check_thread_hygiene(sc, hygiene)
        findings.extend(f for f in hygiene if f.rule in rules)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def analyze_file(path: str,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path) as f:
        source = f.read()
    try:
        return analyze_source(source, filename=path, rules=rules)
    except SyntaxError as e:
        # a file the analyzer cannot parse is ALWAYS an error (never
        # filtered by `rules` — an unanalyzable file must not read as
        # clean), under its own rule id so consumers don't misfile it
        # as a deadlock finding
        return [Finding("syntax-error", "error", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]


def iter_py_files(paths: Sequence[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def analyze_paths(paths: Optional[Sequence[str]] = None,
                  rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Analyze files/dirs (default: the whole paddle_tpu_torch
    package)."""
    out: List[Finding] = []
    for path in iter_py_files(list(paths or DEFAULT_PATHS)):
        out.extend(analyze_file(path, rules=rules))
    return out


def to_diagnostics(findings: Sequence[Finding]):
    """Render findings on the verifier's shared Diagnostic model
    (file/line in the source-location fields) — the `cli concurrency
    --json` shape."""
    from .diagnostics import Diagnostic

    out = []
    for f in findings:
        rel = os.path.relpath(f.file, _REPO_ROOT) \
            if os.path.isabs(f.file) else f.file
        out.append(Diagnostic(
            pass_id=f"concurrency/{f.rule}", severity=f.severity,
            message=f.message + (" [suppressed]" if f.suppressed else ""),
            hint=f.hint, file=rel, line=f.line))
    return out


def summarize(findings: Sequence[Finding]) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    n_sup = sum(1 for f in findings if f.suppressed)
    head = ", ".join(f"{counts[s]} {s}{'s' if counts[s] != 1 else ''}"
                     for s in ("error", "warning", "info")
                     if s in counts) or "no findings"
    if n_sup:
        head += f" ({n_sup} suppressed)"
    return head


if __name__ == "__main__":   # python -m paddle_tpu_torch.analysis.concurrency
    import sys

    fs = analyze_paths(sys.argv[1:] or None)
    for f in fs:
        print(f)
    print(summarize(fs))
    sys.exit(1 if any(f.severity == "error" for f in fs) else 0)
