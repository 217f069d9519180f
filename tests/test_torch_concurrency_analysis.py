"""The port's concurrency analyzer and schedule checker
(paddle_tpu_torch.analysis.concurrency / schedcheck / schedmodels)
against the JAX package's, on the CPU.

  * every rule golden of tests/test_concurrency_analysis.py (each source
    fixture of its rule tests, read from that file's AST) gives the same
    findings in both analyzers: (rule, severity, line, suppressed);
  * `schedcheck.explore` on one two-thread AB/BA model with the same
    seed and bounds explores the same schedules and finds the same
    deadlock trace;
  * the port's four protocol models run once each: clean at head, their
    `buggy=True` variants caught (the JAX package's tests run its own);
  * the GenerationStream regression pin on the port's real code: clean
    at head, the yield-under-lock stall found with the fault armed;
  * the lint over paddle_tpu_torch/ has no unsuppressed error, and the
    nvcc build under kernels/cuda_build.py's lock is a suppressed info;
    CUDA events and streams are not thread primitives;
  * `cli concurrency` (human, --json, --sched).
"""
import ast
import json
import os
import threading

import pytest

from paddle_tpu.analysis import concurrency as jconc
from paddle_tpu.analysis import schedcheck as jsched

from paddle_tpu_torch.analysis import concurrency as conc
from paddle_tpu_torch.analysis import schedcheck as sched
from paddle_tpu_torch.analysis import schedmodels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _goldens():
    """(test name, source) for every `src*` string fixture of the JAX
    package's rule tests (tests/test_concurrency_analysis.py, the rule
    goldens section, before the schedcheck core)."""
    path = os.path.join(REPO, "tests", "test_concurrency_analysis.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        if "schedcheck" in fn.name or "protocol" in fn.name \
                or "pin_" in fn.name or "sched" in fn.name:
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.startswith("src")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                out.append((f"{fn.name}:{node.targets[0].id}",
                            node.value.value))
    return out


GOLDENS = _goldens()


def _shape(findings):
    return sorted((f.rule, f.severity, f.line, f.suppressed)
                  for f in findings)


def test_the_goldens_are_read():
    assert len(GOLDENS) == 23
    rules_seen = set()
    for _, src in GOLDENS:
        rules_seen |= {f.rule for f in conc.analyze_source(src, "f.py")}
    assert set(conc.RULES) <= rules_seen
    assert conc.RULES == jconc.RULES


@pytest.mark.parametrize("name,src", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_rule_golden_matches_the_jax_package(name, src):
    got = conc.analyze_source(src, "fixture.py")
    want = jconc.analyze_source(src, "fixture.py")
    assert _shape(got) == _shape(want)
    assert [f.message for f in sorted(got, key=lambda f: f.line)] == \
        [f.message for f in sorted(want, key=lambda f: f.line)]


def test_cuda_events_and_streams_are_not_thread_primitives():
    src = """
import threading
import torch
class P:
    def __init__(self):
        self._lock = threading.Lock()
        self._ready = torch.cuda.Event()
        self._stream = torch.cuda.Stream()
        self._done = threading.Event()
    def hand_off(self):
        with self._lock:
            self._ready.wait(self._stream)
            self._ready.synchronize()
    def bad(self):
        with self._lock:
            self._done.wait()
"""
    fs = [f for f in conc.analyze_source(src, "p.py")
          if f.rule == "blocking-under-lock"]
    assert [f.line for f in fs] == [16], fs


# ---------------------------------------------------------------------------
# the package itself
# ---------------------------------------------------------------------------


def test_the_port_is_clean_of_unsuppressed_errors():
    findings = conc.analyze_paths()
    assert conc.DEFAULT_PATHS == (os.path.join(REPO, "paddle_tpu_torch"),)
    errs = [f for f in findings if f.severity == "error"]
    assert errs == [], "\n".join(str(f) for f in errs)
    assert not [f for f in findings if f.severity == "warning"], \
        "\n".join(str(f) for f in findings)
    build = [f for f in findings if f.file.endswith(
        os.path.join("kernels", "cuda_build.py"))]
    assert [(f.rule, f.severity, f.suppressed) for f in build] == [
        ("blocking-under-lock", "info", True)]
    files = {os.path.relpath(f, REPO)
             for f in conc.iter_py_files(conc.DEFAULT_PATHS)}
    for threaded in ("paddle_tpu_torch/concurrency.py",
                     "paddle_tpu_torch/reader/pipeline.py",
                     "paddle_tpu_torch/serving/generation.py"):
        assert threaded in files


def test_cli_concurrency(tmp_path, capsys):
    from paddle_tpu_torch.cli import cmd_concurrency, main as cli_main

    assert cmd_concurrency([]) == 0
    assert "concurrency:" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text("import threading, time\n_lock = threading.Lock()\n"
                   "def f():\n    with _lock:\n        time.sleep(1)\n")
    assert cmd_concurrency([str(bad), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["failed"] and doc["diagnostics"][0]["pass"] == \
        "concurrency/blocking-under-lock"
    with pytest.raises(SystemExit, match="unknown rule"):
        cmd_concurrency([str(bad), "--rules", "lock_order"])
    with pytest.raises(SystemExit, match="no such path"):
        cmd_concurrency([str(tmp_path / "nope.py")])
    with pytest.raises(SystemExit) as ei:
        cli_main(["concurrency", str(tmp_path), "--sched",
                  "--sched-schedules", "20", "--json"])
    assert ei.value.code == 1       # bad.py's error; the models held
    doc = json.loads(capsys.readouterr().out)
    assert sorted(r["protocol"] for r in doc["schedcheck"]) == sorted(
        schedmodels.PROTOCOLS)
    assert all(r["ok"] for r in doc["schedcheck"])


# ---------------------------------------------------------------------------
# schedcheck
# ---------------------------------------------------------------------------


def _abba(consistent):
    def model():
        a, b = threading.Lock(), threading.Lock()
        out = []

        def t1():
            with a:
                with b:
                    out.append(1)

        def t2():
            first, second = (a, b) if consistent else (b, a)
            with first:
                with second:
                    out.append(2)

        x = threading.Thread(target=t1)
        y = threading.Thread(target=t2)
        x.start()
        y.start()
        x.join()
        y.join()
        return out

    return model


def test_explore_matches_the_jax_package_on_abba():
    for consistent in (False, True):
        kw = dict(max_schedules=60, random_schedules=10, seed=3)
        got = sched.explore(_abba(consistent), **kw)
        want = jsched.explore(_abba(consistent), **kw)
        assert got.schedules == want.schedules
        assert got.ok == want.ok == consistent
        if not consistent:
            assert "deadlock" in str(got.violation)
            assert got.violation.trace == want.violation.trace
            assert got.violation.schedule_index == \
                want.violation.schedule_index
            replay = sched.run_schedule(_abba(False),
                                        prefix=got.violation.trace)
            assert replay.deadlock is not None
    with pytest.raises(sched.ScheduleViolation):
        sched.check(_abba(False), max_schedules=60)


@pytest.mark.parametrize("protocol", sorted(schedmodels.PROTOCOLS))
def test_protocol_model_on_the_port(protocol):
    factory, invariant = schedmodels.PROTOCOLS[protocol]
    res = sched.explore(factory(), invariant, max_schedules=120,
                        random_schedules=30)
    assert res.ok, f"{protocol}: {res.violation}"
    res = sched.explore(factory(buggy=True), invariant,
                        max_schedules=120, random_schedules=30)
    assert res.violation is not None, f"{protocol}: seeded bug not found"


def test_admit_finish_swap_drives_the_ports_paged_kv_cache():
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache

    factory, invariant = schedmodels.PROTOCOLS[
        "generation_admit_finish_swap"]
    state = sched.run_schedule(factory(), prefix=[]).state
    assert isinstance(state["cache"], PagedKVCache)
    invariant(state)


def _stream_model():
    """A slow consumer iterating the port's GenerationStream must never
    block the scheduler's _put: the consumer parks on an Event only the
    producer's LATER progress sets — with the historical yield-under-
    lock bug the parked consumer holds the stream lock and the producer
    deadlocks against it."""
    from paddle_tpu_torch.serving.generation import GenerationStream

    stream = GenerationStream([1], 3)
    resume = threading.Event()
    got = []

    def producer():
        stream._put(0)
        stream._put(1)
        resume.set()
        stream._put(2)
        stream._finish()

    def consumer():
        for tok in stream:
            got.append(tok)
            resume.wait()

    p = threading.Thread(target=producer)
    c = threading.Thread(target=consumer)
    p.start()
    c.start()
    p.join()
    c.join()
    return got


def _stream_invariant(got):
    assert got == [0, 1, 2], got


def test_pin_generation_stream_slow_consumer():
    res = sched.explore(_stream_model, _stream_invariant,
                        max_schedules=150, random_schedules=20)
    assert res.ok, res.violation
    assert not sched.fault_armed("stream.yield-under-lock")
    with sched.arm_fault("stream.yield-under-lock"):
        res = sched.explore(_stream_model, _stream_invariant,
                            max_schedules=150, random_schedules=20)
    assert res.violation is not None, "yield-under-lock stall not found"
    assert "deadlock" in str(res.violation)
