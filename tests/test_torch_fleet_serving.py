"""The port's serving fleet against the JAX package's: the replica wire,
the router, the autoscaler's policy, `cli serve` and the warm-start
artifact.

Both packages build the same tiny LM (V=23, d16, 2 heads, 1 layer, block
4 x 8) under reset unique names; the JAX startup program makes the
parameters, which serve in both packages (the port's model dir format is
the JAX package's).  The port runs on CPUPlace(), where attention takes
the paged-attention kernel's plain version.

Tolerance: none.  Greedy tokens are compared exactly (the port's
float32 CPU decode of this model is the JAX package's token for token:
tests/test_torch_serving.py), as are the autoscaler's decisions and
reasons, and the wire's frames.  The kernels' build accounting of the
warm-start artifact needs nvcc and a card: tests/test_torch_cuda.py.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.core.framework as jfw
from paddle_tpu.cloud.autoscaler import AutoscalerPolicy as JPolicy
from paddle_tpu.cloud.autoscaler import ReplicaProcess as JReplicaProcess
from paddle_tpu.cloud.router import ReplicaRouter as JRouter
from paddle_tpu.models.transformer import \
    build_lm_paged_decoder as jax_build
from paddle_tpu.serving import GenerationServer as JServer
from paddle_tpu.serving import ReplicaServer as JReplicaServer
from paddle_tpu.serving import replica_call as jcall
from paddle_tpu.serving import replica_stream as jstream
from paddle_tpu.serving import save_generation_model as jax_save

import paddle_tpu_torch.core.framework as tfw
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.cloud.autoscaler import (Autoscaler, AutoscalerPolicy,
                                               ReplicaProcess,
                                               SubprocessReplicaLauncher)
from paddle_tpu_torch.cloud.router import ReplicaRouter
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.models.transformer import build_lm_paged_decoder
from paddle_tpu_torch.serving import (GenerationServer, ReplicaServer,
                                      build_warm_start_artifact,
                                      replica_call, replica_stream,
                                      server_from_model_dir)
from paddle_tpu_torch.serving.generation import (WARM_START_DIRNAME,
                                                 WARM_START_MANIFEST)
from paddle_tpu_torch.serving.replica import ReplicaError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, H, L, BS, NB = 23, 16, 2, 1, 4, 8
SPEC = {"vocab_size": V, "d_model": D, "n_heads": H, "n_layers": L,
        "block_size": BS, "max_blocks_per_seq": NB, "slots": 2,
        "kv_blocks": 24}
_JAX = {}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    old_main = tfw.switch_main_program(tfw.Program())
    old_startup = tfw.switch_startup_program(tfw.Program())
    tfw.reset_unique_names()
    tflags.reset_flags()
    yield
    tfw.switch_main_program(old_main)
    tfw.switch_startup_program(old_startup)
    tflags.reset_flags()


def _jax():
    """The JAX decoder and the parameters of its startup program."""
    if not _JAX:
        jfw.reset_unique_names()
        startup, dec = jax_build(V, BS, NB, d_model=D, n_heads=H,
                                 n_layers=L)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        _JAX["dec"] = dec
        _JAX["states"] = {n: np.asarray(scope.find_var(n))
                          for n in dec.state_names}
    return _JAX["dec"], _JAX["states"]


def _port_server(**kw):
    tfw.reset_unique_names()
    _, dec = build_lm_paged_decoder(V, BS, NB, d_model=D, n_heads=H,
                                    n_layers=L, place=CPUPlace())
    kw.setdefault("slots", 2)
    kw.setdefault("kv_blocks", 24)
    return GenerationServer(dec, _jax()[1], place=CPUPlace(), **kw)


def _jax_server(**kw):
    dec, states = _jax()
    kw.setdefault("slots", 2)
    kw.setdefault("kv_blocks", 24)
    return JServer(dec, states, place=fluid.CPUPlace(), **kw)


def _requests(seed=3, n=6):
    r = np.random.RandomState(seed)
    return [(r.randint(0, V, int(r.randint(2, 9))).tolist(),
             int(r.randint(4, 17))) for _ in range(n)]


def _want(reqs):
    srv = _jax_server()
    try:
        return [srv.generate(p, m, timeout=120) for p, m in reqs]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the autoscaler's policy on the JAX suite's signal sequences
# ---------------------------------------------------------------------------


def _sig(backlog=0.0, p99=float("nan")):
    return {"outstanding_tokens": backlog, "p99": p99, "qps": 0.0,
            "p50": p99, "replicas_live": 1}


_POLICY_KW = {"p99_high_s": 1.0, "backlog_high": 100, "backlog_low": 10,
              "sustain_s": 2.0, "idle_sustain_s": 5.0, "cooldown_s": 4.0}

# tests/test_autoscaler.py's sequences: (signals, live, now), or
# ("record", now) for an action completing
_CASES = {
    "scale_out_sustained": [(_sig(500), 1, t) for t in (0.0, 1.9, 2.0)],
    "p99_alone_is_hot": [(_sig(0, 3.0), 1, t) for t in (0.0, 2.5)],
    "idle_sustain_longer": [(_sig(0), 2, t) for t in (0.0, 4.9, 5.0)],
    "band_max": [(_sig(500), 4, t) for t in (0.0, 3.0)],
    "band_min": [(_sig(0), 1, t) for t in (0.0, 6.0)],
    "noisy_hot_never_flaps": [(_sig(500 if i % 2 == 0 else 50), 2, i * 0.5)
                              for i in range(100)],
    "noisy_idle_never_flaps": [(_sig(5 if i % 2 else 50), 2, i * 2.0)
                               for i in range(40)],
    "hysteresis_resets_both": [(_sig(500), 1, 0.0), (_sig(50), 1, 1.0),
                               (_sig(500), 1, 2.5), (_sig(500), 1, 4.5)],
    "cooldown_after_action": [(_sig(500), 1, 0.0), (_sig(500), 1, 2.0),
                              ("record", 2.5), (_sig(500), 2, 3.0),
                              (_sig(500), 2, 6.0), (_sig(500), 2, 7.0)],
    "no_data_is_cold": [(_sig(), 2, 0.0), (_sig(p99=0.9), 2, 1.0),
                        (_sig(), 2, 7.0)],
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_autoscaler_policy_decides_as_the_jax_package(case):
    runs = []
    for cls in (AutoscalerPolicy, JPolicy):
        p = cls(1, 4, **_POLICY_KW)
        out = []
        for step in _CASES[case]:
            if step[0] == "record":
                p.record_action(step[1])
                continue
            sig, live, now = step
            out.append((p.observe(sig, live=live, now=now),
                        p.last_reason, p.is_hot(sig), p.is_cold(sig)))
        runs.append(out)
    assert runs[0] == runs[1]
    assert any(d for d, *_ in runs[0]) == (case in (
        "scale_out_sustained", "p99_alone_is_hot", "idle_sustain_longer",
        "hysteresis_resets_both", "cooldown_after_action"))


def test_autoscaler_policy_refuses_what_the_jax_package_refuses():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"backlog_low": 100, "backlog_high": 50},
               {"p99_high_s": 1.0, "p99_low_s": 2.0}):
        for cls in (AutoscalerPolicy, JPolicy):
            with pytest.raises(ValueError):
                cls(**kw)


# ---------------------------------------------------------------------------
# the wire, the router: either package's through either package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router_in,replica_in", [("port", "jax"),
                                                  ("jax", "port")])
def test_either_router_serves_through_either_packages_replica(
        router_in, replica_in):
    """A registry-leased replica of one package behind the other
    package's ReplicaRouter: greedy streams equal token for token to the
    JAX package's in-process server on the same weights."""
    reqs = _requests()
    want = _want(reqs)
    router = (ReplicaRouter if router_in == "port" else JRouter)(
        desired=4, refresh_s=0.05)
    if replica_in == "port":
        server = _port_server()
        rep = ReplicaServer(server, registry_addr=router.registry_addr,
                            ttl_s=1.0)
    else:
        server = _jax_server()
        rep = JReplicaServer(server, registry_addr=router.registry_addr,
                             ttl_s=1.0)
    try:
        deadline = time.monotonic() + 30
        while not router.live_replicas():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert router.live_replicas() == [rep.addr]
        streams = [router.submit(p, m) for p, m in reqs]
        got = [s.result(timeout=120) for s in streams]
        assert got == want
        st = router.stats()
        assert st["requests_ok"] == len(reqs) and st["requests_failed"] == 0
        sig = router.signals(30.0)
        assert sig["replicas_live"] == 1
    finally:
        rep.close()
        server.close()
        router.close()


@pytest.mark.parametrize("client_in", ["port", "jax"])
def test_the_replica_wire_is_the_jax_packages(client_in):
    """Every verb of the port's replica through either package's client
    (and of the JAX replica through the port's): ping, stats, generate
    with `skip`, drain (a retryable refusal while draining), resume,
    flight, a malformed line, an unknown op."""
    call, stream = (replica_call, replica_stream) if client_in == "port" \
        else (jcall, jstream)
    prompt, want = [1, 2, 3, 4], _want([([1, 2, 3, 4], 8)])[0]
    for server in (_port_server(), _jax_server()):
        rep = (ReplicaServer if isinstance(server, GenerationServer)
               else JReplicaServer)(server)
        try:
            ping = call(rep.addr, {"op": "ping"})
            assert ping == {"ok": True, "outstanding": 0,
                            "free_blocks": 24, "draining": False,
                            "warm_start": False}
            st = call(rep.addr, {"op": "stats"})["stats"]
            assert st["kv_blocks_total"] == 24 and not st["warm_start"]
            assert list(stream(rep.addr, {"op": "generate",
                                          "prompt": prompt,
                                          "max_new": 8})) == want
            assert list(stream(rep.addr, {"op": "generate",
                                          "prompt": prompt, "max_new": 8,
                                          "skip": 5})) == want[5:]
            if isinstance(server, GenerationServer):
                # the plain version on the CPU: no kernel launch counted
                assert call(rep.addr, {"op": "stats"})["stats"][
                    "paged_attention_launches"] == 0
            ans = call(rep.addr, {"op": "drain", "timeout": 30})
            assert ans == {"ok": True, "drained": True, "draining": True}
            with pytest.raises(RuntimeError) as ei:
                list(stream(rep.addr, {"op": "generate", "prompt": prompt,
                                       "max_new": 4}))
            assert not ei.value.fatal
            assert call(rep.addr, {"op": "resume"}) == {"ok": True}
            assert not call(rep.addr, {"op": "ping"})["draining"]
            dump = call(rep.addr, {"op": "flight"})
            assert dump["ok"] and dump["dump"]["reason"] == "wire"
            assert call(rep.addr, {"op": "nope"}) == {
                "err": "unknown op 'nope'", "fatal": True}
            with socket.create_connection(("127.0.0.1", rep.port),
                                          timeout=10) as s:
                s.sendall(b"not json\n")
                assert json.loads(s.makefile().readline()) == {
                    "err": "malformed request", "fatal": True}
            with pytest.raises(RuntimeError) as ei:     # over capacity
                list(stream(rep.addr, {"op": "generate", "prompt": prompt,
                                       "max_new": 64}))
            assert ei.value.fatal
        finally:
            rep.close()
            server.close()


def test_a_swap_through_the_wire_changes_the_weights(tmp_path):
    reqs = [([1, 2, 3], 8)]
    dec, states = _jax()
    other = {n: (v * 1.5 if v.ndim >= 2 else v) for n, v in states.items()}
    d = jax_save(str(tmp_path / "other"), other, SPEC)
    srv = JServer(dec, other, slots=2, kv_blocks=24, place=fluid.CPUPlace())
    try:
        want_other = srv.generate(*reqs[0], timeout=120)
    finally:
        srv.close()
    server = _port_server()
    rep = ReplicaServer(server)
    try:
        assert jcall(rep.addr, {"op": "swap", "dir": d}) == {"ok": True}
        assert list(jstream(rep.addr, {"op": "generate", "prompt": [1, 2, 3],
                                       "max_new": 8})) == want_other
        assert replica_call(rep.addr, {"op": "stats"})["stats"][
            "hot_swaps"] == 1
    finally:
        rep.close()
        server.close()


def test_an_out_of_vocabulary_prompt_is_refused_alone():
    """A prompt id outside the vocabulary is a caller error (fatal on the
    wire, not retried) and never reaches a tick, so requests batched
    beside it are untouched."""
    want = _want([([1, 2, 3], 8)])[0]
    server = _port_server()
    rep = ReplicaServer(server)
    try:
        with pytest.raises(ValueError, match="vocabulary"):
            server.submit([1, V, 2], 4)
        with pytest.raises(ValueError, match="vocabulary"):
            server.submit([-1, 2], 4)
        ok = server.submit([1, 2, 3], 8)
        with pytest.raises(ReplicaError) as ei:
            list(replica_stream(rep.addr, {"op": "generate",
                                           "prompt": [1, 500, 2],
                                           "max_new": 4}))
        assert ei.value.fatal
        assert ok.result(timeout=120) == want
    finally:
        rep.close()
        server.close()


# ---------------------------------------------------------------------------
# `cli serve`, the banner, the warm-start artifact
# ---------------------------------------------------------------------------


class _FakeProc:
    pid = 1

    def __init__(self, lines):
        self.stdout = iter(lines)

    def poll(self):
        return None


@pytest.mark.parametrize("line,addr", [
    ("serving /tmp/my models/llm on 127.0.0.1:4242, registered in "
     "127.0.0.1:9 (warm start: 1 kernel builds loaded, 0 built, warmup "
     "0.31s)\n", "127.0.0.1:4242"),
    ("serving /data/on call/m on 10.0.0.7:80 (cold start: 1 kernel "
     "builds, 0 loaded, warmup 21.50s)\n", "10.0.0.7:80"),
    ("serving plain on 127.0.0.1:1\n", "127.0.0.1:1")])
def test_the_serve_banner_parses_in_both_autoscalers(line, addr):
    for cls in (ReplicaProcess, JReplicaProcess):
        h = cls.__new__(cls)
        h.proc, h.pid, h.addr = _FakeProc([line]), 1, None
        h._read_banner()
        assert h.addr == addr


def _model_dir(path, **kw):
    from paddle_tpu_torch.serving import save_generation_model

    return save_generation_model(str(path), _jax()[1], SPEC,
                                 place=CPUPlace(), **kw)


def test_cli_serve_replica_is_found_by_the_jax_autoscalers_parse(tmp_path):
    """`python -m paddle_tpu_torch.cli serve` on a warm-start model dir:
    the JAX package's ReplicaProcess reads its address from the banner,
    the replica reports the artifact armed, serves the JAX server's
    tokens, and a SIGTERM drains it and ends it gracefully."""
    d = _model_dir(tmp_path / "m", warm_start=True)
    want = _want([([1, 2, 3], 8)])[0]
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PADDLE_TPU_COMPILATION_CACHE_DIR", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.cli", "serve", d,
         "--use_tpu", "0", "--drain-grace", "5"], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    h = JReplicaProcess(proc)
    try:
        deadline = time.monotonic() + 120
        while h.addr is None:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        ping = jcall(h.addr, {"op": "ping"})
        assert ping["warm_start"] is True
        assert list(jstream(h.addr, {"op": "generate", "prompt": [1, 2, 3],
                                     "max_new": 8})) == want
        h.terminate()
        assert proc.wait(timeout=60) == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def test_a_shipped_artifact_arms_and_the_flag_is_put_back(tmp_path):
    d = _model_dir(tmp_path / "m", warm_start=True)
    cache = os.path.join(d, WARM_START_DIRNAME)
    with open(os.path.join(cache, WARM_START_MANIFEST)) as f:
        manifest = json.load(f)
    # on the CPU the steps launch no CUDA kernel: nothing to build
    assert manifest["sources"] == {} and manifest[
        "compute_capability"] is None
    assert tflags.get_flag("compilation_cache_dir") == ""
    srv = server_from_model_dir(d, place=CPUPlace())
    try:
        assert srv.warm_start_dir == cache
        assert srv.stats()["warm_start"] is True
        assert tflags.get_flag("compilation_cache_dir") == ""
    finally:
        srv.close()
    srv = server_from_model_dir(d, place=CPUPlace(), warm_start=False)
    try:
        assert srv.warm_start_dir is None and not srv.stats()["warm_start"]
    finally:
        srv.close()


def test_a_configured_cache_dir_wins_over_a_shipped_artifact(tmp_path):
    """The JAX package's rules: a shipped artifact arms only when no
    cache dir is configured; an explicit warm_cache_dir always arms; the
    configured value is put back either way."""
    d = _model_dir(tmp_path / "m", warm_start=True)
    tflags.set_flags({"compilation_cache_dir": str(tmp_path / "ops")})
    srv = server_from_model_dir(d, place=CPUPlace())
    try:
        assert srv.warm_start_dir is None
    finally:
        srv.close()
    explicit = str(tmp_path / "explicit")
    seen = {}
    import paddle_tpu_torch.serving.generation as gen

    real = gen.GenerationServer.__init__

    def spy(self, *a, **kw):
        seen["flag"] = tflags.get_flag("compilation_cache_dir")
        real(self, *a, **kw)
    gen.GenerationServer.__init__ = spy
    try:
        srv = server_from_model_dir(d, place=CPUPlace(),
                                    warm_cache_dir=explicit)
    finally:
        gen.GenerationServer.__init__ = real
    try:
        assert srv.warm_start_dir == explicit and seen["flag"] == explicit
    finally:
        srv.close()
    assert tflags.get_flag("compilation_cache_dir") == str(tmp_path / "ops")


@pytest.mark.parametrize("fault", ["capability", "source", "manifest"])
def test_an_artifact_that_does_not_fit_is_not_used(tmp_path, fault):
    d = _model_dir(tmp_path / "m", warm_start=True)
    path = os.path.join(d, WARM_START_DIRNAME, WARM_START_MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    if fault == "capability":
        manifest["compute_capability"] = [9, 0]
    elif fault == "source":
        manifest["sources"] = {"paged_attention.cu": "0" * 16}
    if fault == "manifest":
        os.remove(path)
    else:
        with open(path, "w") as f:
            json.dump(manifest, f)
    with pytest.warns(UserWarning, match="not used"):
        srv = server_from_model_dir(d, place=CPUPlace())
    try:
        assert srv.warm_start_dir is None and not srv.stats()["warm_start"]
        assert tflags.get_flag("compilation_cache_dir") == ""
    finally:
        srv.close()
    # rebuilt, it fits again
    assert build_warm_start_artifact(d, place=CPUPlace()) == os.path.join(
        d, WARM_START_DIRNAME)
    srv = server_from_model_dir(d, place=CPUPlace())
    try:
        assert srv.stats()["warm_start"]
    finally:
        srv.close()


def test_export_builds_copies_a_loaded_library_by_its_key(tmp_path,
                                                          monkeypatch):
    """The artifact's builds: a library this process loaded is copied
    under its key (same source text and flags, same bytes); one it has
    not loaded raises, nvcc or not."""
    from paddle_tpu_torch.kernels import cuda_build

    src, so = cuda_build._target("paged_attention.cu", str(tmp_path / "a"))
    os.makedirs(os.path.dirname(so))
    with open(so, "wb") as f:
        f.write(b"built")
    monkeypatch.setitem(cuda_build._loaded_from, "paged_attention.cu", so)
    out = cuda_build.export_builds(["paged_attention.cu"],
                                   str(tmp_path / "b"))
    key = cuda_build.source_key("paged_attention.cu")
    assert out["paged_attention.cu"].endswith(f"paged_attention-{key}.so")
    with open(out["paged_attention.cu"], "rb") as f:
        assert f.read() == b"built"
    monkeypatch.delitem(cuda_build._loaded_from, "flash_attention.cu",
                        raising=False)
    with pytest.raises(RuntimeError, match="loaded no build"):
        cuda_build.export_builds(["flash_attention.cu"],
                                 str(tmp_path / "c"))
    assert not os.listdir(tmp_path / "c")
    tflags.set_flags({"compilation_cache_dir": str(tmp_path / "d")})
    assert cuda_build.build_dir() == str(tmp_path / "d")
    tflags.reset_flags()
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


# ---------------------------------------------------------------------------
# the autoscaler over an in-process fleet
# ---------------------------------------------------------------------------


class _FakeHandle:
    """An in-process replica standing for a spawned process."""

    _pids = iter(range(10_000, 20_000))

    def __init__(self, registry_addr):
        self.pid = next(self._pids)
        self.server = _port_server()
        self.rep = ReplicaServer(self.server, registry_addr=registry_addr,
                                 ttl_s=1.0)
        self.addr = self.rep.addr

    def alive(self):
        return not self.rep._stop.is_set()

    def terminate(self):
        self.rep.shutdown_gracefully(10)
        self.server.close()

    def kill(self):
        # a SIGKILL: sockets die, heartbeats stop, nothing deregisters
        self.rep._lease._stop.set()
        self.rep._lease.released = True
        self.rep._stop.set()
        try:
            self.rep._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.rep._sock.close()
        self.server.close()

    def wait(self, timeout=None):
        return 0


class _FakeLauncher:
    def __init__(self, registry_addr):
        self.registry_addr = registry_addr
        self.spawned = []

    def spawn(self):
        h = _FakeHandle(self.registry_addr)
        self.spawned.append(h)
        return h


def test_the_autoscaler_scales_out_and_in_with_zero_failed():
    """Sustained backlog grows the in-process fleet, idleness retires a
    replica by drain, a replica killed mid-stream is resumed on a
    survivor: every request completes with the JAX server's tokens."""
    req = ([1, 2, 3], 16)
    want = _want([req])[0]
    router = ReplicaRouter(desired=8, refresh_s=0.05)
    launcher = _FakeLauncher(router.registry_addr)
    policy = AutoscalerPolicy(1, 3, p99_high_s=60.0, backlog_high=60,
                              backlog_low=5, sustain_s=0.2,
                              idle_sustain_s=0.5, cooldown_s=0.2)
    scaler = Autoscaler(router, launcher, policy, poll_s=0.05,
                        window_s=5.0, drain_grace_s=15.0)
    streams, stop = [], threading.Event()
    try:
        assert scaler.ensure_min(timeout_s=60) == 1

        def feeder():
            while not stop.is_set():
                if sum(not s.done for s in streams) < 10:
                    streams.append(router.submit(*req))
                time.sleep(0.002)
        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while len(router.live_replicas(include_draining=False)) < 2:
            assert time.monotonic() < deadline, scaler.events
            scaler.poll()
            time.sleep(0.02)
        # a SIGKILL mid-stream: the router resumes on the survivor
        busiest = max(launcher.spawned,
                      key=lambda h: router.stats()["replicas"].get(h.addr,
                                                                   0))
        busiest.kill()
        time.sleep(0.3)
        stop.set()
        t.join(timeout=5)
        for s in list(streams):
            assert s.result(timeout=120) == want
        assert router.stats()["requests_failed"] == 0
        deadline = time.monotonic() + 60
        while (len(router.live_replicas()) != 1
               or not any("scale-in complete" in e
                          for e in scaler.events)):
            assert time.monotonic() < deadline, scaler.events
            scaler.poll()
            if len(router.live_replicas()) == 1 and not any(
                    "scale-in complete" in e for e in scaler.events):
                # one survivor: grow once more so idleness retires one
                streams.extend(router.submit(*req) for _ in range(12))
            time.sleep(0.02)
        for s in list(streams):
            assert s.result(timeout=120) == want
        assert scaler.status()["crashloops"] == 0
        assert router.stats()["draining"] == []
    finally:
        stop.set()
        scaler.close()
        for h in launcher.spawned:
            if h.alive():
                h.kill()
        router.close()


def _fleet(launcher_cls=_FakeLauncher, **scaler_kw):
    router = ReplicaRouter(desired=8, refresh_s=0.05)
    launcher = launcher_cls(router.registry_addr)
    policy = AutoscalerPolicy(1, 3, p99_high_s=60.0, backlog_high=60,
                              backlog_low=5, sustain_s=0.2,
                              idle_sustain_s=0.5, cooldown_s=0.2)
    scaler_kw.setdefault("poll_s", 0.05)
    scaler_kw.setdefault("window_s", 5.0)
    scaler_kw.setdefault("drain_grace_s", 15.0)
    return router, launcher, Autoscaler(router, launcher, policy,
                                        **scaler_kw)


def _teardown(router, launcher, scaler):
    from paddle_tpu_torch.core.resilience import fault_injector

    fault_injector().clear()
    scaler.close()
    for h in getattr(launcher, "spawned", []):
        if h.alive():
            h.kill()
    router.close()


def _two_live(router, launcher, scaler):
    scaler.ensure_min(timeout_s=60)
    launcher.spawn()                      # a second replica, adopted
    deadline = time.monotonic() + 30
    while len(router.live_replicas()) < 2:
        assert time.monotonic() < deadline
        scaler.poll()
        time.sleep(0.02)


def test_a_raced_sigkill_aborts_the_scale_in_and_keeps_the_floor(
        monkeypatch):
    """tests/test_autoscaler.py's at-least-one-replica pin on the port:
    the last survivor dies between the victim's drain and its retire;
    the victim is resumed, never retired, and still serves."""
    import paddle_tpu_torch.cloud.autoscaler as asc

    router, launcher, scaler = _fleet()
    try:
        _two_live(router, launcher, scaler)
        real_call, state = asc.replica_call, {"killed": False}

        def racing_call(addr, obj, **kw):
            out = real_call(addr, obj, **kw)
            if obj.get("op") == "drain" and not state["killed"]:
                state["killed"] = True
                next(h for h in launcher.spawned
                     if h.addr != addr and h.alive()).kill()
            return out
        monkeypatch.setattr(asc, "replica_call", racing_call)
        victim = scaler._pick_victim(
            router.live_replicas(include_draining=False))
        assert not scaler._scale_in(time.monotonic(),
                                    router.live_replicas())
        assert state["killed"]
        assert any("aborted" in e for e in scaler.events)
        deadline = time.monotonic() + 15
        while router.live_replicas(include_draining=False) != [victim]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert not replica_call(victim, {"op": "ping"})["draining"]
        assert router.generate([1, 2, 3], 4, timeout=60)
    finally:
        _teardown(router, launcher, scaler)


def test_poll_restores_the_floor_after_a_death_outside_a_scale_in():
    router, launcher, scaler = _fleet()
    try:
        scaler.ensure_min(timeout_s=60)
        victim = launcher.spawned[0]
        victim.kill()
        deadline = time.monotonic() + 30
        while True:
            scaler.poll()
            live = router.live_replicas(include_draining=False)
            if live and victim.addr not in live:
                break
            assert time.monotonic() < deadline, scaler.events
            time.sleep(0.05)
        assert any("below min_replicas" in e for e in scaler.events)
        assert router.generate([1, 2, 3], 4, timeout=60)
    finally:
        _teardown(router, launcher, scaler)


@pytest.mark.parametrize("fault", ["drain_times_out", "injected_drain",
                                   "injected_spawn"])
def test_a_failed_scale_action_aborts_cleanly(monkeypatch, fault):
    """A drain that times out (`drained: false`) or an injected fault at
    the chaos sites autoscaler.drain / autoscaler.spawn: a counted,
    clean abort; nothing retired, no drain mark left, nothing
    half-spawned."""
    import paddle_tpu_torch.cloud.autoscaler as asc
    from paddle_tpu_torch.core.resilience import fault_injector

    router, launcher, scaler = _fleet()
    try:
        if fault == "injected_spawn":
            scaler.ensure_min(timeout_s=60)
            fault_injector().inject("autoscaler.spawn", "error", nth=1)
            assert not scaler._spawn(time.monotonic(), reason="chaos")
            assert scaler.status()["crash_streak"] == 1
            assert len(router.live_replicas()) == 1
            return
        _two_live(router, launcher, scaler)
        if fault == "drain_times_out":
            real_call = asc.replica_call

            def timing_out_call(addr, obj, **kw):
                if obj.get("op") == "drain":
                    real_call(addr, obj, **kw)
                    return {"ok": True, "drained": False}
                return real_call(addr, obj, **kw)
            monkeypatch.setattr(asc, "replica_call", timing_out_call)
        else:
            fault_injector().inject("autoscaler.drain", "error", nth=1)
        assert not scaler._scale_in(time.monotonic(),
                                    router.live_replicas())
        assert len(router.live_replicas()) == 2
        assert router.stats()["draining"] == []
        for addr in router.live_replicas():
            assert not replica_call(addr, {"op": "ping"})["draining"]
    finally:
        _teardown(router, launcher, scaler)


class _DyingLauncher:
    """Every spawn is dead at once: the crash-loop shape."""

    def __init__(self, registry_addr):
        self.registry_addr = registry_addr

    class DeadHandle:
        pid, addr = 0, None

        def alive(self):
            return False

        def kill(self):
            pass

        def terminate(self):
            pass

        def wait(self, timeout=None):
            return 1

    def spawn(self):
        return self.DeadHandle()


def test_a_crash_loop_backs_off_and_counts():
    router, launcher, scaler = _fleet(launcher_cls=_DyingLauncher,
                                      crash_loop_limit=3,
                                      crash_backoff_s=30.0)
    try:
        now = 100.0
        for i in range(3):
            assert scaler._spawn(now + i, reason="test")
            scaler._check_pending(now + i + 0.01)
        st = scaler.status()
        assert st["crash_streak"] == 3 and st["crashloops"] == 1
        assert any("CRASH LOOP" in e for e in scaler.events)
        before = len(scaler.events)
        assert scaler.poll(now=scaler._backoff_until - 1.0) == 0
        assert len(scaler.events) == before
        scaler._spawn_failed(now + 10, "again")
        assert scaler.status()["crashloops"] == 2
    finally:
        _teardown(router, launcher, scaler)


# ---------------------------------------------------------------------------
# the subprocess fleet through a ramp and a SIGKILL (slow)
# ---------------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.slow
def test_a_subprocess_fleet_ramps_through_a_sigkill_with_zero_failed(
        tmp_path):
    """`cli serve` subprocess replicas behind the port's router and
    autoscaler: a ramp grows the fleet, the busiest replica is SIGKILLed
    once two serve, the fleet shrinks back to one; zero failed requests,
    every stream the JAX server's, the replicas warm-started."""
    d = _model_dir(tmp_path / "m", warm_start=True)
    router = ReplicaRouter(desired=8, refresh_s=0.1)
    policy = AutoscalerPolicy(1, 3, p99_high_s=30.0, backlog_high=64,
                              backlog_low=6, sustain_s=0.8,
                              idle_sustain_s=3.0, cooldown_s=3.0)
    env = dict(os.environ, PYTHONPATH=REPO,
               PADDLE_TPU_FAULTS="serving.decode:delay:1:1000000000:0.02")
    env.pop("PADDLE_TPU_COMPILATION_CACHE_DIR", None)
    launcher = SubprocessReplicaLauncher(d, router.registry_addr,
                                         use_gpu=0, ttl_s=1.5,
                                         drain_grace_s=30.0, env=env)
    scaler = Autoscaler(router, launcher, policy, poll_s=0.2, window_s=8.0,
                        spawn_timeout_s=300.0, drain_grace_s=30.0)
    reqs = _requests(seed=7, n=200)
    streams, killed = [], {}
    try:
        scaler.ensure_min(timeout_s=300)
        scaler.start()
        for phase, (rate, secs) in enumerate(((4.0, 4.0), (20.0, 8.0),
                                              (1.0, 10.0))):
            t0 = time.monotonic()
            while time.monotonic() - t0 < secs:
                streams.append((len(streams),
                                router.submit(*reqs[len(streams)])))
                owned = scaler.owned_pids()
                if phase >= 1 and len(owned) >= 2 and not killed:
                    load = router.stats()["replicas"]
                    addr = max(owned, key=lambda a: load.get(a, 0))
                    killed[addr] = owned[addr]
                    os.kill(owned[addr], signal.SIGKILL)
                time.sleep(1.0 / rate)
        deadline = time.monotonic() + 90
        while len(router.live_replicas(include_draining=False)) > 1:
            assert time.monotonic() < deadline, scaler.events
            time.sleep(0.2)
        want = _want([reqs[i] for i, _ in streams])
        assert [s.result(timeout=300) for _, s in streams] == want
        assert killed, scaler.events
        assert router.stats()["requests_failed"] == 0
        assert scaler.status()["crashloops"] == 0
        st = replica_call(router.live_replicas()[0], {"op": "stats"})[
            "stats"]
        assert st["warm_start"] and st["recompiles_after_warmup"] == 0
    finally:
        scaler.close(retire_owned=True)
        router.close()
