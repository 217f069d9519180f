"""The port's fleet telemetry plane against the JAX package's.

The same seeded inputs go through both packages' modules: the Prometheus
exposition and its parser (escapes, exemplars), the windowed
TimeSeriesStore, the SLO layer (the grammar, `evaluate`,
`evaluate_snapshot`, the table), the fleet readers of time attribution
(why tables, straggler scores, calibration ratios, exemplar picking),
the Chrome-trace join of a trace dir and the CLI's `metrics`, `slo`,
`why` and `trace-of` on one dump.  Each collector scrapes the other
package's member over the shared wire (the registry, the text format).

Tolerance: none.  Both sides run the same float64 arithmetic in the same
order on the same values, so every rate, quantile, burn rate, share and
score is compared for equality (NaN equal to NaN, through JSON), and
every text byte for byte.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu import cli as jcli
from paddle_tpu.cloud.registry import Registry as JRegistry
from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import collector as jcoll
from paddle_tpu.observability import exemplars as jex
from paddle_tpu.observability import exporters as jexp
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
from paddle_tpu.observability import timeseries as jts
from paddle_tpu.observability import tracing as jtracing

from paddle_tpu_torch import cli as tcli
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.cloud.registry import Registry as TRegistry
from paddle_tpu_torch.observability import attribution as tattr
from paddle_tpu_torch.observability import collector as tcoll
from paddle_tpu_torch.observability import exemplars as tex
from paddle_tpu_torch.observability import exporters as texp
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import slo as tslo
from paddle_tpu_torch.observability import timeseries as tts
from paddle_tpu_torch.observability import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO_SPEC = os.path.join(REPO, "tools", "slo.json")

# one module of each package per role: (metrics, tracing, exemplars,
# exporters, collector, timeseries, slo, attribution)
JAX = (jmetrics, jtracing, jex, jexp, jcoll, jts, jslo, jattr)
PORT = (tmetrics, ttracing, tex, texp, tcoll, tts, tslo, tattr)


def _same(a, b):
    assert json.dumps(a, sort_keys=True, default=repr) == json.dumps(
        b, sort_keys=True, default=repr)


@pytest.fixture(autouse=True)
def _quiet_observability():
    for metrics, tracing, ex, *_ in (JAX, PORT):
        metrics.set_enabled(False)
        tracing.set_enabled(False)
        tracing.clear()
        ex.set_armed(False)
    yield
    for metrics, tracing, ex, *_ in (JAX, PORT):
        metrics.set_enabled(False)
        tracing.set_enabled(False)
        tracing.clear()
        ex.set_armed(False)


# ---------------------------------------------------------------------------
# the exposition and its parser
# ---------------------------------------------------------------------------

_WEIRD = ('plain', 'a"b', 'C:\\net', 'q\\ny', 'line\nbreak', '\\', 'ünï')


def _populate(pkg, reg, seed, with_exemplars=False):
    """Seeded counters, gauges and histograms (escaped label values) in
    `reg`; with exemplars, every histogram observation runs under a
    span, so the buckets carry trace ids."""
    metrics, tracing = pkg[0], pkg[1]
    rng = np.random.RandomState(seed)
    c = metrics.counter("paddle_tpu_fleet_requests_total", "requests",
                        ("path", "code"), registry=reg)
    g = metrics.gauge("paddle_tpu_fleet_queue_depth", "depth", ("path",),
                      registry=reg)
    h = metrics.histogram("paddle_tpu_fleet_request_seconds", "latency",
                          ("path",), buckets=(0.001, 0.01, 0.1, 1.0, 10.0),
                          registry=reg)
    for i in range(40):
        path = _WEIRD[rng.randint(len(_WEIRD))]
        c.labels(path=path, code=str(200 + 100 * rng.randint(4))).inc(
            int(rng.randint(1, 5)))
        g.labels(path=path).set(float(rng.randint(0, 64)))
        v = float(rng.lognormal(-3.0, 2.0))
        if with_exemplars:
            with tracing.span("fleet.request", i=i):
                h.labels(path=path).observe(v)
        else:
            h.labels(path=path).observe(v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_is_the_jax_packages(seed):
    """The same seeded series render the same exposition text."""
    texts = []
    for pkg in (JAX, PORT):
        metrics, exporters = pkg[0], pkg[3]
        metrics.set_enabled(True)
        reg = metrics.MetricsRegistry()
        _populate(pkg, reg, seed)
        texts.append(exporters.prometheus_text(reg))
    assert texts[0] == texts[1]
    assert 'path="a\\"b"' in texts[1] and 'path="line\\nbreak"' in texts[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_prometheus_text_gives_the_jax_packages_dicts(seed):
    """One exposition with escapes and exemplars (the port's, then the
    JAX package's) parses to equal dicts in both packages."""
    for pkg in (PORT, JAX):
        metrics, tracing, ex, exporters = pkg[:4]
        metrics.set_enabled(True)
        tracing.set_enabled(True)
        ex.set_armed(True)
        reg = metrics.MetricsRegistry()
        _populate(pkg, reg, seed, with_exemplars=True)
        text = exporters.prometheus_text(reg)
        assert " # {trace_id=" in text
        got = tcoll.parse_prometheus_text(text)
        want = jcoll.parse_prometheus_text(text)
        _same(got, want)
        hist = got["paddle_tpu_fleet_request_seconds"]["samples"]
        assert any(s["value"].get("exemplars") for s in hist)
        labels = {s["labels"]["path"]
                  for s in got["paddle_tpu_fleet_requests_total"]["samples"]}
        assert labels <= set(_WEIRD)


# ---------------------------------------------------------------------------
# the time-series store, the SLO layer
# ---------------------------------------------------------------------------

_BUCKETS = [0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


def _stores(seed, n=40):
    """Both packages' stores fed the same seeded stream (ts 0.5 s apart):
    a counter, a gauge and a latency histogram for three members of two
    kinds -> (jax store, port store, the last ts)."""
    rng = np.random.RandomState(seed)
    stores = (jts.TimeSeriesStore(clock=lambda: 0.0),
              tts.TimeSeriesStore(clock=lambda: 0.0))
    members = (("gen-0", "generation"), ("gen-1", "generation"),
               ("ps-0", "pserver"))
    cum = {m: [0] * (len(_BUCKETS) + 1) for m, _ in members}
    total = {m: 0.0 for m, _ in members}
    reqs = {m: 0 for m, _ in members}
    ts = 0.0
    for step in range(n):
        ts = step * 0.5
        slow = step > n // 2            # a regression in the second half
        for m, kind in members:
            lbl = {"member": m, "kind": kind}
            k = int(rng.randint(0, 12))
            reqs[m] += k
            for _ in range(k):
                v = float(rng.lognormal(-2.0 + 2.0 * slow, 1.0))
                b = int(np.searchsorted(_BUCKETS, v))
                cum[m][b] += 1
                total[m] += v
            depth = float(rng.randint(0, 50))
            for store in stores:
                store.ingest_value("paddle_tpu_serving_generation_"
                                   "requests_total", "counter", lbl,
                                   reqs[m], ts=ts)
                store.ingest_value("paddle_tpu_serving_generation_"
                                   "queue_depth", "gauge", lbl, depth,
                                   ts=ts)
                store.ingest_histogram(
                    "paddle_tpu_serving_generation_seconds", lbl,
                    _BUCKETS, list(cum[m]), sum(cum[m]), total[m], ts=ts)
    return stores[0], stores[1], ts


_SERIES = ("paddle_tpu_serving_generation_requests_total",
           "paddle_tpu_serving_generation_queue_depth",
           "paddle_tpu_serving_generation_seconds")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeseries_store_windows_are_the_jax_packages(seed):
    js, ps, now = _stores(seed)
    for labels in (None, {"kind": "generation"}, {"member": "ps-0"}):
        for window in (2.0, 5.0, 30.0):
            got, want = [], []
            for store, out in ((ps, got), (js, want)):
                out.append(store.rate(_SERIES[0], window, labels, now))
                out.append(store.sum_rate(_SERIES[2], window, labels, now))
                out.append(store.mean(_SERIES[2], window, labels, now))
                out.append(store.p50(_SERIES[2], window, labels, now))
                out.append(store.p99(_SERIES[2], window, labels, now))
                out.append(store.quantile(_SERIES[2], 0.9, window, labels,
                                          now))
                for q, mean in ((0.99, False), (None, True),
                                (None, False)):
                    out.append(store.interval_verdicts(
                        _SERIES[2], window, lambda v: v < 0.3, labels,
                        now, stat_q=q, stat_mean=mean))
                out.append(store.interval_verdicts(
                    _SERIES[1], window, lambda v: v < 40, labels, now))
            _same(got, want)
        for store_pair in ((ps, js),):
            _same(*[s.latest(_SERIES[1], labels) if labels != {
                "kind": "generation"} else s.label_values(
                _SERIES[1], "member", labels) for s in store_pair])
    assert ps.drop({"member": "gen-1"}) == js.drop({"member": "gen-1"})
    _same(ps.series_names(), js.series_names())


def _specs(slo):
    return slo.load_slos(SLO_SPEC) + [
        slo.parse_slo(t) for t in (
            "serving p99 < 0.5s over 10s", "serving p50 < 200ms over 5s",
            "serving.queue value < 40 over 10s",
            "serving.requests qps > 5 over 10s",
            "serving mean < 0.4 over 10s")] + [
        slo.parse_slo("serving p99 < 2s over 10s",
                      labels={"kind": "generation"}, budget=0.5)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_evaluate_and_the_table_are_the_jax_packages(seed):
    js, ps, now = _stores(seed)
    got = tslo.evaluate(_specs(tslo), ps, now=now)
    want = jslo.evaluate(_specs(jslo), js, now=now)
    _same([s.to_dict() for s in got], [s.to_dict() for s in want])
    assert tslo.format_slo_table(got) == jslo.format_slo_table(want)
    assert tslo.failed(got) == jslo.failed(want)
    assert any(s.alerting for s in got)     # the second half regressed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_evaluate_snapshot_is_the_jax_packages(seed):
    for pkg in (JAX, PORT):
        metrics, exporters = pkg[0], pkg[3]
        metrics.set_enabled(True)
        reg = metrics.MetricsRegistry()
        rng = np.random.RandomState(seed)
        h = metrics.histogram("paddle_tpu_serving_generation_seconds", "",
                              ("server",), registry=reg)
        q = metrics.gauge("paddle_tpu_serving_generation_queue_depth", "",
                          ("server",), registry=reg)
        for i in range(200):
            h.labels(server=str(i % 3)).observe(
                float(rng.lognormal(-1.5, 1.2)))
        q.labels(server="0").set(float(rng.randint(0, 80)))
        text = exporters.prometheus_text(reg)
        got = tslo.evaluate_snapshot(_specs(tslo),
                                     tcoll.parse_prometheus_text(text))
        want = jslo.evaluate_snapshot(_specs(jslo),
                                      jcoll.parse_prometheus_text(text))
        _same([s.to_dict() for s in got], [s.to_dict() for s in want])
        assert tslo.format_slo_table(got) == jslo.format_slo_table(want)


# ---------------------------------------------------------------------------
# time attribution's fleet readers
# ---------------------------------------------------------------------------


def _phase_stores(seed, n=30):
    """Both stores fed seeded phase histograms (generation, trainer and
    pserver members), per-endpoint round times (one endpoint slow) and
    static floors."""
    rng = np.random.RandomState(seed)
    stores = (jts.TimeSeriesStore(clock=lambda: 0.0),
              tts.TimeSeriesStore(clock=lambda: 0.0))
    phases = {"generation": ("decode", "prefill", "sample", "admit"),
              "trainer": ("compute", "feed_pack", "send_round"),
              "pserver": ("optimize", "recv")}
    state = {}
    ts = 0.0
    for step in range(n):
        ts = step * 1.0
        for kind, names in phases.items():
            for m in (f"{kind}-0", f"{kind}-1"):
                for p in names:
                    key = (kind, m, p)
                    c, s_ = state.get(key, ([0] * 4, 0.0))
                    k = int(rng.randint(1, 6))
                    for _ in range(k):
                        v = float(rng.lognormal(-4 + len(p) % 3, 0.5))
                        c[int(np.searchsorted([0.01, 0.1, 1.0], v))] += 1
                        s_ += v
                    state[key] = (c, s_)
                    for store in stores:
                        store.ingest_histogram(
                            f"paddle_tpu_{kind}_phase_seconds",
                            {"member": m, "kind": kind, "phase": p},
                            [0.01, 0.1, 1.0], list(c), sum(c), s_, ts=ts)
                    if p in ("decode", "compute", "optimize"):
                        for store in stores:
                            store.ingest_value(
                                f"paddle_tpu_{kind}_phase_static_seconds",
                                "gauge", {"member": m, "kind": kind,
                                          "phase": p}, 1e-3, ts=ts)
        for ep in ("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"):
            key = ("ep", ep)
            c, s_ = state.get(key, ([0] * 3, 0.0))
            v = float(rng.lognormal(-3 + 2 * (ep.endswith("3")), 0.2))
            c[int(np.searchsorted([0.05, 0.5], v))] += 1
            s_ += v
            state[key] = (c, s_)
            for store in stores:
                store.ingest_histogram(
                    "paddle_tpu_comm_endpoint_round_seconds",
                    {"endpoint": ep, "member": "trainer-0"}, [0.05, 0.5],
                    list(c), sum(c), s_, ts=ts)
    return stores[0], stores[1], ts


@pytest.mark.parametrize("seed", [0, 1])
def test_why_rows_stragglers_and_detectors_are_the_jax_packages(seed):
    js, ps, now = _phase_stores(seed)
    for kind in (None, "generation", "trainer", "pserver"):
        got = tattr.why_rows(ps, kind, window_s=20.0, now=now)
        want = jattr.why_rows(js, kind, window_s=20.0, now=now)
        _same(got, want)
        assert tattr.format_why_table(got) == jattr.format_why_table(want)
    _same(tattr.straggler_scores(ps, window_s=20.0, now=now),
          jattr.straggler_scores(js, window_s=20.0, now=now))
    assert max(tattr.straggler_scores(ps, window_s=20.0,
                                      now=now).values()) >= 3.0
    _same(tattr.calibration_ratios(ps, window_s=20.0, now=now),
          jattr.calibration_ratios(js, window_s=20.0, now=now))
    _same(tattr.run_detectors(ps, window_s=20.0, now=now),
          jattr.run_detectors(js, window_s=20.0, now=now))


@pytest.mark.parametrize("seed", [0, 1])
def test_why_from_a_dump_and_the_exemplar_pick_are_the_jax_packages(seed):
    """A federated-style dump (phase histograms with exemplars) read by
    both packages: why_rows_from_parsed, format_why_table,
    pick_exemplar."""
    tmetrics.set_enabled(True)
    ttracing.set_enabled(True)
    tex.set_armed(True)
    reg = tmetrics.MetricsRegistry()
    rng = np.random.RandomState(seed)
    h = tmetrics.histogram("paddle_tpu_generation_phase_seconds", "",
                           ("phase", "member", "kind"), registry=reg)
    lat = tmetrics.histogram("paddle_tpu_serving_router_request_seconds",
                             "", ("router",), registry=reg)
    for i in range(120):
        with ttracing.span("router.request", i=i):
            p = ("decode", "prefill", "sample")[rng.randint(3)]
            h.labels(phase=p, member=f"generation-{i % 2}",
                     kind="generation").observe(
                float(rng.lognormal(-5 + (p == "decode") * 2, 0.4)))
            lat.labels(router="0").observe(float(rng.lognormal(-1, 1)))
    text = texp.prometheus_text(reg)
    tp, jp = tcoll.parse_prometheus_text(text), \
        jcoll.parse_prometheus_text(text)
    for kind in (None, "generation"):
        got = tattr.why_rows_from_parsed(tp, kind)
        _same(got, jattr.why_rows_from_parsed(jp, kind))
        assert tattr.format_why_table(got) == jattr.format_why_table(
            jattr.why_rows_from_parsed(jp, kind))
    assert got[0]["phase"] == "decode"
    for q in (0.5, 0.99):
        name = "paddle_tpu_serving_router_request_seconds"
        ex = tattr.pick_exemplar(tp, name, q=q)
        _same(ex, jattr.pick_exemplar(jp, name, q=q))
        assert ex["trace_id"]


# ---------------------------------------------------------------------------
# the trace join, the profiler's Chrome events
# ---------------------------------------------------------------------------


def _trace_dir(path, seed):
    rng = np.random.RandomState(seed)
    tids = [f"t{i}" for i in range(5)]
    for pid in (100, 200, 300):
        events = []
        for k in range(12):
            tid = tids[rng.randint(len(tids))]
            events.append({"ph": "X", "cat": "span",
                           "name": f"span{pid}.{k}",
                           "ts": float(rng.randint(0, 10 ** 6)),
                           "dur": float(rng.randint(1, 1000)),
                           "pid": pid, "tid": 1,
                           "args": {"trace_id": tid,
                                    "span_id": f"{pid}-{k}",
                                    "parent_id": None}})
        with open(os.path.join(path, f"trace_{pid}.json"), "w") as f:
            json.dump({"traceEvents": events}, f)
    spans = [{"name": f"ring.{k}", "trace_id": tids[rng.randint(5)],
              "span_id": f"r{k}", "parent_id": None,
              "ts": float(rng.randint(0, 10 ** 3)), "dur": 0.5,
              "pid": 400, "tid": 2, "thread": "x", "attrs": {"k": k}}
             for k in range(8)]
    # one span of the ring also in pid 100's export: joined once
    spans.append({"name": "span100.0", "trace_id": "t0",
                  "span_id": "100-0", "parent_id": None, "ts": 1.0,
                  "dur": 0.5, "pid": 100, "tid": 1, "thread": "x",
                  "attrs": {}})
    with open(os.path.join(path, "flight_400.json"), "w") as f:
        json.dump({"spans": spans}, f)


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_and_merge_traces_are_the_jax_packages(tmp_path, seed):
    src = tmp_path / "src"
    src.mkdir()
    _trace_dir(str(src), seed)
    got = tcoll.assemble_traces(str(src), str(tmp_path / "port"))
    want = jcoll.assemble_traces(str(src), str(tmp_path / "jax"))
    assert set(got) == set(want) and got
    for tid in got:
        with open(got[tid]) as f, open(want[tid]) as g:
            assert json.load(f) == json.load(g)
    with open(tcoll.merge_traces(str(src), str(tmp_path / "p.json"))) \
            as f, open(jcoll.merge_traces(str(src),
                                          str(tmp_path / "j.json"))) as g:
        assert json.load(f) == json.load(g)


def test_chrome_trace_events_carry_the_profilers_ranges():
    """chrome_trace_events(include_profiler=True) appends the port
    profiler's per-name ranges as the JAX package does its own."""
    from paddle_tpu import profiler as jprofiler

    durations = {"exe.run": [0.002, 0.003], "feed": [0.0005]}
    for prof in (tprofiler, jprofiler):
        with prof._events_lock:
            saved = dict(prof._events)
            prof._events.clear()
            prof._events.update({k: list(v) for k, v in durations.items()})
        prof.saved = saved
    try:
        got = ttracing.chrome_trace_events(include_profiler=True)
        want = jtracing.chrome_trace_events(include_profiler=True)
        assert got == want and len(got) == 2 + 3
        assert ttracing.chrome_trace_events(include_profiler=False) == []
    finally:
        for prof in (tprofiler, jprofiler):
            with prof._events_lock:
                prof._events.clear()
                prof._events.update(prof.saved)
            del prof.saved


def test_the_metrics_dump_is_written_at_exit(tmp_path):
    """PADDLE_TPU_METRICS_DUMP names the Prometheus text file a process
    writes at exit."""
    dump = tmp_path / "exit.prom"
    code = ("from paddle_tpu_torch.observability import metrics\n"
            "metrics.counter('paddle_tpu_exit_probe_total', '', "
            "always=True).inc(3)\n")
    env = dict(os.environ, PADDLE_TPU_METRICS_DUMP=str(dump),
               PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    parsed = tcoll.parse_prometheus_text(dump.read_text())
    assert parsed["paddle_tpu_exit_probe_total"]["samples"][0][
        "value"] == 3


# ---------------------------------------------------------------------------
# collectors and members across the packages
# ---------------------------------------------------------------------------


def _member_series(pkg, reg, kind):
    metrics = pkg[0]
    metrics.counter("paddle_tpu_pserver_requests_total", "", ("verb",),
                    registry=reg).labels(verb="SEND").inc(9)
    metrics.histogram("paddle_tpu_serving_generation_seconds", "",
                      registry=reg).observe(0.2)


@pytest.mark.parametrize("members_in,collected_by", [
    ("port", "jax"), ("jax", "port")])
def test_either_collector_scrapes_either_packages_member(members_in,
                                                         collected_by):
    member_pkg = PORT if members_in == "port" else JAX
    coll_mod = tcoll if collected_by == "port" else jcoll
    registry = (TRegistry if collected_by == "port" else JRegistry)()
    addr = f"127.0.0.1:{registry.serve(0)}"
    member_pkg[0].set_enabled(True)
    coll = coll_mod.TelemetryCollector(registry_addr=addr, period_s=0.05)
    anns = []
    try:
        for kind in ("pserver", "generation"):
            reg = member_pkg[0].MetricsRegistry()
            _member_series(member_pkg, reg, kind)
            anns.append(member_pkg[4].announce(addr, kind,
                                               member=f"{kind}-x",
                                               metrics_registry=reg))
        res = coll.scrape_once()
        assert res == {"pserver-x": True, "generation-x": True}
        text = coll.federation_text()
        assert ('paddle_tpu_pserver_requests_total{verb="SEND",'
                'member="pserver-x",kind="pserver"} 9') in text
        assert ('paddle_tpu_member_up{member="generation-x",'
                'kind="generation"} 1') in text
        assert sorted(m["kind"] for m in coll.members()) == [
            "generation", "pserver"]
        assert coll.series.latest("paddle_tpu_pserver_requests_total",
                                  {"member": "pserver-x"}) == 9
        # a member that leaves is reclaimed with its series
        anns.pop().close()
        coll.scrape_once()
        assert [m["member"] for m in coll.members()] == ["pserver-x"]
        assert coll.series.label_values(
            "paddle_tpu_serving_generation_seconds", "member") == [
            "pserver-x"]
    finally:
        for ann in anns:
            ann.close()
        coll.close()
        registry.close()


def test_push_and_the_collectors_http_federation():
    tmetrics.set_enabled(True)
    coll = tcoll.TelemetryCollector(period_s=0.05)
    try:
        port = coll.serve(0)
        reg = jmetrics.MetricsRegistry()
        jmetrics.set_enabled(True)
        jmetrics.counter("paddle_tpu_oneshot_total", registry=reg).inc(4)
        # the JAX package's push client into the port's collector
        jcoll.push_metrics(f"http://127.0.0.1:{port}", "trainer",
                           "trainer-push", registry=reg)
        coll.scrape_once()
        assert ('paddle_tpu_oneshot_total{member="trainer-push",'
                'kind="trainer"} 4') in coll.federation_text()
        import urllib.request

        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read()
        assert b"trainer-push" in body
    finally:
        coll.close()


def test_maybe_announce_once_a_process_and_a_failure_only_logs(
        monkeypatch, caplog):
    registry = TRegistry()
    addr = f"127.0.0.1:{registry.serve(0)}"
    monkeypatch.setattr(tcoll, "_ENV_TRIED", False)
    monkeypatch.setattr(tcoll, "_ENV_ANNOUNCEMENT", None)
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY_REGISTRY", raising=False)
    try:
        assert tcoll.maybe_announce("trainer") is None
        assert tcoll._ENV_TRIED is False     # unset: nothing tried
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_REGISTRY", addr)
        ann = tcoll.maybe_announce("trainer")
        assert ann is not None and ann.kind == "trainer"
        assert tcoll.maybe_announce("pserver") is ann  # first kind wins
        listed = list(registry.list(tcoll.TELEMETRY_KIND).values())
        assert [a.split("|")[0] for a in listed] == ["trainer"]
        ann.close()
        monkeypatch.setattr(tcoll, "_ENV_TRIED", False)
        monkeypatch.setattr(tcoll, "_ENV_ANNOUNCEMENT", None)
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_REGISTRY", "127.0.0.1:1")
        monkeypatch.setenv("PADDLE_TPU_REGISTRY_RETRY_MAX_ATTEMPTS", "1")
        with caplog.at_level("WARNING"):
            assert tcoll.maybe_announce("pserver") is None
        assert "will not appear in the fleet view" in caplog.text
    finally:
        registry.close()


# ---------------------------------------------------------------------------
# the CLI's telemetry tools on one dump
# ---------------------------------------------------------------------------


def _fleet_dump(path):
    """A federation dump of a port collector over two port members
    (generation phases and latencies with exemplars, a router) and the
    trace dir their spans were exported to."""
    tmetrics.set_enabled(True)
    ttracing.set_enabled(True)
    tex.set_armed(True)
    rng = np.random.RandomState(5)
    coll = tcoll.TelemetryCollector(period_s=0.05)
    anns = []
    try:
        for kind in ("generation", "router"):
            reg = tmetrics.MetricsRegistry()
            if kind == "generation":
                h = tmetrics.histogram(
                    "paddle_tpu_generation_phase_seconds", "", ("phase",),
                    registry=reg)
                lat = tmetrics.histogram(
                    "paddle_tpu_serving_generation_seconds", "",
                    ("server",), registry=reg)
            else:
                lat = tmetrics.histogram(
                    "paddle_tpu_serving_router_request_seconds", "",
                    ("router",), registry=reg)
            for i in range(60):
                with ttracing.span(f"{kind}.request", i=i):
                    if kind == "generation":
                        for p in ("decode", "sample", "admit"):
                            h.labels(phase=p).observe(float(
                                rng.lognormal(-4 + (p == "decode") * 2,
                                              0.3)))
                        lat.labels(server="0").observe(
                            float(rng.lognormal(-1, 0.5)))
                    else:
                        lat.labels(router="0").observe(
                            float(rng.lognormal(-1, 0.5)))
            anns.append(tcoll.announce(coll.registry_addr, kind,
                                       member=f"{kind}-0",
                                       metrics_registry=reg))
        coll.scrape_once()
        dump = coll.write_federation(str(path / "fleet.prom"))
    finally:
        for ann in anns:
            ann.close()
        coll.close()
    trace_dir = path / "traces"
    ttracing.write_chrome_trace(str(trace_dir / "trace_1.json"))
    return dump, str(trace_dir)


def test_cli_tools_print_the_jax_packages_text_on_one_dump(tmp_path,
                                                           capsys):
    dump, trace_dir = _fleet_dump(tmp_path)
    snap = texp.write_json(str(tmp_path / "snap.json"))
    runs = (["slo", "--spec", SLO_SPEC, "--prom", dump],
            ["why", "--prom", dump],
            ["why", "--kind", "generation", "--prom", dump],
            ["metrics", snap],
            ["trace-of", "--metric", "serving", "--prom", dump,
             "--trace-dir", trace_dir, "--out", str(tmp_path / "j")],
            ["trace-of", "--metric", "router", "--prom", dump])
    for argv in runs:
        outs = []
        for cli in (tcli, jcli):
            rc = {"slo": cli.cmd_slo, "why": cli.cmd_why,
                  "metrics": cli.cmd_metrics,
                  "trace-of": cli.cmd_trace_of}[argv[0]](argv[1:])
            outs.append((rc, capsys.readouterr().out))
        assert outs[0] == outs[1], argv
        assert outs[0][0] == 0, (argv, outs[0][1])
    rc, text = outs[0]
    assert "trace_id" in text
    why = tcli.cmd_why(["--kind", "generation", "--prom", dump])
    rows = capsys.readouterr().out.splitlines()
    assert why == 0 and rows[2].split()[2] == "decode"


def test_cli_top_renders_the_fleet_table(capsys):
    registry = TRegistry()
    addr = f"127.0.0.1:{registry.serve(0)}"
    tmetrics.set_enabled(True)
    anns = []
    try:
        for kind in ("generation", "router"):
            reg = tmetrics.MetricsRegistry()
            tmetrics.gauge("paddle_tpu_serving_generation_queue_depth", "",
                           registry=reg).set(3)
            anns.append(tcoll.announce(addr, kind, member=f"{kind}-0",
                                       metrics_registry=reg))
        assert tcli.cmd_top(["--registry", addr, "--samples", "2",
                             "--period", "0.05"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].split() == ["MEMBER", "KIND", "UP", "QPS", "P50",
                                    "P99", "QUEUE", "KV_UTIL"]
        rows = {ln.split()[0]: ln.split() for ln in lines[1:]}
        assert rows["generation-0"][1:3] == ["generation", "up"]
        assert rows["generation-0"][6] == "3"
        assert rows["router-0"][1] == "router"
    finally:
        for ann in anns:
            ann.close()
        registry.close()


def test_cli_metrics_diff_and_trace(tmp_path, capsys):
    tmetrics.set_enabled(True)
    reg = tmetrics.MetricsRegistry()
    c = tmetrics.counter("steps_total", "", registry=reg)
    g = tmetrics.gauge("depth", registry=reg)
    c.inc(5)
    g.set(2)
    a = texp.write_json(str(tmp_path / "a.json"), reg)
    time.sleep(0.01)
    c.inc(7)
    g.set(9)
    b = texp.write_json(str(tmp_path / "b.json"), reg)
    assert tcli.cmd_metrics(["--diff", a, b]) == 0
    out = capsys.readouterr().out
    assert "steps_total" in out and "+7" in out and "2 -> 9" in out
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "import numpy as np\n"
        "import paddle_tpu_torch as fluid\n"
        "def build():\n"
        "    x = fluid.layers.data(name='x', shape=[4], dtype='float32')\n"
        "    y = fluid.layers.data(name='y', shape=[1], dtype='float32')\n"
        "    pred = fluid.layers.fc(input=x, size=1)\n"
        "    loss = fluid.layers.mean(\n"
        "        fluid.layers.square_error_cost(pred, y))\n"
        "    def reader():\n"
        "        r = np.random.RandomState(0)\n"
        "        while True:\n"
        "            yield {'x': r.rand(8, 4).astype('float32'),\n"
        "                   'y': r.rand(8, 1).astype('float32')}\n"
        "    return {'loss': loss, 'reader': reader}\n")
    out_json = tmp_path / "trace.json"
    assert tcli.cmd_trace([str(cfg), str(out_json), "--steps", "2",
                           "--use_gpu", "0", "--metrics_out",
                           str(tmp_path / "m.json")]) == 0
    events = json.loads(out_json.read_text())["traceEvents"]
    assert sum(e["name"] == "trainer.step" for e in events) == 2
    assert "trace: 2 step(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the collector's robustness (tests/test_fleet_telemetry.py's cases)
# ---------------------------------------------------------------------------


def _port_member(coll, kind, name, value):
    reg = tmetrics.MetricsRegistry()
    tmetrics.gauge(name, "", registry=reg).set(value)
    return tcoll.announce(coll.registry_addr, kind, metrics_registry=reg)


def test_a_member_dying_mid_scrape_neither_wedges_nor_leaks():
    tmetrics.set_enabled(True)
    coll = tcoll.TelemetryCollector(period_s=0.05, scrape_timeout_s=0.3,
                                    fail_limit=2)
    try:
        ann = _port_member(coll, "pserver", "paddle_tpu_pserver_x", 5)
        coll.scrape_once()
        assert coll.series.latest("paddle_tpu_pserver_x",
                                  {"member": ann.member}) == 5
        ann.http.close()          # the endpoint dies, the lease beats on
        t0 = time.monotonic()
        coll.scrape_once()
        coll.scrape_once()
        assert time.monotonic() - t0 < 3.0
        assert coll.series.points("paddle_tpu_pserver_x",
                                  {"member": ann.member}) == []
        m = next(x for x in coll.members() if x["member"] == ann.member)
        assert not m["up"] and m["fails"] >= 2
        ann.lease.release()
        coll.scrape_once()
        assert all(x["member"] != ann.member for x in coll.members())
    finally:
        coll.close()


def test_a_stale_scrape_cannot_resurrect_a_delisted_members_series():
    tmetrics.set_enabled(True)
    coll = tcoll.TelemetryCollector(period_s=0.05, fail_limit=1)
    try:
        ann = _port_member(coll, "pserver", "paddle_tpu_stale_x", 7)
        coll.scrape_once()
        stale = coll._members[ann.member]
        with coll._lock:
            coll._drop_member_locked(ann.member)
        coll._scrape_member(stale)        # the endpoint still answers
        assert coll.series.points("paddle_tpu_stale_x",
                                  {"member": ann.member}) == []
        ann.http.close()
        coll._scrape_member(stale)        # a failed stale scrape
        assert coll.series.points("paddle_tpu_member_up",
                                  {"member": ann.member}) == []
        ann.close()
    finally:
        coll.close()


def test_a_restarted_member_drops_its_old_incarnation():
    tmetrics.set_enabled(True)
    coll = tcoll.TelemetryCollector(period_s=0.05)
    try:
        reg1 = tmetrics.MetricsRegistry()
        tmetrics.counter("paddle_tpu_restart_total",
                         registry=reg1).inc(1000)
        ann1 = tcoll.announce(coll.registry_addr, "pserver",
                              metrics_registry=reg1)
        coll.scrape_once()
        member = ann1.member
        ann1.close()
        reg2 = tmetrics.MetricsRegistry()
        tmetrics.counter("paddle_tpu_restart_total",
                         registry=reg2).inc(5)
        ann2 = tcoll.announce(coll.registry_addr, "pserver",
                              metrics_registry=reg2)
        assert ann2.member == member
        coll.scrape_once()
        time.sleep(0.05)
        coll.scrape_once()
        rate = coll.series.rate("paddle_tpu_restart_total", 60.0,
                                {"member": member})
        assert rate is None or rate >= 0
        assert coll.series.latest("paddle_tpu_restart_total",
                                  {"member": member}) == 5
        ann2.close()
    finally:
        coll.close()


def test_the_routers_windowed_signals_and_their_reclaim():
    from paddle_tpu_torch.cloud.router import ReplicaRouter

    router = ReplicaRouter(desired=2, refresh_s=0.05)
    try:
        store = router.watch(period_s=0.05)
        assert router.watch() is store
        store.sample_once()
        for v in (0.1, 0.2, 0.2, 0.4):
            router._m_latency.observe(v)
            router._m_ok.inc()
        router._m_outstanding.set(17)
        store.sample_once()
        sig = router.signals(window_s=60.0)
        assert sig["replicas_live"] == 0 and sig["outstanding_tokens"] == 17
        assert 0.1 <= sig["p50"] <= 0.4 and sig["p99"] >= sig["p50"]
        assert sig["qps"] is not None and sig["qps"] > 0
    finally:
        router.close()
    fam = tmetrics.registry().get(
        "paddle_tpu_serving_router_request_seconds")
    assert not any(lbl.get("router") == router._rid
                   for lbl, _ in fam.samples())
    with pytest.raises(RuntimeError, match="closed"):
        router.watch()
