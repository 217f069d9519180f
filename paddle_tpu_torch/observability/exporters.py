"""Exporters: Prometheus text format, localhost HTTP endpoint, JSON
snapshot, Chrome-trace JSON.

Formats:
  * **Prometheus text exposition** — ``prometheus_text()`` /
    ``write_prometheus(path)`` render every registered metric with
    `# HELP`/`# TYPE` headers, label sets, and cumulative histogram
    buckets (`_bucket{le=...}` + `_sum` + `_count`), scrape-able by any
    Prometheus-compatible collector.  ``start_http_server(port)`` serves
    the same text at ``http://127.0.0.1:<port>/metrics`` from a daemon
    thread (stdlib http.server — no new dependencies).
  * **JSON snapshot** — ``json_snapshot()`` / ``write_json(path)``: the
    registry's structured dump plus pid/timestamp meta, consumed by
    tests, bench.py and ``python -m paddle_tpu_torch.cli metrics``.
  * **Chrome trace** — ``chrome_trace(path)`` re-exports
    tracing.write_chrome_trace (spans + profiler ranges) for symmetry.

``PADDLE_TPU_METRICS_DUMP=<path>`` auto-writes the Prometheus text file
at process exit, so multi-process runs (trainers + pservers under a
launcher) each drop a scrape-able dump without code changes.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Optional

from . import exemplars as exemplars_mod
from . import metrics as metrics_mod
from . import tracing

__all__ = [
    "prometheus_text",
    "write_prometheus",
    "json_snapshot",
    "write_json",
    "format_metrics_table",
    "start_http_server",
    "chrome_trace",
]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in merged.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(registry: Optional[metrics_mod.MetricsRegistry]
                    = None) -> str:
    """The whole registry in Prometheus text exposition format."""
    reg = registry or metrics_mod.registry()
    lines = []
    for m in reg.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, child in m.samples():
            if m.kind == "histogram":
                # exemplars attach to their bucket line in OpenMetrics
                # syntax (`value # {trace_id="..."} exemplar_value ts`)
                # — absent unless PADDLE_TPU_EXEMPLARS armed them
                exs = child.exemplars()
                for i, (le, n) in enumerate(
                        child.cumulative_buckets()):
                    line = (f"{m.name}_bucket"
                            f"{_fmt_labels(labels, {'le': _fmt_value(le)})}"
                            f" {n}")
                    bucket_exs = exs.get(i)
                    if bucket_exs:
                        line += " " + exemplars_mod.format_exemplar(
                            bucket_exs[-1])
                    lines.append(line)
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{child.count}")
            else:
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str,
                     registry: Optional[metrics_mod.MetricsRegistry]
                     = None) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path


def json_snapshot(registry: Optional[metrics_mod.MetricsRegistry]
                  = None) -> dict:
    reg = registry or metrics_mod.registry()
    return {
        "pid": os.getpid(),
        "time": time.time(),
        "metrics": reg.snapshot(),
    }


def write_json(path: str,
               registry: Optional[metrics_mod.MetricsRegistry]
               = None) -> str:
    import json

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(json_snapshot(registry), f, indent=1)
    return path


def format_metrics_table(snapshot: dict) -> str:
    """Human-readable table from a json_snapshot() dict (the
    ``cli metrics`` renderer).  Histograms render as count/sum/mean;
    counters and gauges as their value."""
    rows = []
    for name, m in sorted(snapshot.get("metrics", {}).items()):
        for s in m["samples"]:
            label = _fmt_labels(s["labels"])
            v = s["value"]
            if m["type"] == "histogram":
                count = v["count"]
                mean = (v["sum"] / count) if count else 0.0
                val = (f"count={count} sum={v['sum']:.6g} "
                       f"mean={mean:.6g}")
            else:
                val = _fmt_value(v)
            rows.append((f"{name}{label}", m["type"], val))
    name_w = max([len(r[0]) for r in rows] + [6])
    out = [f"{'Metric':<{name_w}}  {'Type':<9}  Value"]
    for n, t, v in rows:
        out.append(f"{n:<{name_w}}  {t:<9}  {v}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# HTTP endpoint (optional, localhost-only)
# ---------------------------------------------------------------------------


class PrometheusServer:
    """Tiny localhost /metrics endpoint over the process registry."""

    def __init__(self, port: int = 0, addr: str = "127.0.0.1",
                 registry: Optional[metrics_mod.MetricsRegistry] = None):
        import http.server

        reg = registry

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = prometheus_text(reg).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                return

        self._httpd = http.server.ThreadingHTTPServer((addr, port),
                                                      _Handler)
        self.port = self._httpd.server_address[1]
        self.addr = addr
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="paddle-tpu-metrics-http")
        self._thread.start()

    def url(self) -> str:
        return f"http://{self.addr}:{self.port}/metrics"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(port: int = 0, addr: str = "127.0.0.1",
                      registry: Optional[metrics_mod.MetricsRegistry]
                      = None) -> PrometheusServer:
    return PrometheusServer(port, addr, registry)


def chrome_trace(path: Optional[str] = None,
                 include_profiler: bool = True) -> str:
    """Write the Chrome-trace JSON (spans + profiler ranges); see
    tracing.write_chrome_trace."""
    return tracing.write_chrome_trace(path, include_profiler)


_DUMP_PATH = os.environ.get("PADDLE_TPU_METRICS_DUMP", "")


def _atexit_dump():
    if _DUMP_PATH:
        try:
            write_prometheus(_DUMP_PATH)
        except OSError:
            pass  # exit-time dump is best-effort


atexit.register(_atexit_dump)
