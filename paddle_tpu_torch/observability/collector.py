"""Central telemetry collection: scrape the fleet, federate one dump.

Every process has its own registry and a localhost ``/metrics``
endpoint; a production fleet (trainers, pservers, `cli serve` replicas,
a router) is only legible when those endpoints merge into ONE view.
This module is the collection plane:

  * **announce** — each member process calls
    :func:`announce(registry_addr, kind)`: it starts a localhost
    Prometheus endpoint over its process registry and registers the
    endpoint in the fleet's TTL-lease registry (cloud/registry.py)
    under the shared ``telemetry`` kind, encoded ``kind|host:port``.
    Lease expiry IS member death — the same liveness contract pservers
    and replicas already live by.
  * **TelemetryCollector** — discovers members from the registry,
    scrapes each endpoint on a period, and merges the samples into a
    fleet-level store with ``member``/``kind`` labels: a
    :class:`~paddle_tpu_torch.observability.timeseries.TimeSeriesStore`
    (windowed rate/p99 queries for `cli top`, the SLO layer and the
    router's autoscaler signal) plus a latest-scrape table rendered as
    **Prometheus federation output** (``federation_text()``).  A member
    that dies mid-scrape times out, never wedges the loop, and its
    series are reclaimed (registry delisting, or ``fail_limit``
    consecutive scrape failures).
  * **push path** — ``collector.serve(port)`` exposes the federated
    dump over HTTP (``GET /metrics``) and accepts pushes
    (``POST /push?kind=K&member=M`` with Prometheus text body) from
    short-lived processes that cannot wait to be scraped;
    :func:`push_metrics` is the client half.
  * **trace assembly** — spans already carry wire-propagated trace
    ids; :func:`assemble_traces` joins the per-process Chrome-trace
    files (and flight-recorder dumps) of a trace dir into one Chrome
    trace PER TRACE ID, so a cross-process request reads as a single
    timeline.

See docs/observability.md "Fleet telemetry" for the topology runbook.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from . import exemplars as exemplars_mod
from . import exporters
from . import metrics as metrics_mod
from .exporters import _fmt_labels, _fmt_value
from .timeseries import TimeSeriesStore, cum_to_per_bucket

__all__ = [
    "TELEMETRY_KIND",
    "announce",
    "Announcement",
    "TelemetryCollector",
    "parse_prometheus_text",
    "push_metrics",
    "assemble_traces",
    "merge_traces",
]

# every member publishes under ONE registry kind — the collector's
# discovery is a single LIST, and member kinds ride inside the address
# string, so adding a new process kind needs no registry change
TELEMETRY_KIND = "telemetry"
_DESIRED_SLOTS = 256


def _encode_member(kind: str, addr: str, member: str = "") -> str:
    if "|" in kind or "|" in member:
        raise ValueError("member kind/name cannot contain '|'")
    return f"{kind}|{addr}|{member}" if member else f"{kind}|{addr}"


def _decode_member(index: int, raw: str) -> Tuple[str, str, str]:
    """-> (kind, scrape addr, member id).  Addresses that predate the
    encoding (bare host:port) fall back to kind 'unknown'."""
    parts = raw.split("|")
    if len(parts) == 1:
        return "unknown", parts[0], f"unknown-{index}"
    kind, addr = parts[0], parts[1]
    member = parts[2] if len(parts) > 2 and parts[2] else \
        f"{kind}-{index}"
    return kind, addr, member


class Announcement:
    """A member's live telemetry publication: the localhost endpoint +
    the registry lease keeping it discoverable."""

    def __init__(self, http_server, lease, kind: str, member: str):
        self.http = http_server
        self.lease = lease
        self.kind = kind
        self.member = member

    @property
    def url(self) -> str:
        return self.http.url()

    def close(self):
        if self.lease is not None:
            self.lease.release()
        self.http.close()


def announce(registry_addr: str, kind: str, member: str = "",
             port: int = 0, ttl_s: float = 2.0,
             registry=None, metrics_registry=None) -> Announcement:
    """Publish THIS process's /metrics endpoint in the fleet registry
    so a TelemetryCollector discovers and scrapes it.  `registry_addr`
    is the TTL-lease registry (a ClusterController's
    ``registry_addr``, a router-hosted one, or a standalone
    ``Registry.serve()``); pass an in-process ``registry`` object to
    skip TCP, and ``metrics_registry`` to expose a registry other than
    the process-wide one.  Returns the Announcement — close() on clean
    shutdown (the lease TTL reclaims the slot after a crash)."""
    from ..cloud.registry import Lease, RegistryClient

    srv = exporters.start_http_server(port=port,
                                      registry=metrics_registry)
    try:
        reg = registry if registry is not None \
            else RegistryClient(registry_addr)
        # every announcer pins the same generous slot cap: members may
        # race the collector to the registry, and DESIRE is idempotent
        reg.set_desired(TELEMETRY_KIND, _DESIRED_SLOTS)
        lease = Lease(reg, TELEMETRY_KIND,
                      _encode_member(kind, f"{srv.addr}:{srv.port}",
                                     member),
                      ttl_s=ttl_s)
    except Exception:
        srv.close()  # no half-announced member: endpoint without lease
        raise
    m = member or f"{kind}-{lease.index}"
    return Announcement(srv, lease, kind, m)


_ENV_ANNOUNCE_LOCK = threading.Lock()
_ENV_ANNOUNCEMENT: Optional[Announcement] = None
_ENV_TRIED = False


def maybe_announce(kind: str, member: str = "") -> Optional[Announcement]:
    """Announce once per process when PADDLE_TPU_TELEMETRY_REGISTRY is
    set — the hook trainer/pserver/replica entrypoints call so a fleet
    launched with the env var self-assembles under the collector.  The
    first caller's kind wins (one process, one member)."""
    global _ENV_ANNOUNCEMENT, _ENV_TRIED
    addr = os.environ.get("PADDLE_TPU_TELEMETRY_REGISTRY", "")
    if not addr:
        return None
    with _ENV_ANNOUNCE_LOCK:
        if _ENV_TRIED:
            return _ENV_ANNOUNCEMENT
        _ENV_TRIED = True
        try:
            _ENV_ANNOUNCEMENT = announce(
                addr, kind,
                member or os.environ.get("PADDLE_TPU_TELEMETRY_MEMBER",
                                         ""))
        except Exception as e:
            # telemetry must never block boot — but a member silently
            # missing from every `cli top` needs SOME breadcrumb
            _ENV_ANNOUNCEMENT = None
            logging.getLogger("paddle_tpu_torch.telemetry").warning(
                "telemetry announce to %s failed (%r): this process "
                "will not appear in the fleet view", addr, e)
        return _ENV_ANNOUNCEMENT


# ---------------------------------------------------------------------------
# Prometheus text parsing (the exposition exporters.py produces)
# ---------------------------------------------------------------------------


def _unescape_label(v: str) -> str:
    # left-to-right over escape PAIRS — chained str.replace corrupts
    # values like 'C:\\net' (the collapsed backslash re-matches '\n')
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt,
                                                            c + nxt))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(s: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    i = 0
    while i < len(s):
        eq = s.index("=", i)
        key = s[i:eq].strip().lstrip(",").strip()
        j = eq + 2  # skip ="
        buf = []
        while j < len(s):
            c = s[j]
            if c == "\\" and j + 1 < len(s):
                buf.append(s[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        out[key] = _unescape_label("".join(buf))
        i = j + 1
    return out


def _parse_value(s: str) -> float:
    s = s.strip()
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse Prometheus text exposition back into the registry-snapshot
    shape: ``{name: {"type", "help", "samples": [{"labels", "value"}]}}``
    with histogram families reassembled (value = ``{"buckets": [[le,
    cumulative]...], "sum", "count"}`` plus, when bucket lines carry
    OpenMetrics exemplars, ``"exemplars": {le: parsed exemplar}``).
    Tolerant of unknown types and of series lacking a # TYPE line
    (treated as untyped gauges)."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    raw: List[Tuple[str, Dict[str, str], float, Optional[dict]]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3].strip()
            elif len(parts) >= 4 and parts[1] == "HELP":
                helps[parts[2]] = parts[3]
            continue
        # the exemplar splits off FIRST: its `# {...}` suffix carries
        # braces that would otherwise confuse the label-set scan
        line, ex = exemplars_mod.split_sample_line(line)
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            close = rest.rindex("}")
            labels = _parse_labels(rest[:close])
            value = _parse_value(rest[close + 1:])
        else:
            name, _, v = line.partition(" ")
            labels = {}
            value = _parse_value(v)
        raw.append((name, labels, value, ex))

    out: Dict[str, dict] = {}
    hist_parts: Dict[str, dict] = {}
    hist_names = {n for n, t in types.items() if t == "histogram"}

    def _hist_slot(base: str, labels: Dict[str, str]) -> dict:
        fam = hist_parts.setdefault(base, {})
        key = tuple(sorted((k, v) for k, v in labels.items()
                           if k != "le"))
        return fam.setdefault(key, {"labels": {k: v for k, v in labels.items() if k != "le"},  # noqa: E501
                                    "buckets": [], "sum": 0.0,
                                    "count": 0})

    for name, labels, value, ex in raw:
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    name[: -len(suffix)] in hist_names:
                base = name[: -len(suffix)]
                if suffix == "_bucket":
                    le = _parse_value(labels.get("le", "+Inf"))
                    slot = _hist_slot(base, labels)
                    slot["buckets"].append([le, int(value)])
                    if ex is not None:
                        slot.setdefault("exemplars", {})[le] = ex
                elif suffix == "_sum":
                    _hist_slot(base, labels)["sum"] = value
                else:
                    _hist_slot(base, labels)["count"] = int(value)
                break
        if base is not None:
            continue
        fam = out.setdefault(name, {
            "type": types.get(name, "gauge"),
            "help": helps.get(name, ""), "samples": []})
        fam["samples"].append({"labels": labels, "value": value})

    for base, slots in hist_parts.items():
        fam = out.setdefault(base, {
            "type": "histogram", "help": helps.get(base, ""),
            "samples": []})
        for slot in slots.values():
            slot["buckets"].sort(key=lambda b: b[0])
            value = {"buckets": slot["buckets"],
                     "sum": slot["sum"],
                     "count": slot["count"]}
            if slot.get("exemplars"):
                # keyed by le so federation can re-attach each to its
                # bucket line; absent entirely for exemplar-free dumps
                value["exemplars"] = slot["exemplars"]
            fam["samples"].append({
                "labels": slot["labels"], "value": value})
    return out


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------


class _Member:
    __slots__ = ("member", "kind", "addr", "fails", "up", "last_ts",
                 "parsed")

    def __init__(self, member: str, kind: str, addr: str):
        self.member = member
        self.kind = kind
        self.addr = addr
        self.fails = 0
        self.up = False
        self.last_ts = 0.0
        self.parsed: Dict[str, dict] = {}


class TelemetryCollector:
    """Fleet-level scrape-and-merge over a TTL-lease registry.

    ``registry_addr`` joins an existing registry; ``registry=`` an
    in-process one; neither hosts a fresh Registry over TCP (members
    then announce at ``collector.registry_addr``)."""

    def __init__(self, registry_addr: Optional[str] = None,
                 registry=None, period_s: float = 1.0,
                 scrape_timeout_s: float = 1.0, fail_limit: int = 2,
                 capacity: int = 720):
        self._owned_registry = None
        if registry is None and registry_addr is None:
            from ..cloud.registry import Registry

            self._owned_registry = registry = Registry()
            port = registry.serve(0)
            registry_addr = f"127.0.0.1:{port}"
        elif registry is None:
            from ..cloud.registry import RegistryClient

            registry = RegistryClient(registry_addr)
        self._reg = registry
        self.registry_addr = registry_addr
        try:
            self._reg.set_desired(TELEMETRY_KIND, _DESIRED_SLOTS)
        except Exception:
            pass  # a read-only registry client still discovers
        self.period_s = float(period_s)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.fail_limit = int(fail_limit)
        # the fleet time-series: fed by scrapes/pushes, never
        # self-sampling (its registry would be the COLLECTOR's, not the
        # fleet's)
        self.series = TimeSeriesStore(capacity=capacity,
                                      period_s=period_s)
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http = None
        self.scrapes = 0
        self.scrape_failures = 0
        # detector window: wide enough that a single scrape's lifetime
        # stats already produce a verdict (mean() treats a one-point
        # series as in-window), tight enough to track live drift
        self.detector_window_s = max(60.0, 10 * self.period_s)
        # collector-synthesized families (straggler scores, calibration
        # ratios), parsed-snapshot shaped, merged into federation_text
        self._synth: Dict[str, dict] = {}

    # -- discovery + scrape -------------------------------------------------
    def _discover(self) -> Dict[str, Tuple[str, str]]:
        """member id -> (kind, addr) from the registry (empty on a
        registry hiccup: keep the current table, never wedge)."""
        try:
            listed = self._reg.list(TELEMETRY_KIND)
        except Exception:
            with self._lock:
                return {m.member: (m.kind, m.addr)
                        for m in self._members.values()}
        out = {}
        for idx, rawaddr in listed.items():
            kind, addr, member = _decode_member(idx, rawaddr)
            out[member] = (kind, addr)
        return out

    def _drop_member_locked(self, member: str) -> None:
        self._members.pop(member, None)
        self.series.drop({"member": member})

    def scrape_once(self) -> Dict[str, bool]:
        """Discover + scrape every member once; returns
        {member: scrape_ok}.  All network I/O runs outside the
        collector lock with a per-member timeout — one dying member
        costs at most `scrape_timeout_s`, never the loop."""
        listing = self._discover()
        with self._lock:
            for member, (kind, addr) in listing.items():
                m = self._members.get(member)
                if m is None or m.addr != addr or m.kind != kind:
                    if m is not None:
                        # same member id, new incarnation (a restarted
                        # process can reclaim the lowest free lease
                        # index, and its /metrics port — baked into
                        # addr — changes): the old points must go, or
                        # the new process's reset counters append
                        # after the old high values and every rate()
                        # in the window reads NEGATIVE
                        self.series.drop({"member": member})
                    self._members[member] = _Member(member, kind, addr)
            for member in list(self._members):
                if member not in listing \
                        and self._members[member].addr != "push":
                    # lease expired / released: the member is gone and
                    # so are its series.  Push members never held a
                    # lease — they persist until restarted pushes
                    # replace them
                    self._drop_member_locked(member)
            targets = [m for m in self._members.values()
                       if m.addr != "push"]
        results: Dict[str, bool] = {}
        for m in targets:
            ok = self._scrape_member(m)
            results[m.member] = ok
        self.run_detectors()
        return results

    def run_detectors(self) -> Dict[str, dict]:
        """Recompute the collector-side detectors (comm stragglers,
        static-vs-measured calibration drift) over the fleet series and
        publish their synthetic gauges: ingested into the time-series
        store (SLO-able, `cli top`) and merged into federation_text.
        Runs after every scrape pass; cheap (label scans + window
        means).  Detection must never wedge collection."""
        try:
            from . import attribution

            synth = attribution.run_detectors(
                self.series, window_s=self.detector_window_s)
        except Exception:
            return dict(self._synth)
        with self._lock:
            self._synth = synth
        for name, fam in synth.items():
            for s in fam["samples"]:
                self.series.ingest_value(name, fam["type"],
                                         s["labels"], s["value"])
        return synth

    def _scrape_member(self, m: _Member) -> bool:
        ts = time.monotonic()
        try:
            with urllib.request.urlopen(
                    f"http://{m.addr}/metrics",
                    timeout=self.scrape_timeout_s) as resp:
                text = resp.read().decode()
            parsed = parse_prometheus_text(text)
        except Exception:
            with self._lock:
                self.scrape_failures += 1
                if self._members.get(m.member) is not m:
                    # delisted (or replaced by a new incarnation) while
                    # this scrape was in flight: its series are already
                    # dropped — writing anything back would resurrect a
                    # ghost no future discovery pass can reclaim
                    return False
                m.fails += 1
                m.up = False
                if m.fails >= self.fail_limit:
                    # still lease-listed but unscrapeable (wedged or
                    # firewalled): reclaim its series — a dashboard
                    # must not keep rendering a ghost
                    self.series.drop({"member": m.member})
                    m.parsed = {}
                # member_up goes in AFTER any fail-limit drop: a wedged
                # member must read DOWN in the store, not no-data
                # (no-data passes SLO checks)
                self.series.ingest_value(
                    "paddle_tpu_member_up", "gauge",
                    {"member": m.member, "kind": m.kind}, 0.0)
            return False
        self._ingest(m, parsed, ts)
        return True

    def _ingest(self, m: _Member, parsed: Dict[str, dict],
                ts: float) -> None:
        with self._lock:
            if self._members.get(m.member) is not m:
                # a concurrent discovery pass delisted this member (or
                # replaced it with a new incarnation) after we snapshot
                # our targets: its series were dropped, and ingesting
                # this in-flight scrape would leak them forever
                return
            self.scrapes += 1
            m.fails = 0
            m.up = True
            m.last_ts = ts
            m.parsed = parsed
            extra = {"member": m.member, "kind": m.kind}
            self.series.ingest_value("paddle_tpu_member_up", "gauge",
                                     extra, 1.0, ts=ts)
            for name, fam in parsed.items():
                for s in fam["samples"]:
                    labels = {**s["labels"], **extra}
                    if fam["type"] == "histogram":
                        les, counts = cum_to_per_bucket(
                            s["value"]["buckets"])
                        if not les:
                            continue
                        self.series.ingest_histogram(
                            name, labels, les, counts,
                            s["value"]["count"], s["value"]["sum"],
                            ts=ts)
                    else:
                        self.series.ingest_value(
                            name, fam["type"], labels, s["value"],
                            ts=ts)

    def ingest_push(self, kind: str, member: str, text: str) -> None:
        """The push path: one Prometheus text body from a short-lived
        process that will not live to be scraped."""
        member = member or f"{kind}-push"
        with self._lock:
            m = self._members.get(member)
            if m is None:
                m = self._members[member] = _Member(member, kind,
                                                    "push")
        self._ingest(m, parse_prometheus_text(text), time.monotonic())
        self.run_detectors()

    # -- outputs ------------------------------------------------------------
    def members(self) -> List[dict]:
        with self._lock:
            return [{"member": m.member, "kind": m.kind,
                     "addr": m.addr, "up": m.up, "fails": m.fails}
                    for m in sorted(self._members.values(),
                                    key=lambda m: m.member)]

    def federation_text(self) -> str:
        """The whole fleet's latest scrape as ONE Prometheus text dump,
        every series labeled ``member``/``kind`` — what a real
        Prometheus would produce from a /federate pull."""
        merged: Dict[str, dict] = {}
        with self._lock:
            snapshot = [(m.member, m.kind, dict(m.parsed), m.up)
                        for m in sorted(self._members.values(),
                                        key=lambda m: m.member)]
            synth = {n: {"type": f["type"], "help": f["help"],
                         "samples": [(dict(s["labels"]), s["value"])
                                     for s in f["samples"]]}
                     for n, f in self._synth.items()}
        lines = []
        for member, kind, parsed, up in snapshot:
            for name, fam in parsed.items():
                slot = merged.setdefault(
                    name, {"type": fam["type"], "help": fam["help"],
                           "samples": []})
                for s in fam["samples"]:
                    slot["samples"].append(
                        ({**s["labels"], "member": member,
                          "kind": kind}, s["value"]))
        up_fam = {"type": "gauge",
                  "help": "1 when the member's last scrape succeeded",
                  "samples": [({"member": member, "kind": kind},
                               1.0 if up else 0.0)
                              for member, kind, _, up in snapshot]}
        merged["paddle_tpu_member_up"] = up_fam
        for name, fam in synth.items():
            slot = merged.setdefault(
                name, {"type": fam["type"], "help": fam["help"],
                       "samples": []})
            slot["samples"].extend(fam["samples"])
        for name in sorted(merged):
            fam = merged[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                if fam["type"] == "histogram":
                    exs = value.get("exemplars") or {}
                    for le, cum in value["buckets"]:
                        line = (
                            f"{name}_bucket"
                            f"{_fmt_labels(labels, {'le': _fmt_value(le)})}"  # noqa: E501
                            f" {cum}")
                        if le in exs:
                            # federation preserves member exemplars, so
                            # `cli trace-of` can resolve a fleet-level
                            # p99 straight to a member's trace id
                            line += " " + exemplars_mod.render_exemplar(
                                exs[le])
                        lines.append(line)
                    lines.append(f"{name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(value['sum'])}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} "
                                 f"{value['count']}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def write_federation(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.federation_text())
        return path

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "TelemetryCollector":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="paddle-tpu-collector")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # the scrape loop must survive anything

    def serve(self, port: int = 0, addr: str = "127.0.0.1") -> int:
        """Expose the federated dump + the push endpoint over HTTP:
        GET /metrics (or /federate) and POST /push?kind=K&member=M."""
        import http.server
        import urllib.parse

        coll = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes,
                      ctype: str = "text/plain; version=0.0.4"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib casing)
                path = self.path.split("?")[0]
                if path in ("/metrics", "/federate", "/"):
                    self._send(200, coll.federation_text().encode())
                elif path == "/members":
                    self._send(200,
                               json.dumps(coll.members()).encode(),
                               "application/json")
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path != "/push":
                    self.send_error(404)
                    return
                q = urllib.parse.parse_qs(parsed.query)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n).decode()
                try:
                    coll.ingest_push(q.get("kind", ["push"])[0],
                                     q.get("member", [""])[0], body)
                except Exception as e:
                    self._send(400, f"bad push: {e}".encode())
                    return
                self._send(200, b"ok")

            def log_message(self, *a):
                return

        self._http = http.server.ThreadingHTTPServer((addr, port),
                                                     _Handler)
        httpd = self._http
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="paddle-tpu-collector-http").start()
        return self._http.server_address[1]

    def stop(self):
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.period_s + 5)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self._owned_registry is not None:
            self._owned_registry.close()
            self._owned_registry = None

    close = stop


def push_metrics(collector_url: str, kind: str, member: str = "",
                 registry: Optional[metrics_mod.MetricsRegistry] = None,
                 timeout_s: float = 2.0) -> None:
    """Push this process's registry to a collector's /push endpoint —
    the exit hook for processes too short-lived to be scraped."""
    import urllib.parse

    body = exporters.prometheus_text(registry).encode()
    q = urllib.parse.urlencode({"kind": kind, "member": member})
    req = urllib.request.Request(
        f"{collector_url.rstrip('/')}/push?{q}", data=body,
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        resp.read()


# ---------------------------------------------------------------------------
# cross-process trace assembly
# ---------------------------------------------------------------------------


def _span_to_chrome_event(rec: dict) -> dict:
    return {
        "ph": "X", "cat": "span", "name": rec["name"],
        "ts": rec["ts"] * 1e6, "dur": rec["dur"] * 1e6,
        "pid": rec["pid"], "tid": rec["tid"],
        "args": {"trace_id": rec["trace_id"],
                 "span_id": rec["span_id"],
                 "parent_id": rec["parent_id"], **rec["attrs"]},
    }


def _load_trace_events(trace_dir: str) -> List[dict]:
    events: List[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "trace_*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
            events.extend(payload.get("traceEvents", []))
        except (OSError, ValueError):
            continue  # a torn file from a crashed process
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "flight_*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
            for rec in payload.get("spans", []):
                events.append(_span_to_chrome_event(rec))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return events


def assemble_traces(trace_dir: str, out_dir: Optional[str] = None
                    ) -> Dict[str, str]:
    """Join the per-process trace files of `trace_dir` into ONE Chrome
    trace per trace id: every span whose wire-propagated ``trace_id``
    matches lands in the same file, regardless of which process
    recorded it.  Flight-recorder dumps in the dir contribute their
    span rings too (a SIGKILLed member's last spans join the timeline
    its peers exported).  Returns {trace_id: written path}."""
    out_dir = out_dir or trace_dir
    by_tid: Dict[str, List[dict]] = {}
    for ev in _load_trace_events(trace_dir):
        tid = (ev.get("args") or {}).get("trace_id")
        if tid:
            by_tid.setdefault(tid, []).append(ev)
    os.makedirs(out_dir, exist_ok=True)
    out: Dict[str, str] = {}
    for tid, events in by_tid.items():
        # the same span can appear in both a process's trace export
        # and its flight ring — dedupe on span id
        seen, unique = set(), []
        for ev in events:
            sid = ev["args"].get("span_id")
            if sid in seen:
                continue
            seen.add(sid)
            unique.append(ev)
        unique.sort(key=lambda e: e.get("ts", 0))
        path = os.path.join(out_dir, f"trace_join_{tid}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": unique,
                       "displayTimeUnit": "ms",
                       "otherData": {"trace_id": tid}}, f)
        out[tid] = path
    return out


def merge_traces(trace_dir: str, out_path: str) -> str:
    """All processes' events in one Chrome trace (pids keep the tracks
    apart) — the whole-run view next to assemble_traces' per-request
    files."""
    events = _load_trace_events(trace_dir)
    events.sort(key=lambda e: e.get("ts", 0))
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return out_path
