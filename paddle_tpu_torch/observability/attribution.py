"""Time attribution: phase breakdowns, why-tables, stragglers, drift.

The fleet telemetry plane can say THAT a latency objective regressed;
this layer says WHERE the time went and WHO is slow:

  * **Phase instrumentation** — :func:`phase(kind, name)` wraps one
    phase of a serving tick (admit / prefill / decode / draft_verify /
    sample / deliver / kv_alloc / kv_release), a training iteration
    (feed_pack / h2d / compute / send_round / barrier_wait / get) or a
    pserver round (optimize / recv / barrier) in a labeled child span
    PLUS an observation into the per-kind
    ``paddle_tpu_<kind>_phase_seconds{phase=...}`` histogram family.
    Cost: one no-op context manager when both metrics and tracing are
    off; two perf_counter reads + a cached-child observe when on.
  * **Why-table** — :func:`why_rows` (live TimeSeriesStore) /
    :func:`why_rows_from_parsed` (a federated Prometheus dump) compute
    the fleet "where does the time go" table behind ``cli why``: per
    (kind, member, phase) seconds-of-phase-per-second and its share of
    the member's attributed time.
  * **Straggler detection** — :func:`straggler_scores` z-scores each
    endpoint's windowed mean of
    ``paddle_tpu_comm_endpoint_round_seconds`` against its PEERS
    (leave-one-out, sigma floored at 10% of the peer mean so two
    healthy endpoints never read as mutual stragglers), published by
    the collector as the SLO-able ``paddle_tpu_comm_straggler_score``
    gauge and surfaced in ``cli top``.
  * **Calibration drift** — member processes publish the cost model's static
    roofline floor per phase (``*_phase_static_seconds`` gauges via
    :func:`publish_static_floor`); :func:`calibration_ratios` bands
    measured phase time against it and the collector republishes
    ``paddle_tpu_calibration_ratio{kind,member,phase}`` for burn-rate
    alerting (tools/slo.json pins the static_vs_measured band).

The collector calls :func:`run_detectors` after every scrape pass.
See docs/observability.md "Time attribution".
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as metrics_mod
from . import tracing

__all__ = [
    "KINDS",
    "PHASES",
    "PHASE_BUCKETS",
    "phase",
    "observe_phase",
    "phase_family",
    "publish_static_floor",
    "why_rows",
    "why_rows_from_parsed",
    "format_why_table",
    "straggler_scores",
    "calibration_ratios",
    "run_detectors",
    "pick_exemplar",
]

# the attributed member kinds and their canonical phase vocabularies —
# docs/observability.md "Time attribution" mirrors these tables; adding
# a phase needs only a new phase() call site, the label carries it
KINDS = ("generation", "trainer", "pserver")

PHASES: Dict[str, Tuple[str, ...]] = {
    "generation": ("admit", "prefill", "decode", "draft_verify",
                   "sample", "deliver", "kv_alloc", "kv_release"),
    "trainer": ("feed_pack", "h2d", "compute", "send_round",
                "barrier_wait", "get"),
    "pserver": ("optimize", "recv", "barrier"),
}

# phases run from tens of µs (KV alloc) to seconds (a cold compile in
# the compute phase): a wider, finer ladder than the request-latency
# default (50 µs .. ~26 s doubling)
PHASE_BUCKETS: Tuple[float, ...] = tuple(
    0.00005 * 2 ** i for i in range(20))


def phase_family(kind: str) -> metrics_mod.Histogram:
    return metrics_mod.histogram(
        f"paddle_tpu_{kind}_phase_seconds",
        f"seconds spent per {kind} phase",
        labelnames=("phase",), buckets=PHASE_BUCKETS)


def _static_family(kind: str) -> metrics_mod.Gauge:
    return metrics_mod.gauge(
        f"paddle_tpu_{kind}_phase_static_seconds",
        "static roofline floor (seconds) for the phase",
        labelnames=("phase",))


# child cache keyed on family identity: registry().clear() in tests
# mints a new family, and observing into an orphaned child would make
# phase data silently vanish for the rest of the process
_children: Dict[Tuple[str, str], Tuple[object, object]] = {}


def observe_phase(kind: str, name: str, seconds: float) -> None:
    """Record one phase duration into the kind's histogram family (a
    no-op when metrics are disabled)."""
    if not metrics_mod.enabled():
        return
    key = (kind, name)
    fam = phase_family(kind)
    hit = _children.get(key)
    if hit is None or hit[0] is not fam:
        hit = (fam, fam.labels(phase=name))
        _children[key] = hit
    hit[1].observe(seconds)


class _NoopCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _PhaseCtx:
    __slots__ = ("_kind", "_name", "_span_cm", "_span", "_t0")

    def __init__(self, kind: str, name: str):
        self._kind = kind
        self._name = name

    def __enter__(self):
        self._span_cm = tracing.span(f"{self._kind}.phase.{self._name}")
        self._span = self._span_cm.__enter__()
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if exc_type is not None and self._span is not None:
            # an error attr makes the tail sampler keep the trace
            self._span.set_attr("error", exc_type.__name__)
        self._span_cm.__exit__(exc_type, exc, tb)
        observe_phase(self._kind, self._name, dt)
        return False


def phase(kind: str, name: str):
    """Context manager attributing the block to (kind, phase): a child
    span named ``<kind>.phase.<name>`` under the active trace plus an
    observation into ``paddle_tpu_<kind>_phase_seconds``.  One boolean
    test and a shared no-op when the whole observability stack is off —
    safe on per-tick hot paths."""
    if not (metrics_mod.enabled() or tracing.enabled()
            or tracing._listeners):
        return _NOOP
    return _PhaseCtx(kind, name)


def publish_static_floor(kind: str,
                         floors: Dict[str, float]) -> None:
    """Export the static roofline floor (seconds) per phase as
    ``paddle_tpu_<kind>_phase_static_seconds{phase=...}`` gauges —
    the calibration detector's denominator.  No-op when metrics are
    off or a floor is non-positive (no model, no band)."""
    if not metrics_mod.enabled():
        return
    fam = _static_family(kind)
    for p, v in floors.items():
        if v and v > 0:
            fam.labels(phase=p).set(float(v))


# ---------------------------------------------------------------------------
# the why-table ("where does the time go")
# ---------------------------------------------------------------------------


def _with_shares(rows: List[dict], seconds_key: str) -> List[dict]:
    totals: Dict[Tuple[str, str], float] = {}
    for r in rows:
        k = (r["kind"], r["member"])
        totals[k] = totals.get(k, 0.0) + max(r[seconds_key], 0.0)
    for r in rows:
        t = totals[(r["kind"], r["member"])]
        r["share"] = (max(r[seconds_key], 0.0) / t) if t > 0 else 0.0
    rows.sort(key=lambda r: (r["kind"], r["member"], -r["share"]))
    return rows


def why_rows(series, kind: Optional[str] = None,
             window_s: float = 60.0,
             now: Optional[float] = None) -> List[dict]:
    """Per (kind, member, phase) attribution over a live fleet
    TimeSeriesStore: ``seconds_per_s`` (windowed rate of the phase
    histogram's _sum — seconds of phase time per wall second),
    ``mean_s``, ``calls_per_s`` and the phase's ``share`` of the
    member's total attributed time."""
    rows: List[dict] = []
    for k in (KINDS if kind is None else (kind,)):
        name = f"paddle_tpu_{k}_phase_seconds"
        members = series.label_values(name, "member") or [""]
        for m in members:
            base = {"member": m} if m else {}
            for p in series.label_values(name, "phase",
                                         base or None):
                lbl = {**base, "phase": p}
                sr = series.sum_rate(name, window_s, lbl, now)
                if sr is None:
                    continue
                mean = series.mean(name, window_s, lbl, now)
                rate = series.rate(name, window_s, lbl, now)
                rows.append({
                    "kind": k, "member": m or "-", "phase": p,
                    "seconds_per_s": sr,
                    "mean_s": mean if mean == mean else 0.0,
                    "calls_per_s": rate or 0.0,
                })
    return _with_shares(rows, "seconds_per_s")


def why_rows_from_parsed(parsed: Dict[str, dict],
                         kind: Optional[str] = None) -> List[dict]:
    """The why-table from a PARSED Prometheus dump (a federated file or
    one process's exit dump) — lifetime totals instead of windowed
    rates, so it works on a single snapshot with no history."""
    rows: List[dict] = []
    for k in (KINDS if kind is None else (kind,)):
        fam = parsed.get(f"paddle_tpu_{k}_phase_seconds")
        if not fam or fam.get("type") != "histogram":
            continue
        for s in fam["samples"]:
            v = s["value"]
            rows.append({
                "kind": k,
                "member": s["labels"].get("member", "-"),
                "phase": s["labels"].get("phase", "?"),
                "seconds": v["sum"],
                "count": v["count"],
                "mean_s": (v["sum"] / v["count"]) if v["count"] else 0.0,
            })
    return _with_shares(rows, "seconds")


def format_why_table(rows: List[dict]) -> str:
    """Render why-rows as the ``cli why`` table."""
    if not rows:
        return ("no phase data — run with PADDLE_TPU_METRICS=on and "
                "phase instrumentation armed")
    live = "seconds_per_s" in rows[0]
    head = ["kind", "member", "phase", "share",
            "sec/s" if live else "seconds",
            "mean", "calls/s" if live else "count"]
    table: List[List[str]] = [head]
    for r in rows:
        table.append([
            r["kind"], r["member"], r["phase"],
            f"{r['share'] * 100:5.1f}%",
            (f"{r['seconds_per_s']:.4f}" if live
             else f"{r['seconds']:.4f}"),
            f"{r['mean_s'] * 1000:.3f}ms",
            (f"{r['calls_per_s']:.1f}" if live
             else str(r["count"])),
        ])
    widths = [max(len(row[i]) for row in table)
              for i in range(len(head))]
    out = []
    for i, row in enumerate(table):
        out.append("  ".join(c.ljust(w)
                             for c, w in zip(row, widths)).rstrip())
        if i == 0:
            out.append("  ".join("-" * w for w in widths))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# straggler detection (comm endpoints)
# ---------------------------------------------------------------------------

ENDPOINT_ROUND_METRIC = "paddle_tpu_comm_endpoint_round_seconds"
STRAGGLER_METRIC = "paddle_tpu_comm_straggler_score"
CALIBRATION_METRIC = "paddle_tpu_calibration_ratio"


def straggler_scores(series, name: str = ENDPOINT_ROUND_METRIC,
                     window_s: float = 60.0,
                     now: Optional[float] = None) -> Dict[str, float]:
    """Per-endpoint straggler z-score: how many (floored) standard
    deviations an endpoint's windowed mean round time sits ABOVE its
    peers' (leave-one-out).  Sigma is floored at 10% of the peer mean —
    near-identical healthy peers must not amplify µs jitter into a
    flag.  Negative drift (faster than peers) clamps to 0: only slow
    is a straggler."""
    means: Dict[str, float] = {}
    for ep in series.label_values(name, "endpoint"):
        m = series.mean(name, window_s, {"endpoint": ep}, now)
        if m == m:  # not NaN
            means[ep] = m
    if len(means) < 2:
        return {}
    out: Dict[str, float] = {}
    for ep, v in means.items():
        peers = [x for e, x in means.items() if e != ep]
        mu = sum(peers) / len(peers)
        var = sum((x - mu) ** 2 for x in peers) / len(peers)
        sigma = max(math.sqrt(var), 0.1 * abs(mu), 1e-9)
        out[ep] = max(0.0, (v - mu) / sigma)
    return out


# ---------------------------------------------------------------------------
# calibration drift (static roofline vs measured)
# ---------------------------------------------------------------------------


def calibration_ratios(series, window_s: float = 120.0,
                       now: Optional[float] = None) -> List[dict]:
    """measured/static per (kind, member, phase): the windowed mean of
    the phase histogram over the member's published static roofline
    floor.  >1 means production is slower than the model predicts
    (expected — the floor ignores overheads); a drifting ratio is the
    alert signal, banded by tools/slo.json."""
    out: List[dict] = []
    for k in KINDS:
        sname = f"paddle_tpu_{k}_phase_static_seconds"
        mname = f"paddle_tpu_{k}_phase_seconds"
        members = series.label_values(sname, "member") or [""]
        for m in members:
            base = {"member": m} if m else {}
            for p in series.label_values(sname, "phase",
                                         base or None):
                static = series.latest(sname, {**base, "phase": p})
                if not static or static <= 0:
                    continue
                measured = series.mean(mname, window_s,
                                       {**base, "phase": p}, now)
                if measured != measured:  # NaN: no observations yet
                    continue
                out.append({"kind": k, "member": m or "-",
                            "phase": p, "static_s": static,
                            "measured_s": measured,
                            "ratio": measured / static})
    return out


def run_detectors(series, window_s: float = 60.0,
                  now: Optional[float] = None) -> Dict[str, dict]:
    """One detector pass over a fleet TimeSeriesStore -> synthetic
    gauge families in the parsed-snapshot shape the collector merges
    into its federation output."""
    synth: Dict[str, dict] = {}
    scores = straggler_scores(series, window_s=window_s, now=now)
    if scores:
        synth[STRAGGLER_METRIC] = {
            "type": "gauge",
            "help": ("z-score of an endpoint's mean round time vs its "
                     "peers (leave-one-out, sigma floored)"),
            "samples": [{"labels": {"endpoint": ep}, "value": v}
                        for ep, v in sorted(scores.items())]}
    ratios = calibration_ratios(series,
                                window_s=max(window_s, 120.0), now=now)
    if ratios:
        synth[CALIBRATION_METRIC] = {
            "type": "gauge",
            "help": ("measured phase seconds / static roofline floor "
                     "(static_vs_measured band)"),
            "samples": [{"labels": {"kind": r["kind"],
                                    "member": r["member"],
                                    "phase": r["phase"]},
                         "value": r["ratio"]} for r in ratios]}
    return synth


# ---------------------------------------------------------------------------
# exemplar -> trace resolution (the `cli trace-of` core)
# ---------------------------------------------------------------------------


def pick_exemplar(parsed: Dict[str, dict], metric: str,
                  q: float = 0.99) -> Optional[dict]:
    """From a parsed (federated) dump, pick the exemplar that best
    represents the metric's q-quantile: pool the family's buckets,
    compute the lifetime quantile, and return the freshest exemplar at
    or above it (falling back to the largest-valued one).  Returns
    ``{"trace_id", "value", "ts", "labels", "quantile_s"}`` or None
    when the family has no exemplars."""
    from .metrics import quantile_from_buckets
    from .timeseries import cum_to_per_bucket

    fam = parsed.get(metric)
    if not fam or fam.get("type") != "histogram":
        return None
    les: Optional[List[float]] = None
    agg: Optional[List[float]] = None
    total = 0
    exs: List[Tuple[dict, dict]] = []  # (sample labels, exemplar)
    for s in fam["samples"]:
        v = s["value"]
        for ex in (v.get("exemplars") or {}).values():
            if ex.get("labels", {}).get("trace_id"):
                exs.append((s["labels"], ex))
        ls, counts = cum_to_per_bucket(v["buckets"])
        if not ls:
            continue
        if les is None:
            les, agg = ls, [0.0] * len(counts)
        elif ls != les or len(counts) != len(agg):
            continue  # mismatched member layout: skip from the pool
        for i, c in enumerate(counts):
            agg[i] += c
        total += v["count"]
    if not exs:
        return None
    thr = (quantile_from_buckets(les, agg, total, q)
           if les and total else 0.0)
    qualifying = [(lbl, ex) for lbl, ex in exs
                  if ex.get("value", 0.0) >= thr]
    if qualifying:
        lbl, ex = max(qualifying,
                      key=lambda t: t[1].get("ts") or 0.0)
    else:  # quantile fell between exemplared buckets: take the worst
        lbl, ex = max(exs, key=lambda t: t[1].get("value", 0.0))
    return {"trace_id": ex["labels"]["trace_id"],
            "value": ex.get("value"), "ts": ex.get("ts"),
            "labels": dict(lbl),
            "quantile_s": thr if thr == thr else None}
