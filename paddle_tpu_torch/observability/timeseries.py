"""Bounded in-process time-series history over the metrics registry.

The metrics registry answers "what is the value NOW"; everything the fleet
plane needs — the router's autoscaling signal, `cli top`'s qps column,
SLO burn rates — is a question about a WINDOW: "what was the p99 over
the last 60 s", "how fast is this counter moving".  This module is that
substrate: a :class:`TimeSeriesStore` samples registry counters, gauges
and histogram bucket vectors into per-series ring buffers
(``collections.deque(maxlen=capacity)``) at a configurable period, and
answers window queries without Prometheus:

  * ``rate(name, window_s)`` — counter / histogram-count slope over the
    window (qps, tokens/s), summed across matching label sets;
  * ``quantile(name, q, window_s)`` / ``p99`` / ``p50`` — the TRUE
    windowed quantile from bucket-count deltas between the window's
    edge samples (not the lifetime quantile a raw histogram gives);
  * ``latest(name)`` — most recent value, summed across matches;
  * ``interval_verdicts(...)`` — per-sample-interval good/bad flags,
    the SLO layer's burn-rate input (slo.py).

Series are keyed (name, sorted label items); queries match by label
SUBSET, so ``rate("requests_total", 60, labels={"kind": "pserver"})``
aggregates every member of that kind in a fleet store.  The store can
sample a local :class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry`
(``sample_once`` / the ``start()`` daemon thread) or be fed parsed
remote scrapes by the TelemetryCollector (``ingest*``, collector.py).

Memory is bounded by construction: ``capacity`` points per series, and
``drop(labels)`` reclaims a departed member's series the way
``Metric.remove`` reclaims a closed instance's.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import metrics as metrics_mod
from .metrics import quantile_from_buckets

__all__ = ["TimeSeriesStore", "HistPoint", "cum_to_per_bucket"]


class HistPoint(tuple):
    """One histogram sample: (count, sum, per-bucket counts incl. the
    trailing overflow slot).  A plain tuple subclass so deque storage
    stays compact."""

    __slots__ = ()

    def __new__(cls, count: int, total: float, counts: Sequence[int]):
        return tuple.__new__(cls, (int(count), float(total),
                                   tuple(counts)))

    @property
    def count(self) -> int:
        return self[0]

    @property
    def sum(self) -> float:
        return self[1]

    @property
    def counts(self) -> Tuple[int, ...]:
        return self[2]


def cum_to_per_bucket(buckets) -> Tuple[List[float], List[int]]:
    """Prometheus-exposition cumulative buckets ``[[le, cumulative],
    ...]`` (incl. the +Inf line when present) -> ``(finite les,
    per-bucket counts incl. the trailing overflow slot)`` — the shape
    ingest_histogram and quantile_from_buckets consume.  ONE owner:
    the collector's live ingestion and slo.evaluate_snapshot must
    never disagree about the same dump."""
    les, counts, prev = [], [], 0
    for le, cum in buckets:
        counts.append(int(cum) - prev)
        prev = int(cum)
        if le != float("inf"):
            les.append(le)
    if len(counts) == len(les):  # no explicit +Inf line
        counts.append(0)
    return les, counts


def _labels_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


class _Series:
    __slots__ = ("name", "labels", "kind", "buckets", "points")

    def __init__(self, name: str, labels: dict, kind: str,
                 buckets: Optional[Tuple[float, ...]], capacity: int):
        self.name = name
        self.labels = dict(labels)
        self.kind = kind
        self.buckets = buckets  # finite les only (histograms)
        self.points: deque = deque(maxlen=capacity)


class TimeSeriesStore:
    """Ring-buffered samples of metric series, queryable as windows."""

    def __init__(self, registry: Optional[metrics_mod.MetricsRegistry]
                 = None, period_s: float = 1.0, capacity: int = 720,
                 clock=time.monotonic):
        self._registry = registry  # None = the process registry, late-
        # bound so set-up order does not matter
        self.period_s = float(period_s)
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, tuple], _Series] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- ingestion ----------------------------------------------------------
    def _put(self, name: str, labels: dict, kind: str, ts: float, value,
             buckets: Optional[Tuple[float, ...]] = None) -> None:
        key = (name, _labels_key(labels))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _Series(name, labels, kind, buckets, self.capacity)
                self._series[key] = s
            elif buckets is not None and s.buckets != buckets:
                # a member restarted with different bucket bounds:
                # deltas against the old points would be garbage
                s.buckets = buckets
                s.points.clear()
            s.points.append((float(ts), value))

    def ingest_value(self, name: str, kind: str, labels: dict,
                     value: float, ts: Optional[float] = None) -> None:
        """Record one counter/gauge observation (collector scrape)."""
        self._put(name, labels, kind,
                  self._clock() if ts is None else ts, float(value))

    def ingest_histogram(self, name: str, labels: dict,
                         buckets: Sequence[float],
                         counts: Sequence[int], count: int, total: float,
                         ts: Optional[float] = None) -> None:
        """Record one histogram observation: `buckets` are the finite
        les, `counts` the PER-BUCKET (non-cumulative) counts including
        the trailing overflow slot."""
        self._put(name, labels, "histogram",
                  self._clock() if ts is None else ts,
                  HistPoint(count, total, counts), tuple(buckets))

    def sample_once(self, now: Optional[float] = None) -> int:
        """Sample every series of the registry once; returns the number
        of series touched."""
        reg = self._registry or metrics_mod.registry()
        ts = self._clock() if now is None else now
        n = 0
        for m in reg.metrics():
            for labels, child in m.samples():
                if m.kind == "histogram":
                    _, counts = cum_to_per_bucket(
                        child.cumulative_buckets())
                    self.ingest_histogram(
                        name=m.name, labels=labels, buckets=m.buckets,
                        counts=counts, count=child.count,
                        total=child.sum, ts=ts)
                else:
                    self.ingest_value(m.name, m.kind, labels,
                                      child.value, ts=ts)
                n += 1
        return n

    # -- sampler thread -----------------------------------------------------
    def start(self) -> "TimeSeriesStore":
        """Start the periodic sampler (daemon thread); idempotent."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="paddle-tpu-timeseries")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period_s):
            try:
                self.sample_once()
            except Exception:  # sampling must never kill the host
                pass

    def stop(self):
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.period_s + 5)

    close = stop

    # -- series access ------------------------------------------------------
    def _matching(self, name: str,
                  labels: Optional[dict]) -> List[_Series]:
        want = _labels_key(labels)
        with self._lock:
            return [s for (n, lk), s in self._series.items()
                    if n == name and set(want) <= set(lk)]

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def points(self, name: str, labels: Optional[dict] = None
               ) -> List[Tuple[float, object]]:
        """All retained (ts, value) points of the single series matching
        `labels` exactly-or-by-subset; raises if the subset is
        ambiguous (window math on mixed series would be meaningless)."""
        matches = self._matching(name, labels)
        if not matches:
            return []
        if len(matches) > 1:
            raise ValueError(
                f"{name}: labels {labels or {}} match "
                f"{len(matches)} series; narrow the label set")
        with self._lock:
            return list(matches[0].points)

    def drop(self, labels: dict) -> int:
        """Drop every series whose labels are a superset of `labels`
        (e.g. ``drop({"member": "pserver-0"})`` after its lease
        expires); returns how many were dropped."""
        want = set(_labels_key(labels))
        with self._lock:
            doomed = [k for k in self._series if want <= set(k[1])]
            for k in doomed:
                del self._series[k]
        return len(doomed)

    # -- window queries -----------------------------------------------------
    def _edges(self, s: _Series, window_s: float, now: float):
        """(baseline, last) points for a window ending at `now`: the
        latest point at-or-before the window start (so the delta covers
        the FULL window), else the earliest retained point."""
        with self._lock:  # a sampler thread may be appending
            pts = list(s.points)
        if not pts:
            return None
        start = now - window_s
        base = None
        for p in pts:
            if p[0] <= start:
                base = p
            else:
                break
        if base is None:
            base = pts[0]
        last = pts[-1]
        if last[0] <= base[0] and last is not base:
            return None
        return base, last

    def rate(self, name: str, window_s: float,
             labels: Optional[dict] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second slope over the window, summed across matching
        series.  Counters/gauges use the raw value; histograms the
        observation count (request rate).  None when no series has two
        usable points yet."""
        now = self._clock() if now is None else now
        total, seen = 0.0, False
        for s in self._matching(name, labels):
            edges = self._edges(s, window_s, now)
            if edges is None:
                continue
            (t0, v0), (t1, v1) = edges
            if t1 <= t0:
                continue
            if s.kind == "histogram":
                v0, v1 = v0.count, v1.count
            total += (v1 - v0) / (t1 - t0)
            seen = True
        return total if seen else None

    def sum_rate(self, name: str, window_s: float,
                 labels: Optional[dict] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Per-second slope of a histogram's ``_sum`` over the window,
        summed across matching series — for a ``*_phase_seconds``
        family this is "seconds of phase time per wall second", the
        phase-share signal behind `cli why`.  None when no matching
        histogram series has a usable window yet."""
        now = self._clock() if now is None else now
        total, seen = 0.0, False
        for s in self._matching(name, labels):
            if s.kind != "histogram":
                continue
            edges = self._edges(s, window_s, now)
            if edges is None:
                continue
            (t0, v0), (t1, v1) = edges
            if t1 <= t0:
                continue
            total += (v1.sum - v0.sum) / (t1 - t0)
            seen = True
        return total if seen else None

    def label_values(self, name: str, label: str,
                     labels: Optional[dict] = None) -> List[str]:
        """Distinct values of `label` across the series of `name`
        (optionally restricted to a label subset) — how the attribution
        layer enumerates phases, endpoints and members it should group
        by."""
        out = set()
        for s in self._matching(name, labels):
            v = s.labels.get(label)
            if v is not None:
                out.add(v)
        return sorted(out)

    def latest(self, name: str, labels: Optional[dict] = None
               ) -> Optional[float]:
        """Most recent value summed across matching series (histograms:
        observation count)."""
        total, seen = 0.0, False
        for s in self._matching(name, labels):
            with self._lock:
                pt = s.points[-1] if s.points else None
            if pt is None:
                continue
            v = pt[1]
            total += v.count if s.kind == "histogram" else v
            seen = True
        return total if seen else None

    def quantile(self, name: str, q: float, window_s: float,
                 labels: Optional[dict] = None,
                 now: Optional[float] = None) -> float:
        """Windowed q-quantile: per-bucket count DELTAS between each
        matching series' window edges, summed across series (bucket
        layouts must agree — mismatched members are skipped), then the
        shared interpolation (metrics.quantile_from_buckets).  NaN when
        the window saw no observations."""
        now = self._clock() if now is None else now
        agg: Optional[List[float]] = None
        buckets: Optional[Tuple[float, ...]] = None
        total = 0
        for s in self._matching(name, labels):
            if s.kind != "histogram" or s.buckets is None:
                continue
            edges = self._edges(s, window_s, now)
            if edges is None:
                continue
            (_, v0), (_, v1) = edges
            if v1 is v0:
                # single retained point: everything it counted happened
                # since the store began watching — treat as in-window
                v0 = HistPoint(0, 0.0, [0] * len(v1.counts))
            if buckets is None:
                buckets = s.buckets
                agg = [0.0] * len(v1.counts)
            elif s.buckets != buckets or len(v1.counts) != len(agg):
                continue
            for i, (a, b) in enumerate(zip(v0.counts, v1.counts)):
                agg[i] += max(b - a, 0)
            total += max(v1.count - v0.count, 0)
        if agg is None:
            return float("nan")
        return quantile_from_buckets(buckets, agg, total, q)

    def mean(self, name: str, window_s: float,
             labels: Optional[dict] = None,
             now: Optional[float] = None) -> float:
        """Windowed mean of a histogram: (sum delta) / (count delta)
        between each matching series' window edges, pooled across
        matches.  NaN when the window saw no observations."""
        now = self._clock() if now is None else now
        total_sum = total_count = 0.0
        seen = False
        for s in self._matching(name, labels):
            if s.kind != "histogram":
                continue
            edges = self._edges(s, window_s, now)
            if edges is None:
                continue
            (_, v0), (_, v1) = edges
            if v1 is v0:
                # single retained point: treat its history as
                # in-window, like quantile() does
                total_sum += v1.sum
                total_count += v1.count
            else:
                total_sum += v1.sum - v0.sum
                total_count += v1.count - v0.count
            seen = True
        if not seen or total_count <= 0:
            return float("nan")
        return total_sum / total_count

    def p99(self, name: str, window_s: float,
            labels: Optional[dict] = None,
            now: Optional[float] = None) -> float:
        return self.quantile(name, 0.99, window_s, labels, now)

    def p50(self, name: str, window_s: float,
            labels: Optional[dict] = None,
            now: Optional[float] = None) -> float:
        return self.quantile(name, 0.50, window_s, labels, now)

    def interval_verdicts(self, name: str, window_s: float, check,
                          labels: Optional[dict] = None,
                          now: Optional[float] = None,
                          stat_q: Optional[float] = None,
                          stat_mean: bool = False) -> List[bool]:
        """Per-consecutive-sample-interval verdicts inside the window —
        the SLO burn-rate input.  For each matching series and each
        adjacent point pair in the window, `check(value)` is called
        with the interval's instantaneous statistic: for histograms
        the bucket-delta q-quantile when `stat_q` is given, the
        interval mean (sum delta / count delta) when `stat_mean`, else
        the per-second observation rate; the newer point's value for
        gauges; the per-second slope for counters.  Intervals with no
        signal (no observations in the delta) are skipped.  Verdicts
        from all matching series pool into one list: a fleet-level SLO
        burns when ANY member burns."""
        now = self._clock() if now is None else now
        start = now - window_s
        out: List[bool] = []
        for s in self._matching(name, labels):
            with self._lock:
                pts = [p for p in s.points if p[0] >= start]
            for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                if s.kind == "histogram":
                    if stat_mean:
                        n = v1.count - v0.count
                        if n <= 0:
                            continue  # idle interval: no latency signal
                        stat = (v1.sum - v0.sum) / n
                    elif stat_q is None:
                        # rate semantics, like the counter branch: a
                        # raw count delta would scale the verdict with
                        # the sample period
                        if t1 <= t0:
                            continue
                        stat = (v1.count - v0.count) / (t1 - t0)
                    else:
                        deltas = [max(b - a, 0) for a, b in
                                  zip(v0.counts, v1.counts)]
                        n = max(v1.count - v0.count, 0)
                        if not n:
                            continue  # idle interval: no latency signal
                        stat = quantile_from_buckets(
                            s.buckets, deltas, n, stat_q)
                elif s.kind == "counter":
                    if t1 <= t0:
                        continue
                    stat = (v1 - v0) / (t1 - t0)
                else:
                    stat = v1
                out.append(bool(check(stat)))
        return out
