"""Declarative service-level objectives over the telemetry plane.

An SLO here is one sentence — ``"serving p99 < 0.5s over 60s"`` — that
the fleet either meets or burns.  Objectives evaluate against a
:class:`~paddle_tpu_torch.observability.timeseries.TimeSeriesStore` (a local
process's sampler, or a TelemetryCollector's fleet store) with
**multiwindow burn-rate alerting**: each consecutive-sample interval in
the window gets a good/bad verdict (the windowed p99 of that interval's
bucket deltas, the counter slope, or the gauge value), the violating
fraction is divided by the error budget, and the objective ALERTS only
when the burn rate reaches the alert factor over BOTH the fast window
(`window_s`) and the slow window (`window_s * slow_factor`) — the
standard two-window rule: fast catches a live regression, slow keeps a
single noisy sample from paging anyone.

Spec forms (mix freely in one ``slo.json``):

  * compact grammar — ``"<metric|alias> <stat> <op> <value>[s|ms]
    [over <N>s]"``, e.g. ``"pserver.barrier_wait p99 < 1s"``,
    ``"serving qps > 0.5 over 120s"``;
  * dict — ``{"name", "metric", "stat", "op", "threshold",
    "window_s", "labels", "budget", "slow_factor"}`` (labels filter
    the fleet store, e.g. ``{"kind": "generation"}``).

Stats: ``p50``/``p90``/``p99``/any ``p<q>`` (histogram window
quantiles), ``rate``/``qps`` (counter or histogram-count slope per
second), ``mean`` (windowed sum/count delta), ``value`` (gauge).

Surfaces: ``cli slo --check`` (exit nonzero on violation; live mode
samples a registry/collector, snapshot mode gates a Prometheus dump)
and the SLO column of ``cli top``.  docs/observability.md "Fleet
telemetry" documents the grammar; tools/slo.json is the checked-in
fleet baseline CI enforces.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional

from .metrics import quantile_from_buckets
from .timeseries import TimeSeriesStore, cum_to_per_bucket

__all__ = [
    "SLOSpec",
    "SLOStatus",
    "ALIASES",
    "parse_slo",
    "load_slos",
    "evaluate",
    "evaluate_snapshot",
    "format_slo_table",
    "failed",
]

# short names for the series operators actually write SLOs against —
# the full paddle_tpu_* name is always accepted too
ALIASES = {
    "serving": "paddle_tpu_serving_generation_seconds",
    "serving.request": "paddle_tpu_serving_request_seconds",
    "serving.first_token": "paddle_tpu_serving_first_token_seconds",
    "serving.queue": "paddle_tpu_serving_generation_queue_depth",
    "serving.kv_util": "paddle_tpu_serving_kv_pool_utilization",
    "serving.requests": "paddle_tpu_serving_generation_requests_total",
    "router": "paddle_tpu_serving_router_request_seconds",
    "router.failed": "paddle_tpu_serving_router_requests_total",
    "fleet.replicas": "paddle_tpu_autoscaler_replicas_live",
    "fleet.crashloops": "paddle_tpu_autoscaler_crashloops_total",
    "fleet.spawn": "paddle_tpu_autoscaler_spawn_seconds",
    "pserver.barrier_wait": "paddle_tpu_pserver_barrier_wait_seconds",
    "pserver.optimize": "paddle_tpu_pserver_optimize_seconds",
    "pserver.requests": "paddle_tpu_pserver_requests_total",
    "trainer.step": "paddle_tpu_trainer_step_seconds",
    "trainer.steps": "paddle_tpu_trainer_steps_total",
    # time-attribution plane (observability/attribution.py)
    "serving.phases": "paddle_tpu_generation_phase_seconds",
    "trainer.phases": "paddle_tpu_trainer_phase_seconds",
    "pserver.phases": "paddle_tpu_pserver_phase_seconds",
    "comm.endpoint_round": "paddle_tpu_comm_endpoint_round_seconds",
    "comm.straggler": "paddle_tpu_comm_straggler_score",
    "calibration": "paddle_tpu_calibration_ratio",
}

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

_GRAMMAR = re.compile(
    r"^\s*(?P<metric>\S+)\s+(?P<stat>\S+)\s*"
    r"(?P<op><=|>=|<|>)\s*(?P<value>[0-9.eE+-]+)\s*(?P<unit>ms|s)?"
    r"(?:\s+over\s+(?P<window>[0-9.]+)\s*s)?\s*$")


class SLOSpec:
    """One objective; construct via parse_slo()/load_slos() or directly
    with keyword arguments."""

    def __init__(self, metric: str, stat: str, op: str,
                 threshold: float, window_s: float = 60.0,
                 labels: Optional[Dict[str, str]] = None,
                 name: str = "", budget: float = 0.05,
                 slow_factor: float = 5.0, source: str = ""):
        self.metric = ALIASES.get(metric, metric)
        self.stat = stat.lower()
        if self.stat == "qps":
            self.stat = "rate"
        if op not in _OPS:
            raise ValueError(f"SLO op must be one of {sorted(_OPS)}, "
                             f"got {op!r}")
        if not (self.stat in ("rate", "value", "mean")
                or re.fullmatch(r"p\d{1,2}(\.\d+)?", self.stat)):
            raise ValueError(f"unknown SLO stat {self.stat!r}")
        self.op = op
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.labels = dict(labels or {})
        self.name = name or source or \
            f"{self.metric} {self.stat} {op} {threshold}"
        # budget: tolerated violating fraction of intervals; burn rate
        # = fraction / budget, alerting at burn >= 1 in both windows.
        # 0 means zero tolerance (any bad interval alerts).
        self.budget = float(budget)
        self.slow_factor = float(slow_factor)
        self.source = source

    @property
    def quantile_q(self) -> Optional[float]:
        if self.stat.startswith("p") and self.stat != "value":
            return float(self.stat[1:]) / 100.0
        return None

    def meets(self, value: float) -> bool:
        if value is None or (isinstance(value, float)
                             and math.isnan(value)):
            return True  # no data is not a violation
        return _OPS[self.op](value, self.threshold)

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "stat": self.stat, "op": self.op,
                "threshold": self.threshold, "window_s": self.window_s,
                "labels": self.labels, "budget": self.budget,
                "slow_factor": self.slow_factor}

    def __repr__(self):
        return f"SLOSpec({self.name!r})"


def parse_slo(text: str, **overrides) -> SLOSpec:
    """Parse the compact grammar (module docstring).  A trailing
    ``ms`` unit divides the threshold by 1000; the default window is
    60 s."""
    m = _GRAMMAR.match(text)
    if m is None:
        raise ValueError(
            f"cannot parse SLO {text!r}; expected "
            "'<metric> <stat> <op> <value>[s|ms] [over <N>s]'")
    threshold = float(m.group("value"))
    if m.group("unit") == "ms":
        threshold /= 1000.0
    kw = dict(metric=m.group("metric"), stat=m.group("stat"),
              op=m.group("op"), threshold=threshold,
              window_s=float(m.group("window") or 60.0),
              source=text.strip())
    kw.update(overrides)
    return SLOSpec(**kw)


def load_slos(path: str) -> List[SLOSpec]:
    """Read a spec file: ``{"slos": [<grammar string> | <spec dict>,
    ...]}`` (tools/slo.json is the checked-in example)."""
    with open(path) as f:
        doc = json.load(f)
    entries = doc.get("slos")
    if not isinstance(entries, list) or not entries:
        raise ValueError(
            f"{path}: expected a non-empty 'slos' list "
            "(docs/observability.md 'SLO specs')")
    out = []
    for e in entries:
        if isinstance(e, str):
            out.append(parse_slo(e))
        elif isinstance(e, dict):
            out.append(SLOSpec(**e))
        else:
            raise ValueError(f"{path}: bad slo entry {e!r}")
    return out


class SLOStatus:
    """One spec's evaluation: the windowed stat, the burn rates, and
    the alert verdict."""

    def __init__(self, spec: SLOSpec, value: float, ok: bool,
                 burn_fast: float, burn_slow: float, alerting: bool,
                 no_data: bool):
        self.spec = spec
        self.value = value
        self.ok = ok
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.alerting = alerting
        self.no_data = no_data

    def to_dict(self) -> dict:
        return {"slo": self.spec.name, "value": self.value,
                "ok": self.ok, "burn_fast": self.burn_fast,
                "burn_slow": self.burn_slow,
                "alerting": self.alerting, "no_data": self.no_data}

    def __repr__(self):
        state = "ALERT" if self.alerting else \
            ("no-data" if self.no_data else "ok")
        return f"SLOStatus({self.spec.name!r}: {state})"


def _window_stat(spec: SLOSpec, series: TimeSeriesStore,
                 window_s: float, now: Optional[float]):
    q = spec.quantile_q
    if q is not None:
        return series.quantile(spec.metric, q, window_s,
                               labels=spec.labels, now=now)
    if spec.stat == "rate":
        return series.rate(spec.metric, window_s, labels=spec.labels,
                           now=now)
    if spec.stat == "mean":
        return series.mean(spec.metric, window_s, labels=spec.labels,
                           now=now)
    return series.latest(spec.metric, labels=spec.labels)


def _burn(spec: SLOSpec, series: TimeSeriesStore, window_s: float,
          now: Optional[float]):
    """(burn_rate, n_intervals) over one window."""
    verdicts = series.interval_verdicts(
        spec.metric, window_s,
        check=lambda v: not spec.meets(v),
        labels=spec.labels, now=now, stat_q=spec.quantile_q,
        stat_mean=(spec.stat == "mean"))
    if not verdicts:
        return 0.0, 0
    frac = sum(verdicts) / len(verdicts)
    if spec.budget <= 0:
        return (math.inf if frac > 0 else 0.0), len(verdicts)
    return frac / spec.budget, len(verdicts)


def evaluate(specs: List[SLOSpec], series: TimeSeriesStore,
             now: Optional[float] = None,
             alert_factor: float = 1.0) -> List[SLOStatus]:
    """Evaluate every spec against the store.  `alerting` needs the
    burn rate at/over `alert_factor` in BOTH the fast and the slow
    window; `ok` is the instantaneous fast-window stat vs the
    threshold (what `cli top` shows even before a burn alert)."""
    out = []
    for spec in specs:
        value = _window_stat(spec, series, spec.window_s, now)
        no_data = value is None or (isinstance(value, float)
                                    and math.isnan(value))
        ok = spec.meets(value)
        burn_fast, n_fast = _burn(spec, series, spec.window_s, now)
        burn_slow, n_slow = _burn(
            spec, series, spec.window_s * spec.slow_factor, now)
        alerting = (n_fast > 0 and n_slow > 0
                    and burn_fast >= alert_factor
                    and burn_slow >= alert_factor)
        out.append(SLOStatus(spec, value, ok, burn_fast, burn_slow,
                             alerting, no_data))
    return out


def evaluate_snapshot(specs: List[SLOSpec],
                      families: Dict[str, dict]) -> List[SLOStatus]:
    """Gate a single Prometheus dump (collector federation output or
    any scrape) — no windows, so quantiles/means are lifetime values
    and `rate` cannot be checked (reported as no-data).  The smoke-gate
    mode ``cli slo --check --prom`` uses in CI."""
    out = []
    for spec in specs:
        fam = families.get(spec.metric)
        value: float = float("nan")
        if fam is not None:
            matching = [s for s in fam["samples"]
                        if all(s["labels"].get(k) == v
                               for k, v in spec.labels.items())]
            q = spec.quantile_q
            if q is not None and fam["type"] == "histogram":
                agg: List[float] = []
                buckets: List[float] = []
                total = 0
                for s in matching:
                    les, counts = cum_to_per_bucket(
                        s["value"]["buckets"])
                    if not buckets:
                        buckets, agg = les, [0.0] * len(counts)
                    elif les != buckets or len(counts) != len(agg):
                        continue
                    agg = [a + c for a, c in zip(agg, counts)]
                    total += s["value"]["count"]
                if buckets and total:
                    value = quantile_from_buckets(buckets, agg, total,
                                                  q)
            elif spec.stat == "mean" and fam["type"] == "histogram":
                tot = sum(s["value"]["count"] for s in matching)
                ssum = sum(s["value"]["sum"] for s in matching)
                value = (ssum / tot) if tot else float("nan")
            elif spec.stat == "value" and matching:
                value = sum(float(s["value"]) for s in matching)
            # rate over one snapshot is undefined: stays NaN/no-data
        no_data = isinstance(value, float) and math.isnan(value)
        ok = spec.meets(value)
        out.append(SLOStatus(spec, value, ok, 0.0, 0.0,
                             alerting=not ok, no_data=no_data))
    return out


def format_slo_table(statuses: List[SLOStatus]) -> str:
    rows = []
    for st in statuses:
        if st.no_data:
            state, val = "no-data", "-"
        else:
            state = "ALERT" if st.alerting else \
                ("ok" if st.ok else "burning")
            val = f"{st.value:.6g}"
        burn = (f"{st.burn_fast:.2f}/{st.burn_slow:.2f}"
                if (st.burn_fast or st.burn_slow) else "-")
        rows.append((st.spec.name, val, burn, state))
    name_w = max([len(r[0]) for r in rows] + [3])
    val_w = max([len(r[1]) for r in rows] + [5])
    out = [f"{'SLO':<{name_w}}  {'value':>{val_w}}  "
           f"{'burn f/s':>10}  state"]
    for name, val, burn, state in rows:
        out.append(f"{name:<{name_w}}  {val:>{val_w}}  {burn:>10}  "
                   f"{state}")
    return "\n".join(out)


def failed(statuses: List[SLOStatus]) -> bool:
    """The --check verdict: any alerting objective fails the gate."""
    return any(st.alerting for st in statuses)
