"""Plane-wide metric registry + the one clock every layer shares.

FeatInsight's headline claims are *observability* claims — feature
computation "taking up to 70% of the overall latency", "millisecond-level"
feature updates — and a serving plane that cannot measure its own
queue-wait / routing / device-compute / freshness split cannot honestly
report either number.  This module is the measurement substrate:

* :class:`Clock` — ONE injectable time source.  ``now()`` /` `now_us()``
  are monotonic (latency spans, scheduler deadlines), ``time()`` is wall
  epoch seconds (registry deploy stamps).  ``BatchScheduler``,
  ``FeatureRegistry``, the router, and every tracer span resolve their
  notion of time through the installed telemetry's clock, so one
  :class:`FakeClock` drives the entire plane deterministically under test.
* :class:`MetricRegistry` — labeled counters / gauges / histograms with a
  **stable snapshot schema** (``snapshot() -> dict``, JSON-safe), a
  Prometheus text-exposition exporter, and a hard per-metric series cap so
  label cardinality cannot grow without bound (the classic metrics-plane
  failure mode).  Histograms keep fixed log-spaced buckets plus a bounded
  reservoir of recent raw values for tail percentiles.
* :class:`Telemetry` — the bundle (clock + metrics + tracer) with a
  process-wide default: ``get_telemetry()`` / ``set_telemetry()`` /
  ``use_telemetry()``.  ``Telemetry(enabled=False)`` is the null plane:
  every record call short-circuits.

A framework-free copy of the reference package's ``repro.obs.telemetry``:
the metric names, labels and units are the same catalog
(``docs/OBSERVABILITY.md``), so one dashboard reads either package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time as _time
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Clock",
    "FakeClock",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "MetricCardinalityError",
    "Telemetry",
    "get_telemetry",
    "set_telemetry",
    "reset_telemetry",
    "use_telemetry",
    "DEFAULT_BUCKETS_S",
]


# ---------------------------------------------------------------------------
# The one clock
# ---------------------------------------------------------------------------


class Clock:
    """The plane's single time source (monotonic + wall).

    ``now()`` (float s) and ``now_us()`` (int µs) are monotonic — spans,
    queue-wait deadlines, latency attribution.  ``time()`` is wall epoch
    seconds — deploy-record stamps.  Subclass / replace with
    :class:`FakeClock` to drive every consumer from one deterministic
    counter.
    """

    def now(self) -> float:
        return _time.perf_counter()

    def now_us(self) -> int:
        return _time.monotonic_ns() // 1_000

    def time(self) -> float:
        return _time.time()


class FakeClock(Clock):
    """Deterministic clock for tests: one counter feeds monotonic AND wall
    time, advanced explicitly (``advance`` seconds / ``tick`` µs)."""

    def __init__(self, start_s: float = 0.0, epoch_s: float = 1_000_000.0):
        self._t = float(start_s)
        self._epoch = float(epoch_s)

    def advance(self, seconds: float) -> "FakeClock":
        if seconds < 0:
            raise ValueError(f"FakeClock cannot rewind ({seconds})")
        self._t += float(seconds)
        return self

    def tick(self, us: int = 1) -> "FakeClock":
        return self.advance(us / 1e6)

    def now(self) -> float:
        return self._t

    def now_us(self) -> int:
        return int(round(self._t * 1e6))

    def time(self) -> float:
        return self._epoch + self._t


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


class MetricCardinalityError(RuntimeError):
    """A metric exceeded its label-series cap — unbounded cardinality is a
    bug in the instrumentation, not a load condition, so fail loudly."""


# log-spaced latency buckets: 10 µs .. 30 s (covers queue waits, device
# compute, compile times, and migration phases in one scheme)
DEFAULT_BUCKETS_S: Tuple[float, ...] = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
    1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0,
)

_RESERVOIR = 512  # recent raw values kept per histogram series (tails)


def _label_values(
    declared: Tuple[str, ...], labels: Dict[str, str], name: str
) -> Tuple[str, ...]:
    if set(labels) != set(declared):
        raise ValueError(
            f"metric {name!r} declared labels {declared}, got "
            f"{tuple(sorted(labels))} — label keys are part of the schema"
        )
    return tuple(str(labels[k]) for k in declared)


@dataclasses.dataclass
class _MetricBase:
    name: str
    help: str
    unit: str
    label_names: Tuple[str, ...]
    max_series: int
    enabled: bool = True

    def __post_init__(self):
        self._series: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _slot(self, labels: Dict[str, str], make):
        key = _label_values(self.label_names, labels, self.name)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series:
                        raise MetricCardinalityError(
                            f"metric {self.name!r} exceeded max_series="
                            f"{self.max_series} (new series {key!r}); "
                            "bound the label domain or raise the cap "
                            "explicitly"
                        )
                    s = make()
                    self._series[key] = s
        return s

    def series_count(self) -> int:
        return len(self._series)

    def _snap_series(self) -> List[Dict]:
        out = []
        for key in sorted(self._series):
            out.append(
                {
                    "labels": dict(zip(self.label_names, key)),
                    **self._snap_one(self._series[key]),
                }
            )
        return out

    def snapshot(self) -> Dict:
        return {
            "type": self.kind,
            "unit": self.unit,
            "help": self.help,
            "labels": list(self.label_names),
            "series": self._snap_series(),
        }


class Counter(_MetricBase):
    kind = "counter"

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if not self.enabled:
            return
        slot = self._slot(labels, lambda: [0.0])
        slot[0] += n

    def inc_along(
        self,
        label: str,
        values: Sequence[str],
        counts: Sequence[float],
        **labels: str,
    ) -> None:
        """Vectorized ``inc``: fold an aligned batch of
        (``label=values[i]``, ``counts[i]``) increments into the series
        that differ only in ``label`` (the remaining labels are fixed) in
        ONE call.  Zero counts are skipped, so hot paths can hand a dense
        histogram (e.g. rows per shard) without a per-series ``inc`` loop
        or series churn for empty buckets."""
        if not self.enabled:
            return
        for v, n in zip(values, counts):
            if n:
                slot = self._slot({**labels, label: str(v)}, lambda: [0.0])
                slot[0] += float(n)

    def value(self, **labels: str) -> float:
        key = _label_values(self.label_names, labels, self.name)
        s = self._series.get(key)
        return float(s[0]) if s is not None else 0.0

    def total(self) -> float:
        return float(sum(s[0] for s in self._series.values()))

    def _snap_one(self, s) -> Dict:
        return {"value": float(s[0])}


class Gauge(_MetricBase):
    kind = "gauge"

    def set(self, v: float, **labels: str) -> None:
        if not self.enabled:
            return
        slot = self._slot(labels, lambda: [0.0])
        slot[0] = float(v)

    def value(self, **labels: str) -> float:
        key = _label_values(self.label_names, labels, self.name)
        s = self._series.get(key)
        return float(s[0]) if s is not None else 0.0

    def _snap_one(self, s) -> Dict:
        return {"value": float(s[0])}


class _HistSeries:
    __slots__ = ("count", "sum", "max", "buckets", "recent")

    def __init__(self, n_bounds: int):
        self.count = 0.0
        self.sum = 0.0
        self.max = 0.0
        self.buckets = [0.0] * (n_bounds + 1)  # +inf overflow bucket
        self.recent: Deque[float] = deque(maxlen=_RESERVOIR)


class Histogram(_MetricBase):
    kind = "histogram"

    def __init__(self, *args, bounds: Sequence[float] = DEFAULT_BUCKETS_S,
                 **kw):
        super().__init__(*args, **kw)
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")

    def observe(self, v: float, n: float = 1.0, **labels: str) -> None:
        """Record ``n`` observations of value ``v`` (``n > 1`` weights a
        whole batch of identical per-row observations, e.g. one ingest
        batch's freshness counted once per row)."""
        if not self.enabled:
            return
        s: _HistSeries = self._slot(
            labels, lambda: _HistSeries(len(self.bounds))
        )
        v = float(v)
        s.count += n
        s.sum += v * n
        if v > s.max:
            s.max = v
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        s.buckets[i] += n
        s.recent.append(v)

    def observe_array(self, values: Iterable[float], **labels: str) -> None:
        for v in values:
            self.observe(float(v), **labels)

    # -- reads ---------------------------------------------------------------

    def _get(self, labels: Dict[str, str]) -> Optional[_HistSeries]:
        key = _label_values(self.label_names, labels, self.name)
        return self._series.get(key)

    def count(self, **labels: str) -> float:
        s = self._get(labels)
        return float(s.count) if s is not None else 0.0

    def sum(self, **labels: str) -> float:
        s = self._get(labels)
        return float(s.sum) if s is not None else 0.0

    def mean(self, **labels: str) -> float:
        s = self._get(labels)
        if s is None or s.count == 0:
            return 0.0
        return s.sum / s.count

    def percentile(self, p: float, **labels: str) -> float:
        """Tail estimate over the bounded reservoir of recent raw values."""
        s = self._get(labels)
        if s is None or not s.recent:
            return 0.0
        vals = sorted(s.recent)
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac

    def _snap_one(self, s: _HistSeries) -> Dict:
        return {
            "count": float(s.count),
            "sum": float(s.sum),
            "max": float(s.max),
            "buckets": [
                [b, float(c)]
                for b, c in zip(list(self.bounds) + ["+Inf"], s.buckets)
            ],
            "p50": self._reservoir_pct(s, 50.0),
            "p95": self._reservoir_pct(s, 95.0),
            "p99": self._reservoir_pct(s, 99.0),
        }

    @staticmethod
    def _reservoir_pct(s: _HistSeries, p: float) -> float:
        if not s.recent:
            return 0.0
        vals = sorted(s.recent)
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac


class MetricRegistry:
    """Get-or-create registry of labeled metrics.

    Re-registration with a different type / unit / label set raises — the
    snapshot schema is a contract, not a convention.  ``max_series``
    bounds per-metric label cardinality (override per metric for known
    wider-but-bounded domains like (scenario, shard)).
    """

    def __init__(self, enabled: bool = True, max_series: int = 256):
        self.enabled = enabled
        self.max_series = max_series
        self._metrics: Dict[str, _MetricBase] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, unit, labels, max_series, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(
                        name, help, unit, tuple(labels),
                        max_series or self.max_series,
                        enabled=self.enabled, **kw,
                    )
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}"
            )
        if m.label_names != tuple(labels) or m.unit != unit:
            raise ValueError(
                f"metric {name!r} re-registered with different schema: "
                f"had (unit={m.unit!r}, labels={m.label_names}), got "
                f"(unit={unit!r}, labels={tuple(labels)})"
            )
        return m

    def counter(
        self, name: str, help: str = "", unit: str = "1",
        labels: Sequence[str] = (), max_series: Optional[int] = None,
    ) -> Counter:
        return self._get(Counter, name, help, unit, labels, max_series)

    def gauge(
        self, name: str, help: str = "", unit: str = "1",
        labels: Sequence[str] = (), max_series: Optional[int] = None,
    ) -> Gauge:
        return self._get(Gauge, name, help, unit, labels, max_series)

    def histogram(
        self, name: str, help: str = "", unit: str = "s",
        labels: Sequence[str] = (), max_series: Optional[int] = None,
        bounds: Sequence[float] = DEFAULT_BUCKETS_S,
    ) -> Histogram:
        return self._get(
            Histogram, name, help, unit, labels, max_series, bounds=bounds
        )

    def metrics(self) -> Dict[str, _MetricBase]:
        return dict(self._metrics)

    def snapshot(self) -> Dict[str, Dict]:
        return {
            name: self._metrics[name].snapshot()
            for name in sorted(self._metrics)
        }

    # -- Prometheus text exposition -----------------------------------------

    @staticmethod
    def _esc(v: str) -> str:
        return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")

    @classmethod
    def _fmt_labels(cls, labels: Dict[str, str], extra: str = "") -> str:
        parts = [f'{k}="{cls._esc(str(v))}"' for k, v in labels.items()]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# HELP {name} {m.help} (unit: {m.unit})")
            lines.append(f"# TYPE {name} {m.kind}")
            snap = m.snapshot()
            for s in snap["series"]:
                lab = s["labels"]
                if m.kind in ("counter", "gauge"):
                    lines.append(
                        f"{name}{self._fmt_labels(lab)} {s['value']:.10g}"
                    )
                else:
                    acc = 0.0
                    for le, c in s["buckets"]:
                        acc += c
                        le_s = "+Inf" if le == "+Inf" else f"{le:.10g}"
                        extra = f'le="{le_s}"'
                        lines.append(
                            f"{name}_bucket{self._fmt_labels(lab, extra)}"
                            f" {acc:.10g}"
                        )
                    lines.append(
                        f"{name}_sum{self._fmt_labels(lab)} {s['sum']:.10g}"
                    )
                    lines.append(
                        f"{name}_count{self._fmt_labels(lab)} {s['count']:.10g}"
                    )
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The bundle + process default
# ---------------------------------------------------------------------------


class Telemetry:
    """Clock + metric registry + tracer, as one installable unit.

    ``enabled=False`` builds the null plane: metrics and spans
    short-circuit (the uninstrumented baseline for the overhead gate).
    """

    SCHEMA_VERSION = 1

    def __init__(
        self,
        clock: Optional[Clock] = None,
        enabled: bool = True,
        max_series: int = 256,
        span_capacity: int = 256,
    ):
        from repro_torch.obs.tracing import Tracer  # cycle-free: tracing imports nothing from here at module top except types

        self.clock = clock if clock is not None else Clock()
        self.enabled = bool(enabled)
        self.metrics = MetricRegistry(
            enabled=self.enabled, max_series=max_series
        )
        self.tracer = Tracer(
            self.clock, registry=self.metrics, capacity=span_capacity,
            enabled=self.enabled,
        )

    def snapshot(self, include_spans: int = 32) -> Dict:
        """The one stable JSON document every exporter renders from."""
        return {
            "schema_version": self.SCHEMA_VERSION,
            "enabled": self.enabled,
            "time_s": self.clock.time(),
            "metrics": self.metrics.snapshot(),
            "spans": [
                s.to_dict() for s in self.tracer.roots()[-include_spans:]
            ],
        }

    def snapshot_json(self, include_spans: int = 32) -> str:
        return json.dumps(self.snapshot(include_spans), indent=2)

    def to_prometheus(self) -> str:
        return self.metrics.to_prometheus()


_DEFAULT: Optional[Telemetry] = None
_DEFAULT_LOCK = threading.Lock()


def get_telemetry() -> Telemetry:
    """The process-wide telemetry every instrumented layer records into."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Telemetry()
    return _DEFAULT


def set_telemetry(t: Telemetry) -> Telemetry:
    """Install ``t`` as the process default; returns the previous one."""
    global _DEFAULT
    prev = get_telemetry()
    _DEFAULT = t
    return prev


def reset_telemetry() -> Telemetry:
    """Fresh default telemetry (fresh metrics, fresh spans, real clock)."""
    return set_telemetry(Telemetry())


class use_telemetry:
    """Context manager installing ``t`` for a scope (tests / benches)."""

    def __init__(self, t: Telemetry):
        self.t = t
        self._prev: Optional[Telemetry] = None

    def __enter__(self) -> Telemetry:
        self._prev = set_telemetry(self.t)
        return self.t

    def __exit__(self, *exc) -> None:
        if self._prev is not None:
            set_telemetry(self._prev)
