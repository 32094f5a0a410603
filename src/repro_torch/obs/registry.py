"""Unified metrics registry — labeled counters, gauges, P²-backed histograms.

One surface for every number the runtime keeps: `SessionStats` byte
accounting, the fault/duplicate/replay counters previously summed ad hoc by
`engine.fault_summary`, `protocol.HOST_DENSIFY_COUNT`, QoS rung switches,
admission rejections, slot churn. A metric is (name, labels) → instrument:

    reg = MetricsRegistry()
    reg.counter("frames_total", party="client", direction="up").inc()
    reg.gauge("queue_depth").set(5)
    reg.histogram("token_latency_ms").observe(12.5)

Counters only go up; gauges are set; histograms feed the existing
streaming `P2Quantile` estimators (`runtime/metrics.py`) at fixed
quantiles, so a histogram is O(1) memory no matter how many observations —
the same trick `LatencyStats` uses at fleet scale.

`snapshot()` returns a plain nested dict (deterministic key order — safe
to embed in loadgen's seeded reports), `render_text()` a Prometheus-style
text form (`name{k="v"} value`, sorted lines) for periodic dumps during
long runs. Metric names and labels are the reference's (its
`docs/observability.md` catalogs them), so a snapshot of the same
sequence of operations is equal in both packages.

`DEFAULT_REGISTRY` is the process-wide instance; globals with no run
context (the host-densify guard-rail counter in `split/protocol.py`) land
there. Run harnesses (`engine.run_streaming`, `loadgen.run_loadgen`)
build a fresh registry per run so reports stay isolated and
deterministic.

The port's copy of the reference's `obs/registry.py`.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Tuple

from repro_torch.runtime.metrics import P2Quantile

LabelKey = Tuple[Tuple[str, str], ...]

#: default quantiles tracked per histogram (matches `LatencyStats`)
HIST_QS = (0.50, 0.95, 0.99)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count (float increments allowed for bytes)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """A value that can move both ways (queue depth, QoS rung, occupancy)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Streaming distribution: count/sum/min/max plus P² quantile markers.

    Memory is O(len(qs)); `quantile(q)` is exact below 5 observations
    (P² warm-up keeps raw samples) and an estimate after.
    """

    __slots__ = ("_qs", "_p2", "_n", "_sum", "_min", "_max", "_lock")

    def __init__(self, qs: Iterable[float] = HIST_QS):
        self._qs = tuple(qs)
        self._p2 = {q: P2Quantile(q) for q in self._qs}
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._n += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x
            for p2 in self._p2.values():
                p2.add(x)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._n if self._n else float("nan")

    def quantile(self, q: float) -> float:
        return self._p2[q].value()

    def summary(self) -> dict:
        with self._lock:
            out = {"count": self._n, "sum": self._sum}
            if self._n:
                out["min"] = self._min
                out["max"] = self._max
                out["mean"] = self._sum / self._n
            for q in self._qs:
                out[f"p{int(q * 100)}"] = self._p2[q].value()
            return out


class MetricsRegistry:
    """Get-or-create store of labeled instruments.

    A (name, labels) pair always resolves to the same instrument; asking
    for the same name with a different instrument kind is an error (it
    would silently fork the metric).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key -> instrument})
        self._metrics: Dict[str, Tuple[str, Dict[LabelKey, object]]] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, object],
             factory):
        key = _label_key(labels)
        with self._lock:
            entry = self._metrics.get(name)
            if entry is None:
                entry = (kind, {})
                self._metrics[name] = entry
            elif entry[0] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as {entry[0]}, "
                    f"requested as {kind}")
            inst = entry[1].get(key)
            if inst is None:
                inst = factory()
                entry[1][key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, qs: Iterable[float] = HIST_QS,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, lambda: Histogram(qs))

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested dict, deterministic order: name -> [{labels, ...value}]."""
        with self._lock:
            items = [(name, kind, dict(series))
                     for name, (kind, series) in self._metrics.items()]
        out = {}
        for name, kind, series in sorted(items):
            rows = []
            for key in sorted(series):
                inst = series[key]
                row: dict = {"labels": dict(key)} if key else {"labels": {}}
                if kind == "histogram":
                    row.update(inst.summary())
                else:
                    row["value"] = inst.value
                rows.append(row)
            out[name] = {"kind": kind, "series": rows}
        return out

    def render_text(self) -> str:
        """Prometheus-style lines, sorted: `name{k="v",...} value`."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, metric in snap.items():
            for row in metric["series"]:
                base = name
                labels = row["labels"]
                if metric["kind"] == "histogram":
                    for field, val in sorted(row.items()):
                        if field == "labels":
                            continue
                        lines.append(_line(f"{name}_{field}", labels, val))
                else:
                    lines.append(_line(base, labels, row["value"]))
        return "\n".join(lines) + ("\n" if lines else "")


def _line(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


#: process-wide registry for context-free globals (e.g. host-densify);
#: per-run harnesses construct their own instead of using this
DEFAULT_REGISTRY = MetricsRegistry()
