"""Process-wide metrics registry: Counter / Gauge / Histogram with
label sets, thread-safe, renderable to Prometheus exposition text and to
the JSON snapshot behind the apiserver's ``/metrics?format=json`` — the
port's copy of ``kubeflow_tpu/obs/metrics.py``.

  * instruments are get-or-create by name (idempotent; a type conflict
    raises), so call sites can ask for their instrument inline;
  * ``add_collector`` registers a callback run at render time for values
    that live elsewhere (the pull model); ``add_external`` bridges another
    registry's instruments into this one's output (the plane's registry
    shows the process-wide ``kfx_train_*`` families);
  * histograms carry cumulative buckets (``le`` upper bounds + +Inf), a
    running sum and count, and estimate percentiles by linear
    interpolation — the server-reported request p50/p99.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from ..utils.prom import HistogramValue, fmt_le, prom_text

# Default buckets tuned for request latencies in seconds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05, 0.075,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def percentile_from_buckets(buckets: Sequence[Tuple[float, int]],
                            q: float) -> Optional[float]:
    """Estimated q-quantile (0..1) from cumulative histogram buckets
    [(upper_bound, cumulative_count)] with ascending bounds (last may
    be +Inf), by linear interpolation inside the landing bucket; None
    when empty. A +Inf landing clamps to the last finite bound (the
    standard histogram_quantile rule)."""
    total = buckets[-1][1] if buckets else 0
    if not total:
        return None
    target = q * total
    prev_cum, lower = 0, 0.0
    for bound, cum in buckets:
        if cum >= target:
            if math.isinf(bound):
                return lower
            in_bucket = cum - prev_cum
            frac = (target - prev_cum) / in_bucket if in_bucket else 1.0
            return lower + (bound - lower) * frac
        prev_cum = cum
        if not math.isinf(bound):
            lower = bound
    return lower


class _Metric:
    TYPE = ""

    def __init__(self, name: str, help_: str, lock: threading.RLock):
        self.name = name
        self.help = help_
        self._lock = lock


class _ScalarMetric(_Metric):
    """Shared storage for counter/gauge: {label-key: (labels, value)}."""

    def __init__(self, name: str, help_: str, lock: threading.RLock):
        super().__init__(name, help_, lock)
        self._values: Dict[_LabelKey, Tuple[Dict[str, str],
                                            Union[int, float]]] = {}

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def _add(self, amount: Union[int, float], labels: Dict[str, str]) -> None:
        k = _key(labels)
        with self._lock:
            _, cur = self._values.get(k, (labels, 0))
            self._values[k] = (dict(labels), cur + amount)

    def _set(self, value: Union[int, float], labels: Dict[str, str]) -> None:
        with self._lock:
            self._values[_key(labels)] = (dict(labels), value)

    def samples(self) -> List[Tuple[Dict[str, str], Union[int, float]]]:
        with self._lock:
            return [(dict(lab), v) for lab, v in self._values.values()]

    def value(self, **labels: str) -> Union[int, float]:
        with self._lock:
            return self._values.get(_key(labels), ({}, 0))[1]


class Counter(_ScalarMetric):
    TYPE = "counter"

    def inc(self, amount: Union[int, float] = 1, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._add(amount, labels)

    def set_total(self, value: Union[int, float], **labels: str) -> None:
        """Mirror an externally-maintained cumulative total (collector
        use only — e.g. the span-log write count)."""
        self._set(value, labels)


class Gauge(_ScalarMetric):
    TYPE = "gauge"

    def set(self, value: Union[int, float], **labels: str) -> None:
        self._set(value, labels)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name: str, help_: str, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, lock)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or not math.isinf(bounds[-1]):
            bounds.append(math.inf)
        self.bounds: Tuple[float, ...] = tuple(bounds)
        # {label-key: (labels, per-bucket counts, sum)}
        self._values: Dict[_LabelKey,
                           Tuple[Dict[str, str], List[int], float]] = {}

    def observe(self, value: float, n: int = 1, **labels: str) -> None:
        """Record ``n`` observations of ``value``."""
        k = _key(labels)
        with self._lock:
            entry = self._values.get(k)
            if entry is None:
                entry = (dict(labels), [0] * len(self.bounds), 0.0)
                self._values[k] = entry
            _, counts, _ = entry
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    counts[i] += n
                    break
            self._values[k] = (entry[0], counts, entry[2] + value * n)

    def _merged(self, labels: Optional[Dict[str, str]]
                ) -> Tuple[List[int], float, int]:
        """(bucket counts, sum, count) aggregated over every sample
        whose labels are a superset of ``labels`` (None = all)."""
        counts = [0] * len(self.bounds)
        total_sum = 0.0
        with self._lock:
            for lab, c, s in self._values.values():
                if labels is not None and any(
                        lab.get(k) != str(v) for k, v in labels.items()):
                    continue
                for i, n in enumerate(c):
                    counts[i] += n
                total_sum += s
        return counts, total_sum, sum(counts)

    def count(self, **labels: str) -> int:
        return self._merged(labels or None)[2]

    def percentile(self, q: float,
                   labels: Optional[Dict[str, str]] = None
                   ) -> Optional[float]:
        """Estimated q-quantile (0..1) over every sample whose labels
        are a superset of ``labels`` (None = all); None when empty."""
        counts, _, _ = self._merged(labels)
        cum, cumulative = 0, []
        for bound, n in zip(self.bounds, counts):
            cum += n
            cumulative.append((bound, cum))
        return percentile_from_buckets(cumulative, q)

    def samples(self) -> List[Tuple[Dict[str, str], HistogramValue]]:
        out = []
        with self._lock:
            for lab, counts, s in self._values.values():
                cum, buckets = 0, []
                for bound, n in zip(self.bounds, counts):
                    cum += n
                    buckets.append((bound, cum))
                out.append((dict(lab), HistogramValue(buckets, s, cum)))
        return out


class MetricsRegistry:
    """A family of named instruments plus render-time collectors."""

    def __init__(self):
        self._lock = threading.RLock()
        # Serializes renders, so a concurrent render never sees a
        # half-repopulated family (collectors clear() and set() theirs).
        # It is not the instruments' lock: a collector takes its owner's
        # lock (the scheduler's), and the owner records into instruments
        # while it holds that lock (an admission), so a render holding
        # the instruments' lock across the collectors orders the two
        # locks both ways and deadlocks the plane (the reference does).
        self._render_lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []
        # Bridged registries: (registry, name prefix). See add_external.
        self._externals: List[Tuple["MetricsRegistry", str]] = []

    def _get(self, cls, name: str, help_: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {m.TYPE}, not a {cls.TYPE}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def add_collector(self,
                      fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register a callback run before every render; it should set
        gauges/counters for values owned elsewhere."""
        with self._lock:
            self._collectors.append(fn)

    def add_external(self, registry: "MetricsRegistry",
                     prefix: str = "") -> None:
        """Bridge another registry's instruments (optionally filtered by
        name ``prefix``) into this registry's render output: how the
        plane's registry exposes families recorded live into the
        process-wide ``default_registry()`` by in-process components (the
        LM train loop's ``kfx_train_*``) without double-owning the state.
        Locally-registered names win on collision; the external registry's
        collectors are not run."""
        with self._lock:
            self._externals.append((registry, prefix))

    def _gathered(self) -> List[_Metric]:
        with self._lock:
            metrics = dict(self._metrics)
            externals = list(self._externals)
        for reg, prefix in externals:
            with reg._lock:
                ext = list(reg._metrics.items())
            for name, m in ext:
                if prefix and not name.startswith(prefix):
                    continue
                metrics.setdefault(name, m)
        return sorted(metrics.values(), key=lambda m: m.name)

    def _collected(self):
        """Run the collectors, then gather: (metric, samples) pairs read
        under the render lock, the one path both outputs take."""
        with self._render_lock:
            with self._lock:
                collectors = list(self._collectors)
            for fn in collectors:
                fn(self)
            return [(m, m.samples()) for m in self._gathered()]

    def render(self) -> str:
        """Prometheus exposition text for every registered metric."""
        return prom_text([(m.name, m.TYPE, m.help, samples)
                          for m, samples in self._collected()])

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able view of the same state the exposition text shows —
        the single snapshot path both /metrics formats derive from."""
        out: Dict[str, Dict] = {}
        for m, samples in self._collected():
            if isinstance(m, Histogram):
                rows = [{"labels": lab,
                         "buckets": [[fmt_le(b), c] for b, c in hv.buckets],
                         "sum": hv.sum, "count": hv.count}
                        for lab, hv in samples]
            else:
                rows = [{"labels": lab, "value": v} for lab, v in samples]
            out[m.name] = {"type": m.TYPE, "help": m.help, "samples": rows}
        return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry — what a standalone predictor records
    into until a model server hands it its own."""
    return _default
