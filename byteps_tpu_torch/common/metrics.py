"""Always-on telemetry: the port's metrics registry.

The port's own copy of ``byteps_tpu/common/metrics.py`` (counters,
gauges, fixed-bucket histograms, one process-wide registry and the
``json_safe`` sanitizer). Series identity is the dotted name, so the
serve tier's ``serve.*`` series keep the reference's names.

``BYTEPS_METRICS_ON=0`` swaps every handle for a shared no-op.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "json_safe", "DEFAULT_BUCKETS",
]

# Fixed 1-2-5 geometric ladder spanning 1 .. 1e8 (+inf overflow bucket):
# fixed buckets keep ``observe`` allocation-free and snapshots mergeable.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * (10 ** e) for e in range(0, 8) for m in (1, 2, 5)
)


class Counter:
    """Monotonic counter; ``inc`` under a per-metric lock (``+=`` is a
    read-modify-write the interpreter lock does not make atomic)."""

    __slots__ = ("_v", "_lock")

    def __init__(self) -> None:
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins value that also tracks its high-water mark."""

    __slots__ = ("_v", "_max", "_lock")

    def __init__(self) -> None:
        self._v = 0.0
        self._max = -math.inf
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v
            if v > self._max:
                self._max = v

    def value(self) -> float:
        with self._lock:
            return self._v

    def max(self) -> float:
        with self._lock:
            return self._max if self._max != -math.inf else 0.0


class Histogram:
    """Fixed-bucket histogram with p50/p99 snapshots, interpolated within
    the owning bucket (coarse by design)."""

    __slots__ = ("_edges", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, buckets: Optional[Sequence[float]] = None) -> None:
        self._edges: Tuple[float, ...] = tuple(buckets or DEFAULT_BUCKETS)
        self._counts = [0] * (len(self._edges) + 1)  # +overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect_left(self._edges, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        target = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self._edges[i - 1] if i > 0 else 0.0
                hi = (self._edges[i] if i < len(self._edges)
                      else max(self._max, lo))
                lo = max(lo, self._min if self._min != math.inf else lo)
                hi = min(hi, self._max if self._max != -math.inf else hi)
                if hi <= lo:
                    return lo
                return lo + (hi - lo) * (target - seen) / c
            seen += c
        return self._max if self._max != -math.inf else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": self._quantile_locked(0.50),
                "p99": self._quantile_locked(0.99),
            }

    def count(self) -> int:
        with self._lock:
            return self._count


class _Null:
    """Shared no-op standing in for every metric when the registry is
    disabled."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def value(self) -> int:
        return 0

    def max(self) -> float:
        return 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"count": 0}

    def count(self) -> int:
        return 0


_NULL = _Null()

# Runaway-series backstop: a bug minting a fresh name per op fills the
# registry, not the process heap.
_MAX_SERIES = 4096


class MetricsRegistry:
    """Name → metric map. Creation takes the registry lock; call sites
    cache the returned handle, so steady-state traffic never does."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self.dropped_series = 0

    def _get(self, table: Dict[str, Any], name: str, factory):
        if not self.enabled:
            return _NULL
        m = table.get(name)
        if m is not None:
            return m
        with self._lock:
            m = table.get(name)
            if m is None:
                if (len(self._counters) + len(self._gauges)
                        + len(self._hists)) >= _MAX_SERIES:
                    self.dropped_series += 1
                    return _NULL
                m = factory()
                table[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(self._hists, name, lambda: Histogram(buckets))

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """One JSON-safe view: counters/gauges as scalars, histograms as
        their stat dicts, filtered by dotted-name ``prefix``."""
        with self._lock:
            counters = {k: v for k, v in self._counters.items()
                        if k.startswith(prefix)}
            gauges = {k: v for k, v in self._gauges.items()
                      if k.startswith(prefix)}
            hists = {k: v for k, v in self._hists.items()
                     if k.startswith(prefix)}
        out: Dict[str, Any] = {
            "counters": {k: c.value() for k, c in sorted(counters.items())},
            "gauges": {k: {"value": g.value(), "max": g.max()}
                       for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot() for k, h in sorted(hists.items())},
        }
        if self.dropped_series:
            out["dropped_series"] = self.dropped_series
        return out


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (enabled per BYTEPS_METRICS_ON at first
    use; ``reset_registry()`` re-reads)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                from byteps_tpu_torch.common.config import get_config

                _registry = MetricsRegistry(enabled=get_config().metrics_on)
    return _registry


def reset_registry() -> None:
    """Drop the cached registry. Handles cached by live objects keep
    working; they just stop being visible in the new registry."""
    global _registry
    with _registry_lock:
        _registry = None


def json_safe(obj: Any, _depth: int = 0) -> Any:
    """Scrub a telemetry value down to plain JSON types: numpy scalars
    unwrap, small arrays become lists, big arrays a shape descriptor,
    bytes decode, non-finite floats and anything else become ``str``."""
    import numpy as np

    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else str(obj)
    if _depth > 8:
        return str(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        v = float(obj)
        return v if math.isfinite(v) else str(v)
    if isinstance(obj, np.complexfloating):
        return str(complex(obj))
    if isinstance(obj, np.ndarray):
        if obj.ndim == 0:
            return json_safe(obj.item(), _depth + 1)
        if obj.size <= 16:
            return [json_safe(x, _depth + 1) for x in obj.tolist()]
        return f"ndarray(shape={obj.shape}, dtype={obj.dtype})"
    if isinstance(obj, (bytes, bytearray, np.bytes_)):
        return bytes(obj).decode("utf-8", errors="replace")
    if isinstance(obj, dict):
        return {str(k): json_safe(v, _depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [json_safe(v, _depth + 1) for v in obj]
    return str(obj)
