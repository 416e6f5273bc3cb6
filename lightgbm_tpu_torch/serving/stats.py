"""Serving-side metrics: request counters + latency histograms (port of
lightgbm_tpu/serving/stats.py, the same buckets and readout).

The training side reports phase costs through utils/timer (accumulating
TIMETAG timers); online inference needs tail latency, not just totals, so
this module adds log-bucketed histograms with p50/p95/p99 readout. The
HTTP front end exposes a `snapshot()` of everything at `/stats`.
"""
from __future__ import annotations

import math
import threading
from typing import Dict

# log-spaced latency buckets: 1us .. ~137s, x2 per bucket (28 buckets).
_BUCKET_LO = 1e-6
_BUCKET_COUNT = 28


class LatencyHistogram:
    """Fixed log2 buckets over seconds; cheap record, percentile readout.

    Percentiles are bucket upper-bound estimates (standard Prometheus
    histogram semantics), good to within one x2 bucket — plenty for
    p50/p95/p99 serving dashboards.
    """

    def __init__(self):
        self._counts = [0] * (_BUCKET_COUNT + 1)   # +1 overflow bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0:
            seconds = 0.0
        idx = 0
        if seconds > _BUCKET_LO:
            idx = min(int(math.log2(seconds / _BUCKET_LO)) + 1, _BUCKET_COUNT)
        self._counts[idx] += 1
        self.count += 1
        self.sum += seconds
        self.max = max(self.max, seconds)

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket containing the p-th percentile."""
        if self.count == 0:
            return 0.0
        target = math.ceil(self.count * p / 100.0)
        seen = 0
        for idx, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return _BUCKET_LO * (2.0 ** idx)
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_ms": (self.sum / self.count * 1e3) if self.count else 0.0,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "max_ms": self.max * 1e3,
        }


class ServingStats:
    """Thread-safe counter + histogram registry for one serving stack.

    Besides the flat counters/histograms, per-model-version series
    (`observe_version`) track request count, error count, and a latency
    histogram keyed by the version tag that answered (or was asked for,
    on errors) — the observability half of canary/shadow traffic
    splitting: `/stats` exposes them under `"versions"`, `/metrics`
    renders them as `{version="..."}`-labeled series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, LatencyHistogram] = {}
        self._versions: Dict[str, Dict[str, int]] = {}
        self._vhists: Dict[str, LatencyHistogram] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = LatencyHistogram()
            hist.record(seconds)

    def observe_version(self, version: str, seconds: float = None,
                        error: bool = False) -> None:
        """Count one request against a model version; `seconds` records
        into the version's latency histogram (None on error paths where
        no answer was produced)."""
        version = str(version)
        with self._lock:
            ent = self._versions.setdefault(
                version, {"requests": 0, "errors": 0})
            ent["requests"] += 1
            if error:
                ent["errors"] += 1
            if seconds is not None:
                hist = self._vhists.get(version)
                if hist is None:
                    hist = self._vhists[version] = LatencyHistogram()
                hist.record(seconds)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "latency": {k: h.snapshot() for k, h in self._hists.items()},
                "versions": {
                    v: {"requests": ent["requests"],
                        "errors": ent["errors"],
                        "latency": (self._vhists[v].snapshot()
                                    if v in self._vhists else None)}
                    for v, ent in self._versions.items()},
            }
