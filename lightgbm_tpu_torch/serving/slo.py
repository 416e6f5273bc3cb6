"""SLO burn-rate alerting over fast/slow dual windows (port of
lightgbm_tpu/serving/slo.py).

Two targets, both optional (0 disables): ``serve_slo_p99_ms`` (p99
latency objective) and ``serve_slo_error_rate`` (error-rate
objective). Each request's latency/error lands in a bounded sample
deque; the monitor evaluates the objectives over two trailing *time*
windows — a **fast** window (default 60s) that catches acute burns
quickly, and a **slow** window (default 600s) that catches slow leaks
a fast window averages away. This is the standard multi-window
burn-rate shape: page on the fast window, ticket on the slow one.

Consumers:

* ``/healthz`` — a fast-window burn flips ``ok`` → ``degraded`` (the
  HTTP layer already maps non-ok to 503, so load balancers back off).
* ``/metrics`` — both windows' observed p99/error-rate and burn flags
  are exported as gauges next to the serving counters.
* the canary router — `version_violation(version)` answers "is THIS
  version burning its SLO in the fast window", the additional
  demotion input wired in fleet/router.py.

Burn transitions are edge-triggered into the flight recorder
(``slo_burn`` / ``slo_clear`` events + an ``slo_burns`` counter), so
run reports show when an incident started and ended, not one line per
request. Evaluation is O(window) and happens on read (health/metrics/
router), not per observe — the request path pays one deque append.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..telemetry import bundle as telem_bundle
from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events

__all__ = ["SloMonitor"]

_MAX_SAMPLES = 8192


class SloMonitor:
    """Sliding-window SLO evaluation over per-request observations."""

    def __init__(self, p99_ms: float = 0.0, error_rate: float = 0.0,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 min_requests: int = 20):
        self.p99_ms = float(p99_ms)
        self.error_rate = float(error_rate)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.min_requests = int(min_requests)
        self._lock = threading.Lock()
        # (t_monotonic, latency_s | None, error, version)
        self._samples: deque = deque(maxlen=_MAX_SAMPLES)
        self._burning = False

    @property
    def configured(self) -> bool:
        return self.p99_ms > 0 or self.error_rate > 0

    # -- request path ----------------------------------------------------
    def observe(self, version: Optional[str], seconds: Optional[float],
                error: bool = False) -> None:
        """One request's outcome. O(1): evaluation is deferred to the
        readers (health/metrics/router)."""
        with self._lock:
            self._samples.append((time.monotonic(),
                                  None if seconds is None else
                                  float(seconds),
                                  bool(error), version))

    # -- evaluation ------------------------------------------------------
    def _window_stats(self, window_s: float,
                      version: Optional[str] = None) -> dict:
        cutoff = time.monotonic() - window_s
        lats = []
        requests = errors = 0
        with self._lock:
            for t, lat, err, ver in self._samples:
                if t < cutoff:
                    continue
                if version is not None and ver != version:
                    continue
                requests += 1
                if err:
                    errors += 1
                elif lat is not None:
                    lats.append(lat)
        p99 = 0.0
        if lats:
            lats.sort()
            p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))] * 1e3
        rate = errors / requests if requests else 0.0
        violated = None
        if requests >= self.min_requests:
            if self.p99_ms > 0 and p99 > self.p99_ms:
                violated = (f"p99 {p99:.1f}ms > slo {self.p99_ms:g}ms "
                            f"({requests} reqs)")
            elif self.error_rate > 0 and rate > self.error_rate:
                violated = (f"error_rate {rate:.3f} > slo "
                            f"{self.error_rate:g} ({requests} reqs)")
        return {"requests": requests, "errors": errors,
                "error_rate": round(rate, 6), "p99_ms": round(p99, 3),
                "burning": violated is not None, "violation": violated}

    def version_violation(self, version: str) -> Optional[str]:
        """Fast-window SLO verdict for one version (the router's
        demotion input): a reason string while burning, else None."""
        if not self.configured:
            return None
        return self._window_stats(self.fast_window_s,
                                  version)["violation"]

    def burning(self) -> bool:
        """Aggregate fast-window burn (drives /healthz degradation).
        Edge-triggers slo_burn/slo_clear events on state change."""
        if not self.configured:
            return False
        fast = self._window_stats(self.fast_window_s)
        self._edge(fast)
        return fast["burning"]

    def _edge(self, fast: dict) -> None:
        with self._lock:
            was, now = self._burning, fast["burning"]
            self._burning = now
        if now and not was:
            telem_counters.incr("slo_burns")
            telem_events.emit("slo_burn", window="fast",
                              violation=fast["violation"],
                              p99_ms=fast["p99_ms"],
                              error_rate=fast["error_rate"],
                              requests=fast["requests"])
            # outside self._lock (released above): capture writes files
            telem_bundle.maybe_capture("slo_burn",
                                       violation=fast["violation"])
        elif was and not now:
            telem_events.emit("slo_clear", window="fast",
                              p99_ms=fast["p99_ms"],
                              error_rate=fast["error_rate"],
                              requests=fast["requests"])

    def snapshot(self) -> dict:
        """Both windows' stats + objectives (for /stats, /metrics and
        /healthz). Edge-triggers burn events like `burning()`."""
        fast = self._window_stats(self.fast_window_s)
        slow = self._window_stats(self.slow_window_s)
        if self.configured:
            self._edge(fast)
        return {"slo_p99_ms": self.p99_ms,
                "slo_error_rate": self.error_rate,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "configured": self.configured,
                "fast": fast, "slow": slow}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._burning = False
