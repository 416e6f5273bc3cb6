"""Brownout load shedding: priority classes over the batcher queue (port
of lightgbm_tpu/serving/shed.py).

Overload is a first-class scenario, not an error path: when a replica
saturates, *which* traffic gets dropped decides whether the SLO
survives. Three priority classes, in strictly decreasing worth:

* ``pinned``    — un-versioned routed traffic, the SLO class; shed
  only when the queue is hard-full.
* ``versioned`` — explicit-version requests (debug, replay, batch
  backfill); shed under acute burn and at reduced queue headroom.
* ``shadow``    — mirrored canary traffic; measurement-only, first to
  go the moment anything burns.

Two mechanisms compose inside `MicroBatcher.submit_async` (the
batcher's existing admission-control point):

* **Headroom** — each class may only fill its fraction of
  ``max_queue_rows`` (defaults 1.0 / 0.8 / 0.5), so a rising queue
  rejects shadow before versioned before pinned with no coordination.
* **Brownout levels** driven by the SLO burn-rate monitor (slo.py):
  level 0 (clear) admits per headroom; level 1 (slow-window burn —
  the "ticket" signal) sheds shadow outright; level 2 (fast-window
  burn — the "page" signal) sheds shadow + versioned, keeping pinned
  SLO traffic as the only queue tenant so its deadline flush holds.

Level transitions are logged through the canary router's audit channel
(one bounded decision log for everything that reroutes traffic),
edge-triggered into the flight recorder (``shed_level`` event +
``shed_level`` gauge), and every rejection counts into
``shed_requests`` plus a per-class ServingStats counter
(``serve_shed_<class>``) for ``/stats``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log

__all__ = ["LoadShedder", "PRIORITIES", "DEFAULT_PRIORITY"]

PRIORITIES = ("pinned", "versioned", "shadow")
DEFAULT_PRIORITY = "pinned"
_RANK = {"pinned": 0, "versioned": 1, "shadow": 2}
DEFAULT_HEADROOM = {"pinned": 1.0, "versioned": 0.8, "shadow": 0.5}


class LoadShedder:
    """Priority-class admission policy, consulted by the batcher under
    its queue lock (every decision must be O(dict reads) — the SLO
    window scan behind `level()` is cached for `refresh_s`)."""

    def __init__(self, slo=None, headroom: Optional[Dict[str, float]] = None,
                 refresh_s: float = 0.25,
                 audit: Optional[Callable] = None):
        self.slo = slo                      # serving.slo.SloMonitor | None
        self.headroom = dict(DEFAULT_HEADROOM)
        if headroom:
            self.headroom.update(headroom)
        self.refresh_s = float(refresh_s)
        # audit(action, version=None, **detail): the router's audit
        # channel (CanaryRouter.audit_note) once the app binds it
        self.audit = audit
        self._lock = threading.Lock()
        self._level = 0
        self._manual: Optional[int] = None
        self._last_eval = 0.0
        self._shed: Dict[str, int] = {p: 0 for p in PRIORITIES}

    # -- brownout level --------------------------------------------------
    def set_level(self, level: Optional[int], reason: str = "manual") -> None:
        """Operator/test override (None returns control to the SLO)."""
        with self._lock:
            self._manual = None if level is None else int(level)
        self._publish(self.level(), reason)

    def level(self) -> int:
        """Current brownout level (0 clear / 1 slow burn / 2 fast
        burn). SLO-driven unless a manual override is set."""
        with self._lock:
            manual = self._manual
            if manual is not None:
                return manual
            has_slo = self.slo is not None and self.slo.configured
            if has_slo:
                now = time.monotonic()
                if now - self._last_eval < self.refresh_s:
                    return self._level
                self._last_eval = now
        if not has_slo:
            # no signal source: a cleared manual override means clear,
            # not "whatever level was last published"
            if self._level != 0:
                self._publish(0, "manual_cleared")
            return 0
        fast = self.slo._window_stats(self.slo.fast_window_s)
        slow = self.slo._window_stats(self.slo.slow_window_s)
        level = 2 if fast["burning"] else 1 if slow["burning"] else 0
        reason = (fast.get("violation") or slow.get("violation")
                  or "slo_clear")
        self._publish(level, reason)
        return level

    def _publish(self, level: int, reason: str) -> None:
        with self._lock:
            previous, self._level = self._level, level
        if level == previous:
            return
        telem_counters.set_gauge("shed_level", level)
        telem_events.emit("shed_level", level=level, previous=previous,
                          reason=reason)
        if self.audit is not None:
            try:
                self.audit("shed_level", None, level=level,
                           previous=previous, reason=reason)
            except Exception as exc:   # noqa: BLE001 — audit is advisory
                log.debug("shed: audit hook failed: %s", exc)
        (log.warning if level > previous else log.info)(
            "shed: brownout level %d -> %d (%s)", previous, level, reason)

    # -- admission -------------------------------------------------------
    def admit(self, priority: str, queued_rows: int, incoming_rows: int,
              cap: int) -> Optional[str]:
        """None to admit, else the rejection reason. Called with the
        batcher queue lock held."""
        rank = _RANK.get(priority, 0)
        level = self.level()
        if level >= 1 and rank >= _RANK["shadow"]:
            return self._reject(priority, f"brownout level {level} "
                                          "sheds shadow traffic")
        if level >= 2 and rank >= _RANK["versioned"]:
            return self._reject(priority, f"brownout level {level} "
                                          "sheds versioned traffic")
        limit = cap * self.headroom.get(priority, 1.0)
        if queued_rows + incoming_rows > limit:
            return self._reject(
                priority, f"queue {queued_rows}+{incoming_rows} rows over "
                          f"{priority} headroom {limit:g}/{cap}")
        return None

    def _reject(self, priority: str, reason: str) -> str:
        with self._lock:
            self._shed[priority] = self._shed.get(priority, 0) + 1
        telem_counters.incr("shed_requests")
        return reason

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self._level,
                    "manual": self._manual,
                    "headroom": dict(self.headroom),
                    "shed": dict(self._shed)}
