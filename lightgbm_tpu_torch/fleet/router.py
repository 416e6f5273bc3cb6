"""Canary/shadow traffic router: weighted split, counter-gated promotion
(port of lightgbm_tpu/fleet/router.py).

ServingStats keeps per-version request/error/latency series -- the
measurement half of canary deployment. This is the other half: a router
that decides, per request, which model version answers, and moves
versions through the canary state machine on the evidence of their own
counters.

State machine (one stable, at most one canary):

    deploy(v, weight)        stable answers 1-w of traffic, canary w
      |                      (or 0 in shadow mode: canary only sees
      |                      mirrored copies, responses discarded)
      +-- promote            canary becomes stable (auto when its
      |                      counters clear the health gate, or forced)
      +-- demote(reason)     canary dropped (auto on error spike /
                             latency blowout / watchdog fire, or forced)

The split is deterministic, not random: request n goes to the canary
iff ``floor(n*w) > floor((n-1)*w)``, which hits the weight exactly on
every prefix — reproducible in tests and drift-free in production.

Promotion gate (evaluated per request, O(dict reads)):

* at least `min_requests` canary requests since deploy;
* canary error rate <= `max_error_rate`;
* canary p99 <= `p99_ratio` x stable p99 (skipped when the stable has
  no latency history);
* no watchdog fire since deploy (`telemetry.counters` watchdog_fires);
* labeled-feedback quality (when a `serving.feedback.FeedbackStore` is
  attached with `feedback_min_labels > 0`): hold until the canary has
  accrued `feedback_min_labels` labels via `POST /feedback`, then
  demote if its AUC trails the stable's by more than
  `feedback_auc_epsilon` (stable AUC only compared once the stable has
  enough labels of its own — counters prove the canary is not
  *erroring*, labels prove it is not *wrong*).

Demotion fires immediately — before min_requests — on an absolute
error burst (`demote_errors`), a watchdog fire, or (when an SLO
monitor is attached via `slo=`) a fast-window SLO burn on the canary's
own latency/error series: a bleeding canary is cut, not averaged out.

Every transition (stable/deploy/promote/demote) is recorded in a
bounded audit log together with the exact gate snapshot — the counter
deltas and thresholds the decision was made on — queryable via
`audit_snapshot()` (`GET /router/audit` over HTTP) and attached to the
router_promote/router_demote events.

Both routed versions are pinned in the predictor cache for as long as
they hold a slot (ModelRegistry.pin_version), so LRU eviction under
multi-model load can never drop an executable that live traffic needs.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log

__all__ = ["CanaryRouter", "RouterState"]


class RouterState:
    STABLE_ONLY = "stable_only"
    CANARY = "canary"
    SHADOW = "shadow"


class CanaryRouter:
    """Per-request version routing over a ModelRegistry + ServingStats."""

    AUDIT_MAX = 200

    def __init__(self, registry, stats, min_requests: int = 50,
                 max_error_rate: float = 0.02, p99_ratio: float = 3.0,
                 demote_errors: int = 3, slo=None, feedback=None,
                 feedback_min_labels: int = 0,
                 feedback_auc_epsilon: float = 0.02):
        self.registry = registry
        self.stats = stats
        self.min_requests = int(min_requests)
        self.max_error_rate = float(max_error_rate)
        self.p99_ratio = float(p99_ratio)
        self.demote_errors = int(demote_errors)
        self.slo = slo                      # optional serving.slo.SloMonitor
        self.feedback = feedback            # optional FeedbackStore
        self.feedback_min_labels = int(feedback_min_labels)
        self.feedback_auc_epsilon = float(feedback_auc_epsilon)
        self._lock = threading.Lock()
        self._stable: Optional[str] = None
        self._canary: Optional[str] = None
        self._weight = 0.0
        self._shadow = False
        self._route_n = 0
        self._canary_routed = 0
        self._baseline: Dict[str, float] = {}
        self.history: List[dict] = []
        self.audit: List[dict] = []
        self._last_eval: Optional[dict] = None
        # transition hook: callable(action, version, **detail) invoked
        # after every stable/deploy/promote/demote lands (outside the
        # lock): a fleet manifest publisher binds here so this router's
        # decisions propagate to every replica.
        self.on_transition = None

    # -- configuration ---------------------------------------------------
    def set_stable(self, version: str) -> None:
        """Install/replace the stable version (pinned against eviction)."""
        with self._lock:
            previous = self._stable
            self._stable = version
            self._audit_locked("stable", version, previous=previous)
        self.registry.pin_version(version)
        if previous and previous != version:
            self.registry.unpin_version(previous)
        telem_events.emit("router_stable", version=version,
                          previous=previous)
        self._notify("stable", version, previous=previous)

    def deploy(self, version: str, weight: float = 0.10,
               shadow: bool = False) -> None:
        """Start canarying `version` at `weight` of traffic (shadow mode
        mirrors instead of splitting). Baselines the canary's counters
        and the process watchdog counter so the gate judges only what
        happens AFTER this deploy."""
        if not (0.0 < weight <= 1.0) and not shadow:
            raise ValueError(f"canary weight {weight} not in (0, 1]")
        self.registry.get(version)          # raises on unknown version
        with self._lock:
            if self._stable is None:
                raise RuntimeError("deploy a stable version first")
            if self._canary is not None:
                raise RuntimeError(
                    f"canary {self._canary!r} already in flight")
            self._canary = version
            self._weight = 0.0 if shadow else float(weight)
            self._shadow = bool(shadow)
            self._route_n = 0
            self._canary_routed = 0
            self._baseline = self._counters_for(version)
            self._baseline["watchdog_fires"] = telem_counters.get(
                "watchdog_fires")
            self._audit_locked("deploy", version, weight=weight,
                               shadow=shadow)
        self.registry.pin_version(version)
        telem_counters.set_gauge("router_canary_weight",
                                 0.0 if shadow else weight)
        telem_events.emit("router_deploy", version=version, weight=weight,
                          shadow=shadow)
        self._notify("deploy", version, weight=weight, shadow=shadow)
        log.info("router: canary %s at %.0f%%%s", version, weight * 100,
                 " (shadow)" if shadow else "")

    # -- routing ---------------------------------------------------------
    def route(self) -> Optional[str]:
        """The version that should answer the next request (None when no
        stable is installed — caller falls back to registry latest)."""
        with self._lock:
            if self._stable is None:
                return None
            if self._canary is None or self._shadow:
                return self._stable
            self._route_n += 1
            n, w = self._route_n, self._weight
            if math.floor(n * w) > math.floor((n - 1) * w):
                self._canary_routed += 1
                return self._canary
            return self._stable

    def shadow_target(self) -> Optional[str]:
        """The version to mirror this request to (None = no mirroring)."""
        with self._lock:
            return self._canary if (self._shadow and self._canary) else None

    @property
    def active(self) -> bool:
        with self._lock:
            return self._stable is not None

    @property
    def stable(self) -> Optional[str]:
        with self._lock:
            return self._stable

    @property
    def canary(self) -> Optional[str]:
        with self._lock:
            return self._canary

    # -- the gate --------------------------------------------------------
    def _counters_for(self, version: str) -> Dict[str, float]:
        snap = self.stats.snapshot()["versions"].get(version) or {}
        return {"requests": snap.get("requests", 0),
                "errors": snap.get("errors", 0)}

    def _p99_ms(self, version: str) -> float:
        snap = self.stats.snapshot()["versions"].get(version) or {}
        lat = snap.get("latency") or {}
        return float(lat.get("p99_ms", 0.0))

    def _gate_snapshot(self, canary: str, stable: Optional[str],
                       baseline: dict) -> dict:
        """The exact evidence one evaluate() decides on: counter deltas
        since deploy, both p99s, the SLO verdict, and the thresholds in
        force. One snapshot per evaluation — the audit log and the
        router_* events carry it verbatim."""
        now = self._counters_for(canary)
        requests = now["requests"] - baseline.get("requests", 0)
        errors = now["errors"] - baseline.get("errors", 0)
        gate = {"canary": canary, "stable": stable,
                "requests": int(requests), "errors": int(errors),
                "error_rate": (round(errors / requests, 6)
                               if requests > 0 else 0.0),
                "canary_p99_ms": round(self._p99_ms(canary), 3),
                "stable_p99_ms": (round(self._p99_ms(stable), 3)
                                  if stable else 0.0),
                "watchdog_fires": int(
                    telem_counters.get("watchdog_fires")
                    - baseline.get("watchdog_fires", 0)),
                "thresholds": {"min_requests": self.min_requests,
                               "max_error_rate": self.max_error_rate,
                               "p99_ratio": self.p99_ratio,
                               "demote_errors": self.demote_errors}}
        if self.slo is not None:
            gate["slo_violation"] = self.slo.version_violation(canary)
        if self._feedback_gated():
            c_auc, c_n = self.feedback.auc(canary)
            s_auc, s_n = self.feedback.auc(stable)
            gate["thresholds"]["feedback_min_labels"] = \
                self.feedback_min_labels
            gate["thresholds"]["feedback_auc_epsilon"] = \
                self.feedback_auc_epsilon
            gate["feedback"] = {
                "canary_labels": c_n, "stable_labels": s_n,
                "canary_auc": (round(c_auc, 6) if c_auc is not None
                               else None),
                "stable_auc": (round(s_auc, 6) if s_auc is not None
                               else None)}
        return gate

    def _feedback_gated(self) -> bool:
        return self.feedback is not None and self.feedback_min_labels > 0

    def evaluate(self) -> str:
        """Apply the state machine once: returns "promoted", "demoted",
        or "hold". Called per request by the serving app (cheap) or on a
        timer by embedders."""
        with self._lock:
            canary = self._canary
            stable = self._stable
            baseline = dict(self._baseline)
        if canary is None:
            return "hold"
        gate = self._gate_snapshot(canary, stable, baseline)

        def _hold() -> str:
            with self._lock:
                self._last_eval = {"result": "hold", "t": time.time(),
                                   "gate": gate}
            return "hold"

        if gate["watchdog_fires"] > 0:
            self.demote("watchdog_fire", missing_ok=True, gate=gate)
            return "demoted"
        requests, errors = gate["requests"], gate["errors"]
        if errors >= self.demote_errors:
            self.demote(f"error_spike ({int(errors)} errors in "
                        f"{int(requests)} requests)", missing_ok=True,
                        gate=gate)
            return "demoted"
        slo_reason = gate.get("slo_violation")
        if slo_reason:
            self.demote(f"slo_burn ({slo_reason})", missing_ok=True,
                        gate=gate)
            return "demoted"
        if requests < self.min_requests:
            return _hold()
        if requests > 0 and errors / requests > self.max_error_rate:
            self.demote(f"error_rate {errors / requests:.3f}",
                        missing_ok=True, gate=gate)
            return "demoted"
        stable_p99 = gate["stable_p99_ms"]
        canary_p99 = gate["canary_p99_ms"]
        if stable_p99 > 0 and canary_p99 > self.p99_ratio * stable_p99:
            self.demote(f"p99 {canary_p99:.1f}ms > {self.p99_ratio:g}x "
                        f"stable {stable_p99:.1f}ms", missing_ok=True,
                        gate=gate)
            return "demoted"
        fb = gate.get("feedback")
        if fb is not None:
            # quality gate: counters above proved the canary answers
            # fast and without erroring; labels prove the answers are
            # RIGHT. Hold (not demote) while labels accrue — absence of
            # evidence is not a regression.
            if fb["canary_labels"] < self.feedback_min_labels:
                return _hold()
            c_auc, s_auc = fb["canary_auc"], fb["stable_auc"]
            if (c_auc is not None and s_auc is not None
                    and fb["stable_labels"] >= self.feedback_min_labels
                    and c_auc < s_auc - self.feedback_auc_epsilon):
                self.demote(
                    f"feedback_auc {c_auc:.3f} < stable {s_auc:.3f} - "
                    f"{self.feedback_auc_epsilon:g}", missing_ok=True,
                    gate=gate)
                return "demoted"
        self.promote(missing_ok=True, gate=gate)
        return "promoted"

    # -- transitions -----------------------------------------------------
    def promote(self, missing_ok: bool = False,
                gate: Optional[dict] = None) -> None:
        """Canary becomes stable; the old stable is unpinned (it stays
        loaded in the registry for instant rollback until unload).
        `missing_ok` is the auto-transition path: concurrent evaluate()
        calls may race to the same verdict, and the loser finds the slot
        already empty — a no-op, not an error. `gate` is the evaluation
        snapshot that justified an auto-promotion (None = forced)."""
        with self._lock:
            canary, old_stable = self._canary, self._stable
            if canary is None:
                if missing_ok:
                    return
                raise RuntimeError("no canary to promote")
            self._stable, self._canary = canary, None
            self._weight, self._shadow = 0.0, False
            self._record_locked("promote", canary, old=old_stable)
            self._audit_locked("promote", canary, old=old_stable,
                               gate=gate)
        if old_stable and old_stable != canary:
            self.registry.unpin_version(old_stable)
        telem_counters.incr("router_promotions")
        telem_counters.set_gauge("router_canary_weight", 0.0)
        telem_events.emit("router_promote", version=canary,
                          previous=old_stable, gate=gate)
        self._notify("promote", canary, previous=old_stable)
        log.info("router: promoted %s (was %s)", canary, old_stable)

    def demote(self, reason: str = "manual", missing_ok: bool = False,
               gate: Optional[dict] = None) -> None:
        """Cut the canary: all traffic back to stable, pin released."""
        with self._lock:
            canary = self._canary
            if canary is None:
                if missing_ok:
                    return
                raise RuntimeError("no canary to demote")
            self._canary = None
            self._weight, self._shadow = 0.0, False
            self._record_locked("demote", canary, reason=reason)
            self._audit_locked("demote", canary, reason=reason, gate=gate)
        self.registry.unpin_version(canary)
        telem_counters.incr("router_demotions")
        telem_counters.set_gauge("router_canary_weight", 0.0)
        telem_events.emit("router_demote", version=canary, reason=reason,
                          gate=gate)
        self._notify("demote", canary, reason=reason)
        log.warning("router: demoted %s (%s)", canary, reason)

    def _notify(self, action: str, version: str, **detail) -> None:
        """Fire the on_transition hook; a failing subscriber must never
        take the routing path down with it."""
        cb = self.on_transition
        if cb is None:
            return
        try:
            cb(action, version, **detail)
        except Exception as exc:   # noqa: BLE001 — hook is advisory
            log.warning("router: on_transition hook failed for %s %s: %s",
                        action, version, exc)

    def audit_note(self, action: str, version: Optional[str] = None,
                   **detail) -> None:
        """Append a non-transition decision to the audit channel — the
        one bounded log for everything that reroutes traffic. The load
        shedder logs brownout level changes here so `GET /router/audit`
        explains shed traffic next to canary transitions."""
        with self._lock:
            self._audit_locked(action, version, **detail)

    def _record_locked(self, action: str, version: str, **detail) -> None:
        self.history.append({"action": action, "version": version,
                             "t": time.time(), **detail})

    def _audit_locked(self, action: str, version: str, **detail) -> None:
        self.audit.append({"action": action, "version": version,
                           "t": time.time(), **detail})
        if len(self.audit) > self.AUDIT_MAX:
            del self.audit[:len(self.audit) - self.AUDIT_MAX]

    # -- introspection ---------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            state = (RouterState.SHADOW if self._shadow and self._canary
                     else RouterState.CANARY if self._canary
                     else RouterState.STABLE_ONLY)
            return {"state": state, "stable": self._stable,
                    "canary": self._canary, "weight": self._weight,
                    "shadow": self._shadow, "routed": self._route_n,
                    "canary_routed": self._canary_routed,
                    "min_requests": self.min_requests,
                    "max_error_rate": self.max_error_rate,
                    "p99_ratio": self.p99_ratio,
                    "history": list(self.history[-20:])}

    def audit_snapshot(self, limit: int = 100) -> dict:
        """The decision log (GET /router/audit): every recorded
        transition with the gate snapshot it was decided on, plus the
        most recent "hold" evaluation so a stuck canary is explainable
        before any transition happens."""
        with self._lock:
            last = dict(self._last_eval) if self._last_eval else None
            return {"decisions": list(self.audit[-int(limit):]),
                    "last_evaluation": last}
