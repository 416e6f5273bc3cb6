"""Watchdogs: trailing-window anomaly monitors over iteration records
(port of lightgbm_tpu/telemetry/watchdogs.py, without serving's drift
monitor).

Three monitors watch the flight-recorder iteration stream (events.py)
and emit `kind="watchdog"` warning events when a fresh iteration breaks
from its own trailing baseline:

* **slow_iter**  — iteration wall > `slow_iter` x trailing median wall.
* **overlap**    — stream `overlap_fraction` < `overlap` x trailing
  median overlap (only meaningful while rows stream from the host; a
  collapse here means the double buffer stopped hiding transfers).
* **grad_spike** — gradient L2 norm > `grad_spike` x trailing median
  (generic-iteration runs only; the fused step keeps gradients on the
  device).

Baselines are medians over a bounded trailing window; nothing fires
until `MIN_SAMPLES` healthy iterations exist, so warm-up and capture
iterations never alarm. Every fire lands in the event stream AND in the
`watchdog_fires` counter.

Configuration (`LGBM_TPU_WATCHDOGS` env): `off` disables, otherwise a
comma list overriding the default factors, e.g.
``slow_iter=4,overlap=0.4,grad_spike=20,arm_loss_guard=1``.
`arm_loss_guard=1` asks the engine loop to append the
`resilience.loss_spike_guard` callback when the caller didn't — the
watchdog layer observes; the armed guard acts (rolls the spike back).

Observation rides the flight-recorder gate: while events are disabled
nothing here runs, preserving the off-mode byte path.
"""
from __future__ import annotations

import os
import statistics
from collections import deque
from typing import Dict, Optional

from . import counters, events

__all__ = ["configure", "observe", "fired", "loss_guard_requested",
           "reset"]

DEFAULTS = {"slow_iter": 3.0, "overlap": 0.5, "grad_spike": 10.0}
WINDOW = 32
MIN_SAMPLES = 5

_cfg: Optional[dict] = None          # parsed config (None = parse env)
_walls: deque = deque(maxlen=WINDOW)
_overlaps: deque = deque(maxlen=WINDOW)
_grad_norms: deque = deque(maxlen=WINDOW)
_fired: Dict[str, int] = {}


def configure(spec: Optional[str] = None) -> dict:
    """Parse and install a watchdog config (None re-reads the env var).
    Returns the active config ({} when off)."""
    global _cfg
    raw = (spec if spec is not None
           else os.environ.get("LGBM_TPU_WATCHDOGS", "")).strip().lower()
    if raw in ("off", "0", "none", "disabled"):
        _cfg = {"off": True}
        return {}
    cfg = dict(DEFAULTS)
    cfg["arm_loss_guard"] = False
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key == "arm_loss_guard":
            cfg["arm_loss_guard"] = val.strip() in ("1", "true", "yes", "on")
        elif key in DEFAULTS:
            try:
                cfg[key] = float(val)
            except ValueError:
                pass                 # keep the default on a bad value
    _cfg = cfg
    return cfg


def _config() -> dict:
    if _cfg is None:
        configure()
    return _cfg


def loss_guard_requested() -> bool:
    """Whether `arm_loss_guard=1` asked the engine to append the
    resilience loss_spike_guard callback."""
    cfg = _config()
    return bool(cfg.get("arm_loss_guard")) and not cfg.get("off")


def _fire(monitor: str, iteration, value: float, baseline: float,
          factor: float) -> None:
    _fired[monitor] = _fired.get(monitor, 0) + 1
    counters.incr("watchdog_fires")
    events.emit("watchdog", monitor=monitor, iteration=iteration,
                value=round(float(value), 6),
                baseline=round(float(baseline), 6), factor=factor)
    # postmortem evidence while the anomaly is still in the ring; the
    # import is deferred (bundle imports this module for fired()) and
    # the call site holds no lock — capture does file I/O
    from . import bundle
    bundle.maybe_capture("watchdog_" + monitor, monitor=monitor,
                         iteration=iteration)


def observe(rec: dict) -> None:
    """Check one iteration record against the trailing baselines (the
    flight recorder calls this before staging the record, so a watchdog
    event always precedes its iteration in the stream)."""
    cfg = _config()
    if cfg.get("off"):
        return
    it = rec.get("iteration")
    wall = rec.get("wall_s")
    if wall is not None:
        if len(_walls) >= MIN_SAMPLES:
            base = statistics.median(_walls)
            if base > 0 and wall > cfg["slow_iter"] * base:
                _fire("slow_iter", it, wall, base, cfg["slow_iter"])
        _walls.append(float(wall))
    overlap = (rec.get("stream") or {}).get("overlap_fraction")
    if overlap is not None:
        if len(_overlaps) >= MIN_SAMPLES:
            base = statistics.median(_overlaps)
            if base >= 0.1 and overlap < cfg["overlap"] * base:
                _fire("overlap", it, overlap, base, cfg["overlap"])
        _overlaps.append(float(overlap))
    gnorm = (rec.get("grad_norms") or {}).get("grad_l2")
    if gnorm is not None:
        if len(_grad_norms) >= MIN_SAMPLES:
            base = statistics.median(_grad_norms)
            if base > 0 and gnorm > cfg["grad_spike"] * base:
                _fire("grad_spike", it, gnorm, base, cfg["grad_spike"])
        _grad_norms.append(float(gnorm))


def fired() -> Dict[str, int]:
    """Fires per monitor since the last reset."""
    return dict(_fired)


def reset() -> None:
    """Clear windows, fire counts, and the cached config (so tests that
    monkeypatch LGBM_TPU_WATCHDOGS re-parse)."""
    global _cfg
    _cfg = None
    _walls.clear()
    _overlaps.clear()
    _grad_norms.clear()
    _fired.clear()
