"""Per-iteration phase breakdown for training (a copy of
lightgbm_tpu/telemetry/recorder.py).

The trainer brackets each boosting iteration with `iteration(i)` and the
hot sites inside it (gradient compute, learner dispatch, host syncs,
score updates) with `phase(name)`. The recorder accumulates per-phase
seconds twice: into the CURRENT iteration (reported by
`last_iteration()`, streamed by the `record_telemetry` callback) and
into run totals (reported by `phase_breakdown()`).

Canonical phase names, the JAX package's, so breakdowns from the two
packages diff cleanly:

    boost_avg   gradient   bagging    grow_dispatch   host_sync
    tree_replay score_update          sentry          collective   eval

All of them are host-clock times. `grow_dispatch` is the time to
ENQUEUE a tree's device work (the fused step or the learner's device
loop: the kernels and the replays of the captured split step), and
`host_sync` is the blocking fetch of the tree's records, which waits
for the device to finish that work: the device time of a tree shows up
in `host_sync`, not in `grow_dispatch`. No phase synchronizes the device
to split the two further.

Phases must NOT nest: each second is attributed exactly once, so
`phase_sum / wall` is a meaningful coverage ratio. Phases recorded
outside an open iteration (engine-side eval) count toward run totals but
not toward iteration wall / coverage.

Disabled (default) both hooks return the shared no-op context manager
after one module-global read, so they stay in the hot path.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .spans import NULL_SPAN, add_event

__all__ = ["enable", "enabled", "iteration", "phase", "last_iteration",
           "phase_breakdown", "reset"]

_enabled = False
_lock = threading.Lock()
_totals: Dict[str, list] = {}       # name -> [seconds, calls]
_iter_count = 0
_iter_wall = 0.0
_phase_in_iter = 0.0
_last: Optional[dict] = None
_cur: Optional[dict] = None         # {"index", "t0", "phases"}


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


class _IterCtx:
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __enter__(self):
        global _cur
        _cur = {"index": self.index, "t0": time.perf_counter(),
                "phases": {}}
        return self

    def __exit__(self, *exc):
        global _cur, _iter_count, _iter_wall, _phase_in_iter, _last
        cur, _cur = _cur, None
        if cur is None:            # reentrant/forced-closed: nothing open
            return False
        wall = time.perf_counter() - cur["t0"]
        with _lock:
            _iter_count += 1
            _iter_wall += wall
            _phase_in_iter += sum(cur["phases"].values())
            _last = {"iteration": cur["index"], "wall_s": wall,
                     "phases": dict(cur["phases"])}
        add_event("iteration", wall, t0=cur["t0"], index=cur["index"])
        return False


class _PhaseCtx:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        with _lock:
            ent = _totals.setdefault(self.name, [0.0, 0])
            ent[0] += dt
            ent[1] += 1
            if _cur is not None:
                phases = _cur["phases"]
                phases[self.name] = phases.get(self.name, 0.0) + dt
        add_event(self.name, dt, t0=self.t0)
        return False


def iteration(index: int):
    """Bracket one boosting iteration (GBDT.train_one_iter owns this)."""
    if not _enabled:
        return NULL_SPAN
    return _IterCtx(index)


def phase(name: str):
    """Attribute a block to `name` within the current iteration."""
    if not _enabled:
        return NULL_SPAN
    return _PhaseCtx(name)


def last_iteration() -> Optional[dict]:
    """The most recently closed iteration's {iteration, wall_s, phases}
    (the `record_telemetry` callback's feed)."""
    with _lock:
        return None if _last is None else {
            "iteration": _last["iteration"], "wall_s": _last["wall_s"],
            "phases": dict(_last["phases"])}


def phase_breakdown() -> dict:
    """Run-total breakdown: per-phase seconds/calls, iteration count and
    wall, and `coverage` = in-iteration phase seconds / iteration wall
    (the >=90% acceptance metric; None before any iteration closes)."""
    with _lock:
        phases = {k: {"secs": round(v[0], 6), "calls": v[1]}
                  for k, v in sorted(_totals.items())}
        wall, psum, n = _iter_wall, _phase_in_iter, _iter_count
    return {"phases": phases, "iterations": n,
            "wall_s": round(wall, 6), "phase_sum_s": round(psum, 6),
            "coverage": round(psum / wall, 4) if wall > 0 else None}


def reset() -> None:
    global _iter_count, _iter_wall, _phase_in_iter, _last, _cur
    with _lock:
        _totals.clear()
        _iter_count = 0
        _iter_wall = 0.0
        _phase_in_iter = 0.0
        _last = None
        _cur = None
