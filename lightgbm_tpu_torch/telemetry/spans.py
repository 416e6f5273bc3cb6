"""Nestable monotonic-clock spans with Chrome trace-event export (a copy
of lightgbm_tpu/telemetry/spans.py).

A span is a `with telemetry.spans.span("name"):` block timed on
`time.perf_counter()`. Completed spans land in a bounded ring buffer
(newest win; default 65536 events, `LGBM_TPU_TRACE_RING` overrides) and
export as Chrome/Perfetto trace-event JSON via `dump_trace(path)` —
load the file in chrome://tracing or ui.perfetto.dev.

Disabled (the default) every `span()` call returns one shared no-op
context manager after a single module-global read, so hooks can stay in
hot paths permanently. Thread identity rides on each event (`tid`), so
concurrent threads render as separate tracks; nesting within a
thread is inferred from the timestamps, the standard trace-event
semantics.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List

__all__ = ["NULL_SPAN", "span", "add_event", "enable", "enabled",
           "events", "clear", "dump_trace", "epoch", "set_pid", "pid"]


class _NullSpan:
    """The shared do-nothing context manager every disabled hook returns
    (spans here, phases in recorder.py): no allocation, no clock read."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

_enabled = False
_lock = threading.Lock()
_events = deque(maxlen=max(16, int(os.environ.get(
    "LGBM_TPU_TRACE_RING", 65536))))

# perf_counter -> unix epoch at import: every event's `ts` lands on the
# wall clock (microseconds since the unix epoch), a base that is common
# across processes — which is what merging per-rank traces requires.
# Monotonicity within the process is preserved (the offset is constant).
_EPOCH = time.time() - time.perf_counter()

# trace `pid` override: a multi-process run sets this to the rank so
# per-rank dumps load side by side in Perfetto (one track per rank).
# None = real os.getpid().
_pid = None


def epoch() -> float:
    """The constant perf_counter -> unix-seconds offset used for `ts`."""
    return _EPOCH


def set_pid(value) -> None:
    """Override the `pid` stamped on trace events (a rank; None restores
    the real process id)."""
    global _pid
    _pid = None if value is None else int(value)


def pid() -> int:
    return os.getpid() if _pid is None else _pid


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = bool(flag)


def enabled() -> bool:
    return _enabled


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        add_event(self.name, time.perf_counter() - self.t0,
                  t0=self.t0, **self.args)
        return False


def span(name: str, **args):
    """Context manager timing a block as one trace event. `args` become
    the event's `args` payload (small JSON-able values only)."""
    if not _enabled:
        return NULL_SPAN
    return _Span(name, args)


def add_event(name: str, dur_s: float, t0: float = None, **args) -> None:
    """Record an already-timed block (the recorder's phases reuse their
    own clock reads through this instead of double-timing)."""
    if not _enabled:
        return
    if t0 is None:
        t0 = time.perf_counter() - dur_s
    ev = {"name": name, "ph": "X", "ts": (t0 + _EPOCH) * 1e6,
          "dur": dur_s * 1e6, "pid": pid(),
          "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def events() -> List[dict]:
    """Snapshot of the ring (oldest first)."""
    with _lock:
        return list(_events)


def clear() -> None:
    with _lock:
        _events.clear()


def dump_trace(path: str) -> str:
    """Write the ring as a Chrome trace-event JSON file; returns `path`.
    Timestamps are wall-clock microseconds (unix epoch base), so dumps
    from different ranks share one time base and load side-by-side."""
    meta = [{"name": "process_name", "ph": "M", "pid": pid(),
             "args": {"name": (f"rank {_pid}" if _pid is not None
                               else f"pid {os.getpid()}")}}]
    doc = {"traceEvents": meta + events(), "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
