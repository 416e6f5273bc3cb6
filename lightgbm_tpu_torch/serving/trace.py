"""Per-request trace propagation through the serving path (port of
lightgbm_tpu/serving/trace.py, on the port's telemetry/events.py).

Every HTTP request gets a request id (an incoming ``X-Request-Id``
header is honored, else one is generated) and the id is always returned
in the response header — correlation is free. A *sampled* subset of
requests additionally gets a full timeline: linked ``trace_span``
events in the flight-recorder stream, one per hop of the serving path
(``router`` version selection, ``batcher`` queue wait, ``predictor``
device execute, ``server`` end-to-end), all carrying the same
``trace`` id so a grep of the event stream reassembles a single
request's journey.

Sampling is deterministic error-diffusion (an accumulator adds the
rate per request and emits when it crosses 1.0), so `rate=0.25` traces
exactly every 4th request — no RNG, reproducible in tests. The rate
comes from ``LGBM_TPU_TRACE_SAMPLE`` (or `configure(rate)`, which the
CLI wires to the ``serve_trace_sample`` param); the default is 0.0 and
tracing also requires the event stream to be enabled, so the untraced
hot path costs one module-global read plus one float add — the same
no-op discipline as spans/events.

The Trace object travels *explicitly* with the request (a slot on the
batcher's `_Pending`), not via thread-locals: the flush worker emits
the batcher/predictor spans from its own thread.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from ..telemetry import events

__all__ = ["configure", "sample_rate", "new_request_id", "start",
           "Trace", "reset"]

_lock = threading.Lock()
_rate: Optional[float] = None      # None = parse env on first use
_accum = 0.0                       # error-diffusion sampling accumulator


def configure(rate: Optional[float] = None) -> float:
    """Install a sampling rate in [0, 1] (None re-reads
    ``LGBM_TPU_TRACE_SAMPLE``). Returns the active rate."""
    global _rate, _accum
    if rate is None:
        raw = os.environ.get("LGBM_TPU_TRACE_SAMPLE", "").strip()
        try:
            rate = float(raw) if raw else 0.0
        except ValueError:
            rate = 0.0
    with _lock:
        _rate = min(1.0, max(0.0, float(rate)))
        _accum = 0.0
        return _rate


def sample_rate() -> float:
    if _rate is None:
        configure()
    return _rate


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def start(request_id: Optional[str] = None) -> Optional["Trace"]:
    """Begin a trace for one request if it is sampled. Returns None
    (sampled out / tracing off / events disabled) or a Trace whose id
    is `request_id` when given."""
    if not events.enabled():
        return None
    rate = sample_rate()
    if rate <= 0.0:
        return None
    global _accum
    with _lock:
        _accum += rate
        if _accum < 1.0:
            return None
        _accum -= 1.0
    return Trace(request_id or new_request_id())


class Trace:
    """One sampled request's timeline. `span(name, dur_s, **fields)`
    records a linked ``trace_span`` event; `t_offset_ms` is the span's
    start relative to trace start, so spans reassemble into a timeline
    regardless of emission order across threads."""

    __slots__ = ("trace_id", "t0")

    def __init__(self, trace_id: str):
        self.trace_id = str(trace_id)
        self.t0 = time.monotonic()

    def span(self, span: str, dur_s: float, **fields) -> None:
        start_s = max(0.0, time.monotonic() - self.t0 - dur_s)
        events.emit("trace_span", trace=self.trace_id, span=span,
                    t_offset_ms=round(start_s * 1e3, 3),
                    dur_ms=round(float(dur_s) * 1e3, 3), **fields)


def reset() -> None:
    """Forget the cached rate/accumulator (tests that monkeypatch
    LGBM_TPU_TRACE_SAMPLE re-parse on next use)."""
    global _rate, _accum
    with _lock:
        _rate = None
        _accum = 0.0
