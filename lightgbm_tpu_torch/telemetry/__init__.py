"""Telemetry: structured tracing and metrics of training (port of
lightgbm_tpu/telemetry).

Three layers, all off by default and costing one module-global read per
hook when off:

* `spans` — nestable monotonic-clock spans in a ring buffer with
  Chrome/Perfetto trace-event export (`telemetry.dump_trace(path)`).
* `counters` — process-wide counters/gauges (CUDA-graph captures and
  kernel builds with their seconds, device transfer bytes, grown trees,
  collective retries, peak host RSS and peak device memory) with
  Prometheus text exposition (`prometheus_text`).
* `recorder` — per-iteration phase breakdown on the host clock
  (gradient, bagging, boost_avg, grow_dispatch, sentry, host_sync,
  tree_replay, score_update, eval), read by `phase_breakdown()` and the
  `record_telemetry` callback.

Built on top of those, the flight-recorder layer: `events` (durable
structured per-iteration JSONL stream, `LGBM_TPU_EVENTS=path`),
`watchdogs` (slow-iteration / overlap / grad-norm-spike monitors) and
`bundle` (atomic postmortem directories, `LGBM_TPU_BUNDLE_DIR`). The
JAX package's `clock`, `timeline` and `aggregate` gather ranks over the
distributed lane and wait for the multi-GPU port.

Modes (`telemetry` config param, `LGBM_TPU_TELEMETRY` env — env wins):

* ``off``     every hook is a no-op; the training path is byte for byte
  unchanged (the low-frequency forensic counters still count).
* ``summary`` recorder + hot-path counters + events on: per-iteration
  phase accounting, `telemetry_summary()` one-line JSON.
* ``trace``   summary plus the span ring: every phase/span lands in the
  trace buffer for `dump_trace`. With ``LGBM_TPU_XLA_TRACE=<dir>`` (the
  JAX package's variable, so users' settings carry over) entering trace
  mode also starts a `torch.profiler` session (CPU, and CUDA where
  present), whose Chrome trace of the device kernels `dump_trace` (or
  leaving trace mode) writes into that directory.

No mode synchronizes the device: times are host-clock times (see
recorder.py for what `grow_dispatch` and `host_sync` hold).
"""
from __future__ import annotations

import os

from ..utils import log, timer
from . import bundle, counters, events, recorder, spans, watchdogs
from .spans import span

__all__ = ["counters", "recorder", "spans", "span", "events", "watchdogs",
           "bundle", "mode", "set_mode", "enabled", "resolve_mode",
           "configure", "dump_trace", "telemetry_summary",
           "phase_breakdown", "prometheus_text", "record_iteration",
           "reset", "device_trace_active", "device_trace_path",
           "note_grow_dispatches"]

MODES = ("off", "summary", "trace")
_mode = "off"

# -- device timeline (torch.profiler) under trace mode ----------------------
# Opt-in via LGBM_TPU_XLA_TRACE=<dir>: entering trace mode starts a
# torch.profiler session; leaving trace mode (or dump_trace) stops it and
# writes its Chrome trace into <dir>. With the env var unset — or any mode
# below trace — this is never consulted, so the off-mode path is unchanged.
_device_trace = {"prof": None, "dir": "", "path": ""}


def _device_trace_start() -> None:
    path = os.environ.get("LGBM_TPU_XLA_TRACE", "").strip()
    if not path or _device_trace["prof"] is not None:
        return
    try:
        prof = timer.start_device_trace()
    except Exception as exc:          # profiler backend unavailable
        log.warning("LGBM_TPU_XLA_TRACE: profiler start failed: %s", exc)
        return
    _device_trace.update(prof=prof, dir=path, path="")
    log.info("torch.profiler trace started (dir %s)", path)


def _device_trace_stop() -> None:
    prof = _device_trace["prof"]
    if prof is None:
        return
    _device_trace["prof"] = None
    try:
        out = timer.stop_device_trace(prof, _device_trace["dir"],
                                      "torch_trace")
        _device_trace["path"] = out
        log.info("torch.profiler trace written to %s", out)
    except Exception as exc:  # pragma: no cover - stop raced the runtime
        log.warning("LGBM_TPU_XLA_TRACE: profiler stop failed: %s", exc)


def device_trace_active() -> bool:
    return _device_trace["prof"] is not None


def device_trace_path() -> str:
    """The last torch.profiler trace file written ("" before one)."""
    return _device_trace["path"]


def mode() -> str:
    return _mode


def enabled() -> bool:
    return _mode != "off"


def set_mode(new_mode: str) -> str:
    """Switch the process-wide telemetry mode, flipping the layer gates.
    Nothing captured on the device depends on it, so flipping it never
    invalidates a captured split step."""
    global _mode
    new_mode = (new_mode or "off").strip().lower()
    if new_mode not in MODES:
        raise ValueError(
            f"telemetry mode must be one of {'/'.join(MODES)}, "
            f"got {new_mode!r}")
    _mode = new_mode
    active = new_mode != "off"
    recorder.enable(active)
    counters.set_active(active)
    events.enable(active)
    spans.enable(new_mode == "trace")
    if new_mode == "trace":
        _device_trace_start()
    else:
        _device_trace_stop()
    return _mode


def resolve_mode(param: str = "") -> str:
    """The ONE resolution point of the telemetry knobs: the
    LGBM_TPU_TELEMETRY env var when set, else the config param."""
    env = os.environ.get("LGBM_TPU_TELEMETRY", "").strip().lower()
    return env if env else (str(param or "off").strip().lower())


def configure(param: str = "", explicit: bool = False) -> str:
    """Apply a training config's `telemetry` param (GBDT init calls
    this). A default-off param does not stomp a mode set programmatically
    via `set_mode` unless the user passed it explicitly or the env var
    forces a value."""
    resolved = resolve_mode(param)
    if (explicit or resolved != "off"
            or os.environ.get("LGBM_TPU_TELEMETRY")):
        if resolved != _mode:
            set_mode(resolved)
    return _mode


def dump_trace(path: str) -> str:
    """Export the span ring as Chrome trace-event JSON; returns `path`.
    An active torch.profiler session (LGBM_TPU_XLA_TRACE) is stopped
    first, so its device trace lands beside the host spans."""
    _device_trace_stop()
    return spans.dump_trace(path)


def note_grow_dispatches(dispatches: float, trees: float = 0.0) -> None:
    """Growth-program dispatch accounting: bump the raw `grow_dispatches`
    / `grow_trees` counters and refresh the derived
    `grow_dispatches_per_tree` gauge. The device loops hold it at 1 (a
    tree's device work enqueued at once, its split step replayed inside).
    A per-tree site, so it counts only while telemetry is on (the JAX
    package counts it always): with telemetry off no counter moves per
    iteration."""
    if not counters.is_active():
        return
    counters.incr("grow_dispatches", dispatches)
    if trees:
        counters.incr("grow_trees", trees)
        counters.set_gauge(
            "grow_dispatches_per_tree",
            counters.get("grow_dispatches")
            / max(counters.get("grow_trees"), 1.0))


def telemetry_summary() -> dict:
    """One JSON-able dict with everything: mode, counters/gauges (peak
    RSS and device memory included) and the run's phase breakdown."""
    out = {"telemetry": _mode}
    out.update(counters.snapshot())
    out["phase_breakdown"] = recorder.phase_breakdown()
    return out


def phase_breakdown() -> dict:
    return recorder.phase_breakdown()


def prometheus_text(serving_snapshot=None, cache_info=None,
                    slo=None, drift=None) -> str:
    """Prometheus text for the serving `/metrics` endpoint: process
    counters + the serving stack's counters/latency histograms
    (per-version series labeled `{version="..."}`) + predictor cache
    gauges + SLO burn-rate gauges (fast/slow window p99, error rate,
    burning flags) + drift-monitor gauges. With no argument, the process
    counters and gauges alone."""
    extra_counters, latency, extra_gauges = {}, {}, {}
    if serving_snapshot:
        extra_counters.update(serving_snapshot.get("counters") or {})
        latency.update(serving_snapshot.get("latency") or {})
        for ver, vs in (serving_snapshot.get("versions") or {}).items():
            label = f'{{version="{ver}"}}'
            extra_counters[f"serve_version_requests{label}"] = \
                vs.get("requests", 0)
            extra_counters[f"serve_version_errors{label}"] = \
                vs.get("errors", 0)
            if vs.get("latency"):
                latency[f"serve_version_request{label}"] = vs["latency"]
    if cache_info:
        extra_gauges.update({f"predictor_cache_{k}": v
                             for k, v in cache_info.items()})
    if slo:
        extra_gauges["serve_slo_p99_ms"] = slo.get("slo_p99_ms", 0.0)
        extra_gauges["serve_slo_error_rate"] = \
            slo.get("slo_error_rate", 0.0)
        for win in ("fast", "slow"):
            ws = slo.get(win) or {}
            label = f'{{window="{win}"}}'
            extra_gauges[f"serve_slo_window_p99_ms{label}"] = \
                ws.get("p99_ms", 0.0)
            extra_gauges[f"serve_slo_window_error_rate{label}"] = \
                ws.get("error_rate", 0.0)
            extra_gauges[f"serve_slo_window_burning{label}"] = \
                1.0 if ws.get("burning") else 0.0
    if drift:
        extra_gauges["serve_drift_fires"] = drift.get("fires", 0)
        worst = max(drift.get("psi", {}).values(), default=0.0)
        extra_gauges["serve_drift_psi_worst"] = worst
        extra_gauges["serve_drift_psi_threshold"] = \
            drift.get("threshold", 0.0)
    return counters.prometheus_text(extra_counters or None, latency or None,
                                    extra_gauges or None)


def record_iteration(rec: dict) -> None:
    """Feed one assembled iteration record through the watchdogs and
    into the flight recorder (GBDT.train_one_iter owns the assembly).
    No-op while events are off."""
    if not events.enabled():
        return
    watchdogs.observe(rec)
    events.iteration_record(rec)


def reset() -> None:
    """Clear accumulated state (mode unchanged), e.g. after warm-up so a
    breakdown covers only the timed window."""
    recorder.reset()
    counters.reset()
    spans.clear()
    events.reset()
    watchdogs.reset()
    bundle.reset()


try:
    set_mode(resolve_mode())
except ValueError as _exc:       # bad env value: warn, stay off
    log.warning("LGBM_TPU_TELEMETRY: %s", _exc)
