"""Process-wide counters and gauges (port of
lightgbm_tpu/telemetry/counters.py).

Two kinds of state:

* **Counters/gauges** — a thread-safe name->number registry
  (`incr`/`add_seconds`/`set_gauge`). Always writable: one-off
  producers count unconditionally so forensic counters exist even with
  telemetry off — the CUDA-graph captures of the device loops
  (`graph_captures`, `graph_capture_seconds`, from
  ``ops/fused.py::SplitLoop.capture``), the kernel builds at first use
  (`kernel_builds`, `kernel_build_seconds`, from
  ``ops/kernels/build.py``), collective dispatches and retries
  (resilience/faults.py), preemptions, watchdog fires. Per-iteration
  producers (the bytes of each device->host fetch, `transfer_d2h_bytes`,
  and of each streamed host->device chunk, `transfer_h2d_bytes`; the
  trees grown, `grow_dispatches` / `grow_trees`) gate on `is_active()`,
  flipped by `telemetry.set_mode`: with telemetry off no counter moves
  per iteration.
* **Process gauges read at snapshot time** — peak host RSS
  (getrusage) and, where CUDA is initialized, the peak device memory
  (`torch.cuda.max_memory_allocated`; reading it does not synchronize).

The JAX package's XLA compile-event listener has no counterpart: the
port compiles nothing per shape; its one-off costs are the captures and
the builds above.

Prometheus text exposition (`prometheus_text`) renders all of it plus
caller-supplied extras; the serving `/metrics` endpoint is a thin wrapper
over it.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

__all__ = ["incr", "add_seconds", "set_gauge", "get", "is_active",
           "set_active", "snapshot", "reset", "note_capture",
           "note_kernel_build", "peak_rss_bytes", "device_peak_bytes",
           "prometheus_text"]

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_active = False


def set_active(flag: bool) -> None:
    """Hot-path gate (telemetry.set_mode owns this): per-transfer counter
    sites check `is_active()` before paying the registry lock."""
    global _active
    _active = bool(flag)


def is_active() -> bool:
    return _active


def incr(name: str, n: float = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def add_seconds(name: str, seconds: float) -> None:
    incr(name, float(seconds))


def set_gauge(name: str, value: float) -> None:
    with _lock:
        _gauges[name] = float(value)


def get(name: str, default: float = 0) -> float:
    with _lock:
        return _counters.get(name, _gauges.get(name, default))


def reset() -> None:
    """Clear counters/gauges."""
    with _lock:
        _counters.clear()
        _gauges.clear()


def note_capture(seconds: float) -> None:
    """One CUDA-graph capture of a device loop's split step (its warm-up
    step included in `seconds`)."""
    incr("graph_captures")
    add_seconds("graph_capture_seconds", seconds)


def note_kernel_build(count: int, seconds: float) -> None:
    """`count` CUDA sources compiled by nvcc at first use, in `seconds`
    of wall (the builds run in parallel)."""
    incr("kernel_builds", count)
    add_seconds("kernel_build_seconds", seconds)


def peak_rss_bytes() -> int:
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru) * 1024      # linux reports kilobytes
    except Exception:              # pragma: no cover - non-posix
        return 0


def device_peak_bytes() -> Optional[int]:
    """torch.cuda.max_memory_allocated() when CUDA is initialized in this
    process (None otherwise: reading it must not initialize CUDA)."""
    try:
        import torch
        if not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.max_memory_allocated())
    except Exception:              # pragma: no cover - no CUDA build
        return None


def snapshot() -> dict:
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
    gauges["peak_rss_bytes"] = peak_rss_bytes()
    dev = device_peak_bytes()
    if dev is not None:
        gauges["device_peak_bytes"] = dev
    return {"counters": counters, "gauges": gauges}


# -- Prometheus text exposition --------------------------------------------
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    return "lgbm_tpu_" + _NAME_RE.sub("_", str(name))


def _split_labels(name: str):
    """`family{label="v"}` -> (family, `{...}`). Plain names pass through
    with an empty label set; the label block is already Prometheus syntax
    and is appended verbatim after the sanitized family name."""
    name = str(name)
    brace = name.find("{")
    if brace < 0:
        return name, ""
    return name[:brace], name[brace:]


def prometheus_text(extra_counters: Optional[Dict] = None,
                    latency: Optional[Dict[str, dict]] = None,
                    extra_gauges: Optional[Dict] = None) -> str:
    """Render everything as Prometheus text format (version 0.0.4).
    `latency` takes serving-stats histogram snapshots ({name: {count,
    mean_ms, p50_ms, p95_ms, p99_ms}}) and renders them as summaries."""
    snap = snapshot()
    lines: List[str] = []
    typed = set()                    # families already TYPE-declared:
    # labeled series of one family share a single TYPE line

    def emit(name: str, kind: str, value) -> None:
        family, labels = _split_labels(name)
        mname = _metric_name(family)
        if mname not in typed:
            typed.add(mname)
            lines.append(f"# TYPE {mname} {kind}")
        lines.append(f"{mname}{labels} {value}")

    merged_counters = dict(snap["counters"])
    merged_counters.update(extra_counters or {})
    for key in sorted(merged_counters):
        family, labels = _split_labels(key)
        emit(family + "_total" + labels, "counter", merged_counters[key])
    merged_gauges = dict(snap["gauges"])
    merged_gauges.update(extra_gauges or {})
    for key in sorted(merged_gauges):
        emit(key, "gauge", merged_gauges[key])
    for key in sorted(latency or {}):
        hist = latency[key]
        family, labels = _split_labels(key)
        mname = _metric_name(family) + "_seconds"
        if mname not in typed:
            typed.add(mname)
            lines.append(f"# TYPE {mname} summary")
        for quantile, field in (("0.5", "p50_ms"), ("0.95", "p95_ms"),
                                ("0.99", "p99_ms")):
            qlabels = (labels[:-1] + f',quantile="{quantile}"}}' if labels
                       else f'{{quantile="{quantile}"}}')
            lines.append(f'{mname}{qlabels} {hist[field] / 1e3}')
        total_s = hist["mean_ms"] * hist["count"] / 1e3
        lines.append(f"{mname}_sum{labels} {total_s}")
        lines.append(f"{mname}_count{labels} {hist['count']}")
    return "\n".join(lines) + "\n"
