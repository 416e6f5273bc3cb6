"""Phase timers + profiler integration (port of
lightgbm_tpu/utils/timer.py).

Equivalent of the reference's TIMETAG accumulating timers (reference:
src/treelearner/serial_tree_learner.cpp:21-48, CMake USE_TIMETAG) printed at
teardown, plus a torch.profiler trace hook for the device timeline.

Enable with env LGBM_TPU_TIMETAG=1 or config timetag=true; report via
`report()` or automatically at interpreter exit. No training site opens a
`timer` yet: in the JAX package only serving does, and its sites come with
the port's serving layer.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

from . import log

_acc: Dict[str, float] = defaultdict(float)
_cnt: Dict[str, int] = defaultdict(int)
_enabled = os.environ.get("LGBM_TPU_TIMETAG", "0") not in ("0", "", "false")


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def timer(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1


def add(name: str, seconds: float) -> None:
    if _enabled:
        _acc[name] += seconds
        _cnt[name] += 1


def report() -> Dict[str, float]:
    if _acc:
        log.info("cost summary:")
        for name in sorted(_acc):
            log.info("  %-24s %10.3fs  (%d calls)",
                     name, _acc[name], _cnt[name])
    return dict(_acc)


def reset() -> None:
    _acc.clear()
    _cnt.clear()


@atexit.register
def _report_at_exit():  # pragma: no cover
    if _enabled and _acc:
        report()


def start_device_trace():
    """Start a torch.profiler session (CPU activity, and CUDA where
    present) and return it. The one profiler path of the package: the
    `device_trace` block below and telemetry's ``LGBM_TPU_XLA_TRACE``
    session both run on it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_device_trace(prof, log_dir: str, prefix: str = "trace") -> str:
    """Stop `prof` and write its Chrome trace (chrome://tracing, Perfetto)
    as ``<prefix>_<pid>.json`` in `log_dir`; returns the file's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    out = os.path.join(log_dir, "%s_%d.json" % (prefix, os.getpid()))
    prof.export_chrome_trace(out)
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture the device timeline of the block and write it as
    ``trace_<pid>.json`` in `log_dir`. The reference has no device
    tracing; this replaces its wall-clock logs for kernel-level analysis.
    Yields the profiler."""
    prof = start_device_trace()
    try:
        yield prof
    finally:
        stop_device_trace(prof, log_dir)
