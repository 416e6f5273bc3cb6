"""Postmortem bundles: freeze the evidence before it evaporates (port of
lightgbm_tpu/telemetry/bundle.py, one process).

A bundle is one atomic directory capturing everything a postmortem needs,
written at the moment of the incident:

    events.jsonl         the flight-recorder ring (last-N events)
    trace.json           the local span ring (Chrome trace events)
    counters.json        counters + gauges + watchdog fires
    config.json          resolved training config (set_context)
    env.json             env fingerprint (python, torch, CUDA, the
                         driver and the card, LGBM_TPU_* variables)
    MANIFEST.json        inventory + reason + identity, written LAST

The JAX package's merged fleet trace, clock.json and critical_path.json
gather ranks over the distributed lane, which the port does not have yet:
the local span ring stands in for the merged trace.

Atomicity: everything is written into a ``.tmp-`` sibling and
``os.rename``d into place, and MANIFEST.json is the last file written
inside it — so a directory without a manifest is by definition torn
(crash mid-capture) and consumers skip it.

Capture is opt-in via ``LGBM_TPU_BUNDLE_DIR`` (unset = every trigger
returns after one env read) and rotation-capped by
``LGBM_TPU_BUNDLE_KEEP`` (default 5, oldest complete bundles deleted).
A per-reason cooldown (``LGBM_TPU_BUNDLE_COOLDOWN_S``, default 30)
keeps a flapping watchdog from grinding the disk.

Triggers: watchdog fires (watchdogs.py), collective deadline misses and
``kill_rank`` before ``os._exit`` (resilience/faults.py), and graceful
preemption (engine.train). Trigger sites call ``maybe_capture`` with no
lock held — capture does file I/O.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from . import counters, events, spans, watchdogs
from ..utils import log

__all__ = ["enabled", "bundle_root", "keep", "set_context",
           "maybe_capture", "capture", "complete_bundles", "reset"]

MANIFEST = "MANIFEST.json"
BUNDLE_FORMAT = 1

_seq_lock = threading.Lock()
_seq = 0
_last_capture: Dict[str, float] = {}     # reason -> monotonic stamp
_context: Dict[str, dict] = {}           # "config" -> resolved params


def bundle_root() -> str:
    return os.environ.get("LGBM_TPU_BUNDLE_DIR", "").strip()


def enabled() -> bool:
    return bool(bundle_root())


def keep() -> int:
    try:
        return max(1, int(os.environ.get("LGBM_TPU_BUNDLE_KEEP", "5")
                          or 5))
    except ValueError:
        return 5


def _cooldown_s() -> float:
    try:
        return float(os.environ.get("LGBM_TPU_BUNDLE_COOLDOWN_S", "30")
                     or 30)
    except ValueError:
        return 30.0


def set_context(key: str, value: dict) -> None:
    """Register JSON-able context (the resolved config) to ride along in
    every future bundle. Cheap unconditional assignment — safe to call
    with telemetry off."""
    _context[str(key)] = value


def maybe_capture(reason: str, **fields) -> Optional[str]:
    """Capture a bundle if bundling is enabled and the per-reason
    cooldown has elapsed; never raises (an incident path must not die
    in its own forensics). Returns the bundle path or None."""
    root = bundle_root()
    if not root:
        return None
    with _seq_lock:
        now = time.monotonic()
        last = _last_capture.get(reason)
        if last is not None and now - last < _cooldown_s():
            return None
        _last_capture[reason] = now
        global _seq
        _seq += 1
        seq = _seq
    try:
        return capture(reason, root=root, seq=seq, **fields)
    except Exception as exc:  # pragma: no cover - disk-full etc.
        log.warning("bundle capture (%s) failed: %s", reason, exc)
        return None


def _sanitize(text: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(text))[:48] or "unknown"


def _env_fingerprint(rank: int, world: int) -> dict:
    fp = {"python": sys.version.split()[0],
          "platform": sys.platform,
          "argv": list(sys.argv),
          "rank": rank, "world": world, "pid": os.getpid()}
    try:
        import torch
        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            fp["card"] = torch.cuda.get_device_name(0)
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=driver_version,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10)
            if smi.returncode == 0 and smi.stdout.strip():
                fp["driver"], _, fp["power_limit"] = (
                    p.strip() for p in
                    smi.stdout.strip().splitlines()[0].partition(","))
    except Exception:  # pragma: no cover - no nvidia-smi, no CUDA build
        pass
    fp["env"] = {k: v for k, v in sorted(os.environ.items())
                 if k.startswith(("LGBM_TPU_", "LGBM_TORCH_", "CUDA_"))}
    return fp


def capture(reason: str, root: Optional[str] = None,
            seq: Optional[int] = None, **fields) -> str:
    """Write one atomic bundle directory and rotate old ones. Callers
    wanting the guarded path use ``maybe_capture``."""
    root = root or bundle_root()
    if not root:
        raise RuntimeError("LGBM_TPU_BUNDLE_DIR is not set")
    os.makedirs(root, exist_ok=True)
    rank, world = 0, 1
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    name = f"bundle-{stamp}-{_sanitize(reason)}-r{rank}-p{os.getpid()}"
    if seq:
        name += f"-{seq}"
    tmp = os.path.join(root, ".tmp-" + name)
    final = os.path.join(root, name)
    os.makedirs(tmp)
    inventory: Dict[str, int] = {}

    def _write(fname: str, text: str) -> None:
        data = text.encode("utf-8")
        with open(os.path.join(tmp, fname), "wb") as fh:
            fh.write(data)
        inventory[fname] = len(data)

    ring = events.events()
    if ring:
        _write("events.jsonl", "".join(
            json.dumps(e, sort_keys=True, default=str) + "\n"
            for e in ring))
    trace_events = spans.events()
    if trace_events:
        _write("trace.json", json.dumps(
            {"traceEvents": trace_events, "displayTimeUnit": "ms"}))
    snap = counters.snapshot()
    snap["watchdog_fired"] = watchdogs.fired()
    _write("counters.json", json.dumps(snap, sort_keys=True,
                                       default=str))
    if _context:
        _write("config.json", json.dumps(_context, sort_keys=True,
                                         default=str))
    _write("env.json", json.dumps(_env_fingerprint(rank, world),
                                  sort_keys=True))
    manifest = {"bundle_format": BUNDLE_FORMAT, "reason": str(reason),
                "ts_unix": time.time(), "rank": rank, "world": world,
                "pid": os.getpid(), "files": dict(inventory)}
    for key, val in fields.items():
        manifest.setdefault(key, val)
    # the manifest is written last INSIDE the tmp dir, then the rename
    # publishes: any observable bundle dir without a manifest is torn
    _write(MANIFEST, json.dumps(manifest, sort_keys=True, default=str))
    os.rename(tmp, final)
    counters.incr("bundles_captured")
    events.emit("bundle_captured", reason=str(reason), path=final,
                files=sorted(inventory))
    log.warning("postmortem bundle captured (%s): %s", reason, final)
    _rotate(root)
    return final


def complete_bundles(root: Optional[str] = None) -> List[str]:
    """The bundle directories under `root` (default: the capture root)
    that have their MANIFEST.json, oldest first; torn ones (a capture
    that died before its manifest) are skipped."""
    root = root or bundle_root()
    if not root or not os.path.isdir(root):
        return []
    return sorted(
        d for d in os.listdir(root)
        if d.startswith("bundle-")
        and os.path.isfile(os.path.join(root, d, MANIFEST)))


def _rotate(root: str) -> None:
    complete = complete_bundles(root)
    for stale in complete[:-keep()]:
        shutil.rmtree(os.path.join(root, stale), ignore_errors=True)


def reset() -> None:
    """Clear cooldowns + sequence (context survives — the resolved
    config is still the run's config after a bench reset)."""
    global _seq
    with _seq_lock:
        _seq = 0
        _last_capture.clear()
