"""Flight recorder: a bounded, structured per-run event stream (a copy of
lightgbm_tpu/telemetry/events.py).

Where spans.py answers "what happened inside this iteration" and
counters.py answers "how much has this process done", the flight
recorder answers "what happened to this RUN" — a durable, replayable
sequence of JSON records you can diff across runs and ranks after the
fact.

Two kinds of records share one stream:

* **iteration records** (`kind="iteration"`) — one per boosting
  iteration, assembled at iteration close by GBDT.train_one_iter:
  recorder phase breakdown, train/valid metric values (attached by the
  engine loop after eval), grad/hess norm summary (generic path, where
  gradients are host-visible), quantization config/renew stats, stream
  overlap fraction + peak device bytes + H2D bytes, and collective
  dispatch/retry deltas for the iteration.
* **discrete events** (`kind="checkpoint" | "rollback" | "skip_iter" |
  "fault" | "watchdog" | "preempt" | "bundle_captured" | ...`) —
  emitted at the moment they happen by resilience and the watchdogs.

Sinks: an in-memory ring (bounded deque, `LGBM_TPU_EVENTS_RING`
overrides the 4096 default, newest win) always collects while enabled;
a JSONL file sink is added when `LGBM_TPU_EVENTS=<path>` is set (or
`set_sink(path)` is called) — one JSON object per line, append-mode,
flushed per record so a killed run keeps everything already emitted.
`LGBM_TPU_EVENTS_MAX_MB` bounds the sink: when the file would exceed
the cap it is rotated to `<path>.1` (one generation kept, older
overwritten) at a record boundary, so long runs cannot fill the disk and every line in both files stays intact.

Off (the default — the recorder follows the telemetry mode) every hook
returns after one module-global read, the same shared no-op discipline
as spans/recorder, so the float path stays byte-for-byte unchanged and
the warm-iteration overhead guard holds.

Iteration records are emitted in two steps so the engine can attach
eval metrics without a second JSONL line: `iteration_record(rec)`
stages the record; `attach_metrics(...)` merges the eval results; the
stage is flushed on the next `iteration_record`, on `flush()`, or on
`close()`. Callers that never attach metrics (direct
`train_one_iter` loops) lose nothing — the staged record flushes on
the next iteration.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["enable", "enabled", "emit", "iteration_record",
           "attach_metrics", "flush", "close", "events", "counts",
           "sink_path", "set_sink", "reset"]

_enabled = False
_lock = threading.RLock()
_ring: deque = deque(maxlen=max(64, int(
    os.environ.get("LGBM_TPU_EVENTS_RING", "4096") or 4096)))
_counts: Dict[str, int] = {}        # kind -> records emitted (ring-independent)
_seq = 0
_sink = None                        # open file object (JSONL)
_sink_path: Optional[str] = None
_sink_bytes = 0                     # bytes written to the current sink file
_pending_iter: Optional[dict] = None


def _max_sink_bytes() -> int:
    """Size cap for the JSONL sink (0 = unbounded). Read per rotation
    check so tests can flip the env without reopening the sink."""
    raw = os.environ.get("LGBM_TPU_EVENTS_MAX_MB", "").strip()
    if not raw:
        return 0
    try:
        return max(0, int(float(raw) * 1024 * 1024))
    except ValueError:
        return 0


def enable(flag: bool = True) -> None:
    """Follows the telemetry mode (telemetry.set_mode owns this).
    Enabling opens the JSONL sink if `LGBM_TPU_EVENTS` names a path;
    disabling flushes and closes it."""
    global _enabled
    active = bool(flag)
    if active == _enabled:
        # still honor a sink path that appeared since the last enable
        if active and _sink is None:
            _maybe_open_env_sink()
        _enabled = active
        return
    if active:
        _maybe_open_env_sink()
        _enabled = True
    else:
        _enabled = False
        close()


def enabled() -> bool:
    return _enabled


def _maybe_open_env_sink() -> None:
    path = os.environ.get("LGBM_TPU_EVENTS", "").strip()
    if path and _sink is None:
        set_sink(path)


def set_sink(path: Optional[str]) -> Optional[str]:
    """Point the JSONL sink at `path` (append mode; None closes it).
    Returns the active sink path."""
    global _sink, _sink_path, _sink_bytes
    with _lock:
        if _sink is not None:
            try:
                _sink.close()
            except OSError:  # pragma: no cover
                pass
            _sink, _sink_path, _sink_bytes = None, None, 0
        if path:
            _sink = open(path, "a", encoding="utf-8")
            _sink_path = path
            try:
                _sink_bytes = os.path.getsize(path)
            except OSError:  # pragma: no cover
                _sink_bytes = 0
        return _sink_path


def _rotate_sink_locked() -> None:
    """Move the full sink file aside to `<path>.1` and reopen fresh.
    Runs at a record boundary (after a flushed line) so neither file
    ever holds a torn line."""
    global _sink, _sink_bytes
    path = _sink_path
    try:
        _sink.close()
    except OSError:  # pragma: no cover
        pass
    try:
        os.replace(path, path + ".1")
    except OSError:  # pragma: no cover
        pass
    _sink = open(path, "a", encoding="utf-8")
    _sink_bytes = 0


def sink_path() -> Optional[str]:
    return _sink_path


def _write(record: dict) -> None:
    """Append to ring + sink. Caller holds no invariants: the record is
    complete."""
    global _seq
    with _lock:
        _seq += 1
        record.setdefault("seq", _seq)
        _counts[record["kind"]] = _counts.get(record["kind"], 0) + 1
        _ring.append(record)
        if _sink is not None:
            line = json.dumps(record, sort_keys=True,
                              default=_json_default) + "\n"
            _sink.write(line)
            _sink.flush()
            global _sink_bytes
            _sink_bytes += len(line)
            cap = _max_sink_bytes()
            if cap and _sink_bytes >= cap:
                _rotate_sink_locked()


def _json_default(obj):
    try:
        return float(obj)          # numpy / torch scalars
    except Exception:
        return str(obj)


def emit(kind: str, **fields) -> None:
    """Record one discrete event (checkpoint written, rollback, fault
    fired, watchdog, preemption...). No-op while disabled."""
    if not _enabled:
        return
    rec = {"kind": kind, "ts": time.time()}
    rec.update(fields)
    _write(rec)


def iteration_record(rec: dict) -> None:
    """Stage one iteration record (GBDT.train_one_iter owns this). The
    previously staged record — by now final, metrics attached or not —
    is flushed first so the stream stays ordered."""
    if not _enabled:
        return
    with _lock:
        _flush_pending_locked()
        staged = {"kind": "iteration", "ts": time.time()}
        staged.update(rec)
        global _pending_iter
        _pending_iter = staged


def attach_metrics(evaluation_result_list) -> None:
    """Merge the engine loop's eval results ([(dataset, metric, value,
    higher_better), ...]) into the staged iteration record."""
    if not _enabled or not evaluation_result_list:
        return
    with _lock:
        if _pending_iter is None:
            return
        metrics = _pending_iter.setdefault("metrics", {})
        for item in evaluation_result_list:
            try:
                data_name, metric_name, value = item[0], item[1], item[2]
            except (TypeError, IndexError):
                continue
            metrics[f"{data_name}:{metric_name}"] = float(value)


def _flush_pending_locked() -> None:
    global _pending_iter
    if _pending_iter is not None:
        pend, _pending_iter = _pending_iter, None
        _write(pend)


def flush() -> None:
    """Flush the staged iteration record (engine end-of-train calls
    this so the last iteration's metrics land on disk)."""
    with _lock:
        _flush_pending_locked()


def close() -> None:
    """Flush and close the JSONL sink (ring survives)."""
    with _lock:
        _flush_pending_locked()
        set_sink(None)


def events(kind: Optional[str] = None) -> List[dict]:
    """Snapshot of the in-memory ring (oldest first), optionally
    filtered by kind. Includes the staged iteration record."""
    with _lock:
        out = list(_ring)
        if _pending_iter is not None:
            out.append(dict(_pending_iter))
    if kind is not None:
        out = [e for e in out if e.get("kind") == kind]
    return out


def counts() -> Dict[str, int]:
    """Emitted-record counts per kind over the process lifetime of the
    current window (reset() clears; ring eviction does not)."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Clear the ring/counts/staged record (sink stays open: a bench
    resetting after warmup keeps appending to the same file)."""
    global _pending_iter, _seq
    with _lock:
        _ring.clear()
        _counts.clear()
        _pending_iter = None
        _seq = 0
