"""Graceful preemption: SIGTERM/SIGINT -> checkpoint -> exit 76 (port of
lightgbm_tpu/resilience/preempt.py, one process).

Cloud fleets evict hosts with a SIGTERM and a short grace window. The
stock outcome is the worst one: training dies mid-iteration and the run
restarts from whatever the last *periodic* checkpoint captured. This
module turns the notice into a clean, resumable exit:

* ``install_handlers`` arms SIGTERM/SIGINT to set a process-wide flag —
  nothing else happens in signal context (the handler is async-signal
  constrained; all real work runs at the next iteration boundary).
* ``engine.train`` polls the flag at the same per-iteration site as
  ``faults.kill_point``. When set, it writes an *emergency checkpoint*
  (atomic file + checksum) and exits with ``PREEMPT_EXIT_CODE`` (76) — a
  launcher-visible contract: 76 means "checkpointed cleanly, relaunch
  with ``resume_from`` and ``num_boost_round=None``".
* The fault verb ``preempt@iter=N`` (resilience/faults.py) arms the
  flag deterministically for tests, through the same code path a real
  SIGTERM takes.

The emergency checkpoint records the run's original round target
(``target_rounds`` in the manifest) so a resume finishes the right
budget without the operator restating it.

With one process there is no vote: ``resolve_group_sync`` is false and
``group_requested`` is the local flag. The JAX package's vote across
ranks (one byte per rank per iteration over its host allgather, and the
state that decides whether it runs) waits for the port's multi-GPU layer.
"""
from __future__ import annotations

import os
import signal
import threading

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log

__all__ = ["PREEMPT_EXIT_CODE", "install_handlers", "arm", "requested",
           "reason", "clear", "resolve_group_sync",
           "group_requested"]

# exit-code contract: the process wrote a durable emergency checkpoint and
# can be resumed bit-identically with resume_from. Chosen clear of the shell (126/127/128+n) and
# sysexits ranges actually emitted by this stack.
PREEMPT_EXIT_CODE = 76

_requested = threading.Event()
_installed = False
_reason = ""


def _on_signal(signum, frame) -> None:   # pragma: no cover - signal ctx
    # async-signal context: set the flag, nothing else. The iteration
    # boundary does the checkpointing with a full Python stack.
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    arm(f"signal:{name}")


def install_handlers() -> bool:
    """Arm SIGTERM/SIGINT to request a graceful preemption. Idempotent;
    returns False (and stays un-armed) off the main thread, where
    CPython refuses signal.signal. ``LGBM_TPU_NO_SIGNAL_HANDLERS=1``
    disables installation entirely: a harness that owns the process's
    signal disposition (pytest under a watchdog timeout, notebook
    kernels) must keep it — a swallowed harness SIGTERM would otherwise
    arm the flag and turn every later train() in the process into an
    exit-76."""
    global _installed
    if os.environ.get("LGBM_TPU_NO_SIGNAL_HANDLERS", "") == "1":
        return False
    if _installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:   # pragma: no cover - non-main interpreter thread
        return False
    _installed = True
    return True


def arm(why: str = "requested") -> None:
    """Set the preemption flag (signal handler, fault verb, or tests).
    First arm wins; re-arming is a no-op."""
    global _reason
    if _requested.is_set():
        return
    _reason = str(why)
    _requested.set()
    telem_counters.incr("preempts")
    telem_events.emit("preempt", phase="armed", reason=_reason)
    log.warning("preemption requested (%s): will checkpoint and exit %d "
                "at the next iteration boundary", _reason,
                PREEMPT_EXIT_CODE)


def requested() -> bool:
    """Local flag only — no collective. One Event read."""
    return _requested.is_set()


def reason() -> str:
    return _reason


def clear() -> None:
    """Reset the flag (tests; a resumed process starts clean anyway)."""
    global _reason
    _requested.clear()
    _reason = ""


def resolve_group_sync() -> bool:
    """Whether the per-iteration preempt vote across ranks runs: never
    with one process."""
    return False


def group_requested() -> bool:
    """True when the preemption flag is set (one process: the local flag,
    one Event read)."""
    return _requested.is_set()
