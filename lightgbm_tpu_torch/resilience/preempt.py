"""Graceful preemption: SIGTERM/SIGINT -> checkpoint -> exit 76 (port of
lightgbm_tpu/resilience/preempt.py).

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

Across ranks (a data-parallel run) the ranks vote: at each iteration
boundary every rank sends one byte, its flag, over the host all-gather
lane (io/distributed.py), and all of them checkpoint at the same boundary
and exit 76 when any one was preempted. Whether the vote runs is agreed
once, at the training loop's entry (``resolve_group_sync``: every rank
must be armed -- handlers installed or ``LGBM_TPU_PREEMPT_SYNC=1``), so an
asymmetric arming cannot leave some ranks waiting in the per-iteration
all-gather. With one process there is no vote: ``group_requested`` is the
local flag.
"""
from __future__ import annotations

import os
import signal
import threading

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log

__all__ = ["PREEMPT_EXIT_CODE", "install_handlers", "arm", "requested",
           "reason", "clear", "sync_enabled", "resolve_group_sync",
           "group_requested"]

# exit-code contract: the process wrote a durable emergency checkpoint and
# can be resumed bit-identically with resume_from. Chosen clear of the shell (126/127/128+n) and
# sysexits ranges actually emitted by this stack.
PREEMPT_EXIT_CODE = 76

_requested = threading.Event()
_installed = False
_reason = ""
# the group's decision whether the vote runs (resolve_group_sync)
_group_sync = False


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
    """Reset the flag and the group's vote decision (tests; a resumed
    process starts clean anyway)."""
    global _reason, _group_sync
    _requested.clear()
    _reason = ""
    _group_sync = False


def sync_enabled() -> bool:
    """This process's own arming of the vote: handlers installed, or
    ``LGBM_TPU_PREEMPT_SYNC=1``. The group decides from every rank's
    (resolve_group_sync), never from this alone: install_handlers
    declines off the main thread, so arming can differ between ranks."""
    return _installed or os.environ.get("LGBM_TPU_PREEMPT_SYNC", "") == "1"


def resolve_group_sync() -> bool:
    """Agree once, collectively, whether the per-iteration vote runs:
    called at the training loop's entry, which every rank reaches
    together. Each rank sends its sync_enabled() byte; the vote runs only
    when every rank is armed (a mismatch disables it everywhere, with a
    warning, rather than leaving the armed ranks in the per-iteration
    all-gather). One process: False, there is no vote."""
    global _group_sync
    from ..distributed import bootstrap
    if not bootstrap.is_distributed():
        _group_sync = False
        return _group_sync
    from ..io.distributed import _allgather_host_bytes
    votes = _allgather_host_bytes(b"\x01" if sync_enabled() else b"\x00")
    armed = [v[:1] == b"\x01" for v in votes]
    _group_sync = all(armed)
    if not _group_sync and any(armed):
        unarmed = [i for i, a in enumerate(armed) if not a]
        telem_events.emit("preempt", phase="vote_disabled",
                          unarmed_ranks=unarmed)
        log.warning("preempt vote disabled: arming is asymmetric (rank(s) "
                    "%s un-armed)", unarmed)
    return _group_sync


def group_requested() -> bool:
    """True when any rank has the preemption flag set. One process, or
    with the vote off: the local flag (one Event read). Under the vote:
    each rank's byte over the host all-gather lane (framed with the
    iteration epoch, so a desynced rank fails typed), and a rank that
    learns of a peer's preemption arms its own flag ("peer")."""
    local = _requested.is_set()
    if not _group_sync:
        return local
    from ..distributed import bootstrap
    if not bootstrap.is_distributed():
        return local
    from ..io.distributed import _allgather_host_bytes
    votes = _allgather_host_bytes(b"\x01" if local else b"\x00")
    hit = any(v[:1] == b"\x01" for v in votes)
    if hit and not local:
        arm("peer")
    return hit
