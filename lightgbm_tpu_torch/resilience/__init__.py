"""Fault-tolerant training: checkpoints, non-finite sentries, fault
injection, graceful preemption (port of lightgbm_tpu/resilience).

* ``checkpoint`` — atomic, checksummed, rotated full-state checkpoints
  and ``engine.train(resume_from=...)`` restore, in the JAX package's
  file format (a checkpoint moves between the two packages).
* ``sentries``  — non-finite guards over each boosting iteration
  (``on_nonfinite = raise | skip_iter | rollback``) and a loss-spike
  rollback callback.
* ``faults``    — deterministic, seedable fault injection
  (``LGBM_TPU_FAULT_SPEC``) at the gradient boundary and the iteration
  boundary, with bounded exponential-backoff retry for transient
  collectives.
* ``preempt``   — SIGTERM/SIGINT (or ``preempt@iter=``) -> emergency
  checkpoint -> exit 76.
"""
from . import faults, preempt                      # noqa: F401
from .checkpoint import (CheckpointData, CheckpointError,       # noqa: F401
                         CheckpointManager, atomic_write_text,
                         find_checkpoint, load_checkpoint,
                         restore_checkpoint, save_checkpoint)
from .faults import (FaultPlan, TransientCollectiveError,       # noqa: F401
                     run_collective)
from .sentries import NonFiniteError, all_finite, loss_spike_guard  # noqa: F401

__all__ = [
    "faults", "preempt", "FaultPlan", "TransientCollectiveError",
    "run_collective", "CheckpointData", "CheckpointError",
    "CheckpointManager", "atomic_write_text", "find_checkpoint",
    "load_checkpoint", "restore_checkpoint", "save_checkpoint",
    "NonFiniteError", "all_finite", "loss_spike_guard",
]
