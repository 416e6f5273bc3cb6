"""Multi-process training layer of the port.

Port of lightgbm_tpu/distributed/ for the data-parallel slice:

* `bootstrap` -- process-group bring-up from the reference's
  ``machines`` / ``num_machines`` / ``machine_rank`` /
  ``local_listen_port`` surface (env-var overrides for launchers) onto
  torch.distributed, and a barrier.
* `ingest` -- rank-partitioned loading: each process bins its own row
  block against cooperatively found bin mappers (io/distributed.py), then
  the compact binned blocks are all-gathered so every process holds the
  same full `Dataset` (``dist_shard_mode=replicated``).

* `checkpoint` -- the rank-0 checkpoint topology: every rank captures
  (the scores of every rank gathered), rank 0 writes, a barrier; a
  resume is read by rank 0 and broadcast to every rank
  (``DistributedCheckpointManager``, ``restore_for_resume``).

A data-parallel run (``tree_learner=data``, parallel/learners.py) trains
every mode the single-card device learner trains: float or quantized
gradients, bagging, GOSS, RF, DART, leaf renewal, query groups; it
checkpoints through rank 0, resumes on every rank, and exits 76 on every
rank when one is preempted (resilience/preempt.py's vote).

Not ported yet, each raising naming ROADMAP.md section 1, item 5:
feature-parallel and voting learners, ``dist_shard_mode=rows``, streamed
data-parallel, the host-loop data-parallel learner, `supervisor` (the
supervised bring-up, elastic rejoin and rank-failure recovery) and the
telemetry aggregation across ranks. One process passes through every
entry point unchanged.
"""
from __future__ import annotations

from . import bootstrap, checkpoint, ingest
from .bootstrap import (barrier, initialize, initialize_from_config,
                        initialize_from_env, is_distributed, process_count,
                        rank, resolve_rank, shutdown)
from .ingest import load_sharded, shard_row_block, wrap_train_set

__all__ = [
    "bootstrap", "checkpoint", "ingest",
    "barrier", "initialize", "initialize_from_config", "initialize_from_env",
    "is_distributed", "process_count", "rank", "resolve_rank", "shutdown",
    "load_sharded", "shard_row_block", "wrap_train_set",
]
