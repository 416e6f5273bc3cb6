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

Not ported yet (ROADMAP.md section 1, item 5): ``dist_shard_mode=rows``,
`checkpoint` (rank-0 writes, resume broadcast) and `supervisor`.
One process passes through every entry point unchanged.
"""
from __future__ import annotations

from . import bootstrap, ingest
from .bootstrap import (barrier, initialize, initialize_from_config,
                        initialize_from_env, is_distributed, process_count,
                        rank, resolve_rank, shutdown)
from .ingest import load_sharded, shard_row_block, wrap_train_set

__all__ = [
    "bootstrap", "ingest",
    "barrier", "initialize", "initialize_from_config", "initialize_from_env",
    "is_distributed", "process_count", "rank", "resolve_rank", "shutdown",
    "load_sharded", "shard_row_block", "wrap_train_set",
]
