"""Rank-0 checkpoint topology: one writer, every rank restores.

Port of lightgbm_tpu/distributed/checkpoint.py. The reference's cluster
runs write the model from machine 0 only (reference: application.cpp --
output paths are rank-0 work); checkpoints follow the same topology on
top of resilience/checkpoint.py:

* **save** -- every rank captures (a collective: the training scores of
  every rank's block are gathered into one global array), rank 0 writes
  the file (atomic, checksummed, rotated), then every rank meets at a
  barrier, so no rank runs past a checkpoint that is not yet durable.
  The other ranks do no I/O and need no writable filesystem.
* **restore** -- after a barrier, rank 0 finds and reads the checkpoint
  bytes and broadcasts them over the host all-gather lane
  (io/distributed.py); every rank restores from the identical bytes,
  cutting the stored global scores to its own block. No shared
  filesystem is needed.

With one process both are the plain CheckpointManager and
restore_checkpoint (no barrier, no broadcast), so callers use them
unconditionally. The JAX package's elastic rejoin at a checkpoint
(LGBM_TPU_ELASTIC_REJOIN=1, its supervisor) is not ported: asking for it
raises.
"""
from __future__ import annotations

import os
from typing import Optional

from ..resilience.checkpoint import (CheckpointData, CheckpointManager,
                                     capture, find_checkpoint,
                                     load_checkpoint, restore_checkpoint)
from ..utils import log
from ..utils.log import LightGBMError
from . import bootstrap

__all__ = ["DistributedCheckpointManager", "restore_for_resume"]


def _broadcast_bytes_from_rank0(payload: Optional[bytes]) -> bytes:
    """Rank 0's bytes on every rank (the all-gather lane as a broadcast:
    the other ranks contribute empty payloads)."""
    from ..io.distributed import _allgather_host_bytes
    return _allgather_host_bytes(payload if payload is not None else b"")[0]


def _refuse_rejoin() -> None:
    if os.environ.get("LGBM_TPU_ELASTIC_REJOIN", "") == "1":
        raise LightGBMError(
            "elastic rejoin at a checkpoint (LGBM_TPU_ELASTIC_REJOIN=1) is "
            "not supported by lightgbm_tpu_torch yet (ROADMAP.md section "
            "1, item 5: distributed/supervisor.py)")


class DistributedCheckpointManager:
    """resilience.checkpoint.CheckpointManager with the rank-0 writer and
    the barrier after each save. save() returns rank 0's path ("" on the
    other ranks)."""

    def __init__(self, directory: str, keep_last: int = 3,
                 prefix: str = "ckpt"):
        self.directory = directory
        self._keep_last = keep_last
        self._prefix = prefix
        self._writer_rank = bootstrap.rank()
        self._writer = (CheckpointManager(directory, keep_last, prefix)
                        if self._writer_rank == 0 else None)

    def _current_writer(self) -> Optional[CheckpointManager]:
        """The writer of the CURRENT rank (write duty follows the rank
        number, which a re-formed group may renumber): rank 0's
        CheckpointManager, None elsewhere."""
        r = bootstrap.rank()
        if r != self._writer_rank:
            self._writer_rank = r
            self._writer = (CheckpointManager(self.directory,
                                              self._keep_last, self._prefix)
                            if r == 0 else None)
        return self._writer

    def save(self, booster, history: Optional[list] = None,
             extra_meta=None, allow_rejoin: bool = True) -> str:
        """Capture on every rank, write on rank 0, meet at the barrier.
        allow_rejoin (the JAX package's: whether a pending rejoin may
        re-form the group at this checkpoint; a preempted run's
        emergency save passes False) raises where rejoin is asked for."""
        if allow_rejoin:
            _refuse_rejoin()
        writer = self._current_writer()
        path = ""
        if bootstrap.is_distributed():
            meta, arrays = capture(booster, history, extra_meta=extra_meta)
            if writer is not None:
                path = writer.save_captured(meta, arrays)
        elif writer is not None:
            path = writer.save(booster, history=history,
                               extra_meta=extra_meta)
        bootstrap.barrier("ckpt_save")
        return path

    def latest(self) -> Optional[CheckpointData]:
        writer = self._current_writer()
        return writer.latest() if writer is not None else None


def restore_for_resume(booster, source) -> CheckpointData:
    """Resume every rank from `source` (a checkpoint file or directory,
    as engine.train's resume_from, or CheckpointData): rank 0 resolves it
    and broadcasts the file's bytes after the resume barrier; every rank
    restores from them. One process: restore_checkpoint."""
    if not bootstrap.is_distributed():
        data = (source if isinstance(source, CheckpointData)
                else find_checkpoint(source))
        restore_checkpoint(booster, data)
        return data
    bootstrap.barrier("ckpt_resume")
    payload, path = None, ""
    if bootstrap.rank() == 0:
        data0 = (source if isinstance(source, CheckpointData)
                 else find_checkpoint(source))
        path = data0.path
        with open(path, "rb") as fh:
            payload = fh.read()
    # the file format is the wire format: every rank parses the same bytes
    data = load_checkpoint(path or "<rank 0>",
                           _broadcast_bytes_from_rank0(payload))
    restore_checkpoint(booster, data)
    log.info("rank %d restored checkpoint at iteration %d",
             bootstrap.rank(), data.iteration)
    return data
