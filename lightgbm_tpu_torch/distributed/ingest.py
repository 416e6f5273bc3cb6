"""Rank-partitioned dataset ingest over the process group.

Port of lightgbm_tpu/distributed/ingest.py, replicated mode. The
reference's distributed load (reference: src/io/dataset_loader.cpp
LoadFromFile under num_machines > 1): each machine reads only its row
partition and bin boundaries are found cooperatively
(io/distributed.py `distributed_find_bins`: the samples are exchanged
first, so every process ends with the IDENTICAL mapper list). Then the
*binned* blocks are all-gathered, so every process holds the complete
`Dataset` (``dist_shard_mode=replicated``): the float matrix never
crosses the wire, only the uint8 / uint16 codes and the label and weight
blocks. Each rank's data-parallel learner then keeps its own row block on
its device.

Row blocks are ceil-sized, as the data-parallel learner's
(``local_n = ceil(n / W)``, parallel/mesh.py), not the reference's
remainder-to-front split (`io/distributed.rank_row_range`).
``dist_shard_mode=rows`` (each host keeps only its block) raises: it is a
later slice's (ROADMAP.md section 1, item 5).
"""
from __future__ import annotations

import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..io.distributed import (_allgather_host_bytes, bin_block,
                              distributed_find_bins)
from ..utils import log
from ..utils.log import LightGBMError
from . import bootstrap


def shard_row_block(num_total_rows: int, rank: int,
                    num_processes: int) -> Tuple[int, int]:
    """The ceil-sized contiguous block of `rank` (the last ranks may run
    short; the learner pads)."""
    local_n = -(-num_total_rows // num_processes)
    begin = min(rank * local_n, num_total_rows)
    return begin, min(begin + local_n, num_total_rows)


def _check_mode(cfg: Config) -> None:
    mode = getattr(cfg, "dist_shard_mode", "replicated")
    if mode != "replicated":
        raise LightGBMError(
            "dist_shard_mode=%s is not supported by lightgbm_tpu_torch yet "
            "(replicated only; ROADMAP.md section 1, item 5)" % mode)


def load_partition(local_data: np.ndarray, config: Optional[Config] = None,
                   label_local=None, weight_local=None,
                   categorical: Optional[Sequence[int]] = None,
                   params=None, feature_names=None):
    """Each process passes ONLY its row partition, in rank order:
    cooperative bin finding over all partitions, local binning, then an
    all-gather of the binned blocks (with the per-rank labels and
    weights), so every process rebuilds the same full `Dataset`."""
    cfg = config or Config(params or {})
    _check_mode(cfg)
    local_data = np.ascontiguousarray(local_data, dtype=np.float64)
    if local_data.ndim == 1:
        local_data = local_data.reshape(-1, 1)
    mappers = distributed_find_bins(local_data, cfg, categorical)
    payload = pickle.dumps(
        {"binned": bin_block(local_data, mappers),
         "label": (None if label_local is None
                   else np.asarray(label_local)),
         "weight": (None if weight_local is None
                    else np.asarray(weight_local))},
        protocol=4)
    blocks = [pickle.loads(c) for c in _allgather_host_bytes(payload)]
    binned = np.vstack([b["binned"] for b in blocks])
    label = (np.concatenate([b["label"] for b in blocks])
             if blocks[0]["label"] is not None else None)
    weight = (np.concatenate([b["weight"] for b in blocks])
              if blocks[0]["weight"] is not None else None)
    from ..io.dataset import Dataset
    ds = Dataset.from_binned(binned, mappers, cfg, label=label,
                             weight=weight, feature_names=feature_names)
    log.info("distributed ingest: %d rows reassembled from %d partitions"
             " (%d local)", ds.num_data, bootstrap.process_count(),
             local_data.shape[0])
    return ds


def wrap_train_set(inner, device=None):
    """The user-facing `Dataset` over an ingest-produced (inner) Dataset,
    for `engine.train` / `Booster`: construct() is already done."""
    from ..basic import Dataset as LazyDataset
    ds = LazyDataset(None, free_raw_data=False, device=device)
    ds._inner = inner
    return ds


def load_sharded(data: np.ndarray, config: Optional[Config] = None,
                 label=None, weight=None, group=None,
                 categorical: Optional[Sequence[int]] = None,
                 params=None, feature_names=None):
    """Every process holds the FULL raw matrix (a shared filesystem, a
    replicated loader): slice this rank's ceil block and run the
    partition protocol. One process: plain local construction, the path
    of `Dataset(data, ...)`."""
    cfg = config or Config(params or {})
    _check_mode(cfg)
    nproc = bootstrap.process_count()
    if nproc <= 1:
        from ..io.dataset import Dataset
        return Dataset(data, config=cfg, label=label, weight=weight,
                       group=group, categorical_feature=categorical,
                       feature_names=feature_names)
    if group is not None:
        log.fatal("load_sharded: query groups cannot be row-sharded; "
                  "pass group only on single-process runs")
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    lo, hi = shard_row_block(arr.shape[0], bootstrap.rank(), nproc)
    return load_partition(
        arr[lo:hi], cfg,
        label_local=None if label is None else np.asarray(label)[lo:hi],
        weight_local=None if weight is None else np.asarray(weight)[lo:hi],
        categorical=categorical, feature_names=feature_names)
