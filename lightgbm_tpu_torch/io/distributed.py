"""Distributed (multi-process) data loading: rank-partitioned rows with
distributed bin finding.

Port of lightgbm_tpu/io/distributed.py, the equivalent of the reference's distributed loading path
(reference: src/io/dataset_loader.cpp:168 rank/num_machines row
partitioning, :573-722 CostructFromSampleData — features partitioned across
machines, each finds local BinMappers for its slice, then
Network::Allgather of the serialized mappers at :697-716). Differences by
design:

* Sample exchange happens FIRST (each process contributes its local sample
  of every feature; each rank receives the union sample for its feature
  slice), so every process ends with the SAME mapper list. When the data
  is small enough that no sampling triggers, that list is bit-identical
  to a single-process run; with sampling active, the union of per-rank
  samples differs from the single-process draw, so mappers are
  cross-rank-consistent but not single-process-identical (the reference
  has the same property — each machine bins from local samples,
  dataset_loader.cpp:592-616).
* The transport is parallel/network.py's framed host-bytes all-gather
  over torch.distributed, not a userspace socket mesh.

Every process returns the COMPLETE mapper list, ready to bin its local
row partition.
"""
from __future__ import annotations

import pickle
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..utils import log
from .binning import (BinMapper, load_forced_bounds,
                      mapper_from_sample_column, resolve_ignore_set)


def rank_row_range(num_total_rows: int, rank: int, num_processes: int
                   ) -> Tuple[int, int]:
    """Contiguous row range owned by a rank (reference:
    dataset_loader.cpp:168 — rows split evenly, remainder to the front)."""
    base = num_total_rows // num_processes
    rem = num_total_rows % num_processes
    begin = rank * base + min(rank, rem)
    return begin, begin + base + (1 if rank < rem else 0)


def feature_slice(num_features: int, rank: int, num_processes: int
                  ) -> Tuple[int, int]:
    """Contiguous feature range a rank finds bins for (reference:
    dataset_loader.cpp:573-600 partitions features evenly)."""
    base = num_features // num_processes
    rem = num_features % num_processes
    begin = rank * base + min(rank, rem)
    return begin, begin + base + (1 if rank < rem else 0)


_EPOCH_HEADER = struct.Struct("<q")


def _frame_payload(payload: bytes, epoch: int) -> bytes:
    """Prefix the iteration-epoch sequence number (resilience/faults.py
    ``current_epoch``) so every payload crossing the lane names the
    boosting iteration its sender was on."""
    return _EPOCH_HEADER.pack(int(epoch)) + payload


def _deframe_chunks(chunks: List[bytes], local_epoch: int) -> List[bytes]:
    """Strip + verify the epoch header on every rank's chunk. A mismatch
    means two ranks met inside a collective on DIFFERENT iterations —
    typed ``EpochDesyncError`` with both epochs named, instead of
    silently exchanging stale payloads."""
    from ..resilience.faults import EpochDesyncError
    out: List[bytes] = []
    for rank, chunk in enumerate(chunks):
        if len(chunk) < _EPOCH_HEADER.size:
            raise EpochDesyncError(local_epoch, -(2 ** 62), rank)
        remote = _EPOCH_HEADER.unpack_from(chunk)[0]
        if remote != int(local_epoch):
            raise EpochDesyncError(local_epoch, remote, rank)
        out.append(chunk[_EPOCH_HEADER.size:])
    return out


def _allgather_host_bytes(payload: bytes) -> List[bytes]:
    """All-gather arbitrary host bytes across processes (the role of
    Network::Allgather on serialized mappers, dataset_loader.cpp:697-716)
    through ``faults.run_collective``, so the hop shares the collective
    deadline and the retry of transient failures with every other
    cross-rank lane. Every payload carries the iteration-epoch header;
    ranks meeting here on different boosting iterations fail typed
    (``EpochDesyncError``) rather than mixing stale bytes."""
    from ..parallel import network
    from ..resilience import faults
    from ..telemetry import counters
    epoch = faults.current_epoch()
    framed = _frame_payload(payload, epoch)
    chunks = faults.run_collective(
        lambda: network.allgather_host_bytes(framed),
        site="allgather_bytes")
    # forensic counters (low-frequency): every byte that crosses the host
    # boundary through this lane
    counters.incr("dist_allgathers")
    counters.incr("dist_wire_bytes",
                  float(sum(len(c) for c in chunks)) + 8 * len(chunks))
    return _deframe_chunks(chunks, epoch)



def allgather_host_array(arr: np.ndarray) -> np.ndarray:
    """Every rank's `arr` (one dtype, the same leading shape) joined along
    the last axis in rank order, over ``_allgather_host_bytes``."""
    lead = arr.shape[:-1]
    return np.concatenate(
        [np.frombuffer(b, dtype=arr.dtype).reshape(lead + (-1,))
         for b in _allgather_host_bytes(arr.tobytes())], axis=-1)

def distributed_find_bins(local_data: np.ndarray, config: Config,
                          categorical: Optional[Sequence[int]] = None,
                          forced_bounds=None) -> List[BinMapper]:
    """Compute the full BinMapper list cooperatively across processes.

    local_data: this process's row partition, (n_local, F) float64.
    Returns the complete, identical-on-every-process mapper list.
    """
    from ..distributed import bootstrap
    nproc = bootstrap.process_count()
    rank = bootstrap.rank()
    cfg = config
    cat_idx = set(categorical or [])
    n_local, num_f = local_data.shape
    forced_bounds = forced_bounds or {}

    # --- 1. local sample (same RNG recipe as single-process, applied to
    # the local rows; budget split evenly across processes) -------------
    budget = max(1, cfg.bin_construct_sample_cnt // nproc)
    sample_cnt = min(n_local, budget)
    rng = np.random.RandomState(cfg.data_random_seed + rank)
    if sample_cnt < n_local:
        rows = np.sort(rng.choice(n_local, sample_cnt, replace=False))
    else:
        rows = np.arange(n_local)
    sample = np.ascontiguousarray(local_data[rows], dtype=np.float64)

    # --- 2. exchange samples: every process contributes its sample of
    # every feature; ranks consume only their slice ---------------------
    chunks = _allgather_host_bytes(pickle.dumps(sample, protocol=4))
    union = np.vstack([pickle.loads(c) for c in chunks])   # (S_total, F)
    total_sample = union.shape[0]

    # --- 3. find bins for OUR feature slice ----------------------------
    # same config preprocessing as the single-process path
    # (io/dataset.py _build_mappers, via the shared binning helpers);
    # name: ignore_column forms need feature names, which live in Dataset,
    # so only numeric indices resolve here
    if not forced_bounds:
        forced_bounds = load_forced_bounds(cfg.forcedbins_filename)
    ignore = resolve_ignore_set(cfg.ignore_column)

    f_begin, f_end = feature_slice(num_f, rank, nproc)
    my_mappers: List[BinMapper] = []
    for f in range(f_begin, f_end):
        if f in ignore:
            my_mappers.append(BinMapper.trivial())
            continue
        my_mappers.append(mapper_from_sample_column(
            union[:, f], total_sample, cfg, f, cat_idx, forced_bounds))

    # --- 4. all-gather the serialized mapper slices --------------------
    slices = _allgather_host_bytes(pickle.dumps(my_mappers, protocol=4))
    mappers: List[BinMapper] = []
    for c in slices:
        mappers.extend(pickle.loads(c))
    log.check(len(mappers) == num_f,
              "distributed bin finding produced wrong mapper count")
    return mappers


def bin_block(local_data: np.ndarray, mappers: List[BinMapper]
              ) -> np.ndarray:
    """Bin a row block against precomputed mappers: the dtype and column
    layout of Dataset._bin_data (non-trivial features only, in mapper
    order), so blocks vstack into a valid `binned`."""
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    max_bins = max([mappers[i].num_bin for i in used], default=1)
    dtype = np.uint8 if max_bins <= 256 else np.uint16
    out = np.zeros((local_data.shape[0], max(len(used), 1)), dtype=dtype)
    for j, f in enumerate(used):
        out[:, j] = mappers[f].values_to_bins(
            local_data[:, f]).astype(dtype)
    return out


def load_distributed(local_data: np.ndarray, config: Config,
                     label_local=None, weight_local=None,
                     categorical: Optional[Sequence[int]] = None):
    """Rank-partitioned dataset load: distributed bin finding over all
    processes, then each process bins only its OWN rows (reference:
    DatasetLoader::LoadFromFile under num_machines > 1 -- memory per
    machine scales with the partition, dataset_loader.cpp:168)."""
    from .dataset import Dataset
    local_data = np.ascontiguousarray(local_data, dtype=np.float64)
    mappers = distributed_find_bins(local_data, config, categorical)
    return Dataset.from_binned(bin_block(local_data, mappers), mappers,
                               config, label=label_local,
                               weight=weight_local)
