"""Incremental continuation: append fresh rows, warm-start, top up (port
of lightgbm_tpu/continual/update.py).

New raw rows are binned through the FROZEN BinMapper set of an already
constructed Dataset -- the same `values_to_bins` construction used, so
the codes are bit-equal to the JAX package's -- and appended to the
binned matrix (and to a live `DeviceDataShard` wire store), so an
`init_model` warm-start top-up trains on history + fresh rows without
re-binning history. Re-binning would also move old rows between bins
when the distribution drifts; freezing the mappers keeps the old trees'
thresholds meaningful.

The port's Dataset keeps its derived arrays (the bundle and feature
maps) in ``_cache``; `append_rows` drops them, and, given the Booster
that trained on the Dataset, that Booster's learner with its device
copies of the old rows (`Booster.free_dataset`), so a continuation
builds its learner from the grown matrix.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log


def _inner_of(dataset):
    """Accept either the user-level basic.Dataset (constructed) or the
    inner io Dataset."""
    inner = getattr(dataset, "_inner", None)
    if inner is not None:
        return inner
    if hasattr(dataset, "bin_mappers"):
        return dataset
    raise ValueError(
        "append_rows needs a constructed Dataset (call construct() "
        "first so the BinMapper set to freeze exists)")


def bin_rows(dataset, raw: np.ndarray) -> np.ndarray:
    """Bin (M, F_total) raw rows through the frozen mappers into the
    (M, F_used) code layout of `dataset.binned` -- byte-compatible with
    what construction produced, so the blocks concatenate."""
    inner = _inner_of(dataset)
    raw = np.asarray(raw, dtype=np.float64)
    if raw.ndim != 2 or raw.shape[1] < inner.num_total_features:
        raise ValueError(
            f"append rows must be (M, {inner.num_total_features}); "
            f"got {raw.shape}")
    dtype = inner.binned.dtype
    out = np.zeros((raw.shape[0], max(inner.num_features, 1)), dtype=dtype)
    for j, f in enumerate(inner.used_features):
        out[:, j] = inner.bin_mappers[f].values_to_bins(
            raw[:, f]).astype(dtype)
    return out


def _encode_bundle_block(inner, codes: np.ndarray) -> np.ndarray:
    """EFB-encode one appended block under the FROZEN column plan (the
    Dataset's `_encode_bundles` over a block instead of the whole matrix
    -- replanning bundles would reshuffle history's columns)."""
    from ..io.bundling import encode_bundle
    dtype = inner.bundled.dtype
    out = np.zeros((codes.shape[0], len(inner.columns)), dtype=dtype)
    for ci, col in enumerate(inner.columns):
        if not col.is_bundle:
            out[:, ci] = codes[:, col.features[0]].astype(dtype)
            continue
        for j, base in zip(col.features, col.bases):
            m = inner.bin_mappers[inner.used_features[j]]
            encode_bundle(out[:, ci], codes[:, j].astype(np.int32),
                          base, m.default_bin)
    return out


def append_rows(dataset, raw, label, weight=None, booster=None) -> int:
    """Append raw rows + labels to a constructed Dataset in place;
    returns the new row count. History is untouched: only the new block
    passes through `values_to_bins`. The Dataset's derived arrays are
    dropped; `booster` (a Booster trained on `dataset`) has its learner
    and device copies of the old rows dropped too (`free_dataset`: it
    still predicts; it trains no further)."""
    inner = _inner_of(dataset)
    meta = inner.metadata
    if meta.query_boundaries is not None:
        raise ValueError("append_rows does not support ranking datasets "
                         "(query groups would need re-partitioning)")
    if meta.init_score is not None:
        raise ValueError("append_rows does not support init_score "
                         "datasets (scores would misalign)")
    codes = bin_rows(inner, raw)
    label = np.asarray(label, dtype=np.float64).reshape(-1)
    log.check(len(label) == len(codes),
              "append_rows: label length mismatch")
    if booster is not None:
        booster.free_dataset()
    inner.binned = np.concatenate([inner.binned, codes], axis=0)
    if getattr(inner, "bundled", None) is not None:
        inner.bundled = np.concatenate(
            [inner.bundled, _encode_bundle_block(inner, codes)], axis=0)
    inner.num_data = int(inner.binned.shape[0])
    meta.num_data = inner.num_data
    meta.label = (np.concatenate([meta.label, label])
                  if meta.label is not None else label)
    if meta.weight is not None:
        w = (np.asarray(weight, dtype=np.float64).reshape(-1)
             if weight is not None
             else np.ones(len(codes), dtype=np.float64))
        log.check(len(w) == len(codes),
                  "append_rows: weight length mismatch")
        meta.weight = np.concatenate([meta.weight, w])
    inner._cache = {}
    telem_counters.incr("continual_append_rows", float(len(codes)))
    telem_events.emit("continual_append", rows=len(codes),
                      total_rows=inner.num_data)
    return inner.num_data


def pack_codes(codes: np.ndarray, item_bits: int,
               col_target: Optional[int] = None) -> np.ndarray:
    """Bit-pack an (M, C) code block into the u32 wire layout of
    `DeviceDataShard` (the packing DeviceTreeLearner.pack_codes applies
    at construction; the shard append round-trip test holds them
    equal)."""
    nrow, ncol = codes.shape
    want = max(ncol, col_target or 0)
    if item_bits == 4:
        npairs = ((want + 7) // 8) * 4
        byte_arr = np.zeros((nrow, npairs * 2), dtype=np.uint8)
        byte_arr[:, :ncol] = codes
        packed = (byte_arr[:, 0::2]
                  | (byte_arr[:, 1::2] << 4)).astype(np.uint8)
        return np.ascontiguousarray(packed).view(np.uint32)
    per = 32 // item_bits
    padded = np.zeros((nrow, ((want + per - 1) // per) * per),
                      dtype=np.uint8 if item_bits == 8 else np.uint16)
    padded[:, :ncol] = codes
    return np.ascontiguousarray(padded).view(np.uint32)


def continue_training(prev_booster, train_set, num_boost_round: int = 10,
                      params: Optional[dict] = None):
    """Warm continuation: top up `prev_booster` with `num_boost_round`
    new trees over `train_set` (typically the original Dataset grown by
    `append_rows`). Returns the continued Booster, on the Dataset's
    device, or on `prev_booster`'s when the Dataset names none."""
    from ..engine import train as _train
    device = None if train_set.device is not None else prev_booster.device
    p = dict(prev_booster.params or {})
    if params:
        p.update(params)
    # a reloaded model string pins num_iterations in params; the top-up
    # count is the argument
    for k in ("num_boost_round", "num_iterations", "num_iteration",
              "n_iter", "num_trees", "num_round", "num_rounds",
              "nrounds", "n_estimators", "max_iter"):
        p.pop(k, None)
    return _train(p, train_set, num_boost_round=num_boost_round,
                  init_model=prev_booster, device=device)
