"""Binned split decision, and the host-loop learner's data partition.

Port of lightgbm_tpu/ops/partition.py (reference: include/LightGBM/
tree.h:243 NumericalDecisionInner, data_partition.hpp:20-205). The growth
cores reorder packed rows with kernel K4 (ops/kernels/partition.py); the
host-loop learner (models/serial_learner.py) keeps the JAX package's
permutation buffer of row ids grouped by leaf, re-partitioned per split by
a stable argsort of a 2-bit key over the leaf's padded window, as in JAX
(plain torch: it is plain XLA there, no Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def decide_left(bins: torch.Tensor, threshold: int, default_left: bool,
                missing_type: int, default_bin: int,
                num_bins_f: int) -> torch.Tensor:
    """Missing bin goes to the default side, otherwise left iff
    bin <= threshold. The split's parameters are host scalars."""
    left = bins <= threshold
    if missing_type == MISSING_ZERO:
        missing = bins == default_bin
    elif missing_type == MISSING_NAN:
        missing = bins == num_bins_f - 1
    else:
        return left
    return torch.where(missing, torch.full_like(left, bool(default_left)),
                       left)


def mask_to_words(mask: torch.Tensor, words: int) -> torch.Tensor:
    """(..., B) bool bin mask -> (..., words) int32 bitset words, bin b
    at bit b % 32 of word b // 32 (Common::ConstructBitset's layout; bins
    past B are clear)."""
    *lead, b = mask.shape
    pad = words * 32 - b
    m = mask.to(torch.int64)
    if pad > 0:
        m = torch.cat([m, m.new_zeros(*lead, pad)], dim=-1)
    bits = torch.arange(32, device=mask.device, dtype=torch.int64)
    w = (m[..., :words * 32].reshape(*lead, words, 32) << bits).sum(dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def words_to_mask(words: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(..., W) int32 bitset words -> (..., num_bins) bool bin mask."""
    b = torch.arange(num_bins, device=words.device)
    w = words.to(torch.int64)[..., b // 32]
    return ((w >> (b % 32)) & 1) == 1


def decide_left_categorical(bins: torch.Tensor,
                            words: torch.Tensor) -> torch.Tensor:
    """Categorical split: left iff the row's bin is set in the (W,) int32
    bitset `words` (reference CategoricalDecisionInner, the JAX
    partition_step_categorical); a bin past the bitset goes right."""
    n_words = words.shape[0]
    w = words.to(torch.int64)[torch.clamp(bins.long() >> 5, 0, n_words - 1)]
    inside = (bins >= 0) & (bins.long() >> 5 < n_words)
    return inside & (((w >> (bins.long() & 31)) & 1) == 1)


def reorder_window(indices_buf: torch.Tensor, begin: int, count: int,
                   go_left: torch.Tensor, bucket: int):
    """Stable (left | right | pad) reorder of the window [begin, begin +
    bucket) of indices_buf in place: pad positions (>= count) get the
    highest key, so they stay at the window's tail in their order and an
    overrun into the next leaf is rewritten as it was. Returns the
    window's rows before the reorder, the (bucket,) validity and the left
    count as a 0-d tensor."""
    window = indices_buf[begin:begin + bucket].clone()
    valid = torch.arange(bucket, device=window.device) < count
    key = torch.where(valid, (~go_left).to(torch.int32),
                      torch.full_like(window, 2))
    order = torch.argsort(key, stable=True)
    indices_buf[begin:begin + bucket] = window[order]
    return window, valid, (key == 0).sum()


def window_bins(binned: torch.Tensor, window: torch.Tensor,
                feature: int) -> torch.Tensor:
    """(bucket,) int64 bins of `feature` for the rows of `window` (row
    ids into the (N, F) codes `binned`; int16 codes read as uint16)."""
    col = binned[:, feature].index_select(0, window.long()).long()
    return col & 0xFFFF if binned.dtype == torch.int16 else col


def partition_step(indices_buf: torch.Tensor, binned: torch.Tensor,
                   begin: int, count: int, feature: int, threshold: int,
                   default_left: bool, missing_type: int, default_bin: int,
                   num_bins_f: int, *, bucket: int):
    """Split one leaf's index window into (left | right), in place.

    indices_buf: (N + max_bucket,) int32 permutation buffer; binned: (N,
    F) bin codes; the split as host ints. Returns (indices_buf, left
    count as a 0-d tensor)."""
    window = indices_buf[begin:begin + bucket]
    go_left = decide_left(window_bins(binned, window, feature), threshold,
                          default_left, missing_type, default_bin,
                          num_bins_f)
    return indices_buf, reorder_window(indices_buf, begin, count, go_left,
                                       bucket)[2]


def partition_step_categorical(indices_buf: torch.Tensor,
                               binned: torch.Tensor, begin: int, count: int,
                               feature: int, bitset: torch.Tensor, *,
                               bucket: int):
    """Categorical split: left iff the row's bin is in the int32 bitset
    (reference CategoricalDecisionInner + Common::FindInBitset)."""
    window = indices_buf[begin:begin + bucket]
    go_left = decide_left_categorical(window_bins(binned, window, feature),
                                      bitset)
    return indices_buf, reorder_window(indices_buf, begin, count, go_left,
                                       bucket)[2]


def make_indices_buffer(n_total: int, max_bucket: int, bag_indices=None,
                        device="cpu") -> torch.Tensor:
    """The padded (n_total + max_bucket,) int32 permutation buffer: every
    row id, or the bag's first, zeros after."""
    buf = np.zeros(n_total + max_bucket, dtype=np.int32)
    if bag_indices is None:
        buf[:n_total] = np.arange(n_total, dtype=np.int32)
    else:
        buf[:len(bag_indices)] = bag_indices
    return torch.from_numpy(buf).to(device)
