"""Binned split decision.

Port of lightgbm_tpu/ops/partition.py::decide_left (reference:
include/LightGBM/tree.h:243 NumericalDecisionInner). The row reorder that
the JAX package does with a stable argsort lives in kernel K4
(ops/kernels/partition.py).
"""
from __future__ import annotations

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
