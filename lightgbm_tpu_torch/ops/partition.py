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
