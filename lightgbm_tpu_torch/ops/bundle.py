"""Device-side EFB helpers: column-histogram expansion and row routing.

Port of lightgbm_tpu/ops/bundle.py to torch (reference: src/io/
dataset.cpp:820-960 per-group histograms and Dataset::FixHistogram,
dataset.h:419, which rebuilds an elided default bin from the leaf totals).
"""
from __future__ import annotations

import torch


def expand_column_hist(col_hist: torch.Tensor,    # (..., C, Bc, 3)
                       totals: torch.Tensor,      # (..., 3) leaf sums
                       hist_idx: torch.Tensor,    # (F, B) int64 flat index
                       f_elide: torch.Tensor,     # (F,) int32 0/1
                       f_default: torch.Tensor,   # (F,) int32 default bin
                       ) -> torch.Tensor:
    """Column histograms -> per-feature histograms (..., F, B, 3).

    hist_idx points into the flattened (C*Bc, 3) array with one trailing
    zero slot for invalid positions; elided default bins are rebuilt as
    totals - sum(other bins), the FixHistogram identity. Leading batch
    dimensions (the two children of a split) pass through."""
    *lead, c, bc, _ = col_hist.shape
    flat = torch.cat([col_hist.reshape(*lead, c * bc, 3),
                      col_hist.new_zeros(*lead, 1, 3)], dim=-2)
    fh = flat[..., hist_idx, :]                          # (..., F, B, 3)
    rem = totals[..., None, :] - fh.sum(dim=-2)          # (..., F, 3)
    b = fh.shape[-2]
    donehot = (torch.arange(b, device=fh.device)[None, :]
               == f_default[:, None]).to(fh.dtype)       # (F, B)
    fix = donehot[:, :, None] * rem[..., :, None, :] \
        * f_elide[:, None, None].to(fh.dtype)
    return fh + fix


def logical_bins_for_feature(col_codes: torch.Tensor, base: int,
                             default_bin: int, num_bins_f: int,
                             elide: int) -> torch.Tensor:
    """Map a column's raw codes to one subfeature's logical bins.

    For single-feature columns (elide == 0) codes ARE the bins. For bundle
    members, codes in [base, base + nbin - 2] unmap to the feature's
    non-default bins; anything else means 'this feature at its default'.
    The feature's metadata arrive as host ints (the growth loop reads the
    split record on the host)."""
    if not elide:
        return col_codes
    j = col_codes - base
    inside = (j >= 0) & (j < num_bins_f - 1)
    logical = j + (j >= default_bin).to(col_codes.dtype)
    return torch.where(inside, logical,
                       torch.full_like(col_codes, default_bin))
