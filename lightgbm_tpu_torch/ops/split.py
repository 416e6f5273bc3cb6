"""Vectorized best-split search over (feature, bin, missing direction).

Port of the numerical part of lightgbm_tpu/ops/split.py to torch
(reference: src/treelearner/feature_histogram.hpp:91-116 FindBestThreshold
Numerical and :508-648 FindBestThresholdSequence): a cumsum and a masked
argmax over the whole (F, B) plane, batched over a leading leaf axis so
that both children of a split are scanned in one pass.

Semantics, as in the JAX package:
  * two sweeps = two missing directions. dir=-1 accumulates from the right
    (missing goes LEFT, default_left=True); dir=+1 from the left (missing
    goes RIGHT). Ties prefer dir=-1, within dir=-1 the larger threshold,
    within dir=+1 the smaller. torch.argmax returns the first maximum, as
    jnp.argmax does, and the tie-breaks rely on that.
  * MissingType::Zero keeps the default (zero) bin out of both sums, so it
    travels with the missing direction; MissingType::NaN keeps the NaN bin
    out of the dir=-1 suffix so NaN travels left there.
  * L1 soft-thresholding, L2, max_delta_step clamp, monotone rejection and
    min/max output clamps (feature_histogram.hpp:446-490), and the
    min_data_in_leaf / min_sum_hessian_in_leaf feasibility masks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class SplitResult(NamedTuple):
    """Winning split per leaf: every field is an (N,) tensor."""
    gain: torch.Tensor           # f32, NEG_INF if no valid split
    feature: torch.Tensor        # int64 inner feature index
    threshold: torch.Tensor      # int64 bin threshold (left: bin <= thr)
    default_left: torch.Tensor   # bool
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor     # f32 (exact integers)
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def _threshold_l1(s, l1):
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def _leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step):
    out = -_threshold_l1(sum_grad, l1) / (sum_hess + l2)
    # max_delta_step <= 0 means unbounded
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def _leaf_output_constrained(sum_grad, sum_hess, l1, l2, max_delta_step,
                             min_c, max_c):
    out = _leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return torch.minimum(torch.maximum(out, min_c), max_c)


def _gain_given_output(sum_grad, sum_hess, l1, l2, output):
    sg_l1 = _threshold_l1(sum_grad, l1)
    return -(2.0 * sg_l1 * output + (sum_hess + l2) * output * output)


def leaf_split_gain(sum_grad, sum_hess, l1, l2, max_delta_step):
    """Objective value of keeping a node whole (reference GetLeafSplitGain)."""
    out = _leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)
    return _gain_given_output(sum_grad, sum_hess, l1, l2, out)


def calculate_leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step):
    """Public helper (reference CalculateSplittedLeafOutput)."""
    return _leaf_output(sum_grad, sum_hess, l1, l2, max_delta_step)


def _split_gains(gl, hl, gr, hr, l1, l2, mds, min_c, max_c, mono):
    """Candidate gain; monotone violations -> 0 (reference GetSplitGains)."""
    lo = _leaf_output_constrained(gl, hl, l1, l2, mds, min_c, max_c)
    ro = _leaf_output_constrained(gr, hr, l1, l2, mds, min_c, max_c)
    gain = (_gain_given_output(gl, hl, l1, l2, lo)
            + _gain_given_output(gr, hr, l1, l2, ro))
    violate = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
    return torch.where(violate, torch.zeros_like(gain), gain)


def per_feature_best(hist, sum_grad, sum_hess, num_data,
                     feature_num_bins, feature_missing, feature_default_bins,
                     feature_mask, monotone, min_constraint, max_constraint,
                     feature_penalty=None, *, l1: float, l2: float,
                     max_delta_step: float, min_data_in_leaf: int,
                     min_sum_hessian: float, min_gain_to_split: float):
    """Per-feature best (gain, threshold, default_left) plus the prefix
    tensors that materialize a winner.

    hist (N, F, B, 3) f32 [sum_grad, sum_hess, count]; sum_grad, sum_hess,
    num_data, min_constraint, max_constraint (N,) f32; feature_* (F,)
    int32; feature_mask (F,) bool; feature_penalty (F,) f32 or None.
    Returns rel (N, F), t (N, F), use_m1 (N, F), (pre, suf)."""
    n, f, b, _ = hist.shape
    dev = hist.device
    tgrid = torch.arange(b, device=dev)[None, :]                  # (1, B)
    nbins = feature_num_bins.long()[:, None]                      # (F, 1)
    is_nan = (feature_missing[:, None] == 2)
    is_zero = (feature_missing[:, None] == 1)
    default_b = feature_default_bins.long()[:, None]
    zero = hist.new_zeros(())

    skip = is_zero & (tgrid == default_b)                         # (F, B)
    eff = torch.where(skip[:, :, None], zero, hist)
    # dir=+1: left = prefix over bins [0..t]
    pre = torch.cumsum(eff, dim=2)                                # (N,F,B,3)
    # dir=-1: right = strict suffix over bins (t, last], NaN bin excluded
    nan_excl = is_nan & (tgrid >= nbins - 1)
    m1_eff = torch.where(nan_excl[:, :, None], zero, eff)
    suf = torch.flip(torch.cumsum(torch.flip(m1_eff, [2]), dim=2), [2]) \
        - m1_eff

    totals = torch.stack([sum_grad, sum_hess, num_data], dim=-1)  # (N, 3)
    tot = totals[:, None, None, :]
    left2 = torch.stack([pre, tot - suf])                         # (2,N,F,B,3)
    right2 = tot[None] - left2

    base_valid = (tgrid < nbins - 1) & feature_mask[:, None] & (nbins > 1)
    zero_skip_t = is_zero & (tgrid == default_b)
    valid2 = torch.stack([base_valid & ~zero_skip_t,
                          base_valid & ~zero_skip_t
                          & ~(is_nan & (tgrid >= nbins - 2))])    # (2, F, B)
    ok2 = (valid2[:, None]
           & (left2[..., 2] >= min_data_in_leaf)
           & (right2[..., 2] >= min_data_in_leaf)
           & (left2[..., 1] >= min_sum_hessian)
           & (right2[..., 1] >= min_sum_hessian))
    mn = min_constraint[:, None, None]
    mx = max_constraint[:, None, None]
    gains2 = _split_gains(left2[..., 0], left2[..., 1],
                          right2[..., 0], right2[..., 1], l1, l2,
                          max_delta_step, mn, mx, monotone[:, None])
    neg = hist.new_full((), NEG_INF)
    gains2 = torch.where(ok2, gains2, neg)

    gain_shift = leaf_split_gain(sum_grad, sum_hess, l1, l2, max_delta_step)
    min_gain_shift = gain_shift + min_gain_to_split                # (N,)
    mgs = min_gain_shift[:, None, None]
    gains_p1 = torch.where(gains2[0] > mgs, gains2[0], neg)
    gains_m1 = torch.where(gains2[1] > mgs, gains2[1], neg)

    best_f_m1 = gains_m1.max(dim=2).values
    best_t_m1 = (b - 1) - torch.argmax(torch.flip(gains_m1, [2]), dim=2)
    best_f_p1 = gains_p1.max(dim=2).values
    best_t_p1 = torch.argmax(gains_p1, dim=2)

    use_m1 = best_f_m1 >= best_f_p1
    per_feature_gain = torch.where(use_m1, best_f_m1, best_f_p1)
    per_feature_t = torch.where(use_m1, best_t_m1, best_t_p1)
    live = per_feature_gain > NEG_INF / 2
    rel = torch.where(live, per_feature_gain - min_gain_shift[:, None], neg)
    if feature_penalty is not None:
        rel = torch.where(rel > NEG_INF / 2, rel * feature_penalty, rel)
    return rel, per_feature_t, use_m1, (pre, suf)


def materialize_split(feat, per_feature_rel, per_feature_t, use_m1, prefix,
                      sum_grad, sum_hess, num_data,
                      min_constraint, max_constraint,
                      *, l1, l2, max_delta_step) -> SplitResult:
    """Build the full SplitResult for the chosen feature of each leaf."""
    pre, suf = prefix
    i = torch.arange(feat.shape[0], device=feat.device)
    gain = per_feature_rel[i, feat]
    thr = per_feature_t[i, feat]
    dleft = use_m1[i, feat]
    p = pre[i, feat, thr]                                         # (N, 3)
    s = suf[i, feat, thr]
    lg = torch.where(dleft, sum_grad - s[:, 0], p[:, 0])
    lh = torch.where(dleft, sum_hess - s[:, 1], p[:, 1])
    lc = torch.where(dleft, num_data - s[:, 2], p[:, 2])
    rg = sum_grad - lg
    rh = sum_hess - lh
    rc = num_data - lc
    lo = _leaf_output_constrained(lg, lh, l1, l2, max_delta_step,
                                  min_constraint, max_constraint)
    ro = _leaf_output_constrained(rg, rh, l1, l2, max_delta_step,
                                  min_constraint, max_constraint)
    return SplitResult(gain, feat, thr, dleft, lg, lh, lc, rg, rh, rc, lo, ro)


def find_best_split(hist, sum_grad, sum_hess, num_data,
                    feature_num_bins, feature_missing, feature_default_bins,
                    feature_mask, monotone, min_constraint, max_constraint,
                    feature_penalty=None, *, l1: float, l2: float,
                    max_delta_step: float, min_data_in_leaf: int,
                    min_sum_hessian: float,
                    min_gain_to_split: float) -> SplitResult:
    """Best split of each leaf: hist (N, F, B, 3) with (N,) leaf totals
    and constraints -> SplitResult of (N,) tensors."""
    rel, t, use_m1, prefix = per_feature_best(
        hist, sum_grad, sum_hess, num_data, feature_num_bins,
        feature_missing, feature_default_bins, feature_mask, monotone,
        min_constraint, max_constraint, feature_penalty, l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split)
    feat = torch.argmax(rel, dim=1)
    return materialize_split(
        feat, rel, t, use_m1, prefix, sum_grad, sum_hess, num_data,
        min_constraint, max_constraint, l1=l1, l2=l2,
        max_delta_step=max_delta_step)
