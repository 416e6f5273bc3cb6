"""Vectorized best-split search over (feature, bin, missing direction).

Port of lightgbm_tpu/ops/split.py to torch
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
                     feature_penalty=None, feature_cost=None, *, l1: float,
                     l2: float, max_delta_step: float,
                     min_data_in_leaf: int, min_sum_hessian: float,
                     min_gain_to_split: float):
    """Per-feature best (gain, threshold, default_left) plus the prefix
    tensors that materialize a winner.

    hist (N, F, B, 3) f32 [sum_grad, sum_hess, count]; sum_grad, sum_hess,
    num_data, min_constraint, max_constraint (N,) f32; feature_* (F,)
    int32; feature_mask (F,) bool, or (N, F) with a mask per leaf (by-node
    sampling); feature_penalty (F,) f32 or None; feature_cost (F,) or
    (N, F) f32 subtractive CEGB cost (reference cegb DeltaGain terms) or
    None. Returns rel (N, F), t (N, F), use_m1 (N, F), (pre, suf)."""
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

    fmask = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    base_valid = ((tgrid < nbins - 1) & (nbins > 1))[None] \
        & fmask[:, :, None]                                       # (1|N,F,B)
    zero_skip_t = is_zero & (tgrid == default_b)
    valid2 = torch.stack([base_valid & ~zero_skip_t,
                          base_valid & ~zero_skip_t
                          & ~(is_nan & (tgrid >= nbins - 2))])  # (2,1|N,F,B)
    ok2 = (valid2
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
    if feature_cost is not None:
        rel = torch.where(rel > NEG_INF / 2, rel - feature_cost, rel)
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
                    feature_penalty=None, feature_cost=None, *, l1: float,
                    l2: float, max_delta_step: float,
                    min_data_in_leaf: int, min_sum_hessian: float,
                    min_gain_to_split: float) -> SplitResult:
    """Best split of each leaf: hist (N, F, B, 3) with (N,) leaf totals
    and constraints -> SplitResult of (N,) tensors (the masks, penalty and
    cost as per_feature_best's)."""
    rel, t, use_m1, prefix = per_feature_best(
        hist, sum_grad, sum_hess, num_data, feature_num_bins,
        feature_missing, feature_default_bins, feature_mask, monotone,
        min_constraint, max_constraint, feature_penalty, feature_cost,
        l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split)
    feat = torch.argmax(rel, dim=1)
    return materialize_split(
        feat, rel, t, use_m1, prefix, sum_grad, sum_hess, num_data,
        min_constraint, max_constraint, l1=l1, l2=l2,
        max_delta_step=max_delta_step)


class CatSplitResult(NamedTuple):
    """Winning categorical split per leaf: (N,) tensors and the (N, B)
    bool mask of the bins that go left."""
    gain: torch.Tensor
    feature: torch.Tensor
    left_mask: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor
    left_count: torch.Tensor
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def per_feature_best_categorical(
        hist, sum_grad, sum_hess, num_data, feature_num_bins,
        feature_missing, feature_mask, min_constraint, max_constraint,
        feature_penalty=None, *, l1: float, l2: float, cat_l2: float,
        cat_smooth: float, max_delta_step: float, min_data_in_leaf: int,
        min_sum_hessian: float, min_gain_to_split: float,
        max_cat_threshold: int, max_cat_to_onehot: int,
        min_data_per_group: int):
    """Per-feature categorical best gains, relative to the leaf's
    min_gain_shift (comparable to per_feature_best's), and what
    materialize_cat_split needs to build a winner's left-bin mask.

    hist (N, F, B, 3) f32; sums and constraints (N,); feature_* (F,);
    feature_mask (F,) or (N, F). Returns rel (N, F) and aux."""
    n, f, b, _ = hist.shape
    dev = hist.device
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]          # (N, F, B)
    bgrid = torch.arange(b, device=dev)[None, :]
    nbins = feature_num_bins.long()[:, None]
    # used_bin = num_bin - 1 + (missing_type == None): the trailing
    # overflow / NaN bin is a candidate only for a "full" feature
    used_bin = nbins - 1 + (feature_missing[:, None] == 0).long()
    bin_ok = bgrid < used_bin                                    # (F, B)
    gain_shift = leaf_split_gain(sum_grad, sum_hess, l1, l2, max_delta_step)
    mgs = (gain_shift + min_gain_to_split)[:, None, None]        # (N, 1, 1)
    use_onehot = feature_num_bins <= max_cat_to_onehot           # (F,)
    sg, sh = sum_grad[:, None, None], sum_hess[:, None, None]
    nd = num_data[:, None, None]
    mn, mx = min_constraint[:, None, None], max_constraint[:, None, None]
    neg = hist.new_full((), NEG_INF)

    def gains_for(gl, hl, eff_l2, ok):
        gains = _split_gains(gl, hl, sg - gl, sh - hl, l1, eff_l2,
                             max_delta_step, mn, mx, 0)
        gains = torch.where(ok, gains, neg)
        return torch.where(gains > mgs, gains, neg)

    # ---- one-hot mode: left = one bin ------------------------------------
    oh_ok = (bin_ok & (c >= min_data_in_leaf) & (h >= min_sum_hessian)
             & ((nd - c) >= min_data_in_leaf)
             & ((sh - h) >= min_sum_hessian))
    oh_gains = gains_for(g, h, l2, oh_ok)
    oh_best = oh_gains.max(dim=2).values
    oh_t = torch.argmax(oh_gains, dim=2)

    # ---- sorted mode -----------------------------------------------------
    valid_sorted = bin_ok & (c >= cat_smooth)                    # (N, F, B)
    ctr = torch.where(valid_sorted, g / (h + cat_smooth),
                      hist.new_full((), float("inf")))
    order = torch.argsort(ctr, dim=2, stable=True)
    hs = torch.take_along_dim(hist, order[..., None], dim=2)
    v_s = torch.take_along_dim(valid_sorted, order, dim=2)
    n_valid = v_s.sum(dim=2, keepdim=True)                       # (N, F, 1)
    hs = torch.where(v_s[..., None], hs, hist.new_zeros(()))
    max_num_cat = torch.clamp((n_valid + 1) // 2, max=max_cat_threshold)
    pos = torch.arange(b, device=dev)
    # the backward walk starts at the high-ratio end: flip, then roll the
    # padded width so the valid entries lead
    roll_idx = (pos + (b - n_valid)) % b                         # (N, F, B)
    hr = torch.take_along_dim(torch.flip(hs, [2]), roll_idx[..., None],
                              dim=2)
    v_r = torch.take_along_dim(torch.flip(v_s, [2]), roll_idx, dim=2)
    left2 = torch.cumsum(torch.stack([hs, hr]), dim=3)          # (2,N,F,B,3)
    gl2, hl2, cl2 = left2[..., 0], left2[..., 1], left2[..., 2]
    ok2 = (torch.stack([v_s, v_r]) & (pos < max_num_cat)
           & (cl2 >= min_data_in_leaf) & (hl2 >= min_sum_hessian)
           & ((nd - cl2) >= max(min_data_in_leaf, min_data_per_group))
           & ((sh - hl2) >= min_sum_hessian))
    gains2 = gains_for(gl2, hl2, l2 + cat_l2, ok2)
    best2 = gains2.max(dim=3).values                             # (2, N, F)
    ti2 = torch.argmax(gains2, dim=3)
    use_fwd = best2[0] >= best2[1]
    sort_best = torch.where(use_fwd, best2[0], best2[1])
    sort_t = torch.where(use_fwd, ti2[0], ti2[1])

    per_gain = torch.where(use_onehot, oh_best, sort_best)
    per_gain = torch.where(feature_mask, per_gain, neg)
    rel = torch.where(per_gain > NEG_INF / 2, per_gain - mgs[:, :, 0], neg)
    if feature_penalty is not None:
        rel = torch.where(rel > NEG_INF / 2, rel * feature_penalty, rel)
    order_r = torch.take_along_dim(torch.flip(order, [2]), roll_idx, dim=2)
    return rel, (use_onehot, oh_t, sort_t, use_fwd, order, v_s, order_r, v_r)


def materialize_cat_split(feat, rel, aux, hist, sum_grad, sum_hess,
                          num_data, min_constraint, max_constraint, *,
                          l1, l2, cat_l2, max_delta_step) -> CatSplitResult:
    """Build the CatSplitResult, with the left-bin mask over the inner
    bins, for the chosen categorical feature of each leaf."""
    use_onehot, oh_t, sort_t, use_fwd, order, v_s, order_r, v_r = aux
    n, _, b, _ = hist.shape
    i = torch.arange(n, device=hist.device)
    gain = rel[i, feat]
    pos_b = torch.arange(b, device=hist.device)[None, :]
    onehot_mask = pos_b == oh_t[i, feat][:, None]                # (N, B)
    sel_sorted = pos_b <= sort_t[i, feat][:, None]
    empty = torch.zeros((n, b), dtype=torch.bool, device=hist.device)
    fwd_mask = empty.scatter(1, order[i, feat], sel_sorted & v_s[i, feat])
    bwd_mask = empty.scatter(1, order_r[i, feat], sel_sorted & v_r[i, feat])
    sorted_mask = torch.where(use_fwd[i, feat][:, None], fwd_mask, bwd_mask)
    onehot = use_onehot[feat]
    left_mask = torch.where(onehot[:, None], onehot_mask, sorted_mask)

    hf = hist[i, feat]                                           # (N, B, 3)
    lsum = torch.where(left_mask[..., None], hf, hist.new_zeros(())).sum(1)
    lg, lh, lc = lsum[:, 0], lsum[:, 1], lsum[:, 2]
    rg, rh, rc = sum_grad - lg, sum_hess - lh, num_data - lc
    w_l2 = torch.where(onehot, hist.new_full((), l2),
                       hist.new_full((), l2 + cat_l2))
    lo = torch.minimum(torch.maximum(-_threshold_l1(lg, l1) / (lh + w_l2),
                                     min_constraint), max_constraint)
    ro = torch.minimum(torch.maximum(-_threshold_l1(rg, l1) / (rh + w_l2),
                                     min_constraint), max_constraint)
    if max_delta_step > 0.0:
        lo = torch.clamp(lo, -max_delta_step, max_delta_step)
        ro = torch.clamp(ro, -max_delta_step, max_delta_step)
    return CatSplitResult(gain, feat, left_mask, lg, lh, lc, rg, rh, rc,
                          lo, ro)


def find_best_split_categorical(hist, sum_grad, sum_hess, num_data,
                                feature_num_bins, feature_missing,
                                feature_mask, min_constraint,
                                max_constraint, **kwargs) -> CatSplitResult:
    """Best categorical split of each leaf (the host-loop learner's entry
    point): hist (N, F, B, 3) with (N,) leaf totals and constraints;
    kwargs are per_feature_best_categorical's settings."""
    rel, aux = per_feature_best_categorical(
        hist, sum_grad, sum_hess, num_data, feature_num_bins,
        feature_missing, feature_mask, min_constraint, max_constraint,
        **kwargs)
    return materialize_cat_split(
        torch.argmax(rel, dim=1), rel, aux, hist, sum_grad, sum_hess,
        num_data, min_constraint, max_constraint, l1=kwargs["l1"],
        l2=kwargs["l2"], cat_l2=kwargs["cat_l2"],
        max_delta_step=kwargs["max_delta_step"])
