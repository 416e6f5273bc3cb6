"""Exclusive Feature Bundling (EFB).

Behavioral equivalent of the reference's feature-bundling pass
(reference: src/io/dataset.cpp:69-225 FindGroups / FastFeatureBundling):
sparse features that are (nearly) mutually exclusive share one storage
column, cutting histogram width and memory. The reference emits
`FeatureGroup`s with per-subfeature bin offsets; here a bundle is one dense
code column plus static per-feature (column, base, elide) maps that the
device ops use to expand a column histogram back into per-feature
histograms (see ops/bundle.py).

Column encoding (for a bundle of features f1..fk):
  code 0                  = every subfeature at its default bin
  code base_f + j         = subfeature f at logical bin
                            b = j + (j >= default_bin_f), j in [0, nbin_f-2]
(the default bin of each subfeature is elided, mirroring the reference's
most-frequent-bin offset trick, feature_group.h:1-249). Conflicting rows
(two non-default subfeatures) keep the LAST pushed subfeature's code; the
loser is absorbed into its default bin — the same information loss the
reference accepts with max_conflict_rate > 0.

Single-feature columns store plain bin codes (no elision, no fix-up).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

# keep bundled columns uint8-addressable, like the reference's GPU
# constraint of <= 256 bins per group (dataset.cpp:80,95)
MAX_COL_BINS = 256


def find_bundles(nonzero_masks: List[np.ndarray], num_bins: Sequence[int],
                 max_conflict_rate: float, sample_cnt: int,
                 max_search: int = 100) -> List[List[int]]:
    """Greedy conflict-bounded grouping over sampled non-default indicators.

    nonzero_masks[i]: bool (sample_cnt,) — rows where candidate feature i is
    away from its default bin. Returns bundles as lists of indices into the
    candidate list. Mirrors the greedy core of reference FindGroups
    (dataset.cpp:69-145): per feature, try existing bundles (bounded search),
    place where accumulated conflicts stay within budget, else open a new
    bundle.
    """
    n = len(nonzero_masks)
    order = sorted(range(n), key=lambda i: -int(nonzero_masks[i].sum()))
    max_error = int(max_conflict_rate * sample_cnt)
    bundles: List[List[int]] = []
    bundle_mask: List[np.ndarray] = []
    bundle_err: List[int] = []
    bundle_bins: List[int] = []
    for i in order:
        nz = nonzero_masks[i]
        cnt_bins = int(num_bins[i]) - 1
        placed = False
        for gi in range(min(len(bundles), max_search)):
            if bundle_bins[gi] + cnt_bins > MAX_COL_BINS - 1:
                continue
            conflict = int((bundle_mask[gi] & nz).sum())
            if bundle_err[gi] + conflict <= max_error:
                bundles[gi].append(i)
                bundle_mask[gi] |= nz
                bundle_err[gi] += conflict
                bundle_bins[gi] += cnt_bins
                placed = True
                break
        if not placed:
            bundles.append([i])
            bundle_mask.append(nz.copy())
            bundle_err.append(0)
            bundle_bins.append(cnt_bins)
    return bundles


class ColumnSpec:
    """One storage column: either a single feature's raw bins or a bundle."""

    __slots__ = ("features", "bases", "num_bins")

    def __init__(self, features: List[int], bases: List[int], num_bins: int):
        self.features = features      # inner feature indices
        self.bases = bases            # per-subfeature code base (bundles)
        self.num_bins = num_bins      # total codes in this column

    @property
    def is_bundle(self) -> bool:
        return len(self.features) > 1


def plan_columns(inner_feature_ids: Sequence[int], mappers,
                 sample_bins: List[np.ndarray], max_conflict_rate: float,
                 sparse_threshold: float) -> List[ColumnSpec]:
    """Decide the column layout for the used features of a dataset.

    inner_feature_ids: real feature ids in inner order.
    mappers: real-indexed BinMapper list.
    sample_bins[j]: int bin codes over the bundling sample for inner
    feature j (None allowed when the feature is dense -> own column).
    """
    cols: List[ColumnSpec] = []
    cand_inner: List[int] = []
    cand_masks: List[np.ndarray] = []
    cand_bins: List[int] = []
    for j, real in enumerate(inner_feature_ids):
        m = mappers[real]
        sb = sample_bins[j]
        if (sb is None or m.sparse_rate < sparse_threshold
                or m.num_bin >= MAX_COL_BINS):
            cols.append(ColumnSpec([j], [0], m.num_bin))
        else:
            cand_inner.append(j)
            cand_masks.append(sb != m.default_bin)
            cand_bins.append(m.num_bin)
    if cand_inner:
        sample_cnt = len(cand_masks[0])
        groups = find_bundles(cand_masks, cand_bins, max_conflict_rate,
                              sample_cnt)
        for grp in groups:
            feats = [cand_inner[g] for g in grp]
            if len(feats) == 1:
                j = feats[0]
                m = mappers[inner_feature_ids[j]]
                cols.append(ColumnSpec([j], [0], m.num_bin))
                continue
            bases = []
            base = 1
            for j in feats:
                m = mappers[inner_feature_ids[j]]
                bases.append(base)
                base += m.num_bin - 1
            cols.append(ColumnSpec(feats, bases, base))
    return cols


def encode_bundle(col_out: np.ndarray, bins: np.ndarray, base: int,
                  default_bin: int) -> None:
    """Write one subfeature's non-default rows into a bundle column."""
    nd = bins != default_bin
    j = bins - (bins > default_bin)
    col_out[nd] = (base + j[nd]).astype(col_out.dtype)


def expansion_arrays(cols: List[ColumnSpec], inner_feature_ids, mappers,
                     num_features: int, logical_bins: int):
    """Static maps used on device to expand column histograms and to route
    rows at a split:

      f_col    (F,)  column index of each inner feature
      f_base   (F,)  code base (0 for single-feature columns)
      f_elide  (F,)  1 when the default bin is elided (bundle member)
      hist_idx (F, B) flattened (col, code) index per logical bin, or the
                      trailing zero slot for invalid/elided positions
    """
    f_col = np.zeros(num_features, np.int32)
    f_base = np.zeros(num_features, np.int32)
    f_elide = np.zeros(num_features, np.int32)
    col_bins = max((c.num_bins for c in cols), default=1)
    zero_slot = len(cols) * col_bins
    hist_idx = np.full((num_features, logical_bins), zero_slot, np.int32)
    for ci, col in enumerate(cols):
        for j, base in zip(col.features, col.bases):
            m = mappers[inner_feature_ids[j]]
            nb = m.num_bin
            f_col[j] = ci
            f_base[j] = base
            f_elide[j] = int(col.is_bundle)
            b = np.arange(nb)
            if col.is_bundle:
                d = m.default_bin
                codes = base + b - (b > d)
                idx = ci * col_bins + codes
                idx[d] = zero_slot          # reconstructed by the fix-up
            else:
                idx = ci * col_bins + b
            hist_idx[j, :nb] = idx
    return f_col, f_base, f_elide, hist_idx, col_bins
