"""Feature binning: value -> small integer bin index.

Behavioral equivalent of the reference BinMapper
(reference: src/io/bin.cpp:76-410 GreedyFindBin / FindBinWithZeroAsOneBin /
BinMapper::FindBin, include/LightGBM/bin.h:462-498 ValueToBin).

Host-side, numpy; runs once per feature at Dataset construction. The output
(bin boundaries + per-row uint8/uint16 codes) is what lives on TPU.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils import log

ZERO_THRESHOLD = 1e-35
MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_NUMERICAL = 0
BIN_CATEGORICAL = 1


def _double_upper_bound(v: float) -> float:
    """Smallest double strictly greater than v (np.nextafter), so values equal
    to a boundary midpoint land in the lower bin, like the reference's
    GetDoubleUpperBound."""
    return float(np.nextafter(v, np.inf))


def _check_double_equal(a: float, b: float) -> bool:
    upper = _double_upper_bound(a)
    return b <= upper


def _distinct_counts(values: np.ndarray, zero_cnt: int):
    """Sorted sample values -> (distinct values, counts) as lists, with the
    implied zero block inserted (reference bin.cpp FindBin): a run of
    values each within one ulp of the one before (_check_double_equal)
    is one distinct value, the run's last; zero_cnt zeros go before the
    first positive value after a negative one, and at the front (or the
    back) when every value is positive (negative) and zero_cnt > 0. The
    JAX package walks the values one by one; this is that walk in numpy
    (tests/test_torch_binning.py holds the two equal)."""
    n = len(values)
    if n == 0:
        return [0.0], [zero_cnt]
    starts = np.flatnonzero(np.concatenate([
        [True], values[1:] > np.nextafter(values[:-1], np.inf)]))
    ends = np.append(starts[1:], n)
    distinct = values[ends - 1].tolist()
    counts = (ends - starts).tolist()
    # a negative run followed by a positive one: the zero block between
    cross = np.flatnonzero((values[starts[1:] - 1] < 0.0)
                           & (values[starts[1:]] > 0.0))
    if len(cross):
        g = int(cross[0]) + 1
        distinct.insert(g, 0.0)
        counts.insert(g, zero_cnt)
    if values[0] > 0.0 and zero_cnt > 0:
        distinct.insert(0, 0.0)
        counts.insert(0, zero_cnt)
    if values[-1] < 0.0 and zero_cnt > 0:
        distinct.append(0.0)
        counts.append(zero_cnt)
    return distinct, counts


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin boundaries over sorted distinct values.

    Two regimes like the reference (bin.cpp:76): few distinct values ->
    midpoint boundaries respecting min_data_in_bin; many -> greedy fill to
    ~total/max_bin per bin, values with huge counts get dedicated bins.
    """
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if max_bin <= 0:
        return [math.inf]
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                val = _double_upper_bound((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or not _check_double_equal(bounds[-1], val):
                    bounds.append(val)
                    cur_cnt = 0
        bounds.append(math.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big.sum())
    rest_sample_cnt -= int(counts[is_big].sum())
    if rest_bin_cnt > 0:
        mean_bin_size = rest_sample_cnt / rest_bin_cnt
    uppers: List[float] = []
    lowers: List[float] = [float(distinct_values[0])]
    cur_cnt = 0
    bin_cnt = 0
    # Python lists: the loop reads one element at a time
    values_l = np.asarray(distinct_values, dtype=np.float64).tolist()
    counts_l = np.asarray(counts).astype(np.int64).tolist()
    is_big = is_big.tolist()
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts_l[i]
        cur_cnt += counts_l[i]
        need_new = (
            is_big[i]
            or cur_cnt >= mean_bin_size
            or (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))
        )
        if need_new:
            uppers.append(values_l[i])
            bin_cnt += 1
            lowers.append(values_l[i + 1])
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                if rest_bin_cnt > 0:
                    mean_bin_size = rest_sample_cnt / rest_bin_cnt
    for i in range(len(uppers)):
        val = _double_upper_bound((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or not _check_double_equal(bounds[-1], val):
            bounds.append(val)
    bounds.append(math.inf)
    return bounds


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Zero gets a dedicated bin; negative/positive ranges binned separately
    with bins allotted proportionally (reference bin.cpp:254-310)."""
    dv = np.asarray(distinct_values, dtype=np.float64)
    cnts = np.asarray(counts, dtype=np.int64)
    left_mask = dv <= -ZERO_THRESHOLD
    right_mask = dv > ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(cnts[left_mask].sum())
    right_cnt_data = int(cnts[right_mask].sum())
    cnt_zero = int(cnts[zero_mask].sum())

    left_cnt = int(np.argmax(~left_mask)) if (~left_mask).any() else len(dv)
    bounds: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        denom = total_sample_cnt - cnt_zero
        left_max_bin = int(left_cnt_data / denom * (max_bin - 1)) if denom > 0 else 1
        left_max_bin = max(1, left_max_bin)
        bounds = greedy_find_bin(dv[:left_cnt], cnts[:left_cnt], left_max_bin,
                                 left_cnt_data, min_data_in_bin)
        if bounds:
            bounds[-1] = -ZERO_THRESHOLD

    right_start = -1
    for i in range(left_cnt, len(dv)):
        if dv[i] > ZERO_THRESHOLD:
            right_start = i
            break
    right_max_bin = max_bin - 1 - len(bounds)
    if right_start >= 0 and right_max_bin > 0:
        right_bounds = greedy_find_bin(dv[right_start:], cnts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(math.inf)
    return bounds


class BinMapper:
    """Per-feature value->bin mapping (numerical or categorical)."""

    @classmethod
    def trivial(cls) -> "BinMapper":
        """One-bin mapper for an ignored/constant feature — the one
        copy shared by the in-memory, sparse and two-round loaders."""
        m = cls()
        m.is_trivial = True
        m.num_bin = 1
        return m

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MISSING_NONE
        self.bin_type: int = BIN_NUMERICAL
        self.bin_upper_bound: List[float] = [math.inf]
        self.categorical_2_bin: Dict[int, int] = {}
        self.bin_2_categorical: List[int] = []
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0

    # ------------------------------------------------------------------
    def find_bin(self, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int, min_split_data: int,
                 bin_type: int = BIN_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None) -> None:
        """Build the mapping from a value sample.

        ``sample_values`` are the *non-zero* sampled values (zeros implied by
        total_sample_cnt - len(sample)), matching the reference's sparse
        sampling contract (bin.cpp:323 FindBin).
        """
        values = np.asarray(sample_values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]
        num_sample_values = len(values) + na_cnt

        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        if not use_missing or zero_as_missing:
            na_cnt = 0

        self.bin_type = bin_type
        self.default_bin = 0
        del num_sample_values
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        values = np.sort(values, kind="stable")
        distinct, counts = _distinct_counts(values, zero_cnt)
        self.min_val = distinct[0]
        self.max_val = distinct[-1]
        dv = np.asarray(distinct)
        cnts = np.asarray(counts)

        if bin_type == BIN_NUMERICAL:
            self._find_bin_numerical(dv, cnts, max_bin, total_sample_cnt,
                                     min_data_in_bin, na_cnt, forced_bounds)
        else:
            self._find_bin_categorical(dv, cnts, max_bin, total_sample_cnt,
                                       min_data_in_bin, na_cnt)

        # trivial feature: one effective bin -> carries no information
        self.is_trivial = self.num_bin <= 1
        cnt_in_bin = self._count_in_bin(dv, cnts, na_cnt)
        if self.num_bin > 1 and not self._check_splittable(cnt_in_bin, min_split_data):
            self.is_trivial = True
        nz = total_sample_cnt - (cnt_in_bin[self.default_bin] if self.default_bin < len(cnt_in_bin) else 0)
        self.sparse_rate = 1.0 - nz / max(1, total_sample_cnt)

    def _find_bin_numerical(self, dv, cnts, max_bin, total_sample_cnt,
                            min_data_in_bin, na_cnt, forced_bounds):
        if self.missing_type == MISSING_ZERO:
            self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
            if len(self.bin_upper_bound) == 2:
                self.missing_type = MISSING_NONE
        elif self.missing_type == MISSING_NONE:
            self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin, total_sample_cnt, min_data_in_bin)
        else:  # NaN bin appended last
            self.bin_upper_bound = find_bin_with_zero_as_one_bin(
                dv, cnts, max_bin - 1, total_sample_cnt - na_cnt, min_data_in_bin)
            self.bin_upper_bound.append(math.nan)
        if forced_bounds:
            self._apply_forced_bounds(forced_bounds, max_bin)
        self.num_bin = len(self.bin_upper_bound)
        # default bin = the bin containing value 0
        self.default_bin = self.value_to_bin(0.0)
        log.check(self.num_bin <= max_bin, "num_bin exceeds max_bin")

    def _apply_forced_bounds(self, forced_bounds, max_bin):
        has_nan = len(self.bin_upper_bound) and math.isnan(self.bin_upper_bound[-1])
        data_bounds = [b for b in self.bin_upper_bound
                       if not math.isnan(b) and not math.isinf(b)]
        forced = sorted({float(fb) for fb in forced_bounds
                         if abs(fb) > ZERO_THRESHOLD and math.isfinite(fb)})
        # reserve slots for the trailing inf bound (always re-appended)
        # and the NaN bin, or the total can exceed max_bin; forced
        # bounds take priority over data-found bounds under truncation
        # (the reference inserts forced bounds first, bin.cpp forced path)
        keep = max_bin - 1 - (1 if has_nan else 0)
        forced = forced[:keep]
        others = sorted(set(data_bounds) - set(forced))[:keep - len(forced)]
        bounds = sorted(set(forced) | set(others))
        bounds.append(math.inf)
        if has_nan:
            bounds.append(math.nan)
        self.bin_upper_bound = bounds

    def _find_bin_categorical(self, dv, cnts, max_bin, total_sample_cnt,
                              min_data_in_bin, na_cnt):
        """Count-sorted category->bin map; rare categories -> overflow bin
        (reference bin.cpp:418-470)."""
        cat_vals: List[int] = []
        cat_cnts: List[int] = []
        for v, c in zip(dv, cnts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                log.warning("Met negative value in categorical features, will convert it to NaN")
                continue
            if cat_vals and iv == cat_vals[-1]:
                cat_cnts[-1] += int(c)
            else:
                cat_vals.append(iv)
                cat_cnts.append(int(c))
        self.num_bin = 0
        self.categorical_2_bin = {}
        self.bin_2_categorical = []
        rest_cnt = total_sample_cnt - na_cnt
        if rest_cnt > 0:
            # sort by count desc (stable)
            order = sorted(range(len(cat_vals)), key=lambda i: (-cat_cnts[i], i))
            cat_vals = [cat_vals[i] for i in order]
            cat_cnts = [cat_cnts[i] for i in order]
            # avoid first bin being category 0 (default/zero bin must stay 0)
            if cat_vals and cat_vals[0] == 0:
                if len(cat_vals) == 1:
                    cat_vals.append(cat_vals[0] + 1)
                    cat_cnts.append(0)
                cat_vals[0], cat_vals[1] = cat_vals[1], cat_vals[0]
                cat_cnts[0], cat_cnts[1] = cat_cnts[1], cat_cnts[0]
            cut_cnt = int((total_sample_cnt - na_cnt) * 0.99)
            used_cnt = 0
            eff_max_bin = min(len(cat_vals), max_bin)
            i = 0
            while i < len(cat_vals) and (used_cnt < cut_cnt or self.num_bin < eff_max_bin):
                if cat_cnts[i] < min_data_in_bin and i > 1:
                    break
                self.bin_2_categorical.append(cat_vals[i])
                self.categorical_2_bin[cat_vals[i]] = self.num_bin
                used_cnt += cat_cnts[i]
                self.num_bin += 1
                i += 1
            if i == len(cat_vals) and na_cnt > 0:
                self.num_bin += 1  # NaN bin
                self.missing_type = MISSING_NAN
            elif i < len(cat_vals):
                self.num_bin += 1  # overflow bin doubles as NaN bin
                self.missing_type = MISSING_NAN
            else:
                self.missing_type = MISSING_NONE
        self.default_bin = 0

    def _count_in_bin(self, dv, cnts, na_cnt) -> np.ndarray:
        out = np.zeros(max(self.num_bin, 1), dtype=np.int64)
        if self.bin_type == BIN_NUMERICAL:
            # dv holds no NaN: value_to_bin of each, as one searchsorted
            np.add.at(out, self.values_to_bins(dv),
                      np.asarray(cnts, dtype=np.int64))
            if self.missing_type == MISSING_NAN and self.num_bin >= 1:
                out[self.num_bin - 1] = na_cnt
        else:
            for v, c in zip(dv, cnts):
                b = self.value_to_bin(float(v))
                if b < len(out):
                    out[b] += int(c)
            # the NaN category lives in the last bin and counts toward
            # splittability like any other category (reference bin.cpp
            # categorical NaN bin)
            if self.missing_type == MISSING_NAN and self.num_bin >= 1:
                out[self.num_bin - 1] += na_cnt
        return out

    def _check_splittable(self, cnt_in_bin: np.ndarray, min_split_data: int) -> bool:
        """A feature is usable if some bin boundary leaves >= min_split_data
        on each side (reference bin.cpp NeedFilter inverse)."""
        total = int(cnt_in_bin.sum())
        left = 0
        for i in range(len(cnt_in_bin) - 1):
            left += int(cnt_in_bin[i])
            if left >= min_split_data and total - left >= min_split_data:
                return True
        return False

    # ------------------------------------------------------------------
    def value_to_bin(self, value: float) -> int:
        """Scalar value -> bin (reference bin.h:462 ValueToBin)."""
        if isinstance(value, float) and math.isnan(value):
            if self.missing_type == MISSING_NAN:
                return self.num_bin - 1
            value = 0.0
        if self.bin_type == BIN_NUMERICAL:
            bounds = self.bin_upper_bound
            hi = self.num_bin - 1
            if self.missing_type == MISSING_NAN:
                hi -= 1
            lo = 0
            while lo < hi:
                mid = (lo + hi - 1) // 2
                if value <= bounds[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            return lo
        iv = int(value)
        if iv < 0:
            return self.num_bin - 1
        return self.categorical_2_bin.get(iv, self.num_bin - 1)

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin for a whole column."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_NUMERICAL:
            nan_mask = np.isnan(values)
            vals = np.where(nan_mask, 0.0, values)
            n_search = self.num_bin - (1 if self.missing_type == MISSING_NAN else 0)
            bounds = np.asarray(self.bin_upper_bound[: max(n_search - 1, 0)], dtype=np.float64)
            bins = np.searchsorted(bounds, vals, side="left")
            # searchsorted(side='left') gives first i with bounds[i] >= v;
            # reference uses v <= bounds[i], identical for first-greater-equal
            if self.missing_type == MISSING_NAN:
                bins = np.where(nan_mask, self.num_bin - 1, bins)
            return bins.astype(np.int32)
        # categorical
        out = np.empty(len(values), dtype=np.int32)
        default = self.num_bin - 1
        nan_mask = np.isnan(values)
        ivals = np.where(nan_mask, -1, values).astype(np.int64)
        lut_size = (max(self.categorical_2_bin) + 1) if self.categorical_2_bin else 1
        if lut_size <= (1 << 22):
            lut = np.full(lut_size, default, dtype=np.int32)
            for k, b in self.categorical_2_bin.items():
                lut[k] = b
            valid = (ivals >= 0) & (ivals < lut_size)
            out[:] = default
            out[valid] = lut[ivals[valid]]
        else:
            for i, iv in enumerate(ivals):
                out[i] = self.categorical_2_bin.get(int(iv), default) if iv >= 0 else default
        return out

    # ------------------------------------------------------------------
    def bin_to_value(self, bin_idx: int) -> float:
        """Representative threshold for a bin boundary: model files store the
        upper bound of the left side."""
        if self.bin_type == BIN_NUMERICAL:
            return self.bin_upper_bound[bin_idx]
        return float(self.bin_2_categorical[bin_idx]) if bin_idx < len(self.bin_2_categorical) else -1.0

    def feature_info(self) -> str:
        """feature_infos model-file entry: [min:max] for numerical,
        category list for categorical, 'none' for trivial."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_NUMERICAL:
            return f"[{self.min_val:g}:{self.max_val:g}]"
        return ":".join(str(c) for c in self.bin_2_categorical)

    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "bin_type": self.bin_type,
            "bin_upper_bound": list(self.bin_upper_bound),
            "bin_2_categorical": list(self.bin_2_categorical),
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": self.default_bin,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        m = cls()
        m.num_bin = d["num_bin"]
        m.missing_type = d["missing_type"]
        m.bin_type = d["bin_type"]
        m.bin_upper_bound = list(d["bin_upper_bound"])
        m.bin_2_categorical = list(d["bin_2_categorical"])
        m.categorical_2_bin = {c: i for i, c in enumerate(m.bin_2_categorical)}
        m.min_val = d["min_val"]
        m.max_val = d["max_val"]
        m.default_bin = d["default_bin"]
        m.is_trivial = d["is_trivial"]
        m.sparse_rate = d.get("sparse_rate", 0.0)
        return m


def load_forced_bounds(forcedbins_filename: Optional[str]) -> Dict[int, list]:
    """Parse the forced-bins JSON file (reference: DatasetLoader reads
    forcedbins_filename; entries {"feature": i, "bin_upper_bound": [...]})."""
    bounds: Dict[int, list] = {}
    if forcedbins_filename:
        import json
        with open(forcedbins_filename) as fh:
            for entry in json.load(fh):
                bounds[int(entry["feature"])] = [
                    float(v) for v in entry["bin_upper_bound"]]
    return bounds


def resolve_ignore_set(ignore_column, feature_names=None) -> set:
    """ignore_column entries -> feature index set. name: forms resolve
    against feature_names when available, silently drop otherwise."""
    ignore = set()
    for c in ignore_column or []:
        if isinstance(c, str) and c.startswith("name:"):
            name = c[5:]
            if feature_names and name in feature_names:
                ignore.add(list(feature_names).index(name))
        else:
            try:
                ignore.add(int(c))
            except (TypeError, ValueError):
                pass
    return ignore


def mapper_from_sample_column(col: np.ndarray, total_sample_cnt: int,
                              cfg, feature_index: int, cat_idx: set,
                              forced_bounds: Optional[Dict[int, list]] = None
                              ) -> "BinMapper":
    """One feature's BinMapper from its sampled column — the single
    find-bin recipe shared by the in-process path
    (io/dataset.py Dataset._build_mappers) and the distributed path
    (io/distributed.py distributed_find_bins)."""
    m = BinMapper()
    # the sampling contract: pass non-zero values, zeros implied
    nonzero = col[(np.abs(col) > ZERO_THRESHOLD) | np.isnan(col)]
    mbf = cfg.max_bin_by_feature
    max_bin = (mbf[feature_index] if mbf and feature_index < len(mbf)
               else cfg.max_bin)
    m.find_bin(
        nonzero, total_sample_cnt=total_sample_cnt, max_bin=max_bin,
        min_data_in_bin=cfg.min_data_in_bin,
        min_split_data=cfg.min_data_in_leaf,
        bin_type=(BIN_CATEGORICAL if feature_index in cat_idx
                  else BIN_NUMERICAL),
        use_missing=cfg.use_missing,
        zero_as_missing=cfg.zero_as_missing,
        forced_bounds=(forced_bounds or {}).get(feature_index))
    return m
