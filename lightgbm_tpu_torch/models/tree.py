"""Tree model: flat-array binary decision tree.

Behavioral equivalent of the reference Tree (reference:
include/LightGBM/tree.h:25-535, src/io/tree.cpp). Node numbering matches the
reference exactly: internal node created by split #s has index s; leaves are
referenced as ~leaf_index (negative) in the child arrays; splitting leaf L
keeps L as the left child's leaf index and appends the right child as a new
leaf. Text/JSON serialization is format-compatible with LightGBM v2.3.1 model
files.

The tree is grown on host (tiny arrays); batch prediction runs on device via
ops/predict.py using the tensorized (split_feature, threshold, children)
arrays this class maintains.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

K_ZERO_THRESHOLD = 1e-35


def _array_to_str(arr, high_precision=False) -> str:
    out = []
    for v in arr:
        if isinstance(v, (float, np.floating)):
            if high_precision:
                out.append(repr(float(v)))
            else:
                out.append(f"{float(v):g}")
        else:
            out.append(str(int(v)))
    return " ".join(out)


class Tree:
    def __init__(self, max_leaves: int):
        self.max_leaves = max_leaves
        m = max(max_leaves, 2)
        self.num_leaves = 1
        self.num_cat = 0
        self.split_feature_inner = np.zeros(m - 1, dtype=np.int32)
        self.split_feature = np.zeros(m - 1, dtype=np.int32)
        self.split_gain = np.zeros(m - 1, dtype=np.float32)
        self.threshold_in_bin = np.zeros(m - 1, dtype=np.int32)
        self.threshold = np.zeros(m - 1, dtype=np.float64)
        self.decision_type = np.zeros(m - 1, dtype=np.int8)
        self.left_child = np.zeros(m - 1, dtype=np.int32)
        self.right_child = np.zeros(m - 1, dtype=np.int32)
        self.leaf_parent = np.full(m, -1, dtype=np.int32)
        self.leaf_value = np.zeros(m, dtype=np.float64)
        self.leaf_weight = np.zeros(m, dtype=np.float64)
        self.leaf_count = np.zeros(m, dtype=np.int64)
        self.internal_value = np.zeros(m - 1, dtype=np.float64)
        self.internal_weight = np.zeros(m - 1, dtype=np.float64)
        self.internal_count = np.zeros(m - 1, dtype=np.int64)
        self.leaf_depth = np.zeros(m, dtype=np.int32)
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.cat_boundaries_inner: List[int] = [0]
        self.cat_threshold_inner: List[int] = []
        self.shrinkage = 1.0
        self.max_depth = -1
        # binned routing (threshold_in_bin / *_inner bitsets) is valid for
        # trees built by a learner; deserialized trees carry raw values
        # only until rebin_inner() reconstructs the binned side
        self.inner_valid = True

    # ------------------------------------------------------------------
    def _split_common(self, leaf: int, feature: int, real_feature: int,
                      left_value: float, right_value: float,
                      left_cnt: int, right_cnt: int,
                      left_weight: float, right_weight: float,
                      gain: float) -> int:
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature
        self.split_feature[new_node] = real_feature
        self.split_gain[new_node] = gain
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_weight[new_node] = self.leaf_weight[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if math.isnan(left_value) else left_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if math.isnan(right_value) else right_value
        self.leaf_weight[self.num_leaves] = right_weight
        self.leaf_count[self.num_leaves] = right_cnt
        self.leaf_depth[self.num_leaves] = self.leaf_depth[leaf] + 1
        self.leaf_depth[leaf] += 1
        return new_node

    def split(self, leaf: int, feature: int, real_feature: int,
              threshold_bin: int, threshold_double: float,
              left_value: float, right_value: float,
              left_cnt: int, right_cnt: int,
              left_weight: float, right_weight: float, gain: float,
              missing_type: int, default_left: bool) -> int:
        """Numerical split; returns the new (right) leaf index."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt,
                                  left_weight, right_weight, gain)
        dt = 0
        if default_left:
            dt |= K_DEFAULT_LEFT_MASK
        dt |= (missing_type & 3) << 2
        self.decision_type[node] = dt
        self.threshold_in_bin[node] = threshold_bin
        self.threshold[node] = threshold_double
        self.num_leaves += 1
        return self.num_leaves - 1

    def split_categorical(self, leaf: int, feature: int, real_feature: int,
                          threshold_bins: List[int], thresholds: List[int],
                          left_value: float, right_value: float,
                          left_cnt: int, right_cnt: int,
                          left_weight: float, right_weight: float, gain: float,
                          missing_type: int) -> int:
        """Categorical (bitset) split; thresholds are uint32 bitset words."""
        node = self._split_common(leaf, feature, real_feature, left_value,
                                  right_value, left_cnt, right_cnt,
                                  left_weight, right_weight, gain)
        dt = K_CATEGORICAL_MASK | ((missing_type & 3) << 2)
        self.decision_type[node] = dt
        self.threshold_in_bin[node] = self.num_cat
        self.threshold[node] = self.num_cat
        self.num_cat += 1
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(thresholds))
        self.cat_threshold.extend(int(t) for t in thresholds)
        self.cat_boundaries_inner.append(
            self.cat_boundaries_inner[-1] + len(threshold_bins))
        self.cat_threshold_inner.extend(int(t) for t in threshold_bins)
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    def apply_shrinkage(self, rate: float) -> None:
        self.leaf_value[: self.num_leaves] *= rate
        self.internal_value[: max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        self.leaf_value[: self.num_leaves] += val
        self.internal_value[: max(self.num_leaves - 1, 0)] += val
        self.shrinkage = 1.0

    def as_constant_tree(self, val: float) -> None:
        self.num_leaves = 1
        self.leaf_value[0] = val

    def set_leaf_output(self, leaf: int, value: float) -> None:
        self.leaf_value[leaf] = value

    # ------------------------------------------------------------------
    def _is_categorical(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_CATEGORICAL_MASK)

    def _default_left(self, node: int) -> bool:
        return bool(self.decision_type[node] & K_DEFAULT_LEFT_MASK)

    def _missing_type(self, node: int) -> int:
        return (int(self.decision_type[node]) >> 2) & 3

    def _cat_contains(self, cat_idx: int, val: int) -> bool:
        lo = self.cat_boundaries[cat_idx]
        hi = self.cat_boundaries[cat_idx + 1]
        word = val // 32
        if word >= hi - lo:
            return False
        return bool((self.cat_threshold[lo + word] >> (val % 32)) & 1)

    def _decision(self, fval: float, node: int) -> int:
        """Raw-value traversal (reference tree.h:221-293 Decision)."""
        if self._is_categorical(node):
            if math.isnan(fval):
                return self.right_child[node]
            ival = int(fval)
            if ival < 0:
                return self.right_child[node]
            if self._cat_contains(int(self.threshold[node]), ival):
                return self.left_child[node]
            return self.right_child[node]
        mt = self._missing_type(node)
        if math.isnan(fval) and mt != MISSING_NAN:
            fval = 0.0
        if ((mt == MISSING_ZERO and abs(fval) <= K_ZERO_THRESHOLD)
                or (mt == MISSING_NAN and math.isnan(fval))):
            return (self.left_child[node] if self._default_left(node)
                    else self.right_child[node])
        return (self.left_child[node] if fval <= self.threshold[node]
                else self.right_child[node])

    def predict_row(self, row: np.ndarray) -> float:
        if self.num_leaves <= 1:
            return float(self.leaf_value[0])
        node = 0
        while node >= 0:
            node = self._decision(float(row[self.split_feature[node]]), node)
        return float(self.leaf_value[~node])

    def predict_leaf_row(self, row: np.ndarray) -> int:
        if self.num_leaves <= 1:
            return 0
        node = 0
        while node >= 0:
            node = self._decision(float(row[self.split_feature[node]]), node)
        return ~node

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Model text block (reference src/io/tree.cpp:209 Tree::ToString)."""
        nl = self.num_leaves
        lines = [f"num_leaves={nl}", f"num_cat={self.num_cat}"]
        n_int = max(nl - 1, 0)
        lines.append("split_feature=" + _array_to_str(self.split_feature[:n_int]))
        lines.append("split_gain=" + _array_to_str(self.split_gain[:n_int]))
        lines.append("threshold=" + _array_to_str(
            [float(t) for t in self.threshold[:n_int]], high_precision=True))
        lines.append("decision_type=" + _array_to_str(self.decision_type[:n_int]))
        lines.append("left_child=" + _array_to_str(self.left_child[:n_int]))
        lines.append("right_child=" + _array_to_str(self.right_child[:n_int]))
        lines.append("leaf_value=" + _array_to_str(
            [float(v) for v in self.leaf_value[:nl]], high_precision=True))
        lines.append("leaf_weight=" + _array_to_str(
            [float(v) for v in self.leaf_weight[:nl]], high_precision=True))
        lines.append("leaf_count=" + _array_to_str(self.leaf_count[:nl]))
        lines.append("internal_value=" + _array_to_str(
            [float(v) for v in self.internal_value[:n_int]]))
        lines.append("internal_weight=" + _array_to_str(
            [float(v) for v in self.internal_weight[:n_int]]))
        lines.append("internal_count=" + _array_to_str(self.internal_count[:n_int]))
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + _array_to_str(self.cat_boundaries))
            lines.append("cat_threshold=" + _array_to_str(self.cat_threshold))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Parse a Tree= block (reference src/io/tree.cpp:481 parse ctor)."""
        kv = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        nl = int(kv["num_leaves"])
        t = cls(max(nl, 2))
        t.num_leaves = nl
        t.num_cat = int(kv.get("num_cat", 0))
        t.shrinkage = float(kv.get("shrinkage", 1.0))

        def ints(key, n):
            if n == 0 or key not in kv or not kv[key].strip():
                return np.zeros(n, dtype=np.int64)
            return np.fromstring(kv[key], dtype=np.float64, sep=" ").astype(np.int64)[:n]

        def floats(key, n):
            if n == 0 or key not in kv or not kv[key].strip():
                return np.zeros(n, dtype=np.float64)
            return np.fromstring(kv[key], dtype=np.float64, sep=" ")[:n]

        n_int = max(nl - 1, 0)
        t.split_feature[:n_int] = ints("split_feature", n_int)
        t.split_feature_inner[:n_int] = t.split_feature[:n_int]
        t.split_gain[:n_int] = floats("split_gain", n_int)
        t.threshold[:n_int] = floats("threshold", n_int)
        t.decision_type[:n_int] = ints("decision_type", n_int)
        t.left_child[:n_int] = ints("left_child", n_int)
        t.right_child[:n_int] = ints("right_child", n_int)
        t.leaf_value[:nl] = floats("leaf_value", nl)
        t.leaf_weight[:nl] = floats("leaf_weight", nl)
        t.leaf_count[:nl] = ints("leaf_count", nl)
        t.internal_value[:n_int] = floats("internal_value", n_int)
        t.internal_weight[:n_int] = floats("internal_weight", n_int)
        t.internal_count[:n_int] = ints("internal_count", n_int)
        if t.num_cat > 0:
            t.cat_boundaries = list(ints("cat_boundaries", t.num_cat + 1))
            ncat_words = t.cat_boundaries[-1]
            t.cat_threshold = [int(x) for x in ints("cat_threshold", ncat_words)]
            # inner thresholds unavailable after load; raw-value traversal
            # only, until rebin_inner() runs against a dataset
            t.cat_boundaries_inner = list(t.cat_boundaries)
            t.cat_threshold_inner = list(t.cat_threshold)
        t.inner_valid = False
        t.recompute_depths()
        return t

    def rebin_inner(self, dataset) -> None:
        """Reconstruct the binned routing of a deserialized tree from the
        dataset's bin mappers, so score replay over binned data
        (ScoreUpdater.add_tree) routes identically to raw traversal.

        Model text stores raw thresholds (the bin upper bound,
        BinMapper.bin_to_value) and real category values; the inverse maps
        are exact: value_to_bin(upper_bound[b]) == b and
        categorical_2_bin[real_cat] == bin. The reference never needs this
        (its Predictor replays over raw rows, predictor.hpp); our replay
        path runs on the device-resident binned matrix instead."""
        n_int = max(self.num_leaves - 1, 0)
        cat_bounds = [0]
        cat_words: List[int] = []
        for node in range(n_int):
            mapper = dataset.bin_mappers[int(self.split_feature[node])]
            if self.decision_type[node] & K_CATEGORICAL_MASK:
                # for a deserialized tree the cat index rides threshold
                # (split_categorical stores it in both fields)
                ci = int(self.threshold[node])
                self.threshold_in_bin[node] = ci
                lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
                bins = []
                for w, word in enumerate(self.cat_threshold[lo:hi]):
                    for b in range(32):
                        if (int(word) >> b) & 1:
                            cat = w * 32 + b
                            bin_i = mapper.categorical_2_bin.get(cat)
                            if bin_i is not None:
                                bins.append(bin_i)
                n_words = (max(bins) // 32 + 1) if bins else 1
                words = [0] * n_words
                for b in bins:
                    words[b // 32] |= 1 << (b % 32)
                cat_words.extend(words)
                cat_bounds.append(cat_bounds[-1] + n_words)
            else:
                self.threshold_in_bin[node] = mapper.value_to_bin(
                    float(self.threshold[node]))
        if self.num_cat > 0:
            self.cat_boundaries_inner = cat_bounds
            self.cat_threshold_inner = cat_words
        self.inner_valid = True

    def recompute_depths(self) -> None:
        """Rebuild leaf_depth from the children arrays (reference
        Tree::RecomputeMaxDepth)."""
        if self.num_leaves <= 1:
            self.leaf_depth[0] = 0
            return
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            for child in (self.left_child[node], self.right_child[node]):
                if child >= 0:
                    stack.append((child, d + 1))
                else:
                    self.leaf_depth[~child] = d + 1

    def _node_to_json(self, node: int, feature_names=None) -> dict:
        if node >= 0:
            d = {
                "split_index": int(node),
                "split_feature": int(self.split_feature[node]),
                "split_gain": float(self.split_gain[node]),
                "threshold": (float(self.threshold[node])
                              if not self._is_categorical(node)
                              else "||".join(
                                  str(c) for c in self._cats_for_node(node))),
                "decision_type": ("==" if self._is_categorical(node) else "<="),
                "default_left": self._default_left(node),
                "missing_type": ["None", "Zero", "NaN"][self._missing_type(node)],
                "internal_value": float(self.internal_value[node]),
                "internal_weight": float(self.internal_weight[node]),
                "internal_count": int(self.internal_count[node]),
            }
            d["left_child"] = self._node_to_json(self.left_child[node])
            d["right_child"] = self._node_to_json(self.right_child[node])
            return d
        leaf = ~node
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(self.leaf_value[leaf]),
            "leaf_weight": float(self.leaf_weight[leaf]),
            "leaf_count": int(self.leaf_count[leaf]),
        }

    def _cats_for_node(self, node: int) -> List[int]:
        cat_idx = int(self.threshold[node])
        lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
        cats = []
        for w in range(lo, hi):
            word = self.cat_threshold[w]
            for b in range(32):
                if (word >> b) & 1:
                    cats.append((w - lo) * 32 + b)
        return cats

    def to_json(self) -> dict:
        out = {"num_leaves": int(self.num_leaves), "num_cat": int(self.num_cat),
               "shrinkage": float(self.shrinkage)}
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            out["tree_structure"] = self._node_to_json(0)
        return out

    # ------------------------------------------------------------------
    def depth(self) -> int:
        return int(self.leaf_depth[: self.num_leaves].max()) if self.num_leaves > 1 else 0
