"""TreeSHAP feature contributions, on the host.

Port of lightgbm_tpu/models/treeshap.py (reference: src/io/tree.cpp:669-713
TreeSHAP + PredictContrib). The recursion's arithmetic is the JAX
package's, in the same order. Its path lives in one buffer per tree, as
in the reference's tree.cpp: a node's path is a slice of four flat lists
that starts past its parent's, so a child copies its parent's elements
once instead of allocating a path of num_leaves + 2 elements per node.
"""
from __future__ import annotations

import numpy as np


class _Path:
    """Path elements (feature index, zero fraction, one fraction, pweight)
    as four flat lists; a node's element i is at its offset + i."""

    __slots__ = ("feat", "zero", "one", "pw")

    def __init__(self, size: int):
        self.feat = [-1] * size
        self.zero = [0.0] * size
        self.one = [0.0] * size
        self.pw = [0.0] * size


def _extend_path(p: _Path, off: int, unique_depth: int, zero_fraction: float,
                 one_fraction: float, feature_index: int) -> None:
    pw = p.pw
    j = off + unique_depth
    p.feat[j] = feature_index
    p.zero[j] = zero_fraction
    p.one[j] = one_fraction
    pw[j] = 1.0 if unique_depth == 0 else 0.0
    for i in range(unique_depth - 1, -1, -1):
        pw[off + i + 1] += (one_fraction * pw[off + i] * (i + 1)
                            / (unique_depth + 1))
        pw[off + i] = (zero_fraction * pw[off + i]
                       * (unique_depth - i) / (unique_depth + 1))


def _unwind_path(p: _Path, off: int, unique_depth: int,
                 path_index: int) -> None:
    pw = p.pw
    one_fraction = p.one[off + path_index]
    zero_fraction = p.zero[off + path_index]
    next_one_portion = pw[off + unique_depth]
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = pw[off + i]
            pw[off + i] = (next_one_portion * (unique_depth + 1)
                           / ((i + 1) * one_fraction))
            next_one_portion = (tmp - pw[off + i] * zero_fraction
                                * (unique_depth - i) / (unique_depth + 1))
        else:
            pw[off + i] = (pw[off + i] * (unique_depth + 1)
                           / (zero_fraction * (unique_depth - i)))
    for i in range(off + path_index, off + unique_depth):
        p.feat[i] = p.feat[i + 1]
        p.zero[i] = p.zero[i + 1]
        p.one[i] = p.one[i + 1]


def _unwound_path_sum(p: _Path, off: int, unique_depth: int,
                      path_index: int) -> float:
    pw = p.pw
    one_fraction = p.one[off + path_index]
    zero_fraction = p.zero[off + path_index]
    next_one_portion = pw[off + unique_depth]
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = (next_one_portion * (unique_depth + 1)
                   / ((i + 1) * one_fraction))
            total += tmp
            next_one_portion = (pw[off + i] - tmp * zero_fraction
                                * ((unique_depth - i) / (unique_depth + 1)))
        else:
            total += (pw[off + i] / zero_fraction
                      / ((unique_depth - i) / (unique_depth + 1)))
    return total


def _tree_shap(tree, row: np.ndarray, phi: np.ndarray, node: int,
               unique_depth: int, p: _Path, parent_off: int,
               parent_zero_fraction: float, parent_one_fraction: float,
               parent_feature_index: int) -> None:
    # this node's path: the parent's first unique_depth elements, then one
    off = parent_off + unique_depth
    if unique_depth > 0:
        for name in _Path.__slots__:
            a = getattr(p, name)
            a[off:off + unique_depth] = a[parent_off:parent_off
                                          + unique_depth]
    _extend_path(p, off, unique_depth, parent_zero_fraction,
                 parent_one_fraction, parent_feature_index)

    if node < 0:  # leaf
        leaf = ~node
        for i in range(1, unique_depth + 1):
            w = _unwound_path_sum(p, off, unique_depth, i)
            phi[p.feat[off + i]] += (w * (p.one[off + i] - p.zero[off + i])
                                     * tree.leaf_value[leaf])
        return

    hot, cold = _decide_children(tree, row, node)
    w = float(tree.internal_count[node])
    hot_count = _child_count(tree, hot)
    cold_count = _child_count(tree, cold)
    hot_zero = hot_count / w if w else 0.0
    cold_zero = cold_count / w if w else 0.0
    incoming_zero = 1.0
    incoming_one = 1.0
    feat = int(tree.split_feature[node])
    path_index = 0
    while path_index <= unique_depth:
        if p.feat[off + path_index] == feat:
            break
        path_index += 1
    if path_index != unique_depth + 1:
        incoming_zero = p.zero[off + path_index]
        incoming_one = p.one[off + path_index]
        _unwind_path(p, off, unique_depth, path_index)
        unique_depth -= 1

    _tree_shap(tree, row, phi, hot, unique_depth + 1, p, off,
               hot_zero * incoming_zero, incoming_one, feat)
    _tree_shap(tree, row, phi, cold, unique_depth + 1, p, off,
               cold_zero * incoming_zero, 0.0, feat)


def _decide_children(tree, row, node):
    nxt = tree._decision(float(row[tree.split_feature[node]]), node)
    if nxt == tree.left_child[node]:
        return tree.left_child[node], tree.right_child[node]
    return tree.right_child[node], tree.left_child[node]


def _child_count(tree, child):
    if child < 0:
        return float(tree.leaf_count[~child])
    return float(tree.internal_count[child])


def _expected_value(tree) -> float:
    total = float(tree.leaf_count[: tree.num_leaves].sum())
    if total <= 0:
        return float(tree.leaf_value[0])
    return float(np.sum(tree.leaf_value[: tree.num_leaves]
                        * tree.leaf_count[: tree.num_leaves]) / total)


def predict_contrib(booster, x, num_iteration=None) -> np.ndarray:
    """(N, (F+1)*K) SHAP values; the last column of each class's block is
    the expected value. An averaged model's (a random forest's) values,
    the expected value included, are divided by the iterations used, so
    each row's sum is its predict_raw score."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x.reshape(1, -1)
    n, _ = x.shape
    nf = booster.max_feature_idx + 1
    k = booster.num_class
    models = booster._used_models(num_iteration)
    out = np.zeros((n, (nf + 1) * k))
    for ti, tree in enumerate(models):
        cls = ti % booster.num_tree_per_iteration
        base = cls * (nf + 1)
        if tree.num_leaves <= 1:
            out[:, base + nf] += float(tree.leaf_value[0])
            continue
        expected = _expected_value(tree)
        # a path of at most depth + 1 elements per level, each level's
        # slice past its parent's
        depth = tree.depth() + 2
        p = _Path(depth * (depth + 1) // 2 + depth)
        for i in range(n):
            phi = np.zeros(nf + 1)
            phi[nf] += expected
            _tree_shap(tree, x[i], phi, 0, 0, p, 0, 1.0, 1.0, -1)
            out[i, base:base + nf + 1] += phi
    if booster.average_output and models:
        out /= max(1, len(models) // booster.num_tree_per_iteration)
    return out
