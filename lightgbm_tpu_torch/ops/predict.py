"""Vectorized tree traversal.

Port of lightgbm_tpu/ops/predict.py (reference: src/io/tree.cpp:115-207
AddPredictionToScore, tree.h:221-293 Decision): trees become padded
tensors, and all rows of all trees advance one level per step for a fixed
number of steps; rows that reached a leaf (negative node) stay put.
Scores then add up tree by tree in f32, in the JAX package's order.

This slice predicts numerical splits only; an ensemble with categorical
splits is refused.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..utils.log import LightGBMError

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2
K_ZERO_THRESHOLD = 1e-35


class EnsembleArrays(NamedTuple):
    """Padded (T, max_nodes) / (T, max_leaves) ensemble tensors."""
    split_feature: torch.Tensor   # (T, M) int64
    threshold: torch.Tensor       # (T, M) f32 real thresholds
    decision_type: torch.Tensor   # (T, M) int32
    left_child: torch.Tensor      # (T, M) int64
    right_child: torch.Tensor     # (T, M) int64
    leaf_value: torch.Tensor      # (T, L) f32
    max_depth: int


def _max_depth_steps(depth: int) -> int:
    """Traversal steps: the deepest tree's depth rounded up to a multiple
    of 8, as the JAX package rounds it."""
    return max(1, int(np.ceil(max(1, depth) / 8)) * 8)


def ensemble_from_numpy(split_feature, threshold, decision_type, left_child,
                        right_child, leaf_value, max_depth: int,
                        device) -> EnsembleArrays:
    """Device tensors from the numpy form of the padded arrays (the form
    lightgbm_tpu.ops.predict.trees_to_arrays returns, fetched to host)."""
    dt = np.asarray(decision_type)
    if np.any(dt & 1):
        raise LightGBMError("categorical splits are not supported by this "
                            "port yet (ensemble has a categorical node)")

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    return EnsembleArrays(
        t(split_feature, torch.int64), t(threshold, torch.float32),
        t(dt, torch.int32), t(left_child, torch.int64),
        t(right_child, torch.int64), t(leaf_value, torch.float32),
        int(max_depth))


def trees_to_arrays(trees: Sequence, device) -> EnsembleArrays:
    """Tensorize host Trees into padded ensemble arrays (no bucketing:
    the port has no compiled program whose shape would key on them)."""
    t_count = len(trees)
    max_nodes = max(max(t.num_leaves - 1, 1) for t in trees)
    max_leaves = max(t.num_leaves for t in trees)

    def pad2(get, width, dt):
        out = np.zeros((t_count, width), dtype=dt)
        for i, tr in enumerate(trees):
            v = get(tr)
            out[i, : len(v)] = v
        return out

    def nodes(name):
        return lambda t: getattr(t, name)[: max(t.num_leaves - 1, 0)]

    sf = pad2(nodes("split_feature"), max_nodes, np.int64)
    th = pad2(nodes("threshold"), max_nodes, np.float64)
    dtp = pad2(nodes("decision_type"), max_nodes, np.int32)
    lc = pad2(nodes("left_child"), max_nodes, np.int64)
    rc = pad2(nodes("right_child"), max_nodes, np.int64)
    lv = pad2(lambda t: t.leaf_value[: t.num_leaves], max_leaves, np.float64)
    # single-leaf trees: node 0 routes to leaf 0 both sides
    for i, tr in enumerate(trees):
        if tr.num_leaves == 1:
            lc[i, 0] = -1
            rc[i, 0] = -1
    return ensemble_from_numpy(
        sf, th.astype(np.float32), dtp, lc, rc, lv.astype(np.float32),
        _max_depth_steps(max(t.depth() for t in trees)), device)


def predict_leaf_index(x: torch.Tensor,
                       arrays: EnsembleArrays) -> torch.Tensor:
    """(N, T) leaf index of every row in every tree over raw f32 values
    (Decision semantics: NaN maps to 0 unless the node's missing type is
    NaN; zero-missing treats |x| <= 1e-35 as missing)."""
    n = x.shape[0]
    t_count = arrays.split_feature.shape[0]
    tix = torch.arange(t_count, device=x.device)[None, :]
    node = torch.zeros((n, t_count), dtype=torch.int64, device=x.device)
    zero = x.new_zeros(())
    for _ in range(arrays.max_depth):
        live = node >= 0
        node_c = node.clamp(min=0)
        f = arrays.split_feature[tix, node_c]
        fval = torch.gather(x, 1, f)
        thr = arrays.threshold[tix, node_c]
        dt = arrays.decision_type[tix, node_c]
        default_left = (dt & 2) > 0
        mt = (dt >> 2) & 3
        is_nan = torch.isnan(fval)
        fval_n = torch.where(is_nan & (mt != MISSING_NAN), zero, fval)
        is_missing = torch.where(
            mt == MISSING_ZERO, torch.abs(fval_n) <= K_ZERO_THRESHOLD,
            (mt == MISSING_NAN) & torch.isnan(fval_n))
        go_left = torch.where(is_missing, default_left, fval_n <= thr)
        nxt = torch.where(go_left, arrays.left_child[tix, node_c],
                          arrays.right_child[tix, node_c])
        node = torch.where(live, nxt, node)
    return ~node


def predict_raw_ensemble(x: torch.Tensor, arrays: EnsembleArrays,
                         tree_class: torch.Tensor,
                         num_class: int) -> torch.Tensor:
    """Raw scores (N, num_class) f32: per-class sums of tree outputs,
    accumulated tree by tree."""
    leaves = predict_leaf_index(x, arrays)                       # (N, T)
    tix = torch.arange(leaves.shape[1], device=x.device)[None, :]
    vals = arrays.leaf_value[tix, leaves]                        # (N, T)
    scores = torch.zeros((x.shape[0], num_class), dtype=torch.float32,
                         device=x.device)
    classes = tree_class.tolist()
    for t, k in enumerate(classes):
        scores[:, k] += vals[:, t]
    return scores
