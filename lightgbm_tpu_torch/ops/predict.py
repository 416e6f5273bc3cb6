"""Vectorized tree traversal.

Port of lightgbm_tpu/ops/predict.py (reference: src/io/tree.cpp:115-207
AddPredictionToScore, tree.h:221-293 Decision): trees become padded
tensors, and all rows of all trees advance one level per step for a fixed
number of steps; rows that reached a leaf (negative node) stay put.
Scores then add up tree by tree in f32, in the JAX package's order.

Two threshold spaces, as in the JAX package: real thresholds for raw
feature values (Decision, ``predict_raw_ensemble``) and bin thresholds for
a dataset's binned codes (DecisionInner, ``predict_binned_tree_values``,
which the score updaters of validation sets and of a continued model run
once per tree).

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
    threshold_bin: torch.Tensor   # (T, M) int32 bin thresholds
    decision_type: torch.Tensor   # (T, M) int32
    left_child: torch.Tensor      # (T, M) int64
    right_child: torch.Tensor     # (T, M) int64
    leaf_value: torch.Tensor      # (T, L) f32
    max_depth: int


def _max_depth_steps(depth: int) -> int:
    """Traversal steps: the deepest tree's depth rounded up to a multiple
    of 8, as the JAX package rounds it."""
    return max(1, int(np.ceil(max(1, depth) / 8)) * 8)


def _refuse_categorical(decision_type) -> None:
    if np.any(np.asarray(decision_type) & 1):
        raise LightGBMError("categorical splits are not supported by this "
                            "port yet (ensemble has a categorical node)")


def ensemble_from_numpy(split_feature, threshold, threshold_bin,
                        decision_type, left_child, right_child, leaf_value,
                        max_depth: int, device) -> EnsembleArrays:
    """Device tensors from the numpy form of the padded arrays (the form
    lightgbm_tpu.ops.predict.trees_to_arrays returns, fetched to host)."""
    dt = np.asarray(decision_type)
    _refuse_categorical(dt)

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    return EnsembleArrays(
        t(split_feature, torch.int64), t(threshold, torch.float32),
        t(threshold_bin, torch.int32), t(dt, torch.int32), t(left_child, torch.int64),
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
    tb = pad2(nodes("threshold_in_bin"), max_nodes, np.int32)
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
        sf, th.astype(np.float32), tb, dtp, lc, rc, lv.astype(np.float32),
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


def predict_binned_leaf(binned: torch.Tensor, real_to_inner: np.ndarray,
                        f_default: np.ndarray, f_numbins: np.ndarray,
                        tree) -> torch.Tensor:
    """(N,) int64 leaf of every row of one host Tree over a dataset's
    logical (N, F) codes (DecisionInner semantics, lightgbm_tpu's
    predict_binned_leaf): at a node of missing type zero a row in the
    feature's default bin is missing, of missing type NaN a row in its
    last bin; a missing row goes the node's default way, any other left
    when its bin is <= the node's bin threshold. The per-node fields are
    joined on the host into one (6, M) table (inner column, bin
    threshold, missing bin, default left, children), so that a level is
    a few gathers and selects over the rows; the walk takes the tree's
    depth in levels. The tree's split_feature is the real feature index:
    `real_to_inner` maps it to the column of `binned`, and f_default /
    f_numbins are host arrays per inner feature."""
    n = binned.shape[0]
    dev = binned.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    m = tree.num_leaves - 1
    dt = np.asarray(tree.decision_type[:m], dtype=np.int32)
    _refuse_categorical(dt)
    col = np.asarray(real_to_inner)[tree.split_feature[:m]]
    mt = (dt >> 2) & 3
    miss = np.where(mt == MISSING_ZERO, np.asarray(f_default)[col],
                    np.where(mt == MISSING_NAN,
                             np.asarray(f_numbins)[col] - 1, -1))
    table = torch.as_tensor(np.stack([
        col, tree.threshold_in_bin[:m], miss, (dt & 2) > 0,
        tree.left_child[:m], tree.right_child[:m]]).astype(np.int64),
        device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree.depth()):
        at = table.index_select(1, node.clamp(min=0))          # (6, N)
        fbin = torch.gather(binned, 1, at[0:1].T)[:, 0].long()
        go_left = torch.where(fbin == at[2], at[3] > 0, fbin <= at[1])
        node = torch.where(node >= 0, torch.where(go_left, at[4], at[5]),
                           node)
    return ~node


def predict_binned_tree_values(binned: torch.Tensor,
                               real_to_inner: np.ndarray,
                               f_default: np.ndarray, f_numbins: np.ndarray,
                               tree) -> torch.Tensor:
    """(N,) f32 leaf value of every row of one host Tree over binned codes
    (lightgbm_tpu's predict_binned_tree_values)."""
    leaf = predict_binned_leaf(binned, real_to_inner, f_default, f_numbins,
                               tree)
    vals = torch.as_tensor(np.asarray(
        tree.leaf_value[:max(tree.num_leaves, 1)], dtype=np.float32),
        device=binned.device)
    return vals.index_select(0, leaf)
