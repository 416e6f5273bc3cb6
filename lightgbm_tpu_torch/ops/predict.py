"""Vectorized tree traversal.

Port of lightgbm_tpu/ops/predict.py (reference: src/io/tree.cpp:115-207
AddPredictionToScore, tree.h:221-293 Decision): trees become padded
tensors, and all rows of all trees advance one level per step for a fixed
number of steps; rows that reached a leaf (negative node) stay put.
Scores then add up tree by tree in f32, in the JAX package's order.

The raw-value walk goes over the trees in chunks: the (N, T_chunk) int64
temporaries of one chunk stay under ``WALK_ELEMENTS`` elements (the JAX
package scans one tree at a time), and the scores still add up tree by
tree in the same order, so they do not depend on the chunking.

Two threshold spaces, as in the JAX package: real thresholds for raw
feature values (Decision, ``predict_raw_ensemble``) and bin thresholds for
a dataset's binned codes (DecisionInner, ``predict_binned_tree_values``,
which the score updaters of validation sets and of a continued model run
once per tree).

Categorical nodes (decision_type bit 0) go left iff the value's bit is
set in the node's bitset (tree.h CategoricalDecision /
CategoricalDecisionInner): raw values through cat_boundaries /
cat_threshold, where a negative, NaN or out-of-range value goes right;
binned codes through cat_boundaries_inner / cat_threshold_inner.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2
K_ZERO_THRESHOLD = 1e-35
# elements of one (N, T_chunk) temporary of the raw-value walk: 2^25
# int64 values are 256 MB (at 1M rows and 500 trees the whole walk's
# would be 4 GB each)
WALK_ELEMENTS = 1 << 25


class EnsembleArrays(NamedTuple):
    """Padded (T, max_nodes) / (T, max_leaves) ensemble tensors."""
    split_feature: torch.Tensor   # (T, M) int64
    threshold: torch.Tensor       # (T, M) f32 real thresholds
    threshold_bin: torch.Tensor   # (T, M) int32 bin thresholds
    decision_type: torch.Tensor   # (T, M) int32
    left_child: torch.Tensor      # (T, M) int64
    right_child: torch.Tensor     # (T, M) int64
    leaf_value: torch.Tensor      # (T, L) f32
    cat_boundaries: torch.Tensor  # (T, C + 2) int64 word offsets
    cat_threshold: torch.Tensor   # (T, W) int64 bitset words (uint32)
    max_depth: int


def _max_depth_steps(depth: int) -> int:
    """Traversal steps: the deepest tree's depth rounded up to a multiple
    of 8, as the JAX package rounds it."""
    return max(1, int(np.ceil(max(1, depth) / 8)) * 8)


def ensemble_from_numpy(split_feature, threshold, threshold_bin,
                        decision_type, left_child, right_child, leaf_value,
                        max_depth: int, device, cat_boundaries=None,
                        cat_threshold=None) -> EnsembleArrays:
    """Device tensors from the numpy form of the padded arrays (the form
    lightgbm_tpu.ops.predict.trees_to_arrays returns, fetched to host;
    its categorical arrays are the real-valued ones, absent: none)."""
    t_count = np.asarray(split_feature).shape[0]
    if cat_boundaries is None:
        cat_boundaries = np.zeros((t_count, 2), np.int64)
        cat_threshold = np.zeros((t_count, 1), np.int64)

    def t(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    return EnsembleArrays(
        t(split_feature, torch.int64), t(threshold, torch.float32),
        t(threshold_bin, torch.int32), t(decision_type, torch.int32),
        t(left_child, torch.int64), t(right_child, torch.int64),
        t(leaf_value, torch.float32), t(cat_boundaries, torch.int64),
        # the words as uint32 values, whatever their sign in int32 form
        t(np.asarray(cat_threshold, np.int64) & 0xFFFFFFFF, torch.int64),
        int(max_depth))


def _bucket_up(v: int) -> int:
    """Next power of two: the shape buckets of a served ensemble, so that
    models of one padded shape share their predictor cache entries."""
    out = 1
    while out < v:
        out *= 2
    return out


def trees_to_arrays(trees: Sequence, device,
                    bucket: bool = False) -> EnsembleArrays:
    """Tensorize host Trees into padded ensemble arrays.

    bucket=True pads every shape axis (trees, nodes, leaves, categorical
    widths) up to the next power of two, as the JAX package does for its
    compiled programs: padding trees are single-leaf trees of value 0, so
    summed scores are unchanged, and a retrained model of the same padded
    shape keys the same serving entries. Leaf-index prediction must not
    bucket (its output has one column per tree)."""
    t_real = len(trees)
    bk = _bucket_up if bucket else (lambda v: v)
    t_count = bk(t_real)
    max_nodes = bk(max(max(t.num_leaves - 1, 1) for t in trees))
    max_leaves = bk(max(t.num_leaves for t in trees))

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
    max_cats = bk(max(t.num_cat for t in trees))
    max_words = bk(max(max(len(t.cat_threshold), 1) for t in trees))
    cb = pad2(lambda t: np.asarray(t.cat_boundaries, np.int64),
              max_cats + 2, np.int64)
    ct = pad2(lambda t: np.asarray(t.cat_threshold, np.int64), max_words,
              np.int64)
    # single-leaf trees, and the bucket's padding trees after the real
    # ones: node 0 routes to leaf 0 both sides
    for i in range(t_count):
        if i >= t_real or trees[i].num_leaves == 1:
            lc[i, 0] = -1
            rc[i, 0] = -1
    return ensemble_from_numpy(
        sf, th.astype(np.float32), tb, dtp, lc, rc, lv.astype(np.float32),
        _max_depth_steps(max(t.depth() for t in trees)), device, cb, ct)


def padded_tree_class(arrays: EnsembleArrays, classes) -> torch.Tensor:
    """(T_pad,) int64 tree -> class map on the host: real trees take
    `classes`, bucket-padding trees class 0 (their leaf value is 0). It
    stays on the host because the walk reads it as Python ints per tree,
    which from a device tensor would be a sync per call."""
    tc = torch.zeros(arrays.split_feature.shape[0], dtype=torch.int64)
    classes = torch.as_tensor(np.asarray(classes, dtype=np.int64))
    tc[:len(classes)] = classes
    return tc


def _in_bitset(v: torch.Tensor, idx: torch.Tensor, bounds: torch.Tensor,
               words: torch.Tensor) -> torch.Tensor:
    """Whether int64 value v is set in bitset idx of (bounds, words) --
    the words bounds[idx] .. bounds[idx + 1] (Common::FindInBitset): a
    negative value or one past the bitset is not. The arrays are 1-d, or
    2-d with a leading tree axis that `v` and `idx` index as (N, T)."""
    if bounds.dim() == 1:
        bounds, words = bounds[None], words[None]
        tix = torch.zeros_like(idx)
    else:
        tix = torch.arange(bounds.shape[0], device=v.device)[None, :] \
            .expand_as(idx)
    nb, nw = bounds.shape[1], words.shape[1]
    lo = bounds[tix, idx.clamp(0, nb - 1)]
    hi = bounds[tix, (idx + 1).clamp(0, nb - 1)]
    wi = torch.div(v, 32, rounding_mode="floor")
    word = words[tix, (lo + wi).clamp(0, nw - 1)]
    return (v >= 0) & (wi < hi - lo) & (((word >> (v % 32)) & 1) == 1)


def tree_chunks(n: int, t_count: int):
    """[a, b) ranges of trees, in order, whose N x (b - a) stays under
    WALK_ELEMENTS (at least one tree each)."""
    step = max(1, WALK_ELEMENTS // max(n, 1))
    return [(a, min(a + step, t_count)) for a in range(0, t_count, step)]


def tree_slice(arrays: EnsembleArrays, a: int, b: int,
               depth: Optional[int] = None) -> EnsembleArrays:
    """Trees [a, b) of `arrays` as views; `depth`, the deepest of those
    trees, bounds their walk (default: the whole ensemble's bound)."""
    steps = arrays.max_depth if depth is None else _max_depth_steps(depth)
    return EnsembleArrays(*(f[a:b] for f in arrays[:-1]), steps)


def _walk(x: torch.Tensor, arrays: EnsembleArrays) -> torch.Tensor:
    """(N, T) leaf index of every row in every tree of `arrays`."""
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
        num_left = torch.where(is_missing, default_left, fval_n <= thr)
        # categorical on raw int values: NaN -> -1 (goes right); an int32
        # conversion truncates toward zero, as XLA's does
        ival = torch.where(is_nan, -1.0, fval.clamp(-2.0**31, 2.0**31 - 128))
        cat_left = _in_bitset(ival.to(torch.int32).long(), thr.long(),
                              arrays.cat_boundaries, arrays.cat_threshold)
        go_left = torch.where((dt & 1) > 0, cat_left, num_left)
        nxt = torch.where(go_left, arrays.left_child[tix, node_c],
                          arrays.right_child[tix, node_c])
        node = torch.where(live, nxt, node)
    return ~node


def predict_leaf_chunks(x: torch.Tensor, arrays: EnsembleArrays):
    """Yields (a, b, (N, b - a) int64 leaves) over the tree chunks, in
    order (Decision semantics: NaN maps to 0 unless the node's missing
    type is NaN; zero-missing treats |x| <= 1e-35 as missing)."""
    for a, b in tree_chunks(x.shape[0], arrays.split_feature.shape[0]):
        yield a, b, _walk(x, tree_slice(arrays, a, b))


def predict_leaf_index(x: torch.Tensor,
                       arrays: EnsembleArrays) -> torch.Tensor:
    """(N, T) leaf index of every row in every tree over raw f32 values,
    walked in tree chunks."""
    chunks = list(predict_leaf_chunks(x, arrays))
    if len(chunks) == 1:
        return chunks[0][2]
    return torch.cat([c for _, _, c in chunks], dim=1)


def predict_raw_ensemble(x: torch.Tensor, arrays: EnsembleArrays,
                         tree_class: torch.Tensor,
                         num_class: int) -> torch.Tensor:
    """Raw scores (N, num_class) f32: per-class sums of tree outputs,
    accumulated tree by tree, one tree chunk's walk at a time."""
    scores = torch.zeros((x.shape[0], num_class), dtype=torch.float32,
                         device=x.device)
    classes = tree_class.tolist()
    for a, b, leaves in predict_leaf_chunks(x, arrays):
        tix = torch.arange(a, b, device=x.device)[None, :]
        vals = arrays.leaf_value[tix, leaves]                    # (N, T_c)
        for t in range(a, b):
            scores[:, classes[t]] += vals[:, t - a]
    return scores


def predict_binned_leaf(binned: torch.Tensor, real_to_inner: np.ndarray,
                        f_default: np.ndarray, f_numbins: np.ndarray,
                        tree) -> torch.Tensor:
    """(N,) int64 leaf of every row of one host Tree over a dataset's
    logical (N, F) codes (DecisionInner semantics, lightgbm_tpu's
    predict_binned_leaf): at a node of missing type zero a row in the
    feature's default bin is missing, of missing type NaN a row in its
    last bin; a missing row goes the node's default way, any other left
    when its bin is <= the node's bin threshold; at a categorical node
    left when its bin is set in the node's inner bitset
    (cat_boundaries_inner / cat_threshold_inner). The per-node fields are
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
    col = np.asarray(real_to_inner)[tree.split_feature[:m]]
    mt = (dt >> 2) & 3
    miss = np.where(mt == MISSING_ZERO, np.asarray(f_default)[col],
                    np.where(mt == MISSING_NAN,
                             np.asarray(f_numbins)[col] - 1, -1))
    table = torch.as_tensor(np.stack([
        col, tree.threshold_in_bin[:m], miss, (dt & 2) > 0,
        tree.left_child[:m], tree.right_child[:m], dt & 1]).astype(np.int64),
        device=dev)
    cat = None
    if tree.num_cat > 0:
        cat = [torch.as_tensor(np.asarray(a, np.int64) & 0xFFFFFFFF,
                               device=dev)
               for a in (tree.cat_boundaries_inner,
                         tree.cat_threshold_inner)]
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree.depth()):
        at = table.index_select(1, node.clamp(min=0))          # (7, N)
        fbin = torch.gather(binned, 1, at[0:1].T)[:, 0].long()
        go_left = torch.where(fbin == at[2], at[3] > 0, fbin <= at[1])
        if cat is not None:
            # a categorical node's bin threshold is its bitset's index
            go_left = torch.where(at[6] > 0,
                                  _in_bitset(fbin, at[1], *cat), go_left)
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
