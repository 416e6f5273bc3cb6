"""Leaf-wise tree learner, in torch: the compact, masked and chunk strategies.

Port of lightgbm_tpu/models/device_learner.py for the serial case of its
three single-device strategies, each with float or quantized gradients,
numerical and categorical features, the row sampling of bagging and GOSS,
per-node feature sampling, (compact) the LRU-capped histogram pool, and
(chunk) rows streamed from the host.

**Compact** (``grow_tree_compact_core``, JAX :808). The reference's
DataPartition (data_partition.hpp:20-205) becomes one packed int32 working
buffer -- bit-packed codes | gh section | row id -- that is physically
reordered per split, so every read of a leaf (split decision, histogram
input) is a contiguous slice. The gh section is three bitcast f32 words
(grad, hess, weight) on the float path, one (qg << 16 | qh) word on the
quantized path. Per split:
  1. the leaf with the best stored gain is chosen (argmax over the (L, 12)
     ``best`` array, the reference's best_split_per_leaf_);
  2. its window decodes the split feature and decides left/right;
  3. kernel K4 stably partitions the window into the other working buffer
     (the two buffers ping-pong: a leaf's rows live in exactly one of
     them, and a split moves the window to the other one);
  4. kernel K1 (float) or K3 (exact int32) builds the histogram of the
     smaller child from its contiguous half of the window;
  5. the sibling is parent - child (FeatureHistogram::Subtract);
  6. both children are scanned in one batched pass and stored in ``best``.
After the loop, the row -> leaf map comes from scattering the final
position -> leaf map over the row-id column.

**Masked** (JAX ``grow_tree`` :307), which ``auto`` picks below 65,536
rows. Codes stay column-major (C, N); the row -> leaf map ``leaf_id`` is
rewritten per split, and the left child's histogram is built over all N
rows with the others' gh zeroed (kernel K2, or K3t when quantized); the
right child is parent - left.

Quantized gradients (ops/quantize.py): the iteration's (grad, hess) are
rounded stochastically with the threefry port, so the integers, the
int32 histograms and the pool are the JAX package's bit for bit; the
scans read dequantized f32 copies. The compact core re-quantizes each
leaf's operand at a leaf-local ratio when ``quant_renew`` is on; the
masked core keeps one ratio per tree.

**Both cores on the device** (``grow_compact`` and ``grow_masked``, what
``grow`` and the fused iteration run). As in the JAX package, the whole
tree grows without a host sync: the state lives in device tensors
allocated once per learner (``DeviceCarry``, the JAX ``_CarryC``;
``MaskedCarry``, the JAX ``_Carry``), and ``split_step``
/ ``masked_split_step`` is the core's split body over it, every write
gated on the step's ``go``, with the bookkeeping both share in
``split_epilogue_device``.
``ops/fused.py::SplitLoop`` runs the step num_leaves - 1 times per tree:
replays of one CUDA graph on the card, eager steps on the CPU. The
kernels of a step read the split from the split descriptor in device
memory (ops/kernels/desc.py) on grids that do not depend on it: the
compact core's kernels walk exactly the leaf's window, so the JAX core's
window-size ladder (``_size_classes``, a ``lax.switch`` over padded
windows) has no counterpart; the masked core's split key (column entry)
and K2 / K3t walk all N rows, as the JAX body does. The tree's split
records, its split count k and the row -> leaf map stay on the device;
the caller fetches records and k in one copy.

**Chunk** (``grow_tree_chunk_core``, JAX :1413; ``strategy=chunk``).
The compact core's rows in one working buffer data0 of N + CH rows, every
leaf's rows kept in it: a split runs over the leaf's CH-row chunks (K4 on
each chunk, its rows past the leaf's end at key 2; the chunks' lefts and
rights then placed, stably, after each other), and the smaller child's
histogram sums its per-chunk histograms. JAX needs the chunks for its
fixed shapes; here K4's device-window entry takes any row count on a grid
fixed by D, so the chunk core's final layout (the stable partition of the
whole leaf) is the compact core's split in one launch. ``strategy=chunk``
therefore runs the compact core's device loop, and the chunk core is the
host loop the tests and chip_smoke hold it to (equal records). Under
``stream_mode`` (chunked or goss, always ``strategy=chunk``) the learner
keeps no device copy of the rows, and each tree's working buffer is
assembled from the host wire store (io/stream.py): every row in order, or
a bag's rows compacted, GOSS's pinned working set gathered on the device;
the out-of-bag rows stream through the router.

``grow_tree_compact_core``, ``grow_tree`` and ``grow_tree_chunk_core``
are the cores as host loops (one host sync per split, to read the chosen
leaf's best row and slice each window with host ints; the chunk loop one
more per chunk). They are kept as the oracles the device loops' records
are held against, and no parameter reaches them.

``make_fused_step`` ports the JAX single-program boosting iteration:
gradients, the row sample, the working rows or operand, the tree, its
leaf values from the records and the score update, all on the device.

**Row sampling** (bagging, GOSS). A bag is 0/1 row weights in the JAX
package. The masked core takes them as they are: its operand is [g * w,
h * w, w]. The compact core compacts the bag instead (the JAX fused
iteration's bag compaction): the bag's rows are gathered into a carry of
their own, and after the tree the router (``route_rows``, the JAX
``route_rows_by_rec``) gives each out-of-bag row its leaf from the split
records. That gives the records of the JAX weighted layout: a 0-weight row
adds nothing to a histogram's sums or count, its gradient quantizes to 0
and so changes no stored-int max, and the records' weighted counts are
the bag's physical counts. The same holds for the generic iteration's
host bag (``train(..., bag_indices)``), which quantizes grad * w over all
N rows before the gather, as JAX does; so the port has no two-word gh
section (the JAX gw = 2 layout).

**Categorical features** (the JAX merged mode): every leaf scan runs the
numerical search over the numerical features and the categorical one
(one-hot or sorted k-vs-rest, ops/split.py) over the categorical
features of the same histograms; the better gain wins, and a categorical
winner's left bins ride beside its best row as W = ceil(B / 32) int32
bitset words (the JAX (L, B) f32 masks, packed). A split sends a row left
iff its logical bin's bit is set: the host loops decode it in torch, the
device loops through the split descriptor's CAT field and words (the
split key's packed and column entries), the router from each record's
words. fetch_tree brings the records' words back in the tree's one copy,
and replay_tree makes bitset nodes of them.
"""
from __future__ import annotations

import gc
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry
from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import Dataset
from ..ops import bundle as bundle_ops
from ..ops import quantize as quant_ops
from ..ops import split as split_ops
from ..ops.fused import SplitLoop, leaf_values_from_rec
from ..ops.histogram import (accumulate_histogram, build_histogram,
                             subtract_histogram)
from ..ops.kernels import desc as dsc
from ..ops.kernels import histogram as khist
from ..ops.kernels import partition as kpart
from ..ops.kernels import split_key as kkey
from ..ops.kernels.histogram import (build_histogram_quantized_rows,
                                     build_histogram_quantized_t,
                                     build_histogram_quantized_window,
                                     build_histogram_t,
                                     build_histogram_window, packed_codes)
from ..ops.kernels.partition import (stable_partition3,
                                     stable_partition3_window)
from ..ops.kernels.split_key import route_rows, split_key, split_key_column
from ..telemetry import counters as telem_counters
from ..telemetry import recorder as telem
from ..ops.partition import (decide_left, decide_left_categorical,
                             mask_to_words)
from ..utils import log
from ..utils import random as trandom
from ..io.stream import DeviceDataShard
from ..utils.envs import chunk_fuse_hist_env, chunk_rows_env, strategy_env
from ..utils.log import LightGBMError
from .tree import Tree

NEG_INF = split_ops.NEG_INF

# Per-leaf best-split state: ONE (L, 12) f32 array (the reference's
# best_split_per_leaf_); feat/thr ride as exact small f32.
B_GAIN, B_FEAT, B_THR, B_DLEFT, B_LSG, B_LSH, B_LCNT, B_RSG, B_RSH, \
    B_RCNT, B_LOUT, B_ROUT = range(12)

# Per-split records: (L-1, 13) f32, replayed into a Tree.
R_LEAF, R_FEAT, R_THR, R_DLEFT, R_GAIN, R_LSG, R_LSH, R_LCNT, R_RSG, \
    R_RSH, R_RCNT, R_LOUT, R_ROUT = range(13)

_POOL_BYTE_LIMIT = 2 << 30


def padded_device_bins(raw_bins: int) -> int:
    """Pow2-padded on-device bin count (min 16), as in the JAX package."""
    return 1 << max(4, (int(raw_bins) - 1).bit_length())


def plan_histogram_pool(config: Config, dataset: Dataset):
    """(slot_bytes, pool_slots): the LRU histogram-pool budget math
    (reference HistogramPool, feature_histogram.hpp:654-831), the JAX
    package's. histogram_pool_size is the budget in MB (< 0: none given,
    then 1 GiB); pool_slots == 0 means the dense one-slot-per-leaf pool
    fits, else the compact core keeps max(2, pool_slots) LRU slots."""
    if dataset.columns:
        ncols = max(1, len(dataset.columns))
        raw_bins = max(c.num_bins for c in dataset.columns)
    else:
        ncols = max(1, dataset.num_features)
        raw_bins = int(dataset.max_num_bins)
    slot_bytes = ncols * padded_device_bins(raw_bins) * 12
    if config.histogram_pool_size and config.histogram_pool_size > 0:
        budget = int(config.histogram_pool_size * (1 << 20))
    else:
        budget = 1 << 30
    k_cap = max(8, budget // slot_bytes)
    L = int(config.num_leaves)
    return slot_bytes, (k_cap if L > k_cap else 0)


def resolve_strategy(config: Config, dataset: Dataset,
                     forced: Optional[str] = None) -> str:
    """The growth strategy (the JAX package's rule, shared by __init__ and
    supports): `forced`, else LGBM_TPU_STRATEGY, else auto -- compact at
    65,536 rows and above, masked below. chunk needs the dense histogram
    pool: under an LRU-capped pool it falls back to compact here without
    a word (supports probes this; __init__ logs the fallback once). With
    stream_mode chunked or goss the result is always chunk, and the
    masked strategy or an LRU-capped pool raises."""
    strat = forced or strategy_env()
    stream = str(getattr(config, "stream_mode", "off") or "off")
    if stream in ("chunked", "goss"):
        if strat == "masked":
            raise LightGBMError(
                "stream_mode=%s requires the chunk growth core; the "
                "masked strategy has no chunk seam (unset "
                "LGBM_TPU_STRATEGY=masked or turn streaming off)"
                % stream)
        _, pool_slots = plan_histogram_pool(config, dataset)
        if pool_slots > 0:
            raise LightGBMError(
                "stream_mode=%s needs the dense histogram pool but "
                "num_leaves=%d exceeds the histogram_pool_size budget "
                "(LRU pool has no chunk seam); raise "
                "histogram_pool_size or reduce num_leaves"
                % (stream, int(config.num_leaves)))
        return "chunk"
    if strat == "auto":
        strat = "compact" if dataset.num_data >= 65536 else "masked"
    if strat not in ("compact", "masked", "chunk"):
        raise LightGBMError("strategy=%s is not a growth strategy (auto, "
                            "compact, masked or chunk)" % strat)
    if strat == "chunk" and plan_histogram_pool(config, dataset)[1] > 0:
        strat = "compact"
    return strat


def pool_size(num_leaves: int, pool_slots: int) -> int:
    """The compact core's pool slots K: max(2, pool_slots) LRU slots when
    the plan caps the pool below num_leaves (one slot cannot hold both
    children of a split), else one per leaf (the JAX core's K)."""
    if 0 < pool_slots < num_leaves:
        return max(2, pool_slots)
    return num_leaves


def node_masks(keys: torch.Tensor, base_mask: torch.Tensor,
               bynode_k: int) -> torch.Tensor:
    """By-node feature sampling (the JAX _tree_helpers.node_mask): for
    each (..., 2) int64 key on base_mask's device, bynode_k of the (F,)
    base mask's features -- u uniform where the base mask is set, inf
    elsewhere, a sort, the bynode_k-th value, base & (u <= kth). Returns
    (..., F) bool; no host sync."""
    u = trandom.uniform_on_device(keys, base_mask.shape[0])
    u = torch.where(base_mask, u, torch.full_like(u, float("inf")))
    kth = torch.sort(u, dim=-1).values[..., bynode_k - 1:bynode_k]
    return base_mask & (u <= kth)


def tree_keys(key: torch.Tensor, quantized: bool, device):
    """The by-node key chain's start from a tree's key (a host key): the
    quantized cores first split off the quantization's key (the key the
    JAX _quant_prepare returns), then every core splits (root key, loop
    key). Both on `device`."""
    if quantized:
        key = trandom.split(key)[0]
    root_key, loop_key = trandom.split(key)
    return root_key.to(device), loop_key.to(device)


def column_go_left(col: torch.Tensor, feat: int, thr: int, dleft: bool,
                   meta: dict,
                   words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The split decision over one column's raw codes: unmap feature
    `feat`'s logical bins (EFB) and compare, or, for a categorical
    feature, look the bins up in the split's (W,) int32 bitset `words`
    (the JAX cat_mask). The feature's metadata are host arrays in `meta`
    (f_base, f_elide, f_numbins, f_missing, f_default, f_categorical)."""
    nb = int(meta["f_numbins"][feat])
    default = int(meta["f_default"][feat])
    fbins = bundle_ops.logical_bins_for_feature(
        col, int(meta["f_base"][feat]), default, nb,
        int(meta["f_elide"][feat]))
    if words is not None and meta["f_categorical"][feat]:
        return decide_left_categorical(fbins, words)
    return decide_left(fbins, thr, dleft, int(meta["f_missing"][feat]),
                       default, nb)


def packed_go_left(win: torch.Tensor, feat: int, thr: int, dleft: bool,
                   meta: dict, *, item_bits: int,
                   words: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode feature `feat`'s codes from a packed int32 row window and
    apply the split decision (column_go_left)."""
    per = 32 // item_bits
    col_i = int(meta["f_col"][feat])
    word, sub = col_i // per, col_i % per
    col = (win[:, word] >> (sub * item_bits)) & ((1 << item_bits) - 1)
    return column_go_left(col, feat, thr, dleft, meta, words)


def partition_window(win: torch.Tensor, key3: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Stable 3-way reorder of a (W, D) int32 window by key3 in {0,1,2}
    into `out` (reference DataPartition::Split) -- kernel K4."""
    return stable_partition3(win, key3, out)


def _merge_num_cat(res: split_ops.SplitResult,
                   cres: split_ops.CatSplitResult, words: int):
    """Merge each leaf's numerical and categorical candidates (the JAX
    _merge_num_cat, the in-program SerialTreeLearner._merge_categorical):
    the categorical one wins only on a strictly greater gain, and then
    its record has threshold 0 and default_left False. Returns (merged
    SplitResult, (N, words) int32 bitset of the winner's left bins, all
    clear where the numerical candidate wins)."""
    cat_wins = cres.gain > res.gain

    def pick(c, r):
        return torch.where(cat_wins, c, r)

    merged = split_ops.SplitResult(
        pick(cres.gain, res.gain), pick(cres.feature, res.feature),
        torch.where(cat_wins, torch.zeros_like(res.threshold),
                    res.threshold),
        res.default_left & ~cat_wins,
        pick(cres.left_sum_grad, res.left_sum_grad),
        pick(cres.left_sum_hess, res.left_sum_hess),
        pick(cres.left_count, res.left_count),
        pick(cres.right_sum_grad, res.right_sum_grad),
        pick(cres.right_sum_hess, res.right_sum_hess),
        pick(cres.right_count, res.right_count),
        pick(cres.left_output, res.left_output),
        pick(cres.right_output, res.right_output))
    return merged, mask_to_words(cres.left_mask & cat_wins[:, None], words)


def _tree_helpers(f_numbins, f_missing, f_default, f_monotone, f_penalty,
                  f_elide, hist_idx, *, max_depth, l1, l2, max_delta_step,
                  min_data_in_leaf, min_sum_hessian, min_gain_to_split,
                  f_categorical=None, cat_statics=None):
    """The split search shared by the root and the children: expand the
    column histograms, scan, pick each leaf's best feature, format best
    rows (with depth gating).

    cat_statics = (cat_l2, cat_smooth, max_cat_threshold,
    max_cat_to_onehot, min_data_per_group) with the (F,) int32
    f_categorical switches the scan to the JAX merged mode: the numerical
    scan over the numerical features and the categorical one over the
    categorical features, of the same expanded histograms, the better
    gain winning (_merge_num_cat). scan returns (SplitResult, (N, W)
    int32 left-bin bitsets, W = ceil(B / 32)); without cat_statics the
    bitsets are None."""
    scan_kwargs = dict(
        l1=l1, l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf, min_sum_hessian=min_sum_hessian,
        min_gain_to_split=min_gain_to_split)
    has_cat = cat_statics is not None
    if has_cat:
        is_cat = f_categorical != 0
        cat_l2, cat_smooth, max_cat_threshold, max_cat_to_onehot, \
            min_data_per_group = cat_statics
        cat_kwargs = dict(
            scan_kwargs, cat_l2=cat_l2, cat_smooth=cat_smooth,
            max_cat_threshold=max_cat_threshold,
            max_cat_to_onehot=max_cat_to_onehot,
            min_data_per_group=min_data_per_group)

    def scan(col_hist, sg, sh, cnt, mn, mx, fmask):
        hist = bundle_ops.expand_column_hist(
            col_hist, torch.stack([sg, sh, cnt], dim=-1), hist_idx,
            f_elide, f_default)
        rel, t, use_m1, prefix = split_ops.per_feature_best(
            hist, sg, sh, cnt, f_numbins, f_missing, f_default,
            fmask & ~is_cat if has_cat else fmask,
            f_monotone, mn, mx, f_penalty, **scan_kwargs)
        feat = torch.argmax(rel, dim=1)
        res = split_ops.materialize_split(
            feat, rel, t, use_m1, prefix, sg, sh, cnt, mn, mx,
            l1=l1, l2=l2, max_delta_step=max_delta_step)
        if not has_cat:
            return res, None
        crel, caux = split_ops.per_feature_best_categorical(
            hist, sg, sh, cnt, f_numbins, f_missing, fmask & is_cat, mn, mx,
            f_penalty, **cat_kwargs)
        cres = split_ops.materialize_cat_split(
            torch.argmax(crel, dim=1), crel, caux, hist, sg, sh, cnt, mn,
            mx, l1=l1, l2=l2, cat_l2=cat_l2, max_delta_step=max_delta_step)
        return _merge_num_cat(res, cres, (hist.shape[2] + 31) // 32)

    def best_row(res: split_ops.SplitResult, child_depth):
        # child_depth: a host int, or a 0-d device tensor (device loop)
        gain = res.gain
        if max_depth > 0:
            deep = child_depth >= max_depth
            if torch.is_tensor(deep):
                gain = torch.where(deep, NEG_INF, gain)
            elif deep:
                gain = torch.full_like(gain, NEG_INF)
        return torch.stack([
            gain, res.feature.float(), res.threshold.float(),
            res.default_left.float(), res.left_sum_grad,
            res.left_sum_hess, res.left_count, res.right_sum_grad,
            res.right_sum_hess, res.right_count, res.left_output,
            res.right_output], dim=1)

    return scan, best_row


def search2_simple(scan, best_row):
    """Both children's scans in one batched pass -> (2, 12) best rows and
    their (2, W) left-bin bitsets (None without categorical features)."""
    def search2(col_hist2, sg2, sh2, cnt2, mn2, mx2, fmask, child_depth):
        res, words = scan(col_hist2, sg2, sh2, cnt2, mn2, mx2, fmask)
        return best_row(res, child_depth), words
    return search2


def split_epilogue(*, k, l, new_id, row, row_dev, mono_f, leaf_min,
                   leaf_max, depth, rec, best, hist_l, hist_r, fmask,
                   search2, best_cat=None, rec_cat=None, key=None,
                   bynode_k=0):
    """The split bookkeeping of the JAX core's split_epilogue: monotone
    constraint propagation (basic mode, serial_tree_learner.cpp:771-852),
    depth update, the split record, and the two children's re-scan.
    `row` is the leaf's best row on the host, `row_dev` the same row on
    the device; leaf_min / leaf_max (L,) stay on the device, `depth` and
    `rec` on the host; with categorical features the (L, W) left-bin
    bitsets best_cat and the records' (L-1, W) rec_cat on the device.
    Updates them in place. With by-node sampling (bynode_k > 0) the
    by-node key is split as in JAX (key, kl, kr = split(key, 3)) and each
    child scans its own node_masks draw of `fmask`; returns the next
    key."""
    mid = (row_dev[B_LOUT] + row_dev[B_ROUT]) * 0.5
    pmin, pmax = leaf_min[l], leaf_max[l]
    lmin = torch.maximum(pmin, mid) if mono_f < 0 else pmin
    lmax = torch.minimum(pmax, mid) if mono_f > 0 else pmax
    rmin = torch.maximum(pmin, mid) if mono_f > 0 else pmin
    rmax = torch.minimum(pmax, mid) if mono_f < 0 else pmax
    mn2 = torch.stack([lmin, rmin])
    mx2 = torch.stack([lmax, rmax])
    # element-wise writes with host ints: a list index would be a
    # host->device copy, and torch synchronises on those
    leaf_min[l], leaf_min[new_id] = mn2[0], mn2[1]
    leaf_max[l], leaf_max[new_id] = mx2[0], mx2[1]
    child_depth = depth[l] + 1
    depth[l] = depth[new_id] = child_depth

    rec[k, :5] = (l, row[B_FEAT], row[B_THR], row[B_DLEFT], row[B_GAIN])
    rec[k, 5:] = row[B_LSG:]
    if rec_cat is not None:
        rec_cat[k] = best_cat[l]

    if bynode_k > 0:
        keys3 = trandom.split_on_device(key, 3)
        key = keys3[0]
        fmask = node_masks(keys3[1:], fmask, bynode_k)
    rows2, words2 = search2(torch.stack([hist_l, hist_r]),
                            row_dev[B_LSG::3][:2], row_dev[B_LSH::3][:2],
                            row_dev[B_LCNT::3][:2], mn2, mx2, fmask,
                            child_depth)
    best[l], best[new_id] = rows2[0], rows2[1]
    if best_cat is not None:
        best_cat[l], best_cat[new_id] = words2[0], words2[1]
    return key


class GrowStats:
    """Counters of the growth loop, summed over the trees a learner grew:
    device->host syncs, splits and trees; the carries it made, each with
    its split loop (on the card, a captured graph); and, with an
    LRU-capped pool, the splits that missed their parent's histogram."""

    def __init__(self):
        self.host_syncs = 0
        self.splits = 0
        self.trees = 0
        self.captures = 0
        self.pool_misses = 0       # LRU pool: splits whose parent was evicted


def _next_split(best: torch.Tensor, stats: Optional[GrowStats]):
    """The one host sync per split: the leaf with the best stored gain and
    its best row, fetched together. Returns (l, row on the host, row on
    the device), or None when no leaf has a positive gain."""
    l_dev = torch.argmax(best[:, B_GAIN]).view(1)
    row_dev = best.index_select(0, l_dev)[0]
    fetched = torch.cat([l_dev.float(), row_dev]).cpu().numpy()
    if stats is not None:
        stats.host_syncs += 1
    row = fetched[1:]
    if not row[B_GAIN] > 1e-10:
        return None
    return int(fetched[0]), row, row_dev


class QuantRows(NamedTuple):
    """The quantized working rows' scales for one tree (compact core):
    storage scales s_g, s_h (f32 scalars), the operand's bits and cap,
    and -- under leaf re-quantization -- the root's max |stored int|."""
    bits: int
    qcap_op: int
    s_g: torch.Tensor
    s_h: torch.Tensor
    root_max: Optional[torch.Tensor]       # (2,) f32, None = renew off


def _quant_prepare(grad, hess, key, *, quant_bits: int, quant_renew: bool):
    """Quantize one iteration's (grad, hess) for the growth cores (JAX
    :711, single device, all-ones weights): split the key as the masked
    strategy does, discretize at the storage resolution (16 bits under
    leaf re-quantization, else grad_bits) and, when renewing, measure the
    root's stored-int maxes. Returns (packed (N,) int32, s_g, s_h,
    root_max (2,) f32 or None)."""
    qkey = trandom.split(key)[1]
    packed, s_g, s_h = quant_ops.quantize_gh_core(
        grad, hess, qkey,
        grad_bits=quant_ops.storage_bits(quant_bits, quant_renew))
    if not quant_renew:
        return packed, s_g, s_h, None
    qg, qh = quant_ops.unpack_gh(packed)
    m = torch.stack([qg.abs().max(), qh.abs().max()]).float()
    return packed, s_g, s_h, m


def exact_k_bag_weights(bag_key: torch.Tensor, n: int, bag_k: int,
                        device) -> torch.Tensor:
    """(n,) f32 0/1 bagging weights with bag_k ones (more only where
    uniforms tie at the cut), deterministic per key: the JAX package's
    exact_k_bag_weights (reference Bagging, gbdt.cpp:210-276). The key is
    a host tensor; the uniforms are drawn on `device`. The cut comes from
    a full sort, as in JAX: on the card `torch.kthvalue` selects in one
    block (5.1 ms of a 126 ms bagged iteration at 1M rows, NVIDIA H100;
    PERF.md)."""
    u = trandom.uniform(bag_key, n, device)
    cut = torch.sort(u).values[bag_k - 1]
    return (u <= cut).float()


def goss_sample(g: torch.Tensor, h: torch.Tensor, bag_key: torch.Tensor,
                n: int, top_k: int, other_k: int, multiply: float):
    """In-program GOSS (reference goss.hpp:60-117), the JAX package's
    goss_sample: the top_k rows by |g * h| (a stable sort, so ties keep
    row order), other_k of the rest taken by a stable sort of uniforms,
    their gradients amplified by `multiply`. Returns (g, h, w, bag_idx,
    oob_idx): amplified gradients, 0/1 weights, and the in-bag (top rows
    first) and out-of-bag row ids."""
    ridx = torch.argsort(-(g * h).abs(), stable=True)
    top_idx, rest = ridx[:top_k], ridx[top_k:]
    perm = torch.argsort(trandom.uniform(bag_key, n - top_k, g.device),
                         stable=True)
    other_idx = rest.index_select(0, perm[:other_k])
    oob_idx = rest.index_select(0, perm[other_k:])
    bag_idx = torch.cat([top_idx, other_idx])
    amp = torch.ones(n, dtype=torch.float32, device=g.device) \
        .index_fill_(0, other_idx, float(multiply))
    w = torch.zeros(n, dtype=torch.float32, device=g.device) \
        .index_fill_(0, bag_idx, 1.0)
    return g * amp, h * amp, w, bag_idx, oob_idx


def grow_tree_compact_core(data: torch.Tensor, spare: torch.Tensor,
                           base_mask: torch.Tensor, meta: dict,
                           *, c_cols: int, item_bits: int, num_leaves: int,
                           col_bins: int, max_depth: int, l1: float,
                           l2: float, max_delta_step: float,
                           min_data_in_leaf: int, min_sum_hessian: float,
                           min_gain_to_split: float,
                           quant: Optional[QuantRows] = None,
                           stats: Optional[GrowStats] = None,
                           cat_statics=None, rng_key=None,
                           bynode_k: int = 0, pool_slots: int = 0):
    """Grow one tree over the packed working buffer `data` -- codes | gh
    section | row id, int32 -- with `spare` the second buffer of the same
    shape. Both are overwritten. The gh section is three bitcast f32 words
    (grad, hess, weight), or with `quant` one packed (qg|qh) word; then
    the histograms and the pool are exact int32 (kernel K3), and under
    leaf re-quantization each split's operand is re-discretized at the
    split leaf's ratio and the parent's pool entry rescaled to it.
    cat_statics (DeviceTreeLearner._statics) turns on categorical splits.
    bynode_k > 0 samples bynode_k features per node from the tree's key
    rng_key (node_masks, on the JAX key chain: tree_keys, then one split
    per split). pool_slots > 0 (plan_histogram_pool) caps the pool at
    pool_size(L, pool_slots) slots with LRU eviction, the JAX core's: a
    leaf keeps its parent's slot when it is cached; else (a miss) it takes
    a free slot or the least recently used one, and the sibling is built
    directly over the larger child's rows instead of parent - smaller.

    Returns (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k), and
    with cat_statics the records' (L-1, W) int32 left-bin bitsets after
    them."""
    n, d_cols = data.shape
    cw = d_cols - (2 if quant is not None else 4)
    L = num_leaves
    dev = data.device
    scan, best_row = _tree_helpers(
        meta["t_numbins"], meta["t_missing"], meta["t_default"],
        meta["t_monotone"], meta["t_penalty"], meta["t_elide"],
        meta["t_hist_idx"], max_depth=max_depth, l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split,
        f_categorical=meta["t_categorical"], cat_statics=cat_statics)
    search2 = search2_simple(scan, best_row)
    bufs = (data, spare)
    renew = quant is not None and quant.root_max is not None
    one = torch.ones((), dtype=torch.float32, device=dev)
    root_mask = base_mask
    if bynode_k > 0:
        root_key, key = tree_keys(rng_key, quant is not None, dev)
        root_mask = node_masks(root_key, base_mask, bynode_k)
    else:
        key = None
    K = pool_size(L, pool_slots)
    pooled = K < L

    def win_hist(rows: torch.Tensor, r) -> torch.Tensor:
        """K1 (float) or K3 (at ratios r) over a contiguous row slice,
        whose codes are read in place (4-bit codes unpacked for K1)."""
        if quant is None:
            return build_histogram(packed_codes(rows, cw, c_cols, item_bits),
                                   rows.view(torch.float32)[:, cw:cw + 3],
                                   col_bins)
        # K3 re-quantizes every row's stored (qg|qh) word to the leaf's
        # ratios itself (every row of a port window is valid)
        return build_histogram_quantized_rows(
            rows, cw, c_cols, item_bits, r[0], r[1], quant.qcap_op,
            quant.bits, col_bins)

    def for_scan(h: torch.Tensor, r) -> torch.Tensor:
        """The f32 histogram the split scan reads: the int32 one
        dequantized at the scales s * r."""
        if quant is None:
            return h
        return h.float() * quant_ops.dequant_scale3(quant.s_g * r[0],
                                                    quant.s_h * r[1])

    def ratios(leaf_max_q):
        if not renew:
            return one, one
        return (quant_ops.requant_ratio(leaf_max_q[0], quant.qcap_op),
                quant_ops.requant_ratio(leaf_max_q[1], quant.qcap_op))

    # ---- root ------------------------------------------------------------
    r0 = ratios(quant.root_max if renew else None)
    hist0 = win_hist(data, r0)
    totals = for_scan(hist0[0].sum(dim=0), r0)   # (3,): sum_g, sum_h, cnt
    leaf_min = torch.full((L,), -np.inf, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L,), np.inf, dtype=torch.float32, device=dev)
    res0, cm0 = scan(for_scan(hist0, r0)[None], totals[0:1], totals[1:2],
                     totals[2:3], leaf_min[:1], leaf_max[:1], root_mask)
    best = torch.full((L, 12), NEG_INF, dtype=torch.float32, device=dev)
    best[:, B_FEAT:] = 0.0
    best[0] = best_row(res0, 0)[0]
    best_cat, rec_cat = _carry_cat(L, 0 if cm0 is None else cm0.shape[1],
                                   dev)
    if best_cat is not None:
        best_cat[0] = cm0[0]
    # the pool keeps the histograms' dtype: on the quantized path parent -
    # child below is exact integer arithmetic
    pool = torch.zeros((K,) + tuple(hist0.shape), dtype=hist0.dtype,
                       device=dev)
    pool[0] = hist0
    # LRU bookkeeping (the JAX _CarryC's): each leaf's slot (-1: evicted),
    # each slot's leaf (-1: free) and the step that last wrote it
    slot_of, slot_owner, slot_last = [-1] * L, [-1] * K, [0] * K
    slot_of[0] = slot_owner[0] = 0

    def alloc(forbid: int) -> int:
        """A free slot first, else the least recently used one, never
        `forbid`; its old leaf loses it."""
        score = [-1 if slot_owner[i] < 0 else slot_last[i]
                 for i in range(K)]
        if forbid >= 0:
            score[forbid] = 2**31 - 1
        s_new = int(np.argmin(score))
        if slot_owner[s_new] >= 0:
            slot_of[slot_owner[s_new]] = -1
        return s_new
    if renew:
        # per leaf: the ratio its pool entry was built at, and the max
        # |stored int| over its rows (seeds the ratio of its own split)
        scale_of = torch.ones((L, 2), dtype=torch.float32, device=dev)
        scale_of[0] = torch.stack(r0)
        leafmax = torch.zeros((L, 2), dtype=torch.float32, device=dev)
        leafmax[0] = quant.root_max
    rec = np.zeros((L - 1, 13), dtype=np.float32)
    depth = [0] * L
    leaf_begin = [0] * L
    leaf_phys = [0] * L
    leaf_phys[0] = n
    leaf_buf = [0] * L                   # which buffer holds the leaf's rows
    pos_leaf = torch.zeros(n, dtype=torch.int64, device=dev)
    in_spare = torch.zeros(n, dtype=torch.bool, device=dev)

    k = 0
    while k < L - 1:
        nxt = _next_split(best, stats)
        if nxt is None:
            break
        l, row, row_dev = nxt
        new_id = k + 1
        feat = int(row[B_FEAT])
        begin, pcount, src = leaf_begin[l], leaf_phys[l], leaf_buf[l]
        dst = 1 - src
        win = bufs[src][begin:begin + pcount]
        go_left = packed_go_left(
            win, feat, int(row[B_THR]), bool(row[B_DLEFT] > 0.5), meta,
            item_bits=item_bits,
            words=None if best_cat is None else best_cat[l])
        rq = ratios(leafmax[l] if renew else None)
        if renew:
            # each child's max |stored int|, which seeds its ratio
            qmax2 = kkey.side_maxes(win, go_left, cw).float().view(2, 2)
        key3 = (~go_left).to(torch.int32)             # 0 = left, 1 = right
        out = partition_window(win, key3, bufs[dst][begin:begin + pcount])
        # all-ones weights: below 2**24 rows the record's f32 count is
        # exact and IS the physical count; above, count the window
        if n < (1 << 24):
            lphys = int(round(float(row[B_LCNT])))
        else:
            lphys = int(go_left.sum())
            if stats is not None:
                stats.host_syncs += 1
        rphys = pcount - lphys

        left_small = row[B_LCNT] <= row[B_RCNT]
        s_off, s_count = (0, lphys) if left_small else (lphys, rphys)
        hist_small = win_hist(out[s_off:s_off + s_count], rq)
        slot_l = slot_of[l] if pooled else l
        if slot_l >= 0:
            parent = pool[slot_l]
            if renew:
                # re-express the parent in the split's ratio before the
                # subtraction (counts pass through exact)
                parent = quant_ops.rescale_histogram(
                    parent, rq[0] / scale_of[l, 0], rq[1] / scale_of[l, 1])
            sibling = subtract_histogram(parent, hist_small)
        else:
            # a miss: the larger child's histogram, built directly
            o_off, o_count = (lphys, rphys) if left_small else (0, lphys)
            sibling = win_hist(out[o_off:o_off + o_count], rq)
            if stats is not None:
                stats.pool_misses += 1
        hist_l, hist_r = ((hist_small, sibling) if left_small
                          else (sibling, hist_small))
        if pooled:
            if slot_l < 0:
                slot_l = alloc(-1)
            slot_of[l], slot_owner[slot_l], slot_last[slot_l] = \
                slot_l, l, new_id
            s_r = alloc(slot_l)
            slot_of[new_id], slot_owner[s_r], slot_last[s_r] = \
                s_r, new_id, new_id
        else:
            s_r = new_id
        pool[slot_l] = hist_l
        pool[s_r] = hist_r

        key = split_epilogue(
            k=k, l=l, new_id=new_id, row=row, row_dev=row_dev,
            mono_f=int(meta["f_monotone"][feat]), leaf_min=leaf_min,
            leaf_max=leaf_max, depth=depth, rec=rec, best=best,
            hist_l=for_scan(hist_l, rq), hist_r=for_scan(hist_r, rq),
            fmask=base_mask, search2=search2, best_cat=best_cat,
            rec_cat=rec_cat, key=key, bynode_k=bynode_k)
        if renew:
            scale_of[l] = scale_of[new_id] = torch.stack(rq)
            leafmax[l], leafmax[new_id] = qmax2[0], qmax2[1]
        leaf_begin[new_id] = begin + lphys
        leaf_phys[l], leaf_phys[new_id] = lphys, rphys
        leaf_buf[l] = leaf_buf[new_id] = dst
        pos_leaf[begin + lphys:begin + pcount] = new_id
        in_spare[begin:begin + pcount] = dst == 1
        k += 1
    if stats is not None:
        stats.splits += k

    # final row -> leaf map: scatter position leaves onto row ids
    row_ids = torch.where(in_spare, spare[:, d_cols - 1],
                          data[:, d_cols - 1]).long()
    leaf_id = torch.empty(n, dtype=torch.int64, device=dev)
    leaf_id[row_ids] = pos_leaf
    if rec_cat is None:
        return rec, leaf_id, k
    return rec, leaf_id, k, rec_cat.cpu().numpy()


def _get(t: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """t[i] for a (1,) int64 device index, without a host sync (indexing
    with a 0-d tensor reads it on the host)."""
    return t.index_select(0, i1)[0]


def _put(t: torch.Tensor, i1: torch.Tensor, v: torch.Tensor,
         go: torch.Tensor) -> None:
    """t[i] = v where go, else unchanged: the gated write of the step."""
    t.index_copy_(0, i1, torch.where(go, v, _get(t, i1))[None])


def split_epilogue_device(c, *, l1, new1, k1, go, row, mono_f, hist_l,
                          hist_r, search2, words_l=None,
                          bynode_k: int = 0) -> None:
    """The split bookkeeping of every device loop (the JAX split_epilogue,
    which serves every core), over a carry `c` with leaf_min, leaf_max,
    depth, rec, best and base_mask (and best_cat, rec_cat): the monotone
    bounds (basic mode), the children's depth, the split record (and
    words_l, the leaf's (W,) left-bin bitset, as its rec_cat row) and the
    two children's re-scan from their f32 histograms hist_l, hist_r (and
    their bitsets into best_cat), each child on its own node_masks draw
    with by-node sampling (bynode_k > 0: the carry's (2,) int64 node_key
    split as in JAX, the first part kept). l1, new1, k1: (1,) int64 device
    indices of the leaf, its new sibling and the record; every write
    gated on the 0-d bool `go`; no host sync."""
    mid = (row[B_LOUT] + row[B_ROUT]) * 0.5
    pmin, pmax = _get(c.leaf_min, l1), _get(c.leaf_max, l1)
    lo_mid, hi_mid = torch.maximum(pmin, mid), torch.minimum(pmax, mid)
    lmin = torch.where(mono_f < 0, lo_mid, pmin)
    lmax = torch.where(mono_f > 0, hi_mid, pmax)
    rmin = torch.where(mono_f > 0, lo_mid, pmin)
    rmax = torch.where(mono_f < 0, hi_mid, pmax)
    mn2, mx2 = torch.stack([lmin, rmin]), torch.stack([lmax, rmax])
    _put(c.leaf_min, l1, lmin, go)
    _put(c.leaf_min, new1, rmin, go)
    _put(c.leaf_max, l1, lmax, go)
    _put(c.leaf_max, new1, rmax, go)
    child_depth = _get(c.depth, l1) + 1
    _put(c.depth, l1, child_depth, go)
    _put(c.depth, new1, child_depth, go)
    _put(c.rec, k1, torch.cat([
        torch.stack([l1[0].float(), row[B_FEAT], row[B_THR], row[B_DLEFT],
                     row[B_GAIN]]), row[B_LSG:]]), go)
    if words_l is not None:
        _put(c.rec_cat, k1, words_l, go)
    fmask = c.base_mask
    if bynode_k > 0:
        keys3 = trandom.split_on_device(c.node_key, 3)
        c.node_key.copy_(torch.where(go, keys3[0], c.node_key))
        fmask = node_masks(keys3[1:], fmask, bynode_k)
    rows2, words2 = search2(torch.stack([hist_l, hist_r]),
                            row[B_LSG::3][:2], row[B_LSH::3][:2],
                            row[B_LCNT::3][:2], mn2, mx2, fmask,
                            child_depth)
    _put(c.best, l1, rows2[0], go)
    _put(c.best, new1, rows2[1], go)
    if words_l is not None:
        _put(c.best_cat, l1, words2[0], go)
        _put(c.best_cat, new1, words2[1], go)


class DeviceCarry:
    """The compact core's state on the device, allocated once per learner
    at fixed addresses (a captured step replays against them): the JAX
    _CarryC.

    data, spare   the two (N, D) int32 working buffers; a leaf's rows lie
                  in one of them (leaf_buf), rows [leaf_begin, + leaf_phys)
    key           (N,) int32: the split window's key3 (split-key -> K4)
    desc          the split descriptor (ops/kernels/desc.py) with
                  cat_words bitset words; root_desc names all rows of
                  data, for the root's histogram
    k             0-d int32: splits made; best (L, 12), pool (K, C, B, 3),
                  depth, leaf_min / leaf_max, rec (L-1, 13) as in the core
    slot_of, slot_owner, slot_last
                  with an LRU-capped pool (K < L slots): each leaf's slot
                  (-1: evicted), each slot's leaf (-1: free) and the step
                  that last wrote it (int32, (L,), (K,), (K,)); misses
                  0-d int32 the tree's misses so far; miss_desc the
                  descriptor of the miss pass: the split's larger child
                  (LEFT_SMALL flipped), GO cleared on a hit
    node_key      (2,) int64 the by-node key chain (by-node sampling)
    base_mask     (F,) bool feature sample of the tree
    s_g, s_h      0-d f32 storage scales (quantized); scale_of / leafmax
                  (L, 2) per-leaf ratios and max |stored int| (renew)
    best_cat      (L, W) int32 left-bin bitset of each leaf's best split
                  (all clear for a numerical one), rec_cat (L-1, W) the
                  records'; None when cat_words W is 0 (the JAX best_cat /
                  rec_cat, bit-packed)
    """

    def __init__(self, n: int, d_cols: int, num_leaves: int, pool_shape,
                 pool_dtype: torch.dtype, num_features: int, device,
                 cat_words: int = 0, pool_slots: int = 0):
        L = num_leaves
        K = pool_size(L, pool_slots)
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.pooled = K < L
        if self.pooled:
            self.slot_of = torch.zeros(L, **i32)
            self.slot_owner = torch.zeros(K, **i32)
            self.slot_last = torch.zeros(K, **i32)
            self.misses = torch.zeros((), **i32)
            self.miss_desc = torch.zeros(dsc.SIZE, **i32)
            self.zero_rest = torch.zeros(dsc.SIZE - dsc.LEFT_SMALL - 1,
                                         **i32)
        self.node_key = torch.zeros(2, dtype=torch.int64, device=device)
        self.data = torch.zeros((n, d_cols), **i32)
        self.spare = torch.zeros((n, d_cols), **i32)
        self.key = torch.zeros(n, **i32)
        self.desc = torch.zeros(dsc.size(cat_words), **i32)
        self.root_desc = dsc.root(n, device)
        self.k = torch.zeros((), **i32)
        self.best = torch.zeros((L, 12), **f32)
        self.pool = torch.zeros((K,) + tuple(pool_shape), dtype=pool_dtype,
                                device=device)
        self.leaf_begin = torch.zeros(L, **i32)
        self.leaf_phys = torch.zeros(L, **i32)
        self.leaf_buf = torch.zeros(L, **i32)
        self.depth = torch.zeros(L, **i32)
        self.leaf_min = torch.zeros(L, **f32)
        self.leaf_max = torch.zeros(L, **f32)
        self.rec = torch.zeros((L - 1, 13), **f32)
        self.base_mask = torch.ones(num_features, dtype=torch.bool,
                                    device=device)
        self.s_g = torch.ones((), **f32)
        self.s_h = torch.ones((), **f32)
        self.scale_of = torch.ones((L, 2), **f32)
        self.leafmax = torch.zeros((L, 2), **f32)
        self.one = torch.ones((), **f32)
        self.zero1 = torch.zeros(1, **i32)
        # the descriptor's side maxes and the masked core's fields
        self.zero_tail = torch.zeros(dsc.CAT - dsc.SIDE_MAX, **i32)
        self.best_cat, self.rec_cat = _carry_cat(L, cat_words, device)


def _carry_cat(num_leaves: int, cat_words: int, device):
    """The (best_cat (L, W), rec_cat (L-1, W)) int32 bitset stores of a
    carry or a host loop, zeroed, or (None, None) when W is 0."""
    if not cat_words:
        return None, None
    return (torch.zeros((num_leaves, cat_words), dtype=torch.int32,
                        device=device),
            torch.zeros((num_leaves - 1, cat_words), dtype=torch.int32,
                        device=device))


def _desc_cat(c, f_categorical: Optional[torch.Tensor], feat1, words_l):
    """The descriptor's tail from CAT: the split feature's categorical
    flag and the leaf's W bitset words; a 0 flag alone without
    categorical features."""
    if words_l is None:
        return [c.zero1]
    return [f_categorical.index_select(0, feat1), words_l]


def split_step(c: DeviceCarry, *, meta_table: torch.Tensor,
               f_monotone: torch.Tensor, search2, c_cols: int,
               item_bits: int, col_bins: int, num_leaves: int,
               quant_bits: int = 0, qcap_op: int = 0,
               renew: bool = False,
               f_categorical: Optional[torch.Tensor] = None,
               bynode_k: int = 0, reduce_hist=None,
               reduce_max=None) -> None:
    """One split of the compact core over the device state `c`: the JAX
    core's body with its split_epilogue, at fixed shapes and with no host
    sync. reduce_hist (the data-parallel learner's): the cross-rank
    reduction of the smaller child's local histogram and of the miss
    pass, the JAX core's psum or psum_scatter under axis_name, called as
    reduce_hist(hist, leaf_count, qh_total) with the child's global count
    from the record and, quantized, its hessian sum in the split's integer
    units (what the scatter mode rebuilds the count lane from); None: one
    process. reduce_max (data-parallel, leaf re-quantization): the
    cross-rank max of the children's side maxes, the JAX pmax.
    quant_bits > 0: the quantized rows, operand cap qcap_op, leaf
    re-quantization when renew; the scales are the carry's. bynode_k > 0:
    by-node sampling on the carry's key. Every state write is gated on go
    = (best gain > 1e-10) & (k < L - 1), and the kernels return at once
    when the descriptor's GO is 0, so a step after the tree stopped
    changes nothing.

    With an LRU-capped pool (c.pooled) the parent's histogram may have
    been evicted, a branch the JAX core takes with lax.cond; a captured
    step cannot branch on the host, so the miss pass launches in every
    step: K1's or K3's window entry over the miss descriptor, the larger
    child's rows on a miss, GO 0 on a hit (returns at once; its output is
    not read). The sibling is then
    where(hit, parent - smaller, miss pass), and the slot bookkeeping is
    the JAX core's alloc over the carry's (L,) and (K,) tensors."""
    L = num_leaves
    d_cols = c.data.shape[1]
    cw = d_cols - (2 if quant_bits else 4)
    l1 = torch.argmax(c.best[:, B_GAIN]).view(1)
    row = _get(c.best, l1)
    k = c.k.long()
    go = (row[B_GAIN].double() > 1e-10) & (k < L - 1)
    # indices stay in range when the tree is full (gated writes there)
    new1 = torch.clamp(k + 1, max=L - 1).view(1)
    k1 = torch.clamp(k, max=L - 2).view(1)
    feat1 = torch.clamp(row[B_FEAT].long(), 0,
                        meta_table.shape[0] - 1).view(1)
    src = _get(c.leaf_buf, l1)
    begin = _get(c.leaf_begin, l1)
    pcount = _get(c.leaf_phys, l1)
    left_small = row[B_LCNT] <= row[B_RCNT]
    words_l = None if c.best_cat is None else _get(c.best_cat, l1)

    # the descriptor: the window and the decision; the left count and the
    # side maxes start at 0 for the split-key kernel to add into
    c.desc.copy_(torch.cat([
        torch.stack([go.int(), src, begin, pcount]), c.zero1,
        torch.stack([left_small.int(), row[B_THR].int(),
                     (row[B_DLEFT] > 0.5).int()]),
        _get(meta_table, feat1), c.zero_tail]
        + _desc_cat(c, f_categorical, feat1, words_l)))
    split_key(c.data, c.spare, c.desc, c.key, item_bits=item_bits, cw=cw,
              renew=renew)
    stable_partition3_window(c.data, c.spare, c.key, c.desc)
    if renew:
        lm = _get(c.leafmax, l1)
        rq = (quant_ops.requant_ratio(lm[0], qcap_op),
              quant_ops.requant_ratio(lm[1], qcap_op))
    else:
        rq = (c.one, c.one)

    def win_hist(desc):
        if quant_bits:
            return build_histogram_quantized_window(
                c.data, c.spare, desc, cw, c_cols, item_bits, rq[0], rq[1],
                qcap_op, quant_bits, col_bins)
        return build_histogram_window(c.data, c.spare, desc, cw, c_cols,
                                      item_bits, col_bins)

    hist_small = win_hist(c.desc)
    if reduce_hist is not None:
        s_cnt = torch.where(left_small, row[B_LCNT], row[B_RCNT])
        qh_unit = c.s_h * rq[1] if quant_bits else None
        s_qh = (torch.where(left_small, row[B_LSH], row[B_RSH]) * qh_unit
                if quant_bits else None)
        hist_small = reduce_hist(hist_small, s_cnt, s_qh)
    lphys = c.desc[dsc.LPHYS]
    rphys = pcount - lphys
    if c.pooled:
        slot_l = _get(c.slot_of, l1)
        hit = slot_l >= 0
        parent = _get(c.pool, slot_l.clamp(min=0).long().view(1))
        # the miss pass: the larger child (LEFT_SMALL flipped)
        c.miss_desc.copy_(torch.cat([
            torch.stack([(go & ~hit).int(), src, begin, pcount]),
            c.desc[dsc.LPHYS:dsc.LPHYS + 1],
            (~left_small).int().view(1), c.zero_rest]))
        hist_other = win_hist(c.miss_desc)
        if reduce_hist is not None:
            hist_other = reduce_hist(
                hist_other, row[B_LCNT] + row[B_RCNT] - s_cnt,
                (row[B_LSH] + row[B_RSH]) * qh_unit - s_qh
                if quant_bits else None)
    else:
        parent = _get(c.pool, l1)
    if renew:
        sc = _get(c.scale_of, l1)
        parent = quant_ops.rescale_histogram(parent, rq[0] / sc[0],
                                             rq[1] / sc[1])
    sibling = subtract_histogram(parent, hist_small)
    if c.pooled:
        sibling = torch.where(hit, sibling, hist_other)
    hist_l = torch.where(left_small, hist_small, sibling)
    hist_r = torch.where(left_small, sibling, hist_small)
    if c.pooled:
        s_l, s_r = _lru_slots(c, l1, new1, slot_l, hit, go, num_leaves)
    else:
        s_l, s_r = l1, new1
    _put(c.pool, s_l, hist_l, go)
    _put(c.pool, s_r, hist_r, go)
    if quant_bits:
        scale3 = quant_ops.dequant_scale3(c.s_g * rq[0], c.s_h * rq[1])
        hist_l, hist_r = hist_l.float() * scale3, hist_r.float() * scale3
    split_epilogue_device(c, l1=l1, new1=new1, k1=k1, go=go, row=row,
                          mono_f=_get(f_monotone, feat1), hist_l=hist_l,
                          hist_r=hist_r, search2=search2, words_l=words_l,
                          bynode_k=bynode_k)
    if renew:
        rq2 = torch.stack(rq)
        side = c.desc[dsc.SIDE_MAX:dsc.LEAF].float().view(2, 2)
        if reduce_max is not None:
            side = reduce_max(side)
        _put(c.scale_of, l1, rq2, go)
        _put(c.scale_of, new1, rq2, go)
        _put(c.leafmax, l1, side[0], go)
        _put(c.leafmax, new1, side[1], go)
    _put(c.leaf_begin, new1, begin + lphys, go)
    _put(c.leaf_phys, l1, lphys, go)
    _put(c.leaf_phys, new1, rphys, go)
    _put(c.leaf_buf, l1, 1 - src, go)
    _put(c.leaf_buf, new1, 1 - src, go)
    c.k.copy_(c.k + go.int())


def _lru_alloc(slot_of, owner, last, forbid, want, num_leaves: int):
    """The JAX core's alloc over (L,) / (K,) int32 tensors: a free slot
    first, else the least recently used (argmin's first), never `forbid`
    ((1,) int64 or None); where `want`, the old owner loses the slot.
    Returns ((1,) int64 slot, new slot_of)."""
    score = torch.where(owner < 0, -1, last)
    if forbid is not None:
        i_k = torch.arange(owner.shape[0], device=owner.device)
        score = torch.where(i_k == forbid, 2**31 - 1, score)
    s = torch.argmin(score).view(1)
    old = _get(owner, s)
    safe = old.clamp(0, num_leaves - 1).long().view(1)
    drop = want & (old >= 0)
    slot_of = slot_of.index_copy(
        0, safe, torch.where(drop, -1, _get(slot_of, safe)).view(1))
    return s, slot_of


def _lru_slots(c: DeviceCarry, l1, new1, slot_l, hit, go, num_leaves: int):
    """The split's pool slots, the JAX core's bookkeeping: the leaf keeps
    its parent's slot on a hit, else allocates; its new sibling always
    allocates (never the leaf's slot). Both stamped with the step k + 1.
    The carry's slot tensors and miss count are written where `go`.
    Returns the (1,) int64 slots (left, right)."""
    step = (c.k + 1).view(1)
    s_new, slot_of = _lru_alloc(c.slot_of, c.slot_owner, c.slot_last, None,
                                ~hit, num_leaves)
    s_l = torch.where(hit, slot_l.long(), s_new[0]).view(1)
    slot_of = slot_of.index_copy(0, l1, s_l.int())
    owner = c.slot_owner.index_copy(0, s_l, l1.int())
    last = c.slot_last.index_copy(0, s_l, step)
    s_r, slot_of = _lru_alloc(slot_of, owner, last, s_l, go, num_leaves)
    slot_of = slot_of.index_copy(0, new1, s_r.int())
    owner = owner.index_copy(0, s_r, new1.int())
    last = last.index_copy(0, s_r, step)
    for t, v in ((c.slot_of, slot_of), (c.slot_owner, owner),
                 (c.slot_last, last)):
        t.copy_(torch.where(go, v, t))
    c.misses.copy_(c.misses + (go & ~hit).int())
    return s_l, s_r


def leaf_map(c: DeviceCarry, n_total: Optional[int] = None,
             live: Optional[torch.Tensor] = None,
             base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_total,) int64 row -> leaf map of the grown tree, from the
    leaves' windows (begin, rows, buffer) with fixed-shape ops: each
    position's leaf and buffer in window order, then scattered onto the
    row ids of the final column (leaves not made have no rows). n_total
    (default: the carry's rows) is the row count of the ids; a bag
    carry's rows hold the original ids of the bag, and the entries of the
    rows outside it are left for the caller to write. With `live` (a
    (1,) int32 tensor) the tree grew on the buffer's first live rows
    alone: their leaves are written over `base`, the (n_total,) int64
    leaves of every row, and the positions past them write nothing."""
    n, d_cols = c.data.shape
    order = torch.argsort(c.leaf_begin, stable=True)
    rows = c.leaf_phys.index_select(0, order).long()
    bufs = c.leaf_buf.index_select(0, order)
    if live is not None:
        # the positions past the live rows: one more run, of no leaf
        order = torch.cat([order, order.new_zeros(1)])
        rows = torch.cat([rows, n - live.long().view(1)])
        bufs = torch.cat([bufs, bufs.new_zeros(1)])
    pos_leaf = torch.repeat_interleave(order, rows, output_size=n)
    pos_buf = torch.repeat_interleave(bufs, rows, output_size=n)
    row_ids = torch.where(pos_buf == 1, c.spare[:, d_cols - 1],
                          c.data[:, d_cols - 1]).long()
    size = n if n_total is None else n_total
    if live is None:
        return torch.empty(size, dtype=torch.int64,
                           device=c.data.device).scatter_(0, row_ids,
                                                          pos_leaf)
    # the dead positions scatter onto one slot past the end
    pos = torch.arange(n, device=c.data.device)
    row_ids = torch.where(pos < live.long(), row_ids, size)
    return torch.cat([base, base.new_zeros(1)]).scatter_(
        0, row_ids, pos_leaf)[:size]


def grow_tree_chunk_core(data: torch.Tensor, base_mask: torch.Tensor,
                         meta: dict, *, c_cols: int, item_bits: int,
                         num_leaves: int, col_bins: int, chunk_rows: int,
                         max_depth: int, l1: float, l2: float,
                         max_delta_step: float, min_data_in_leaf: int,
                         min_sum_hessian: float, min_gain_to_split: float,
                         fuse_hist: bool = True,
                         quant: Optional[QuantRows] = None,
                         stats: Optional[GrowStats] = None,
                         cat_statics=None, rng_key=None, bynode_k: int = 0,
                         data_prebuilt: bool = False):
    """Grow one tree with the chunk core (JAX ``grow_tree_chunk_core``,
    serial) over the working buffer `data` = data0: (N + CH, D) int32,
    packed codes | gh section | row id, the compact core's row layout
    (three bitcast f32 gh words, or with `quant` one (qg << 16 | qh)
    word), then CH = chunk_rows zero pad rows. It is overwritten, and a
    scratch buffer of its shape is made here. Every leaf's rows stay in
    `data`, rows [begin, begin + p); a split of a p-row leaf runs over
    ceil(p / CH) chunks of CH rows:

      pass B, for each chunk: its rows' sides (key 0 left, 1 right, 2 for
        the rows past the leaf's end), a stable three-way partition of the
        chunk (K4), its lefts merged forward into `data` at begin + lrun
        (exactly its lc rows, so later chunks' rows are kept) and its
        rights staged at the chunk's own place in the scratch buffer;
      pass C, for each chunk: its staged rights placed at begin + lphys +
        roff[i] (exactly its rcnt[i] rows), roff the exclusive scan of the
        chunks' right counts;
    and the smaller child's histogram is the f32 (float) or int32 sum of
    its per-chunk histograms, accumulated in the move passes (fuse_hist:
    chunk i's lefts in pass B, or its rights in pass C) or, fuse_hist off,
    in a pass of its own over the moved child in CH-row chunks. The
    sibling is parent - child (a dense pool, as in JAX). The row -> leaf
    map is the final position -> leaf map scattered over the row ids.

    The root's float histogram is one build over data0[:N], so a streamed
    buffer and a resident one give the same root bits; the quantized
    root, exact in int32, accumulates chunk-wise with data_prebuilt (the
    JAX streaming entry) and is one build otherwise. Leaf
    re-quantization, categorical splits and by-node sampling are the
    compact core's (grow_tree_compact_core). This host loop is the oracle
    the device loop of strategy=chunk (the compact core's) is held to.

    Returns (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k), and
    with cat_statics the records' (L-1, W) int32 left-bin bitsets after
    them."""
    CH = int(chunk_rows)
    n = data.shape[0] - CH
    d_cols = data.shape[1]
    cw = d_cols - (2 if quant is not None else 4)
    L = num_leaves
    dev = data.device
    scratch = torch.zeros_like(data)
    scan, best_row = _tree_helpers(
        meta["t_numbins"], meta["t_missing"], meta["t_default"],
        meta["t_monotone"], meta["t_penalty"], meta["t_elide"],
        meta["t_hist_idx"], max_depth=max_depth, l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split,
        f_categorical=meta["t_categorical"], cat_statics=cat_statics)
    search2 = search2_simple(scan, best_row)
    renew = quant is not None and quant.root_max is not None
    one = torch.ones((), dtype=torch.float32, device=dev)
    root_mask, key = base_mask, None
    if bynode_k > 0:
        root_key, key = tree_keys(rng_key, quant is not None, dev)
        root_mask = node_masks(root_key, base_mask, bynode_k)
    hist_dtype = torch.float32 if quant is None else torch.int32

    def ratios(leaf_max_q):
        if not renew:
            return one, one
        return (quant_ops.requant_ratio(leaf_max_q[0], quant.qcap_op),
                quant_ops.requant_ratio(leaf_max_q[1], quant.qcap_op))

    def chunk_hist(acc: torch.Tensor, rows: torch.Tensor, r) -> torch.Tensor:
        """acc plus the histogram of a contiguous row slice: K1 over its
        f32 gh words, or K3 over its words re-quantized at ratios r."""
        codes = packed_codes(rows, cw, c_cols, item_bits)
        if quant is None:
            gh = rows.view(torch.float32)[:, cw:cw + 3]
        else:
            gh = quant_ops.gh_operand_scaled(rows[:, cw], None, quant.bits,
                                             quant.qcap_op, r[0], r[1])
        return accumulate_histogram(acc, codes, gh, col_bins)

    def for_scan(h: torch.Tensor, r) -> torch.Tensor:
        if quant is None:
            return h
        return h.float() * quant_ops.dequant_scale3(quant.s_g * r[0],
                                                    quant.s_h * r[1])

    def zeros() -> torch.Tensor:
        return torch.zeros((c_cols, col_bins, 3), dtype=hist_dtype,
                           device=dev)

    # ---- root ------------------------------------------------------------
    r0 = ratios(quant.root_max if renew else None)
    if quant is not None and data_prebuilt:
        hist0 = zeros()
        for s in range(0, n, CH):
            hist0 = chunk_hist(hist0, data[s:min(n, s + CH)], r0)
    elif quant is not None:
        hist0 = build_histogram_quantized_rows(
            data[:n], cw, c_cols, item_bits, r0[0], r0[1], quant.qcap_op,
            quant.bits, col_bins)
    else:
        hist0 = build_histogram(packed_codes(data[:n], cw, c_cols, item_bits),
                                data[:n].view(torch.float32)[:, cw:cw + 3],
                                col_bins)
    totals = for_scan(hist0[0].sum(dim=0), r0)   # (3,): sum_g, sum_h, cnt
    leaf_min = torch.full((L,), -np.inf, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L,), np.inf, dtype=torch.float32, device=dev)
    res0, cm0 = scan(for_scan(hist0, r0)[None], totals[0:1], totals[1:2],
                     totals[2:3], leaf_min[:1], leaf_max[:1], root_mask)
    best = torch.full((L, 12), NEG_INF, dtype=torch.float32, device=dev)
    best[:, B_FEAT:] = 0.0
    best[0] = best_row(res0, 0)[0]
    best_cat, rec_cat = _carry_cat(L, 0 if cm0 is None else cm0.shape[1],
                                   dev)
    if best_cat is not None:
        best_cat[0] = cm0[0]
    pool = torch.zeros((L,) + tuple(hist0.shape), dtype=hist_dtype,
                       device=dev)
    pool[0] = hist0
    if renew:
        scale_of = torch.ones((L, 2), dtype=torch.float32, device=dev)
        scale_of[0] = torch.stack(r0)
        leafmax = torch.zeros((L, 2), dtype=torch.float32, device=dev)
        leafmax[0] = quant.root_max
    rec = np.zeros((L - 1, 13), dtype=np.float32)
    depth = [0] * L
    leaf_begin = [0] * L
    leaf_phys = [0] * L
    leaf_phys[0] = n
    pos_leaf = torch.zeros(n + CH, dtype=torch.int64, device=dev)

    k = 0
    while k < L - 1:
        nxt = _next_split(best, stats)
        if nxt is None:
            break
        l, row, row_dev = nxt
        new_id = k + 1
        feat = int(row[B_FEAT])
        begin, p = leaf_begin[l], leaf_phys[l]
        nch = -(-p // CH)
        words = None if best_cat is None else best_cat[l]
        rq = ratios(leafmax[l] if renew else None)
        left_small = bool(row[B_LCNT] <= row[B_RCNT])
        hist_small = zeros()
        qmax = torch.zeros(4, dtype=torch.int32, device=dev)

        # pass B: each chunk's lefts forward into data, rights staged
        lrun, rcnt = 0, []
        for i in range(nch):
            start = begin + i * CH
            vc = min(CH, p - i * CH)
            win = data[start:start + CH].clone()
            gl = packed_go_left(win[:vc], feat, int(row[B_THR]),
                                bool(row[B_DLEFT] > 0.5), meta,
                                item_bits=item_bits, words=words)
            if renew:
                qmax = torch.maximum(qmax, kkey.side_maxes(win[:vc], gl, cw))
            key3 = torch.full((CH,), 2, dtype=torch.int32, device=dev)
            key3[:vc] = (~gl).to(torch.int32)
            win_s = stable_partition3(win, key3)
            lc = int(gl.sum())
            if stats is not None:
                stats.host_syncs += 1
            data[begin + lrun:begin + lrun + lc] = win_s[:lc]
            scratch[start:start + vc - lc] = win_s[lc:vc]
            if fuse_hist and left_small:
                hist_small = chunk_hist(hist_small, win_s[:lc], rq)
            lrun += lc
            rcnt.append(vc - lc)
        lphys = lrun
        rphys = p - lphys

        # pass C: the staged rights after the left block
        roff = 0
        for i in range(nch):
            seg = scratch[begin + i * CH:begin + i * CH + rcnt[i]]
            data[begin + lphys + roff:begin + lphys + roff + rcnt[i]] = seg
            if fuse_hist and not left_small:
                hist_small = chunk_hist(hist_small, seg, rq)
            roff += rcnt[i]
        if not fuse_hist:
            # the smaller child over its moved rows, CH rows at a time
            sb, sc = (begin, lphys) if left_small else (begin + lphys, rphys)
            for s in range(0, sc, CH):
                hist_small = chunk_hist(
                    hist_small, data[sb + s:sb + min(sc, s + CH)], rq)

        parent = pool[l]
        if renew:
            parent = quant_ops.rescale_histogram(
                parent, rq[0] / scale_of[l, 0], rq[1] / scale_of[l, 1])
        sibling = subtract_histogram(parent, hist_small)
        hist_l, hist_r = ((hist_small, sibling) if left_small
                          else (sibling, hist_small))
        pool[l] = hist_l
        pool[new_id] = hist_r
        key = split_epilogue(
            k=k, l=l, new_id=new_id, row=row, row_dev=row_dev,
            mono_f=int(meta["f_monotone"][feat]), leaf_min=leaf_min,
            leaf_max=leaf_max, depth=depth, rec=rec, best=best,
            hist_l=for_scan(hist_l, rq), hist_r=for_scan(hist_r, rq),
            fmask=base_mask, search2=search2, best_cat=best_cat,
            rec_cat=rec_cat, key=key, bynode_k=bynode_k)
        if renew:
            scale_of[l] = scale_of[new_id] = torch.stack(rq)
            side = qmax.float().view(2, 2)
            leafmax[l], leafmax[new_id] = side[0], side[1]
        leaf_begin[new_id] = begin + lphys
        leaf_phys[l], leaf_phys[new_id] = lphys, rphys
        pos_leaf[begin + lphys:begin + p] = new_id
        k += 1
    if stats is not None:
        stats.splits += k

    leaf_id = torch.empty(n, dtype=torch.int64, device=dev)
    leaf_id[data[:n, d_cols - 1].long()] = pos_leaf[:n]
    if rec_cat is None:
        return rec, leaf_id, k
    return rec, leaf_id, k, rec_cat.cpu().numpy()


def grow_tree(codes_t: torch.Tensor, gh: torch.Tensor,
              base_mask: torch.Tensor, meta: dict, *, num_leaves: int,
              col_bins: int, max_depth: int, l1: float, l2: float,
              max_delta_step: float, min_data_in_leaf: int,
              min_sum_hessian: float, min_gain_to_split: float,
              scale3: Optional[torch.Tensor] = None,
              stats: Optional[GrowStats] = None, cat_statics=None,
              rng_key=None, bynode_k: int = 0, pool_slots: int = 0):
    """Grow one tree with the masked strategy over column-major codes
    `codes_t` (C, N) and the (N, 3) histogram operand `gh`: f32 [grad,
    hess, 1] (kernel K2), or with `scale3` the integer [qg, qh, 1]
    (kernel K3t; the pool is exact int32 and the scan reads it times the
    tree's fixed dequantization scales `scale3`). Each split rewrites the
    device row -> leaf map and builds the left child's histogram over all
    rows, the others' operand zeroed; the right child is parent - left.
    cat_statics (DeviceTreeLearner._statics) turns on categorical splits,
    bynode_k > 0 by-node sampling from the tree's key rng_key (as
    grow_tree_compact_core's). The masked core's pool is dense whatever
    pool_slots says (the JAX grow_tree's).

    Returns (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k), and
    with cat_statics the records' (L-1, W) int32 left-bin bitsets after
    them."""
    n = codes_t.shape[1]
    L = num_leaves
    dev = codes_t.device
    hist_fn = build_histogram_t if scale3 is None \
        else build_histogram_quantized_t

    def for_scan(h: torch.Tensor) -> torch.Tensor:
        return h if scale3 is None else h.float() * scale3

    scan, best_row = _tree_helpers(
        meta["t_numbins"], meta["t_missing"], meta["t_default"],
        meta["t_monotone"], meta["t_penalty"], meta["t_elide"],
        meta["t_hist_idx"], max_depth=max_depth, l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split,
        f_categorical=meta["t_categorical"], cat_statics=cat_statics)
    search2 = search2_simple(scan, best_row)

    # ---- root ------------------------------------------------------------
    hist0 = hist_fn(codes_t, gh, col_bins)
    totals = for_scan(hist0[0].sum(dim=0))        # (3,): sum_g, sum_h, cnt
    leaf_min = torch.full((L,), -np.inf, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L,), np.inf, dtype=torch.float32, device=dev)
    root_mask, key = base_mask, None
    if bynode_k > 0:
        root_key, key = tree_keys(rng_key, scale3 is not None, dev)
        root_mask = node_masks(root_key, base_mask, bynode_k)
    res0, cm0 = scan(for_scan(hist0)[None], totals[0:1], totals[1:2],
                     totals[2:3], leaf_min[:1], leaf_max[:1], root_mask)
    best = torch.full((L, 12), NEG_INF, dtype=torch.float32, device=dev)
    best[:, B_FEAT:] = 0.0
    best[0] = best_row(res0, 0)[0]
    best_cat, rec_cat = _carry_cat(L, 0 if cm0 is None else cm0.shape[1],
                                   dev)
    if best_cat is not None:
        best_cat[0] = cm0[0]
    pool = torch.zeros((L,) + tuple(hist0.shape), dtype=hist0.dtype,
                       device=dev)
    pool[0] = hist0
    rec = np.zeros((L - 1, 13), dtype=np.float32)
    depth = [0] * L
    leaf_id = torch.zeros(n, dtype=torch.int64, device=dev)

    k = 0
    while k < L - 1:
        nxt = _next_split(best, stats)
        if nxt is None:
            break
        l, row, row_dev = nxt
        new_id = k + 1
        feat = int(row[B_FEAT])
        col = codes_t[int(meta["f_col"][feat])].long()
        if codes_t.dtype == torch.int16:
            col = col & 0xFFFF
        go_left = column_go_left(
            col, feat, int(row[B_THR]), bool(row[B_DLEFT] > 0.5), meta,
            None if best_cat is None else best_cat[l])
        parent = leaf_id == l
        leaf_id = torch.where(parent & ~go_left, new_id, leaf_id)
        ghl = gh * (parent & go_left)[:, None].to(gh.dtype)
        hist_l = hist_fn(codes_t, ghl, col_bins)
        hist_r = subtract_histogram(pool[l], hist_l)
        pool[l] = hist_l
        pool[new_id] = hist_r

        key = split_epilogue(
            k=k, l=l, new_id=new_id, row=row, row_dev=row_dev,
            mono_f=int(meta["f_monotone"][feat]), leaf_min=leaf_min,
            leaf_max=leaf_max, depth=depth, rec=rec, best=best,
            hist_l=for_scan(hist_l), hist_r=for_scan(hist_r),
            fmask=base_mask, search2=search2, best_cat=best_cat,
            rec_cat=rec_cat, key=key, bynode_k=bynode_k)
        k += 1
    if stats is not None:
        stats.splits += k
    if rec_cat is None:
        return rec, leaf_id, k
    return rec, leaf_id, k, rec_cat.cpu().numpy()


class MaskedCarry:
    """The masked core's state on the device, allocated once per learner
    at fixed addresses (the JAX _Carry).

    k             0-d int32: splits made
    leaf_id       (N,) int32 row -> leaf map, rewritten per split
    pool          (L, C, B, 3) f32 (float) or int32 (quantized) histograms
    depth, leaf_min, leaf_max, best (L, 12), rec (L-1, 13) as in the core
    desc          the split descriptor (ops/kernels/desc.py) with
                  cat_words bitset words
    best_cat, rec_cat  (L, W) and (L-1, W) int32 left-bin bitsets, None
                  when cat_words W is 0 (as DeviceCarry's)
    gh            (N, 3) the tree's histogram operand: f32 [grad, hess, 1]
                  or int8 / int32 [qg, qh, 1]
    ghl           (N, 3) the left child's operand, of gh's dtype
    base_mask     (F,) bool feature sample of the tree
    scale3        (3,) f32 the tree's dequantization scales (quantized;
                  the masked core keeps one ratio for the tree)
    node_key      (2,) int64 the by-node key chain (by-node sampling)
    """

    def __init__(self, n: int, num_leaves: int, pool_shape,
                 pool_dtype: torch.dtype, gh_dtype: torch.dtype,
                 num_features: int, device, cat_words: int = 0):
        L = num_leaves
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.k = torch.zeros((), **i32)
        self.leaf_id = torch.zeros(n, **i32)
        self.pool = torch.zeros((L,) + tuple(pool_shape), dtype=pool_dtype,
                                device=device)
        self.depth = torch.zeros(L, **i32)
        self.leaf_min = torch.zeros(L, **f32)
        self.leaf_max = torch.zeros(L, **f32)
        self.best = torch.zeros((L, 12), **f32)
        self.rec = torch.zeros((L - 1, 13), **f32)
        self.desc = torch.zeros(dsc.size(cat_words), **i32)
        self.gh = torch.zeros((n, 3), dtype=gh_dtype, device=device)
        self.ghl = torch.zeros((n, 3), dtype=gh_dtype, device=device)
        self.base_mask = torch.ones(num_features, dtype=torch.bool,
                                    device=device)
        self.scale3 = torch.ones(3, **f32)
        self.node_key = torch.zeros(2, dtype=torch.int64, device=device)
        self.zero5 = torch.zeros(5, **i32)
        self.zero4 = torch.zeros(4, **i32)
        self.zero1 = torch.zeros(1, **i32)
        self.best_cat, self.rec_cat = _carry_cat(L, cat_words, device)


def masked_split_step(c: MaskedCarry, codes_t: torch.Tensor, *,
                      meta_table: torch.Tensor, f_monotone: torch.Tensor,
                      search2, col_bins: int, num_leaves: int,
                      quant: bool,
                      f_categorical: Optional[torch.Tensor] = None,
                      bynode_k: int = 0) -> None:
    """One split of the masked core over the device state `c`: the JAX
    grow_tree body at fixed shapes and with no host sync. The split key's
    column entry rewrites the split leaf's row -> leaf map and writes the
    left child's operand, K2 (or K3t when quantized) builds the left
    child's histogram over all N rows, the right child is parent - left.
    Every state write is gated on go = (best gain > 1e-10) & (k < L - 1),
    and the split key returns at once when the descriptor's GO is 0 (K2 /
    K3t then sum a stale operand that nothing reads), so a step after the
    tree stopped changes nothing. bynode_k > 0: by-node sampling on the
    carry's key."""
    L = num_leaves
    l1 = torch.argmax(c.best[:, B_GAIN]).view(1)
    row = _get(c.best, l1)
    k = c.k.long()
    go = (row[B_GAIN].double() > 1e-10) & (k < L - 1)
    # indices stay in range when the tree is full (gated writes there)
    new1 = torch.clamp(k + 1, max=L - 1).view(1)
    k1 = torch.clamp(k, max=L - 2).view(1)
    feat1 = torch.clamp(row[B_FEAT].long(), 0,
                        meta_table.shape[0] - 1).view(1)
    words_l = None if c.best_cat is None else _get(c.best_cat, l1)

    # the descriptor: go, the decision, the leaf and the new id (the
    # window and side-max fields are the compact core's)
    c.desc.copy_(torch.cat([
        go.int().view(1), c.zero5,
        torch.stack([row[B_THR].int(), (row[B_DLEFT] > 0.5).int()]),
        _get(meta_table, feat1), c.zero4, l1.int(), new1.int()]
        + _desc_cat(c, f_categorical, feat1, words_l)))
    split_key_column(codes_t, c.desc, c.leaf_id, c.gh, c.ghl)
    if quant:
        hist_l = build_histogram_quantized_t(codes_t, c.ghl, col_bins)
    else:
        hist_l = build_histogram_t(codes_t, c.ghl, col_bins)
    hist_r = subtract_histogram(_get(c.pool, l1), hist_l)
    _put(c.pool, l1, hist_l, go)
    _put(c.pool, new1, hist_r, go)
    if quant:
        hist_l, hist_r = hist_l.float() * c.scale3, hist_r.float() * c.scale3
    split_epilogue_device(c, l1=l1, new1=new1, k1=k1, go=go, row=row,
                          mono_f=_get(f_monotone, feat1), hist_l=hist_l,
                          hist_r=hist_r, search2=search2, words_l=words_l,
                          bynode_k=bynode_k)
    c.k.copy_(c.k + go.int())


class DeviceTreeLearner:
    """Tree learner whose growth runs on `device` (the card, or the CPU
    through the kernels' plain versions)."""

    def __init__(self, config: Config, dataset: Dataset,
                 strategy: Optional[str] = None, device="cpu"):
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        requested = strategy or strategy_env()
        self.strategy = resolve_strategy(config, dataset, strategy)
        if requested == "chunk" and self.strategy != "chunk":
            log.warning("chunk strategy needs the dense histogram pool; "
                        "using compact (LRU-capped) instead")
        # out of core: the packed rows stay on the host (io/stream.py) and
        # each tree's working buffer is assembled from streamed chunks
        self.stream_mode = str(getattr(config, "stream_mode", "off")
                               or "off")
        # the chunk core's rows per chunk (CH) and its fused histogram
        self.chunk_rows = chunk_rows_env()
        self.fuse_hist = chunk_fuse_hist_env()
        self._shard: Optional[DeviceDataShard] = None
        self._stream_top_hint: Optional[np.ndarray] = None
        # an LRU-capped pool (compact core) when the dense one would pass
        # the histogram_pool_size budget
        _, self.pool_slots = plan_histogram_pool(config, dataset)
        dev = self.device
        nb, mt, db, cat, mono = dataset.feature_meta_arrays()
        self.num_features = dataset.num_features
        self.num_bins = int(dataset.max_num_bins)
        self.device_bins = padded_device_bins(self.num_bins)
        # categorical splits run in the split scan of every core (the JAX
        # merged mode); each split's left bins ride as W bitset words
        self.has_cat = bool(np.any(cat))
        self.cat_words = (self.device_bins + 31) // 32 if self.has_cat else 0
        bundle = dataset.bundle_arrays()
        if bundle is not None:
            host_codes, f_col, f_base, f_elide, hist_idx, col_bins = bundle
            self.col_device_bins = padded_device_bins(int(col_bins))
            # re-space flat indices for the padded column bin count; pad
            # slots hit the trailing zero entry of the flat column hist
            zero_slot = len(dataset.columns) * self.col_device_bins
            hi = np.asarray(hist_idx)
            raw_cb = int(col_bins)
            invalid = hi == (len(dataset.columns) * raw_cb)
            hi2 = np.where(invalid, zero_slot,
                           (hi // raw_cb) * self.col_device_bins
                           + hi % raw_cb)
            pad = self.device_bins - hi2.shape[1]
            if pad > 0:
                hi2 = np.concatenate(
                    [hi2, np.full((hi2.shape[0], pad), zero_slot)], axis=1)
        else:
            host_codes = dataset.binned
            f = self.num_features
            f_col = np.arange(f, dtype=np.int32)
            f_base = np.zeros(f, np.int32)
            f_elide = np.zeros(f, np.int32)
            self.col_device_bins = self.device_bins
            zero_slot = f * self.device_bins
            hi2 = (np.arange(f, dtype=np.int64)[:, None] * self.device_bins
                   + np.arange(self.device_bins)[None, :])
            hi2 = np.where(np.arange(self.device_bins)[None, :]
                           < nb[:, None], hi2, zero_slot)
        contri = config.feature_contri or []
        pen = np.array([contri[fr] if fr < len(contri) else 1.0
                        for fr in dataset.used_features], dtype=np.float32)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        # host copies drive the per-split window decode; device copies
        # feed the split scan
        self.meta = {
            "f_numbins": nb, "f_missing": mt, "f_default": db,
            "f_monotone": mono, "f_col": f_col, "f_base": f_base,
            "f_elide": f_elide, "f_categorical": cat,
            "t_categorical": t(cat, torch.int32),
            "t_numbins": t(nb, torch.int32), "t_missing": t(mt, torch.int32),
            "t_default": t(db, torch.int32),
            "t_monotone": t(mono, torch.int32),
            "t_penalty": t(pen, torch.float32),
            "t_elide": t(f_elide, torch.int32),
            "t_hist_idx": t(hi2, torch.int64),
            # the split descriptor's feature fields, per feature
            "t_feature_table": t(np.stack([f_col, f_base, f_elide, nb, mt,
                                           db], axis=1), torch.int32)}

        host_codes = np.asarray(host_codes)
        self.c_cols = host_codes.shape[1]
        # quantized-gradient training: grad_bits when on, else 0; renew =
        # the compact core's leaf-wise re-quantization
        self.quant_bits = config.quant_bits
        self.quant_renew = bool(config.quant_renew)
        self.codes_pack: Optional[torch.Tensor] = None
        self.codes_t: Optional[torch.Tensor] = None
        if self.strategy in ("compact", "chunk"):
            if dataset.columns:
                declared_bins = max(c.num_bins for c in dataset.columns)
            else:
                declared_bins = int(dataset.max_num_bins)
            if host_codes.dtype.itemsize == 2:
                self.item_bits = 16
            elif declared_bins <= 16:
                self.item_bits = 4
            else:
                self.item_bits = 8
            packed = self.pack_codes(host_codes)
            self.code_words = packed.shape[1]
            if self.stream_mode != "off":
                # no device copy of the rows: the host wire store and its
                # double-buffered chunk pipeline
                self._shard = DeviceDataShard(
                    packed, item_bits=self.item_bits, c_cols=self.c_cols,
                    chunk_rows=int(getattr(config, "stream_chunk_rows", 0)
                                   or 0),
                    core_chunk_rows=self.chunk_rows, device=dev)
            else:
                self.codes_pack = torch.from_numpy(
                    packed.view(np.int32)).to(dev)
            self._row_ids = torch.arange(dataset.num_data, dtype=torch.int32,
                                         device=dev)
        else:
            # the masked strategy's (C, N) column view; 16-bit codes ride
            # as int16 and are read as uint16
            self.item_bits = 8
            ct = np.ascontiguousarray(host_codes.T)
            if ct.dtype == np.uint16:
                ct = ct.view(np.int16)
            self.codes_t = torch.from_numpy(ct).to(dev)
        self._ones_mask = torch.ones(self.num_features, dtype=torch.bool,
                                     device=dev)
        # the last tree's DeviceCarry or MaskedCarry and its SplitLoop; every
        # carry made, kept alive with its captured graph, by (rows, qcap_op)
        # on compact (all rows, and the bag), under "masked" on masked
        self._carry = None
        self._loop: Optional[SplitLoop] = None
        self._states = {}
        self._scan = None
        self.last_leaf_id: Optional[torch.Tensor] = None
        # train()'s bag (its row ids, sorted as the generic iteration's
        # samplers give them; None: every row) and the rows of each leaf
        # of its tree, grouped at the first leaf_rows call
        self._bag_rows: Optional[np.ndarray] = None
        self._leaf_rows = None
        # the (L-1, W) int32 left-bin bitsets of the last fetched tree's
        # records (fetch_tree), None without categorical features
        self.last_rec_cat: Optional[np.ndarray] = None
        self.stats = GrowStats()
        # streamed GOSS bags: rows taken from the pinned working set
        self.stream_ws_hits = 0

    def pack_codes(self, host_codes: np.ndarray) -> np.ndarray:
        """Bit-pack (N, C) column codes into u32 words for the compact
        working buffer (8 4-bit, 4 u8 or 2 u16 codes per word)."""
        nrow, ncol = host_codes.shape
        if self.item_bits == 4:
            npairs = ((ncol + 7) // 8) * 4          # byte pairs per row
            byte_arr = np.zeros((nrow, npairs * 2), dtype=np.uint8)
            byte_arr[:, :ncol] = host_codes
            packed_bytes = (byte_arr[:, 0::2]
                            | (byte_arr[:, 1::2] << 4)).astype(np.uint8)
            return np.ascontiguousarray(packed_bytes).view(np.uint32)
        per = 32 // self.item_bits
        padded = np.zeros((nrow, ((ncol + per - 1) // per) * per),
                          dtype=np.uint8 if self.item_bits == 8
                          else np.uint16)
        padded[:, :ncol] = host_codes
        return np.ascontiguousarray(padded).view(np.uint32)

    @staticmethod
    def supports(config: Config, dataset: Dataset,
                 strategy: Optional[str] = None) -> bool:
        """Whether this learner trains the configuration (the JAX
        package's capability check, which create_tree_learner reads): not
        with forced splits or CEGB penalties, nor when the pool -- K LRU
        slots on compact, one slot per leaf on masked -- passes 2 GB."""
        if config.forcedsplits_filename:
            return False
        if config.cegb_tradeoff > 0 and (
                config.cegb_penalty_split > 0
                or bool(config.cegb_penalty_feature_coupled)
                or bool(config.cegb_penalty_feature_lazy)):
            return False
        slot_bytes, pool_slots = plan_histogram_pool(config, dataset)
        strat = resolve_strategy(config, dataset, strategy)
        if strat == "compact" and pool_slots > 0:
            slots = pool_slots
        else:
            slots = int(config.num_leaves)
        return slots * slot_bytes <= _POOL_BYTE_LIMIT

    def _statics(self):
        cfg = self.config
        bynode_k = 0
        if 0.0 < cfg.feature_fraction_bynode < 1.0:
            bynode_k = max(1, int(self.num_features
                                  * cfg.feature_fraction_bynode))
        cat_statics = None
        if self.has_cat:
            cat_statics = (float(cfg.cat_l2), float(cfg.cat_smooth),
                           int(cfg.max_cat_threshold),
                           int(cfg.max_cat_to_onehot),
                           int(cfg.min_data_per_group))
        return dict(
            cat_statics=cat_statics,
            num_leaves=int(cfg.num_leaves), col_bins=self.col_device_bins,
            max_depth=int(cfg.max_depth), l1=float(cfg.lambda_l1),
            l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split),
            bynode_k=bynode_k,
            pool_slots=self.pool_slots if self.strategy == "compact" else 0)

    def _feature_mask(self, rng: np.random.RandomState) -> np.ndarray:
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if 0.0 < frac < 1.0:
            k = max(1, int(self.num_features * frac))
            chosen = rng.choice(self.num_features, k, replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def _rows_of(self, bag_idx: Optional[torch.Tensor]):
        """The working rows' packed codes and row ids: every row's, or
        those of the bag's rows, gathered in bag order (original ids).
        Streaming holds no codes on the device: None (the assembly
        streams them in)."""
        if bag_idx is None:
            return self.codes_pack, self._row_ids
        return (None if self.codes_pack is None
                else self.codes_pack.index_select(0, bag_idx),
                bag_idx.to(torch.int32))

    def working_buffer(self, grad: torch.Tensor, hess: torch.Tensor,
                       out: Optional[torch.Tensor] = None,
                       bag_idx: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """(R, CW + 4) int32: packed codes | bitcast f32 grad, hess,
        weight (all ones) | row id, written into `out` (a new tensor when
        None). R = N, or with `bag_idx` the bag's rows: the bag compacted,
        so that an out-of-bag row is no row of the tree (the JAX weighted
        layout's 0-weight rows add nothing to a histogram either)."""
        codes, ids = self._rows_of(bag_idx)
        if bag_idx is not None:
            grad, hess = grad.index_select(0, bag_idx), \
                hess.index_select(0, bag_idx)
        n, cw = ids.shape[0], self.code_words
        if out is None:
            out = torch.empty((n, cw + 4), dtype=torch.int32,
                              device=grad.device)
        if codes is not None:
            out[:, :cw] = codes
        f = out.view(torch.float32)
        f[:, cw] = grad
        f[:, cw + 1] = hess
        f[:, cw + 2] = 1.0
        out[:, cw + 3] = ids
        return out

    def quant_working_buffer(self, grad: torch.Tensor, hess: torch.Tensor,
                             key: torch.Tensor,
                             out: Optional[torch.Tensor] = None,
                             bag_idx: Optional[torch.Tensor] = None,
                             n_total: Optional[int] = None):
        """The compact core's quantized rows: (R, CW + 2) int32 -- packed
        codes | one (qg << 16 | qh) word | row id -- written into `out` (a
        new tensor when None), and their QuantRows. R = N, or with
        `bag_idx` the bag's rows (compacted). Where the quantization runs
        is the JAX package's: over the bag's gathered rows, the operand
        cap from R (n_total None: the fused iteration, whose grower gets
        the gathered bag), or over all n_total = N rows as grad * w, the
        out-of-bag rows at 0, before the gather, the cap from N (the
        generic iteration's host bag: the integers of the JAX weighted
        layout). Every working row counts, so no weight word (the JAX
        gw = 1 layout)."""
        codes, ids = self._rows_of(bag_idx)
        n, cw = ids.shape[0], self.code_words
        kw = dict(quant_bits=self.quant_bits, quant_renew=self.quant_renew)
        if bag_idx is not None and n_total is not None:
            w = torch.zeros_like(grad).index_fill_(0, bag_idx, 1.0)
            packed, s_g, s_h, root_max = _quant_prepare(
                grad * w, hess * w, key, **kw)
            packed = packed.index_select(0, bag_idx)
        else:
            if bag_idx is not None:
                grad, hess = grad.index_select(0, bag_idx), \
                    hess.index_select(0, bag_idx)
            packed, s_g, s_h, root_max = _quant_prepare(grad, hess, key, **kw)
        if out is None:
            out = torch.empty((n, cw + 2), dtype=torch.int32,
                              device=grad.device)
        if codes is not None:
            out[:, :cw] = codes
        out[:, cw] = packed
        out[:, cw + 1] = ids
        return out, QuantRows(self.quant_bits,
                              quant_ops.quant_max(self.quant_bits,
                                                  n_total or n),
                              s_g, s_h, root_max)

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_indices=None, iter_seed: int = 0) -> Tree:
        """One tree from (N,) gradients, on the rows `bag_indices` (host
        ints; None: every row), as the JAX package's train; the row ->
        leaf map of every row, bagged or not, in last_leaf_id."""
        rec, leaf_id, k = self.grow(grad, hess, iter_seed, bag_indices)
        telemetry.note_grow_dispatches(1.0, trees=1.0)
        self.stats.trees += 1
        self.last_leaf_id = leaf_id
        self._bag_rows = None if bag_indices is None \
            else np.asarray(bag_indices, dtype=np.int64)
        self._leaf_rows = None
        if k == 0:
            log.warning("No further splits with positive gain")
        with telem.phase("tree_replay"):
            return self.replay_tree(rec, k, self.last_rec_cat)

    def leaf_rows(self, leaf: int) -> np.ndarray:
        """The in-bag rows of a leaf of the last tree train() grew, in
        ascending order (leaf renewal; the JAX package's leaf_rows): every
        row without a bag, else the bag's rows (GOSS: its sampled rows).
        The first call after a tree fetches its leaf map once (one host
        sync, counted) and groups the rows by leaf."""
        if self._leaf_rows is None:
            leaf_id = self._leaf_id_host()
            self.stats.host_syncs += 1
            rows = np.arange(len(leaf_id)) if self._bag_rows is None \
                else self._bag_rows
            # 16-bit leaf ids sort by radix (a 1M-row tree's in ~20 ms)
            ids = leaf_id[rows].astype(
                np.int16 if self.config.num_leaves < 2**15 else np.int32)
            order = np.argsort(ids, kind="stable")
            bounds = np.searchsorted(ids[order],
                                     np.arange(int(self.config.num_leaves)
                                               + 1))
            self._leaf_rows = (rows[order], bounds)
        rows, bounds = self._leaf_rows
        return rows[bounds[leaf]:bounds[leaf + 1]]

    def _leaf_id_host(self) -> np.ndarray:
        """The last tree's row -> leaf map of every row, on the host."""
        return self.last_leaf_id.cpu().numpy()

    def _base_mask(self, iter_seed: int) -> torch.Tensor:
        """The tree's feature sample from the host RandomState, as in the
        JAX package's train (None: every feature)."""
        rng = np.random.RandomState(
            (self.config.feature_fraction_seed + iter_seed) % (2**31 - 1))
        mask = self._feature_mask(rng)
        return None if mask.all() else torch.as_tensor(mask,
                                                       device=self.device)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             iter_seed: int = 0, bag_indices=None):
        """Grow one tree on the learner's strategy, in its device loop,
        and fetch it: the feature sample from the host RandomState and the
        quantization key prng_key(iter_seed), as in the JAX package's
        train. A host bag (`bag_indices`, the generic iteration's) gives
        the JAX package's 0/1 weights: the compact strategy compacts the
        bag and routes the other rows by the records, its quantization
        over all N rows; the masked strategy weights its operand. Returns
        (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k)."""
        with telem.phase("grow_dispatch"):
            grad, hess = grad.float(), hess.float()
            n = self.dataset.num_data
            inbag = None
            if bag_indices is not None:
                inbag = np.zeros(n, dtype=bool)
                inbag[np.asarray(bag_indices, dtype=np.int64)] = True
            if self.strategy == "masked":
                w = None if inbag is None else torch.as_tensor(
                    inbag.astype(np.float32), device=grad.device)
                rec, leaf_id, k = self.grow_masked(grad, hess, iter_seed, w)
            elif inbag is None or inbag.all():
                rec, leaf_id, k = self.grow_compact(grad, hess, iter_seed)
            else:
                bag_idx, oob_idx = (torch.as_tensor(np.flatnonzero(m),
                                                    device=grad.device)
                                    for m in (inbag, ~inbag))
                rec, leaf_id, k = self.grow_compact(
                    grad, hess, iter_seed, bag_idx, oob_idx, n_total=n)
        with telem.phase("host_sync"):
            rec_h, k, _ = self.fetch_tree(rec, k)
        return rec_h, leaf_id, k

    def fetch_tree(self, rec: torch.Tensor, k: torch.Tensor, *flags):
        """The tree's one device->host copy: its records, k and any 0-d
        `flags`, packed into one tensor, with categorical features also
        the last grown carry's (L-1, W) record bitsets (bit-cast to f32,
        into last_rec_cat). Returns (rec (L-1, 13) f32 numpy, k, flags as
        floats); counts the sync, the splits, with an LRU-capped pool the
        tree's misses (fetched in the same copy) and, on the compact and
        chunk strategies, the rows K4's window entry moved (each split's
        window: its two children)."""
        pooled = getattr(self._carry, "pooled", False)
        if pooled:
            flags = flags + (self._carry.misses,)
        parts = [rec.reshape(-1), k.float().view(1)] \
            + [f.float().view(1) for f in flags]
        if self.cat_words:
            parts.append(self._carry.rec_cat.view(torch.float32).reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        self.stats.host_syncs += 1
        if telem_counters.is_active():
            telem_counters.incr("transfer_d2h_bytes", host.nbytes)
        m = rec.numel()
        rec_h = host[:m].reshape(rec.shape)
        if self.cat_words:
            self.last_rec_cat = host[m + 1 + len(flags):].view(np.int32) \
                .reshape(rec.shape[0], self.cat_words)
            host = host[:m + 1 + len(flags)]
        k = int(host[m])
        self.stats.splits += k
        if self.strategy in ("compact", "chunk"):
            kpart.rows_win += int(round(float(
                rec_h[:k, R_LCNT].sum(dtype=np.float64)
                + rec_h[:k, R_RCNT].sum(dtype=np.float64))))
        out = [float(v) for v in host[m + 1:]]
        if pooled:
            self.stats.pool_misses += int(out.pop())
        return rec_h, k, out

    def reset_config(self) -> None:
        """Drop what was made from the config's values, after a parameter
        reset: the split scan (its constants -- lambda_l1 / l2,
        min_data_in_leaf, min_gain_to_split and the rest -- are Python
        floats baked into it) and every carry with its split loop, whose
        captured step holds the scan and whose shapes hold num_leaves. The
        next tree makes and captures them anew. A graph freed while another
        is being captured breaks that capture, so the old graphs are freed
        (a collection for any held by a cycle) and the card synchronized
        here, between trees."""
        self._scan = None
        self._states = {}
        self._carry = self._loop = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the seams the data-parallel learner (parallel/learners.py)
    # overrides: one process's rows, its collectives, its capture --------
    def num_rows(self) -> int:
        """Working rows of an unbagged tree: every row of the dataset."""
        return self.dataset.num_data

    def pool_cols(self) -> int:
        """Columns of a pool entry: every column."""
        return self.c_cols

    def reduce_hist(self):
        """The cross-process reduction of a child's histogram in the split
        step: None (one process)."""
        return None

    def reduce_root(self, hist0: torch.Tensor):
        """(the root's histogram as the pool keeps it, its (3,) totals
        sum_g, sum_h, count, in the histogram's dtype: integer units on
        the quantized path)."""
        return hist0, hist0[0].sum(dim=0)

    def reduce_max(self):
        """The cross-process max of the split step's side maxes: None
        (one process)."""
        return None

    def step_counters(self) -> tuple:
        """(module, attribute) counters a captured step adds per replay
        beyond the kernels' launches."""
        return ()

    def capturable(self) -> bool:
        """Whether the split step is captured as a CUDA graph: on the
        card."""
        return self.device.type == "cuda"

    def _search(self):
        """The split scan of this learner's settings: (scan, best_row,
        search2), made once (until reset_config)."""
        if self._scan is None:
            st = self._statics()
            scan, best_row = _tree_helpers(
                self.meta["t_numbins"], self.meta["t_missing"],
                self.meta["t_default"], self.meta["t_monotone"],
                self.meta["t_penalty"], self.meta["t_elide"],
                self.meta["t_hist_idx"], max_depth=st["max_depth"],
                l1=st["l1"], l2=st["l2"],
                max_delta_step=st["max_delta_step"],
                min_data_in_leaf=st["min_data_in_leaf"],
                min_sum_hessian=st["min_sum_hessian"],
                min_gain_to_split=st["min_gain_to_split"],
                f_categorical=self.meta["t_categorical"],
                cat_statics=st["cat_statics"])
            self._scan = (scan, best_row, search2_simple(scan, best_row))
        return self._scan

    def _capture(self, key, c, step, counters):
        """The carry's SplitLoop over `step`, kept under `key`; on the
        card the step is captured while the carry is idle, k = L - 1. The
        step must not refer to the learner: the learner holds the loop,
        and a cycle would leave a dropped learner's graph to the cyclic
        collector. Every carry stays alive with its graph: a graph freed
        while another is captured breaks that capture."""
        L = int(self.config.num_leaves)
        loop = SplitLoop(step, L - 1, self.device, counters,
                         capture=self.capturable())
        if loop.capture_step:
            c.k.fill_(L - 1)
            loop.capture()
        self.stats.captures += 1
        self._states[key] = (c, loop)
        self._carry, self._loop = c, loop
        return c, loop

    def _device_state(self, rows: Optional[int] = None,
                      qcap_op: Optional[int] = None):
        """The compact core's DeviceCarry and its SplitLoop over `rows`
        working rows (default N; fewer for a bag) with the quantized
        operand cap qcap_op (default: from `rows`), made at its first
        tree. The cap is a constant of the captured step, so a bag of the
        fused iteration (cap from the bag) and a host bag of the same size
        (cap from N) have carries of their own."""
        st = self._statics()
        L = st["num_leaves"]
        n = self.num_rows() if rows is None else rows
        if not self.quant_bits:
            qcap_op = 0
        elif qcap_op is None:
            qcap_op = quant_ops.quant_max(self.quant_bits, n)
        hit = self._states.get((n, qcap_op))
        if hit is not None:
            self._carry, self._loop = hit
            return hit
        d_cols = self.code_words + (2 if self.quant_bits else 4)
        c = DeviceCarry(n, d_cols, L, (self.pool_cols(), st["col_bins"], 3),
                        torch.int32 if self.quant_bits else torch.float32,
                        self.num_features, self.device, self.cat_words,
                        st["pool_slots"])
        # the step holds no reference to the learner (see _capture)
        kw = dict(meta_table=self.meta["t_feature_table"],
                  f_monotone=self.meta["t_monotone"],
                  search2=self._search()[2], c_cols=self.c_cols,
                  item_bits=self.item_bits, col_bins=st["col_bins"],
                  num_leaves=L, quant_bits=self.quant_bits, qcap_op=qcap_op,
                  renew=bool(self.quant_bits) and self.quant_renew,
                  f_categorical=self.meta["t_categorical"],
                  bynode_k=st["bynode_k"], reduce_hist=self.reduce_hist(),
                  reduce_max=self.reduce_max())

        def step():
            split_step(c, **kw)

        return self._capture((n, qcap_op), c, step, (
            (kkey, "launches"), (kpart, "launches_win"),
            (khist, "launches_win"), (khist, "launches_qwin"))
            + self.step_counters())

    def _set_base_mask(self, c, iter_seed: int) -> None:
        mask = self._base_mask(iter_seed)
        if mask is None:
            c.base_mask.fill_(True)
        else:
            c.base_mask.copy_(mask)

    def _root(self, c, hist0, hist0_s, totals, iter_seed: int) -> None:
        """The root's best row and pool entry into the carry, and the
        state every tree starts from: with by-node sampling the root's
        draw and the carry's key chain from prng_key(iter_seed), with an
        LRU-capped pool the root in slot 0 and every other slot free."""
        search2 = self._search()[2]
        bynode_k = self._statics()["bynode_k"]
        root_mask = c.base_mask
        if bynode_k > 0:
            root_key, loop_key = tree_keys(trandom.prng_key(iter_seed),
                                           bool(self.quant_bits),
                                           self.device)
            c.node_key.copy_(loop_key)
            root_mask = node_masks(root_key, c.base_mask, bynode_k)
        c.leaf_min.fill_(-np.inf)
        c.leaf_max.fill_(np.inf)
        row0, cm0 = search2(hist0_s[None], totals[0:1], totals[1:2],
                            totals[2:3], c.leaf_min[:1], c.leaf_max[:1],
                            root_mask, 0)
        c.best.fill_(NEG_INF)
        c.best[:, B_FEAT:] = 0.0
        c.best[0] = row0[0]
        if c.best_cat is not None:
            c.best_cat.zero_()
            c.best_cat[0] = cm0[0]
            c.rec_cat.zero_()
        c.pool.zero_()
        c.pool[0] = hist0
        c.rec.zero_()
        c.k.zero_()
        c.depth.zero_()
        if getattr(c, "pooled", False):
            c.slot_of.fill_(-1)
            c.slot_of[:1].fill_(0)
            c.slot_owner.fill_(-1)
            c.slot_owner[:1].fill_(0)
            c.slot_last.zero_()
            c.misses.zero_()

    def grow_compact(self, grad: torch.Tensor, hess: torch.Tensor,
                     iter_seed: int = 0,
                     bag_idx: Optional[torch.Tensor] = None,
                     oob_idx: Optional[torch.Tensor] = None,
                     n_total: Optional[int] = None):
        """Grow one tree with the compact core on the device: the working
        rows, the root, the split loop and the row -> leaf map, with no
        host sync. With a bag (device row ids bag_idx, and oob_idx the
        others) the tree grows on the bag's rows alone, gathered into the
        bag's carry (the JAX package's bag compaction), and the router
        gives the out-of-bag rows their leaf from the records; n_total is
        where the quantization runs (quant_working_buffer: None, the
        gathered rows; N, every row before the gather). Streaming (the
        chunk strategy under stream_mode) writes the same buffer's codes
        from the host wire store (_stream_assemble) and routes the
        out-of-bag rows over rows streamed from it. Returns the carry's
        (L-1, 13) f32 records and 0-d int32 k (valid until the next tree)
        and the (N,) int64 leaf_id."""
        grad, hess = grad.float(), hess.float()
        rows = None if bag_idx is None else bag_idx.shape[0]
        qcap_op = None
        if self.quant_bits and rows is not None:
            qcap_op = quant_ops.quant_max(self.quant_bits, n_total or rows)
        c, loop = self._device_state(rows, qcap_op)
        self._set_base_mask(c, iter_seed)
        quant = None
        if self.quant_bits:
            _, quant = self.quant_working_buffer(
                grad, hess, trandom.prng_key(iter_seed), out=c.data,
                bag_idx=bag_idx, n_total=n_total)
        else:
            self.working_buffer(grad, hess, out=c.data, bag_idx=bag_idx)
        if self._shard is not None:
            self._stream_assemble(
                c, None if bag_idx is None else bag_idx.cpu().numpy())
        self._grow_tree(c, loop, quant, iter_seed)
        if bag_idx is None:
            leaf_id = leaf_map(c)
        else:
            leaf_id = leaf_map(c, self.dataset.num_data).index_copy_(
                0, oob_idx, self._route_oob(c, oob_idx).long())
        if self._shard is not None:
            self._shard.release_buffer("data0")
        return c.rec, leaf_id, c.k

    def _grow_tree(self, c, loop, quant: Optional[QuantRows],
                   iter_seed: int, live: Optional[torch.Tensor] = None
                   ) -> None:
        """The tree over the carry's filled working buffer: the root's
        histogram (K1's or K3's window entry over the root descriptor,
        reduce_root), the root's state, then the split loop. With `live`
        (a (1,) int32 tensor) the tree grows on the buffer's first live
        rows alone, the rest of it unread."""
        st = self._statics()
        cw = self.code_words
        if live is not None:
            for f in (dsc.COUNT, dsc.LPHYS):
                c.root_desc[f:f + 1].copy_(live)
        if quant is not None:
            c.s_g.copy_(quant.s_g)
            c.s_h.copy_(quant.s_h)
            renew = quant.root_max is not None
            r0 = ((quant_ops.requant_ratio(quant.root_max[0], quant.qcap_op),
                   quant_ops.requant_ratio(quant.root_max[1], quant.qcap_op))
                  if renew else (c.one, c.one))
            hist0, tot_q = self.reduce_root(build_histogram_quantized_window(
                c.data, c.spare, c.root_desc, cw, self.c_cols,
                self.item_bits, r0[0], r0[1], quant.qcap_op, quant.bits,
                st["col_bins"]))
            scale3 = quant_ops.dequant_scale3(c.s_g * r0[0], c.s_h * r0[1])
            hist0_s = hist0.float() * scale3
            totals = tot_q.float() * scale3
            c.scale_of.fill_(1.0)
            c.leafmax.zero_()
            if renew:
                c.scale_of[0] = torch.stack(r0)
                c.leafmax[0] = quant.root_max
        else:
            hist0, totals = self.reduce_root(build_histogram_window(
                c.data, c.spare, c.root_desc, cw, self.c_cols,
                self.item_bits, st["col_bins"]))
            hist0_s = hist0
        self._root(c, hist0, hist0_s, totals, iter_seed)
        c.leaf_begin.zero_()
        c.leaf_buf.zero_()
        c.leaf_phys.zero_()
        if live is None:
            # (a fill: `t[0] = n` on the card copies n from the host, a
            # sync)
            c.leaf_phys[:1].fill_(c.data.shape[0])
        else:
            c.leaf_phys[:1].copy_(live)
        loop.run()

    def chunk_host_loop(self, grad: torch.Tensor, hess: torch.Tensor,
                        iter_seed: int = 0):
        """The chunk core's host loop (grow_tree_chunk_core, the oracle)
        on this learner's rows and settings, every row, over a data0 of N +
        CH rows built as grow_compact builds its working buffer (its codes
        streamed from the wire store when streaming: the JAX streaming
        entry, data_prebuilt). Returns what grow_tree_chunk_core
        returns."""
        grad, hess = grad.float(), hess.float()
        n, CH = self.dataset.num_data, self.chunk_rows
        cw = self.code_words
        data0 = torch.zeros((n + CH, cw + (2 if self.quant_bits else 4)),
                            dtype=torch.int32, device=self.device)
        quant = None
        key = trandom.prng_key(iter_seed)
        if self.quant_bits:
            _, quant = self.quant_working_buffer(grad, hess, key,
                                                 out=data0[:n])
        else:
            self.working_buffer(grad, hess, out=data0[:n])
        if self._shard is not None:
            for s, cnt, chunk in self._shard.iter_chunks():
                data0[s:s + cnt, :cw].copy_(chunk)
        st = self._statics()
        del st["pool_slots"]
        mask = self._base_mask(iter_seed)
        return grow_tree_chunk_core(
            data0, self._ones_mask if mask is None else mask, self.meta,
            c_cols=self.c_cols, item_bits=self.item_bits,
            chunk_rows=CH, fuse_hist=self.fuse_hist, quant=quant,
            rng_key=key, data_prebuilt=self._shard is not None, **st)

    def _route_oob(self, c, oob_idx: torch.Tensor) -> torch.Tensor:
        """The out-of-bag rows' leaves from the carry's records (the
        router entry): over their resident codes, or, streaming, over
        their rows streamed from the wire store chunk by chunk."""
        kw = dict(item_bits=self.item_bits, rec_cat=c.rec_cat,
                  f_cat=self.meta["t_categorical"] if self.cat_words
                  else None)
        if self._shard is None:
            return route_rows(self.codes_pack.index_select(0, oob_idx),
                              c.rec, c.k, self.meta["t_feature_table"], **kw)
        return self._stream_full_leaf_id(c, oob_idx, **kw)

    # -- out-of-core streaming (io/stream.py) --------------------------
    def _stream_assemble(self, c, idx: Optional[np.ndarray]) -> None:
        """Write the code words of the carry's working buffer from the
        host wire store; its gh words and row ids are already there. Every row
        (no bag, stream_mode chunked, or GOSS's warm-up): the wire's
        chunks in order, pure data movement, so the tree is the resident
        one. A bag (sorted host row ids `idx`): the bag's rows, compacted;
        under stream_mode=goss the rows of the pinned working set are
        gathered on the device without a transfer and the rest stream,
        then the next working set (stream_note_top) is pinned from the
        assembled buffer before the tree reorders it."""
        shard = self._shard
        codes = c.data.narrow(1, 0, self.code_words)
        shard.track_buffer("data0", int(c.data.numel() * 4))
        if idx is None:
            for s, cnt, chunk in shard.iter_chunks():
                codes[s:s + cnt].copy_(chunk)
            return
        dev = c.data.device
        miss_pos = np.arange(idx.size, dtype=np.int64)
        ws_ids, ws_rows = shard.working_set()
        if ws_ids.size:
            hit = np.isin(idx, ws_ids.astype(np.int64), assume_unique=True)
            hit_pos = np.flatnonzero(hit)
            miss_pos = np.flatnonzero(~hit)
            if hit_pos.size:
                cache_pos = np.searchsorted(ws_ids, idx[hit_pos])
                codes.index_copy_(
                    0, torch.as_tensor(hit_pos, device=dev),
                    ws_rows.index_select(
                        0, torch.as_tensor(cache_pos, device=dev)))
            self.stream_ws_hits += int(hit_pos.size)
        if miss_pos.size:
            for s, cnt, chunk in shard.iter_chunks(row_ids=idx[miss_pos]):
                codes.index_copy_(
                    0, torch.as_tensor(miss_pos[s:s + cnt], device=dev),
                    chunk)
        self._stream_refresh_ws(c, idx)

    def _stream_refresh_ws(self, c, idx: np.ndarray) -> None:
        """Pin the booster's top-gradient hint as the next working set,
        its code rows gathered from the assembled buffer (no transfer)."""
        top, self._stream_top_hint = self._stream_top_hint, None
        if top is None or not top.size:
            return
        top = np.sort(np.asarray(top).astype(np.int64))
        top = top[np.isin(top, idx, assume_unique=True)]
        if not top.size:
            return
        pos = torch.as_tensor(np.searchsorted(idx, top),
                              device=c.data.device)
        self._shard.pin_working_set(
            top.astype(np.int32),
            c.data.narrow(1, 0, self.code_words).index_select(0, pos))

    def _stream_full_leaf_id(self, c, oob_idx: torch.Tensor,
                             **kw) -> torch.Tensor:
        """The out-of-bag rows' leaves of a streamed bag's tree: their
        rows stream from the wire store and the router maps each chunk
        from the records (the reference's out-of-bag
        AddPredictionToScore)."""
        oob = oob_idx.cpu().numpy()
        out = torch.empty(oob.size, dtype=torch.int32, device=c.data.device)
        for s, cnt, chunk in self._shard.iter_chunks(row_ids=oob):
            out[s:s + cnt] = route_rows(chunk, c.rec, c.k,
                                        self.meta["t_feature_table"], **kw)
        return out

    def stream_note_top(self, top_ids) -> None:
        """The booster's GOSS hook: the row ids of this iteration's top
        |g * h| rows (capped by goss_working_set), the working set to pin
        for the next. Nothing unless this learner streams."""
        if self._shard is None:
            return
        self._stream_top_hint = np.asarray(top_ids).astype(np.int64)

    def stream_state(self):
        """The streaming state to checkpoint (None when not streaming)."""
        if self._shard is None:
            return None
        return self._shard.stream_state()

    def load_stream_state(self, st) -> None:
        if self._shard is not None and st:
            self._shard.load_stream_state(st)

    def device_data_bytes(self) -> dict:
        """Device bytes of the row data this learner holds, the streamed
        against resident quantity (the JAX package's): streamed, the
        shard's high-water mark (the working buffer, the chunks in flight,
        the working set); resident, the code buffers plus, on the compact
        and chunk strategies, the working buffer of N rows that lives
        beside them while a tree grows. Both are O(N): streaming saves the
        resident codes (N x CW x 4 bytes) less the chunks in flight. The
        buffers both modes share (the spare buffer, the pool) are left
        out."""
        if self._shard is not None:
            return {"mode": "streamed",
                    "bytes": int(max(self._shard.peak_bytes,
                                     self._shard.live_bytes()))}
        total = sum(int(a.numel() * a.element_size())
                    for a in (self.codes_t, self.codes_pack)
                    if a is not None)
        if self.codes_pack is not None:
            total += self.dataset.num_data \
                * (self.code_words + (2 if self.quant_bits else 4)) * 4
        return {"mode": "resident", "bytes": int(total)}

    def masked_operand(self, grad: torch.Tensor, hess: torch.Tensor,
                       iter_seed: int = 0,
                       w: Optional[torch.Tensor] = None):
        """The masked core's (N, 3) histogram operand of one tree and its
        dequantization scales, under the (N,) 0/1 row weights w (None:
        all ones), as the JAX grow_tree builds it: f32 [grad * w, hess *
        w, w] and None, or, with quantized gradients (key
        prng_key(iter_seed), the tree's one ratio), grad * w and hess * w
        quantized, the integer [qg, qh, w > 0] and (3,) f32 scale3."""
        if w is None:
            w = torch.ones_like(grad)
        else:
            grad, hess = grad * w, hess * w
        if not self.quant_bits:
            return torch.stack([grad, hess, w], dim=1), None
        packed, s_g, s_h, _ = _quant_prepare(
            grad, hess, trandom.prng_key(iter_seed),
            quant_bits=self.quant_bits, quant_renew=False)
        gh = quant_ops.gh_operand(packed, w > 0, self.quant_bits)
        return gh, quant_ops.dequant_scale3(s_g, s_h)

    def _masked_state(self):
        """The masked core's MaskedCarry and its SplitLoop, made at the
        first tree."""
        if "masked" in self._states:
            self._carry, self._loop = self._states["masked"]
            return self._carry, self._loop
        st = self._statics()
        L, n = st["num_leaves"], self.dataset.num_data
        quant = bool(self.quant_bits)
        c = MaskedCarry(
            n, L, (self.c_cols, st["col_bins"], 3),
            torch.int32 if quant else torch.float32,
            quant_ops.operand_dtype(self.quant_bits) if quant
            else torch.float32, self.num_features, self.device,
            self.cat_words)
        # the step holds no reference to the learner (see _capture)
        codes_t = self.codes_t
        kw = dict(meta_table=self.meta["t_feature_table"],
                  f_monotone=self.meta["t_monotone"],
                  search2=self._search()[2], col_bins=st["col_bins"],
                  num_leaves=L, quant=quant,
                  f_categorical=self.meta["t_categorical"],
                  bynode_k=st["bynode_k"])

        def step():
            masked_split_step(c, codes_t, **kw)

        return self._capture("masked", c, step, (
            (kkey, "launches_col"), (khist, "launches_t"),
            (khist, "launches_qt")))

    def grow_masked(self, grad: torch.Tensor, hess: torch.Tensor,
                    iter_seed: int = 0, w: Optional[torch.Tensor] = None):
        """Grow one tree with the masked core on the device: the operand
        (under the 0/1 row weights w, None: all ones; an out-of-bag row
        carries a zero operand and is routed like every other row), the
        root (K2 / K3t over all rows), the split loop, with no host sync.
        Returns the carry's (L-1, 13) f32 records and 0-d int32 k (valid
        until the next tree) and the (N,) int64 leaf_id."""
        c, loop = self._masked_state()
        self._set_base_mask(c, iter_seed)
        gh, scale3 = self.masked_operand(grad.float(), hess.float(),
                                         iter_seed, w)
        c.gh.copy_(gh)
        col_bins = self.col_device_bins
        if scale3 is None:
            hist0 = hist0_s = build_histogram_t(self.codes_t, c.gh, col_bins)
            totals = hist0[0].sum(dim=0)          # (3,): sum_g, sum_h, cnt
        else:
            c.scale3.copy_(scale3)
            hist0 = build_histogram_quantized_t(self.codes_t, c.gh, col_bins)
            hist0_s = hist0.float() * c.scale3
            totals = hist0[0].sum(dim=0).float() * c.scale3
        self._root(c, hist0, hist0_s, totals, iter_seed)
        c.leaf_id.zero_()
        loop.run()
        return c.rec, c.leaf_id.long(), c.k

    def make_fused_step(self, objective, goss=None, bagging: bool = True):
        """One boosting iteration as one device program (the JAX package's
        DeviceTreeLearner.make_fused_step), on either strategy: gradients
        at score + init_score; the row sample; the tree in the strategy's
        device loop; its leaf values from the records and the score
        update, with no host sync.

        The sample: goss = (top_k, other_k, multiply) samples by GOSS
        (goss_sample); else, when `bagging` and bagging_freq > 0 and
        bagging_fraction < 1, bag_k = max(1, int(N * bagging_fraction))
        rows by exact_k_bag_weights (bagging=False: GOSS's warm-up, every
        row even under bagging settings). Both draw from prng_key of the
        step's bag seed. The compact strategy compacts a bag of fewer than
        N rows: its rows gathered in the JAX order (GOSS: top rows first;
        bagging: a stable sort of in-bag first) into the bag's carry, the
        other rows routed by the records; the masked strategy weights its
        operand, with GOSS's amplified gradients.

        Returns step(score_row, iter_seed, shrinkage, init_score,
        bag_seed) -> (new_score, rec, leaf_id, k, finite): the delta is 0
        when k == 0, and finite says every updated score is finite."""
        cfg = self.config
        n = self.dataset.num_data
        L = int(cfg.num_leaves)
        if goss is not None:
            top_k, other_k, multiply = goss
            bag_on, bag_k = True, min(n, top_k + other_k)
        elif not bagging:
            bag_on, bag_k = False, n
        else:
            bag_on = cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
            bag_k = max(1, int(n * cfg.bagging_fraction))
        compact = self.strategy in ("compact", "chunk")
        bag_compact = compact and bag_on and bag_k < n

        def step(score_row: torch.Tensor, iter_seed: int, shrinkage: float,
                 init_score: float = 0.0, bag_seed: int = 0):
            score = score_row + init_score
            grad, hess = objective.get_gradients(score)
            w = bag_idx = oob_idx = None
            if bag_on:
                # a host key: its words are read on the host (no sync)
                key = trandom.prng_key(bag_seed)
                if goss is not None:
                    grad, hess, w, bag_idx, oob_idx = goss_sample(
                        grad, hess, key, n, top_k, other_k, multiply)
                else:
                    w = exact_k_bag_weights(key, n, bag_k, grad.device)
            if bag_compact:
                if bag_idx is None:
                    order = torch.argsort((w <= 0).to(torch.int32),
                                          stable=True)
                    bag_idx, oob_idx = order[:bag_k], order[bag_k:]
                rec, leaf_id, k = self.grow_compact(grad, hess, iter_seed,
                                                    bag_idx, oob_idx)
            elif compact:
                # a bag of every row: all-ones weights
                rec, leaf_id, k = self.grow_compact(grad, hess, iter_seed)
            else:
                rec, leaf_id, k = self.grow_masked(grad, hess, iter_seed, w)
            lv = leaf_values_from_rec(rec, k, L)
            delta = lv.index_select(0, leaf_id) * shrinkage
            new_score = score + torch.where(k > 0, delta,
                                            torch.zeros_like(delta))
            return (new_score, rec, leaf_id, k,
                    torch.isfinite(new_score).all())
        return step

    def replay_tree(self, rec_h, k: int, rec_cat_h=None) -> Tree:
        """Materialize a host Tree from the (L-1, 13) split records (the
        JAX replay_tree). rec_cat_h holds the records' (L-1, W) int32
        left-bin bitsets; a record of a categorical feature replays as a
        bitset node: its inner bits are the mask's bins, its real bits
        their categories (bin_2_categorical; bins past it, the overflow
        and NaN bins, have no category)."""
        ds = self.dataset
        rec_h = np.asarray(rec_h)
        tree = Tree(self.config.num_leaves)
        for i in range(k):
            r = rec_h[i]
            inner_f = int(r[R_FEAT])
            real_f = ds.inner_to_real(inner_f)
            mapper = ds.bin_mappers[real_f]
            if mapper.bin_type == BIN_CATEGORICAL and rec_cat_h is not None:
                words = np.asarray(rec_cat_h[i]).astype(np.uint32)
                bins = [w * 32 + b for w in range(len(words))
                        for b in range(32) if (int(words[w]) >> b) & 1]
                cats = [mapper.bin_2_categorical[b] for b in bins
                        if b < len(mapper.bin_2_categorical)]
                tree.split_categorical(
                    int(r[R_LEAF]), inner_f, real_f,
                    [int(w) for w in _make_bitset(bins)],
                    [int(w) for w in _make_bitset(cats)],
                    float(r[R_LOUT]), float(r[R_ROUT]),
                    int(round(float(r[R_LCNT]))),
                    int(round(float(r[R_RCNT]))),
                    float(r[R_LSH]), float(r[R_RSH]),
                    float(r[R_GAIN]), mapper.missing_type)
                continue
            thr_bin = int(r[R_THR])
            tree.split(
                int(r[R_LEAF]), inner_f, real_f, thr_bin,
                ds.real_threshold(inner_f, thr_bin),
                float(r[R_LOUT]), float(r[R_ROUT]),
                int(round(float(r[R_LCNT]))),
                int(round(float(r[R_RCNT]))),
                float(r[R_LSH]), float(r[R_RSH]),
                float(r[R_GAIN]), mapper.missing_type,
                bool(r[R_DLEFT] > 0.5))
        return tree


def _make_bitset(values) -> np.ndarray:
    """uint32 bitset words with the given non-negative values set, as
    few words as the largest needs (one for none): the JAX package's
    serial_learner._make_bitset (Common::ConstructBitset)."""
    if not values:
        return np.zeros(1, dtype=np.uint32)
    out = np.zeros(max(values) // 32 + 1, dtype=np.uint32)
    for v in values:
        out[v // 32] |= np.uint32(1 << (v % 32))
    return out


__all__: List[str] = ["DeviceTreeLearner", "grow_tree",
                      "grow_tree_chunk_core", "grow_tree_compact_core",
                      "resolve_strategy",
                      "padded_device_bins"]
