"""Leaf-wise tree learner, in torch: the compact and the masked strategy.

Port of lightgbm_tpu/models/device_learner.py for the serial, dense-pool,
numerical-feature, all-ones-row-weight case of its two single-device
strategies, each with float or quantized gradients.

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

**Masked** (``grow_tree``, JAX :307), which ``auto`` picks below 65,536
rows. Codes stay column-major (C, N); the row -> leaf map ``leaf_id`` is
rewritten per split, and the left child's histogram is built over all N
rows with the others' gh zeroed (kernel K2, or K3t when quantized); the
right child is parent - left.

Quantized gradients (ops/quantize.py): the iteration's (grad, hess) are
rounded stochastically with the threefry port, so the integers, the
int32 histograms and the pool are the JAX package's bit for bit; the
scans read dequantized f32 copies. The compact core re-quantizes each
leaf's operand at a leaf-local ratio when ``quant_renew`` is on.

Deltas from the JAX cores: torch sizes are dynamic, so the window-size
ladder (``_size_classes``), the ``lax.switch`` over it and the padding of
the working buffer are gone -- every window is exactly the leaf. The price
is that each split reads the chosen leaf's best row on the host (one
device->host sync per split) to slice its window; split records are then
assembled on the host directly.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import Dataset
from ..ops import bundle as bundle_ops
from ..ops import quantize as quant_ops
from ..ops import split as split_ops
from ..ops.histogram import (build_histogram, build_histogram_quantized,
                             subtract_histogram)
from ..ops.kernels.histogram import (build_histogram_quantized_t,
                                     build_histogram_t)
from ..ops.kernels.partition import stable_partition3
from ..ops.partition import decide_left
from ..utils import log
from ..utils import random as trandom
from ..utils.envs import strategy_env
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
    """(slot_bytes, pool_slots) of the histogram pool, the JAX package's
    budget math; pool_slots == 0 means the dense one-slot-per-leaf pool
    fits. The port has only the dense pool."""
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
    """The growth strategy: `forced`, else LGBM_TPU_STRATEGY, else auto --
    compact at 65,536 rows and above, masked below (the JAX rule). The
    chunk strategy and the LRU-capped histogram pool are refused."""
    strat = forced or strategy_env()
    if strat == "auto":
        strat = "compact" if dataset.num_data >= 65536 else "masked"
    if strat not in ("compact", "masked"):
        raise LightGBMError("strategy=%s is not supported by this port yet "
                            "(compact and masked only)" % strat)
    slot_bytes, pool_slots = plan_histogram_pool(config, dataset)
    if pool_slots > 0 or slot_bytes * int(config.num_leaves) \
            > _POOL_BYTE_LIMIT:
        raise LightGBMError(
            "num_leaves=%d needs an LRU-capped histogram pool "
            "(histogram_pool_size), which this port does not have yet"
            % int(config.num_leaves))
    return strat


def _unpack_codes(words: torch.Tensor, c_cols: int,
                  item_bits: int) -> torch.Tensor:
    """(W, CW) int32 packed codes -> (W, c_cols) int32. int32 >> is
    arithmetic, so every field is masked after its shift."""
    per = 32 // item_bits
    shifts = torch.arange(per, device=words.device, dtype=torch.int32) \
        * item_bits
    u = (words[:, :, None] >> shifts) & ((1 << item_bits) - 1)
    return u.reshape(words.shape[0], words.shape[1] * per)[:, :c_cols]


def column_go_left(col: torch.Tensor, feat: int, thr: int, dleft: bool,
                   meta: dict) -> torch.Tensor:
    """The split decision over one column's raw codes: unmap feature
    `feat`'s logical bins (EFB) and compare. The feature's metadata are
    host arrays in `meta` (f_base, f_elide, f_numbins, f_missing,
    f_default)."""
    nb = int(meta["f_numbins"][feat])
    default = int(meta["f_default"][feat])
    fbins = bundle_ops.logical_bins_for_feature(
        col, int(meta["f_base"][feat]), default, nb,
        int(meta["f_elide"][feat]))
    return decide_left(fbins, thr, dleft, int(meta["f_missing"][feat]),
                       default, nb)


def packed_go_left(win: torch.Tensor, feat: int, thr: int, dleft: bool,
                   meta: dict, *, item_bits: int) -> torch.Tensor:
    """Decode feature `feat`'s codes from a packed int32 row window and
    apply the split decision."""
    per = 32 // item_bits
    col_i = int(meta["f_col"][feat])
    word, sub = col_i // per, col_i % per
    col = (win[:, word] >> (sub * item_bits)) & ((1 << item_bits) - 1)
    return column_go_left(col, feat, thr, dleft, meta)


def partition_window(win: torch.Tensor, key3: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Stable 3-way reorder of a (W, D) int32 window by key3 in {0,1,2}
    into `out` (reference DataPartition::Split) -- kernel K4."""
    return stable_partition3(win, key3, out)


def _tree_helpers(f_numbins, f_missing, f_default, f_monotone, f_penalty,
                  f_elide, hist_idx, *, max_depth, l1, l2, max_delta_step,
                  min_data_in_leaf, min_sum_hessian, min_gain_to_split):
    """The split search shared by the root and the children: expand the
    column histograms, scan, pick each leaf's best feature, format best
    rows (with depth gating)."""
    scan_kwargs = dict(
        l1=l1, l2=l2, max_delta_step=max_delta_step,
        min_data_in_leaf=min_data_in_leaf, min_sum_hessian=min_sum_hessian,
        min_gain_to_split=min_gain_to_split)

    def scan(col_hist, sg, sh, cnt, mn, mx, fmask):
        hist = bundle_ops.expand_column_hist(
            col_hist, torch.stack([sg, sh, cnt], dim=-1), hist_idx,
            f_elide, f_default)
        rel, t, use_m1, prefix = split_ops.per_feature_best(
            hist, sg, sh, cnt, f_numbins, f_missing, f_default, fmask,
            f_monotone, mn, mx, f_penalty, **scan_kwargs)
        feat = torch.argmax(rel, dim=1)
        return split_ops.materialize_split(
            feat, rel, t, use_m1, prefix, sg, sh, cnt, mn, mx,
            l1=l1, l2=l2, max_delta_step=max_delta_step)

    def best_row(res: split_ops.SplitResult, child_depth: int):
        gain = res.gain
        if max_depth > 0 and child_depth >= max_depth:
            gain = torch.full_like(gain, NEG_INF)
        return torch.stack([
            gain, res.feature.float(), res.threshold.float(),
            res.default_left.float(), res.left_sum_grad,
            res.left_sum_hess, res.left_count, res.right_sum_grad,
            res.right_sum_hess, res.right_count, res.left_output,
            res.right_output], dim=1)

    return scan, best_row


def search2_simple(scan, best_row):
    """Both children's scans in one batched pass -> (2, 12) best rows."""
    def search2(col_hist2, sg2, sh2, cnt2, mn2, mx2, fmask, child_depth):
        return best_row(scan(col_hist2, sg2, sh2, cnt2, mn2, mx2, fmask),
                        child_depth)
    return search2


def split_epilogue(*, k, l, new_id, row, row_dev, mono_f, leaf_min,
                   leaf_max, depth, rec, best, hist_l, hist_r, fmask,
                   search2):
    """The split bookkeeping of the JAX core's split_epilogue: monotone
    constraint propagation (basic mode, serial_tree_learner.cpp:771-852),
    depth update, the split record, and the two children's re-scan.
    `row` is the leaf's best row on the host, `row_dev` the same row on
    the device; leaf_min / leaf_max (L,) stay on the device, `depth` and
    `rec` on the host. Updates them in place."""
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

    rows2 = search2(torch.stack([hist_l, hist_r]),
                    row_dev[B_LSG::3][:2], row_dev[B_LSH::3][:2],
                    row_dev[B_LCNT::3][:2], mn2, mx2, fmask, child_depth)
    best[l], best[new_id] = rows2[0], rows2[1]


class GrowStats:
    """Counters of the growth loop, summed over the trees a learner grew:
    device->host syncs, splits and trees."""

    def __init__(self):
        self.host_syncs = 0
        self.splits = 0
        self.trees = 0


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


def _quant_side_maxes(win: torch.Tensor, go_left: torch.Tensor,
                      *, cw: int) -> torch.Tensor:
    """(2, 2) f32 [[max|qg|, max|qh|] left, [..] right] over a window:
    each child's stored-int maxes, which seed its leaf-local ratio."""
    qg, qh = quant_ops.unpack_gh(win[:, cw])
    a = torch.stack([qg.abs(), qh.abs()], dim=1).float()
    zero = torch.zeros((), dtype=torch.float32, device=win.device)
    left = torch.where(go_left[:, None], a, zero).amax(dim=0)
    right = torch.where(go_left[:, None], zero, a).amax(dim=0)
    return torch.stack([left, right])


def grow_tree_compact_core(data: torch.Tensor, spare: torch.Tensor,
                           base_mask: torch.Tensor, meta: dict,
                           *, c_cols: int, item_bits: int, num_leaves: int,
                           col_bins: int, max_depth: int, l1: float,
                           l2: float, max_delta_step: float,
                           min_data_in_leaf: int, min_sum_hessian: float,
                           min_gain_to_split: float,
                           quant: Optional[QuantRows] = None,
                           stats: Optional[GrowStats] = None):
    """Grow one tree over the packed working buffer `data` -- codes | gh
    section | row id, int32 -- with `spare` the second buffer of the same
    shape. Both are overwritten. The gh section is three bitcast f32 words
    (grad, hess, weight), or with `quant` one packed (qg|qh) word; then
    the histograms and the pool are exact int32 (kernel K3), and under
    leaf re-quantization each split's operand is re-discretized at the
    split leaf's ratio and the parent's pool entry rescaled to it.

    Returns (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k)."""
    n, d_cols = data.shape
    cw = d_cols - (2 if quant is not None else 4)
    L = num_leaves
    dev = data.device
    scan, best_row = _tree_helpers(
        meta["t_numbins"], meta["t_missing"], meta["t_default"],
        meta["t_monotone"], meta["t_penalty"], meta["t_elide"],
        meta["t_hist_idx"], max_depth=max_depth, l1=l1, l2=l2,
        max_delta_step=max_delta_step, min_data_in_leaf=min_data_in_leaf,
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split)
    search2 = search2_simple(scan, best_row)
    bufs = (data, spare)
    renew = quant is not None and quant.root_max is not None
    one = torch.ones((), dtype=torch.float32, device=dev)

    def win_codes(rows: torch.Tensor) -> torch.Tensor:
        """The codes of a contiguous row slice, read in place through a
        byte (or 16-bit) view of the packed words; 4-bit codes are
        unpacked first."""
        if item_bits == 8:
            return rows.view(torch.uint8)[:, :c_cols]
        if item_bits == 16:
            return rows.view(torch.int16)[:, :c_cols]
        return _unpack_codes(rows[:, :cw], c_cols, item_bits)

    def win_hist(rows: torch.Tensor, r) -> torch.Tensor:
        """K1 (float) or K3 (at ratios r) over a contiguous row slice."""
        if quant is None:
            return build_histogram(win_codes(rows),
                                   rows.view(torch.float32)[:, cw:cw + 3],
                                   col_bins)
        # the operand: every row's stored (qg|qh) word re-quantized to
        # the leaf's ratios (every row of a port window is valid)
        ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, quant.bits,
                                          quant.qcap_op, r[0], r[1])
        return build_histogram_quantized(win_codes(rows), ghq, col_bins)

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
    row0 = best_row(scan(for_scan(hist0, r0)[None], totals[0:1],
                         totals[1:2], totals[2:3], leaf_min[:1],
                         leaf_max[:1], base_mask), 0)
    best = torch.full((L, 12), NEG_INF, dtype=torch.float32, device=dev)
    best[:, B_FEAT:] = 0.0
    best[0] = row0[0]
    # the pool keeps the histograms' dtype: on the quantized path parent -
    # child below is exact integer arithmetic
    pool = torch.zeros((L,) + tuple(hist0.shape), dtype=hist0.dtype,
                       device=dev)
    pool[0] = hist0
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
        go_left = packed_go_left(win, feat, int(row[B_THR]),
                                 bool(row[B_DLEFT] > 0.5), meta,
                                 item_bits=item_bits)
        rq = ratios(leafmax[l] if renew else None)
        if renew:
            qmax2 = _quant_side_maxes(win, go_left, cw=cw)
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
        parent = pool[l]
        if renew:
            # re-express the parent in the split's ratio before the
            # subtraction (counts pass through exact)
            parent = quant_ops.rescale_histogram(
                parent, rq[0] / scale_of[l, 0], rq[1] / scale_of[l, 1])
        sibling = subtract_histogram(parent, hist_small)
        hist_l, hist_r = ((hist_small, sibling) if left_small
                          else (sibling, hist_small))
        pool[l] = hist_l
        pool[new_id] = hist_r

        split_epilogue(k=k, l=l, new_id=new_id, row=row, row_dev=row_dev,
                       mono_f=int(meta["f_monotone"][feat]),
                       leaf_min=leaf_min, leaf_max=leaf_max, depth=depth,
                       rec=rec, best=best, hist_l=for_scan(hist_l, rq),
                       hist_r=for_scan(hist_r, rq), fmask=base_mask,
                       search2=search2)
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
    return rec, leaf_id, k


def grow_tree(codes_t: torch.Tensor, gh: torch.Tensor,
              base_mask: torch.Tensor, meta: dict, *, num_leaves: int,
              col_bins: int, max_depth: int, l1: float, l2: float,
              max_delta_step: float, min_data_in_leaf: int,
              min_sum_hessian: float, min_gain_to_split: float,
              scale3: Optional[torch.Tensor] = None,
              stats: Optional[GrowStats] = None):
    """Grow one tree with the masked strategy over column-major codes
    `codes_t` (C, N) and the (N, 3) histogram operand `gh`: f32 [grad,
    hess, 1] (kernel K2), or with `scale3` the integer [qg, qh, 1]
    (kernel K3t; the pool is exact int32 and the scan reads it times the
    tree's fixed dequantization scales `scale3`). Each split rewrites the
    device row -> leaf map and builds the left child's histogram over all
    rows, the others' operand zeroed; the right child is parent - left.

    Returns (rec (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k)."""
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
        min_sum_hessian=min_sum_hessian, min_gain_to_split=min_gain_to_split)
    search2 = search2_simple(scan, best_row)

    # ---- root ------------------------------------------------------------
    hist0 = hist_fn(codes_t, gh, col_bins)
    totals = for_scan(hist0[0].sum(dim=0))        # (3,): sum_g, sum_h, cnt
    leaf_min = torch.full((L,), -np.inf, dtype=torch.float32, device=dev)
    leaf_max = torch.full((L,), np.inf, dtype=torch.float32, device=dev)
    row0 = best_row(scan(for_scan(hist0)[None], totals[0:1], totals[1:2],
                         totals[2:3], leaf_min[:1], leaf_max[:1],
                         base_mask), 0)
    best = torch.full((L, 12), NEG_INF, dtype=torch.float32, device=dev)
    best[:, B_FEAT:] = 0.0
    best[0] = row0[0]
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
        go_left = column_go_left(col, feat, int(row[B_THR]),
                                 bool(row[B_DLEFT] > 0.5), meta)
        parent = leaf_id == l
        leaf_id = torch.where(parent & ~go_left, new_id, leaf_id)
        ghl = gh * (parent & go_left)[:, None].to(gh.dtype)
        hist_l = hist_fn(codes_t, ghl, col_bins)
        hist_r = subtract_histogram(pool[l], hist_l)
        pool[l] = hist_l
        pool[new_id] = hist_r

        split_epilogue(k=k, l=l, new_id=new_id, row=row, row_dev=row_dev,
                       mono_f=int(meta["f_monotone"][feat]),
                       leaf_min=leaf_min, leaf_max=leaf_max, depth=depth,
                       rec=rec, best=best, hist_l=for_scan(hist_l),
                       hist_r=for_scan(hist_r), fmask=base_mask,
                       search2=search2)
        k += 1
    if stats is not None:
        stats.splits += k
    return rec, leaf_id, k


class DeviceTreeLearner:
    """Tree learner whose growth runs on `device` (the card, or the CPU
    through the kernels' plain versions)."""

    def __init__(self, config: Config, dataset: Dataset,
                 strategy: Optional[str] = None, device="cpu"):
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        if any(dataset.bin_mappers[f].bin_type == BIN_CATEGORICAL
               for f in dataset.used_features):
            raise LightGBMError("categorical features are not supported by "
                                "this port yet (categorical_feature)")
        self.strategy = resolve_strategy(config, dataset, strategy)
        dev = self.device
        nb, mt, db, _, mono = dataset.feature_meta_arrays()
        self.num_features = dataset.num_features
        self.num_bins = int(dataset.max_num_bins)
        self.device_bins = padded_device_bins(self.num_bins)
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
            "f_elide": f_elide,
            "t_numbins": t(nb, torch.int32), "t_missing": t(mt, torch.int32),
            "t_default": t(db, torch.int32),
            "t_monotone": t(mono, torch.int32),
            "t_penalty": t(pen, torch.float32),
            "t_elide": t(f_elide, torch.int32),
            "t_hist_idx": t(hi2, torch.int64)}

        host_codes = np.asarray(host_codes)
        self.c_cols = host_codes.shape[1]
        # quantized-gradient training: grad_bits when on, else 0; renew =
        # the compact core's leaf-wise re-quantization
        self.quant_bits = config.quant_bits
        self.quant_renew = bool(config.quant_renew)
        self.codes_pack: Optional[torch.Tensor] = None
        self.codes_t: Optional[torch.Tensor] = None
        if self.strategy == "compact":
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
            self.codes_pack = torch.from_numpy(packed.view(np.int32)).to(dev)
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
        self._spare: Optional[torch.Tensor] = None
        self.last_leaf_id: Optional[torch.Tensor] = None
        self.stats = GrowStats()

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

    def _statics(self):
        cfg = self.config
        return dict(
            num_leaves=int(cfg.num_leaves), col_bins=self.col_device_bins,
            max_depth=int(cfg.max_depth), l1=float(cfg.lambda_l1),
            l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split))

    def _feature_mask(self, rng: np.random.RandomState) -> np.ndarray:
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if 0.0 < frac < 1.0:
            k = max(1, int(self.num_features * frac))
            chosen = rng.choice(self.num_features, k, replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def working_buffer(self, grad: torch.Tensor,
                       hess: torch.Tensor) -> torch.Tensor:
        """(N, CW + 4) int32: packed codes | bitcast f32 grad, hess,
        weight (all ones) | row id."""
        n = grad.shape[0]
        gh = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
        ids = torch.arange(n, dtype=torch.int32, device=grad.device)
        return torch.cat([self.codes_pack, gh.view(torch.int32),
                          ids[:, None]], dim=1)

    def quant_working_buffer(self, grad: torch.Tensor, hess: torch.Tensor,
                             key: torch.Tensor):
        """The compact core's quantized rows: (N, CW + 2) int32 -- packed
        codes | one (qg << 16 | qh) word | row id -- and their QuantRows.
        All-ones weights need no weight word (the JAX gw = 1 layout)."""
        n = grad.shape[0]
        packed, s_g, s_h, root_max = _quant_prepare(
            grad, hess, key, quant_bits=self.quant_bits,
            quant_renew=self.quant_renew)
        ids = torch.arange(n, dtype=torch.int32, device=grad.device)
        data = torch.cat([self.codes_pack, packed[:, None], ids[:, None]],
                         dim=1)
        return data, QuantRows(self.quant_bits,
                               quant_ops.quant_max(self.quant_bits, n),
                               s_g, s_h, root_max)

    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_indices=None, iter_seed: int = 0) -> Tree:
        if bag_indices is not None:
            raise LightGBMError("bagging is not supported by this port yet")
        rec, leaf_id, k = self.grow(grad, hess, iter_seed)
        self.stats.trees += 1
        self.last_leaf_id = leaf_id
        if k == 0:
            log.warning("No further splits with positive gain")
        return self.replay_tree(rec, k)

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             iter_seed: int = 0):
        """Grow one tree on the learner's strategy: the feature sample
        from the host RandomState and the quantization key
        prng_key(iter_seed), as in the JAX package's train. Returns (rec
        (L-1, 13) f32 numpy, leaf_id (N,) int64 tensor, k)."""
        rng = np.random.RandomState(
            (self.config.feature_fraction_seed + iter_seed) % (2**31 - 1))
        mask = self._feature_mask(rng)
        base_mask = (self._ones_mask if mask.all()
                     else torch.as_tensor(mask, device=self.device))
        key = trandom.prng_key(iter_seed)
        grad, hess = grad.float(), hess.float()
        if self.strategy == "masked":
            return self._grow_masked(grad, hess, base_mask, key)
        return self._grow_compact(grad, hess, base_mask, key)

    def _grow_compact(self, grad, hess, base_mask, key):
        quant = None
        if self.quant_bits:
            data, quant = self.quant_working_buffer(grad, hess, key)
        else:
            data = self.working_buffer(grad, hess)
        if self._spare is None or self._spare.shape != data.shape:
            self._spare = torch.empty_like(data)
        return grow_tree_compact_core(
            data, self._spare, base_mask, self.meta, c_cols=self.c_cols,
            item_bits=self.item_bits, quant=quant, stats=self.stats,
            **self._statics())

    def _grow_masked(self, grad, hess, base_mask, key):
        scale3 = None
        if self.quant_bits:
            packed, s_g, s_h, _ = _quant_prepare(
                grad, hess, key, quant_bits=self.quant_bits,
                quant_renew=False)
            gh = quant_ops.gh_operand(
                packed, torch.ones_like(packed, dtype=torch.bool),
                self.quant_bits)
            scale3 = quant_ops.dequant_scale3(s_g, s_h)
        else:
            gh = torch.stack([grad, hess, torch.ones_like(grad)], dim=1)
        return grow_tree(self.codes_t, gh, base_mask, self.meta,
                         scale3=scale3, stats=self.stats,
                         **self._statics())

    def replay_tree(self, rec_h, k: int) -> Tree:
        """Materialize a host Tree from the (L-1, 13) split records."""
        ds = self.dataset
        rec_h = np.asarray(rec_h)
        tree = Tree(self.config.num_leaves)
        for i in range(k):
            r = rec_h[i]
            inner_f = int(r[R_FEAT])
            real_f = ds.inner_to_real(inner_f)
            mapper = ds.bin_mappers[real_f]
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


__all__: List[str] = ["DeviceTreeLearner", "grow_tree",
                      "grow_tree_compact_core", "resolve_strategy",
                      "padded_device_bins"]
