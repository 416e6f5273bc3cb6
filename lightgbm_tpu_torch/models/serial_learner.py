"""Serial (single-device) leaf-wise tree learner with a host loop.

Port of lightgbm_tpu/models/serial_learner.py (reference:
src/treelearner/serial_tree_learner.cpp:173-893): leaf-wise growth with
histogram subtraction, whose tree loop runs on the host and reads each
split's outcome back (one host sync per split, as in the JAX package).
It is the learner of the configurations the device learner does not take
(``DeviceTreeLearner.supports``): forced splits (the BFS JSON of
``forcedsplits_filename``, applied at the top of every tree) and the CEGB
penalties (split, coupled and lazy), and a histogram pool over the 2 GB
limit; ``parallel/learners.py::create_tree_learner`` picks it, or
``LGBM_TPU_HOST_LEARNER=1`` forces it.

Per split, ops/fused.py's step: the stable partition of the leaf's window
in a permutation buffer of row ids, the left child's histogram from the
window's gathered rows (K1's host-int entry; quantized gradients: K3's
operand entry), the sibling as parent - left, both children's scans;
then one fetch of the left count and the two winners (and, with
categorical features, the two categorical winners, merged on the host).
The histograms are over the (N, F) per-feature codes (no EFB bundles).

Its samplers are its own, as in the JAX package: the per-tree feature
sample and the by-node one (``feature_fraction_bynode``: one
RandomState.choice per split, shared by both children) draw from the
host RandomState, and quantized gradients use the key
(feature_fraction_seed * 9973 + 2 * iter_seed + 1).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import Dataset
from ..ops import fused as fused_ops
from ..ops import quantize as quant_ops
from ..ops import split as split_ops
from ..ops.partition import make_indices_buffer, mask_to_words
from ..utils import log
from ..utils import random as trandom
from .device_learner import GrowStats, _make_bitset
from .tree import Tree

_MIN_BUCKET = 256


def _bucket(count: int, cap: int) -> int:
    """The padded window of a leaf of `count` rows: the power of two from
    256 up that holds them, at most `cap`."""
    b = _MIN_BUCKET
    while b < count:
        b *= 2
    return min(b, cap)


class _LeafState:
    __slots__ = ("begin", "count", "sum_grad", "sum_hess", "depth",
                 "hist", "split", "min_c", "max_c")

    def __init__(self, begin, count, sum_grad, sum_hess, depth,
                 min_c=-np.inf, max_c=np.inf):
        self.begin = begin
        self.count = count
        self.sum_grad = sum_grad
        self.sum_hess = sum_hess
        self.depth = depth
        self.hist = None         # (F, B, 3) on the device
        self.split = None        # host dict of the best split, or None
        self.min_c = min_c
        self.max_c = max_c


# the host record's fields, in the order of _split_table's columns
_NUM_FIELDS = ("gain", "feature", "threshold", "default_left",
               "left_sum_grad", "left_sum_hess", "left_count",
               "right_sum_grad", "right_sum_hess", "right_count",
               "left_output", "right_output")


def _split_table(res) -> torch.Tensor:
    """(N, 12) f32 of a SplitResult or CatSplitResult (a categorical one
    has threshold and default_left 0), in _NUM_FIELDS order."""
    zero = torch.zeros_like(res.gain)
    thr = res.threshold.float() if hasattr(res, "threshold") else zero
    dleft = res.default_left.float() if hasattr(res, "default_left") \
        else zero
    return torch.stack([res.gain, res.feature.float(), thr, dleft,
                        res.left_sum_grad, res.left_sum_hess, res.left_count,
                        res.right_sum_grad, res.right_sum_hess,
                        res.right_count, res.left_output, res.right_output],
                       dim=1)


def _host_split(row: np.ndarray, words: Optional[np.ndarray] = None) -> dict:
    """The host record of one fetched winner (the JAX _fetch_split): a
    categorical one (with its (W,) int32 left-bin words) carries its
    minimal inner bitset."""
    rec = {k: float(v) for k, v in zip(_NUM_FIELDS, row)}
    rec["feature"] = int(row[1])
    rec["threshold"] = 0 if words is not None else int(row[2])
    rec["default_left"] = words is None and bool(row[3] > 0.5)
    rec["left_count"] = int(round(float(row[6])))
    rec["right_count"] = int(round(float(row[9])))
    rec["categorical"] = words is not None
    if words is not None:
        rec["cat_bitset_inner"] = _make_bitset(_bits_set(words))
    return rec


class SerialTreeLearner:
    """The host-loop learner on `device` (the card, or the CPU through
    the kernels' plain versions)."""

    def __init__(self, config: Config, dataset: Dataset, device="cpu"):
        self.config = config
        self.dataset = dataset
        self.device = torch.device(device)
        dev = self.device
        codes = np.ascontiguousarray(dataset.binned)
        if codes.dtype == np.uint16:
            codes = codes.view(np.int16)        # K1 / K3 read int16 as u16
        self.binned = torch.from_numpy(codes).to(dev)
        nb, mt, db, cat, mono = dataset.feature_meta_arrays()

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        self.f_numbins, self.f_missing = t(nb, torch.int32), t(mt, torch.int32)
        self.f_default = t(db, torch.int32)
        self.f_categorical = t(cat, torch.int32)
        self.f_monotone = t(mono, torch.int32)
        self._f_monotone_host = np.asarray(mono)
        self.num_features = dataset.num_features
        self.num_bins = int(dataset.max_num_bins)
        self.device_bins = 1 << max(4, (self.num_bins - 1).bit_length())
        self.max_bucket = _bucket(dataset.num_data, 1 << 30)
        self._has_categorical = any(
            dataset.bin_mappers[f].bin_type == BIN_CATEGORICAL
            for f in dataset.used_features)
        self._cat_words = (self.device_bins + 31) // 32
        self._quant_bits = config.quant_bits
        self._gh_packed = None
        self._scales_vec = None
        self._meta_cache = None
        self._cat_mask_cache = None
        self._mono_enabled = bool(np.any(np.asarray(mono) != 0))
        # feature_contri gain multipliers (reference FeatureMetainfo)
        contri = config.feature_contri or []
        self._feature_penalty = None
        if contri:
            self._feature_penalty = t(
                [contri[f] if f < len(contri) else 1.0
                 for f in dataset.used_features], torch.float32)
        # CEGB (reference cost_effective_gradient_boosting.hpp): coupled
        # penalties are charged once per feature across the whole model;
        # lazy per-row costs are approximated per leaf by count
        self._cegb_enabled = (config.cegb_tradeoff > 0 and (
            config.cegb_penalty_split > 0
            or bool(config.cegb_penalty_feature_coupled)
            or bool(config.cegb_penalty_feature_lazy)))
        if self._cegb_enabled:
            coupled = config.cegb_penalty_feature_coupled or []
            lazy = config.cegb_penalty_feature_lazy or []
            self._cegb_coupled = np.array(
                [coupled[f] if f < len(coupled) else 0.0
                 for f in dataset.used_features])
            self._cegb_lazy = np.array(
                [lazy[f] if f < len(lazy) else 0.0
                 for f in dataset.used_features])
            self._cegb_feature_used = np.zeros(self.num_features, dtype=bool)
        # forced splits: BFS JSON replayed at the top of every tree
        # (reference serial_tree_learner.cpp:607-769 ForceSplits)
        self._forced_splits = None
        if config.forcedsplits_filename:
            with open(config.forcedsplits_filename) as fh:
                self._forced_splits = json.load(fh)
        self.indices_buf: Optional[torch.Tensor] = None
        self.leaves: Dict[int, _LeafState] = {}
        # the score update walks the tree (the JAX learner keeps no row ->
        # leaf map either)
        self.last_leaf_id = None
        self.stats = GrowStats()

    # ------------------------------------------------------------------
    def _scan_args(self):
        cfg = self.config
        return dict(
            l1=float(cfg.lambda_l1), l2=float(cfg.lambda_l2),
            max_delta_step=float(cfg.max_delta_step),
            min_data_in_leaf=int(cfg.min_data_in_leaf),
            min_sum_hessian=float(cfg.min_sum_hessian_in_leaf),
            min_gain_to_split=float(cfg.min_gain_to_split))

    def _cat_scan_args(self):
        cfg = self.config
        return dict(self._scan_args(), cat_l2=float(cfg.cat_l2),
                    cat_smooth=float(cfg.cat_smooth),
                    max_cat_threshold=int(cfg.max_cat_threshold),
                    max_cat_to_onehot=int(cfg.max_cat_to_onehot),
                    min_data_per_group=int(cfg.min_data_per_group))

    def _feature_mask(self, rng: np.random.RandomState) -> np.ndarray:
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if 0.0 < frac < 1.0:
            k = max(1, int(self.num_features * frac))
            chosen = rng.choice(self.num_features, k, replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def _node_feature_mask(self, base_mask: np.ndarray,
                           rng: np.random.RandomState) -> torch.Tensor:
        """The node's feature sample: the tree's base mask, and with
        feature_fraction_bynode a fresh RandomState.choice of its share."""
        frac = self.config.feature_fraction_bynode
        mask = base_mask
        if 0.0 < frac < 1.0:
            k = max(1, int(self.num_features * frac))
            chosen = rng.choice(self.num_features, k, replace=False)
            node = np.zeros(self.num_features, dtype=bool)
            node[chosen] = True
            mask = base_mask & node
        return torch.as_tensor(mask, device=self.device)

    def _fused_meta(self, base_mask, rng):
        """The numerical scan's feature metadata with the node's mask:
        the same for the whole tree unless by-node sampling draws anew
        (train() clears the cache per tree; a cached meta draws
        nothing, as in JAX)."""
        if self._meta_cache is not None:
            return self._meta_cache
        mask = self._node_feature_mask(base_mask, rng) \
            & (self.f_categorical == 0)
        meta = (self.f_numbins, self.f_missing, self.f_default, mask,
                self.f_monotone, self._feature_penalty)
        if not (0.0 < self.config.feature_fraction_bynode < 1.0):
            self._meta_cache = meta
        return meta

    def _cat_mask(self, base_mask) -> torch.Tensor:
        """The categorical scan's mask: the tree's base mask (no by-node
        draw, as in JAX), hoisted per tree."""
        if self._cat_mask_cache is None:
            self._cat_mask_cache = torch.as_tensor(
                base_mask, device=self.device) & (self.f_categorical == 1)
        return self._cat_mask_cache

    def _hist_f32(self, hist):
        """A leaf histogram as the scans read it: itself, or dequantized
        at the iteration's scales (the pool stays exact int32)."""
        if self._quant_bits and hist is not None:
            return quant_ops.dequantize_histogram(hist, self._scales_vec[0],
                                                  self._scales_vec[1])
        return hist

    def _cat_search(self, hists, sums2, mn2, mx2, cat_mask):
        """N leaves' categorical winners over the features of cat_mask:
        hists (N, F, B, 3), sums2 (N, 3), bounds (N,) -> (N, 12) table and
        (N, W) int32 left-bin words."""
        cres = split_ops.find_best_split_categorical(
            self._hist_f32(hists), sums2[:, 0], sums2[:, 1], sums2[:, 2],
            self.f_numbins, self.f_missing, cat_mask, mn2, mx2,
            **self._cat_scan_args())
        return (_split_table(cres),
                mask_to_words(cres.left_mask, self._cat_words))

    def _fetch(self, *parts):
        """The one host copy of a step's results: 0-d / (N, k) tensors
        (int32 ones bit-cast) packed into one tensor; returns the numpy
        pieces in their shapes."""
        flat = [p.reshape(-1).float() if p.dtype != torch.int32
                else p.reshape(-1).view(torch.float32) for p in parts]
        host = torch.cat(flat).cpu().numpy()
        self.stats.host_syncs += 1
        out, i = [], 0
        for p in parts:
            a = host[i:i + p.numel()]
            if p.dtype == torch.int32:
                a = a.view(np.int32)
            out.append(a.reshape(tuple(p.shape)))
            i += p.numel()
        return out

    def _scan_leaf(self, leaf: _LeafState, feature_mask) -> dict:
        """A leaf's best split from its histogram (numerical, and with
        categorical features the better of both); one fetch."""
        dev = self.device
        sums = torch.tensor([[leaf.sum_grad, leaf.sum_hess, leaf.count]],
                            dtype=torch.float32, device=dev)
        mn = torch.tensor([leaf.min_c], dtype=torch.float32, device=dev)
        mx = torch.tensor([leaf.max_c], dtype=torch.float32, device=dev)
        meta = (self.f_numbins, self.f_missing, self.f_default,
                feature_mask & (self.f_categorical == 0), self.f_monotone,
                None)
        res = fused_ops._scan(self._hist_f32(leaf.hist)[None], sums, meta,
                              mn, mx, self._scan_args())
        parts = [_split_table(res)]
        if self._has_categorical:
            parts += list(self._cat_search(
                leaf.hist[None], sums, mn, mx,
                feature_mask & (self.f_categorical == 1)))
        got = self._fetch(*parts)
        rec = _host_split(got[0][0])
        if self._has_categorical:
            crec = _host_split(got[1][0], got[2][0])
            if crec["gain"] > rec["gain"]:
                rec = crec
        return rec

    def _merge_categorical(self, st: _LeafState, crec: dict) -> None:
        """The categorical winner replaces the leaf's numerical one on a
        strictly greater gain (the JAX _merge_categorical, whose scan ran
        in the split's step and came back in its fetch)."""
        if st.split is None or crec["gain"] > st.split["gain"]:
            st.split = crec

    def _cegb_cost(self, count: int) -> Optional[np.ndarray]:
        """(F,) f32 CEGB cost of splitting a leaf of `count` rows: the
        split penalty, each unused feature's coupled penalty, the lazy
        per-row penalties; None without CEGB."""
        if not self._cegb_enabled:
            return None
        cfg = self.config
        cost = np.full(self.num_features,
                       cfg.cegb_tradeoff * cfg.cegb_penalty_split * count)
        cost += np.where(self._cegb_feature_used, 0.0,
                         cfg.cegb_tradeoff * self._cegb_coupled)
        cost += cfg.cegb_tradeoff * self._cegb_lazy * count
        return cost.astype(np.float32)

    # ------------------------------------------------------------------
    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              bag_indices=None, iter_seed: int = 0) -> Tree:
        """Grow one tree from (N,) gradients on the rows `bag_indices`
        (host ints; None: every row). Per split one step of ops/fused.py
        and one host fetch."""
        cfg = self.config
        n = self.dataset.num_data
        dev = self.device
        grad, hess = grad.float(), hess.float()
        bag_cnt = n if bag_indices is None else len(bag_indices)
        indices_buf = make_indices_buffer(n, self.max_bucket, bag_indices,
                                          dev)
        rng = np.random.RandomState(
            (cfg.feature_fraction_seed + iter_seed) % (2**31 - 1))
        base_mask = self._feature_mask(rng)

        tree = Tree(cfg.num_leaves)
        self._meta_cache = None
        self._cat_mask_cache = None
        root_cost = self._cegb_cost(bag_cnt)
        root_cost = None if root_cost is None \
            else torch.as_tensor(root_cost, device=dev)
        bucket = _bucket(bag_cnt, self.max_bucket)
        kw = dict(bucket=bucket, num_bins=self.device_bins,
                  **self._scan_args())
        if self._quant_bits:
            # per-iteration discretization with stochastic rounding, one
            # packed int32 word per row for the whole tree
            qkey = trandom.prng_key(
                (cfg.feature_fraction_seed * 9973 + 2 * iter_seed + 1)
                % (2**31 - 1))
            self._gh_packed, s_g, s_h = quant_ops.quantize_gh(
                grad, hess, qkey, grad_bits=self._quant_bits)
            self._scales_vec = torch.stack([s_g, s_h])
            root_hist, totals, root_res = fused_ops.fused_root_step_q(
                indices_buf, self.binned, self._gh_packed, self._scales_vec,
                bag_cnt, self._fused_meta(base_mask, rng), root_cost,
                grad_bits=self._quant_bits, **kw)
        else:
            root_hist, totals, root_res = fused_ops.fused_root_step(
                indices_buf, self.binned, grad, hess, bag_cnt,
                self._fused_meta(base_mask, rng), root_cost, **kw)
        parts = [totals, _split_table(root_res)]
        if self._has_categorical:
            inf = torch.full((1,), np.inf, device=dev)
            parts += list(self._cat_search(root_hist[None], totals[None],
                                           -inf, inf,
                                           self._cat_mask(base_mask)))
        got = self._fetch(*parts)
        root = _LeafState(0, bag_cnt, float(got[0][0]), float(got[0][1]), 0)
        root.hist = root_hist
        root.split = _host_split(got[1][0])
        if self._has_categorical:
            self._merge_categorical(root, _host_split(got[2][0], got[3][0]))
        leaves: Dict[int, _LeafState] = {0: root}

        if self._forced_splits is not None:
            indices_buf = self._replay_forced_splits(
                tree, leaves, indices_buf, grad, hess, base_mask, rng)

        # up to num_leaves leaves, the forced splits' included (the JAX
        # loop takes num_leaves - 1 more splits after them, and a tree
        # that would grow past num_leaves fails there)
        split_idx = 0
        while tree.num_leaves < cfg.num_leaves:
            # the splittable leaf with the largest gain (leaf-wise growth)
            best_leaf, best_gain = -1, 1e-10
            for li, st in leaves.items():
                if st.split is not None and st.split["gain"] > best_gain:
                    best_leaf, best_gain = li, st.split["gain"]
            if best_leaf < 0:
                if split_idx == 0:
                    log.warning("No further splits with positive gain, "
                                "best gain: %f", best_gain)
                break
            indices_buf = self._apply_split(tree, leaves, best_leaf,
                                            indices_buf, grad, hess,
                                            base_mask, rng)
            split_idx += 1

        self.indices_buf = indices_buf
        self.leaves = leaves
        self.stats.trees += 1
        self.stats.splits += tree.num_leaves - 1
        return tree

    def _apply_split(self, tree: Tree, leaves: Dict[int, _LeafState],
                     leaf_id: int, indices_buf, grad, hess, base_mask, rng):
        ds = self.dataset
        dev = self.device
        st = leaves[leaf_id]
        sp = st.split
        inner_f = sp["feature"]
        real_f = ds.inner_to_real(inner_f)
        mapper = ds.bin_mappers[real_f]

        # children's output bounds: monotone propagation (basic mode,
        # reference serial_tree_learner.cpp:771-852)
        lmin, lmax, rmin, rmax = st.min_c, st.max_c, st.min_c, st.max_c
        mono = int(self._f_monotone_host[inner_f]) if self._mono_enabled \
            else 0
        if mono != 0:
            mid = (sp["left_output"] + sp["right_output"]) / 2.0
            if mono > 0:
                lmax, rmin = min(lmax, mid), max(rmin, mid)
            else:
                lmin, rmax = max(lmin, mid), min(rmax, mid)

        words = np.zeros(self._cat_words, dtype=np.uint32)
        if sp["categorical"]:
            src = sp["cat_bitset_inner"][:self._cat_words]
            words[:len(src)] = src
        bitset = torch.as_tensor(words.view(np.int32), device=dev)
        iparams = [st.begin, st.count, inner_f, sp["threshold"],
                   int(sp["default_left"]), mapper.missing_type,
                   mapper.default_bin, mapper.num_bin,
                   int(sp["categorical"])]
        fparams = np.asarray(
            [sp["left_sum_grad"], sp["left_sum_hess"], sp["left_count"],
             sp["right_sum_grad"], sp["right_sum_hess"], sp["right_count"],
             lmin, lmax, rmin, rmax], dtype=np.float32)
        child_costs = None
        if self._cegb_enabled:
            child_costs = torch.as_tensor(np.stack([
                self._cegb_cost(sp["left_count"]),
                self._cegb_cost(sp["right_count"])]), device=dev)
            self._cegb_feature_used[inner_f] = True
        kw = dict(bucket=_bucket(st.count, self.max_bucket),
                  num_bins=self.device_bins, **self._scan_args())
        meta = self._fused_meta(base_mask, rng)
        if self._quant_bits:
            out = fused_ops.fused_split_step_q(
                indices_buf, self.binned, self._gh_packed, iparams, bitset,
                fparams, st.hist, self._scales_vec, meta, child_costs,
                grad_bits=self._quant_bits, **kw)
        else:
            out = fused_ops.fused_split_step(
                indices_buf, self.binned, grad, hess, iparams, bitset,
                fparams, st.hist, meta, child_costs, **kw)

        # the split's one fetch: the left count and the two winners (and
        # the two categorical winners)
        parts = [out.left_count, _split_table(out.res)]
        if self._has_categorical:
            f = torch.as_tensor(fparams, device=dev)
            parts += list(self._cat_search(
                torch.stack([out.left_hist, out.right_hist]),
                f[:6].view(2, 3), f[6::2], f[7::2],
                self._cat_mask(base_mask)))
        got = self._fetch(*parts)
        left_cnt = int(got[0])
        if left_cnt != sp["left_count"]:
            log.debug("partition/scan count mismatch: %d vs %d",
                      left_cnt, sp["left_count"])

        # tree bookkeeping (leaf_id keeps the left child, the new leaf is
        # the right one)
        if not sp["categorical"]:
            new_leaf = tree.split(
                leaf_id, inner_f, real_f, sp["threshold"],
                ds.real_threshold(inner_f, sp["threshold"]),
                sp["left_output"], sp["right_output"], sp["left_count"],
                sp["right_count"], sp["left_sum_hess"],
                sp["right_sum_hess"], sp["gain"], mapper.missing_type,
                sp["default_left"])
        else:
            inner_bits = sp["cat_bitset_inner"]
            cats = [mapper.bin_2_categorical[b]
                    for b in _bits_set(inner_bits)
                    if b < len(mapper.bin_2_categorical)]
            new_leaf = tree.split_categorical(
                leaf_id, inner_f, real_f, [int(w) for w in inner_bits],
                [int(w) for w in _make_bitset(cats)], sp["left_output"],
                sp["right_output"], sp["left_count"], sp["right_count"],
                sp["left_sum_hess"], sp["right_sum_hess"], sp["gain"],
                mapper.missing_type)

        left = _LeafState(st.begin, sp["left_count"], sp["left_sum_grad"],
                          sp["left_sum_hess"], st.depth + 1, lmin, lmax)
        right = _LeafState(st.begin + sp["left_count"], sp["right_count"],
                           sp["right_sum_grad"], sp["right_sum_hess"],
                           st.depth + 1, rmin, rmax)
        left.hist, right.hist = out.left_hist, out.right_hist
        for i, child in enumerate((left, right)):
            if not self._splittable(child):
                continue
            child.split = _host_split(got[1][i])
            if self._has_categorical:
                self._merge_categorical(child,
                                        _host_split(got[2][i], got[3][i]))
        st.hist = None                       # release the parent histogram
        if left.split is None:
            left.hist = None
        if right.split is None:
            right.hist = None
        leaves[leaf_id] = left
        leaves[tree.num_leaves - 1] = right
        assert tree.num_leaves - 1 == new_leaf
        return out.indices_buf

    def _replay_forced_splits(self, tree, leaves, indices_buf, grad, hess,
                              base_mask, rng):
        """Apply the forced-split JSON breadth-first before normal
        growth."""
        cfg = self.config
        ds = self.dataset
        queue = [(0, self._forced_splits)]
        while queue and tree.num_leaves < cfg.num_leaves:
            leaf_id, node = queue.pop(0)
            if node is None or "feature" not in node:
                continue
            real_f = int(node["feature"])
            if real_f not in ds.used_features:
                log.warning("Forced split feature %d unavailable; skipping",
                            real_f)
                continue
            inner_f = ds.used_features.index(real_f)
            mapper = ds.bin_mappers[real_f]
            bin_thr = min(mapper.value_to_bin(float(node["threshold"])),
                          mapper.num_bin - 2)
            st = leaves[leaf_id]
            sp = self._gather_split_at(st, inner_f, bin_thr)
            if sp is None:
                continue
            st.split = sp
            indices_buf = self._apply_split(tree, leaves, leaf_id,
                                            indices_buf, grad, hess,
                                            base_mask, rng)
            right_leaf = tree.num_leaves - 1
            if "left" in node:
                queue.append((leaf_id, node["left"]))
            if "right" in node:
                queue.append((right_leaf, node["right"]))
        return indices_buf

    def _gather_split_at(self, st: _LeafState, inner_f: int,
                         bin_thr: int) -> Optional[dict]:
        """The split record of a fixed (feature, bin) from the leaf's
        histogram, in f64 on the host (reference feature_histogram.hpp:
        281-419 GatherInfoForThreshold); one fetch."""
        cfg = self.config
        hrow = self._hist_f32(st.hist)[inner_f].cpu().numpy() \
            .astype(np.float64)
        self.stats.host_syncs += 1
        lg, lh, lc = hrow[: bin_thr + 1].sum(axis=0)
        rg, rh, rc = st.sum_grad - lg, st.sum_hess - lh, st.count - lc
        if lc < 1 or rc < 1:
            return None

        def tl1(s):
            return np.sign(s) * max(0.0, abs(s) - cfg.lambda_l1)

        def output(g, h):
            o = -tl1(g) / (h + cfg.lambda_l2)
            if cfg.max_delta_step > 0:
                o = float(np.clip(o, -cfg.max_delta_step,
                                  cfg.max_delta_step))
            return float(np.clip(o, st.min_c, st.max_c))

        def gain_part(g, h, o):
            return -(2.0 * tl1(g) * o + (h + cfg.lambda_l2) * o * o)

        lo, ro = output(lg, lh), output(rg, rh)
        gain_shift = gain_part(st.sum_grad, st.sum_hess,
                               output(st.sum_grad, st.sum_hess))
        gain = gain_part(lg, lh, lo) + gain_part(rg, rh, ro) - gain_shift
        return {
            "gain": float(gain), "feature": inner_f,
            "threshold": int(bin_thr), "default_left": False,
            "left_sum_grad": float(lg), "left_sum_hess": float(lh),
            "left_count": int(round(lc)),
            "right_sum_grad": float(rg), "right_sum_hess": float(rh),
            "right_count": int(round(rc)),
            "left_output": lo, "right_output": ro, "categorical": False,
        }

    def _splittable(self, leaf: _LeafState) -> bool:
        cfg = self.config
        if leaf.count < 2 * cfg.min_data_in_leaf:
            return False
        if leaf.sum_hess < 2 * cfg.min_sum_hessian_in_leaf:
            return False
        if cfg.max_depth > 0 and leaf.depth >= cfg.max_depth:
            return False
        return True

    # ------------------------------------------------------------------
    def leaf_rows(self, leaf_id: int) -> np.ndarray:
        """The rows of a leaf of the last tree (leaf renewal, RF): its
        window of the permutation buffer."""
        st = self.leaves[leaf_id]
        self.stats.host_syncs += 1
        return self.indices_buf[st.begin:st.begin + st.count].cpu().numpy()

    def reset_config(self) -> None:
        """After a parameter reset: the per-tree caches are made anew at
        every tree, so nothing is kept."""
        self._meta_cache = None
        self._cat_mask_cache = None


def _bits_set(words) -> list:
    """The set bit positions of uint32 bitset words."""
    out = []
    for wi, w in enumerate(np.asarray(words).astype(np.uint32)):
        w = int(w)
        for b in range(32):
            if (w >> b) & 1:
                out.append(wi * 32 + b)
    return out
