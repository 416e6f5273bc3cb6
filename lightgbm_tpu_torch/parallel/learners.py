"""The tree learner factory and the data-parallel learner.

Port of lightgbm_tpu/parallel/learners.py::create_tree_learner (reference:
src/treelearner/tree_learner.cpp:13-36 CreateTreeLearner) and of its
device data-parallel learner. The choice is by configuration, the JAX
package's: for ``tree_learner=serial`` the device learner when
``DeviceTreeLearner.supports`` takes the config and
``LGBM_TPU_HOST_LEARNER`` is not 1, else the host-loop
``SerialTreeLearner`` (forced splits, CEGB, a histogram pool over 2 GB);
for ``tree_learner=data`` the ``DeviceDataParallelTreeLearner`` below. It
is never a way around a kernel that fails to build or launch: such a
failure raises wherever it happens. Under stream_mode the learner is the
device chunk learner or an error, never a silent resident learner (the
JAX package's gating): the host-loop learner (LGBM_TPU_HOST_LEARNER=1,
forced splits, CEGB) has no streaming path.

The data-parallel learner takes every mode the single-card device
learner takes on its compact core: float or quantized gradients (both
reduce modes), bagging and GOSS drawn per rank on the fused iteration,
host bags of global row ids on the generic one (pos/neg bagging, RF,
DART), leaf renewal and query groups (models/gbdt.py, the objectives).

Not ported yet, each refused naming ROADMAP.md section 1, item 5: the
feature- and voting-parallel learners, the host-loop data-parallel
learner (the configs only the host loop takes), streamed data-parallel
and rows mode (dist_shard_mode=rows).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..distributed import bootstrap
from ..io.dataset import Dataset
from ..models.device_learner import (B_FEAT, B_GAIN, DeviceTreeLearner,
                                     QuantRows, _quant_prepare, _tree_helpers,
                                     leaf_map)
from ..ops import quantize as quant_ops
from ..ops.fused import leaf_values_from_rec
from ..ops.kernels.split_key import route_rows
from ..telemetry import recorder as telem
from ..models.serial_learner import SerialTreeLearner
from ..utils import log
from ..utils.envs import dp_reduce_mode_env, host_learner_env
from ..utils import random as trandom
from ..utils.log import LightGBMError
from . import network
from .mesh import Mesh, make_mesh


def _not_yet(what: str, part: str) -> LightGBMError:
    return LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                         "(ROADMAP.md section 1, item 5: %s)" % (what, part))


def create_tree_learner(config: Config, dataset: Dataset, device="cpu",
                        mesh: Optional[Mesh] = None):
    """The learner of `config` on `device` (serial or data-parallel)."""
    name = config.tree_learner
    stream = str(getattr(config, "stream_mode", "off") or "off")
    if stream != "off" and name != "serial":
        raise LightGBMError(
            "stream_mode=%s with tree_learner=%s has no streaming path in "
            "lightgbm_tpu_torch: streaming runs on the serial learner "
            "(ROADMAP.md section 1, item 5: streamed data-parallel)"
            % (stream, name))
    if name in ("data", "data_parallel"):
        if host_learner_env() or not DeviceTreeLearner.supports(
                config, dataset, strategy="compact"):
            raise _not_yet(
                "tree_learner=%s with a config only the host-loop learner "
                "takes (forced splits, CEGB, a pool over 2 GB or "
                "LGBM_TPU_HOST_LEARNER=1)" % name,
                "the host-loop data-parallel learner")
        return DeviceDataParallelTreeLearner(config, dataset, device=device,
                                             mesh=mesh)
    if name in ("feature", "feature_parallel"):
        raise _not_yet("tree_learner=%s" % name, "feature-parallel")
    if name in ("voting", "voting_parallel"):
        raise _not_yet("tree_learner=%s" % name, "voting")
    if name != "serial":
        log.fatal("Unknown tree learner %s", name)
    if stream != "off":
        if host_learner_env():
            raise LightGBMError(
                "stream_mode=%s is incompatible with LGBM_TPU_HOST_LEARNER=1"
                " (the host-loop learner has no streaming path)" % stream)
        if not DeviceTreeLearner.supports(config, dataset):
            raise LightGBMError(
                "stream_mode=%s needs the device chunk learner but this "
                "config is unsupported by it (forced splits / CEGB / pool "
                "budget); fix the config or set stream_mode=off" % stream)
        return DeviceTreeLearner(config, dataset, device=device)
    if not host_learner_env() and DeviceTreeLearner.supports(config,
                                                             dataset):
        return DeviceTreeLearner(config, dataset, device=device)
    log.info("Using the host-loop serial tree learner (%s)",
             "LGBM_TPU_HOST_LEARNER=1" if host_learner_env()
             else "forced splits, CEGB or a histogram pool over 2 GB")
    return SerialTreeLearner(config, dataset, device=device)


def rank_bag_weights(key: torch.Tensor, rank: int, real: int, local_n: int,
                     fraction: float, device) -> torch.Tensor:
    """(local_n,) f32 0/1 weights of one rank's bag on the fused iteration
    (the JAX data-parallel program's per-shard exact-count bagging;
    reference gbdt.cpp:210-276 bags each machine's rows): uniforms of
    fold_in(key, rank), +inf on the padding rows, k = max(1, int(f32(real)
    * f32(fraction))) of the real rows by the k-th smallest. The alive
    guard keeps an all-padding rank's bag empty."""
    pos = torch.arange(local_n, device=device)
    alive = pos < real
    u = torch.where(alive, trandom.uniform(trandom.fold_in(key, rank),
                                           local_n, device),
                    torch.full((), float("inf"), device=device))
    k = max(1, int(np.float32(real) * np.float32(fraction)))
    cut = torch.sort(u).values[min(k, local_n) - 1]
    return ((u <= cut) & alive).float()


def rank_goss_sample(g: torch.Tensor, h: torch.Tensor, key: torch.Tensor,
                     rank: int, real: int, top_rate: float,
                     other_rate: float):
    """One rank's GOSS on the fused iteration (the JAX data-parallel
    program's per-shard GOSS; reference goss.hpp:60-117 samples each
    machine's rows): the top_l = max(1, int(f32(real) * top_rate)) real
    rows by |g * h| (a stable sort), other_l of the rest by the uniforms of
    fold_in(key, rank), their gradients amplified by (real - top_l) /
    other_l in f32. `g`, `h` are the rank's (local_n,) rows, padding
    included. Returns (g, h, w): amplified gradients and 0/1 weights."""
    local_n = g.shape[0]
    dev = g.device
    pos = torch.arange(local_n, device=dev)
    alive = pos < real
    realf = np.float32(real)
    top_l = max(1, int(realf * np.float32(top_rate)))
    other_l = max(1, int(realf * np.float32(other_rate)))
    gmag = (g * h).abs() * alive.float()
    ridx = torch.argsort(-gmag, stable=True)
    rank_of = torch.empty_like(pos).scatter_(0, ridx, pos)
    is_top = (rank_of < top_l) & alive
    u = torch.where(alive & ~is_top,
                    trandom.uniform(trandom.fold_in(key, rank), local_n, dev),
                    torch.full((), float("inf"), device=dev))
    cut = torch.sort(u).values[min(other_l, local_n) - 1]
    is_other = (u <= cut) & alive & ~is_top
    mult = float(np.float32(realf - np.float32(top_l))
                 / np.float32(max(other_l, 1)))
    amp = torch.where(is_other, torch.full((), mult, device=dev),
                      torch.ones((), device=dev))
    return g * amp, h * amp, (is_top | is_other).float()


class DeviceDataParallelTreeLearner(DeviceTreeLearner):
    """The data-parallel learner (JAX parallel/learners.py:692-1233): one
    process per device, rows in ceil blocks over the group (parallel/
    mesh.py), every tree grown by the compact core's device loop on this
    rank's block. Per split each rank builds the smaller child's K1 (K3
    when quantized) histogram over its own rows (the child chosen by the
    records' global counts), partitions its own rows (K4's window entry,
    the split key) and reduces the histogram across the ranks (reference:
    data_parallel_tree_learner.cpp:149-164 ReduceScatter, :246
    SyncUpGlobalBestSplit) in one of the JAX package's two modes
    (LGBM_TPU_DP_REDUCE, utils/envs.py):

    * psum: an all-reduce; every rank holds the whole histogram and runs
      the same scan, so the best-split sync costs nothing more;
    * reduce-scatter (the default with no EFB bundles, no by-node
      sampling and W > 1): the column axis is cut into W blocks of
      cs = ceil(C / W) columns; each rank keeps and scans only its block
      (the pool holds (cs, B, 3) entries) and the winner of each leaf is
      elected from an all-gather of the ranks' candidate rows (the JAX
      make_sliced_search), the categorical left-bin words riding with
      them. Quantized, the JAX make_scatter_reduce_q: the integer totals
      all-reduced first, then only the two lanes [qg, qh] reduce-scattered
      (int32: the JAX package's int16 wire, where the global sums fit
      it, has no reduction in gloo or NCCL), the count lane rebuilt as
      round(qh_bin * leaf_n / qh_total) -- exact for constant hessians,
      approximate for others, as in JAX.

    Quantized gradients are discretized against the group's scales
    (ops/quantize.py::quantize_gh_pmax, the cap from the global row count
    n_pad, the noise of fold_in(key, rank)); under leaf re-quantization the
    root's and each split's side maxes are max-reduced across the ranks.

    Row sampling: on the fused iteration each rank draws its own bag or
    GOSS sample from fold_in(bag key, rank) over its real rows
    (rank_bag_weights, rank_goss_sample); on the generic one the booster's
    host bag of global row ids is cut to the block. Either way the tree
    grows on the sampled rows alone, gathered to the front of the working
    buffer (``live`` rows), and the router gives every row of the block
    its leaf (the sampled ones then take the partition's). A quantized
    tree without a sample grows on the real rows alone: the packed row
    has no weight word to fence the padding off the count lane. A rank
    whose block holds no rows (few rows over many ranks) grows every tree
    on none (live 0) and joins every collective, as the JAX program's
    alive guard does.

    Every rank ends with the same split records, bit for bit. On the card
    the split step is captured as a CUDA graph with its collectives
    inside when NCCL carries CUDA tensors; under gloo it runs uncaptured
    (the backend decides: distributed/bootstrap.py). Without a process
    group the learner is the serial one on all rows.

    ``train(grad, hess)`` and ``grow`` take this rank's rows' gradients
    (``row_block``) and a host bag of global row ids; the records are the
    JAX learner's over the global rows. Rows past the block's end, up to
    local_n, are padding at weight 0. The records' counts are global, so
    ``kpart.rows_win`` counts the group's rows. ``leaf_rows`` (leaf
    renewal) gathers every rank's leaf ids: global row ids."""

    def __init__(self, config: Config, dataset: Dataset, device="cpu",
                 mesh: Optional[Mesh] = None):
        super().__init__(config, dataset, strategy="compact", device=device)
        self.mesh = mesh or make_mesh(self.device)
        self.grouped = bootstrap.is_initialized()
        w = self.mesh.size
        n = dataset.num_data
        self.local_n = self.mesh.local_n(n)
        self.n_pad = self.local_n * w
        self.row_block = self.mesh.row_block(n)
        lo, hi = self.row_block
        self.n_real = hi - lo
        mode = dp_reduce_mode_env()
        self.scatter_cols = (
            w if (mode != "psum" and dataset.bundle_arrays() is None
                  and not (0.0 < config.feature_fraction_bynode < 1.0)
                  and w > 1) else 0)
        self.slice_cols = -(-self.c_cols // w) if self.scatter_cols else 0
        # this rank's row block of the packed codes, padded to local_n (a
        # copy: the other ranks' rows are freed)
        block = self.codes_pack[lo:hi]
        self.codes_pack = torch.cat([block, block.new_zeros(
            (self.local_n - self.n_real, block.shape[1]))])
        self._row_ids = torch.arange(self.local_n, dtype=torch.int32,
                                     device=self.device)
        self._alive = self._row_ids < self.n_real
        if self.grouped:
            # captured NCCL collectives must go before the communicator
            bootstrap.before_shutdown(self.reset_config)

    # -- the DeviceTreeLearner seams ---------------------------------
    def num_rows(self) -> int:
        return self.local_n

    def pool_cols(self) -> int:
        return self.slice_cols or self.c_cols

    def reduce_hist(self):
        if not self.grouped:
            return None
        if not self.scatter_cols:
            return lambda h, *_: network.all_reduce(h)
        c_pad = self.slice_cols * self.mesh.size

        def pad(h: torch.Tensor) -> torch.Tensor:
            if h.shape[0] < c_pad:
                h = torch.cat([h, h.new_zeros(
                    (c_pad - h.shape[0],) + tuple(h.shape[1:]))])
            return h

        if not self.quant_bits:
            return lambda h, *_: network.reduce_scatter(pad(h), axis=0)

        def scatter_q(h: torch.Tensor, leaf_n: torch.Tensor,
                      qh_total: torch.Tensor) -> torch.Tensor:
            """The JAX make_scatter_reduce_q: two integer lanes on the
            wire, the count lane rebuilt from the hessian lane and the
            leaf's global count."""
            sl = network.reduce_scatter(pad(h[:, :, :2]), axis=0)
            cnt = torch.round(sl[:, :, 1].float() * (
                leaf_n / torch.clamp(qh_total, min=1.0))).to(torch.int32)
            return torch.cat([sl, cnt[:, :, None]], dim=2)
        return scatter_q

    def reduce_root(self, hist0: torch.Tensor):
        if not self.grouped:
            return super().reduce_root(hist0)
        if not self.scatter_cols:
            hist0 = network.all_reduce(hist0)
            return hist0, hist0[0].sum(dim=0)
        # global totals first (the reduced histogram is a column slice)
        totals = network.all_reduce(hist0[0].sum(dim=0))
        return self.reduce_hist()(hist0, totals[2].float(),
                                  totals[1].float()), totals

    def reduce_max(self):
        return network.all_reduce_max if self.grouped else None

    def step_counters(self) -> tuple:
        return ((network, "collectives"), (network, "collective_bytes"))

    def capturable(self) -> bool:
        return self.device.type == "cuda" and (
            not self.grouped or bootstrap.cuda_backend() == "nccl")

    def _quantize(self, grad: torch.Tensor, hess: torch.Tensor,
                  key: torch.Tensor):
        """The tree's quantized rows: (packed int32, s_g, s_h, root_max (2,)
        f32 or None). In a group the JAX _quant_prepare under shard_map:
        the group's scales, the cap from n_pad, this rank's noise, the
        root's stored-int maxes max-reduced (leaf re-quantization)."""
        if not self.grouped:
            return _quant_prepare(grad, hess, key,
                                  quant_bits=self.quant_bits,
                                  quant_renew=self.quant_renew)
        packed, s_g, s_h = quant_ops.quantize_gh_pmax(
            grad, hess, trandom.split(key)[1],
            grad_bits=quant_ops.storage_bits(self.quant_bits,
                                             self.quant_renew),
            n_total=self.n_pad, rank=self.mesh.rank,
            reduce_max=network.all_reduce_max)
        if not self.quant_renew:
            return packed, s_g, s_h, None
        qg, qh = quant_ops.unpack_gh(packed)
        m = torch.stack([qg.abs().max(), qh.abs().max()]).float()
        return packed, s_g, s_h, network.all_reduce_max(m)

    def _search(self):
        if self._scan is not None or not self.scatter_cols:
            return super()._search()
        st = self._statics()
        cs, w, r = self.slice_cols, self.mesh.size, self.mesh.rank
        c_pad, start = cs * w, r * cs
        f_all = self.num_features
        meta = self.meta

        def sl(t: torch.Tensor, fill) -> torch.Tensor:
            t = torch.cat([t, t.new_full((c_pad - f_all,), fill)])
            return t[start:start + cs]

        nb_sl = sl(meta["t_numbins"], 1)
        col_bins = st["col_bins"]
        bins = torch.arange(col_bins, device=self.device)
        hi_local = torch.where(
            bins[None, :] < nb_sl[:, None],
            torch.arange(cs, device=self.device)[:, None] * col_bins
            + bins[None, :], cs * col_bins).long()
        scan, best_row = _tree_helpers(
            nb_sl, sl(meta["t_missing"], 0), sl(meta["t_default"], 0),
            sl(meta["t_monotone"], 0), sl(meta["t_penalty"], 1.0),
            sl(meta["t_elide"], 0), hi_local, max_depth=st["max_depth"],
            l1=st["l1"], l2=st["l2"], max_delta_step=st["max_delta_step"],
            min_data_in_leaf=st["min_data_in_leaf"],
            min_sum_hessian=st["min_sum_hessian"],
            min_gain_to_split=st["min_gain_to_split"],
            f_categorical=sl(meta["t_categorical"], 0),
            cat_statics=st["cat_statics"])

        def search2(col_hist2, sg2, sh2, cnt2, mn2, mx2, fmask,
                    child_depth):
            res, words = scan(col_hist2, sg2, sh2, cnt2, mn2, mx2,
                              sl(fmask, False))
            rows = best_row(res, child_depth)
            rows = torch.cat([rows[:, :B_FEAT], rows[:, B_FEAT:B_FEAT + 1]
                              + float(start), rows[:, B_FEAT + 1:]], dim=1)
            if words is not None:
                rows = torch.cat([rows, words.view(torch.float32)], dim=1)
            cand = network.all_gather(rows)            # (W, N, 12 [+ W])
            win = torch.argmax(cand[:, :, B_GAIN], dim=0)
            sel = cand[win, torch.arange(rows.shape[0], device=rows.device)]
            return sel[:, :12], (None if words is None else
                                 sel[:, 12:].contiguous().view(torch.int32))

        self._scan = (scan, best_row, search2)
        return self._scan

    # -- the rank's tree ------------------------------------------------
    def _pad(self, v: torch.Tensor) -> torch.Tensor:
        """(local_n,) f32 of the block's real rows' (n_real,) values, the
        padding rows at 0 (as given when already local_n long)."""
        v = v.float()
        pad = self.local_n - v.shape[0]
        return torch.cat([v, v.new_zeros(pad)]) if pad else v

    def _fill(self, c, g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
              order: Optional[torch.Tensor], iter_seed: int):
        """The carry's working buffer over the block's local_n rows in
        `order` (None: row order): codes | [g * w, h * w, w] | row id, or,
        quantized, codes | the packed (qg|qh) word of (g * w, h * w) | row
        id, discretized over every row before the gather (the JAX weighted
        layout's integers). Returns the QuantRows (None: float)."""
        cw = self.code_words
        out = c.data
        gw, hw = g * w, h * w
        if self.quant_bits:
            packed, s_g, s_h, root_max = self._quantize(
                gw, hw, trandom.prng_key(iter_seed))
            lanes = [packed]
        else:
            lanes = [gw, hw, w]
        ids = self._row_ids
        codes = self.codes_pack
        if order is not None:
            lanes = [v.index_select(0, order) for v in lanes]
            ids = order.to(torch.int32)
            codes = codes.index_select(0, order)
        out[:, :cw] = codes
        if self.quant_bits:
            out[:, cw] = lanes[0]
            out[:, cw + 1] = ids
            return QuantRows(self.quant_bits,
                             quant_ops.quant_max(self.quant_bits, self.n_pad),
                             s_g, s_h, root_max)
        f = out.view(torch.float32)
        for j, v in enumerate(lanes):
            f[:, cw + j] = v
        out[:, cw + 3] = ids
        return None

    def grow_compact(self, grad, hess, iter_seed: int = 0,
                     w: Optional[torch.Tensor] = None):
        """The compact core's device loop on this rank's rows: `grad`,
        `hess` hold the block's real rows (or all local_n, padding at 0);
        `w` the (local_n,) 0/1 weights of a row sample (None: every real
        row). Returns the records, the block's real rows' leaf ids and k,
        with no host sync."""
        g, h = self._pad(grad), self._pad(hess)
        sampled = w is not None
        w = self._alive.float() if w is None else w * self._alive.float()
        qcap = (quant_ops.quant_max(self.quant_bits, self.n_pad)
                if self.quant_bits else None)
        c, loop = self._device_state(None, qcap)
        self._set_base_mask(c, iter_seed)
        order = None
        if sampled:
            # the sampled rows first, in row order
            order = torch.argsort((w <= 0).to(torch.int32), stable=True)
            live = (w > 0).sum().to(torch.int32).view(1)
        else:
            # quantized, the real rows (its row has no weight word to
            # fence the padding off the count lane); float, every row,
            # the padding at weight 0
            live = torch.full((1,), self.n_real if self.quant_bits
                              else self.local_n, dtype=torch.int32,
                              device=self.device)
        quant = self._fill(c, g, h, w, order, iter_seed)
        self._grow_tree(c, loop, quant, iter_seed, live)
        if sampled:
            base = self._route_all(c)
        else:
            base = torch.zeros(self.local_n, dtype=torch.int64,
                               device=self.device)
        leaf_id = leaf_map(c, live=live, base=base)
        return c.rec, leaf_id[:self.n_real], c.k

    def _route_all(self, c) -> torch.Tensor:
        """(local_n,) int64 leaf of every row of the block from the
        carry's records (the router entry: a sample's other rows)."""
        return route_rows(self.codes_pack, c.rec, c.k,
                          self.meta["t_feature_table"],
                          item_bits=self.item_bits, rec_cat=c.rec_cat,
                          f_cat=self.meta["t_categorical"]
                          if self.cat_words else None).long()

    def grow(self, grad: torch.Tensor, hess: torch.Tensor,
             iter_seed: int = 0, bag_indices=None):
        """One tree from this rank's block's gradients and a host bag of
        global row ids (the generic iteration's, cut to the block; None:
        every row), fetched: (rec (L-1, 13) f32 numpy, the block's leaf
        ids, k)."""
        with telem.phase("grow_dispatch"):
            w = None
            if bag_indices is not None:
                lo, hi = self.row_block
                idx = np.asarray(bag_indices, dtype=np.int64)
                inbag = np.zeros(self.local_n, dtype=np.float32)
                inbag[idx[(idx >= lo) & (idx < hi)] - lo] = 1.0
                w = torch.as_tensor(inbag, device=self.device)
            rec, leaf_id, k = self.grow_compact(grad, hess, iter_seed, w)
        with telem.phase("host_sync"):
            rec_h, k, _ = self.fetch_tree(rec, k)
        return rec_h, leaf_id, k

    def _leaf_id_host(self) -> np.ndarray:
        """Every rank's real rows' leaf ids in rank order: the global row
        -> leaf map (the host all-gather lane; leaf renewal's rows are
        global row ids)."""
        local = self.last_leaf_id.cpu().numpy().astype(
            np.int16 if self.config.num_leaves < 2**15 else np.int32)
        if not self.grouped:
            return local
        from ..io.distributed import allgather_host_array
        return allgather_host_array(local)

    def sample(self, grad: torch.Tensor, hess: torch.Tensor, bag_seed: int,
               goss: bool = False):
        """The fused iteration's sample of this rank's rows from fold_in(
        prng_key(bag_seed), rank): GOSS at the config's top_rate /
        other_rate (rank_goss_sample), else a bag at bagging_fraction
        (rank_bag_weights). Returns the (local_n,) (grad, hess, w) that
        grow_compact takes."""
        cfg = self.config
        key = trandom.prng_key(bag_seed)
        grad, hess = self._pad(grad), self._pad(hess)
        if goss:
            return rank_goss_sample(grad, hess, key, self.mesh.rank,
                                    self.n_real, float(cfg.top_rate),
                                    float(cfg.other_rate))
        return grad, hess, rank_bag_weights(
            key, self.mesh.rank, self.n_real, self.local_n,
            float(cfg.bagging_fraction), grad.device)

    def make_fused_step(self, objective, goss=None, bagging: bool = True):
        """One boosting iteration as one device program on this rank's
        rows (the JAX data-parallel make_fused_step): the block's
        gradients at score + init_score, the rank's own sample (`sample`:
        GOSS when goss is not None, else a bag when `bagging` and bagging
        is on), the tree, its leaf values and the block's score update,
        with no host sync. Returns step(score_row, iter_seed, shrinkage,
        init_score, bag_seed) -> (new_score, rec, leaf_id, k, finite), as
        the serial learner's."""
        cfg = self.config
        L = int(cfg.num_leaves)
        bag_on = (goss is None and bagging and cfg.bagging_freq > 0
                  and cfg.bagging_fraction < 1.0)

        def step(score_row: torch.Tensor, iter_seed: int, shrinkage: float,
                 init_score: float = 0.0, bag_seed: int = 0):
            score = score_row + init_score
            grad, hess = objective.get_gradients(score)
            w = None
            if goss is not None or bag_on:
                grad, hess, w = self.sample(grad, hess, bag_seed,
                                            goss=goss is not None)
            rec, leaf_id, k = self.grow_compact(grad, hess, iter_seed, w)
            lv = leaf_values_from_rec(rec, k, L)
            delta = lv.index_select(0, leaf_id) * shrinkage
            new_score = score + torch.where(k > 0, delta,
                                            torch.zeros_like(delta))
            return (new_score, rec, leaf_id, k,
                    torch.isfinite(new_score).all())
        return step
