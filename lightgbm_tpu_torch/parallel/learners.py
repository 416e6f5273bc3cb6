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

Not ported yet, each refused naming ROADMAP.md section 1, item 5: the
feature- and voting-parallel learners, the host-loop data-parallel
learner (the configs only the host loop takes), quantized gradients and
row sampling on the data-parallel learner, and streamed data-parallel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..distributed import bootstrap
from ..io.dataset import Dataset
from ..models.device_learner import (B_FEAT, B_GAIN, DeviceTreeLearner,
                                     _tree_helpers)
from ..models.serial_learner import SerialTreeLearner
from ..utils import log
from ..utils.envs import dp_reduce_mode_env, host_learner_env
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
        if config.quantized_grad:
            raise _not_yet("quantized_grad with tree_learner=%s" % name,
                           "quantized data-parallel")
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


class DeviceDataParallelTreeLearner(DeviceTreeLearner):
    """The data-parallel learner (JAX parallel/learners.py:692-1233): one
    process per device, rows in ceil blocks over the group (parallel/
    mesh.py), every tree grown by the compact core's device loop on this
    rank's block. Per split each rank builds the smaller child's K1
    histogram over its own rows (the child chosen by the records' global
    counts), partitions its own rows (K4's window entry, the split key)
    and reduces the histogram across the ranks (reference:
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
      them.

    Every rank ends with the same split records, bit for bit. On the card
    the split step is captured as a CUDA graph with its collective inside
    when NCCL carries CUDA tensors; under gloo it runs uncaptured (the
    backend decides: distributed/bootstrap.py). Without a process group
    the learner is the serial one on all rows.

    ``train(grad, hess)`` and ``grow`` take this rank's rows' gradients
    (``row_block``); the records are the JAX learner's over the global
    rows. Rows past the block's end, up to local_n, are padding at weight
    0. The records' counts are global, so ``kpart.rows_win`` counts the
    group's rows."""

    def __init__(self, config: Config, dataset: Dataset, device="cpu",
                 mesh: Optional[Mesh] = None):
        super().__init__(config, dataset, strategy="compact", device=device)
        self.mesh = mesh or make_mesh(self.device)
        self.grouped = bootstrap.is_initialized()
        w = self.mesh.size
        n = dataset.num_data
        self.local_n = self.mesh.local_n(n)
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
            return network.all_reduce
        c_pad = self.slice_cols * self.mesh.size

        def scatter(h: torch.Tensor) -> torch.Tensor:
            if h.shape[0] < c_pad:
                h = torch.cat([h, h.new_zeros(
                    (c_pad - h.shape[0],) + tuple(h.shape[1:]))])
            return network.reduce_scatter(h, axis=0)
        return scatter

    def reduce_root(self, hist0: torch.Tensor):
        if not self.grouped:
            return super().reduce_root(hist0)
        if not self.scatter_cols:
            hist0 = network.all_reduce(hist0)
            return hist0, hist0[0].sum(dim=0)
        # global totals first (the reduced histogram is a column slice)
        totals = network.all_reduce(hist0[0].sum(dim=0))
        return self.reduce_hist()(hist0), totals

    def step_counters(self) -> tuple:
        return ((network, "collectives"), (network, "collective_bytes"))

    def capturable(self) -> bool:
        return self.device.type == "cuda" and (
            not self.grouped or bootstrap.cuda_backend() == "nccl")

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

    def working_buffer(self, grad, hess, out=None, bag_idx=None):
        out = super().working_buffer(grad, hess, out, bag_idx)
        if bag_idx is None and self.local_n > self.n_real:
            out.view(torch.float32)[self.n_real:, self.code_words + 2] = 0.0
        return out

    def grow_compact(self, grad, hess, iter_seed: int = 0, bag_idx=None,
                     oob_idx=None, n_total=None):
        """The compact core's device loop on this rank's rows: `grad`,
        `hess` hold the block's real rows, padded here with zeros at
        weight 0; returns the records, the block's real rows' leaf ids
        and k."""
        if bag_idx is not None:
            raise LightGBMError(
                "bagging with tree_learner=data is not supported by "
                "lightgbm_tpu_torch yet (ROADMAP.md section 1, item 5)")
        grad, hess = grad.float(), hess.float()
        pad = self.local_n - grad.shape[0]
        if pad:
            grad = torch.cat([grad, grad.new_zeros(pad)])
            hess = torch.cat([hess, hess.new_zeros(pad)])
        rec, leaf_id, k = super().grow_compact(grad, hess, iter_seed)
        return rec, leaf_id[:self.n_real], k
