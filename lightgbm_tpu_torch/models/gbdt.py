"""GBDT boosting loop.

Port of lightgbm_tpu/models/gbdt.py (reference: src/boosting/gbdt.cpp
GBDT::TrainOneIter, gbdt_model_text.cpp): boost from average on the first
iteration, objective gradients, one tree per class (K = num_class for
multiclass and multiclassova, grown one after another by the same
learner), leaf renewal for the L1 family (``_renew_tree_output``: each
leaf refit to a percentile of its in-bag residuals on the host),
shrinkage, score update from the learner's row -> leaf map, model text
and prediction. Scores and gradients live on the booster's device as
(K, N) f32 tensors; trees and split records live on the host. Validation sets (``add_valid``) get each tree
by a walk over their binned codes, and are evaluated, with the training
set, by host metrics over fetched scores; ``rollback_one_iter`` takes an
iteration back out of every score.

Two iterations, as in the JAX package: the fused one (``_fused_eligible``:
GBDT or GOSS, one tree per iteration, either strategy, no leaf renewal,
no pos/neg bagging) runs the learner's single-program step -- gradients, the row
sample (bagging or GOSS, drawn on the device), tree, leaf values and
score update on the device -- and makes one device->host copy, the split
records, k and the finite flag; the generic one runs otherwise (K
classes, leaf renewal, pos/neg bagging), and takes over an iteration whose fused tree has no split (the
stop bookkeeping). It samples on the host (``_bagging``, with
``np.random.RandomState``, and ``GOSS._goss_sample``), as the JAX
package's generic iteration does. The JAX package's pipelined form of the
fused iteration is not ported.

DART and RF (``create_boosting``) run the generic iteration, as in the JAX
package: DART drops earlier trees on the host (``DART._drop_trees``) and
rescales them after the new tree (``DART._normalize``); RF grows every
tree from the gradients at the boost-from-average score on a mandatory
bag and keeps the training and validation scores the running average of
its trees, and ``predict_raw`` averages them (``average_output``).

Prediction (``predict``) gives raw or converted scores, leaf indices
(``pred_leaf``), TreeSHAP contributions on the host (``pred_contrib``,
models/treeshap.py) or scores with prediction early stopping
(``pred_early_stop``: chunks of freq x K trees summed in f32 on the device
into f64 host scores, the rows past the margin dropped after each chunk).
``refit_leaves_on`` refits the leaf values on new data in place
(continual/refit.py); every in-place leaf edit drops the cached ensemble.

Data-parallel training (``tree_learner=data``, the learner of
parallel/learners.py): each process holds the whole Dataset (replicated
ingest) and keeps the scores and computes the gradients of its own row
block only (the learner's ``row_block``), from an objective over those
rows; the boost-from-average score comes from an objective over all the
labels. The training scores' host copy (metrics, a custom objective's
input, GetPredict) gathers the blocks of every rank, so the metrics are
those of all rows. Leaf renewal and query groups are refused there.

Robustness and telemetry (the JAX package's seams): ``_compute_gradients``
is the fault-injection boundary (resilience/faults.py; a plan that poisons
gradients keeps the iteration generic); ``on_nonfinite`` guards each
iteration -- the generic one by one isfinite reduction over the gradient
pair (``_guard_gradients``) and a host check of the new tree's leaves
(``_guard_tree``), the fused one by the finite flag that already rides in
the tree's one fetch, read before anything of the iteration is committed.
``capture_state`` / ``restore_state`` carry everything beyond the model
text that a resumed run needs to continue bit for bit
(resilience/checkpoint.py). Each iteration is bracketed for the telemetry
recorder and, with events on, assembled into a flight-recorder record.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..config import Config
from ..io.dataset import Dataset
from ..metrics import create_metrics
from ..objectives import create_objective
from ..objectives.objective import parse_objective_from_model
from ..ops import predict as predict_ops
from ..ops import quantize as quantize_ops
from ..resilience import faults
from ..telemetry import counters as telem_counters
from ..telemetry import recorder as telem
from ..utils import log
from ..utils.log import LightGBMError
from .device_learner import DeviceTreeLearner
from .tree import Tree

K_EPSILON = 1e-15
MODEL_VERSION = "v3"


def _threshold_l1_np(s: float, l1: float) -> float:
    return math.copysign(max(0.0, abs(s) - l1), s)


def _grad_norm_start(grad, hess):
    """Start the flight recorder's L2/max summary of the iteration's
    gradient pair: (sum g^2, max |g|, sum h^2) reduced in f64 on the
    pair's device, the three scalars copied to pinned host memory behind
    the stream. `_grad_norm_read` reads them after the iteration's tree
    fetch, which has waited for that stream already, so the summary adds
    no host sync. Callers gate on telemetry.events.enabled()."""
    g, h = grad.detach().double(), hess.detach().double()
    vals = torch.stack([g.square().sum(),
                        g.abs().max() if g.numel() else g.new_zeros(()),
                        h.square().sum()])
    if vals.device.type != "cuda":
        return vals, None
    host = torch.empty(3, dtype=torch.float64, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _grad_norm_read(pending) -> dict:
    host, done = pending
    if done is not None and not done.query():
        done.synchronize()   # the iteration fetched no tree
    ss, mx, hs = host.tolist()
    return {"grad_l2": math.sqrt(ss), "grad_max_abs": mx,
            "hess_l2": math.sqrt(hs)}


def _copy_scores(updater, arr) -> None:
    """Write stored (K, N) f32 scores into `updater`'s score tensor in
    place (its address kept) and drop its host copy."""
    src = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    dst = updater.score
    if tuple(dst.shape) != tuple(src.shape):
        raise LightGBMError("checkpoint scores of shape %s do not fit the "
                            "booster's %s" % (tuple(src.shape),
                                              tuple(dst.shape)))
    dst.copy_(src)
    updater.score = dst


def _rows_f32(x) -> np.ndarray:
    """Contiguous (N, F) f32 rows (one row from a 1-d input)."""
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    return x.reshape(1, -1) if x.ndim == 1 else x


class ScoreUpdater:
    """Per-dataset raw scores (reference: src/boosting/score_updater.hpp):
    a (K, N) f32 tensor on the booster's device, and its f64 host copy,
    fetched once per score version (every change of the scores drops it,
    so a multi-metric eval of one iteration fetches once)."""

    def __init__(self, dataset: Dataset, num_class: int, device,
                 rows: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        n = dataset.num_data
        init = np.zeros((num_class, n), dtype=np.float32)
        self.has_init_score = dataset.metadata.init_score is not None
        if self.has_init_score:
            s = np.asarray(dataset.metadata.init_score, dtype=np.float32)
            if s.size == n * num_class:
                init = s.reshape(num_class, n)
            else:
                init = np.tile(s.reshape(1, n), (num_class, 1))
        # rows: a data-parallel rank's block [begin, end) -- its scores
        # are those rows' only, and host_scores gathers every rank's
        self.rows = rows
        if rows is not None:
            init = np.ascontiguousarray(init[:, rows[0]:rows[1]])
        self._score = torch.as_tensor(init, device=device)
        self._host: Optional[np.ndarray] = None
        self._binned: Optional[torch.Tensor] = None
        self.fetches = 0            # device -> host copies of the scores

    @property
    def score(self) -> torch.Tensor:
        return self._score

    @score.setter
    def score(self, value: torch.Tensor) -> None:
        self._score = value
        self._host = None

    def _add(self, class_id: int, delta) -> None:
        self._score[class_id] += delta
        self._host = None

    def add_constant(self, val: float, class_id: int) -> None:
        self._add(class_id, float(val))

    def multiply(self, factor: float, class_id: int) -> None:
        self._score[class_id] *= factor
        self._host = None

    def add_tree(self, tree: Tree, class_id: int) -> None:
        """Score update by walking `tree` over the dataset's logical binned
        codes (a validation set, a continued model's trees); a tree read
        from model text gets its bin thresholds from this dataset's
        mappers first."""
        if not tree.inner_valid:
            tree.rebin_inner(self.dataset)
        ds = self.dataset
        if self._binned is None:
            codes = np.asarray(ds.binned)
            if self.rows is not None:
                codes = codes[self.rows[0]:self.rows[1]]
            if codes.dtype != np.uint8:
                codes = codes.astype(np.int32)
            self._binned = torch.from_numpy(codes).to(self._score.device)
            self._real_to_inner = np.full(ds.num_total_features, -1,
                                          dtype=np.int64)
            self._real_to_inner[ds.used_features] = np.arange(
                len(ds.used_features))
        nb, _, db, _, _ = ds.feature_meta_arrays()
        self._add(class_id, predict_ops.predict_binned_tree_values(
            self._binned, self._real_to_inner, db, nb, tree))

    def add_tree_by_leaf_id(self, tree: Tree, leaf_id: torch.Tensor,
                            class_id: int) -> None:
        """Score update from the learner's row -> leaf map: an (N,) gather
        instead of re-walking the tree (reference in-bag AddScore fast
        path, score_updater.hpp:84)."""
        leaf_vals = torch.as_tensor(
            np.asarray(tree.leaf_value[:max(tree.num_leaves, 1)],
                       dtype=np.float32), device=self._score.device)
        self._add(class_id, leaf_vals[leaf_id.clamp(0, tree.num_leaves - 1)])

    def host_scores(self) -> np.ndarray:
        """The f64 host copy of the scores (read-only); a data-parallel
        rank's holds every rank's block, gathered in rank order (a
        collective: every rank calls it at the same point)."""
        if self._host is None:
            self._host = self._score.cpu().numpy().astype(np.float64)
            if self.rows is not None:
                from ..io.distributed import _allgather_host_bytes
                blocks = _allgather_host_bytes(self._host.tobytes())
                k = self._host.shape[0]
                self._host = np.concatenate(
                    [np.frombuffer(b, dtype=np.float64).reshape(k, -1)
                     for b in blocks], axis=1)
            self.fetches += 1
            if telem_counters.is_active():
                telem_counters.incr("transfer_d2h_bytes",
                                    self._score.numel() * 4)
        return self._host


class GBDT:
    """The boosting engine (reference: src/boosting/gbdt.cpp GBDT)."""

    average_output = False

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 device="cpu"):
        self.config = config
        self.train_set = train_set
        self.device = torch.device(device)
        self.models: List[Tree] = []
        self.iter = 0
        self.num_init_iteration = 0
        self.shrinkage_rate = config.learning_rate
        self.objective = None
        self.init_objective = None
        self.row_block = None
        self.valid_names: List[str] = []
        self.valid_updaters: List[ScoreUpdater] = []
        self.valid_metrics: List[List] = []
        self.train_metrics: List = []
        self.label_idx = 0
        self.best_iteration = 0
        self._ensemble_cache: Dict = {}
        self._sentry_retrying = False
        self._ev_grad_norms = None
        if train_set is not None:
            self._init_train(train_set)

    def _init_train(self, train_set: Dataset) -> None:
        cfg = self.config
        telemetry.configure(getattr(cfg, "telemetry", "off"),
                            explicit="telemetry" in getattr(cfg, "raw", {}))
        # the resolved config rides along in any postmortem bundle (a dict
        # assignment -- free when bundling is off)
        telemetry.bundle.set_context(
            "config", {str(k): str(v)
                       for k, v in sorted(getattr(cfg, "raw", {}).items())})
        from ..parallel.learners import (DeviceDataParallelTreeLearner,
                                         create_tree_learner)
        self.learner = create_tree_learner(cfg, train_set, self.device)
        # a data-parallel rank's rows (None: every row)
        if isinstance(self.learner, DeviceDataParallelTreeLearner):
            self.row_block = self.learner.row_block
        # None for a custom objective: the caller passes the gradients.
        # The objective is set up on every label; a data-parallel rank
        # computes its block's gradients with it cut to the block, which
        # keeps what it drew from every label (the label weights, which
        # classes train). The init objective (boost from average) is the
        # uncut one.
        self.objective = create_objective(cfg.objective, cfg)
        self.init_objective = self.objective
        if self.objective is not None:
            if self.row_block is not None:
                self._check_data_parallel()
            self.objective.init(train_set.metadata, train_set.num_data,
                                self.device)
            if self.row_block is not None:
                self.objective = self.objective.row_block(*self.row_block)
            self.num_class = self.objective.num_model_per_iteration
        else:
            self.num_class = max(1, cfg.num_class)
        self.num_tree_per_iteration = self.num_class
        self.score_updater = ScoreUpdater(train_set, self.num_class,
                                          self.device, rows=self.row_block)
        self.num_data = (train_set.num_data if self.row_block is None
                         else self.row_block[1] - self.row_block[0])
        self.train_metrics = create_metrics(cfg.metric, cfg, cfg.objective)
        for m in self.train_metrics:
            m.init(train_set.metadata, train_set.num_data)
        self._class_need_train = [
            self.objective.class_need_train(k) if self.objective else True
            for k in range(self.num_class)]
        self.feature_names = train_set.feature_names
        self.max_feature_idx = train_set.num_total_features - 1
        self._bag_rng = np.random.RandomState(cfg.bagging_seed % (2**31 - 1))
        self._bag_indices: Optional[np.ndarray] = None
        # the last iteration's row -> leaf maps, by class, for rollback
        self._last_leaf_ids: Dict[int, torch.Tensor] = {}
        self._last_leaf_ids_iter = -1
        # the fused steps, by whether they sample by GOSS
        self._fused_step: Optional[Dict[bool, object]] = None

    def _check_data_parallel(self) -> None:
        """Refuse what the data-parallel iteration does not do yet."""
        if self.objective.is_renew_tree_output:
            raise LightGBMError(
                "objective=%s (leaf renewal) with tree_learner=data is not "
                "supported by lightgbm_tpu_torch yet (ROADMAP.md section 1,"
                " item 5)" % self.config.objective)
        if self.train_set.metadata.query_boundaries is not None:
            raise LightGBMError(
                "query groups with tree_learner=data are not supported by "
                "lightgbm_tpu_torch yet (ROADMAP.md section 1, item 5)")

    def _local_rows(self, arr: np.ndarray, k_trees: int) -> np.ndarray:
        """(K, rows) of external (K * N,) gradients: this rank's block
        under data-parallel training (the caller passes every row's)."""
        a = np.array(arr, dtype=np.float32)     # a copy: may be read-only
        if self.row_block is None:
            return a.reshape(k_trees, self.num_data)
        lo, hi = self.row_block
        return a.reshape(k_trees, -1)[:, lo:hi]

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        """Evaluate `valid_set` (binned by the training set's mappers) every
        iteration; the trees that already exist go into its scores."""
        self.valid_names.append(name)
        vu = ScoreUpdater(valid_set, self.num_class, self.device)
        per = max(self.num_tree_per_iteration, 1)
        for it in range(len(self.models) // per):
            for k in range(per):
                vu.add_tree(self.models[it * per + k], k)
        self.valid_updaters.append(vu)
        metrics = create_metrics(self.config.metric, self.config,
                                 self.config.objective)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        self.valid_metrics.append(metrics)

    # ------------------------------------------------------------------
    def _boost_from_average(self, class_id: int, update_scorer: bool) -> float:
        cfg = self.config
        if (self.models or self.score_updater.has_init_score
                or self.objective is None):
            return 0.0
        if not (cfg.boost_from_average or self.train_set.num_features == 0):
            return 0.0
        init_score = self.init_objective.boost_from_score(class_id)
        if abs(init_score) > K_EPSILON:
            if update_scorer:
                self.score_updater.add_constant(init_score, class_id)
                for vu in self.valid_updaters:
                    vu.add_constant(init_score, class_id)
            log.info("Start training from score %f", init_score)
            return init_score
        return 0.0

    def _compute_gradients(self):
        """objective->GetGradients over the (K, N) score tensor: (K, N)
        gradients and hessians (a one-class objective sees the (N,) row).
        This is the gradient fault-injection boundary
        (resilience/faults.py): an active plan may poison the pair, which
        the sentries must then catch."""
        score = self.score_updater.score
        if self.num_class > 1:
            g, h = self.objective.get_gradients(score)
        else:
            g, h = self.objective.get_gradients(score[0])
            g, h = g[None, :], h[None, :]
        plan = faults.active_plan()
        if plan is not None:
            g, h = plan.inject_gradients(g, h, self.iter)
        return g, h

    # -- non-finite sentries (resilience/sentries.py) -------------------
    def _sentry_enabled(self) -> bool:
        return getattr(self.config, "on_nonfinite", "off") \
            not in ("off", "", "none")

    def _apply_nonfinite_policy(self, what: str) -> str:
        """Host-side policy dispatch once a guard trips. Returns 'skip'
        (drop the iteration) or 'retry' (previous iteration rolled back,
        recompute and go again); policy 'raise' raises."""
        from ..resilience.sentries import NonFiniteError
        pol = self.config.on_nonfinite
        if pol == "raise":
            raise NonFiniteError(
                f"non-finite {what} detected at iteration {self.iter}; "
                "set on_nonfinite=skip_iter/rollback to continue instead")
        # only roll back when a previous iteration remains afterwards:
        # rolling back to an EMPTY model would replay boost-from-average
        # with shifted bias bookkeeping
        if pol == "rollback" and self.iter > 0 \
                and len(self.models) > self.num_tree_per_iteration:
            log.warning("non-finite %s at iteration %d: rolling back one "
                        "iteration", what, self.iter)
            telemetry.events.emit("rollback", iteration=self.iter,
                                  what=what, reason="non_finite")
            self.rollback_one_iter()
            return "retry"
        log.warning("non-finite %s at iteration %d: skipping iteration",
                    what, self.iter)
        telemetry.events.emit("skip_iter", iteration=self.iter, what=what,
                              reason="non_finite")
        return "skip"

    def _guard_gradients(self, grad, hess, recompute=None):
        """One isfinite reduction over (grad, hess) (one host bool);
        returns the (possibly recomputed) pair, or None when the iteration
        should be skipped. `recompute` re-derives the pair after a
        rollback (None for a custom objective's gradients, which cannot be
        recomputed here)."""
        if not self._sentry_enabled():
            return grad, hess
        from ..resilience import sentries
        for _ in range(2):
            if sentries.all_finite(grad, hess):
                return grad, hess
            act = self._apply_nonfinite_policy("gradients/hessians")
            if act != "retry" or recompute is None:
                return None
            grad, hess = recompute()
        raise sentries.NonFiniteError(
            f"non-finite gradients persist at iteration {self.iter} "
            "after rollback")

    def _guard_tree(self, tree) -> bool:
        """Host check over the new tree's leaf outputs. True = usable;
        False = drop the tree (policy skip/rollback); raises on 'raise'."""
        if not self._sentry_enabled() or tree.num_leaves <= 1:
            return True
        vals = np.asarray(tree.leaf_value[:tree.num_leaves],
                          dtype=np.float64)
        if np.isfinite(vals).all():
            return True
        from ..resilience.sentries import NonFiniteError
        if self.config.on_nonfinite == "raise":
            raise NonFiniteError(
                f"non-finite leaf outputs at iteration {self.iter}")
        log.warning("non-finite leaf outputs at iteration %d: dropping "
                    "tree", self.iter)
        return False

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training should stop (no tree
        with more than one leaf was produced). External (K * N,)
        gradients and hessians (a custom objective's) take the generic
        iteration. The iteration is one recorder bracket; with events on,
        one flight-recorder record."""
        ev_on = telemetry.events.enabled()
        if ev_on:
            coll0 = (telem_counters.get("collective_dispatches"),
                     telem_counters.get("collective_retries"))
            self._ev_grad_norms = None
        with telem.iteration(self.iter):
            if gradients is None and hessians is None \
                    and self._fused_eligible():
                stop = self._train_one_iter_fused()
            else:
                stop = self._train_one_iter_generic(gradients, hessians)
        if ev_on:
            self._emit_iteration_event(stop, coll0)
        return stop

    def _emit_iteration_event(self, stop: bool, coll0) -> None:
        """Assemble this iteration's flight-recorder record: recorder
        phases, grad/hess norms (generic iteration), the quantization
        plan, the stream's overlap, peak and H2D bytes, and collective
        deltas. Events-gated -- the off path never reaches here."""
        rec: Dict = {}
        last = telem.last_iteration()
        if last is not None:
            rec.update(last)
        else:
            rec["iteration"] = self.iter - (0 if stop else 1)
        if stop:
            rec["stop"] = True
        if self._ev_grad_norms is not None:
            rec["grad_norms"] = _grad_norm_read(self._ev_grad_norms)
        cfg = self.config
        if getattr(cfg, "quantized_grad", False):
            renew = bool(getattr(cfg, "quant_renew", False))
            rec["quant"] = {
                "grad_bits": int(cfg.grad_bits), "renew": renew,
                "storage_bits": quantize_ops.storage_bits(
                    int(cfg.grad_bits), renew)}
        shard = getattr(self.learner, "_shard", None)
        if shard is not None:
            overlap = shard.overlap_fraction()
            rec["stream"] = {
                "overlap_fraction": (None if overlap is None
                                     else round(overlap, 4)),
                "peak_bytes": int(getattr(shard, "peak_bytes", 0)),
                "h2d_bytes": int(getattr(shard, "h2d_bytes", 0))}
        d0, r0 = coll0
        dispatches = telem_counters.get("collective_dispatches") - d0
        retries = telem_counters.get("collective_retries") - r0
        if dispatches or retries:
            rec["collectives"] = {"dispatches": int(dispatches),
                                  "retries": int(retries)}
        telemetry.record_iteration(rec)

    def _bagging(self, iteration: int) -> Optional[np.ndarray]:
        """The generic iteration's row sample on the host (reference
        gbdt.cpp:210-276, the JAX package's GBDT._bagging): sorted row ids,
        drawn anew every bagging_freq iterations, per class under pos/neg
        bagging on a binary objective; None without bagging."""
        cfg = self.config
        n = self.num_data
        pos_neg = cfg.pos_bagging_fraction < 1.0 \
            or cfg.neg_bagging_fraction < 1.0
        if cfg.bagging_freq <= 0 or (cfg.bagging_fraction >= 1.0
                                     and not pos_neg):
            return None
        if iteration % cfg.bagging_freq != 0 \
                and self._bag_indices is not None:
            return self._bag_indices
        if pos_neg and self.objective is not None \
                and self.objective.name == "binary":
            pos = np.nonzero(self.train_set.label > 0)[0]
            neg = np.nonzero(self.train_set.label <= 0)[0]
            kp = max(1, int(len(pos) * cfg.pos_bagging_fraction))
            kn = max(1, int(len(neg) * cfg.neg_bagging_fraction))
            idx = np.concatenate([
                self._bag_rng.choice(pos, kp, replace=False),
                self._bag_rng.choice(neg, kn, replace=False)])
        else:
            k = max(1, int(n * cfg.bagging_fraction))
            idx = self._bag_rng.choice(n, k, replace=False)
        idx = np.sort(idx).astype(np.int32)
        self._bag_indices = idx
        return idx

    def _fused_eligible(self) -> bool:
        """Whether the single-program device iteration applies: GBDT or
        GOSS on the device learner (the host-loop learner runs the generic
        iteration), one tree per iteration that trains, on either strategy
        (each grows its tree in its device loop), no leaf renewal (its
        percentiles run on the host) and no pos/neg bagging (its bag is
        drawn on the host), and not under stream_mode (the streamed
        assembly is a host loop of transfers per tree, with no seam in the
        fused step), nor while a fault plan poisons gradients (they inject
        at the host boundary, _compute_gradients), as in the JAX
        package."""
        if getattr(self.config, "stream_mode", "off") != "off":
            return False
        plan = faults.active_plan()
        if plan is not None and plan.has_gradient_faults:
            return False
        return (self.__class__ in (GBDT, GOSS)
                and isinstance(self.learner, DeviceTreeLearner)
                and self.objective is not None
                and not self.objective.is_renew_tree_output
                and self.num_tree_per_iteration == 1
                and self._class_need_train[0]
                and self.train_set.num_features > 0
                and self.config.pos_bagging_fraction >= 1.0
                and self.config.neg_bagging_fraction >= 1.0)

    def _fused_goss(self):
        """GOSS's sampling parameters for the fused step; None for GBDT
        (GOSS overrides)."""
        return None

    def _train_one_iter_fused(self) -> bool:
        """One boosting iteration as one device program and one small
        fetch (DeviceTreeLearner.make_fused_step). The first iteration's
        boost-from-average score is added inside the step, so an iteration
        without a split leaves the score as it was and the generic path
        redoes it with the reference's stop bookkeeping. The bag seed is
        the JAX package's: bagging_seed + iter // bagging_freq (a bag kept
        for bagging_freq iterations), + iter under GOSS. The validation
        sets get the tree with that score as its bias, at
        materialization.

        With on_nonfinite set, the policy is decided from the finite flag
        of the same fetch before anything is committed: skip_iter commits
        no tree and no training or validation score (iter advances),
        rollback takes the previous iteration back and redoes this one
        once; a second failure raises."""
        cfg = self.config
        with telem.phase("boost_avg"):
            init_score = self._boost_from_average(0, False)
        goss_params = self._fused_goss()
        if self._fused_step is None:
            self._fused_step = {}
        fkey = goss_params is not None
        if fkey not in self._fused_step:
            # GOSS replaces bagging: its warm-up trains on every row
            self._fused_step[fkey] = self.learner.make_fused_step(
                self.objective, goss=goss_params,
                bagging=not isinstance(self, GOSS))
        freq = 1 if goss_params is not None else max(cfg.bagging_freq, 1)
        bag_seed = (cfg.bagging_seed + self.iter // freq) % (2**31 - 1)
        with telem.phase("grow_dispatch"):
            new_score, rec, leaf_id, k, finite = self._fused_step[fkey](
                self.score_updater.score[0], self.iter, self.shrinkage_rate,
                init_score, bag_seed)
        telemetry.note_grow_dispatches(1.0, trees=1.0)
        with telem.phase("host_sync"):
            rec_h, k, (finite,) = self.learner.fetch_tree(rec, k, finite)
        act = None
        if self._sentry_enabled():
            # the flag came in the tree's one fetch: deciding adds no sync
            with telem.phase("sentry"):
                if not finite and self._sentry_retrying:
                    from ..resilience.sentries import NonFiniteError
                    raise NonFiniteError(
                        "non-finite fused iteration outputs persist at "
                        "iteration %d after rollback" % self.iter)
                if not finite:
                    act = self._apply_nonfinite_policy(
                        "fused iteration outputs")
        if act is not None:
            if act == "retry":
                self._sentry_retrying = True
                try:
                    return self._train_one_iter_fused()
                finally:
                    self._sentry_retrying = False
            self.iter += 1      # skip: nothing committed
            return False
        with telem.phase("tree_replay"):
            stopped = self._materialize_one(rec_h, k, leaf_id, init_score)
        if stopped:
            return self._train_one_iter_generic()
        if not finite:
            log.warning("Non-finite training scores after iteration %d",
                        self.iter)
        with telem.phase("score_update"):
            self.score_updater.score = new_score[None]
        self.iter += 1
        return False

    def _materialize_one(self, rec_h: np.ndarray, k: int,
                         leaf_id: torch.Tensor, init_score: float) -> bool:
        """Replay a fused iteration's records into a host tree and append
        it; True (and nothing appended) when the tree has no split."""
        if k == 0:
            return True
        tree = self.learner.replay_tree(rec_h, k, self.learner.last_rec_cat)
        tree.apply_shrinkage(self.shrinkage_rate)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        self.learner.last_leaf_id = leaf_id
        self.learner.stats.trees += 1
        self._last_leaf_ids[0] = leaf_id
        self._last_leaf_ids_iter = self.iter
        for vu in self.valid_updaters:
            vu.add_tree(tree, 0)
        self.models.append(tree)
        return False

    def _train_one_iter_generic(self, gradients=None, hessians=None) -> bool:
        k_trees, n = self.num_tree_per_iteration, self.num_data
        with telem.phase("gradient"):
            if gradients is None or hessians is None:
                init_scores = [self._boost_from_average(k, True)
                               for k in range(k_trees)]
                grad, hess = self._compute_gradients()
            else:
                init_scores = [0.0] * k_trees
                grad, hess = (torch.as_tensor(
                    self._local_rows(a, k_trees), device=self.device)
                    for a in (gradients, hessians))
            guarded = self._guard_gradients(
                grad, hess,
                self._compute_gradients if gradients is None else None)
        if guarded is None:
            self.iter += 1   # skipped: seeds keep moving, no tree / score
            return False
        grad, hess = guarded
        if telemetry.events.enabled():
            self._ev_grad_norms = _grad_norm_start(grad, hess)
        with telem.phase("bagging"):
            grad, hess, bag_indices = self._sample(grad, hess)
        should_continue = False
        sentry_dropped = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(2)
            if self._class_need_train[k] and self.train_set.num_features > 0:
                new_tree = self.learner.train(
                    grad[k], hess[k], bag_indices,
                    iter_seed=self.iter * self.num_tree_per_iteration + k)
                if not self._guard_tree(new_tree):
                    new_tree = Tree(2)
                    sentry_dropped = True
            if new_tree.num_leaves > 1:
                should_continue = True
                if (self.objective is not None
                        and self.objective.is_renew_tree_output):
                    self._renew_tree_output(new_tree, k)
                new_tree.apply_shrinkage(self.shrinkage_rate)
                self._update_score(new_tree, k)
                if abs(init_scores[k]) > K_EPSILON:
                    new_tree.add_bias(init_scores[k])
            elif len(self.models) < self.num_tree_per_iteration:
                output = (self.init_objective.boost_from_score(k)
                          if not self._class_need_train[k]
                          and self.objective is not None
                          else init_scores[k])
                new_tree.as_constant_tree(output)
                self.score_updater.add_constant(output, k)
                for vu in self.valid_updaters:
                    vu.add_constant(output, k)
            self.models.append(new_tree)

        if not should_continue:
            if sentry_dropped and \
                    len(self.models) > self.num_tree_per_iteration:
                # every tree of this iteration was dropped by the sentry:
                # a skipped iteration, not the end of training
                del self.models[-self.num_tree_per_iteration:]
                self.iter += 1
                return False
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter += 1
        return False

    def _sample(self, grad, hess):
        """The generic iteration's rows: (grad, hess, bag_indices) by
        _bagging (GOSS overrides)."""
        return grad, hess, self._bagging(self.iter)

    def _update_score(self, tree: Tree, class_id: int) -> None:
        """The training scores from the learner's row -> leaf map (kept for
        rollback: it routes exactly as the partition did), or by walking
        the tree when the learner keeps none (the host-loop learner); the
        validation sets' by walking the tree."""
        with telem.phase("score_update"):
            self._update_score_inner(tree, class_id)

    def _update_score_inner(self, tree: Tree, class_id: int) -> None:
        leaf_id = self.learner.last_leaf_id
        if leaf_id is not None:
            self.score_updater.add_tree_by_leaf_id(tree, leaf_id, class_id)
            self._last_leaf_ids[class_id] = leaf_id
            self._last_leaf_ids_iter = self.iter
        else:
            self.score_updater.add_tree(tree, class_id)
            self._last_leaf_ids.pop(class_id, None)
        for vu in self.valid_updaters:
            vu.add_tree(tree, class_id)

    def _renew_tree_output(self, tree: Tree, class_id: int) -> None:
        """Leaf re-fit of the L1 family (reference
        serial_tree_learner.cpp:855-893 RenewTreeOutput; the JAX package's
        GBDT._renew_tree_output): each leaf's value becomes the objective's
        percentile of its in-bag rows' residuals label - score, in f64 from
        the f32 training scores before the tree is added (one fetch of the
        scores, counted in the updater's fetches; the learner's leaf map,
        one more host sync). MAPE weighs rows by its leaf_renew_weight,
        the others by the dataset's weights."""
        scores = self.score_updater.host_scores()[class_id]
        label = np.asarray(self.train_set.label, dtype=np.float64)
        weights = getattr(self.objective, "leaf_renew_weight",
                          self.train_set.metadata.weight)
        for leaf in range(tree.num_leaves):
            rows = self.learner.leaf_rows(leaf)
            if len(rows) == 0:
                continue
            tree.set_leaf_output(leaf, self.objective.renew_leaf_output(
                label[rows] - scores[rows],
                weights[rows] if weights is not None else None))

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees out of the model and the scores
        (reference gbdt.cpp:453 RollbackOneIter)."""
        if self.iter <= 0:
            return
        self.invalidate_ensemble_cache()
        per = self.num_tree_per_iteration
        for k in range(per):
            tree = self.models[len(self.models) - per + k]
            tree.apply_shrinkage(-1.0)
            leaf_id = (self._last_leaf_ids.get(k)
                       if self._last_leaf_ids_iter == self.iter - 1 else None)
            if leaf_id is not None and tree.num_leaves > 1:
                self.score_updater.add_tree_by_leaf_id(tree, leaf_id, k)
            else:
                self.score_updater.add_tree(tree, k)
            for vu in self.valid_updaters:
                vu.add_tree(tree, k)
        self._last_leaf_ids.clear()
        del self.models[-per:]
        self.iter -= 1

    # -- serving drift baseline (serving/drift.py) ------------------------
    def drift_baseline(self) -> Optional[Dict]:
        """Training-time drift baseline for serving: per-feature bin
        occupancy over the train set plus the *converted* train-score
        distribution (the transform serving applies by default, so served
        predictions compare directly). Cached after the first call; None
        for a booster without a train set. One fetch of the (K, N) scores,
        converted on the device. The CLI writes it to a
        ``<model>.drift.json`` sidecar; the model text never changes."""
        if getattr(self, "train_set", None) is None \
                or getattr(self, "score_updater", None) is None:
            return None
        cached = getattr(self, "_drift_baseline", None)
        if cached is not None:
            return cached
        from ..serving import drift as serve_drift
        raw = self.score_updater.score
        if self.row_block is not None:
            # every rank's rows (a collective on every rank)
            raw = torch.as_tensor(self.score_updater.host_scores(),
                                  dtype=torch.float32, device=raw.device)
        if self.objective is not None:
            raw = self.objective.convert_output(raw)
        self._drift_baseline = serve_drift.compute_baseline(
            self.train_set, scores=raw.cpu().numpy())
        return self._drift_baseline

    # -- training-state capture / restore (resilience/checkpoint.py) -----
    def capture_state(self) -> Dict:
        """Live training state beyond the model text: everything a resumed
        run needs to continue bit for bit (the JAX package's keys, so a
        checkpoint moves between the packages). The scores come back as
        (K, N) f32 host arrays (one fetch per dataset)."""
        if getattr(self, "_bag_rng", None) is None:
            log.fatal("checkpointing requires a booster constructed with "
                      "a train_set (model-only boosters have no training "
                      "state; use save_model instead)")
        st: Dict = {
            "iter": int(self.iter),
            "shrinkage_rate": float(self.shrinkage_rate),
            "best_iteration": int(self.best_iteration),
            "num_init_iteration": int(self.num_init_iteration),
            "bag_rng": self._bag_rng.get_state(),
            "bag_indices": (None if self._bag_indices is None
                            else np.asarray(self._bag_indices)),
            "train_score": self.score_updater.score.cpu().numpy().copy(),
            "valid_scores": [vu.score.cpu().numpy().copy()
                             for vu in self.valid_updaters],
        }
        if isinstance(self, DART):
            st["dart"] = {"tree_weights": list(self._tree_weights),
                          "sum_weight": float(self._sum_weight),
                          "drop_rng": self._drop_rng.get_state()}
        stream = getattr(self.learner, "stream_state", lambda: None)()
        if stream is not None:
            st["stream"] = stream
        return st

    def restore_state(self, st: Dict) -> None:
        """Inverse of capture_state, applied after the model trees have
        been restored. Scores come back bit for bit from the stored f32
        arrays, copied into the score tensors in place (NOT replayed
        through the trees: a replay re-associates the float adds and the
        boost-from-average constant). The learner's stream state goes to
        its shard, which exists from the learner's construction, so a
        restore before the first tree takes effect at that tree."""
        if getattr(self, "_bag_rng", None) is None:
            log.fatal("restoring a checkpoint requires a booster "
                      "constructed with a train_set")
        self.iter = int(st["iter"])
        self.shrinkage_rate = float(st["shrinkage_rate"])
        self.best_iteration = int(st["best_iteration"])
        self.num_init_iteration = int(st["num_init_iteration"])
        self._bag_rng.set_state(st["bag_rng"])
        self._bag_indices = (None if st.get("bag_indices") is None
                             else np.asarray(st["bag_indices"],
                                             dtype=np.int32))
        if st.get("train_score") is not None:
            _copy_scores(self.score_updater, st["train_score"])
        vs = st.get("valid_scores") or []
        if vs and len(vs) == len(self.valid_updaters):
            for vu, arr in zip(self.valid_updaters, vs):
                _copy_scores(vu, arr)
        elif self.valid_updaters:
            log.warning(
                "checkpoint carries %d valid-set scores, booster has %d "
                "valid sets: rebuilding scores by tree replay", len(vs),
                len(self.valid_updaters))
            per = max(self.num_tree_per_iteration, 1)
            for vu in self.valid_updaters:
                vu.score = torch.zeros_like(vu.score)
                for it in range(len(self.models) // per):
                    for k in range(per):
                        vu.add_tree(self.models[it * per + k], k)
        if "dart" in st and isinstance(self, DART):
            d = st["dart"]
            self._tree_weights = list(d["tree_weights"])
            self._sum_weight = float(d["sum_weight"])
            self._drop_rng.set_state(d["drop_rng"])
        if st.get("stream") is not None and hasattr(
                self.learner, "load_stream_state"):
            self.learner.load_stream_state(st["stream"])
        self._last_leaf_ids.clear()
        self._last_leaf_ids_iter = -1
        self.invalidate_ensemble_cache()

    # ------------------------------------------------------------------
    def eval_metrics(self, only: Optional[str] = None):
        """(dataset_name, metric_name, value, higher_better) tuples of the
        training metrics, then of each validation set's (`only`: of the
        dataset of that name alone); metrics run on the host over each
        dataset's fetched scores."""
        out = []
        sets = [("training", self.score_updater, self.train_metrics)]
        sets += zip(self.valid_names, self.valid_updaters,
                    self.valid_metrics)
        for dname, updater, metrics in sets:
            if not metrics or only not in (None, dname):
                continue
            scores = updater.host_scores()
            s = scores[0] if self.num_class == 1 else scores
            for m in metrics:
                for name, val in zip(m.names, m.eval(s, self.objective)):
                    out.append((dname, name, val, m.higher_better))
        return out

    def num_trees(self) -> int:
        return len(self.models)

    @property
    def current_iteration(self) -> int:
        return len(self.models) // max(self.num_tree_per_iteration, 1)

    def invalidate_ensemble_cache(self) -> None:
        """Drop the cached ensemble: its key sees the model's length and
        last tree, not leaf values changed in place (DART's rescaling)."""
        self._ensemble_cache = {}

    def ensemble_arrays(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0, bucket: bool = False):
        """Cached (EnsembleArrays, tree_class, n_models) for the model
        slice; keyed on the model length and last tree, so growth misses.
        bucket=True pads every axis to a power of two (the serving
        predictor's shapes, `trees_to_arrays`); tree_class is a host
        tensor either way, padding trees mapped to class 0."""
        models = self._used_models(num_iteration, start_iteration)
        if not models:
            return None, None, 0
        key = (len(self.models), id(self.models[-1]), start_iteration,
               len(models), bucket)
        hit = self._ensemble_cache.get(key)
        if hit is None:
            arrays = predict_ops.trees_to_arrays(models, self.device,
                                                 bucket=bucket)
            tc = predict_ops.padded_tree_class(
                arrays, np.arange(len(models)) % self.num_tree_per_iteration)
            hit = (arrays, tc, len(models))
            # one slice per form (bucketed or not): a stale slice's
            # device tensors go with it
            self._ensemble_cache = {k: v for k, v in
                                    self._ensemble_cache.items()
                                    if k[-1] != bucket}
            self._ensemble_cache[key] = hit
        return hit

    def predict_raw(self, x, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> np.ndarray:
        """(N, K) raw scores over raw feature values; with average_output
        (a random forest) the mean over the iterations used."""
        x = _rows_f32(x)
        arrays, tc, n_models = self.ensemble_arrays(num_iteration,
                                                    start_iteration)
        if not n_models:
            return np.zeros((x.shape[0], self.num_class))
        out = predict_ops.predict_raw_ensemble(
            torch.as_tensor(x, device=self.device), arrays, tc,
            self.num_class)
        out = out.cpu().numpy().astype(np.float64)
        if self.average_output:
            out /= max(1, n_models // self.num_tree_per_iteration)
        return out

    def predict_leaf(self, x, num_iteration: Optional[int] = None,
                     start_iteration: int = 0) -> np.ndarray:
        """(N, T) int32 leaf index of every row in every tree used, walked
        on the device in tree chunks, each fetched as it is done."""
        x = _rows_f32(x)
        arrays, _, n_models = self.ensemble_arrays(num_iteration,
                                                   start_iteration)
        out = np.zeros((x.shape[0], n_models), dtype=np.int32)
        if not n_models:
            return out
        xt = torch.as_tensor(x, device=self.device)
        for a, b, leaves in predict_ops.predict_leaf_chunks(xt, arrays):
            out[:, a:b] = leaves.to(torch.int32).cpu().numpy()
        return out

    def predict_raw_early_stop(self, x, num_iteration=None, freq: int = 10,
                               margin: float = 10.0,
                               start_iteration: int = 0) -> np.ndarray:
        """Raw scores with prediction early stopping (reference:
        src/boosting/prediction_early_stop.cpp): after every `freq`
        iterations' trees, rows whose margin exceeds `margin` stop
        accumulating -- binary 2 |score|, multiclass top1 - top2. Each
        chunk of freq x K trees (a slice of the cached ensemble, walked to
        the chunk's own depth) is an f32 sum on the device over the rows
        still active, added into f64 host scores. The margin test reads
        the running sums, as LightGBM's PredictRaw applies it; with
        average_output (a random forest) each row's sum is then divided by
        the iterations that row summed, so a row that never stops equals
        predict_raw. ``last_early_stop_trees`` keeps the trees each row
        summed."""
        x = _rows_f32(x)
        models = self._used_models(num_iteration, start_iteration)
        arrays, tc, n_models = self.ensemble_arrays(num_iteration,
                                                    start_iteration)
        n = x.shape[0]
        scores = np.zeros((n, self.num_class))
        trees_used = np.zeros(n, dtype=np.int64)
        xt = torch.as_tensor(x, device=self.device)
        active = np.arange(n)
        step = max(1, freq) * self.num_tree_per_iteration
        for start in range(0, n_models, step):
            if len(active) == 0:
                break
            end = min(start + step, n_models)
            xa = xt if len(active) == n else xt.index_select(
                0, torch.as_tensor(active, device=self.device))
            part = predict_ops.tree_slice(
                arrays, start, end,
                depth=max(t.depth() for t in models[start:end]))
            out = predict_ops.predict_raw_ensemble(xa, part, tc[start:end],
                                                   self.num_class)
            scores[active] += out.cpu().numpy()
            trees_used[active] += end - start
            if self.num_class == 1:
                m = 2.0 * np.abs(scores[active, 0])
            else:
                srt = np.sort(scores[active], axis=1)
                m = srt[:, -1] - srt[:, -2]
            active = active[m <= margin]
        self.last_early_stop_trees = trees_used
        if self.average_output:
            scores /= np.maximum(
                1, trees_used // self.num_tree_per_iteration)[:, None]
        return scores

    def predict(self, x, num_iteration=None, raw_score=False,
                pred_leaf=False, pred_contrib=False, start_iteration=0,
                pred_early_stop=False, pred_early_stop_freq=10,
                pred_early_stop_margin=10.0):
        if pred_leaf:
            return self.predict_leaf(x, num_iteration, start_iteration)
        if pred_contrib:
            return self.predict_contrib(x, num_iteration)
        if pred_early_stop:
            raw = self.predict_raw_early_stop(
                x, num_iteration, pred_early_stop_freq,
                pred_early_stop_margin, start_iteration)
        else:
            raw = self.predict_raw(x, num_iteration, start_iteration)
        if raw_score:
            return raw[:, 0] if self.num_class == 1 else raw
        if self.objective is not None:
            out = self.objective.convert_output(
                torch.as_tensor(raw.T.astype(np.float32))).numpy().T
        else:
            out = raw
        return out[:, 0] if self.num_class == 1 else out

    def predict_contrib(self, x, num_iteration=None) -> np.ndarray:
        """TreeSHAP feature contributions (reference: tree.cpp:669-713
        PredictContrib), on the host."""
        from .treeshap import predict_contrib
        return predict_contrib(self, x, num_iteration)

    def _used_models(self, num_iteration, start_iteration=0) -> List[Tree]:
        total_iter = len(self.models) // max(self.num_tree_per_iteration, 1)
        start_iteration = max(0, min(start_iteration, total_iter))
        start = start_iteration * self.num_tree_per_iteration
        if num_iteration is not None and num_iteration > 0:
            end = min((start_iteration + num_iteration)
                      * self.num_tree_per_iteration, len(self.models))
        else:
            end = len(self.models)
        return self.models[start:end]

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        out = np.zeros(self.max_feature_idx + 1, dtype=np.float64)
        for tree in self._used_models(iteration):
            for node in range(tree.num_leaves - 1):
                if importance_type == "split":
                    out[tree.split_feature[node]] += 1.0
                elif tree.split_gain[node] > 0:
                    out[tree.split_feature[node]] += tree.split_gain[node]
        return out

    def refit_leaves(self, leaf_preds: np.ndarray, decay_rate: float) -> None:
        """Refit leaf values keeping the structure (reference:
        gbdt.cpp:298-321 RefitTree + FitByExistingTree): new value =
        decay * old + (1 - decay) * the regularized leaf output of the
        gradients at this booster's own training scores."""
        grad, hess = self._compute_gradients()
        self._refit_leaves_apply(leaf_preds, grad, hess, decay_rate)

    def refit_leaves_on(self, metadata, leaf_preds: np.ndarray,
                        decay_rate: float) -> None:
        """Refit on new rows in place: the gradients of the objective at a
        zero score over `metadata` (io.dataset.Metadata of the new rows;
        the objective reads nothing else, so the rows need no binning),
        then one leaf update of this model. The objective is the model's
        own (a model read from text keeps its objective line) or, without
        one, the config's."""
        cfg = self.config
        if self.objective is not None:
            obj = parse_objective_from_model(self.objective.to_string(),
                                             copy.deepcopy(cfg))
        elif cfg.objective != "none":
            obj = create_objective(cfg.objective, cfg)
        else:
            raise ValueError("refit requires an objective "
                             "(objective=none has no gradients)")
        obj.init(metadata, metadata.num_data, self.device)
        num_class = obj.num_model_per_iteration
        score = torch.zeros((num_class, metadata.num_data),
                            dtype=torch.float32, device=self.device)
        if num_class == 1:
            g, h = obj.get_gradients(score[0])
            g, h = g[None, :], h[None, :]
        else:
            g, h = obj.get_gradients(score)
        self._refit_leaves_apply(leaf_preds, g, h, decay_rate,
                                 num_tree_per_iteration=num_class)

    def _refit_leaves_apply(self, leaf_preds, grad, hess,
                            decay_rate: float,
                            num_tree_per_iteration: Optional[int] = None
                            ) -> None:
        """The refit's tail: drop the cached ensemble, then the device
        sums (continual/refit.py) or, with LGBM_TPU_HOST_REFIT=1, the host
        loop."""
        per_iter = (num_tree_per_iteration if num_tree_per_iteration
                    else self.num_tree_per_iteration)
        self.invalidate_ensemble_cache()
        from ..continual import refit as continual_refit
        cfg = self.config
        if continual_refit.device_refit_enabled():
            continual_refit.refit_leaves_device(
                self.models, leaf_preds, grad, hess,
                lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
                max_delta_step=cfg.max_delta_step, decay_rate=decay_rate,
                shrinkage_rate=self.shrinkage_rate,
                num_tree_per_iteration=per_iter)
            return
        self._refit_leaves_host(leaf_preds, grad, hess, decay_rate,
                                per_iter)

    def _refit_leaves_host(self, leaf_preds, grad, hess,
                           decay_rate: float,
                           num_tree_per_iteration: int) -> None:
        """The host per-leaf loop (the JAX package's), kept as the device
        sums' oracle: f32 sums of each leaf's rows."""
        g = grad.cpu().numpy()
        h = hess.cpu().numpy()
        cfg = self.config
        for ti, tree in enumerate(self.models):
            k = ti % num_tree_per_iteration
            leaves = leaf_preds[:, ti]
            for leaf in range(tree.num_leaves):
                rows = np.nonzero(leaves == leaf)[0]
                if len(rows) == 0:
                    continue
                sg = float(g[k][rows].sum())
                sh = float(h[k][rows].sum())
                out = -_threshold_l1_np(sg, cfg.lambda_l1) \
                    / (sh + cfg.lambda_l2)
                if cfg.max_delta_step > 0:
                    out = float(np.clip(out, -cfg.max_delta_step,
                                        cfg.max_delta_step))
                old = float(tree.leaf_value[leaf])
                tree.set_leaf_output(
                    leaf, decay_rate * old
                    + (1.0 - decay_rate) * out * self.shrinkage_rate)

    # -- model serialization -------------------------------------------
    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        """reference: gbdt_model_text.cpp:250 SaveModelToString; the same
        text as the JAX package for the same trees and parameters."""
        lines = ["tree", f"version={MODEL_VERSION}",
                 f"num_class={self.num_class}",
                 f"num_tree_per_iteration={self.num_tree_per_iteration}",
                 f"label_index={self.label_idx}",
                 f"max_feature_idx={self.max_feature_idx}"]
        if self.objective is not None:
            lines.append(f"objective={self.objective.to_string()}")
        if self.average_output:
            lines.append("average_output")
        lines.append("feature_names=" + " ".join(self.feature_names))
        if self.config.monotone_constraints:
            lines.append("monotone_constraints=" + " ".join(
                str(c) for c in self.config.monotone_constraints))
        feature_infos = (self.train_set.feature_infos() if self.train_set
                         else getattr(self, "_feature_infos", []))
        lines.append("feature_infos=" + " ".join(feature_infos))

        models = self._used_models(
            num_iteration if num_iteration > 0 else None, start_iteration)
        tree_strs = [f"Tree={i}\n" + tree.to_string() + "\n"
                     for i, tree in enumerate(models)]
        lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
        lines.append("")
        body = "\n".join(lines) + "\n" + "".join(tree_strs)
        body += "end of trees\n"
        imp = self.feature_importance("split")
        pairs = [(int(imp[i]), self.feature_names[i])
                 for i in range(len(imp)) if imp[i] > 0]
        pairs.sort(key=lambda p: -p[0])
        body += "\nfeature importances:\n"
        for v, name in pairs:
            body += f"{name}={v}\n"
        body += "\nparameters:\n" + self.config.to_string() + "\n"
        body += "end of parameters\n"
        return body

    @classmethod
    def load_model_from_string(cls, text: str, config: Optional[Config] = None,
                               device="cpu") -> "GBDT":
        """reference: gbdt_model_text.cpp:365 LoadModelFromString."""
        from ..objectives.objective import parse_objective_from_model
        config = config or Config()
        booster = cls(config, None, device=device)
        header, _, rest = text.partition("Tree=0")
        kv = {}
        for line in header.splitlines():
            if "=" in line:
                k, _, v = line.partition("=")
                kv[k.strip()] = v.strip()
        booster.num_class = int(kv.get("num_class", 1))
        booster.num_tree_per_iteration = int(
            kv.get("num_tree_per_iteration", 1))
        booster.label_idx = int(kv.get("label_index", 0))
        booster.max_feature_idx = int(kv.get("max_feature_idx", 0))
        booster.feature_names = kv.get("feature_names", "").split()
        booster._feature_infos = kv.get("feature_infos", "").split()
        booster.average_output = "average_output" in header.split("\n")
        if "objective" in kv:
            config.num_class = booster.num_class
            booster.objective = parse_objective_from_model(kv["objective"],
                                                           config)
        tree_blocks = ("Tree=0" + rest).split("end of trees")[0]
        for chunk in tree_blocks.split("Tree="):
            chunk = chunk.strip()
            if not chunk:
                continue
            body = chunk.split("\n", 1)[1] if "\n" in chunk else ""
            booster.models.append(Tree.from_string(body))
        booster.num_init_iteration = (len(booster.models)
                                      // max(booster.num_tree_per_iteration, 1))
        return booster

    @classmethod
    def load_model(cls, filename: str, config: Optional[Config] = None,
                   device="cpu") -> "GBDT":
        from ..io.file_io import read_text
        return cls.load_model_from_string(read_text(filename), config,
                                          device=device)

    def save_model(self, filename: str, num_iteration: int = -1,
                   start_iteration: int = 0) -> None:
        from ..io.file_io import write_text
        write_text(filename, self.save_model_to_string(start_iteration,
                                                       num_iteration))

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        """reference: gbdt_model_text.cpp:28 DumpModel (JSON)."""
        models = self._used_models(num_iteration, start_iteration)
        return {
            "name": "tree",
            "version": MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
            "objective": (self.objective.to_string() if self.objective
                          else ""),
            "average_output": self.average_output,
            "feature_names": list(self.feature_names),
            "feature_importances": {
                self.feature_names[i]: float(v)
                for i, v in enumerate(self.feature_importance("split"))
                if v > 0},
            "tree_info": [dict(tree_index=i, **t.to_json())
                          for i, t in enumerate(models)],
        }


class GOSS(GBDT):
    """Gradient-based one-side sampling (reference src/boosting/goss.hpp;
    the JAX package's GOSS). The fused iteration samples on the device
    (``goss_sample``); the generic one, which takes over an iteration
    without a split, samples on the host."""

    def _goss_params(self):
        cfg = self.config
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        return top_k, other_k, float((n - top_k) / max(other_k, 1))

    def _fused_goss(self):
        # every row for the first 1 / learning_rate iterations
        # (goss.hpp:143-144)
        if self.iter < int(1.0 / max(self.config.learning_rate, 1e-12)):
            return None
        return self._goss_params()

    def _goss_sample(self, grad, hess):
        """The host sample (goss.hpp:91 BaggingHelper): the top rows by
        |g * h| and other_k of the rest from the bagging RandomState.
        Returns (sorted bag row ids, the sampled other rows, multiply)."""
        top_k, other_k, multiply = self._goss_params()
        g = np.abs(grad.cpu().numpy() * hess.cpu().numpy()).sum(axis=0)
        order = np.argsort(-g, kind="stable")
        top_idx, rest = order[:top_k], order[top_k:]
        sampled = self._bag_rng.choice(len(rest), min(other_k, len(rest)),
                                       replace=False)
        other_idx = rest[sampled]
        if hasattr(self.learner, "stream_note_top"):
            # streaming keeps the top rows on the device for the next
            # iteration: at most goss_working_set of them (0: all)
            ws_k = int(getattr(self.config, "goss_working_set", 0) or 0)
            ws_k = top_k if ws_k <= 0 else min(ws_k, top_k)
            self.learner.stream_note_top(
                np.sort(top_idx[:ws_k]).astype(np.int32))
        idx = np.sort(np.concatenate([top_idx, other_idx])).astype(np.int32)
        return idx, other_idx, multiply

    def _sample(self, grad, hess):
        """GOSS replaces bagging: every row during the warm-up, else the
        host sample with the other rows' gradients amplified."""
        if self._fused_goss() is None:
            return grad, hess, None
        idx, other_idx, multiply = self._goss_sample(grad, hess)
        amp = torch.ones(self.num_data, dtype=torch.float32,
                         device=grad.device)
        amp[torch.as_tensor(other_idx, device=grad.device)] = multiply
        return grad * amp[None, :], hess * amp[None, :], idx


class DART(GBDT):
    """Dropout boosting (reference src/boosting/dart.hpp; the JAX package's
    DART) on the generic iteration. Before each iteration a host
    RandomState(drop_seed) picks earlier trees to drop (skip_drop,
    drop_rate, max_drop; uniform_drop, else weighted by each tree's
    weight) and takes them out of the training scores; the new tree is
    shrunk by learning_rate / (1 + k) (xgboost_dart_mode: learning_rate /
    (learning_rate + k)); then each of the k dropped trees is rescaled to
    k / (k + 1) of its weight (k / (k + learning_rate)) in the model and in
    the validation scores, and put back into the training scores at that
    weight. The JAX package's _normalize leaves the dropped trees at
    another scale than the scores it keeps; the port keeps the reference's
    weights, so the model predicts its training scores."""

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 device="cpu"):
        super().__init__(config, train_set, device=device)
        self._drop_rng = np.random.RandomState(config.drop_seed
                                               % (2**31 - 1))
        self._tree_weights: List[float] = []
        self._sum_weight = 0.0
        self.drop_index: List[int] = []

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        drop_index = self._drop_trees()
        stop = super().train_one_iter(gradients, hessians)
        if not stop:
            self._normalize(drop_index)
        return stop

    def _drop_trees(self) -> List[int]:
        """The iterations dropped before this one (reference
        DART::DroppingTrees), taken out of the training scores, and the
        new tree's shrinkage."""
        cfg = self.config
        drop_index: List[int] = []
        n_iter = self.iter
        if self._drop_rng.rand() >= cfg.skip_drop and n_iter > 0:
            drop_rate = cfg.drop_rate
            if cfg.uniform_drop:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / n_iter)
                for i in range(n_iter):
                    if self._drop_rng.rand() < drop_rate:
                        drop_index.append(self.num_init_iteration + i)
                        if 0 < cfg.max_drop <= len(drop_index):
                            break
            else:
                inv_avg = len(self._tree_weights) \
                    / max(self._sum_weight, 1e-20)
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                    / max(self._sum_weight, 1e-20))
                for i in range(n_iter):
                    if self._drop_rng.rand() \
                            < drop_rate * self._tree_weights[i] * inv_avg:
                        drop_index.append(self.num_init_iteration + i)
                        if 0 < cfg.max_drop <= len(drop_index):
                            break
        per = self.num_tree_per_iteration
        for i in drop_index:
            for k in range(per):
                tree = self.models[i * per + k]
                tree.apply_shrinkage(-1.0)
                self.score_updater.add_tree(tree, k)
        k_drop = len(drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_drop)
        elif k_drop:
            self.shrinkage_rate = cfg.learning_rate \
                / (cfg.learning_rate + k_drop)
        else:
            self.shrinkage_rate = cfg.learning_rate
        self.drop_index = drop_index
        return drop_index

    def _normalize(self, drop_index: List[int]) -> None:
        """Rescale the dropped trees (reference DART::Normalize): each holds
        -w after the drop; the validation scores lose w / (k + 1) of it
        (xgboost_dart_mode: w * lr / (lr + k)) and the training scores get
        the rest back, which the tree then holds."""
        cfg = self.config
        lr = cfg.learning_rate
        self.invalidate_ensemble_cache()
        k = float(len(drop_index))
        per = self.num_tree_per_iteration
        for i in drop_index:
            for c in range(per):
                tree = self.models[i * per + c]
                if not cfg.xgboost_dart_mode:
                    tree.apply_shrinkage(1.0 / (k + 1.0))
                    for vu in self.valid_updaters:
                        vu.add_tree(tree, c)
                    tree.apply_shrinkage(-k)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    for vu in self.valid_updaters:
                        vu.add_tree(tree, c)
                    tree.apply_shrinkage(-k / lr)
                self.score_updater.add_tree(tree, c)
            if not cfg.uniform_drop:
                ti = i - self.num_init_iteration
                extra = 1.0 if not cfg.xgboost_dart_mode else lr
                self._sum_weight -= self._tree_weights[ti] / (k + extra)
                self._tree_weights[ti] *= k / (k + extra)
        self._tree_weights.append(self.shrinkage_rate)
        self._sum_weight += self.shrinkage_rate


class RF(GBDT):
    """Random forest (reference src/boosting/rf.hpp; the JAX package's RF)
    on the generic iteration: a bag every iteration (the config requires
    one), no shrinkage, every tree grown from the gradients at the
    boost-from-average score (which, as in the JAX package, is not added
    to the trees or the scores), leaf renewal from label - that score,
    and training and validation scores kept the running average of the
    trees, which predict_raw averages (average_output)."""

    average_output = True

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 device="cpu"):
        super().__init__(config, train_set, device=device)
        self.shrinkage_rate = 1.0
        if self.objective is None:
            log.fatal("RF mode does not support custom objective")
        per = self.num_tree_per_iteration
        self._rf_init_scores = [self._boost_from_average(k, False)
                                for k in range(per)]
        tmp = torch.as_tensor(np.tile(np.asarray(
            self._rf_init_scores, dtype=np.float32)[:, None],
            (1, self.num_data)), device=self.device)
        if self.num_class == 1:
            g, h = self.objective.get_gradients(tmp[0])
            self._rf_grad, self._rf_hess = g[None, :], h[None, :]
        else:
            self._rf_grad, self._rf_hess = self.objective.get_gradients(tmp)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        bag_indices = self._bagging(self.iter)
        prev = self.iter
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(2)
            if self._class_need_train[k] and self.train_set.num_features > 0:
                new_tree = self.learner.train(
                    self._rf_grad[k], self._rf_hess[k], bag_indices,
                    iter_seed=self.iter * self.num_tree_per_iteration + k)
            if new_tree.num_leaves > 1:
                should_continue = True
                if self.objective.is_renew_tree_output:
                    self._renew_tree_output_rf(new_tree, k)
                # the running average: score = (score * t + tree) / (t + 1)
                if prev > 0:
                    factor = prev / (prev + 1.0)
                    self.score_updater.multiply(factor, k)
                    for vu in self.valid_updaters:
                        vu.multiply(factor, k)
                new_tree.apply_shrinkage(1.0 / (prev + 1.0))
                self._update_score(new_tree, k)
                new_tree.apply_shrinkage(prev + 1.0)
            self.models.append(new_tree)
        if not should_continue:
            log.warning("Stopped training: no splittable leaves (RF)")
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter += 1
        return False

    def _renew_tree_output_rf(self, tree: Tree, class_id: int) -> None:
        """The L1 family's leaf re-fit from the residuals label - the
        boost-from-average score of each leaf's in-bag rows, weighted by
        the dataset's weights (the JAX package's _renew_tree_output_rf)."""
        init = self._rf_init_scores[class_id]
        label = np.asarray(self.train_set.label, dtype=np.float64)
        weights = self.train_set.metadata.weight
        for leaf in range(tree.num_leaves):
            rows = self.learner.leaf_rows(leaf)
            if len(rows) == 0:
                continue
            tree.set_leaf_output(leaf, self.objective.renew_leaf_output(
                label[rows] - init,
                weights[rows] if weights is not None else None))


def create_boosting(config: Config, train_set: Optional[Dataset],
                    device="cpu") -> GBDT:
    """The boosting engine of config.boosting (reference boosting.cpp:35
    CreateBoosting): GBDT, GOSS, DART or RF."""
    cls = {"gbdt": GBDT, "gbrt": GBDT, "plain": GBDT, "goss": GOSS,
           "dart": DART, "rf": RF, "random_forest": RF}.get(config.boosting)
    if cls is None:
        raise LightGBMError("boosting=%s is not supported by "
                            "lightgbm_tpu_torch yet" % config.boosting)
    return cls(config, train_set, device=device)
