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
fused iteration is not ported; DART and RF are not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..io.dataset import Dataset
from ..metrics import create_metrics
from ..objectives import create_objective
from ..ops import predict as predict_ops
from ..utils import log
from ..utils.log import LightGBMError
from .device_learner import DeviceTreeLearner
from .tree import Tree

K_EPSILON = 1e-15
MODEL_VERSION = "v3"


class ScoreUpdater:
    """Per-dataset raw scores (reference: src/boosting/score_updater.hpp):
    a (K, N) f32 tensor on the booster's device, and its f64 host copy,
    fetched once per score version (every change of the scores drops it,
    so a multi-metric eval of one iteration fetches once)."""

    def __init__(self, dataset: Dataset, num_class: int, device):
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
        """The f64 host copy of the scores (read-only)."""
        if self._host is None:
            self._host = self._score.cpu().numpy().astype(np.float64)
            self.fetches += 1
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
        self.valid_names: List[str] = []
        self.valid_updaters: List[ScoreUpdater] = []
        self.valid_metrics: List[List] = []
        self.train_metrics: List = []
        self.label_idx = 0
        self._ensemble_cache: Dict = {}
        if train_set is not None:
            self._init_train(train_set)

    def _init_train(self, train_set: Dataset) -> None:
        cfg = self.config
        # None for a custom objective: the caller passes the gradients
        self.objective = create_objective(cfg.objective, cfg)
        if self.objective is not None:
            self.objective.init(train_set.metadata, train_set.num_data,
                                self.device)
            self.num_class = self.objective.num_model_per_iteration
        else:
            self.num_class = max(1, cfg.num_class)
        self.num_tree_per_iteration = self.num_class
        self.learner = DeviceTreeLearner(cfg, train_set, device=self.device)
        self.score_updater = ScoreUpdater(train_set, self.num_class,
                                          self.device)
        self.num_data = train_set.num_data
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
        init_score = self.objective.boost_from_score(class_id)
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
        gradients and hessians (a one-class objective sees the (N,)
        row)."""
        score = self.score_updater.score
        if self.num_class > 1:
            return self.objective.get_gradients(score)
        g, h = self.objective.get_gradients(score[0])
        return g[None, :], h[None, :]

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; True when training should stop (no tree
        with more than one leaf was produced). External (K * N,)
        gradients and hessians (a custom objective's) take the generic
        iteration."""
        if gradients is None and hessians is None and self._fused_eligible():
            return self._train_one_iter_fused()
        return self._train_one_iter_generic(gradients, hessians)

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
        GOSS, one tree per iteration that trains, on either strategy (each
        grows its tree in its device loop), no leaf renewal (its
        percentiles run on the host) and no pos/neg bagging (its bag is
        drawn on the host), as in the JAX package."""
        return (self.__class__ in (GBDT, GOSS)
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
        materialization."""
        cfg = self.config
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
        new_score, rec, leaf_id, k, finite = self._fused_step[fkey](
            self.score_updater.score[0], self.iter, self.shrinkage_rate,
            init_score, bag_seed)
        rec_h, k, (finite,) = self.learner.fetch_tree(rec, k, finite)
        if self._materialize_one(rec_h, k, leaf_id, init_score):
            return self._train_one_iter_generic()
        if not finite:
            log.warning("Non-finite training scores after iteration %d",
                        self.iter)
        self.score_updater.score = new_score[None]
        self.iter += 1
        return False

    def _materialize_one(self, rec_h: np.ndarray, k: int,
                         leaf_id: torch.Tensor, init_score: float) -> bool:
        """Replay a fused iteration's records into a host tree and append
        it; True (and nothing appended) when the tree has no split."""
        if k == 0:
            return True
        tree = self.learner.replay_tree(rec_h, k)
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
        if gradients is None or hessians is None:
            init_scores = [self._boost_from_average(k, True)
                           for k in range(k_trees)]
            grad, hess = self._compute_gradients()
        else:
            init_scores = [0.0] * k_trees
            grad, hess = (torch.as_tensor(np.asarray(
                a, dtype=np.float32).reshape(k_trees, n), device=self.device)
                for a in (gradients, hessians))
        grad, hess, bag_indices = self._sample(grad, hess)
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(2)
            if self._class_need_train[k] and self.train_set.num_features > 0:
                new_tree = self.learner.train(
                    grad[k], hess[k], bag_indices,
                    iter_seed=self.iter * self.num_tree_per_iteration + k)
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
                output = (self.objective.boost_from_score(k)
                          if not self._class_need_train[k]
                          and self.objective is not None
                          else init_scores[k])
                new_tree.as_constant_tree(output)
                self.score_updater.add_constant(output, k)
                for vu in self.valid_updaters:
                    vu.add_constant(output, k)
            self.models.append(new_tree)

        if not should_continue:
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
        rollback: it routes exactly as the partition did), the validation
        sets' by walking the tree."""
        leaf_id = self.learner.last_leaf_id
        self.score_updater.add_tree_by_leaf_id(tree, leaf_id, class_id)
        self._last_leaf_ids[class_id] = leaf_id
        self._last_leaf_ids_iter = self.iter
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
        self._ensemble_cache = {}
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

    def ensemble_arrays(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0):
        """Cached (EnsembleArrays, tree_class, n_models) for the model
        slice; keyed on the model length and last tree, so growth misses."""
        models = self._used_models(num_iteration, start_iteration)
        if not models:
            return None, None, 0
        key = (len(self.models), id(self.models[-1]), start_iteration,
               len(models))
        hit = self._ensemble_cache.get(key)
        if hit is None:
            arrays = predict_ops.trees_to_arrays(models, self.device)
            tc = torch.as_tensor(
                np.arange(len(models)) % self.num_tree_per_iteration)
            hit = (arrays, tc, len(models))
            self._ensemble_cache = {key: hit}
        return hit

    def predict_raw(self, x, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> np.ndarray:
        """(N, K) raw scores over raw feature values."""
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
        if x.ndim == 1:
            x = x.reshape(1, -1)
        arrays, tc, n_models = self.ensemble_arrays(num_iteration,
                                                    start_iteration)
        if not n_models:
            return np.zeros((x.shape[0], self.num_class))
        out = predict_ops.predict_raw_ensemble(
            torch.as_tensor(x, device=self.device), arrays, tc,
            self.num_class)
        return out.cpu().numpy().astype(np.float64)

    def predict(self, x, num_iteration=None, raw_score=False,
                start_iteration=0):
        raw = self.predict_raw(x, num_iteration, start_iteration)
        if raw_score:
            return raw[:, 0] if self.num_class == 1 else raw
        if self.objective is not None:
            out = self.objective.convert_output(
                torch.as_tensor(raw.T.astype(np.float32))).numpy().T
        else:
            out = raw
        return out[:, 0] if self.num_class == 1 else out

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


def create_boosting(config: Config, train_set: Optional[Dataset],
                    device="cpu") -> GBDT:
    """The boosting engine of config.boosting (reference boosting.cpp:35
    CreateBoosting): GBDT or GOSS; DART and RF are not ported."""
    if config.boosting in ("gbdt", "gbrt", "plain"):
        return GBDT(config, train_set, device=device)
    if config.boosting == "goss":
        return GOSS(config, train_set, device=device)
    raise LightGBMError("boosting=%s is not supported by lightgbm_tpu_torch "
                        "yet" % config.boosting)
