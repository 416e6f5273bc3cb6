"""GBDT boosting loop.

Port of the generic iteration of lightgbm_tpu/models/gbdt.py (reference:
src/boosting/gbdt.cpp GBDT::TrainOneIter, gbdt_model_text.cpp): boost from
average on the first iteration, objective gradients, one tree, shrinkage,
score update from the learner's row -> leaf map, model text and
prediction. Scores and gradients live on the booster's device as (1, N)
f32 tensors; trees and split records live on the host.
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
from .device_learner import DeviceTreeLearner
from .tree import Tree

K_EPSILON = 1e-15
MODEL_VERSION = "v3"


class ScoreUpdater:
    """Per-dataset raw scores (reference: src/boosting/score_updater.hpp)."""

    def __init__(self, dataset: Dataset, num_class: int, device):
        n = dataset.num_data
        init = np.zeros((num_class, n), dtype=np.float32)
        self.has_init_score = dataset.metadata.init_score is not None
        if self.has_init_score:
            s = np.asarray(dataset.metadata.init_score, dtype=np.float32)
            if s.size == n * num_class:
                init = s.reshape(num_class, n)
            else:
                init = np.tile(s.reshape(1, n), (num_class, 1))
        self.score = torch.as_tensor(init, device=device)

    def add_constant(self, val: float, class_id: int) -> None:
        self.score[class_id] += float(val)

    def add_tree_by_leaf_id(self, tree: Tree, leaf_id: torch.Tensor,
                            class_id: int) -> None:
        """Score update from the learner's row -> leaf map: an (N,) gather
        instead of re-walking the tree (reference in-bag AddScore fast
        path, score_updater.hpp:84)."""
        leaf_vals = torch.as_tensor(
            np.asarray(tree.leaf_value[:max(tree.num_leaves, 1)],
                       dtype=np.float32), device=self.score.device)
        self.score[class_id] += leaf_vals[
            leaf_id.clamp(0, tree.num_leaves - 1)]

    def host_scores(self) -> np.ndarray:
        return self.score.cpu().numpy().astype(np.float64)


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
        self.shrinkage_rate = config.learning_rate
        self.objective = None
        self.train_metrics: List = []
        self.label_idx = 0
        self._ensemble_cache: Dict = {}
        if train_set is not None:
            self._init_train(train_set)

    def _init_train(self, train_set: Dataset) -> None:
        cfg = self.config
        self.objective = create_objective(cfg.objective, cfg)
        self.objective.init(train_set.metadata, train_set.num_data,
                            self.device)
        self.num_class = self.objective.num_model_per_iteration
        self.num_tree_per_iteration = self.num_class
        self.learner = DeviceTreeLearner(cfg, train_set, device=self.device)
        self.score_updater = ScoreUpdater(train_set, self.num_class,
                                          self.device)
        self.num_data = train_set.num_data
        self.train_metrics = create_metrics(cfg.metric, cfg, cfg.objective)
        for m in self.train_metrics:
            m.init(train_set.metadata, train_set.num_data)
        self._class_need_train = [self.objective.class_need_train(k)
                                  for k in range(self.num_class)]
        self.feature_names = train_set.feature_names
        self.max_feature_idx = train_set.num_total_features - 1

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
            log.info("Start training from score %f", init_score)
            return init_score
        return 0.0

    def _compute_gradients(self):
        """objective->GetGradients over the (1, N) score tensor."""
        g, h = self.objective.get_gradients(self.score_updater.score[0])
        return g[None, :], h[None, :]

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when training should stop (no tree
        with more than one leaf was produced)."""
        return self._train_one_iter_generic()

    def _train_one_iter_generic(self) -> bool:
        init_scores = [self._boost_from_average(k, True)
                       for k in range(self.num_tree_per_iteration)]
        grad, hess = self._compute_gradients()
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            new_tree = Tree(2)
            if self._class_need_train[k] and self.train_set.num_features > 0:
                new_tree = self.learner.train(
                    grad[k], hess[k],
                    iter_seed=self.iter * self.num_tree_per_iteration + k)
            if new_tree.num_leaves > 1:
                should_continue = True
                new_tree.apply_shrinkage(self.shrinkage_rate)
                self._update_score(new_tree, k)
                if abs(init_scores[k]) > K_EPSILON:
                    new_tree.add_bias(init_scores[k])
            elif len(self.models) < self.num_tree_per_iteration:
                output = (init_scores[k] if self._class_need_train[k]
                          else self.objective.boost_from_score(k))
                new_tree.as_constant_tree(output)
                self.score_updater.add_constant(output, k)
            self.models.append(new_tree)

        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > self.num_tree_per_iteration:
                del self.models[-self.num_tree_per_iteration:]
            return True
        self.iter += 1
        return False

    def _update_score(self, tree: Tree, class_id: int) -> None:
        self.score_updater.add_tree_by_leaf_id(
            tree, self.learner.last_leaf_id, class_id)

    # ------------------------------------------------------------------
    def eval_metrics(self):
        """(dataset_name, metric_name, value, higher_better) tuples of the
        training metrics."""
        out = []
        if self.train_metrics:
            s = self.score_updater.host_scores()[0]
            for m in self.train_metrics:
                for name, val in zip(m.names, m.eval(s, self.objective)):
                    out.append(("training", name, val, m.higher_better))
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
        return booster
