"""User-facing Dataset and Booster of the port.

Port of lightgbm_tpu/basic.py for the slices this package covers: GBDT
and GOSS with every objective of the JAX package but lambdarank (the
pointwise ones, multiclass and multiclassova with ``num_class`` trees per
iteration: ``predict`` gives (N, K)), serial learner, float or quantized
gradients (``quantized_grad``, ``grad_bits``, ``quant_renew``), the
compact and masked growth strategies, row sampling (``bagging_fraction``
with ``bagging_freq``, ``pos_bagging_fraction`` / ``neg_bagging_fraction``,
``boosting=goss``) and per-tree feature sampling (``feature_fraction``),
no categorical features; validation sets binned by reference, their
evaluation with the pointwise metrics, rollback, parameter resets and
custom objectives (``objective=none``, ``update(fobj=...)``). Every
parameter outside that slice raises LightGBMError naming its key. Both
classes run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .io.dataset import Dataset as _InnerDataset
from .metrics import METRIC_NAMES
from .models.gbdt import GBDT, create_boosting
from .objectives import OBJECTIVE_NAMES
from .utils.device import resolve_device
from .utils.log import LightGBMError


def check_supported(cfg: Config) -> None:
    """Raise LightGBMError for the first parameter outside the slice."""
    bad = None
    multi = cfg.objective in ("multiclass", "multiclassova")
    if cfg.objective not in OBJECTIVE_NAMES + ["none"]:
        bad = "objective=%s" % cfg.objective
    elif multi and cfg.num_class < 2:
        # the reference: "Number of classes should be specified and
        # greater than 1 for multiclass training"
        raise LightGBMError("objective=%s needs num_class > 1, got %d"
                            % (cfg.objective, cfg.num_class))
    elif cfg.boosting not in ("gbdt", "gbrt", "plain", "goss"):
        bad = "boosting=%s" % cfg.boosting
    elif cfg.num_class > 1 and not multi:
        bad = "num_class=%d with objective=%s" % (cfg.num_class,
                                                  cfg.objective)
    elif cfg.feature_fraction_bynode < 1.0:
        bad = "feature_fraction_bynode=%g" % cfg.feature_fraction_bynode
    elif cfg.categorical_feature:
        bad = "categorical_feature"
    elif cfg.quantized_grad and cfg.tree_learner != "serial":
        bad = "quantized_grad with tree_learner=%s" % cfg.tree_learner
    elif cfg.tree_learner != "serial":
        bad = "tree_learner=%s" % cfg.tree_learner
    elif cfg.stream_mode != "off":
        bad = "stream_mode=%s" % cfg.stream_mode
    elif cfg.forcedsplits_filename:
        bad = "forcedsplits_filename"
    elif cfg.cegb_tradeoff > 0 and (
            cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled
            or cfg.cegb_penalty_feature_lazy):
        bad = "cegb_tradeoff"
    elif cfg.on_nonfinite != "off":
        bad = "on_nonfinite=%s" % cfg.on_nonfinite
    elif cfg.two_round:
        bad = "two_round"
    else:
        unknown = [m for m in cfg.metric
                   if m not in METRIC_NAMES + ["none"]]
        if unknown:
            bad = "metric=%s" % unknown[0]
    if bad is not None:
        raise LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                            "(GBDT or GOSS with any objective but "
                            "lambdarank, serial learner, float or quantized "
                            "gradients, bagging and feature_fraction but no "
                            "by-node sampling, no categorical features)"
                            % bad)


class Dataset:
    """Lazily constructed training data (reference: basic.py:711). The
    binning runs on the host; its device views are made on the device of
    the Booster that trains on it (``device``, if given, is the default
    for that Booster). A dataset with a `reference` (a validation set) is
    binned with the reference's mappers."""

    def __init__(self, data, label=None, reference=None, weight=None,
                 init_score=None, feature_name="auto", params=None,
                 device=None):
        if isinstance(data, str):
            raise LightGBMError("file input is not supported by "
                                "lightgbm_tpu_torch yet; pass an array")
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = copy.deepcopy(params) or {}
        self.device = device
        self._inner: Optional[_InnerDataset] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        check_supported(cfg)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        ref_inner = None
        if self.reference is not None:
            ref_inner = self.reference.construct()._inner
        self._inner = _InnerDataset(
            self.data, config=cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names,
            reference=ref_inner)
        self.data = None
        return self

    def _update_params(self, params: Dict[str, Any]) -> None:
        if self._inner is None:
            self.params.update(params or {})

    def create_valid(self, data, label=None, weight=None, init_score=None,
                     params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       init_score=init_score, params=params or self.params,
                       device=self.device)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The dataset of some rows (sorted, as the reference sorts them):
        this dataset's binning and bundles, the rows' codes and metadata."""
        self.construct()
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update(self.__dict__)
        sub.params = params or self.params
        sub.data = None
        sub.reference = self
        sub._inner = self._inner.subset(np.sort(np.asarray(used_indices)))
        md = sub._inner.metadata
        sub.label, sub.weight, sub.init_score = (md.label, md.weight,
                                                 md.init_score)
        return sub

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin this dataset with `reference`'s mappers (reference:
        basic.py:1319); it must not be constructed yet."""
        if not isinstance(reference, Dataset):
            raise TypeError("Reference should be Dataset instance")
        if reference is self.reference:
            return self
        if self._inner is not None:
            raise LightGBMError("Cannot set reference after the Dataset was "
                                "constructed")
        self.reference = reference
        return self

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def get_label(self):
        return self.construct()._inner.metadata.label

    def num_data(self) -> int:
        return self.construct()._inner.num_data

    def num_feature(self) -> int:
        return self.construct()._inner.num_total_features


class Booster:
    """Training / prediction handle (reference: basic.py:1658)."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file=None, model_str=None, device=None):
        self.params = copy.deepcopy(params) or {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_data_name = "training"
        self.name_valid_sets: List[str] = []
        self.valid_sets: List[Dataset] = []
        if device is None and train_set is not None:
            device = train_set.device
        self.device = resolve_device(device)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set._update_params(self.params)
            train_set.construct()
            cfg = train_set._inner.config
            cfg.update(self.params)
            check_supported(cfg)
            self._gbdt = create_boosting(cfg, train_set._inner,
                                         device=self.device)
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._gbdt = GBDT.load_model_from_string(
                model_str, Config(self.params), device=self.device)
        else:
            raise TypeError("need at least one of train_set, model_file, "
                            "model_str")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate `data` every iteration under `name`; it is binned with
        the training set's mappers unless it already has a reference."""
        if data.reference is None and data._inner is None:
            data.set_reference(self.train_set)
        data.construct()
        self._gbdt.add_valid(data._inner, name)
        self.name_valid_sets.append(name)
        self.valid_sets.append(data)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; True when training stopped early. With
        `fobj`, its (grad, hess) at the current training scores drive the
        iteration (reference Booster.update)."""
        if fobj is not None:
            grad, hess = fobj(self.__inner_predict_raw(), self.train_set)
            return self.__boost(grad, hess)
        return self._gbdt.train_one_iter()

    def __boost(self, grad, hess) -> bool:
        return self._gbdt.train_one_iter(np.asarray(grad, dtype=np.float32),
                                         np.asarray(hess, dtype=np.float32))

    def __inner_predict_raw(self) -> np.ndarray:
        scores = self._gbdt.score_updater.host_scores()
        return scores[0] if self._gbdt.num_class == 1 else scores.reshape(-1)

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params) -> "Booster":
        """Change parameters between iterations (reference basic.py
        reset_parameter): learning_rate only sets the shrinkage; any other
        key also drops the fused steps and the learner's split scan and
        captured loops, which are remade from the new values at the next
        tree."""
        self._gbdt.config.update(params)
        self.params.update(params)
        self._gbdt.shrinkage_rate = self._gbdt.config.learning_rate
        if any(k != "learning_rate" for k in params):
            self._gbdt._fused_step = None
            self._gbdt.learner.reset_config()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def eval_train(self, feval=None):
        return self.__eval(self._train_data_name, feval)

    def eval_valid(self, feval=None):
        out = []
        for name in self.name_valid_sets:
            out.extend(self.__eval(name, feval))
        return out

    def eval(self, data=None, name=None, feval=None):
        return self.eval_train(feval) + self.eval_valid(feval)

    def __eval(self, dataset_name, feval=None):
        """(dataset, metric, value, higher_better) of one dataset: its
        configured metrics, then `feval`'s (its raw scores and Dataset)."""
        inner = ("training" if dataset_name == self._train_data_name
                 else dataset_name)
        results = [(dataset_name, mname, val, hb) for _, mname, val, hb
                   in self._gbdt.eval_metrics(only=inner)]
        if feval is not None:
            if dataset_name == self._train_data_name:
                ds, updater = self.train_set, self._gbdt.score_updater
            else:
                idx = self.name_valid_sets.index(dataset_name)
                ds = self.valid_sets[idx]
                updater = self._gbdt.valid_updaters[idx]
            preds = updater.host_scores()
            preds = preds[0] if self._gbdt.num_class == 1 \
                else preds.reshape(-1)
            ret = feval(preds, ds)
            for (n, v, hb) in (ret if isinstance(ret, list) else [ret]):
                results.append((dataset_name, n, v, hb))
        return results

    def predict(self, data, num_iteration=None, raw_score=False,
                start_iteration=0):
        """Predictions of the first `num_iteration` iterations (None: the
        best iteration of early stopping, if any, else all)."""
        if hasattr(data, "values"):
            data = data.values
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else None)
        return self._gbdt.predict(np.asarray(data),
                                  num_iteration=num_iteration,
                                  raw_score=raw_score,
                                  start_iteration=start_iteration)

    def model_to_string(self, num_iteration=None, start_iteration=0) -> str:
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        return self._gbdt.save_model_to_string(start_iteration, num_iteration)

    def save_model(self, filename, num_iteration=None,
                   start_iteration=0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self
