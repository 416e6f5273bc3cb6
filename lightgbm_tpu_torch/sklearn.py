"""scikit-learn estimator API.

Port of lightgbm_tpu/sklearn.py, signature-compatible with the reference
sklearn wrapper (reference: python-package/lightgbm/sklearn.py:167
LGBMModel, :725 LGBMRegressor, :751 LGBMClassifier, :884 LGBMRanker). It
imports no scikit-learn. One argument is the port's own: ``device``
(default None: the card; "cpu" runs the plain PyTorch versions), passed to
``train``; it is not a LightGBM parameter.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as _train


class LGBMModel:
    def __init__(self, boosting_type="gbdt", num_leaves=31, max_depth=-1,
                 learning_rate=0.1, n_estimators=100, subsample_for_bin=200000,
                 objective=None, class_weight=None, min_split_gain=0.0,
                 min_child_weight=1e-3, min_child_samples=20, subsample=1.0,
                 subsample_freq=0, colsample_bytree=1.0, reg_alpha=0.0,
                 reg_lambda=0.0, random_state=None, n_jobs=-1, silent=True,
                 importance_type="split", device=None, **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result = None
        self._best_iteration = -1
        self._best_score = {}
        self._n_features = None
        self._classes = None
        self._n_classes = None
        self.set_params(**kwargs)

    # -- sklearn plumbing ----------------------------------------------
    def get_params(self, deep=True):
        params = {
            "boosting_type": self.boosting_type, "num_leaves": self.num_leaves,
            "max_depth": self.max_depth, "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective, "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample, "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "silent": self.silent, "importance_type": self.importance_type,
            "device": self.device,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for key, value in params.items():
            setattr(self, key, value)
            self._other_params[key] = value
        for k in list(self._other_params):
            if hasattr(type(self), k) or k in (
                    "boosting_type", "num_leaves", "max_depth", "learning_rate",
                    "n_estimators", "device"):
                self._other_params.pop(k, None)
        return self

    def _process_params(self):
        params = self.get_params()
        params.pop("silent", None)
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        params.pop("device", None)
        ren = {
            "boosting_type": "boosting",
            "min_split_gain": "min_gain_to_split",
            "min_child_weight": "min_sum_hessian_in_leaf",
            "min_child_samples": "min_data_in_leaf",
            "subsample": "bagging_fraction",
            "subsample_freq": "bagging_freq",
            "colsample_bytree": "feature_fraction",
            "reg_alpha": "lambda_l1",
            "reg_lambda": "lambda_l2",
            "subsample_for_bin": "bin_construct_sample_cnt",
            "random_state": "seed",
            "n_jobs": "num_threads",
        }
        out = {}
        for k, v in params.items():
            if v is None:
                continue
            out[ren.get(k, k)] = v
        if out.get("seed") is None:
            out.pop("seed", None)
        out.pop("num_threads", None)
        return out

    # -- fitting --------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_class_weight=None, eval_init_score=None, eval_group=None,
            eval_metric=None, early_stopping_rounds=None, verbose=True,
            feature_name="auto", categorical_feature="auto", callbacks=None):
        params = self._process_params()
        if self._objective_default() is not None and "objective" not in params:
            params["objective"] = self._objective_default()
        params.setdefault("objective", self._objective_default() or "regression")
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        if self._n_classes is not None and self._n_classes > 2:
            params["num_class"] = self._n_classes
        if self.class_weight is not None and sample_weight is None:
            sample_weight = self._class_weights_to_sample_weight(y)

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params)
        valid_sets = []
        valid_names = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                else:
                    vw = (eval_sample_weight[i]
                          if eval_sample_weight else None)
                    vg = eval_group[i] if eval_group else None
                    vi = eval_init_score[i] if eval_init_score else None
                    valid_sets.append(Dataset(
                        vx, label=vy, weight=vw, group=vg, init_score=vi,
                        reference=train_set, params=params))
                valid_names.append(
                    eval_names[i] if eval_names else f"valid_{i}")

        feval = eval_metric if callable(eval_metric) else None
        evals_result = {}
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            feval=_wrap_feval(feval) if feval else None,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=evals_result, verbose_eval=verbose,
            feature_name=feature_name,
            categorical_feature=categorical_feature, callbacks=callbacks,
            device=self.device)
        self._evals_result = evals_result
        self._best_iteration = self._Booster.best_iteration
        self._best_score = self._Booster.best_score
        self._n_features = train_set.num_feature()
        return self

    def _objective_default(self):
        return self.objective

    def _class_weights_to_sample_weight(self, y):
        y = np.asarray(y)
        if self.class_weight == "balanced":
            classes, counts = np.unique(y, return_counts=True)
            weights = {c: len(y) / (len(classes) * n)
                       for c, n in zip(classes, counts)}
        else:
            weights = dict(self.class_weight)
        return np.asarray([weights.get(v, 1.0) for v in y])

    # -- inference ------------------------------------------------------
    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        if self._Booster is None:
            raise LightGBMNotFittedError("Estimator not fitted")
        return self._Booster.predict(
            X, raw_score=raw_score, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_contrib=pred_contrib)

    # -- attributes -----------------------------------------------------
    @property
    def booster_(self):
        if self._Booster is None:
            raise LightGBMNotFittedError("No booster found")
        return self._Booster

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def best_score_(self):
        return self._best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def n_features_(self):
        return self._n_features

    @property
    def feature_importances_(self):
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self):
        return self.booster_.feature_name()

    @property
    def objective_(self):
        return self.objective or self._objective_default()


class LightGBMNotFittedError(ValueError):
    pass


class LGBMRegressor(LGBMModel):
    def _objective_default(self):
        return self.objective or "regression"


class LGBMClassifier(LGBMModel):
    def _objective_default(self):
        if self.objective is not None:
            return self.objective
        if self._n_classes is not None and self._n_classes > 2:
            return "multiclass"
        return "binary"

    def fit(self, X, y, **kwargs):
        y = np.asarray(y)
        self._classes, y_enc = np.unique(y, return_inverse=True)
        self._n_classes = len(self._classes)
        eval_set = kwargs.get("eval_set")
        if eval_set is not None:
            # the validation labels coded as the training labels are (the
            # reference's _le.transform; the JAX package passes them raw)
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            kwargs["eval_set"] = [
                (vx, vy) if (vx is X and vy is y)
                else (vx, self._encode(vy)) for vx, vy in eval_set]
        super().fit(X, y_enc.astype(np.float64), **kwargs)
        return self

    def _encode(self, labels):
        labels = np.asarray(labels)
        codes = np.searchsorted(self._classes, labels)
        if np.any(codes >= len(self._classes)) \
                or np.any(self._classes[np.minimum(
                    codes, len(self._classes) - 1)] != labels):
            raise ValueError("eval_set holds labels absent from the "
                             "training labels")
        return codes.astype(np.float64)

    def predict(self, X, raw_score=False, num_iteration=None,
                pred_leaf=False, pred_contrib=False, **kwargs):
        result = self.predict_proba(X, raw_score, num_iteration,
                                    pred_leaf, pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            idx = (result > 0.5).astype(np.int64)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=None,
                      pred_leaf=False, pred_contrib=False, **kwargs):
        result = super().predict(X, raw_score, num_iteration, pred_leaf,
                                 pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if self._n_classes == 2 and result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    def _objective_default(self):
        return self.objective or "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)


def _wrap_feval(feval):
    """sklearn-style feval(y_true, y_pred) -> engine-style feval(preds, ds)."""
    def inner(preds, dataset):
        label = dataset.get_label() if hasattr(dataset, "get_label") \
            else dataset.metadata.label
        ret = feval(label, preds)
        return ret
    return inner
