"""Training and cross-validation entry points.

Port of lightgbm_tpu/engine.py (reference: python-package/lightgbm/
engine.py:18 train, :373 cv): validation sets, callbacks (evaluation
printing and recording, parameter resets, early stopping), custom
objectives and metrics, continued training from ``init_model``, and
k-fold cross-validation. The JAX package's telemetry, fault, supervisor
and preemption seams are not ported; ``resume_from`` raises.

As in the JAX package, whenever a metric is configured (binary's default
binary_logloss counts) the training set is evaluated every iteration too,
on the host.
"""
from __future__ import annotations

import collections
import copy
import os
from typing import Any, Dict, List

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .utils.log import LightGBMError

__all__ = ["train", "cv", "CVBooster"]

_ROUND_KEYS = ("num_boost_round", "num_iterations", "num_iteration",
               "n_iter", "num_tree", "num_trees", "num_round", "num_rounds",
               "n_estimators")


def _pop_rounds(params: Dict[str, Any], num_boost_round) -> int:
    for key in _ROUND_KEYS:
        if key in params:
            num_boost_round = params.pop(key)
    return int(num_boost_round)


def _sorted_callbacks(cbs):
    """(before-iteration callbacks, after-iteration callbacks), each by
    its order."""
    before = {c for c in cbs if getattr(c, "before_iteration", False)}
    after = cbs - before
    return (sorted(before, key=lambda c: getattr(c, "order", 0)),
            sorted(after, key=lambda c: getattr(c, "order", 0)))


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, valid_names=None,
          fobj=None, feval=None, init_model=None, feature_name="auto",
          categorical_feature="auto", early_stopping_rounds=None,
          evals_result=None, verbose_eval=True, learning_rates=None,
          keep_training_booster=False, callbacks=None, resume_from=None,
          device=None) -> Booster:
    """Train a booster on the card (``device="cpu"`` runs the kernels'
    plain PyTorch versions on the CPU instead). `fobj(preds, train_set)`
    returns the gradients and hessians of a custom objective at the raw
    training scores; `feval(preds, dataset)` returns (name, value,
    higher_better) or a list of them; `init_model` (a model file, such
    as the JAX package writes, or a Booster) is continued."""
    if resume_from is not None:
        raise LightGBMError("resume_from is not supported by "
                            "lightgbm_tpu_torch yet (no checkpoints)")
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    params = copy.deepcopy(params or {})
    if fobj is not None:
        params["objective"] = "none"
    num_boost_round = _pop_rounds(params, num_boost_round)
    if early_stopping_rounds is None:
        for key in ("early_stopping_round", "early_stopping_rounds"):
            if key in params:
                early_stopping_rounds = int(params.pop(key))
    first_metric_only = bool(params.get("first_metric_only", False))
    if feature_name != "auto":
        train_set.feature_name = feature_name
    train_set._update_params(params)

    booster = Booster(params=params, train_set=train_set, device=device)
    if init_model is not None:
        _load_init_model(booster, init_model)
    if isinstance(valid_sets, Dataset):
        valid_sets = [valid_sets]
    has_valid = False
    for i, vset in enumerate(valid_sets or []):
        if vset is train_set:
            booster.set_train_data_name(
                valid_names[i] if valid_names else "training")
            continue
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else "valid_%d" % i)
        vset.reference = train_set
        booster.add_valid(vset, name)
        has_valid = True

    cbs = set(callbacks or [])
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.add(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(
            early_stopping_rounds, first_metric_only,
            verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs_before, cbs_after = _sorted_callbacks(cbs)

    begin_iteration = booster.current_iteration()
    end_iteration = begin_iteration + num_boost_round
    evaluation_result_list: List = []
    for i in range(begin_iteration, end_iteration):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=begin_iteration,
                end_iteration=end_iteration, evaluation_result_list=None))
        stop = booster.update(fobj=fobj)
        evaluation_result_list = []
        if has_valid or booster._gbdt.train_metrics:
            evaluation_result_list = (booster.eval_train(feval)
                                      + booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=begin_iteration,
                    end_iteration=end_iteration,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evaluation_result_list = e.best_score
            break
        if stop:
            break
    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for item in evaluation_result_list:
        booster.best_score[item[0]][item[1]] = item[2]
    return booster


def _load_init_model(booster: Booster, init_model) -> None:
    """Continue `init_model` -- a model file (the port's or the JAX
    package's model text), a Booster, or any booster that writes model
    text -- in `booster`: its trees lead the model, and the training
    scores (and any validation set's) start from them. The trees are
    routed over this training set's bins from their real thresholds."""
    from .models.gbdt import GBDT
    if isinstance(init_model, (str, os.PathLike)):
        with open(init_model) as f:
            text = f.read()
    elif isinstance(init_model, Booster):
        text = None
        trees = init_model._gbdt.models
    elif hasattr(init_model, "model_to_string"):
        text = init_model.model_to_string(num_iteration=-1)
    else:
        raise TypeError("init_model must be a path or Booster")
    if text is not None:
        trees = GBDT.load_model_from_string(text).models
    g = booster._gbdt
    g.models = [copy.deepcopy(t) for t in trees]
    for t in g.models:
        t.inner_valid = False
    per = max(g.num_tree_per_iteration, 1)
    g.num_init_iteration = len(g.models) // per
    for k in range(per):
        for it in range(g.num_init_iteration):
            tree = g.models[it * per + k]
            g.score_updater.add_tree(tree, k)
            for vu in g.valid_updaters:
                vu.add_tree(tree, k)


class CVBooster:
    """The boosters of the folds (reference engine.py _CVBooster): a call
    of any Booster method goes to each and returns their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, folds, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """[(train rows, test rows)] of each fold: `folds` as given (pairs, or
    a splitter with a split method, which gets each row's query id as
    `groups`), else whole queries to a fold when the data has query
    groups, else stratified by label or plain chunks of the rows; queries
    or rows shuffled by RandomState(seed)."""
    full_data.construct()
    num_data = full_data.num_data()
    group = full_data.get_group()
    if folds is not None:
        if not hasattr(folds, "__iter__") and hasattr(folds, "split"):
            groups = (np.repeat(np.arange(len(group)),
                                np.asarray(group, dtype=np.int64))
                      if group is not None
                      else np.zeros(num_data, dtype=np.int64))
            folds = folds.split(X=np.zeros(num_data),
                                y=full_data.get_label(), groups=groups)
        return folds
    rng = np.random.RandomState(seed)
    out = []
    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)
        for chunk in np.array_split(gidx, nfold):
            test_rows = np.concatenate(
                [np.arange(bounds[g], bounds[g + 1]) for g in chunk]) \
                if len(chunk) else np.array([], dtype=np.int64)
            mask = np.ones(num_data, dtype=bool)
            mask[test_rows] = False
            out.append((np.nonzero(mask)[0], test_rows))
        return out
    if stratified:
        label = np.asarray(full_data.get_label())
        assign = np.zeros(num_data, dtype=np.int64)
        for cls in np.unique(label):
            rows = np.nonzero(label == cls)[0]
            if shuffle:
                rng.shuffle(rows)
            for f, chunk in enumerate(np.array_split(rows, nfold)):
                assign[chunk] = f
        for f in range(nfold):
            out.append((np.nonzero(assign != f)[0],
                        np.nonzero(assign == f)[0]))
        return out
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    chunks = np.array_split(idx, nfold)
    for f in range(nfold):
        out.append((np.concatenate([chunks[g] for g in range(nfold)
                                    if g != f]), chunks[f]))
    return out


def cv(params, train_set, num_boost_round=100, folds=None, nfold=5,
       stratified=True, shuffle=True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv=True, seed=0, callbacks=None, eval_train_metric=False,
       return_cvbooster=False, device=None):
    """k-fold cross-validation: one booster per fold, trained in turn
    iteration by iteration, each evaluated on its held-out rows. Returns
    {"<metric>-mean": [...], "<metric>-stdv": [...]} over the folds (with
    eval_train_metric, keyed "<dataset> <metric>-..."), cut at the best
    iteration when early stopping fires; "cvbooster" with
    return_cvbooster."""
    if init_model is not None:
        raise LightGBMError("cv(init_model=...) is not supported by "
                            "lightgbm_tpu_torch yet")
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)
    params = copy.deepcopy(params or {})
    if fobj is not None:
        params["objective"] = "none"
    if metrics:
        params["metric"] = metrics
    num_boost_round = _pop_rounds(params, num_boost_round)
    if early_stopping_rounds is None:
        early_stopping_rounds = params.pop("early_stopping_round", None)
    if feature_name != "auto":
        train_set.feature_name = feature_name
    train_set._update_params(params)
    folds_iter = _make_n_folds(train_set, folds, nfold, seed, stratified,
                               shuffle)

    results = collections.defaultdict(list)
    cvbooster = CVBooster()
    for train_rows, test_rows in folds_iter:
        tset = train_set.subset(np.sort(train_rows))
        vset = train_set.subset(np.sort(test_rows))
        if fpreproc is not None:
            tset, vset, fold_params = fpreproc(tset, vset,
                                               copy.deepcopy(params))
        else:
            fold_params = params
        booster = Booster(params=fold_params, train_set=tset, device=device)
        booster.add_valid(vset, "valid")
        cvbooster.append(booster)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None and int(early_stopping_rounds) > 0:
        cbs.add(callback_mod.early_stopping(
            int(early_stopping_rounds),
            bool(params.get("first_metric_only", False)), verbose=False))
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int) and verbose_eval:
        cbs.add(callback_mod.print_evaluation(verbose_eval, show_stdv))
    cbs_before, cbs_after = _sorted_callbacks(cbs)

    for i in range(num_boost_round):
        for booster in cvbooster.boosters:
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            booster.update(fobj=fobj)
        merged = collections.defaultdict(list)
        for booster in cvbooster.boosters:
            one = (booster.eval_train(feval) if eval_train_metric else []) \
                + booster.eval_valid(feval)
            for (dname, mname, val, hb) in one:
                merged[(dname, mname, hb)].append(val)
        agg = [(dname, mname, float(np.mean(vals)), hb, float(np.std(vals)))
               for (dname, mname, hb), vals in merged.items()]
        for (dname, mname, mean, hb, std) in agg:
            prefix = "%s %s" % (dname, mname) if eval_train_metric else mname
            results[prefix + "-mean"].append(mean)
            results[prefix + "-stdv"].append(std)
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster.boosters[0], params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg))
        except callback_mod.EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for key in list(results.keys()):
                results[key] = results[key][:cvbooster.best_iteration]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
