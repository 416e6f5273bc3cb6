"""Validation sets, evaluation, early stopping, callbacks and cv: the port
(device="cpu") against the JAX package on the same numpy data.

The data is tests/test_torch_engine.py's task, 15 leaves. Each JAX run
that evaluates a validation set takes its generic iteration: the JAX
package's fused iteration adds the first iteration's boost-from-average
score to a validation set's scores twice (once as a constant, once as the
first tree's bias), so its validation metrics are off by that score,
while its generic iteration's are right; the trees of both iterations are
the same. The port's fused iteration gives the validation sets the tree
with its bias once, so its validation scores equal predict(raw_score).
Eval histories agree within 1e-4 (the trees' leaf values differ in f32
rounding), the metrics themselves within 1e-12 on shared scores.

A held-out row can see a difference the training rows cannot: where two
thresholds of a leaf have no training row between them, both packages
make the same split of the training rows with gains equal in exact
arithmetic, and f32 rounding picks one threshold on each side (the engine
tests' _assert_same_splits allows exactly that). Held-out rows in the
bins between go each package's way. Where a test's data has such rows
(the folds of cv with early stopping, whose training sets are two thirds
of the rows), their count is held small and the metrics are held on the
other rows.
"""
import collections

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metrics import metric as jmetric
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch import callback as tcallback
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metrics import metric as tmetric
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _task(objective, n=3000, seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    x[r.rand(n) < 0.03, 2] = np.nan
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
    y = logit + 0.5 * r.randn(n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    return x, y


def _params(objective, **extra):
    return dict({"objective": objective, "num_leaves": 15, "max_bin": 63,
                 "learning_rate": 0.1, "min_data_in_leaf": 20,
                 "min_gain_to_split": 1e-3, "verbosity": -1}, **extra)


def _split(objective):
    """The engine tests' training rows, and 1,000 validation rows drawn
    from the same task."""
    return _task(objective) + _task(objective, n=1000, seed=6)


def _structure(trees):
    return [(list(t.split_feature[:t.num_leaves - 1]),
             list(t.left_child[:t.num_leaves - 1]),
             list(t.right_child[:t.num_leaves - 1]),
             list(t.leaf_count[:t.num_leaves])) for t in trees]


def _assert_same_splits(trees_a, trees_b, x):
    assert _structure(trees_a) == _structure(trees_b)
    for ta, tb in zip(trees_a, trees_b):
        for node in range(ta.num_leaves - 1):
            col = x[:, ta.split_feature[node]]
            lo, hi = sorted((ta.threshold[node], tb.threshold[node]))
            assert not np.any((col > lo) & (col <= hi))


def _assert_same_history(got, want):
    assert list(got) == list(want)
    for dname in want:
        assert list(got[dname]) == list(want[dname])
        for mname in want[dname]:
            np.testing.assert_allclose(got[dname][mname],
                                       want[dname][mname],
                                       rtol=1e-4, atol=1e-4)


def _run_both(objective, strategy, jax_kwargs=None, port_kwargs=None,
              rounds=10, **extra):
    """(x, xv, jb, tb, jax evals, port evals): train() of both packages
    with the validation set "v"."""
    xt, yt, xv, yv = _split(objective)
    p = _params(objective, **extra)
    mp = pytest.MonkeyPatch()
    if strategy == "compact":
        mp.setenv("LGBM_TPU_STRATEGY", "compact")
    else:
        mp.delenv("LGBM_TPU_STRATEGY", raising=False)
    mp.setattr(jgbdt.GBDT, "_fused_eligible", lambda self: False)
    try:
        jd = jlgb.Dataset(xt, yt)
        jev, tev = {}, {}
        jb = jlgb.train(p, jd, rounds, valid_sets=[jd.create_valid(xv, yv)],
                        valid_names=["v"], evals_result=jev,
                        verbose_eval=False, **(jax_kwargs or {}))
        td = tlgb.Dataset(xt, yt)
        tb = tlgb.train(p, td, rounds, valid_sets=[td.create_valid(xv, yv)],
                        valid_names=["v"], evals_result=tev,
                        verbose_eval=False, device="cpu",
                        **(port_kwargs or jax_kwargs or {}))
    finally:
        mp.undo()
    return xt, xv, jb, tb, jev, tev


@pytest.fixture(scope="module", params=[("binary", "compact"),
                                        ("regression", "masked")])
def with_valid(request):
    objective, strategy = request.param
    metric = ["binary_logloss", "auc"] if objective == "binary" \
        else ["l2", "l1", "huber"]
    return (objective, strategy) + _run_both(objective, strategy,
                                             metric=metric)


def test_eval_history_matches_jax(with_valid):
    objective, strategy, xt, xv, jb, tb, jev, tev = with_valid
    assert tb._gbdt.learner.strategy == strategy
    assert tb._gbdt._fused_step is not None       # the main path
    assert list(tev) == ["training", "v"] and len(tev["v"]) >= 2
    _assert_same_history(tev, jev)
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, xt)


def test_valid_scores_include_init_score(with_valid):
    # the fused iteration adds the boost-from-average score inside its
    # program; the validation set gets it as the first tree's bias
    objective, _, _, xv, _, tb, _, tev = with_valid
    gb = tb._gbdt
    init = gb.objective.boost_from_score(0)
    assert abs(init) > 1e-3
    np.testing.assert_allclose(gb.valid_updaters[0].score[0].numpy(),
                               tb.predict(xv, raw_score=True),
                               rtol=0, atol=1e-5)
    first = tb.predict(xv, raw_score=True, num_iteration=1)
    metric = gb.valid_metrics[0][0]
    np.testing.assert_allclose(
        tev["v"][metric.name][0], metric.eval(first, gb.objective)[0],
        rtol=1e-6)


def test_booster_eval_matches_recorded_history(with_valid):
    _, _, _, _, _, tb, _, tev = with_valid
    got = {(d, m): v for d, m, v, _ in tb.eval_train() + tb.eval_valid()}
    want = {(d, m): v[-1] for d, ms in tev.items() for m, v in ms.items()}
    assert got == want
    assert tb.eval() == tb.eval_train() + tb.eval_valid()


def test_binned_walk_matches_jax(with_valid):
    # a validation set binned by reference has the JAX package's codes,
    # and each JAX tree, read from model text and rebinned against it,
    # walks them to the same f32 leaf values (NaN rows of feature 2
    # included)
    objective, _, xt, xv, jb, _, _, _ = with_valid
    yt, yv = _split(objective)[1::2]
    jd = jlgb.Dataset(xt, yt, params=_params(objective))
    jv = jd.create_valid(xv, yv).construct()._inner
    td = tlgb.Dataset(xt, yt, params=_params(objective))
    tv = td.create_valid(xv, yv).construct()._inner
    np.testing.assert_array_equal(tv.binned, jv.binned)
    assert tv.bin_mappers is td._inner.bin_mappers
    trees = convert.booster_from_model_string(
        jb.model_to_string(), device="cpu")._gbdt.models
    nb, mt, db, _, _ = jv.feature_meta_arrays()
    su = tgbdt.ScoreUpdater(tv, 1, "cpu")
    for jt, tt in zip(jb._gbdt.models, trees):
        want = np.asarray(jpredict.predict_binned_tree_values(
            jv.device_binned(), mt, db, nb, jt))
        su.add_tree(tt, 0)          # rebins the tree, uploads the codes
        got = tpredict.predict_binned_tree_values(
            su._binned, su._real_to_inner, db, nb, tt)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(su.score[0].numpy(),
                               jb.predict(xv, raw_score=True),
                               rtol=0, atol=1e-5)


def test_valid_scores_with_a_constant_feature():
    # the walk maps a tree's real feature index to the column of the
    # logical codes, which leaves constant features out
    x, y = _task("binary", n=2000)
    x = np.column_stack([np.full(len(x), 3.0), x])
    td = tlgb.Dataset(x[:1500], y[:1500])
    b = tlgb.train(_params("binary"), td, 5, device="cpu",
                   valid_sets=[td.create_valid(x[1500:], y[1500:])])
    assert td._inner.used_features[0] == 1
    np.testing.assert_allclose(b._gbdt.valid_updaters[0].score[0].numpy(),
                               b.predict(x[1500:], raw_score=True),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def early_stopped():
    return _run_both("binary", "masked", {"early_stopping_rounds": 3},
                     rounds=60, learning_rate=0.5,
                     metric=["binary_logloss"])


def test_early_stopping_matches_jax(early_stopped):
    xt, xv, jb, tb, jev, tev = early_stopped
    assert 1 <= tb.best_iteration < 57
    assert tb.best_iteration == jb.best_iteration
    assert tb.num_trees() == tb.best_iteration + 3
    assert set(tb.best_score) == {"training", "v"}
    for d in jb.best_score:
        for m in jb.best_score[d]:
            np.testing.assert_allclose(tb.best_score[d][m],
                                       jb.best_score[d][m], rtol=1e-4)
    _assert_same_history(tev, jev)
    # predict and model text default to the best iteration
    np.testing.assert_array_equal(
        tb.predict(xv), tb.predict(xv, num_iteration=tb.best_iteration))
    assert not np.array_equal(tb.predict(xv),
                              tb.predict(xv, num_iteration=-1))
    assert tb.model_to_string().count("Tree=") == tb.best_iteration


def test_record_evaluation_and_learning_rates_match_jax():
    rates = [0.3, 0.2, 0.1, 0.05, 0.05]
    xt, _, jb, tb, jev, tev = _run_both(
        "regression", "masked", {"learning_rates": rates}, rounds=5,
        metric=["l2"])
    _assert_same_history(tev, jev)
    np.testing.assert_allclose(tb.predict(xt, raw_score=True),
                               jb.predict(xt, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    assert tb._gbdt.shrinkage_rate == 0.05
    # record_evaluation alone, as a callback
    got = {}
    cb = tcallback.record_evaluation(got)
    cb(tcallback.CallbackEnv(None, {}, 0, 0, 1, [("v", "l2", 1.5, False)]))
    assert got == {"v": collections.OrderedDict(l2=[1.5])}


@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_reset_parameter_lambda_l2_matches_jax(strategy, monkeypatch):
    # lambda_l2 changes at iteration 2: the learner must drop its split
    # scan (whose constants are baked in) and its carries, and remake
    # them -- one more carry, captured anew on the card
    x, y = _task("binary")
    if strategy == "compact":
        monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    else:
        monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)
    p = _params("binary", lambda_l2=0.0)
    l2 = [0.0, 0.0, 50.0, 50.0, 50.0]
    jb = jlgb.train(p, jlgb.Dataset(x, y), 5, verbose_eval=False,
                    callbacks=[jlgb.callback.reset_parameter(lambda_l2=l2)])
    captures = []
    tb = tlgb.train(p, tlgb.Dataset(x, y), 5, device="cpu",
                    verbose_eval=False, callbacks=[
                        tlgb.reset_parameter(lambda_l2=l2),
                        lambda env: captures.append(
                            env.model._gbdt.learner.stats.captures)])
    assert captures == [1, 1, 2, 2, 2]
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    # the reset changed the trees: lambda_l2 = 50 shrinks leaf values
    kept = tlgb.train(p, tlgb.Dataset(x, y), 5, device="cpu")
    assert np.abs(kept.predict(x, raw_score=True)
                  - tb.predict(x, raw_score=True)).max() > 1e-2


def test_rollback_matches_jax():
    # rollback restores the scores of the shorter model (to 1e-6: f32
    # adds and subtracts), which are JAX's to the trees' 1e-4
    before = []

    def keep_scores(env):
        gb = env.model._gbdt
        before.append([su.score[0].clone() for su in
                       [gb.score_updater] + gb.valid_updaters])

    xt, xv, jb, tb, _, _ = _run_both(
        "binary", "compact", port_kwargs={"callbacks": [keep_scores]},
        rounds=5)
    jb.rollback_one_iter()
    tb.rollback_one_iter()
    assert tb.current_iteration() == jb.current_iteration() == 4
    updaters = [(jb._gbdt.score_updater, tb._gbdt.score_updater),
                (jb._gbdt.valid_updaters[0], tb._gbdt.valid_updaters[0])]
    for (jsu, tsu), want in zip(updaters, before[3]):
        np.testing.assert_allclose(tsu.score[0].numpy(), want.numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tsu.score[0].numpy(),
                                   np.asarray(jsu.score)[0],
                                   rtol=1e-4, atol=1e-4)
    # the text of the model trained for 4 rounds, importances included
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGBM_TPU_STRATEGY", "compact")
        shorter = tlgb.train(_params("binary"), tlgb.Dataset(xt, _split(
            "binary")[1]), 4, device="cpu")
    assert tb.model_to_string() == shorter.model_to_string()
    np.testing.assert_allclose(tb._gbdt.valid_updaters[0].score[0].numpy(),
                               tb.predict(xv, raw_score=True),
                               rtol=0, atol=1e-5)


def test_init_model_continuation_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _task("regression")
    p = _params("regression")
    jfirst = jlgb.train(p, jlgb.Dataset(x, y), 4, verbose_eval=False)
    path = str(tmp_path / "jax_model.txt")
    jfirst.save_model(path)
    jb = jlgb.train(p, jlgb.Dataset(x, y), 4, init_model=path,
                    verbose_eval=False)
    from_file = tlgb.train(p, tlgb.Dataset(x, y), 4, init_model=path,
                           device="cpu")
    tfirst = tlgb.train(p, tlgb.Dataset(x, y), 4, device="cpu")
    from_booster = tlgb.train(p, tlgb.Dataset(x, y), 4, init_model=tfirst,
                              device="cpu")
    want = jb.predict(x, raw_score=True)
    for tb in (from_file, from_booster):
        assert tb.num_trees() == jb.num_trees() == 8
        assert tb._gbdt.num_init_iteration == 4
        _assert_same_splits(tb._gbdt.models[4:], jb._gbdt.models[4:], x)
        np.testing.assert_allclose(tb.predict(x, raw_score=True), want,
                                   rtol=1e-4, atol=1e-4)
        # the training scores start from the continued model
        np.testing.assert_allclose(tb._gbdt.score_updater.score[0].numpy(),
                                   tb.predict(x, raw_score=True),
                                   rtol=0, atol=1e-5)


def _logloss_fobj(preds, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def _error_feval(preds, dataset):
    # the JAX package hands a validation set's feval its inner dataset
    y = dataset.get_label() if hasattr(dataset, "get_label") \
        else dataset.label
    return "error", float(np.mean((preds > 0) != (y > 0))), False


def test_fobj_and_feval_match_jax():
    xt, xv, jb, tb, jev, tev = _run_both(
        "binary", "masked", {"fobj": _logloss_fobj, "feval": _error_feval},
        rounds=5, metric=["auc"])
    assert tb._gbdt.objective is None and tb._gbdt._fused_step is None
    assert "objective=" not in tb.model_to_string().split("Tree=0")[0]
    assert set(tev["v"]) == {"auc", "error"}
    _assert_same_history(tev, jev)
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, xt)
    # no objective: predict returns the raw scores
    np.testing.assert_array_equal(tb.predict(xv),
                                  tb.predict(xv, raw_score=True))


def _leaves(booster, x, n_trees):
    return np.array([[t.predict_leaf_row(row) for t in
                      booster._gbdt.models[:n_trees]] for row in x])


@pytest.mark.parametrize("early_stopping_rounds", [None, 2])
def test_cv_matches_jax(early_stopping_rounds, monkeypatch):
    # a stratified 3-fold cv of 3 rounds, or with early stopping (which a
    # learning rate of 0.5 makes fire within the rounds)
    monkeypatch.setattr(jgbdt.GBDT, "_fused_eligible", lambda self: False)
    x, y = _task("binary")
    p = _params("binary", metric=["binary_logloss", "auc"])
    rounds, extra = 3, {"eval_train_metric": True}
    if early_stopping_rounds:
        rounds = 40
        p["learning_rate"] = 0.5
        extra["early_stopping_rounds"] = early_stopping_rounds
    want = jlgb.cv(p, jlgb.Dataset(x, y), rounds, nfold=3,
                   return_cvbooster=True, **extra)
    got = tlgb.cv(p, tlgb.Dataset(x, y), rounds, nfold=3, device="cpu",
                  return_cvbooster=True, **extra)
    jcv, tcv = want.pop("cvbooster"), got.pop("cvbooster")
    assert sorted(got) == sorted(want)
    n = len(want["valid auc-mean"])
    assert len(got["valid auc-mean"]) == n
    if early_stopping_rounds is None:
        assert n == rounds
    else:
        assert tcv.best_iteration == jcv.best_iteration == n < rounds - 2
    assert tcv.num_trees() == [rounds if early_stopping_rounds is None
                               else n + early_stopping_rounds] * 3
    for key in want:
        if early_stopping_rounds is None or key.startswith("training"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-4)
    if early_stopping_rounds is None:
        return
    # the held-out rows: per fold, those that reach another leaf of some
    # tree in the two packages (ties, see the module doc) are few, and on
    # the others every iteration's metrics agree
    folds = [t for _, t in tlgb.engine._make_n_folds(
        tlgb.Dataset(x, y), None, 3, 0, True, True)]
    for jb, tb, rows in zip(jcv.boosters, tcv.boosters, folds):
        xf, yf = x[rows], y[rows]
        sep = (_leaves(jb, xf, n) != _leaves(tb, xf, n)).any(axis=1)
        assert sep.mean() <= 0.02
        for m in (jmetric.BinaryLoglossMetric, jmetric.AUCMetric):
            metric = m(JConfig())
            metric.init(_Meta(yf[~sep], None), int((~sep).sum()))
            for it in range(1, n + 1):
                np.testing.assert_allclose(*[metric.eval(
                    b.predict(xf[~sep], raw_score=True, num_iteration=it),
                    jb._gbdt.objective) for b in (tb, jb)],
                    rtol=1e-4, atol=1e-4)


def _shared_scores(name, weighted):
    r = np.random.RandomState(7)
    n = 500
    if name in ("binary_logloss", "binary_error", "auc", "cross_entropy",
                "cross_entropy_lambda", "kldiv"):
        label = (r.rand(n) < 0.4).astype(np.float64)
        if name in ("cross_entropy", "kldiv"):
            label = np.where(label > 0, 0.2 + 0.7 * r.rand(n),
                             0.3 * r.rand(n))
    elif name in ("ndcg", "map"):
        # relevance grades 0..4
        label = r.randint(0, 5, n).astype(np.float64)
    elif name.startswith("multi_"):
        # 3 classes: (K, N) scores
        label = r.randint(0, 3, n).astype(np.float64)
        score = 0.05 + 0.9 * r.rand(3, n)
        weight = 0.5 + r.rand(n) if weighted else None
        return label, score, weight
    else:
        label = 0.05 + 2.0 * r.rand(n)
    score = 0.05 + 0.9 * r.rand(n)
    weight = 0.5 + r.rand(n) if weighted else None
    return label, score, weight


class _Meta:
    def __init__(self, label, weight, query_boundaries=None):
        self.label, self.weight = label, weight
        self.init_score = None
        self.query_boundaries = query_boundaries


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(tmetric.METRIC_NAMES))
def test_metric_matches_jax(name, weighted):
    assert len(tmetric.METRIC_NAMES) == 21
    label, score, weight = _shared_scores(name, weighted)
    params = {"alpha": 0.7, "fair_c": 0.8, "tweedie_variance_power": 1.3}
    jm = jmetric.create_metric(name, JConfig(params))
    tm = tmetric.create_metric(name, TConfig(params))
    # the ranking metrics read query groups: 50 queries of 10 rows
    qb = (np.arange(0, len(label) + 1, 10, dtype=np.int32)
          if name in ("ndcg", "map") else None)
    jm.init(_Meta(label, weight, qb), len(label))
    tm.init(_Meta(label, weight, qb), len(label))
    assert (tm.names, tm.higher_better) == (jm.names, jm.higher_better)
    np.testing.assert_allclose(tm.eval(score, None), jm.eval(score, None),
                               rtol=1e-12, atol=1e-12)


def test_default_metric_of_each_objective_matches_jax():
    assert tmetric._DEFAULT_FOR_OBJECTIVE == jmetric._DEFAULT_FOR_OBJECTIVE


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_metrics_of_unported_objectives_raise(name):
    # the ranking metrics on a dataset without query information raise
    # the JAX package's error
    x, y = _task("binary", n=200)
    with pytest.raises(LightGBMError,
                       match="%s metric requires query information"
                       % name.upper()):
        tlgb.train(_params("binary", metric=[name]), tlgb.Dataset(x, y), 1,
                   device="cpu")


def test_unported_resilience_seams_raise(tmp_path):
    x, y = _task("binary", n=200)
    with pytest.raises(LightGBMError, match="resume_from"):
        tlgb.train(_params("binary"), tlgb.Dataset(x, y), 1, device="cpu",
                   resume_from=str(tmp_path))
    with pytest.raises(LightGBMError, match="checkpoint"):
        tcallback.checkpoint(str(tmp_path))
    with pytest.raises(LightGBMError, match="record_telemetry"):
        tcallback.record_telemetry()


def test_cv_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    x, y = _task("binary", n=200)
    with pytest.raises(LightGBMError, match="CUDA"):
        tlgb.cv(_params("binary"), tlgb.Dataset(x, y), 1, nfold=2)
