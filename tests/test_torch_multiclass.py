"""multiclass (softmax) and multiclassova on the per-class loop: the port's
train() (device="cpu") against the JAX package's on the same numpy data.

Three classes cut from one noisy margin, 3,000 x 8 rows, 15 leaves. The
port grows each iteration's K trees one after another in its device loop
(the generic iteration; one learner, so one captured step). The JAX side
runs its per-class loop too: LGBM_TPU_NO_VMAP_K=1 turns off its batched
path (``train_batched``, whose test is red: ROADMAP section 3), and a
multiclass iteration of either package is never fused. Validation rows are
training feature rows with fresh labels (see tests/test_torch_objectives.py).
Trees are compared as partitions of the training rows, raw scores,
probabilities and eval histories within 1e-5.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.utils.log import LightGBMError

from test_torch_objectives import _assert_same_partitions

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

K = 3


def _task(n=3000, seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    x[r.rand(n) < 0.03, 2] = np.nan
    m = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
    y = np.digitize(m + 0.5 * r.randn(n), [-1.0, 1.0]).astype(np.float64)
    return x, y


def _params(objective, **extra):
    return dict({"objective": objective, "num_class": K, "num_leaves": 15,
                 "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
                 "min_gain_to_split": 1e-3, "verbosity": -1,
                 "metric": ["multi_logloss", "multi_error"]}, **extra)


@pytest.fixture(autouse=True)
def per_class_loop(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_NO_VMAP_K", "1")


def _valid(x):
    idx = np.random.RandomState(6).choice(len(x), 1000, replace=False)
    return x[idx], _task(seed=6)[1][idx]


@pytest.fixture(scope="module", params=[(o, s) for o in
                                        ("multiclass", "multiclassova")
                                        for s in ("compact", "masked")],
                ids=lambda p: "%s-%s" % p)
def run(request):
    objective, strategy = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_NO_VMAP_K", "1")
    if strategy == "compact":
        mp.setenv("LGBM_TPU_STRATEGY", "compact")
    else:
        mp.delenv("LGBM_TPU_STRATEGY", raising=False)
    x, y = _task()
    xv, yv = _valid(x)
    try:
        out = [objective, strategy, x]
        for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
            ds, ev = lgb.Dataset(x, y), {}
            out += [lgb.train(_params(objective), ds, 5,
                              valid_sets=[ds.create_valid(xv, yv)],
                              valid_names=["v"], evals_result=ev,
                              verbose_eval=False, **kw), ev]
    finally:
        mp.undo()
    return out


def test_multiclass_matches_jax(run):
    objective, strategy, x, jb, jev, tb, tev = run
    gb = tb._gbdt
    assert gb.learner.strategy == strategy
    assert gb.num_tree_per_iteration == K and gb._fused_step is None
    assert tb.num_trees() == jb.num_trees() == 5 * K
    # one learner grows every class's tree: one capture, one sync a tree
    assert gb.learner.stats.captures == 1
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees == 5 * K
    _assert_same_partitions(jb._gbdt.models, gb.models, x)
    raw = tb.predict(x, raw_score=True)
    assert raw.shape == (len(x), K)
    np.testing.assert_allclose(raw, jb.predict(x, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    prob = tb.predict(x)
    assert prob.shape == (len(x), K)
    np.testing.assert_allclose(prob, jb.predict(x), rtol=1e-5, atol=1e-5)
    if objective == "multiclass":
        np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=0,
                                   atol=1e-6)
    # the training scores are the per-class sums of the trees
    np.testing.assert_allclose(gb.score_updater.score.numpy().T, raw,
                               rtol=0, atol=1e-5)
    assert list(tev) == list(jev) == ["training", "v"]
    for d in jev:
        assert list(tev[d]) == list(jev[d]) == ["multi_logloss",
                                                 "multi_error"]
        for m in jev[d]:
            np.testing.assert_allclose(tev[d][m], jev[d][m], rtol=1e-5,
                                       atol=1e-5)


def test_model_text_round_trip(run):
    _, _, x, jb, _, tb, _ = run
    text = tb.model_to_string()
    assert "num_class=%d" % K in text \
        and "num_tree_per_iteration=%d" % K in text
    back = convert.booster_from_model_string(jb.model_to_string(),
                                             device="cpu")
    np.testing.assert_allclose(back.predict(x), jb.predict(x), rtol=1e-6,
                               atol=1e-6)
    jback = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(jback.predict(x, raw_score=True),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)


def test_early_stopping_on_multi_logloss():
    # learning_rate 0.5 overfits within the rounds: both packages stop at
    # the same best iteration with the same history
    x, y = _task()
    xv, yv = _valid(x)
    p = _params("multiclass", learning_rate=0.5, metric=["multi_logloss"])
    out = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds, ev = lgb.Dataset(x, y), {}
        b = lgb.train(p, ds, 30, valid_sets=[ds.create_valid(xv, yv)],
                      valid_names=["v"], evals_result=ev,
                      early_stopping_rounds=3, verbose_eval=False, **kw)
        out.append((b, ev))
    (jb, jev), (tb, tev) = out
    assert 1 <= tb.best_iteration == jb.best_iteration < 25
    np.testing.assert_allclose(tev["v"]["multi_logloss"],
                               jev["v"]["multi_logloss"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(xv), jb.predict(xv), rtol=1e-5,
                               atol=1e-5)


def test_stratified_cv_matches_jax():
    # 3 folds stratified by class, the same rows in each fold; a fold's
    # held-out rows are not its training rows, so a tied threshold can
    # route a few each package's way: held to the existing cv test's 1e-4
    # (tests/test_torch_valid.py)
    x, y = _task()
    p = _params("multiclass", metric=["multi_logloss"])
    jr = jlgb.cv(p, jlgb.Dataset(x, y), 3, nfold=3, verbose_eval=False)
    tr = tlgb.cv(p, tlgb.Dataset(x, y), 3, nfold=3, device="cpu")
    assert sorted(tr) == sorted(jr)
    for key in jr:
        np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-4)
    folds = tlgb.engine._make_n_folds(tlgb.Dataset(x, y), None, 3, 0, True,
                                      True)
    for _, rows in folds:
        # stratified: every fold holds each class in its share
        share = np.bincount(y[rows].astype(int), minlength=K) \
            / np.bincount(y.astype(int), minlength=K)
        assert np.allclose(share, 1.0 / 3, atol=0.01)


def test_rollback_takes_out_every_class_tree():
    x, y = _task()
    p = _params("multiclassova")
    tb = tlgb.train(p, tlgb.Dataset(x, y), 4, device="cpu")
    short = tlgb.train(p, tlgb.Dataset(x, y), 3, device="cpu")
    tb.rollback_one_iter()
    assert tb.num_trees() == short.num_trees() == 3 * K
    np.testing.assert_allclose(tb._gbdt.score_updater.score.numpy().T,
                               short.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.predict(x), short.predict(x), rtol=0,
                               atol=1e-6)


def test_a_class_without_rows_gets_constant_trees():
    # no row of class 2: it does not train (class_need_train) and gets a
    # constant tree of its boost-from-score in the first iteration
    x, y = _task()
    y = np.minimum(y, 1.0)
    p = _params("multiclass", metric=["multi_logloss"])
    jb = jlgb.train(p, jlgb.Dataset(x, y), 3, verbose_eval=False)
    tb = tlgb.train(p, tlgb.Dataset(x, y), 3, device="cpu")
    assert [t.num_leaves for t in tb._gbdt.models] \
        == [t.num_leaves for t in jb._gbdt.models]
    assert tb._gbdt.models[2].num_leaves == 1
    np.testing.assert_allclose(tb.predict(x), jb.predict(x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("params,key", [
    ({"objective": "lambdarank"}, "objective=lambdarank"),
    ({"objective": "binary", "num_class": 3}, "num_class=3"),
    ({"objective": "multiclass"}, "num_class"),
    ({"objective": "multiclassova", "num_class": 1}, "num_class")])
def test_out_of_slice_multiclass_params_raise(params, key):
    x, y = _task(n=200)
    with pytest.raises(LightGBMError, match=key):
        tlgb.train(dict(params, verbosity=-1), tlgb.Dataset(x, y), 1,
                   device="cpu")
