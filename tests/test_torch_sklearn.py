"""The port's scikit-learn estimators against the JAX package's with the
same arguments (device="cpu" on the port's side).

At 15 leaves and min_child_samples 20 both packages grow the same trees
(the ground rule of the port's parity tests), so predictions on the
training rows agree within 1e-5. (A threshold between two training
values is the f32 rounding's choice in each package, so a row of other
data in between may go either way.) The JAX side runs its per-class loop
for multiclass (LGBM_TPU_NO_VMAP_K=1) and its generic iteration where a
validation set is evaluated (its fused one adds the init score twice to
validation scores). The JAX classifier passes eval_set labels uncoded, so
it gets them as 0 / 1; the port codes them as it codes the training
labels.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.models import gbdt as jgbdt
import lightgbm_tpu_torch as tlgb

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

ARGS = dict(num_leaves=15, n_estimators=5, learning_rate=0.3,
            min_child_samples=20, min_split_gain=1e-3, max_bin=63,
            verbosity=-1)


def _task(kind, n=2000, seed=41):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    if kind == "binary":
        return x, _label(x, r)
    noisy = m + 0.5 * r.randn(n)
    if kind == "multiclass":
        return x, np.digitize(noisy, [-0.7, 0.7]) * 10 + 5
    if kind == "rank":
        return x, np.clip(np.digitize(noisy, [-1, 0, 1]), 0, 3) \
            .astype(np.float64)
    return x, noisy


@pytest.fixture
def per_class_loop(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_NO_VMAP_K", "1")


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_classifier_matches_jax(kind, per_class_loop):
    x, y = _task(kind)
    xq = x[:400]
    jm = jlgb.LGBMClassifier(**ARGS).fit(x, y, verbose=False)
    tm = tlgb.LGBMClassifier(device="cpu", **ARGS).fit(x, y, verbose=False)
    assert np.array_equal(tm.classes_, jm.classes_)
    assert tm.n_classes_ == jm.n_classes_
    np.testing.assert_allclose(tm.predict_proba(xq), jm.predict_proba(xq),
                               rtol=0, atol=1e-5)
    assert np.array_equal(tm.predict(xq), jm.predict(xq))
    np.testing.assert_allclose(tm.predict(xq, raw_score=True),
                               jm.predict(xq, raw_score=True), rtol=0,
                               atol=1e-5)
    assert np.array_equal(tm.predict(xq, pred_leaf=True),
                          jm.predict(xq, pred_leaf=True))
    assert np.array_equal(tm.feature_importances_, jm.feature_importances_)
    assert tm.n_features_ == 6 and tm.objective_ == jm.objective_


def test_regressor_matches_jax():
    x, y = _task("regression")
    xq = x[::5]
    jm = jlgb.LGBMRegressor(reg_lambda=0.5, **ARGS).fit(x, y,
                                                        verbose=False)
    tm = tlgb.LGBMRegressor(reg_lambda=0.5, device="cpu", **ARGS) \
        .fit(x, y, verbose=False)
    np.testing.assert_allclose(tm.predict(xq), jm.predict(xq), rtol=0,
                               atol=1e-5)
    assert tm.booster_.num_trees() == 5


def test_ranker_matches_jax():
    x, y = _task("rank", 1800)
    group = [20] * 90
    xq = x[::4]
    kw = dict(ARGS, min_child_samples=20)
    jm = jlgb.LGBMRanker(**kw).fit(x, y, group=group, verbose=False)
    tm = tlgb.LGBMRanker(device="cpu", **kw).fit(x, y, group=group,
                                                 verbose=False)
    np.testing.assert_allclose(tm.predict(xq), jm.predict(xq), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="group"):
        tlgb.LGBMRanker(device="cpu").fit(x, y)


def _label(x, r):
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    return np.where(m + 0.5 * r.randn(len(x)) > 0.4, "yes", "no")


def test_eval_set_with_early_stopping_matches_jax(monkeypatch):
    x, y = _task("binary", 2500)
    monkeypatch.setattr(jgbdt.GBDT, "_fused_eligible", lambda self: False)
    kw = dict(ARGS, n_estimators=8, learning_rate=0.5)
    fit = dict(eval_metric="binary_logloss", early_stopping_rounds=3,
               verbose=False)
    # an evaluation set of training rows (a copy: another set), which
    # both packages' trees split alike
    xe, ye = x[:800].copy(), y[:800].copy()
    jm = jlgb.LGBMClassifier(**kw).fit(
        x, y, eval_set=[(xe, (ye == "yes").astype(float))], **fit)
    tm = tlgb.LGBMClassifier(device="cpu", **kw).fit(
        x, y, eval_set=[(xe, ye)], **fit)
    assert tm.best_iteration_ == jm.best_iteration_
    got = tm.evals_result_["valid_0"]["binary_logloss"]
    want = jm.evals_result_["valid_0"]["binary_logloss"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.evals_result_["training"]
                               ["binary_logloss"],
                               jm.evals_result_["training"]
                               ["binary_logloss"], rtol=0, atol=1e-5)
    # held-out rows stop the training early
    r = np.random.RandomState(43)
    xv = r.randn(800, 6)
    yv = _label(xv, r)
    stopped = tlgb.LGBMClassifier(device="cpu", **dict(kw, n_estimators=40))
    stopped.fit(x, y, eval_set=[(xv, yv)], **fit)
    best = stopped.best_iteration_
    hist = stopped.evals_result_["valid_0"]["binary_logloss"]
    assert 0 < best < 40 and len(hist) == best + 3
    assert stopped.best_score_["valid_0"]["binary_logloss"] \
        == pytest.approx(min(hist), abs=1e-12)
    np.testing.assert_array_equal(
        stopped.predict_proba(xv),
        stopped.predict_proba(xv, num_iteration=best))
    with pytest.raises(ValueError, match="absent"):
        tlgb.LGBMClassifier(device="cpu", **kw).fit(
            x, y, eval_set=[(xv, np.where(yv == "yes", "y", "n"))], **fit)


def test_class_weight_balanced_matches_jax():
    x, y = _task("binary")
    assert np.mean(y == "yes") < 0.45
    jm = jlgb.LGBMClassifier(class_weight="balanced", **ARGS) \
        .fit(x, y, verbose=False)
    tm = tlgb.LGBMClassifier(class_weight="balanced", device="cpu",
                             **ARGS).fit(x, y, verbose=False)
    w = tm._class_weights_to_sample_weight(y)
    assert np.allclose(np.bincount(y == "yes", weights=w), len(y) / 2)
    np.testing.assert_allclose(tm.predict_proba(x[:300]),
                               jm.predict_proba(x[:300]), rtol=0, atol=1e-5)
    plain = tlgb.LGBMClassifier(device="cpu", **ARGS).fit(x, y,
                                                          verbose=False)
    assert np.max(np.abs(plain.predict_proba(x[:300])
                         - tm.predict_proba(x[:300]))) > 1e-3


def test_get_and_set_params():
    m = tlgb.LGBMRegressor(num_leaves=7, device="cpu", reg_alpha=0.1,
                           min_data_per_group=50)
    params = m.get_params()
    want = jlgb.LGBMRegressor(num_leaves=7, reg_alpha=0.1,
                              min_data_per_group=50).get_params()
    assert params == dict(want, device="cpu")
    assert m.set_params(n_estimators=3, learning_rate=0.2,
                        device=None) is m
    assert m.n_estimators == 3 and m.get_params()["learning_rate"] == 0.2
    assert m.get_params()["device"] is None
    assert "device" not in m._process_params()
    assert m._process_params()["min_data_per_group"] == 50
    assert tlgb.LGBMRegressor(**params).get_params() == params


def test_not_fitted_raises():
    m = tlgb.LGBMClassifier(device="cpu")
    with pytest.raises(tlgb.LightGBMNotFittedError):
        m.predict(np.zeros((2, 6)))
    with pytest.raises(tlgb.LightGBMNotFittedError):
        m.booster_
    assert issubclass(tlgb.LightGBMNotFittedError, ValueError)
