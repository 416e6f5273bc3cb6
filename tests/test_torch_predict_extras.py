"""Prediction extras of the port against the JAX package: leaf indices,
TreeSHAP contributions, prediction early stopping, sparse input in row
batches and the chunked leaf walk.

One small model per task is trained in the JAX package (binary with NaNs,
3-class multiclass, binary with two categorical columns; 15 leaves, 2,500
rows) and its model text is read by both packages, so both predict from the
same trees. Tolerances: leaf indices equal; contributions within 1e-9
absolute (the same f64 recursion on the host); early-stopped raw scores
within 1e-6 (f32 sums of each chunk of trees, added in f64); sparse input
equal to dense; the walk in tree chunks bit-equal to the walk in one.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch.ops import predict as tpredict

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

ROUNDS = 6


def _task(kind, n=2500, seed=11):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    if kind == "categorical":
        for j in (4, 5):
            cats = r.randint(0, 9, n)
            x[:, j] = cats
            m = m + (cats % 3 - 1) * 0.8
    else:
        x[r.rand(n) < 0.05, 2] = np.nan
        x[r.rand(n) < 0.1, 3] = 0.0
    noisy = m + 0.5 * r.randn(n)
    if kind == "multiclass":
        return x, np.digitize(noisy, [-0.7, 0.7]).astype(np.float64)
    return x, (noisy > 0).astype(np.float64)


def _params(kind):
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "learning_rate": 0.3, "max_bin": 63, "min_gain_to_split": 1e-3,
         "verbosity": -1}
    if kind == "multiclass":
        p.update(objective="multiclass", num_class=3)
    if kind == "categorical":
        p["categorical_feature"] = "4,5"
    return p


@pytest.fixture(scope="module", params=["binary", "multiclass",
                                        "categorical"])
def models(request):
    kind = request.param
    x, y = _task(kind)
    mp = pytest.MonkeyPatch()
    # the JAX package's batched-class path is red: its per-class loop
    mp.setenv("LGBM_TPU_NO_VMAP_K", "1")
    try:
        trained = jlgb.train(_params(kind), jlgb.Dataset(x, y), ROUNDS,
                             verbose_eval=False)
    finally:
        mp.undo()
    text = trained.model_to_string()
    xq = _task(kind, n=600, seed=12)[0]
    return (kind, jlgb.Booster(model_str=text),
            tlgb.Booster(model_str=text, device="cpu"), xq)


def test_pred_leaf_equals_jax(models):
    kind, jb, tb, xq = models
    for window in ({}, {"num_iteration": 2}, {"start_iteration": 3},
                   {"start_iteration": 1, "num_iteration": 3}):
        want = jb.predict(xq, pred_leaf=True, **window)
        got = tb.predict(xq, pred_leaf=True, **window)
        assert got.dtype == np.int32 and got.shape == want.shape
        assert np.array_equal(got, want), window


def test_pred_contrib_matches_jax(models):
    kind, jb, tb, xq = models
    want = jb.predict(xq[:40], pred_contrib=True)
    got = tb.predict(xq[:40], pred_contrib=True)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-9
    # each class block sums to that class's raw score
    raw = tb.predict(xq[:40], raw_score=True).reshape(40, -1)
    k = raw.shape[1]
    sums = got.reshape(40, k, -1).sum(axis=2)
    assert np.max(np.abs(sums - raw)) <= 1e-5


@pytest.mark.parametrize("freq,margin", [(1, 0.5), (2, 1.5), (3, 4.0),
                                         (10, 10.0)])
def test_pred_early_stop_matches_jax(models, freq, margin):
    kind, jb, tb, xq = models
    for window in ({}, {"start_iteration": 1, "num_iteration": 4}):
        kw = dict(raw_score=True, pred_early_stop=True,
                  pred_early_stop_freq=freq,
                  pred_early_stop_margin=margin, **window)
        want = jb.predict(xq, **kw)
        got = tb.predict(xq, **kw)
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 1e-6, (freq, margin, window)
    # a tight margin stops rows early; the rows that stopped summed fewer
    # trees than the model has
    tb.predict(xq, pred_early_stop=True, pred_early_stop_freq=1,
               pred_early_stop_margin=0.5)
    used = tb._gbdt.last_early_stop_trees
    assert used.min() < tb.num_trees() and used.max() == tb.num_trees()


def test_sparse_predict_across_batches_equals_dense(models, monkeypatch):
    kind, jb, tb, xq = models
    dense = np.where(np.abs(xq) < 0.7, 0.0, xq)
    dense[np.isnan(dense)] = 0.0
    csr = sp.csr_matrix(dense)
    monkeypatch.setattr(tbasic, "_SPARSE_PREDICT_BATCH", 64)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True}):
        want = tb.predict(dense, **kw)
        got = tb.predict(csr, **kw)
        assert np.array_equal(got, want), kw
    assert np.array_equal(tb.predict(csr.tocsc()), tb.predict(dense))


def test_chunked_walk_is_bit_equal(models, monkeypatch):
    kind, jb, tb, xq = models
    raw = tb.predict(xq, raw_score=True)
    leaves = tb.predict(xq, pred_leaf=True)
    tb._gbdt.invalidate_ensemble_cache()
    # two trees per chunk of the walk
    monkeypatch.setattr(tpredict, "WALK_ELEMENTS", 2 * len(xq))
    assert len(tpredict.tree_chunks(len(xq), tb.num_trees())) > 2
    assert np.array_equal(tb.predict(xq, raw_score=True), raw)
    assert np.array_equal(tb.predict(xq, pred_leaf=True), leaves)


# ---- a random forest: averaged early stop and contributions -------------

RF_ROUNDS = 4


@pytest.fixture(scope="module")
def rf_models():
    """A binary random forest (bagging 0.7, 4 iterations of 7 leaves,
    2,000 x 6 rows from seed 3) trained in the JAX package, read by both
    packages, and its first 300 rows."""
    r = np.random.RandomState(3)
    x = r.randn(2000, 6)
    y = ((1.5 * x[:, 0] - x[:, 1] + 0.5 * r.randn(2000)) > 0) \
        .astype(np.float64)
    params = {"objective": "binary", "boosting": "rf", "num_leaves": 7,
              "bagging_fraction": 0.7, "bagging_freq": 1,
              "min_data_in_leaf": 20, "verbosity": -1}
    text = jlgb.train(params, jlgb.Dataset(x, y), RF_ROUNDS,
                      verbose_eval=False).model_to_string()
    assert "average_output" in text
    return (jlgb.Booster(model_str=text),
            tlgb.Booster(model_str=text, device="cpu"), x[:300])


def _rf_f32_tree_scores(tb, xq):
    """(N, T) each tree's f32 leaf value of each row, in f64: what the
    walk adds per tree."""
    leaves = tb.predict(xq, pred_leaf=True)
    return np.stack([np.float32(t.leaf_value[leaves[:, i]])
                     for i, t in enumerate(tb._gbdt.models)],
                    axis=1).astype(np.float64)


def test_rf_early_stop_without_stops_is_averaged(rf_models):
    jb, tb, xq = rf_models
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=10, pred_early_stop_margin=1e9)
    got = tb.predict(xq, **kw)
    assert (tb._gbdt.last_early_stop_trees == RF_ROUNDS).all()
    raw = tb.predict(xq, raw_score=True)
    assert np.max(np.abs(got - raw)) <= 1e-9
    # the JAX package sums the trees (ROADMAP.md section 3): its output
    # divided by the iterations
    assert np.max(np.abs(got - jb.predict(xq, **kw) / RF_ROUNDS)) <= 1e-9


def test_rf_early_stop_that_stops_matches_a_loop_over_the_trees(rf_models):
    jb, tb, xq = rf_models
    got = tb.predict(xq, raw_score=True, pred_early_stop=True,
                     pred_early_stop_freq=1, pred_early_stop_margin=2.0)
    per_tree = _rf_f32_tree_scores(tb, xq)
    want = np.zeros(len(xq))
    for i in range(len(xq)):
        s, used = 0.0, 0
        for v in per_tree[i]:
            s += v
            used += 1
            if 2.0 * abs(s) > 2.0:
                break
        want[i] = s / used
    assert (tb._gbdt.last_early_stop_trees < RF_ROUNDS).any()
    assert np.max(np.abs(got - want)) <= 1e-9


def test_rf_contributions_sum_to_the_averaged_score(rf_models):
    jb, tb, xq = rf_models
    got = tb.predict(xq[:60], pred_contrib=True)
    # each row sums to the f64 mean of its leaves' values, and to the
    # raw score within its f32 rounding (the walk sums in f32)
    leaves = tb.predict(xq[:60], pred_leaf=True)
    mean = np.mean([t.leaf_value[leaves[:, i]]
                    for i, t in enumerate(tb._gbdt.models)], axis=0)
    assert np.max(np.abs(got.sum(axis=1) - mean)) <= 1e-9
    raw = tb.predict(xq[:60], raw_score=True)
    assert np.max(np.abs(got.sum(axis=1) - raw)) <= 1e-6
    want = jb.predict(xq[:60], pred_contrib=True) / RF_ROUNDS
    assert np.max(np.abs(got - want)) <= 1e-9
