"""DART and random forest: the port's Booster (device="cpu") against the
JAX package's on the same numpy data, and JAX model text of each boosting
mode read by the port.

Both packages run DART and RF on the generic iteration. Each run has a
validation set, and is compared iteration by iteration: the trees (the
same splits of the training rows), DART's drop sets, the validation
metrics, and at the end the raw predictions, within 1e-5.

The JAX package's DART rescales a dropped tree's leaves to another weight
than the one its training and validation scores carry (its _normalize
ends with a shrinkage of -1 / k that LightGBM's DART::Normalize does not
have, and in xgboost_dart_mode puts (1 + k) / k where LightGBM puts
k / learning_rate), so its predictions differ from its own scores, and a
tree dropped a second time leaves its scores wrong too. The port keeps
LightGBM's weights. Outside xgboost_dart_mode the JAX package's training
and validation scores are LightGBM's until a tree is dropped a second
time: up to that round the port is held to the JAX package unpatched
(test_dart_scores_match_unpatched_jax). Beyond it, and for predictions,
`_lightgbm_normalize`, LightGBM's arithmetic, is patched into the JAX
side (test_dart_matches_jax).
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.models import gbdt as jgbdt
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

ROUNDS = 6


def _task(objective, n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    m = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
    y = m + 0.5 * r.randn(n)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(y, [-0.5, 0.5]).astype(np.float64)
    return x, y


def _params(objective, **extra):
    return dict({"objective": objective, "num_leaves": 15, "max_bin": 63,
                 "learning_rate": 0.3, "min_data_in_leaf": 20,
                 "min_gain_to_split": 1e-3, "verbosity": -1}, **extra)


def _lightgbm_normalize(self, drop_index):
    """DART::Normalize of LightGBM (src/boosting/dart.hpp): each dropped
    tree holds -w after the drop; the validation scores lose w / (k + 1)
    of it (xgboost_dart_mode: w * lr / (lr + k)), the training scores get
    the rest back, and the tree keeps that weight."""
    cfg = self.config
    lr = cfg.learning_rate
    self.invalidate_ensemble_cache()
    k = float(len(drop_index))
    per = self.num_tree_per_iteration
    for i in drop_index:
        for c in range(per):
            tree = self.models[i * per + c]
            tree.apply_shrinkage(self.shrinkage_rate if cfg.xgboost_dart_mode
                                 else 1.0 / (k + 1.0))
            for vu in self.valid_updaters:
                vu.add_tree(tree, c)
            tree.apply_shrinkage(-k / lr if cfg.xgboost_dart_mode else -k)
            self.score_updater.add_tree(tree, c)
        if not cfg.uniform_drop:
            ti = i - self.num_init_iteration
            extra = lr if cfg.xgboost_dart_mode else 1.0
            self._sum_weight -= self._tree_weights[ti] / (k + extra)
            self._tree_weights[ti] *= k / (k + extra)
    self._tree_weights.append(self.shrinkage_rate)
    self._sum_weight += self.shrinkage_rate


def _run(lgb, params, data, rounds=ROUNDS, **kw):
    """Train iteration by iteration with a validation set: (booster,
    validation history, drop sets, training scores)."""
    x, y, xv, yv = data
    ds = lgb.Dataset(x, y)
    b = lgb.Booster(params=params, train_set=ds, **kw)
    b.add_valid(ds.create_valid(xv, yv), "v")
    hist, drops = [], []
    for _ in range(rounds):
        b.update()
        hist.append([v for _, _, v, _ in b.eval_valid()])
        drops.append(list(getattr(b._gbdt, "drop_index", None)
                          or getattr(b._gbdt, "_drop_index", [])))
    score = np.asarray(b._gbdt.score_updater.score, dtype=np.float64)
    return b, np.asarray(hist), drops, score[0] if len(score) == 1 \
        else score.T


def _structure(trees):
    return [(list(t.split_feature[:t.num_leaves - 1]),
             list(t.left_child[:t.num_leaves - 1]),
             list(t.right_child[:t.num_leaves - 1])) for t in trees]


def _assert_same_splits(trees_a, trees_b, x):
    assert _structure(trees_a) == _structure(trees_b)
    for ta, tb in zip(trees_a, trees_b):
        for node in range(ta.num_leaves - 1):
            col = x[:, ta.split_feature[node]]
            lo, hi = sorted((ta.threshold[node], tb.threshold[node]))
            assert not np.any((col > lo) & (col <= hi))


@functools.lru_cache(maxsize=None)
def _data(objective):
    return _task(objective, 3000, 5) + _task(objective, 1000, 6)


@functools.lru_cache(maxsize=None)
def _jax_run(objective, patched, extra):
    params = _params(objective, **{k: list(v) if isinstance(v, tuple)
                                   else v for k, v in extra})
    own = jgbdt.DART._normalize
    if patched:
        jgbdt.DART._normalize = _lightgbm_normalize
    try:
        return _run(jlgb, params, _data(objective))
    finally:
        jgbdt.DART._normalize = own


DART = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
DART_MODES = {
    "weighted": ("binary", {"metric": ["binary_logloss", "auc"]}),
    "uniform_drop": ("binary", {"uniform_drop": True, "metric": ["auc"]}),
    "xgboost_dart_mode": ("binary", {"xgboost_dart_mode": True,
                                     "max_drop": 2, "metric": ["auc"]}),
    # K trees per iteration, each class's dropped and rescaled
    "multiclass": ("multiclass", {"num_class": 3,
                                  "metric": ["multi_logloss"]})}


@pytest.mark.parametrize("mode", sorted(DART_MODES))
def test_dart_matches_jax(mode):
    objective, more = DART_MODES[mode]
    extra = tuple(sorted(dict(DART, **more).items(), key=lambda kv: kv[0]))
    jb, jhist, jdrops, _ = _jax_run(objective, True, _hashable(extra))
    tb, thist, tdrops, tscore = _run(
        tlgb, _params(objective, **dict(extra)), _data(objective),
        device="cpu")
    x = _data(objective)[0]
    assert tdrops == jdrops
    assert sum(len(d) for d in tdrops) >= 2
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    # the rescaled trees predict the training scores
    np.testing.assert_allclose(tb.predict(x, raw_score=True), tscore,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["weighted", "uniform_drop"])
def test_dart_scores_match_unpatched_jax(mode):
    # the JAX package's own DART, unpatched: its training and validation
    # scores follow LightGBM's weights until a tree is dropped a second
    # time (the drop then takes back the weight _normalize left in the
    # tree, not the one its scores carry), so both packages are compared
    # round by round up to that round
    more = {"uniform_drop": True} if mode == "uniform_drop" else {}
    params = _params("binary", drop_rate=0.3, skip_drop=0.0, drop_seed=7,
                     boosting="dart", metric=["binary_logloss", "auc"],
                     **more)
    x, y, xv, yv = _data("binary")
    runs = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(x, y)
        b = lgb.Booster(params=params, train_set=ds, **kw)
        b.add_valid(ds.create_valid(xv, yv), "v")
        runs.append((b, []))
    dropped, compared = set(), 0
    for _ in range(ROUNDS):
        for b, rounds in runs:
            b.update()
            g = b._gbdt
            rounds.append((list(getattr(g, "drop_index", None)
                                or getattr(g, "_drop_index", [])),
                           np.asarray(g.score_updater.score,
                                      dtype=np.float64)[0],
                           [v for _, _, v, _ in b.eval_valid()]))
        (jd, js, jv), (td, ts, tv) = runs[0][1][-1], runs[1][1][-1]
        assert td == jd
        if dropped & set(jd):
            break
        dropped |= set(jd)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
        compared += 1
    assert len(dropped) >= 3 and compared >= 4


def _hashable(items):
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in items)


RF = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1}


@pytest.mark.parametrize("objective,strategy", [
    ("binary", "masked"), ("binary", "compact"),
    ("regression_l1", "masked")])
def test_rf_matches_jax(objective, strategy, monkeypatch):
    # the JAX run on its own strategy at this size (masked); the port on
    # both: a bag of every strategy (compact: the bag's carry and the
    # router for the out-of-bag rows)
    metric = ["auc"] if objective == "binary" else ["l1", "l2"]
    extra = tuple(sorted(dict(RF, metric=metric).items(),
                         key=lambda kv: kv[0]))
    jb, jhist, _, jscore = _jax_run(objective, False, _hashable(extra))
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    tb, thist, _, tscore = _run(tlgb, _params(objective, **dict(extra)),
                                _data(objective), device="cpu")
    assert tb._gbdt.learner.strategy == strategy
    x = _data(objective)[0]
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tscore, jscore, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.predict(x, raw_score=True), tscore,
                               rtol=1e-5, atol=1e-5)
    assert "average_output" in tb.model_to_string().split("\n")


def _rank_task(n_queries=150, docs=20, seed=3):
    r = np.random.RandomState(seed)
    x = r.randn(n_queries * docs, 6)
    s = x[:, 0] - 0.5 * x[:, 1] + np.repeat(r.randn(n_queries), docs) \
        + 0.5 * r.randn(len(x))
    y = np.digitize(s, np.quantile(s, [0.5, 0.75, 0.9])).astype(np.float64)
    return x, y, np.full(n_queries, docs)


@pytest.mark.parametrize("mode", ["rf", "dart", "lambdarank"])
def test_jax_model_text_predicts_the_same(mode):
    # a random forest's text says average_output: the port averages its
    # trees as the JAX package does
    r = np.random.RandomState(11)
    if mode == "lambdarank":
        x, y, group = _rank_task()
        ds = jlgb.Dataset(x, y, group=group)
        params = {"objective": "lambdarank"}
    else:
        x = r.randn(2000, 6)
        y = (x[:, 0] + 0.5 * x[:, 1] + r.randn(2000) > 0).astype(float)
        ds = jlgb.Dataset(x, y)
        params = {"objective": "binary", "boosting": mode}
        if mode == "rf":
            params.update(bagging_fraction=0.6, bagging_freq=1)
        else:
            params.update(drop_rate=0.5, skip_drop=0.0)
    jb = jlgb.train(dict(params, num_leaves=7, verbosity=-1), ds, 4,
                    verbose_eval=False)
    tb = convert.booster_from_model_string(jb.model_to_string(),
                                           device="cpu")
    xt = r.randn(500, x.shape[1])
    np.testing.assert_allclose(tb.predict(xt, raw_score=True),
                               jb.predict(xt, raw_score=True),
                               rtol=0, atol=1e-6)
