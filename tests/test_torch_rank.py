"""Learning to rank: the port's query groups, lambdarank objective, ndcg
and map metrics and group-aware cv against the JAX package's on the same
numpy data.

* lambdarank's gradients and hessians from identical scores on ragged
  queries (1, 2, 7, 20 and 33 documents: L = 64 slots), with tied scores,
  a query whose labels are all equal, lambdamart_norm on and off, and row
  weights, within rtol 1e-5, atol 1e-7;
* ndcg and map at several eval_at within 1e-12;
* the query boundaries of subset and create_valid, and cv's folds, equal;
* end to end on bench.py's ranking data (make_ranking_like, 150 queries
  of 20 documents, 15 leaves, min_data_in_leaf 20), on the fused
  iteration of both packages (lambdarank's init score is 0, so the JAX
  fused iteration's doubled init score does not arise): compact float,
  masked float, compact quantized and compact float with bagging and
  feature_fraction, the same trees, predictions and
  the validation ndcg / map history within 1e-5. "The same trees" is the
  same partition of the training rows: where a leaf has no rows in the
  bins between two thresholds, both make its split and f32 rounding picks
  one in each package (ROADMAP section 3), so the validation queries are
  training rows with labels of their own (the JAX package's second
  sample), as in tests/test_torch_valid.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import engine as jengine
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import metric as jmetric
from lightgbm_tpu.objectives import objective as jobj
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metrics import metric as tmetric
from lightgbm_tpu_torch.objectives import objective as tobj
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

SIZES = [1, 2, 7, 20, 33]


def make_ranking_like(n_queries, docs_per_query, f, seed=17, w=None):
    """bench.py's make_ranking_like, draw for draw: query-grouped
    documents with grades 0..4 from a per-query shifted score."""
    r = np.random.RandomState(seed)
    n = n_queries * docs_per_query
    x = r.randn(n, f).astype(np.float32)
    if w is None:
        w = r.randn(f) * (r.rand(f) > 0.4)
    ctx = np.repeat(r.randn(n_queries, 1) * 0.5, docs_per_query, axis=0)
    score = x @ w * 0.4 + 0.2 * x[:, 0] * x[:, 1] + ctx[:, 0] \
        + r.randn(n) * 0.8
    edges = np.quantile(score, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(score, edges).astype(np.float64)
    group = np.full(n_queries, docs_per_query, dtype=np.int64)
    return x, y, group, w


def _ragged(seed=0):
    r = np.random.RandomState(seed)
    n = sum(SIZES)
    y = r.randint(0, 5, n).astype(np.float64)
    y[1:3] = 2.0                   # the 2-document query: equal labels
    return y, 0.5 + r.rand(n), r


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("norm", [True, False])
def test_lambdarank_gradients_match_jax(norm, weighted, tied):
    y, w, r = _ragged()
    n = len(y)
    cfg = {"objective": "lambdarank", "lambdamart_norm": norm}
    metas = []
    for meta in (JMetadata(n), TMetadata(n)):
        meta.set_label(y)
        meta.set_weight(w if weighted else None)
        meta.set_group(SIZES)
        metas.append(meta)
    jo = jobj.LambdarankNDCG(JConfig(cfg))
    jo.init(metas[0], n)
    to = tobj.LambdarankNDCG(TConfig(cfg))
    to.init(metas[1], n, "cpu")
    assert to.pad_len == jo.pad_len == 64
    for _ in range(3):
        score = r.randn(n).astype(np.float32)
        if tied:
            # ties within queries, and every score equal (the first
            # iteration's)
            score = np.round(score) if _ else np.zeros(n, np.float32)
        jg, jh = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
        tg, th = (a.numpy() for a in to.get_gradients(torch.from_numpy(score)))
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-7)
        # the one-document query and the equal-label query get nothing
        assert not tg[:3].any() and not th[:3].any()


def test_lambdarank_gradients_in_chunks(monkeypatch):
    # queries run in chunks of the pair budget: per query the same values
    y, w, r = _ragged(1)
    n = len(y)
    meta = TMetadata(n)
    meta.set_label(y)
    meta.set_group(SIZES)
    score = torch.from_numpy(r.randn(n).astype(np.float32))
    cfg = TConfig({"objective": "lambdarank"})
    whole = tobj.LambdarankNDCG(cfg)
    whole.init(meta, n, "cpu")
    monkeypatch.setattr(tobj, "_PAIR_BUDGET", 2 * 64 * 64)
    chunked = tobj.LambdarankNDCG(cfg)
    chunked.init(meta, n, "cpu")
    assert (whole._chunk, chunked._chunk) == (4096, 2)
    for a, b in zip(whole.get_gradients(score), chunked.get_gradients(score)):
        assert torch.equal(a, b)


class _Meta:
    def __init__(self, label, qb):
        self.label, self.weight = label, None
        self.init_score = None
        self.query_boundaries = qb


@pytest.mark.parametrize("eval_at", [[1, 3, 5], [10], [2, 40]])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metric_matches_jax(name, eval_at):
    y, _, r = _ragged(2)
    qb = np.concatenate([[0], np.cumsum(SIZES)]).astype(np.int32)
    jm = jmetric.create_metric(name, JConfig({"eval_at": eval_at}))
    tm = tmetric.create_metric(name, TConfig({"eval_at": eval_at}))
    jm.init(_Meta(y, qb), len(y))
    tm.init(_Meta(y, qb), len(y))
    assert (tm.names, tm.higher_better) == (jm.names, jm.higher_better)
    for score in (r.randn(len(y)), np.round(r.randn(len(y))),
                  np.zeros(len(y))):
        np.testing.assert_allclose(tm.eval(score, None), jm.eval(score, None),
                                   rtol=1e-12, atol=1e-12)


def test_query_boundaries_of_subset_and_create_valid():
    y, _, r = _ragged(3)
    x = r.randn(len(y), 4)
    rows = np.sort(r.choice(len(y), 40, replace=False))
    rows = np.union1d(rows, np.arange(10, 30))     # whole queries too
    out = []
    for lgb in (jlgb, tlgb):
        ds = lgb.Dataset(x, y, group=SIZES)
        sub = ds.subset(rows)
        valid = ds.create_valid(x[:30], y[:30], group=[1, 2, 7, 20])
        valid.construct()
        out.append((sub.get_group(), sub.get_field("group"),
                    sub._inner.metadata.query_boundaries,
                    valid._inner.metadata.query_boundaries,
                    ds.get_group()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    # set_group / set_field before and after construction
    ds = tlgb.Dataset(x, y)
    ds.set_field("group", SIZES)
    np.testing.assert_array_equal(ds.get_group(), SIZES)
    ds.set_group([len(y)])
    assert ds._inner.metadata.num_queries == 1


@pytest.mark.parametrize("shuffle", [False, True])
def test_cv_folds_keep_whole_queries(shuffle):
    y, _, r = _ragged(4)
    x = r.randn(len(y), 4)
    params = {"objective": "lambdarank", "verbosity": -1}
    jf = jengine._make_n_folds(jlgb.Dataset(x, y, group=SIZES), None, 3,
                               params, 7, True, shuffle)
    tf = tengine._make_n_folds(tlgb.Dataset(x, y, group=SIZES), None, 3, 7,
                               True, shuffle)
    assert len(jf) == len(tf) == 3
    for (jt, jv), (tt, tv) in zip(jf, tf):
        assert set(jt) == set(tt) and set(jv) == set(tv)

    class Splitter:
        def split(self, X, y, groups):
            self.groups = groups
            return [(np.arange(10), np.arange(10, len(X)))]
    sp = Splitter()
    tengine._make_n_folds(tlgb.Dataset(x, y, group=SIZES), sp, 3, 0, True,
                          shuffle)
    np.testing.assert_array_equal(sp.groups, np.repeat(np.arange(5), SIZES))


@functools.lru_cache(maxsize=None)
def _rank_data():
    x, y, g, w = make_ranking_like(150, 20, 8)
    _, yv, gv, _ = make_ranking_like(40, 20, 8, seed=4242, w=w)
    return x, y, g, x[:len(yv)], yv, gv


def _assert_same_partitions(trees_a, trees_b, x):
    """The same features and shapes, and every training row in the leaf
    of the same number in each tree."""
    def structure(trees):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves])) for t in trees]
    assert structure(trees_a) == structure(trees_b)
    for ta, tb in zip(trees_a, trees_b):
        assert [ta.predict_leaf_row(row) for row in x] \
            == [tb.predict_leaf_row(row) for row in x]


@pytest.mark.parametrize("strategy,quant,sampled", [
    ("compact", False, False), ("masked", False, False),
    ("compact", True, False), ("compact", False, True)])
def test_lambdarank_training_matches_jax(strategy, quant, sampled,
                                         monkeypatch):
    # sampled: bagging 0.7 and feature_fraction 0.8, the bag drawn in the
    # fused iteration from the same threefry key in both packages
    if strategy == "compact":
        monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y, g, xv, yv, gv = _rank_data()
    p = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
         "learning_rate": 0.1, "min_data_in_leaf": 20,
         "min_gain_to_split": 1e-3, "metric": ["ndcg", "map"],
         "eval_at": [1, 5, 10], "verbosity": -1}
    if quant:
        p.update(quantized_grad=True, grad_bits=8)
    if sampled:
        p.update(bagging_fraction=0.7, bagging_freq=1, feature_fraction=0.8)
    evs = []
    boosters = []
    for lgb, kw in ((jlgb, {}), (tlgb, {"device": "cpu"})):
        ds = lgb.Dataset(x, y, group=g)
        ev = {}
        boosters.append(lgb.train(
            p, ds, 5, valid_sets=[ds.create_valid(xv, yv, group=gv)],
            valid_names=["v"], evals_result=ev, verbose_eval=False, **kw))
        evs.append(ev)
    jb, tb = boosters
    gb = tb._gbdt
    assert gb.learner.strategy == strategy
    assert gb._fused_eligible() and gb._fused_step is not None
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees == 5
    _assert_same_partitions(gb.models, jb._gbdt.models, x)
    for xs in (x, xv):
        np.testing.assert_allclose(tb.predict(xs), jb.predict(xs),
                                   rtol=1e-5, atol=1e-5)
    assert list(evs[1]["v"]) == list(evs[0]["v"])
    for name in evs[0]["v"]:
        np.testing.assert_allclose(evs[1]["v"][name], evs[0]["v"][name],
                                   rtol=1e-5, atol=1e-5)
    # the validation scores are the trees' predictions
    np.testing.assert_allclose(gb.valid_updaters[0].host_scores()[0],
                               tb.predict(xv, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_ranking_needs_query_information():
    x, y, g, _, _, _ = _rank_data()
    with pytest.raises(LightGBMError, match="requires query information"):
        tlgb.train({"objective": "regression", "metric": ["map"],
                    "verbosity": -1}, tlgb.Dataset(x, y), 1, device="cpu")
    # a cv of lambdarank folds whole queries
    out = tlgb.cv({"objective": "lambdarank", "num_leaves": 7,
                   "verbosity": -1, "eval_at": [5]},
                  tlgb.Dataset(x, y, group=g), 2, nfold=3, device="cpu")
    assert list(out) == ["ndcg@5-mean", "ndcg@5-stdv"]
    assert len(out["ndcg@5-mean"]) == 2

