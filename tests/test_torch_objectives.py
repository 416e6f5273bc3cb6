"""The ten pointwise objectives beside binary and L2: the port's train()
(device="cpu") against the JAX package's on the same numpy data.

Every objective trains 6 rounds of 15 leaves on 3,000 x 8 rows (each
target drawn from one margin: noisy for the L2-like ones, Poisson or
Gamma counts for the log links, a probability for the cross-entropies),
with a validation set, on the compact and on the masked strategy of the
port, both held to one JAX run per objective (its own strategy at this
size, masked). The JAX side takes its generic iteration, whose
validation scores are right (ROADMAP section 3: its fused one adds the
init score twice). The
validation rows are training feature rows with fresh labels, so no
validation row lies between two thresholds that split the training rows
alike (the known tie of ROADMAP section 3 would route it each package's
way).

What is compared, and to what tolerance:

* the trees: the same partition of the training rows into leaves (two
  splits whose gains tie to ~1e-6, which the reference's biased float
  histogram orders, may come in the other order: cross_entropy_lambda's
  fifth tree does);
* raw training predictions and eval histories within 1e-5. The leaf
  renewal family (regression_l1, quantile, mape) renews every leaf from a
  percentile of f64 residuals and agrees exactly. fair and gamma are held
  within 1e-3: the JAX package's bf16 hi/lo histogram keeps ~16 bits per
  gradient, and on their cancelling gradient sums that moves a leaf by up
  to 2e-4; ``test_leaf_values_where_the_reference_is_biased`` shows the
  port's first tree within 1e-5 relative of the exact f64 leaf values and
  the reference farther.
The quantized runs (one per family) and the renewal under bagging are in
tests/test_torch_objectives_quantized.py.
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.objectives import objective as jobj
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.objectives import objective as tobj
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

OBJECTIVES = ["regression_l1", "huber", "fair", "poisson", "quantile",
              "mape", "gamma", "tweedie", "cross_entropy",
              "cross_entropy_lambda"]
RENEW = ("regression_l1", "quantile", "mape")
# the reference's histogram bias moves these leaves past 1e-5 (see above)
BIASED = ("fair", "gamma")


def _task(objective, n=3000, seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    x[r.rand(n) < 0.03, 2] = np.nan
    m = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 3] * x[:, 4]
    if objective in ("poisson", "tweedie"):
        y = r.poisson(np.exp(0.5 * m)).astype(np.float64)
    elif objective == "gamma":
        y = r.gamma(2.0, np.exp(0.5 * m) / 2.0)
    elif objective.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-(m + 0.5 * r.randn(n))))
    else:
        y = m + 0.5 * r.randn(n)
    return x, y


def _params(objective, **extra):
    return dict({"objective": objective, "num_leaves": 15, "max_bin": 63,
                 "learning_rate": 0.1, "min_data_in_leaf": 20,
                 "min_gain_to_split": 1e-3, "verbosity": -1}, **extra)


def _leaves(tree, x):
    """(N,) leaf of each row of x in a host tree (numerical splits; NaN
    takes the default side where the split's missing type is NaN, else
    counts as 0)."""
    node = np.zeros(len(x), dtype=np.int64)
    active = np.ones(len(x), dtype=bool)
    if tree.num_leaves <= 1:
        return node
    while active.any():
        idx = np.nonzero(active)[0]
        nd = node[idx]
        v = x[idx, np.asarray(tree.split_feature)[nd]]
        dt = np.asarray(tree.decision_type)[nd]
        nan = np.isnan(v)
        miss_nan = ((dt >> 2) & 3) == 2
        left = np.where(nan & miss_nan, (dt & 2) != 0,
                        np.where(nan, 0.0, v)
                        <= np.asarray(tree.threshold)[nd])
        nxt = np.where(left, np.asarray(tree.left_child)[nd],
                       np.asarray(tree.right_child)[nd])
        done = nxt < 0
        node[idx] = np.where(done, ~nxt, nxt)
        active[idx[done]] = False
    return node


def _partition(tree, x):
    """The training rows' grouping into leaves, whatever the numbering."""
    leaf = _leaves(tree, x)
    return sorted(tuple(np.nonzero(leaf == l)[0][:3]) + (int(
        (leaf == l).sum()),) for l in np.unique(leaf))


def _assert_same_partitions(trees_a, trees_b, x):
    assert len(trees_a) == len(trees_b)
    for ta, tb in zip(trees_a, trees_b):
        assert _partition(ta, x) == _partition(tb, x)


def _task_with_valid(objective):
    """Training rows and the validation set "v" (training feature rows,
    fresh labels)."""
    xt, yt = _task(objective)
    idx = np.random.RandomState(6).choice(len(xt), 1000, replace=False)
    return xt, yt, xt[idx], _task(objective, seed=6)[1][idx]


@functools.lru_cache(maxsize=None)
def _jax_run(objective, rounds=6):
    """(jb, jax evals): the JAX package's train() with the validation set,
    on its generic iteration and its own strategy at 3,000 rows (masked),
    once per objective: both of the port's strategies are held to it."""
    xt, yt, xv, yv = _task_with_valid(objective)
    mp = pytest.MonkeyPatch()
    mp.delenv("LGBM_TPU_STRATEGY", raising=False)
    mp.setattr(jgbdt.GBDT, "_fused_eligible", lambda self: False)
    try:
        jd, jev = jlgb.Dataset(xt, yt), {}
        jb = jlgb.train(_params(objective), jd, rounds,
                        valid_sets=[jd.create_valid(xv, yv)],
                        valid_names=["v"], evals_result=jev,
                        verbose_eval=False)
    finally:
        mp.undo()
    return jb, jev


def _run_both(objective, strategy, rounds=6):
    """(x, jb, tb, jax evals, port evals): train() of both packages with
    the validation set "v", the port on `strategy`."""
    xt, yt, xv, yv = _task_with_valid(objective)
    jb, jev = _jax_run(objective, rounds)
    mp = pytest.MonkeyPatch()
    if strategy == "compact":
        mp.setenv("LGBM_TPU_STRATEGY", "compact")
    else:
        mp.delenv("LGBM_TPU_STRATEGY", raising=False)
    try:
        td, tev = tlgb.Dataset(xt, yt), {}
        tb = tlgb.train(_params(objective), td, rounds,
                        valid_sets=[td.create_valid(xv, yv)],
                        valid_names=["v"], evals_result=tev,
                        verbose_eval=False, device="cpu")
    finally:
        mp.undo()
    return xt, jb, tb, jev, tev


@pytest.fixture(scope="module", params=[(o, s) for o in OBJECTIVES
                                        for s in ("compact", "masked")],
                ids=lambda p: "%s-%s" % p)
def run(request):
    objective, strategy = request.param
    return (objective, strategy) + _run_both(objective, strategy)


def test_objective_matches_jax(run):
    objective, strategy, x, jb, tb, jev, tev = run
    gb = tb._gbdt
    assert gb.learner.strategy == strategy
    assert gb.objective.name == objective
    # the renewal family takes the generic iteration, the others the fused
    assert (gb._fused_step is None) == (objective in RENEW)
    assert tb.num_trees() == jb.num_trees() == 6
    _assert_same_partitions(jb._gbdt.models, gb.models, x)
    tol = 1e-3 if objective in BIASED else 1e-5
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=tol, atol=tol)
    assert list(tev) == list(jev) == ["training", "v"]
    for d in jev:
        assert list(tev[d]) == list(jev[d])
        for m in jev[d]:
            np.testing.assert_allclose(tev[d][m], jev[d][m], rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("objective", BIASED)
def test_leaf_values_where_the_reference_is_biased(objective):
    # the first tree's leaf values against the exact ones: -G / H of each
    # leaf's rows in f64 (the port's gradients at the init score), shrunk,
    # plus the init score; the port within 1e-5 relative (its split scan
    # adds the histogram's f32 bins), the JAX package (its first tree,
    # shared with test_objective_matches_jax) farther
    x, y = _task(objective)
    jb, _ = _jax_run(objective)
    tb = tlgb.train(_params(objective), tlgb.Dataset(x, y), 1, device="cpu")
    gb = tb._gbdt
    init = gb.objective.boost_from_score(0)
    g, h = (t.double().numpy() for t in gb.objective.get_gradients(
        torch.full((len(y),), init, dtype=torch.float32)))
    tree = gb.models[0]
    leaf = _leaves(tree, x)
    exact = np.array([-g[leaf == l].sum() / h[leaf == l].sum() * 0.1 + init
                      for l in range(tree.num_leaves)])
    port = np.asarray(tree.leaf_value[:tree.num_leaves])
    ref = np.asarray(jb._gbdt.models[0].leaf_value[:tree.num_leaves])
    assert (np.abs(port - exact) <= 1e-5 * np.abs(exact) + 1e-6).all()
    assert np.abs(ref - exact).max() > np.abs(port - exact).max()


@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("case", ["n=0", "n=1", "ties", "draw"])
@pytest.mark.parametrize("weighted", [False, True])
def test_percentile_matches_jax(weighted, case, alpha):
    r = np.random.RandomState(3)
    n = {"n=0": 0, "n=1": 1}.get(case, 101)
    v = r.randn(n)
    if case == "ties":
        v = np.round(v * 2.0) / 2.0           # a handful of distinct values
    w = 0.2 + r.rand(n) if weighted else None
    assert tobj._percentile(v, w, alpha) == jobj._percentile(v, w, alpha)


def test_model_text_round_trip(run):
    # JAX model text loads in the port (its objective string read back)
    # and predicts the JAX package's converted outputs; the port's own
    # text round-trips to the same predictions
    _, _, x, jb, tb, _, _ = run
    back = convert.booster_from_model_string(jb.model_to_string(),
                                             device="cpu")
    assert back._gbdt.objective.to_string() \
        == jb._gbdt.objective.to_string()
    np.testing.assert_allclose(back.predict(x), jb.predict(x), rtol=1e-6,
                               atol=1e-6)
    again = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_allclose(again.predict(x), tb.predict(x), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("text,attr,value", [
    ("regression sqrt", "sqrt", True), ("binary sigmoid:2", "sigmoid", 2.0),
    ("multiclass num_class:4", "num_class", 4),
    ("multiclassova num_class:3 sigmoid:1.5", "sigmoid", 1.5)])
def test_parse_objective_reads_what_to_string_writes(text, attr, value):
    from lightgbm_tpu_torch.config import Config
    o = tobj.parse_objective_from_model(text, Config())
    assert getattr(o, attr) == value and o.to_string() == text


@pytest.mark.parametrize("objective,label", [
    ("poisson", -1.0), ("gamma", -1.0), ("tweedie", -1.0),
    ("cross_entropy", 1.5), ("cross_entropy_lambda", -0.5)])
def test_labels_outside_the_objectives_range_raise(objective, label):
    x, y = _task("huber", n=200)
    y = np.abs(y) / (1.0 + np.abs(y))
    y[7] = label
    with pytest.raises(LightGBMError, match=objective):
        tlgb.train(_params(objective), tlgb.Dataset(x, y), 1, device="cpu")
