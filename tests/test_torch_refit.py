"""Booster.refit of the port against the JAX package's, and the device
leaf sums against the host loop.

A small model per objective (binary, regression, 3-class multiclass; 15
leaves) is trained in the JAX package; both packages read its model text
with the same params and refit it on new rows at decay_rate 0 and 0.9.
Leaf values agree within rtol 1e-5 and atol 1e-6, the JAX package's own
bound for its device refit against its host loop
(tests/test_continual_refit.py): the port sums each leaf's gradients in
f64 with index_add_, the JAX package in f32.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.continual import refit as trefit

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _task(objective, n, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    noisy = m + 0.5 * r.randn(n)
    if objective == "binary":
        return x, (noisy > 0).astype(np.float64)
    if objective == "multiclass":
        return x, np.digitize(noisy, [-0.7, 0.7]).astype(np.float64)
    return x, noisy


def _params(objective):
    p = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
         "learning_rate": 0.3, "max_bin": 63, "min_gain_to_split": 1e-3,
         "lambda_l2": 0.5, "verbosity": -1}
    if objective == "multiclass":
        p["num_class"] = 3
    return p


def _leaves(booster):
    return np.concatenate([t.leaf_value[:t.num_leaves]
                           for t in booster._gbdt.models])


@pytest.fixture(scope="module", params=["binary", "regression",
                                        "multiclass"])
def model(request):
    objective = request.param
    x, y = _task(objective, 2500, 21)
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_NO_VMAP_K", "1")
    try:
        b = jlgb.train(_params(objective), jlgb.Dataset(x, y), 5,
                       verbose_eval=False)
    finally:
        mp.undo()
    xn, yn = _task(objective, 1500, 22)
    return objective, b.model_to_string(), xn, yn


@pytest.mark.parametrize("decay", [0.0, 0.9])
def test_refit_matches_jax(model, decay):
    objective, text, xn, yn = model
    jb = jlgb.Booster(params=_params(objective), model_str=text)
    tb = tlgb.Booster(params=_params(objective), model_str=text,
                      device="cpu")
    before = _leaves(tb)
    jb.refit(xn, yn, decay_rate=decay)
    n0 = trefit.dispatches
    assert tb.refit(xn, yn, decay_rate=decay) is tb
    assert trefit.dispatches == n0 + 1
    np.testing.assert_allclose(_leaves(tb), _leaves(jb), rtol=1e-5,
                               atol=1e-6)
    assert np.max(np.abs(_leaves(tb) - before)) > 1e-3
    np.testing.assert_allclose(tb.predict(xn, raw_score=True),
                               jb.predict(xn, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_device_sums_match_the_host_loop(model, monkeypatch):
    objective, text, xn, yn = model
    dev = tlgb.Booster(params=_params(objective), model_str=text,
                       device="cpu").refit(xn, yn, decay_rate=0.5)
    monkeypatch.setenv("LGBM_TPU_HOST_REFIT", "1")
    n0 = trefit.dispatches
    host = tlgb.Booster(params=_params(objective), model_str=text,
                        device="cpu").refit(xn, yn, decay_rate=0.5)
    assert trefit.dispatches == n0
    np.testing.assert_allclose(_leaves(dev), _leaves(host), rtol=1e-5,
                               atol=1e-6)


def test_refit_drops_the_cached_ensemble(model):
    objective, text, xn, yn = model
    tb = tlgb.Booster(params=_params(objective), model_str=text,
                      device="cpu")
    before = tb.predict(xn, raw_score=True)
    assert tb._gbdt._ensemble_cache
    tb.refit(xn, yn, decay_rate=0.0)
    after = tb.predict(xn, raw_score=True)
    assert np.max(np.abs(after - before)) > 1e-3
    fresh = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    np.testing.assert_allclose(after, fresh.predict(xn, raw_score=True),
                               rtol=0, atol=1e-6)


def test_leaf_stats_sum_every_segment():
    r = np.random.RandomState(3)
    leaves = r.randint(0, 7, size=(500, 4)).astype(np.int32)
    g = torch.as_tensor(r.randn(2, 500).astype(np.float32))
    h = torch.as_tensor(r.rand(2, 500).astype(np.float32))
    got = trefit.leaf_stats(leaves, g, h, num_tree_per_iteration=2,
                            max_leaves=7)
    for t in range(4):
        for leaf in range(7):
            rows = leaves[:, t] == leaf
            gk, hk = g[t % 2].double().numpy(), h[t % 2].double().numpy()
            np.testing.assert_allclose(
                got[t, leaf], [gk[rows].sum(), hk[rows].sum(), rows.sum()],
                rtol=1e-12, atol=1e-12)


def test_refit_of_model_text_takes_its_objective(model):
    # the model text's objective line, not the config's default
    # (regression): the JAX package refits a model read from text with
    # the objective of its params only
    objective, text, xn, yn = model
    p = _params(objective)
    bare = tlgb.Booster(params={"learning_rate": p["learning_rate"],
                                "lambda_l2": p["lambda_l2"]},
                        model_str=text, device="cpu")
    full = tlgb.Booster(params=p, model_str=text, device="cpu")
    bare.refit(xn, yn, decay_rate=0.5)
    full.refit(xn, yn, decay_rate=0.5)
    np.testing.assert_array_equal(_leaves(bare), _leaves(full))
