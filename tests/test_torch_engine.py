"""End to end: the port's train() vs the JAX package's, and model carry-over.

Ten rounds of binary and of L2 regression on the same numpy data. The JAX
side runs its compact strategy; its binary path is the fused single-program
iteration, which is not bit-identical to the generic path the port
follows, and torch.exp differs from jnp.exp in the last ulp, so the check
is on tree structure (features, children, leaf counts, and thresholds up to
empty bins: two thresholds with no training value between them make the
same split, and which one wins such a tie is decided by f32 rounding) and
on raw predictions within 1e-4. Models cross over both ways: the port's text
loads in both packages and in the vendored reference LightGBM CLI
(tools/oracle/lightgbm), and a JAX model loaded into the port -- as text
or as ensemble arrays -- predicts what JAX predicts to 1e-6 (the same f32
thresholds and leaf values, summed tree by tree in the same order).
"""
import os
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu_torch import convert
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


def _params(objective):
    return {"objective": objective, "num_leaves": 15, "max_bin": 63,
            "learning_rate": 0.1, "min_data_in_leaf": 20,
            "min_gain_to_split": 1e-3, "verbosity": -1}


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


@pytest.fixture(scope="module", params=["binary", "regression"])
def trained(request):
    objective = request.param
    x, y = _task(objective)
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_STRATEGY", "compact")
    try:
        jb = jlgb.train(_params(objective), jlgb.Dataset(x, y),
                        num_boost_round=10, verbose_eval=False)
        tb = tlgb.train(_params(objective), tlgb.Dataset(x, y),
                        num_boost_round=10, device="cpu")
    finally:
        mp.undo()
    return objective, x, jb, tb


def test_trees_and_predictions_match_jax(trained):
    objective, x, jb, tb = trained
    assert tb.num_trees() == jb.num_trees() == 10
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.predict(x), jb.predict(x),
                               rtol=1e-4, atol=1e-4)


def test_port_model_text_loads_in_both(trained, tmp_path):
    _, x, _, tb = trained
    text = tb.model_to_string()
    want = tb.predict(x, raw_score=True)
    back = convert.booster_from_model_string(text, device="cpu")
    assert back.model_to_string().split("feature importances:")[0] \
        == text.split("feature importances:")[0]
    np.testing.assert_allclose(back.predict(x, raw_score=True), want,
                               rtol=0, atol=1e-6)
    tb.save_model(str(tmp_path / "m.txt"))
    from_file = tlgb.Booster(model_file=str(tmp_path / "m.txt"),
                             device="cpu")
    np.testing.assert_array_equal(from_file.predict(x, raw_score=True),
                                  want)
    jback = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(jback.predict(x, raw_score=True), want,
                               rtol=0, atol=1e-6)


def test_training_metrics_match_jax(trained):
    # binary_logloss / l2 on the training scores, the default metric of
    # each objective, plus auc / rmse computed by the port's metrics
    objective, _, jb, tb = trained
    jm = {name: v for _, name, v, _ in jb.eval_train()}
    tm = {name: v for _, name, v, _ in tb.eval_train()}
    assert set(tm) == set(jm) and tm
    for name in tm:
        np.testing.assert_allclose(tm[name], jm[name], rtol=1e-4)


ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "oracle", "lightgbm")


def test_reference_cli_predicts_port_model(trained, tmp_path):
    if not os.path.exists(ORACLE):
        pytest.skip("reference oracle binary unavailable")
    _, x, _, tb = trained
    model = tmp_path / "port.txt"
    tb.save_model(str(model))
    data = tmp_path / "x.csv"
    np.savetxt(data, np.column_stack([np.zeros(len(x)), x]),
               delimiter=",", fmt="%.17g")
    out = tmp_path / "pred.txt"
    r = subprocess.run(
        [ORACLE, "task=predict", f"data={data}", f"input_model={model}",
         f"output_result={out}", "header=false", "label_column=0",
         "predict_raw_score=true", "verbosity=-1"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    # the CLI sums the trees' leaf values in f64, the port in f32
    np.testing.assert_allclose(np.loadtxt(out),
                               tb.predict(x, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_jax_model_predicts_equal_in_port(trained):
    _, x, jb, _ = trained
    want = jb.predict(x, raw_score=True)
    text = jb.model_to_string()
    tb = convert.booster_from_model_string(text, device="cpu")
    np.testing.assert_allclose(tb.predict(x, raw_score=True), want,
                               rtol=0, atol=1e-6)
    # the same trees write the same model text, byte for byte (the
    # parameters section reflects each booster's own Config)
    assert tb.model_to_string().split("\nparameters:")[0] \
        == text.split("\nparameters:")[0]
    arrays = jpredict.trees_to_arrays(jb._gbdt.models)
    ens = convert.ensemble_from_arrays(
        {k: np.asarray(v) for k, v in arrays._asdict().items()},
        device="cpu")
    raw = tpredict.predict_raw_ensemble(
        torch.as_tensor(x, dtype=torch.float32), ens,
        torch.zeros(ens.split_feature.shape[0], dtype=torch.int64), 1)
    np.testing.assert_allclose(raw[:, 0].numpy(), want, rtol=0, atol=1e-6)


def test_weights_and_init_score_match_jax(monkeypatch):
    x, y = _task("binary", n=2000, seed=8)
    r = np.random.RandomState(1)
    w = np.where(y > 0, 2.0, 1.0) * (0.5 + r.rand(len(y)))
    init = 0.3 * r.randn(len(y))
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    jb = jlgb.train(_params("binary"),
                    jlgb.Dataset(x, y, weight=w, init_score=init),
                    num_boost_round=5, verbose_eval=False)
    tb = tlgb.train(_params("binary"),
                    tlgb.Dataset(x, y, weight=w, init_score=init),
                    num_boost_round=5, device="cpu")
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key,value", [
    ("objective", "multiclass"), ("tree_learner", "voting"),
    ("tree_learner", "feature"), ("quantized_grad", True),
    ("tree_learner", "data"), ("stream_mode", "chunked")])
def test_out_of_slice_params_raise_naming_the_key(key, value):
    x, y = _task("binary", n=200)
    params = dict(_params("binary"), **{key: value})
    named = key
    if key in ("quantized_grad", "stream_mode"):
        # streaming runs on the serial learner only (streamed
        # data-parallel waits for a later part of the multi-GPU slice)
        params["tree_learner"] = "data"
    if (key, value) in (("quantized_grad", True), ("tree_learner", "data")):
        # quantized and sampled data-parallel runs train; streamed rows
        # under them are still refused, naming the stream
        params.update(bagging_freq=1, bagging_fraction=0.5,
                      stream_mode="chunked")
        named = "stream_mode"
    with pytest.raises(LightGBMError, match=named):
        tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=1,
                   device="cpu")


@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_quantized_training_matches_jax(strategy, monkeypatch):
    # compact forced through the environment, masked by auto (n < 65,536)
    # on both sides; the same threefry draws quantize the same gradients,
    # so the trees are the same, and the port's model text loads in the
    # JAX package
    x, y = _task("binary")
    if strategy == "compact":
        monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    else:
        monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)
    params = dict(_params("binary"), quantized_grad=True, grad_bits=8)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=10,
                    verbose_eval=False)
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=10,
                    device="cpu")
    assert tb._gbdt.learner.strategy == strategy
    assert tb.num_trees() == jb.num_trees() == 10
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    want = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(want, jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    jback = jlgb.Booster(model_str=tb.model_to_string())
    np.testing.assert_allclose(jback.predict(x, raw_score=True), want,
                               rtol=0, atol=1e-6)
