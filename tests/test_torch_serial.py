"""The host-loop SerialTreeLearner of the port against the JAX package's,
and the learner factory, on the CPU.

With LGBM_TPU_HOST_LEARNER=1 both packages train with their serial
learner: float and quantized gradients (the serial learner's own key),
categorical features, bagging, feature_fraction and by-node sampling
(its own host RandomState draws, one per split), feature_contri and leaf
renewal (leaf_rows). Forced splits (a JSON file) and the CEGB penalties
(split, coupled, lazy) take the serial learner without the variable, in
both packages (``DeviceTreeLearner.supports`` says no), and so does a
histogram pool over 2 GB; the factory's choice is asserted by the
learner's class name on both sides.

Binary runs on the categorical tests' dyadic gradients (multiples of
1/64, hessian 0.25), so the float histograms are exact in both packages.
Model text: the lines are held key by key, integers (structure, counts,
features, decision types but for the default-left bit, which f32 rounding
decides where a leaf has no missing value: ROADMAP section 3) and
thresholds exactly, floats (gains, leaf values, weights) within 1e-4
relative: the split scans' f32 arithmetic rounds gains in the last digit
differently. The JAX loop takes num_leaves - 1 splits
after the forced ones and fails when a tree would grow past num_leaves,
so the forced-split parity runs at max_depth 3 (ROADMAP section 3); the
port's tree stops at num_leaves. 3000 rows, 15 leaves, 2 rounds.
"""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import \
    DeviceTreeLearner as JDeviceLearner
from lightgbm_tpu.parallel.learners import \
    create_tree_learner as jcreate
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
from lightgbm_tpu_torch.models.serial_learner import _bucket
from lightgbm_tpu_torch.ops import partition as tpart
from lightgbm_tpu_torch.parallel.learners import create_tree_learner
from test_torch_categorical import _cat_task, _dyadic_fobj
from test_torch_engine import _params, _task

torch.set_num_threads(1)

EXACT = ("num_leaves", "num_cat", "split_feature", "left_child",
         "right_child", "leaf_count", "internal_count", "cat_boundaries",
         "cat_threshold", "threshold", "max_feature_idx")

CASES = {
    "float": ("binary", {}),
    "quant": ("binary", {"quantized_grad": True, "grad_bits": 8}),
    "categorical": ("binary", {"cat": True}),
    "bagging": ("binary", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    "feature_fraction": ("binary", {"feature_fraction": 0.6}),
    "bynode": ("binary", {"feature_fraction_bynode": 0.5}),
    "contri": ("binary",
               {"feature_contri": [1.0, 0.5, 1.0, 1.0, 0.2, 1.0, 1.0]}),
    "l1_renew": ("regression_l1", {}),
}


def _assert_text_close(jtext, ttext):
    jl, tl = jtext.splitlines(), ttext.splitlines()
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a == b or a.startswith("tree_sizes="):
            continue
        key, _, va = a.partition("=")
        assert b.startswith(key + "="), (a, b)
        if key == "decision_type":
            # the default-left bit of a split whose leaf has no missing
            # value is a tie of the two scan directions (ROADMAP 3)
            da = [int(v) & ~2 for v in va.split()]
            assert da == [int(v) & ~2 for v in b.split("=")[1].split()]
            continue
        assert key not in EXACT, (a, b)
        fa = np.array(va.split(), dtype=np.float64)
        fb = np.array(b.partition("=")[2].split(), dtype=np.float64)
        np.testing.assert_allclose(fb, fa, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def _train_both(objective, extra, rounds=2, data=None):
    """Both packages' boosters; binary runs on dyadic gradients (every
    float histogram sum exact in both), regression_l1's are +-1."""
    x, y = data if data is not None else _task(objective)
    params = dict(_params(objective), **extra)
    kw = {}
    if params.pop("cat", False):
        kw["categorical_feature"] = [0, 1]
    fobj = dict(fobj=_dyadic_fobj) if objective == "binary" else {}
    jb = jlgb.train(params, jlgb.Dataset(x, y, **kw), num_boost_round=rounds,
                    verbose_eval=False, **fobj)
    tb = tlgb.train(params, tlgb.Dataset(x, y, **kw), num_boost_round=rounds,
                    device="cpu", **fobj)
    return x, jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_learner_matches_jax(case, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HOST_LEARNER", "1")
    objective, extra = CASES[case]
    data = None
    if extra.get("cat"):
        x, y, _ = _cat_task()
        data = (x, y)
    x, jb, tb = _train_both(objective, extra, data=data)
    for b in (jb, tb):
        assert type(b._gbdt.learner).__name__ == "SerialTreeLearner"
    assert not tb._gbdt._fused_eligible()
    learner = tb._gbdt.learner
    n_splits = sum(t.num_leaves - 1 for t in tb._gbdt.models)
    assert n_splits > 20
    # one fetch per split, and the root's
    assert learner.stats.host_syncs >= n_splits + len(tb._gbdt.models)
    if case == "categorical":
        assert "cat_threshold" in tb.model_to_string()
    if case == "float":
        # _scan_leaf re-scans a live leaf's histogram to its stored split
        mask = torch.ones(learner.num_features, dtype=torch.bool)
        live = [st for st in learner.leaves.values() if st.split is not None]
        assert live
        for st in live:
            assert learner._scan_leaf(st, mask) == st.split
    _assert_text_close(jb.model_to_string(), tb.model_to_string())
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def _forced(tmp_path, x):
    """Feature 0 at its median at the root, features 1 and 3 at theirs
    below it (the JSON's real feature indices and raw thresholds)."""
    med = np.nanmedian(x, axis=0)
    spec = {"feature": 0, "threshold": float(med[0]),
            "left": {"feature": 1, "threshold": float(med[1])},
            "right": {"feature": 3, "threshold": float(med[3])}}
    path = tmp_path / "forced_splits.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.parametrize("case", ["forced", "forced_quant", "cegb"])
def test_forced_splits_and_cegb_match_jax(case, tmp_path):
    x, y = _task("binary")
    if case.startswith("forced"):
        extra = {"forcedsplits_filename": _forced(tmp_path, x),
                 "max_depth": 3}
        if case == "forced_quant":
            extra.update(quantized_grad=True, grad_bits=8)
    else:
        extra = {"cegb_tradeoff": 1.0, "cegb_penalty_split": 0.05,
                 "cegb_penalty_feature_coupled": [5, 0, 0, 3, 0, 0, 0, 0],
                 "cegb_penalty_feature_lazy": [0, 0.01, 0, 0, 0, 0, 0, 0]}
    x, jb, tb = _train_both("binary", extra, data=(x, y))
    for b in (jb, tb):
        assert type(b._gbdt.learner).__name__ == "SerialTreeLearner"
    trees = tb._gbdt.models
    if case.startswith("forced"):
        for t in trees:
            assert list(t.split_feature[:3]) == [0, 1, 3]
    _assert_text_close(jb.model_to_string(), tb.model_to_string())
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    if case == "cegb":
        # the penalties prune: fewer leaves than the same run without
        plain = tlgb.train(_params("binary"), tlgb.Dataset(x, y), 2,
                           fobj=_dyadic_fobj, device="cpu")
        assert sum(t.num_leaves for t in trees) \
            < sum(t.num_leaves for t in plain._gbdt.models)
    else:
        # the JAX package's model text predicts the same in the port
        back = convert.booster_from_model_string(jb.model_to_string(),
                                                 device="cpu")
        np.testing.assert_allclose(back.predict(x, raw_score=True),
                                   jb.predict(x, raw_score=True), rtol=0,
                                   atol=1e-6)


def test_forced_splits_grow_to_num_leaves(tmp_path):
    # the port's tree stops at num_leaves with the forced splits on top
    x, y = _task("binary")
    params = dict(_params("binary"),
                  forcedsplits_filename=_forced(tmp_path, x))
    tb = tlgb.train(params, tlgb.Dataset(x, y), 2, device="cpu")
    for t in tb._gbdt.models:
        assert t.num_leaves == 15
        assert list(t.split_feature[:3]) == [0, 1, 3]


def test_factory_picks_the_jax_learner(tmp_path, monkeypatch):
    x, y = _task("binary", n=600)
    base = dict(_params("binary"))
    cases = {
        "plain": ({}, "DeviceTreeLearner"),
        "forced": ({"forcedsplits_filename": _forced(tmp_path, x)},
                   "SerialTreeLearner"),
        "cegb_split": ({"cegb_penalty_split": 0.1}, "SerialTreeLearner"),
        "cegb_lazy": ({"cegb_penalty_feature_lazy": [0.1] * 8},
                      "SerialTreeLearner"),
        "cegb_off": ({"cegb_tradeoff": 0.0, "cegb_penalty_split": 0.1},
                     "DeviceTreeLearner"),
        # a masked dense pool over 2 GB (600 rows: masked): 131,072
        # leaves of 8 x 256 x 12 bytes
        "pool_2gb": ({"num_leaves": 131072, "max_bin": 255},
                     "SerialTreeLearner"),
        "bynode": ({"feature_fraction_bynode": 0.5}, "DeviceTreeLearner"),
        "lru": ({"histogram_pool_size": 0.04}, "DeviceTreeLearner"),
    }
    for name, (extra, want) in cases.items():
        params = dict(base, **extra)
        jcfg, tcfg = JConfig(params), TConfig(params)
        jds = JDataset(x, config=jcfg, label=y)
        tds = TDataset(x, config=tcfg, label=y)
        assert JDeviceLearner.supports(jcfg, jds) \
            == DeviceTreeLearner.supports(tcfg, tds) \
            == (want == "DeviceTreeLearner"), name
        if name == "pool_2gb":
            continue                     # not built: 2 GB of pool
        assert type(jcreate(jcfg, jds)).__name__ == want, name
        assert type(create_tree_learner(tcfg, tds)).__name__ == want, name
    monkeypatch.setenv("LGBM_TPU_HOST_LEARNER", "1")
    tcfg = TConfig(base)
    assert type(create_tree_learner(
        tcfg, TDataset(x, config=tcfg, label=y))).__name__ \
        == "SerialTreeLearner"
    with pytest.raises(Exception, match="tree_learner=voting"):
        create_tree_learner(TConfig(dict(base, tree_learner="voting")),
                            TDataset(x, config=tcfg, label=y))


@pytest.mark.parametrize("categorical", [False, True])
def test_partition_step_matches_a_stable_sort(categorical):
    # the permutation buffer's window reorder (the JAX partition_step and
    # partition_step_categorical): left rows, then right rows, each in
    # order; the pad tail untouched
    r = np.random.RandomState(2)
    n, f = 1000, 4
    binned = torch.from_numpy(r.randint(0, 30, (n, f)).astype(np.uint8))
    buf = tpart.make_indices_buffer(n, _bucket(n, 1 << 30))
    perm = torch.from_numpy(r.permutation(n).astype(np.int32))
    buf[:n] = perm
    begin, count = 100, 500
    bucket = _bucket(count, 1 << 30)
    before = buf.clone()
    rows = before[begin:begin + count].long()
    if categorical:
        cats = [1, 4, 5, 17, 29]
        words = torch.zeros(1, dtype=torch.int32)
        words[0] = sum(1 << c for c in cats)
        _, left = tpart.partition_step_categorical(
            buf, binned, begin, count, 2, words, bucket=bucket)
        go = torch.isin(binned[rows, 2].long(), torch.tensor(cats))
    else:
        _, left = tpart.partition_step(buf, binned, begin, count, 2, 11,
                                       False, 0, 0, 30, bucket=bucket)
        go = binned[rows, 2] <= 11
    assert int(left) == int(go.sum())
    assert torch.equal(buf[begin:begin + count],
                       torch.cat([rows[go], rows[~go]]).int())
    assert torch.equal(buf[begin + count:], before[begin + count:])
    assert torch.equal(buf[:begin], before[:begin])
