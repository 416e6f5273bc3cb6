"""The Booster and Dataset surface of the port against the JAX package's.

Models come from the JAX package (15 leaves, 2,000 rows; binary,
3-class multiclass and binary with categorical columns) and both
packages read the same model text; training in the port runs on the CPU.
Equal means equal: dump_model's dicts, the C++ if-else source, split
value histograms, importances, the shuffled tree order, saved datasets.
Predictions of the compiled if-else source (f64 sums) and of predict_raw
(f32) agree within 1e-5.
"""
import copy
import ctypes
import inspect
import pickle
import random
import shutil
import subprocess

import numpy as np
import pandas as pd
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io.codegen import model_to_ifelse as jax_ifelse
from lightgbm_tpu.io.dataset import Dataset as JaxInner
from lightgbm_tpu_torch.io.codegen import model_to_ifelse
from lightgbm_tpu_torch.io.dataset import Dataset as TorchInner
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _task(kind, n=2000, seed=31):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    if kind == "categorical":
        cats = r.randint(0, 7, n)
        x[:, 5] = cats
        m = m + (cats % 3 - 1) * 0.8
    noisy = m + 0.5 * r.randn(n)
    if kind == "multiclass":
        return x, np.digitize(noisy, [-0.7, 0.7]).astype(np.float64)
    return x, (noisy > 0).astype(np.float64)


def _params(kind="binary"):
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "learning_rate": 0.3, "max_bin": 63, "min_gain_to_split": 1e-3,
         "verbosity": -1}
    if kind == "multiclass":
        p.update(objective="multiclass", num_class=3)
    if kind == "categorical":
        p["categorical_feature"] = "5"
    return p


@pytest.fixture(scope="module", params=["binary", "multiclass",
                                        "categorical"])
def model(request):
    kind = request.param
    x, y = _task(kind)
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_NO_VMAP_K", "1")
    try:
        b = jlgb.train(_params(kind), jlgb.Dataset(x, y), 4,
                       verbose_eval=False)
    finally:
        mp.undo()
    return kind, b.model_to_string(), x


@pytest.fixture(scope="module")
def port_booster():
    x, y = _task("binary")
    ds = tlgb.Dataset(x, y, free_raw_data=False)
    return tlgb.train(_params(), ds, 4, device="cpu"), ds, x


def _public(cls):
    return {n for n, v in inspect.getmembers(cls)
            if not n.startswith("_") and callable(v)}


def test_every_public_method_of_the_jax_classes():
    assert _public(jlgb.Booster) <= _public(tlgb.Booster)
    assert _public(jlgb.Dataset) <= _public(tlgb.Dataset)
    want = inspect.signature(jlgb.Booster.predict).parameters
    got = inspect.signature(tlgb.Booster.predict).parameters
    assert list(want) == [p for p in got]


@pytest.mark.parametrize("method,args,item", [
    ("save_checkpoint", ("ckpt",), "section 1, item 5"),
    ("restore_checkpoint", ("ckpt",), "section 1, item 5")])
def test_later_slices_raise_naming_their_item(port_booster, method, args,
                                              item, tmp_path):
    # a data-parallel booster checkpoints and restores (rank 0's file:
    # tests/test_torch_parallel_resume.py); the parts of the multi-GPU
    # item still to come raise naming it
    _, _, x = port_booster
    y = (x[:, 0] > 0) * 1.0
    params = {"objective": "binary", "tree_learner": "data",
              "verbosity": -1}
    b = tlgb.train(dict(params), tlgb.Dataset(x, y), num_boost_round=1,
                   device="cpu")
    path = str(tmp_path / args[0])
    b.save_checkpoint(path)
    want = b.model_to_string()
    if method == "restore_checkpoint":
        getattr(b, method)(path)
        assert b.model_to_string() == want
    later = ({"tree_learner": "voting"} if method == "save_checkpoint"
             else {"stream_mode": "chunked"})
    with pytest.raises(LightGBMError, match="ROADMAP.md %s" % item):
        tlgb.train(dict(params, **later), tlgb.Dataset(x, y),
                   num_boost_round=1, device="cpu")


def test_pickle_and_copies_predict_the_same(port_booster):
    b, _, x = port_booster
    b.set_attr(note="kept")
    want = b.predict(x, raw_score=True)
    for other in (pickle.loads(pickle.dumps(b)), copy.copy(b),
                  copy.deepcopy(b)):
        assert other is not b and other.device == b.device
        assert np.array_equal(other.predict(x, raw_score=True), want)
        assert other.attr("note") == "kept"
        assert other.model_to_string() == b.model_to_string()
    b.set_attr(note=None)
    assert b.attr("note") is None
    with pytest.raises(ValueError):
        b.set_attr(note=3)


def test_unpickling_where_the_device_is_absent_names_cpu(port_booster,
                                                         monkeypatch):
    b, _, _ = port_booster
    state = b.__getstate__()
    state["device"] = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(LightGBMError, match='device="cpu"'):
        tlgb.Booster.__new__(tlgb.Booster).__setstate__(state)


def test_model_from_string_and_file(port_booster, tmp_path):
    b, _, x = port_booster
    path = str(tmp_path / "m.txt")
    b.save_model(path)
    for other in (tlgb.Booster(model_file=path, device="cpu"),
                  tlgb.Booster(model_file=path, device="cpu")
                  .model_from_string(b.model_to_string(num_iteration=2))
                  .model_from_string(b.model_to_string())):
        assert np.array_equal(other.predict(x), b.predict(x))
        assert other.num_model_per_iteration() == 1
        assert other.num_feature() == 6
        assert other.feature_name() == b.feature_name()


def test_dump_model_equals_jax(model):
    kind, text, _ = model
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    assert tb.dump_model() == jb.dump_model()
    assert tb.dump_model(num_iteration=2, start_iteration=1) \
        == jb.dump_model(num_iteration=2, start_iteration=1)
    assert tb.get_leaf_output(3, 2) == jb.get_leaf_output(3, 2)


def test_model_to_ifelse_equals_jax_and_compiles(model, tmp_path):
    kind, text, x = model
    tb = tlgb.Booster(model_str=text, device="cpu")
    src = model_to_ifelse(tb._gbdt)
    assert src == jax_ifelse(jlgb.Booster(model_str=text)._gbdt)
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to compile the if-else source")
    cpp = tmp_path / "model.cpp"
    cpp.write_text(src + 'extern "C" void predict_row(const double* a, '
                   "double* o) { lightgbm_tpu_model::Predict(a, o); }\n")
    lib = tmp_path / "model.so"
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).predict_row
    k = tb.num_model_per_iteration()
    rows = np.ascontiguousarray(x[:300].astype(np.float32)
                                .astype(np.float64))
    got = np.zeros((len(rows), k))
    out = np.zeros(k)
    for i, row in enumerate(rows):
        fn(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        got[i] = out
    want = tb.predict(rows, raw_score=True).reshape(len(rows), k)
    assert np.max(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("feature,bins,xgb", [
    (0, None, False), (1, 4, False), ("Column_0", None, False),
    (0, None, True), (2, 3, True)])
def test_split_value_histogram_equals_jax(model, feature, bins, xgb):
    kind, text, _ = model
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    want = jb.get_split_value_histogram(feature, bins=bins,
                                        xgboost_style=xgb)
    got = tb.get_split_value_histogram(feature, bins=bins,
                                       xgboost_style=xgb)
    if xgb:
        pd.testing.assert_frame_equal(got, want)
    else:
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_split_value_histogram_refuses_a_categorical_feature():
    x, y = _task("categorical", n=1500)
    tb = tlgb.train(_params("categorical"), tlgb.Dataset(x, y), 2,
                    device="cpu")
    assert any(t.num_cat for t in tb._gbdt.models)
    with pytest.raises(LightGBMError, match="categorical"):
        tb.get_split_value_histogram(5)


def test_feature_importance_equals_jax(model):
    kind, text, _ = model
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    for kw in ({}, {"importance_type": "gain"}, {"iteration": 2}):
        got, want = tb.feature_importance(**kw), jb.feature_importance(**kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tb.feature_importance().dtype == np.int64


def test_shuffle_models_matches_jax(model):
    kind, text, x = model
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, device="cpu")
    tb.predict(x)                      # fills the ensemble cache
    random.seed(7)
    jb.shuffle_models(start_iteration=1)
    random.seed(7)
    tb.shuffle_models(start_iteration=1)
    order = [[t.leaf_value[0] for t in b._gbdt.models] for b in (jb, tb)]
    assert order[0] == order[1]
    fresh = tlgb.Booster(model_str=tb.model_to_string(), device="cpu")
    assert np.array_equal(tb.predict(x, pred_leaf=True),
                          fresh.predict(x, pred_leaf=True))


def test_free_dataset_keeps_predict_and_refuses_update():
    x, y = _task("binary", n=1500)
    b = tlgb.train(_params(), tlgb.Dataset(x, y), 3, device="cpu")
    text, want = b.model_to_string(), b.predict(x)
    learner = b._gbdt.learner
    assert b.free_dataset() is b
    assert b._gbdt.learner is None and b._gbdt.score_updater is None
    del learner
    assert np.array_equal(b.predict(x), want)
    assert b.model_to_string() == text
    with pytest.raises(LightGBMError, match="free_dataset"):
        b.update()


def _frame(n, seed):
    r = np.random.RandomState(seed)
    colors = np.array(["red", "green", "blue", "cyan"])
    c = colors[r.randint(0, 4, n)]
    df = pd.DataFrame({"a": r.randn(n), "b": r.randn(n),
                       "color": pd.Categorical(c, categories=colors[::-1])})
    y = ((df["a"] + (c == "red") - (c == "cyan") + 0.3 * r.randn(n)) > 0)
    return df, y.astype(np.float64).values


def test_pandas_category_frames(tmp_path):
    df, y = _frame(1500, 1)
    p = dict(_params(), min_data_per_group=20, cat_smooth=1.0)
    tb = tlgb.train(p, tlgb.Dataset(df, y), 4, device="cpu")
    assert tb.pandas_categorical == [["cyan", "blue", "green", "red"]]
    # the same as training on the codes with the column categorical
    codes = df.assign(color=df["color"].cat.codes.astype(float)).values
    tc = tlgb.train(p, tlgb.Dataset(codes, y, categorical_feature=[2],
                                    feature_name=["a", "b", "color"]),
                    4, device="cpu")
    text = tb.model_to_string()
    assert text.startswith(tc.model_to_string())
    assert "\npandas_categorical:" in text
    # a predict frame with its categories in another order is aligned
    dq, _ = _frame(300, 2)
    dq2 = dq.assign(color=dq["color"].cat.reorder_categories(
        ["red", "green", "blue", "cyan"]))
    want = tc.predict(dq.assign(color=dq["color"].cat.codes
                                .astype(float)).values)
    assert np.array_equal(tb.predict(dq), want)
    assert np.array_equal(tb.predict(dq2), want)
    # the model text's trailer both ways between the packages
    path = str(tmp_path / "port.txt")
    tb.save_model(path)
    jb = jlgb.Booster(model_file=path)
    assert jb.pandas_categorical == tb.pandas_categorical
    np.testing.assert_allclose(jb.predict(dq2), want, rtol=0, atol=1e-6)
    jtrained = jlgb.train(p, jlgb.Dataset(df, y), 3, verbose_eval=False)
    jpath = str(tmp_path / "jax.txt")
    jtrained.save_model(jpath)
    back = tlgb.Booster(model_file=jpath, device="cpu")
    assert back.pandas_categorical == jtrained.pandas_categorical
    np.testing.assert_allclose(back.predict(dq2), jtrained.predict(dq2),
                               rtol=0, atol=1e-6)
    # a validation frame is coded with the training lists
    ds = tlgb.Dataset(df, y)
    ev = {}
    tlgb.train(p, ds, 2, valid_sets=[ds.create_valid(dq2, _frame(300, 2)[1])],
               evals_result=ev, device="cpu")
    assert len(ev["valid_0"]["binary_logloss"]) == 2


def _same_inner(a, b):
    assert np.array_equal(a.binned, b.binned)
    assert [m.to_dict() for m in a.bin_mappers] \
        == [m.to_dict() for m in b.bin_mappers]
    assert list(a.used_features) == list(b.used_features)
    assert list(a.feature_names) == list(b.feature_names)
    for f in ("label", "weight", "query_boundaries", "init_score"):
        va, vb = getattr(a.metadata, f), getattr(b.metadata, f)
        assert (va is None and vb is None) or np.array_equal(va, vb), f


def test_save_and_load_binary_both_ways(tmp_path):
    x, y = _task("binary", n=800)
    w = np.random.RandomState(2).rand(800)
    td = tlgb.Dataset(x, y, weight=w, group=[300, 500],
                      params={"verbosity": -1}).construct()
    jd = jlgb.Dataset(x, y, weight=w, group=[300, 500],
                      params={"verbosity": -1}).construct()
    _same_inner(td._inner, jd._inner)
    td.save_binary(str(tmp_path / "port.bin"))
    jd.save_binary(str(tmp_path / "jax.bin"))
    _same_inner(JaxInner.load_binary(str(tmp_path / "port.bin.npz")),
                jd._inner)
    back = TorchInner.load_binary(str(tmp_path / "jax.bin.npz"))
    _same_inner(back, td._inner)
    assert back.num_data == 800 and back.bundled is None \
        or np.array_equal(back.bundled, td._inner.bundled)


def test_add_features_from_equals_jax():
    x, y = _task("binary", n=900)
    x2 = np.random.RandomState(5).randn(900, 3)
    x2[:, 1] = 1.0                                  # a constant column
    p = {"verbosity": -1}
    ta = tlgb.Dataset(x, y, params=p).add_features_from(
        tlgb.Dataset(x2, params=p))
    ja = jlgb.Dataset(x, y, params=p).construct()
    ja.add_features_from(jlgb.Dataset(x2, params=p))
    _same_inner(ta._inner, ja._inner)
    assert ta.num_feature() == 9
    both = tlgb.Dataset(np.hstack([x, x2]), y, params=p).construct()
    assert np.array_equal(ta._inner.binned, both._inner.binned)
    b1 = tlgb.train(_params(), ta, 3, device="cpu")
    b2 = tlgb.train(_params(), both, 3, device="cpu")
    assert np.array_equal(b1.predict(np.hstack([x, x2])),
                          b2.predict(np.hstack([x, x2])))


def test_dataset_getters():
    x, y = _task("binary", n=500)
    init = np.full(500, 0.25)
    mono = [1, 0, 0, 0, 0, -1]
    ds = tlgb.Dataset(x, y, init_score=init, free_raw_data=False,
                      params={"monotone_constraints": mono,
                              "feature_contri": [1.0] * 5 + [0.5],
                              "verbosity": -1})
    with pytest.raises(LightGBMError):
        ds.get_data()
    ds.construct()
    assert ds.get_data() is x
    assert np.array_equal(ds.get_init_score(), init)
    assert ds.get_weight() is None
    assert ds.get_feature_name() == ["Column_%d" % i for i in range(6)]
    assert np.array_equal(ds.get_monotone_constraints(), mono)
    assert np.array_equal(ds.get_feature_penalty(), [1.0] * 5 + [0.5])
    ds.set_feature_name(list("abcdef"))
    assert ds.get_feature_name() == list("abcdef")
    valid = ds.create_valid(x[:50], y[:50])
    assert valid.get_ref_chain() == {id(valid), id(ds)}
    freed = tlgb.Dataset(x, y).construct()
    assert freed.get_data() is None
