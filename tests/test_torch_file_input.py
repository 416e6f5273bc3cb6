"""File input of the port against the JAX package's: the text parsers
(the repo's native parser, cpp/parser.cpp, and the numpy path), the
.weight / .query side files, training from a file and predicting one.

Each parser is held to the same parser of the JAX package on the same
file, element for element (NaN where NaN): the native one (built by each
package from the same source) and the numpy one.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.io import native as jnative
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu_torch.io import native as tnative
from lightgbm_tpu_torch.io import parser as tparser

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _rows(n=300, f=5, seed=4):
    # multiples of 2^-10: the native parser's decimal arithmetic reads
    # them exactly
    r = np.random.RandomState(seed)
    x = np.round(r.randn(n, f) * 1024) / 1024
    x[r.rand(n, f) < 0.02] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1]) > 0) \
        .astype(np.float64)
    return x, y


def _write(path, kind, x, y):
    delim = {"csv": ",", "tsv": "\t", "space": " "}.get(kind)
    with open(path, "w") as f:
        if kind == "header":
            f.write(",".join(["label"] + ["f%d" % j
                                           for j in range(x.shape[1])])
                    + "\n")
            delim = ","
        if kind == "comments":
            f.write("# a comment line\n\n")
            delim = ","
        for i in range(len(y)):
            if kind == "libsvm":
                f.write("%g %s\n" % (y[i], " ".join(
                    "%d:%r" % (j, float(v)) for j, v in enumerate(x[i])
                    if v != 0 and not np.isnan(v))))
            else:
                f.write(delim.join(["%g" % y[i]]
                                   + ["%r" % float(v) for v in x[i]]) + "\n")
            if kind == "comments" and i == 5:
                f.write("# another\n")


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("kind", ["csv", "tsv", "space", "libsvm", "header",
                                  "comments"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_parse_file_matches_jax(tmp_path, monkeypatch, kind, route):
    x, y = _rows()
    if kind == "libsvm":
        x = np.nan_to_num(x)
    path = str(tmp_path / ("data." + kind))
    _write(path, kind, x, y)
    if route == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    else:
        assert tnative.available() and jnative.available()
    got = tparser.parse_file(path)
    assert tparser.last_parser == route
    want = jparser.parse_file(path)
    for a, b in zip(got, want):
        assert _same(a, b)
    assert _same(got[1], y)
    assert _same(got[0], x)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_has_header_overrides_the_detection(tmp_path, monkeypatch, route):
    x, y = _rows(40)
    path = str(tmp_path / "h.csv")
    _write(path, "header", x, y)
    if route == "numpy":
        monkeypatch.setattr(tnative, "_TRIED", True)
        monkeypatch.setattr(tnative, "_LIB", None)
    for has_header in (None, True):
        got_x, got_y, _ = tparser.parse_file(path, has_header=has_header)
        assert _same(got_y, y) and _same(got_x, x)


def test_side_files_give_weights_and_groups(tmp_path):
    x, y = _rows(200)
    path = str(tmp_path / "rank.csv")
    _write(path, "csv", x, y)
    w = np.round(np.random.RandomState(1).rand(200) + 0.5, 4)
    np.savetxt(path + ".weight", w)
    np.savetxt(path + ".query", [50, 70, 80], fmt="%d")
    td = tlgb.Dataset(path, params={"verbosity": -1}).construct()
    jd = jlgb.Dataset(path, params={"verbosity": -1}).construct()
    assert _same(td.get_weight(), jd.get_weight())
    assert _same(td.get_group(), jd.get_group())
    assert _same(td.get_group(), [50, 70, 80])
    assert _same(td.get_label(), y)


def test_training_from_a_file_is_training_from_the_array(tmp_path):
    x, y = _rows(1500, seed=8)
    path = str(tmp_path / "train.csv")
    _write(path, "csv", x, y)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "verbosity": -1}
    from_file = tlgb.train(p, tlgb.Dataset(path), 4, device="cpu")
    from_array = tlgb.train(p, tlgb.Dataset(x, y), 4, device="cpu")
    assert from_file.model_to_string() == from_array.model_to_string()
    # a file predicts as its rows (its first column is the label)
    assert np.array_equal(from_file.predict(path), from_array.predict(x))
    hpath = str(tmp_path / "header.csv")
    _write(hpath, "header", x[:100], y[:100])
    assert np.array_equal(from_file.predict(hpath, data_has_header=True),
                          from_array.predict(x[:100]))
