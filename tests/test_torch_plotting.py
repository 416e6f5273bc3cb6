"""The port's plotting surface (lightgbm_tpu_torch/plotting.py) against
the JAX package's (tests/test_plotting.py's four cases): the same model
text loaded into both packages' Boosters gives the same axes, labels,
importance values, split-value histograms and digraph source."""
import shutil

import numpy as np
import pytest

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

import lightgbm_tpu as jlgb  # noqa: E402
from lightgbm_tpu import plotting as jplot  # noqa: E402

import lightgbm_tpu_torch as tlgb  # noqa: E402
from lightgbm_tpu_torch import plotting as tplot  # noqa: E402

from conftest import make_binary  # noqa: E402


@pytest.fixture(scope="module")
def trained():
    x, y = make_binary(1500, 6, seed=2)
    ds = tlgb.Dataset(x[:1200], y[:1200])
    dv = tlgb.Dataset(x[1200:], y[1200:], reference=ds)
    evals = {}
    bst = tlgb.train({"objective": "binary", "num_leaves": 15,
                      "metric": "binary_logloss", "verbosity": -1},
                     ds, num_boost_round=5, valid_sets=[ds, dv],
                     valid_names=["training", "valid"],
                     callbacks=[tlgb.record_evaluation(evals)],
                     device="cpu")
    # both packages read the same model text
    text = bst.model_to_string()
    return (tlgb.Booster(model_str=text, device="cpu"),
            jlgb.Booster(model_str=text), evals)


def _bars(ax):
    return sorted((p.get_width(), p.get_height()) for p in ax.patches)


def _labels(ax):
    return (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            [t.get_text() for t in ax.get_yticklabels()])


def test_plot_importance(trained):
    bst, jb, _ = trained
    for kw in ({}, {"importance_type": "gain", "title": "t", "xlabel": "x",
                    "ylabel": "y"}):
        ax, jax_ax = tplot.plot_importance(bst, **kw), \
            jplot.plot_importance(jb, **kw)
        assert _labels(ax) == _labels(jax_ax)
        np.testing.assert_allclose(_bars(ax), _bars(jax_ax), rtol=1e-6)
        assert [t.get_text() for t in ax.texts] \
            == [t.get_text() for t in jax_ax.texts]
    imp = bst.feature_importance()
    assert len(ax.patches) == int(np.count_nonzero(imp))
    assert ax.get_title() == "t"


def test_plot_metric(trained):
    _, _, evals = trained
    ax, jax_ax = tplot.plot_metric(evals), jplot.plot_metric(evals)
    assert (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()) \
        == (jax_ax.get_title(), jax_ax.get_xlabel(), jax_ax.get_ylabel()) \
        == ("Metric during training", "Iterations", "binary_logloss")
    lines, jlines = ax.get_lines(), jax_ax.get_lines()
    assert len(lines) == len(jlines) == 2
    for a, b in zip(lines, jlines):
        assert a.get_label() == b.get_label()
        np.testing.assert_array_equal(a.get_ydata(), b.get_ydata())
        assert len(a.get_ydata()) == 5


def test_plot_split_value_histogram(trained):
    bst, jb, _ = trained
    feat = int(np.argmax(bst.feature_importance()))
    ax = tplot.plot_split_value_histogram(bst, feat)
    jax_ax = jplot.plot_split_value_histogram(jb, feat)
    assert ax.get_title() == jax_ax.get_title()
    assert ax.get_title().startswith("Split value histogram for feature")
    assert len(ax.patches) > 0
    np.testing.assert_allclose(
        [(p.get_x(), p.get_height()) for p in ax.patches],
        [(p.get_x(), p.get_height()) for p in jax_ax.patches], rtol=1e-6)


def test_plot_tree_and_digraph(trained):
    pytest.importorskip("graphviz")
    bst, jb, _ = trained
    for info in (None, ["split_gain", "internal_count", "leaf_count"]):
        g = tplot.create_tree_digraph(bst, tree_index=1, show_info=info)
        jg = jplot.create_tree_digraph(jb, tree_index=1, show_info=info)
        assert g.source == jg.source
    assert "leaf" in g.source.lower()
    if shutil.which("dot") is None:
        # rendering needs graphviz's `dot` binary: without it, the same
        # error as the JAX package's
        with pytest.raises(Exception) as exc:
            tplot.plot_tree(bst, tree_index=0)
        with pytest.raises(type(exc.value)):
            jplot.plot_tree(jb, tree_index=0)
    else:
        assert tplot.plot_tree(bst, tree_index=0) is not None
