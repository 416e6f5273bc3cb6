"""The chunk growth core of the port against the JAX package's.

The chunk core grows a tree over fixed CH-row chunks
(``grow_tree_chunk_core``, the host loop ``chunk_host_loop`` runs);
`strategy=chunk` grows its trees in the compact core's device loop, whose
records the chunk core's must equal (CPU here, the kernels' plain
versions). The data are the JAX
tests' shape: 20,000 x 5 rows with LGBM_TPU_CHUNK=8192 (3 chunks at the
root), 31 leaves, max_bin 63, min_data_in_leaf 20, and their exact
gradients: multiples of 0.25 with unit hessians
(tests/test_chunk_strategy.py), so every float histogram sum is exact
whatever its grouping and model text compares for equality: the port's
chunk tree equals the JAX package's chunk tree and the port's compact
tree, and the device loop's records equal the host loop's. Quantized
trees use int32 histograms: exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import DeviceTreeLearner as JLearner
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.ops import histogram as thist

torch.set_num_threads(1)

CHUNK = 8192
BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "min_data_in_leaf": 20, "verbosity": -1}
KINDS = ["numerical", "categorical", "missing"]
QUANT = {"quantized_grad": True, "grad_bits": 8}


@pytest.fixture(autouse=True)
def _chunk_env(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_CHUNK", str(CHUNK))
    monkeypatch.delenv("LGBM_TPU_CHUNK_NO_FUSE_HIST", raising=False)
    monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)


def _data(kind, n=20000, seed=3):
    """(x, y, g, h, params): 5 columns, exact gradients."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 5).astype(np.float32)
    params = dict(BASE)
    if kind == "categorical":
        x[:, 1] = r.randint(0, 12, n)
        params["categorical_feature"] = "1"
        y = ((x[:, 0] + (x[:, 1] % 3 == 0) + 0.3 * r.randn(n)) > 0.7)
    elif kind == "missing":
        x[r.rand(n, 5) < 0.15] = np.nan
        y = (np.nan_to_num(x[:, 0]) + 0.4 * r.randn(n)) > 0
    else:
        y = (x[:, 0] - 0.5 * x[:, 1] + 0.3 * r.randn(n)) > 0
    g = (r.randint(-8, 9, n) * 0.25).astype(np.float32)
    h = np.ones(n, np.float32)
    return x, y.astype(np.float64), g, h, params


_JAX_TREE = {}


def _jax_tree(kind, extra=None):
    """The JAX package's chunk-core tree of the case (cached)."""
    key = (kind, tuple(sorted((extra or {}).items())))
    if key not in _JAX_TREE:
        x, y, g, h, params = _data(kind)
        cfg = JConfig(dict(params, **(extra or {})))
        lrn = JLearner(cfg, JDataset(x, config=cfg, label=y),
                       strategy="chunk")
        assert lrn.strategy == "chunk"
        _JAX_TREE[key] = lrn.train(jnp.asarray(g), jnp.asarray(h))
    return _JAX_TREE[key]


def _jax_text(kind, extra=None):
    return _jax_tree(kind, extra).to_string()


def _learner(kind, strategy, extra=None):
    x, y, g, h, params = _data(kind)
    cfg = TConfig(dict(params, **(extra or {})))
    lrn = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg, label=y),
                                strategy=strategy, device="cpu")
    return lrn, torch.from_numpy(g), torch.from_numpy(h)


def _chunk_tree(lrn, g, h):
    """The chunk core's tree (the host loop) on the learner's rows."""
    out = lrn.chunk_host_loop(g, h)
    return lrn.replay_tree(out[0], out[2], out[3] if len(out) > 3 else None)


def _port_text(kind, strategy, extra=None):
    """The port's tree text: the chunk core's for "chunk", else the
    strategy's device loop's."""
    lrn, g, h = _learner(kind, strategy, extra)
    assert lrn.strategy == strategy
    if strategy == "chunk":
        return _chunk_tree(lrn, g, h).to_string()
    return lrn.train(g, h).to_string()


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_model_text_equals_jax(kind):
    assert _port_text(kind, "chunk") == _jax_text(kind)


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_equals_compact(kind):
    assert _port_text(kind, "chunk") == _port_text(kind, "compact")


@pytest.mark.parametrize("kind", ["numerical", "categorical"])
def test_fuse_hist_off_equals_on(kind, monkeypatch):
    on = _port_text(kind, "chunk")
    monkeypatch.setenv("LGBM_TPU_CHUNK_NO_FUSE_HIST", "1")
    lrn, g, h = _learner(kind, "chunk")
    assert not lrn.fuse_hist
    assert _chunk_tree(lrn, g, h).to_string() == on


def test_chunk_larger_than_data_equals_compact(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_CHUNK", "65536")
    lrn, g, h = _learner("numerical", "chunk")
    assert lrn.chunk_rows > lrn.dataset.num_data
    assert _chunk_tree(lrn, g, h).to_string() \
        == _port_text("numerical", "compact")


@pytest.mark.parametrize("renew", [True, False])
def test_quantized_chunk_equals_jax(renew):
    # int32 histograms and pool: the same splits and counts; gains and
    # leaf values agree to the split scan's f32 arithmetic on the
    # dequantized sums (rtol 1e-5, as tests/test_torch_learner.py holds
    # the compact core). These rows have no missing values, so the
    # default-left bit is a tie that f32 rounding decides (ROADMAP.md
    # section 3) and is not compared
    extra = dict(QUANT, quant_renew=renew)
    lrn, g, h = _learner("numerical", "chunk", extra)
    got, want = _chunk_tree(lrn, g, h), _jax_tree("numerical", extra)
    m = want.num_leaves
    assert got.num_leaves == m > 10
    for f in ("split_feature", "threshold_in_bin", "left_child",
              "right_child"):
        np.testing.assert_array_equal(getattr(got, f)[:m - 1],
                                      getattr(want, f)[:m - 1], err_msg=f)
    np.testing.assert_array_equal(got.leaf_count[:m], want.leaf_count[:m])
    np.testing.assert_allclose(got.leaf_value[:m], want.leaf_value[:m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.split_gain[:m - 1],
                               want.split_gain[:m - 1], rtol=1e-5)


@pytest.mark.parametrize("case", ["float", "quantized", "categorical",
                                  "no_fuse", "bynode"])
def test_device_loop_records_equal_host_loop(case, monkeypatch):
    extra = {"quantized": QUANT,
             "bynode": {"feature_fraction_bynode": 0.6}}.get(case, {})
    if case == "no_fuse":
        monkeypatch.setenv("LGBM_TPU_CHUNK_NO_FUSE_HIST", "1")
    kind = "categorical" if case == "categorical" else "missing"
    lrn, g, h = _learner(kind, "chunk", extra)
    rec, leaf_id, k = lrn.grow(g, h, iter_seed=2)
    out = lrn.chunk_host_loop(g, h, iter_seed=2)
    hrec, hleaf, hk = out[:3]
    assert k == hk and k > 10
    np.testing.assert_array_equal(rec[:k], hrec[:k])
    np.testing.assert_array_equal(leaf_id.numpy(), hleaf.numpy())
    if case == "categorical":
        np.testing.assert_array_equal(lrn.last_rec_cat[:k], out[3][:k])
        assert (out[3][:k] != 0).any()


def test_lru_capped_pool_falls_back_to_compact():
    x, y, g, h, params = _data("numerical", n=3000)
    cfg = TConfig(dict(params, num_leaves=255, histogram_pool_size=0.001))
    ds = TDataset(x, config=cfg, label=y)
    assert tdl.resolve_strategy(cfg, ds, "chunk") == "compact"
    lrn = tdl.DeviceTreeLearner(cfg, ds, strategy="chunk", device="cpu")
    assert lrn.strategy == "compact" and lrn.pool_slots > 0
    assert lrn.train(torch.from_numpy(g), torch.from_numpy(h)).num_leaves > 1


def test_accumulate_histogram_by_dtype():
    r = np.random.RandomState(1)
    codes = torch.from_numpy(r.randint(0, 16, (300, 4)).astype(np.uint8))
    gh = torch.from_numpy((r.randint(-8, 9, (300, 3)) * 0.25)
                          .astype(np.float32))
    ghq = torch.from_numpy(r.randint(-100, 100, (300, 3)).astype(np.int32))
    for op, acc0 in ((gh, torch.zeros((4, 16, 3))),
                     (ghq, torch.zeros((4, 16, 3), dtype=torch.int32))):
        acc = acc0
        for s in range(0, 300, 128):
            acc = thist.accumulate_histogram(acc, codes[s:s + 128],
                                             op[s:s + 128], 16)
        whole = (thist.build_histogram if op.dtype == torch.float32
                 else thist.build_histogram_quantized)(codes, op, 16)
        assert acc.dtype == acc0.dtype
        np.testing.assert_array_equal(acc.numpy(), whole.numpy())


def test_chunk_trains_end_to_end(monkeypatch):
    # the fused iteration under strategy=chunk: the training scores are
    # the model's predictions
    x, y, _, _, params = _data("numerical", n=9000)
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "chunk")
    bst = tengine.train(dict(params, num_leaves=15),
                        tbasic.Dataset(x, y), num_boost_round=3,
                        device="cpu")
    assert bst._gbdt.learner.strategy == "chunk"
    score = bst._gbdt.score_updater.score.numpy().reshape(-1)
    np.testing.assert_allclose(score, bst.predict(x, raw_score=True),
                               atol=1e-5)
