"""Out-of-core streaming of the port (io/stream.py and the learner's
streamed assembly of the working buffer that strategy=chunk's device loop,
the compact core's, grows on) against resident training, the chunk core's
host loop and the JAX package.

Assembly is pure data movement: the streamed tree equals the resident
chunk-strategy tree whatever the transfer chunk size, for exact and real float
gradients and for quantized ones (the assembly quantizes with the key the
core derives its scales from). The exact-gradient convention of
tests/test_chunk_strategy.py (multiples of 0.25, unit hessians) makes
the port's streamed model text the JAX package's. The shard's own
behaviour is held against the JAX tests' cases (tests/test_streaming.py);
on the CPU it moves chunks without pinning or a side stream.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import DeviceTreeLearner as JLearner
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.io.stream import (DeviceDataShard,
                                          derive_stream_chunk_rows)
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.parallel.learners import create_tree_learner
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "min_data_in_leaf": 20, "verbosity": -1}


@pytest.fixture(autouse=True)
def _chunk_env(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_CHUNK", "8192")
    monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)
    monkeypatch.delenv("LGBM_TPU_HOST_LEARNER", raising=False)


def _rows(n=20000, f=5, seed=3):
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    y = ((x[:, 0] - 0.5 * x[:, 1] + 0.3 * r.randn(n)) > 0) \
        .astype(np.float64)
    g = (r.randint(-8, 9, n) * 0.25).astype(np.float32)
    h = np.ones(n, np.float32)
    return x, y, g, h


def _learner(x, y, params=None, strategy=None):
    cfg = TConfig(dict(BASE, **(params or {})))
    return tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg, label=y),
                                 strategy=strategy, device="cpu")


def _grow_text(x, y, g, h, params=None, strategy=None):
    return _learner(x, y, params, strategy).train(
        torch.from_numpy(g), torch.from_numpy(h)).to_string()


def _trees_text(booster):
    """Model text without the parameters block (the stream parameters
    differ between a streamed and a resident run)."""
    s = booster._gbdt.save_model_to_string(0, -1)
    head, _, rest = s.partition("\nparameters:")
    _, _, tail = rest.partition("end of parameters")
    return head + tail


# ---- the shard ------------------------------------------------------------

def test_derive_stream_chunk_rows():
    assert derive_stream_chunk_rows(0, 65536) == 65536
    assert derive_stream_chunk_rows(30000, 65536) == 30000
    assert derive_stream_chunk_rows(7, 65536) == 1024


def test_shard_refuses_a_bad_wire():
    with pytest.raises(ValueError):
        DeviceDataShard(np.zeros((4, 2), np.uint8), item_bits=8, c_cols=5)
    with pytest.raises(ValueError):
        DeviceDataShard(np.zeros(4, np.uint32), item_bits=8, c_cols=5)


def test_shard_chunk_iteration_exact():
    wire = np.arange(5000 * 3, dtype=np.uint32).reshape(5000, 3)
    sh = DeviceDataShard(wire, item_bits=8, c_cols=12, chunk_rows=2048)
    assert sh.overlap_fraction() is None
    got = list(sh.iter_chunks())
    assert [(s, c) for s, c, _ in got] == [(0, 2048), (2048, 2048),
                                           (4096, 904)]
    np.testing.assert_array_equal(
        np.concatenate([t.numpy() for _, _, t in got]).view(np.uint32),
        wire)
    assert sh.cursor == 3 and sh.h2d_bytes == wire.nbytes
    assert sh.overlap_fraction() is not None
    assert sh.host_bytes == wire.nbytes and sh.live_bytes() == 0
    assert sh.peak_bytes == 2 * 2048 * 3 * 4


def test_shard_row_subset_and_working_set():
    wire = np.arange(50 * 2, dtype=np.uint32).reshape(50, 2)
    sh = DeviceDataShard(wire, item_bits=8, c_cols=8, chunk_rows=1024)
    ids = np.array([3, 7, 20, 49], np.int64)
    (s, c, dev), = list(sh.iter_chunks(row_ids=ids))
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), wire[ids])
    sh.pin_working_set(np.array([5, 9], np.int32))
    ws_ids, ws_rows = sh.working_set()
    np.testing.assert_array_equal(ws_rows.numpy().view(np.uint32),
                                  wire[[5, 9]])
    st = sh.stream_state()
    sh2 = DeviceDataShard(wire, item_bits=8, c_cols=8, chunk_rows=1024)
    sh2.load_stream_state(st)
    assert sh2.cursor == sh.cursor
    np.testing.assert_array_equal(sh2.ws_ids, ws_ids)
    np.testing.assert_array_equal(
        sh2.working_set()[1].numpy().view(np.uint32), wire[[5, 9]])
    assert sh.append_rows(wire[:10]) == 60
    (_, c, dev), = list(sh.iter_chunks(row_ids=np.array([55])))
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), wire[[5]])
    with pytest.raises(ValueError):
        sh.append_rows(np.zeros((2, 3), np.uint32))


# ---- streamed against resident ---------------------------------------------

def test_streamed_equals_resident_at_three_chunk_sizes():
    x, y, g, h = _rows()
    resident = _grow_text(x, y, g, h, strategy="chunk")
    for rows in (0, 5000, 6000):      # derived (8192, a tail) | divides | tail
        lrn = _learner(x, y, {"stream_mode": "chunked",
                              "stream_chunk_rows": rows})
        assert lrn.strategy == "chunk" and lrn._shard is not None
        assert lrn.codes_t is None and lrn.codes_pack is None
        streamed = lrn.train(torch.from_numpy(g),
                             torch.from_numpy(h)).to_string()
        assert streamed == resident, rows
        assert lrn._shard.h2d_bytes == len(x) * lrn.code_words * 4
        assert lrn.device_data_bytes()["mode"] == "streamed"
        assert lrn.device_data_bytes()["bytes"] \
            < _learner(x, y, strategy="chunk").device_data_bytes()["bytes"]


def test_streamed_equals_resident_with_real_gradients():
    x, y, _, _ = _rows()
    r = np.random.RandomState(5)
    g = r.randn(len(x)).astype(np.float32)
    h = (0.1 + r.rand(len(x))).astype(np.float32)
    assert _grow_text(x, y, g, h, {"stream_mode": "chunked"}) \
        == _grow_text(x, y, g, h, strategy="chunk")


@pytest.mark.parametrize("renew", [True, False])
def test_streamed_equals_resident_quantized(renew):
    x, y, g, h = _rows()
    q = {"quantized_grad": True, "grad_bits": 8, "quant_renew": renew}
    resident = _grow_text(x, y, g, h, q, strategy="chunk")
    for rows in (0, 6000):
        assert _grow_text(x, y, g, h, dict(q, stream_mode="chunked",
                                           stream_chunk_rows=rows)) \
            == resident, rows


def test_streamed_host_loop_equals_device_loop():
    # the host loop on the streamed data0 (the JAX streaming entry: the
    # quantized root accumulated chunk-wise) gives the device loop's
    # records
    x, y, g, h = _rows(n=12000)
    lrn = _learner(x, y, {"stream_mode": "chunked", "quantized_grad": True,
                          "grad_bits": 8})
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    rec, leaf_id, k = lrn.grow(gt, ht)
    hrec, hleaf, hk = lrn.chunk_host_loop(gt, ht)
    assert k == hk > 10
    np.testing.assert_array_equal(rec[:k], hrec[:k])
    np.testing.assert_array_equal(leaf_id.numpy(), hleaf.numpy())


def test_streamed_model_text_equals_jax(monkeypatch):
    x, y, g, h = _rows()
    cfg = JConfig(dict(BASE, stream_mode="chunked"))
    jl = JLearner(cfg, JDataset(x, config=cfg, label=y))
    assert jl.strategy == "chunk"
    want = jl.train(jnp.asarray(g), jnp.asarray(h)).to_string()
    assert _grow_text(x, y, g, h, {"stream_mode": "chunked"}) == want


def test_streamed_engine_with_bagging(monkeypatch):
    # a host bag: the bag's rows stream compacted and the out-of-bag rows
    # stream through the router; the trees are the resident chunk run's
    # on the same (generic) iteration
    monkeypatch.setattr(GBDT, "_fused_eligible", lambda self: False)
    r = np.random.RandomState(21)
    n = 9000
    x = r.uniform(size=(n, 5)).astype(np.float32)
    y = (x[:, 0] + 0.3 * r.normal(size=n) > 0.5).astype(np.float64)
    params = dict(BASE, num_leaves=15, learning_rate=0.5,
                  bagging_fraction=0.7, bagging_freq=2)

    def run(extra):
        return tengine.train(dict(params, **extra), tbasic.Dataset(x, y),
                             num_boost_round=3, device="cpu")

    monkeypatch.setenv("LGBM_TPU_STRATEGY", "chunk")
    resident = run({})
    monkeypatch.delenv("LGBM_TPU_STRATEGY")
    streamed = run({"stream_mode": "chunked"})
    assert _trees_text(resident) == _trees_text(streamed)
    assert streamed._gbdt.learner._shard.h2d_bytes > 0
    np.testing.assert_array_equal(
        resident._gbdt.learner.last_leaf_id.numpy(),
        streamed._gbdt.learner.last_leaf_id.numpy())


# ---- GOSS working sets -------------------------------------------------------

def _goss(extra=None, n=3000, seed=31):
    r = np.random.RandomState(seed)
    x = r.uniform(size=(n, 5)).astype(np.float32)
    y = (x[:, 0] + 0.3 * r.normal(size=n) > 0.5).astype(np.float64)
    params = dict(BASE, num_leaves=7, learning_rate=0.5, boosting="goss",
                  stream_mode="goss", top_rate=0.3, other_rate=0.2,
                  **(extra or {}))
    return tengine.train(params, tbasic.Dataset(x, y), num_boost_round=5,
                         device="cpu"), x


def test_goss_streamed_deterministic_and_covers_rows():
    a, x = _goss()
    b, _ = _goss()
    assert _trees_text(a) == _trees_text(b)
    lrn = a._gbdt.learner
    ws_ids, ws_rows = lrn._shard.working_set()
    assert ws_ids.size == int(len(x) * 0.3) and ws_rows is not None
    assert lrn.stream_ws_hits > 0
    leaf = lrn.last_leaf_id.numpy()
    assert leaf.shape == (len(x),) and (leaf >= 0).all()
    # in-bag and out-of-bag rows alike: the leaf the tree routes them to
    tree = a._gbdt.models[-1]
    np.testing.assert_array_equal(
        leaf[:300], [tree.predict_leaf_row(row) for row in x[:300]])
    np.testing.assert_allclose(a._gbdt.score_updater.score.numpy()
                               .reshape(-1), a.predict(x, raw_score=True),
                               atol=1e-5)


def test_goss_working_set_capped():
    bst, _ = _goss({"goss_working_set": 100}, seed=33)
    assert bst._gbdt.learner._shard.working_set()[0].size == 100


def test_stream_state_round_trip():
    bst, x = _goss()
    lrn = bst._gbdt.learner
    st = lrn.stream_state()
    assert st["cursor"] == lrn._shard.cursor > 0
    other = _learner(x, np.zeros(len(x)), {"stream_mode": "goss",
                                           "boosting": "goss"})
    other.load_stream_state(st)
    assert other._shard.cursor == st["cursor"]
    np.testing.assert_array_equal(other._shard.ws_ids, st["ws_ids"])
    np.testing.assert_array_equal(other._shard.working_set()[1].numpy(),
                                  lrn._shard.working_set()[1].numpy())
    assert _learner(x, np.zeros(len(x))).stream_state() is None


# ---- rejections ---------------------------------------------------------------

def _tiny(params):
    r = np.random.RandomState(0)
    x = r.uniform(size=(500, 4)).astype(np.float32)
    cfg = TConfig(dict(BASE, **params))
    return cfg, TDataset(x, config=cfg, label=(x[:, 0] > 0.5) * 1.0)


def test_stream_forces_the_chunk_strategy():
    cfg, ds = _tiny({"stream_mode": "chunked"})
    assert tdl.resolve_strategy(cfg, ds) == "chunk"
    assert tdl.resolve_strategy(cfg, ds, "compact") == "chunk"


def test_stream_refuses_the_masked_strategy():
    cfg, ds = _tiny({"stream_mode": "chunked"})
    with pytest.raises(LightGBMError, match="masked"):
        tdl.resolve_strategy(cfg, ds, "masked")


def test_stream_refuses_an_lru_capped_pool():
    cfg, ds = _tiny({"stream_mode": "chunked", "num_leaves": 255,
                     "histogram_pool_size": 0.001})
    with pytest.raises(LightGBMError, match="histogram_pool_size"):
        tdl.resolve_strategy(cfg, ds)


@pytest.mark.parametrize("learner_name", ["voting", "feature", "data"])
def test_stream_refuses_parallel_learners(learner_name):
    cfg, ds = _tiny({"stream_mode": "chunked",
                     "tree_learner": learner_name})
    with pytest.raises(LightGBMError, match="serial"):
        create_tree_learner(cfg, ds, device="cpu")


def test_stream_refuses_the_host_learner(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_HOST_LEARNER", "1")
    cfg, ds = _tiny({"stream_mode": "chunked"})
    with pytest.raises(LightGBMError, match="HOST_LEARNER"):
        create_tree_learner(cfg, ds, device="cpu")


def test_stream_refuses_cegb():
    cfg, ds = _tiny({"stream_mode": "chunked", "cegb_penalty_split": 0.1})
    with pytest.raises(LightGBMError, match="chunk learner"):
        create_tree_learner(cfg, ds, device="cpu")


def test_stream_goss_needs_goss_boosting():
    with pytest.raises(LightGBMError):
        TConfig(dict(BASE, stream_mode="goss"))
