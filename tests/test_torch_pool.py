"""The LRU-capped histogram pool of the compact core, against the JAX
package, on the CPU.

``plan_histogram_pool`` and ``DeviceTreeLearner.supports`` are the JAX
package's budget math and capability check. Under a histogram_pool_size
budget that caps the pool below num_leaves, the compact core keeps K =
max(2, pool_slots) slots: a leaf keeps its parent's slot while it is
cached, else takes a free or the least recently used one, and the
sibling of a split whose parent was evicted is built directly over the
larger child's rows (the miss pass, which the device loop launches in
every step, returning at once on a hit). A 31-leaf tree in 8 slots
(histogram_pool_size 0.04 MB, 8 columns of 64 padded bins) misses often:
its final slot bookkeeping (each leaf's slot, each slot's leaf and last
use) equals the JAX core's, on the device loop and the host loop, float
and quantized; the quantized records' counts are exact. Float trees are
held at 15 leaves (ROADMAP's tie rule). The masked core keeps its dense
pool (as the JAX masked core).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models import device_learner as jdl
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.utils import random as trandom
from test_torch_engine import _assert_same_splits, _params, _task
from test_torch_masked import FLOATS

torch.set_num_threads(1)

POOLED = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
          "verbosity": -1, "histogram_pool_size": 0.04}


@pytest.mark.parametrize("features,bins", [(8, 63), (28, 255), (1000, 255),
                                           (3, 15)])
@pytest.mark.parametrize("leaves", [15, 255, 2047])
@pytest.mark.parametrize("budget", [-1.0, 0.04, 2.0, 4096.0])
def test_plan_and_supports_match_jax(features, bins, leaves, budget):
    ds = types.SimpleNamespace(columns=None, num_features=features,
                               max_num_bins=bins, num_data=100000)
    params = {"num_leaves": leaves, "histogram_pool_size": budget,
              "verbosity": -1}
    jcfg, tcfg = JConfig(params), TConfig(params)
    assert tdl.plan_histogram_pool(tcfg, ds) \
        == jdl.plan_histogram_pool(jcfg, ds)
    for strategy in ("compact", "masked"):
        assert tdl.DeviceTreeLearner.supports(tcfg, ds, strategy) \
            == jdl.DeviceTreeLearner.supports(jcfg, ds, strategy)


def _spy_final_carry(monkeypatch):
    """The JAX core's final carry, caught at its split loop."""
    final = {}
    real = jdl.run_split_loop

    def spy(cond, body, state, n, program="per_split"):
        out = real(cond, body, state, n, program)
        final["carry"] = out if hasattr(out, "slot_of") else out[0]
        return out

    monkeypatch.setattr(jdl, "run_split_loop", spy)
    return final


def _grad(y):
    r = np.random.RandomState(0)
    g = (y - 0.5 + 0.1 * r.randn(len(y))).astype(np.float32)
    h = (0.2 + 0.05 * r.rand(len(y))).astype(np.float32)
    return g, h


@pytest.mark.parametrize("quant", [False, True])
def test_lru_slots_and_records_match_jax(quant, monkeypatch):
    x, y = _task("binary")
    g, h = _grad(y)
    params = dict(POOLED)
    if quant:
        params.update(quantized_grad=True, grad_bits=8)
    jcfg, tcfg = JConfig(params), TConfig(params)
    jds = JDataset(x, config=jcfg, label=y)
    jl = jdl.DeviceTreeLearner(jcfg, jds, strategy="compact")
    assert jl.pool_slots == 8
    final = _spy_final_carry(monkeypatch)
    ones = jnp.ones(len(x), jnp.float32)
    jrec, _, jleaf, jk, _ = jdl.grow_tree_compact_core(
        jl.codes_pack, jl.codes_row, jnp.asarray(g), jnp.asarray(h), ones,
        jnp.ones(jds.num_features, bool), jl.f_numbins, jl.f_missing,
        jl.f_default, jl.f_monotone, jl.f_penalty, jl.f_categorical,
        jl.f_col, jl.f_base, jl.f_elide, jl.hist_idx,
        jax.random.PRNGKey(3), **jl._grow_fn_kwargs(True)[1],
        **jl._statics())
    jrec, jk, jc = np.asarray(jrec), int(jk), final["carry"]

    tl = tdl.DeviceTreeLearner(tcfg, TDataset(x, config=tcfg, label=y),
                               strategy="compact", device="cpu")
    assert tl.pool_slots == 8 and tl._statics()["pool_slots"] == 8
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    rec, leaf, k = tl.grow(gt, ht, iter_seed=3)
    c = tl._carry
    assert c.pool.shape[0] == 8
    assert k == jk == 30
    for name in ("slot_of", "slot_owner", "slot_last"):
        np.testing.assert_array_equal(getattr(c, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    misses = tl.stats.pool_misses
    assert misses >= 5
    held = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_LCNT, tdl.R_RCNT]
    np.testing.assert_array_equal(rec[:k, held], jrec[:k, held])
    np.testing.assert_allclose(rec[:k, FLOATS], jrec[:k, FLOATS],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))

    # the host loop: the same records, leaf map and misses
    if quant:
        data, q = tl.quant_working_buffer(gt, ht, trandom.prng_key(3))
    else:
        data, q = tl.working_buffer(gt, ht), None
    hrec, hleaf, hk = tdl.grow_tree_compact_core(
        data, torch.empty_like(data), tl._ones_mask, tl.meta,
        c_cols=tl.c_cols, item_bits=tl.item_bits, quant=q, stats=tl.stats,
        **tl._statics())
    assert hk == k and tl.stats.pool_misses == 2 * misses
    np.testing.assert_array_equal(hrec, rec)
    assert torch.equal(hleaf, leaf)


def test_dense_pool_unchanged_and_masked_stays_dense():
    # without a budget the plan is dense and the carry holds L slots; the
    # masked core ignores the budget (the JAX grow_tree's dense pool)
    x, y = _task("binary", n=800)
    cfg = TConfig(dict(POOLED, histogram_pool_size=-1.0))
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg, label=y),
                               strategy="compact", device="cpu")
    tl.grow(*(torch.from_numpy(a) for a in _grad(y)))
    assert tl.pool_slots == 0 and not tl._carry.pooled
    assert tl._carry.pool.shape[0] == 31
    cfg = TConfig(POOLED)
    tm = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg, label=y),
                               strategy="masked", device="cpu")
    assert tm.pool_slots == 8 and tm._statics()["pool_slots"] == 0
    tm.grow(*(torch.from_numpy(a) for a in _grad(y)))
    assert tm._carry.pool.shape[0] == 31


@pytest.mark.parametrize("quant", [False, True])
def test_train_pooled_matches_jax(quant, monkeypatch):
    # the fused iteration on the pooled compact core, 15 leaves in 8 slots
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _task("binary")
    params = dict(_params("binary"), histogram_pool_size=0.04)
    if quant:
        params.update(quantized_grad=True, grad_bits=8)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=4,
                    verbose_eval=False)
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=4,
                    device="cpu")
    learner = tb._gbdt.learner
    assert type(learner).__name__ == "DeviceTreeLearner"
    assert type(jb._gbdt.learner).__name__ == "DeviceTreeLearner"
    assert learner._carry.pooled and learner.stats.pool_misses > 0
    assert learner.stats.host_syncs == 4       # misses come in the fetch
    _assert_same_splits(tb._gbdt.models, jb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
