"""Per-node feature sampling (feature_fraction_bynode) of the port against
the JAX package, on the CPU.

The device loops draw each node's features inside the split step, with
the by-node key chain in their carries: ``split_on_device`` and
``uniform_on_device`` never read the key on the host, and give the bits
of ``jax.random.split`` / ``uniform``; ``node_masks`` is the JAX
``node_mask``. Then both growth cores, on their host loops and on their
device loops (eager here), float and quantized, against the JAX cores
from the same key (the quantized cores split the quantization's key off
first), and ``train`` end to end on the fused iteration, whose tree key
is prng_key(iter) in both packages. By-node sampling does not change
which learner a package picks (DeviceTreeLearner on both sides), and the
JAX package's model text predicts the same in the port.

Where a leaf's rows leave a bin empty, two thresholds (or both missing
directions) split its rows alike and f32 rounding picks one in each
package (ROADMAP section 3): records are held on leaf, feature and
counts, and the row -> leaf maps equal. 3000 rows, 15 leaves,
min_data_in_leaf 20, min_gain_to_split 1e-3.
"""
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
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.utils import random as trandom
from test_torch_engine import _params, _structure, _task
from test_torch_masked import FLOATS, _data

torch.set_num_threads(1)

BYNODE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
          "verbosity": -1, "feature_fraction_bynode": 0.5}
HELD = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_LCNT, tdl.R_RCNT]


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 2])
def test_device_key_threefry_matches_jax(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = trandom.split(trandom.prng_key(seed))[1]
    np.testing.assert_array_equal(
        trandom.split_on_device(tk, 3).numpy(),
        np.asarray(jax.random.split(jk, 3)).astype(np.int64))
    keys = trandom.split_on_device(tk, 3)[1:]
    got = trandom.uniform_on_device(keys, 29)
    assert got.shape == (2, 29) and got.dtype == torch.float32
    for i in range(2):
        want = np.asarray(jax.random.uniform(
            jnp.asarray(keys[i].numpy().astype(np.uint32)), (29,)))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      want.view(np.uint32))
    # a (2,) key gives one row, the host-key function's
    assert torch.equal(trandom.uniform_on_device(tk, 29),
                       trandom.uniform(tk, 29))


@pytest.mark.parametrize("frac", [0.3, 0.5, 0.9])
def test_node_mask_matches_jax(frac):
    f = 23
    base = np.random.RandomState(4).rand(f) < 0.7
    k = max(1, int(f * frac))
    z = jnp.zeros(f, jnp.int32)
    node_mask = jdl._tree_helpers(
        jnp.asarray(base), z, z, z, z, jnp.ones(f), z,
        jnp.zeros((f, 16), jnp.int32), num_bins=16, max_depth=0, l1=0.0,
        l2=0.0, max_delta_step=0.0, min_data_in_leaf=1,
        min_sum_hessian=0.0, min_gain_to_split=0.0, bynode_k=k)[0]
    tbase = torch.as_tensor(base)
    for seed in range(5):
        key = trandom.split_on_device(trandom.prng_key(seed), 2)
        got = tdl.node_masks(key, tbase, k)               # (2, F): batched
        for i in range(2):
            want = np.asarray(node_mask(jnp.asarray(
                key[i].numpy().astype(np.uint32))))
            np.testing.assert_array_equal(got[i].numpy(), want)
        assert int(got[0].sum()) == min(k, int(base.sum()))


def _jax_grow(strategy, params, x, g, h, seed):
    jcfg = JConfig(params)
    jds = JDataset(x, config=jcfg, label=np.zeros(len(x)))
    jl = jdl.DeviceTreeLearner(jcfg, jds, strategy=strategy)
    jl._ones_w = jnp.ones(len(x), jnp.float32)
    rec, _, leaf, k, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jl._ones_w,
        jnp.ones(jds.num_features, bool), jax.random.PRNGKey(seed))
    return np.asarray(rec), np.asarray(leaf), int(k)


@pytest.mark.parametrize("strategy", ["compact", "masked"])
@pytest.mark.parametrize("quant", [False, True])
def test_bynode_loops_match_jax(strategy, quant):
    # the device loop (learner.grow) and the host loop against the JAX
    # core, then against each other exactly
    x, g, h = _data()
    params = dict(BYNODE)
    if quant:
        params.update(quantized_grad=True, grad_bits=8)
    seed = 3
    jrec, jleaf, jk = _jax_grow(strategy, params, x, g, h, seed)
    cfg = TConfig(params)
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg,
                                             label=np.zeros(len(x))),
                               strategy=strategy, device="cpu")
    assert tl._statics()["bynode_k"] == 3
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    rec, leaf, k = tl.grow(gt, ht, iter_seed=seed)
    assert k == jk and k > 5
    np.testing.assert_array_equal(rec[:k, HELD], jrec[:k, HELD])
    np.testing.assert_allclose(rec[:k, FLOATS], jrec[:k, FLOATS],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(leaf.numpy(), jleaf)
    # the same tree without by-node sampling is another tree
    full = _jax_grow(strategy, dict(params, feature_fraction_bynode=1.0),
                     x, g, h, seed)[0]
    assert not np.array_equal(full[:k, HELD], jrec[:k, HELD])

    key = trandom.prng_key(seed)
    if strategy == "compact":
        if quant:
            data, q = tl.quant_working_buffer(gt, ht, key)
        else:
            data, q = tl.working_buffer(gt, ht), None
        hrec, hleaf, hk = tdl.grow_tree_compact_core(
            data, torch.empty_like(data), tl._ones_mask, tl.meta,
            c_cols=tl.c_cols, item_bits=tl.item_bits, quant=q,
            rng_key=key, **tl._statics())
    else:
        gh, scale3 = tl.masked_operand(gt, ht, seed)
        hrec, hleaf, hk = tdl.grow_tree(tl.codes_t, gh, tl._ones_mask,
                                        tl.meta, scale3=scale3, rng_key=key,
                                        **tl._statics())
    assert hk == k
    np.testing.assert_array_equal(hrec, rec)
    assert torch.equal(hleaf, leaf)


@pytest.mark.parametrize("case", ["compact-float", "masked-quant"])
def test_train_bynode_matches_jax(case, monkeypatch):
    # the fused iteration on both sides: tree key prng_key(iter)
    strategy, kind = case.split("-")
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _task("binary")
    params = dict(_params("binary"), feature_fraction_bynode=0.5,
                  feature_fraction=0.9)
    if kind == "quant":
        params.update(quantized_grad=True, grad_bits=8)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=4,
                    verbose_eval=False)
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=4,
                    device="cpu")
    assert type(jb._gbdt.learner).__name__ == "DeviceTreeLearner"
    assert type(tb._gbdt.learner).__name__ == "DeviceTreeLearner"
    assert tb._gbdt.learner.strategy == strategy
    assert tb._gbdt._fused_step is not None      # the fused iteration ran
    assert tb._gbdt.learner.stats.host_syncs == 4
    # the same trees; a tied threshold may differ where the rows between
    # the two choices lie in other leaves, so the scores of the training
    # rows agree
    assert _structure(tb._gbdt.models) == _structure(jb._gbdt.models)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)
    # the JAX package's model text predicts the same in the port
    back = convert.booster_from_model_string(jb.model_to_string(),
                                             device="cpu")
    np.testing.assert_allclose(back.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True), rtol=0,
                               atol=1e-6)
