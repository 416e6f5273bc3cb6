"""The port's compact growth core vs the JAX package's, split record by
split record, with float and with quantized gradients.

Both learners grow one tree from the same numpy gradients and hessians
(n = 3000, num_leaves = 15). The JAX side runs its compact strategy (the
one the port follows). Integer record columns (leaf, feature, threshold)
and the row -> leaf map must be equal; default_left too wherever the
split leaf holds rows in the feature's missing bin (with none there, both
directions give the same split and the direction is decided by f32
rounding, see test_torch_split.py). Float columns agree within rtol and
atol 1e-4, the histogram bound of test_torch_histogram.py: the JAX
histogram sums a bf16 hi/lo split, the port sums f32 in another order,
and a sibling's sums come from parent - child, which hands the parent's
absolute error to the smaller child (measured: up to 2.2e-5 relative at
n = 3000). min_gain_to_split = 1e-3 keeps splits at f32 noise level out.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import \
    DeviceTreeLearner as JLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _missing_in_leaf(ds, rec, k):
    """(k,) bool: split i's leaf holds rows in its feature's missing bin.
    Replays the records over the logical bins of the training rows."""
    nb, mt, db, _, _ = ds.feature_meta_arrays()
    leaf = np.zeros(ds.num_data, np.int64)
    out = np.zeros(k, bool)
    for i in range(k):
        l, f, thr, dl = (int(rec[i, 0]), int(rec[i, 1]), int(rec[i, 2]),
                         rec[i, 3] > 0.5)
        bins = ds.binned[:, f].astype(np.int64)
        missing = (((mt[f] == 2) & (bins == nb[f] - 1))
                   | ((mt[f] == 1) & (bins == db[f])))
        out[i] = bool(np.any(missing & (leaf == l)))
        left = np.where(missing, dl, bins <= thr)
        leaf[(leaf == l) & ~left] = i + 1
    return out


def _data(kind, seed=11, n=3000):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    x[r.rand(n) < 0.05, 1] = np.nan
    x[r.rand(n) < 0.05, 3] = np.nan
    if kind == "bundled":
        k = 8
        oh = np.zeros((n, k))
        oh[np.arange(n), r.randint(0, k, n)] = r.randint(1, 3, n)
        x = np.concatenate([x[:, :3], oh], axis=1)
    g = ((x[:, 0] > 0.2) - 0.5 + 0.3 * r.randn(n)).astype(np.float32)
    g += 0.4 * np.nan_to_num(x[:, 1]).astype(np.float32)
    h = (0.1 + r.rand(n)).astype(np.float32)
    return x, g, h


CASES = {
    "dense63": ("dense", {"max_bin": 63}),
    "nibble15": ("dense", {"max_bin": 15, "lambda_l2": 1.0}),
    "monotone": ("dense", {"max_bin": 63, "max_delta_step": 0.4,
                           "monotone_constraints": [1, -1, 0, 0, 0, 0]}),
    "bundled": ("bundled", {"max_bin": 63, "lambda_l1": 0.1,
                            "max_depth": 4}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_and_leaf_ids_match_jax(case):
    kind, extra = CASES[case]
    x, g, h = _data(kind)
    params = dict({"objective": "binary", "num_leaves": 15,
                   "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
                   "verbosity": -1}, **extra)
    jcfg, tcfg = JConfig(params), TConfig(params)
    jds = JDataset(x, config=jcfg, label=np.zeros(len(x)))
    tds = TDataset(x, config=tcfg, label=np.zeros(len(x)))
    if kind == "bundled":
        assert tds.columns is not None

    jl = JLearner(jcfg, jds, strategy="compact")
    assert jl.strategy == "compact"
    jl._ones_w = jnp.ones(len(x), jnp.float32)
    jrec, _, jleaf, jk, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jl._ones_w,
        jnp.ones(jds.num_features, bool), jax.random.PRNGKey(0))
    jrec, jleaf, jk = np.asarray(jrec), np.asarray(jleaf), int(jk)

    tl = tdl.DeviceTreeLearner(tcfg, tds, strategy="compact", device="cpu")
    data = tl.working_buffer(torch.from_numpy(g), torch.from_numpy(h))
    trec, tleaf, tk = tdl.grow_tree_compact_core(
        data, torch.empty_like(data), tl._ones_mask, tl.meta,
        c_cols=tl.c_cols, item_bits=tl.item_bits, **tl._statics())

    assert tk == jk and tk > 3
    ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR]
    np.testing.assert_array_equal(trec[:tk, ints], jrec[:jk, ints])
    has = _missing_in_leaf(tds, trec, tk)
    assert has.any()
    np.testing.assert_array_equal(trec[:tk, tdl.R_DLEFT][has],
                                  jrec[:jk, tdl.R_DLEFT][has])
    floats = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_LCNT, tdl.R_RSG,
              tdl.R_RSH, tdl.R_RCNT, tdl.R_LOUT, tdl.R_ROUT]
    np.testing.assert_allclose(trec[:tk, floats], jrec[:jk, floats],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tleaf.numpy(), jleaf)


def test_train_returns_replayed_tree():
    x, g, h = _data("dense")
    cfg = TConfig({"objective": "binary", "num_leaves": 7,
                   "verbosity": -1})
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg,
                                             label=np.zeros(len(x))),
                               strategy="compact", device="cpu")
    tree = tl.train(torch.from_numpy(g), torch.from_numpy(h))
    assert tree.num_leaves == 7
    # one host sync per split: the leaf's best row read before the split
    assert (tl.stats.host_syncs, tl.stats.splits, tl.stats.trees) \
        == (6, 6, 1)
    counts = np.bincount(tl.last_leaf_id.numpy(), minlength=7)
    np.testing.assert_array_equal(counts, tree.leaf_count[:7])


@pytest.mark.parametrize("renew", [True, False])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_compact_matches_jax(renew, bits):
    # the integer histograms, pool and leaf re-quantization are exact, so
    # the records agree to the split scan's f32 arithmetic (rtol 1e-5)
    # and the counts exactly
    from test_torch_masked import FLOATS, INTS, grow_both
    jrec, jleaf, jk, trec, tleaf, tk, tl = grow_both(
        {"quantized_grad": True, "grad_bits": bits, "quant_renew": renew},
        "compact")
    assert tl.codes_t is None and tl.quant_renew == renew
    assert tk == jk and tk > 3
    np.testing.assert_array_equal(trec[:tk, INTS], jrec[:jk, INTS])
    np.testing.assert_allclose(trec[:tk, FLOATS], jrec[:jk, FLOATS],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(trec[:tk, [tdl.R_LCNT, tdl.R_RCNT]],
                                  jrec[:jk, [tdl.R_LCNT, tdl.R_RCNT]])
    np.testing.assert_array_equal(tleaf, jleaf)


def test_quantized_compact_renew_off_equals_masked():
    # within the port (tests/test_quantized_rows.py's anchor): with renew
    # off both strategies quantize with the same key and bits, and integer
    # sums are order-free, so the records are bit-identical
    x, g, h = _data("dense")
    params = {"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
              "quantized_grad": True, "grad_bits": 8, "quant_renew": False,
              "verbosity": -1}
    cfg = TConfig(params)
    ds = TDataset(x, config=cfg, label=np.zeros(len(x)))
    out = {}
    for strategy in ("compact", "masked"):
        tl = tdl.DeviceTreeLearner(cfg, ds, strategy=strategy, device="cpu")
        out[strategy] = tl.grow(torch.from_numpy(g), torch.from_numpy(h),
                                iter_seed=4)
    (crec, cleaf, ck), (mrec, mleaf, mk) = out["compact"], out["masked"]
    assert ck == mk and ck > 3
    np.testing.assert_array_equal(crec, mrec)
    assert torch.equal(cleaf, mleaf)
