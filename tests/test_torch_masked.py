"""The port's masked strategy vs the JAX package's, split record by split
record, with float and with quantized gradients.

Both learners grow one tree from the same numpy gradients and hessians
(n = 3000, num_leaves = 15, min_gain_to_split = 1e-3): the JAX side
through ``_run_grow`` with ``strategy="masked"`` and ``PRNGKey(seed)``,
the port through ``DeviceTreeLearner.grow(g, h, iter_seed=seed)`` (the
same key, from the threefry port). Integer record columns (leaf, feature,
threshold) and the row -> leaf map must be equal.

Float columns: within rtol = atol = 1e-4 on the float path (the K1 bound of
test_torch_learner.py: the JAX histogram sums a bf16 hi/lo split); within
rtol 1e-5 on the quantized path, where the integer histograms are equal and
only the split scan's f32 arithmetic can differ in the last bits.
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
from lightgbm_tpu_torch.ops.kernels import histogram as khist

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _data(seed=11, n=3000):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    x[r.rand(n) < 0.05, 1] = np.nan
    g = ((x[:, 0] > 0.2) - 0.5 + 0.3 * r.randn(n)).astype(np.float32)
    g += 0.4 * np.nan_to_num(x[:, 1]).astype(np.float32)
    h = (0.1 + r.rand(n)).astype(np.float32)
    return x, g, h


def grow_both(params, strategy, seed=3, n=3000):
    """(jrec, jleaf, jk, trec, tleaf, tk, port learner) for one tree."""
    x, g, h = _data(n=n)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
                   "verbosity": -1}, **params)
    jcfg, tcfg = JConfig(params), TConfig(params)
    jds = JDataset(x, config=jcfg, label=np.zeros(n))
    tds = TDataset(x, config=tcfg, label=np.zeros(n))
    jl = JLearner(jcfg, jds, strategy=strategy)
    assert jl.strategy == strategy
    jl._ones_w = jnp.ones(n, jnp.float32)
    jrec, _, jleaf, jk, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jl._ones_w,
        jnp.ones(jds.num_features, bool), jax.random.PRNGKey(seed))
    tl = tdl.DeviceTreeLearner(tcfg, tds, strategy=strategy, device="cpu")
    assert tl.strategy == strategy
    trec, tleaf, tk = tl.grow(torch.from_numpy(g), torch.from_numpy(h),
                              iter_seed=seed)
    return (np.asarray(jrec), np.asarray(jleaf), int(jk), trec,
            tleaf.numpy(), tk, tl)


INTS = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR]
FLOATS = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_LCNT, tdl.R_RSG,
          tdl.R_RSH, tdl.R_RCNT, tdl.R_LOUT, tdl.R_ROUT]


@pytest.mark.parametrize("quant", [None, 8, 16])
def test_masked_records_and_leaf_ids_match_jax(quant):
    params = ({} if quant is None
              else {"quantized_grad": True, "grad_bits": quant})
    jrec, jleaf, jk, trec, tleaf, tk, _ = grow_both(params, "masked")
    assert tk == jk and tk > 3
    np.testing.assert_array_equal(trec[:tk, INTS], jrec[:jk, INTS])
    tol = 1e-4 if quant is None else 1e-5
    np.testing.assert_allclose(trec[:tk, FLOATS], jrec[:jk, FLOATS],
                               rtol=tol, atol=tol)
    if quant is not None:
        # counts are integer histogram lanes: exact
        np.testing.assert_array_equal(trec[:tk, [tdl.R_LCNT, tdl.R_RCNT]],
                                      jrec[:jk, [tdl.R_LCNT, tdl.R_RCNT]])
    np.testing.assert_array_equal(tleaf, jleaf)


def test_auto_picks_masked_below_65536_rows(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_STRATEGY", raising=False)
    x, _, _ = _data(n=500)
    cfg = TConfig({"objective": "binary", "verbosity": -1})
    ds = TDataset(x, config=cfg, label=np.zeros(500))
    assert tdl.resolve_strategy(cfg, ds) == "masked"
    assert tdl.resolve_strategy(cfg, ds, "compact") == "compact"
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    assert tdl.resolve_strategy(cfg, ds) == "compact"
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "chunk")
    with pytest.raises(tdl.LightGBMError, match="chunk"):
        tdl.resolve_strategy(cfg, ds)


def test_masked_train_counts_and_leaf_map():
    x, g, h = _data()
    cfg = TConfig({"objective": "binary", "num_leaves": 7,
                   "verbosity": -1})
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg,
                                             label=np.zeros(len(x))),
                               device="cpu")
    assert tl.strategy == "masked" and tl.codes_pack is None
    tree = tl.train(torch.from_numpy(g), torch.from_numpy(h))
    assert tree.num_leaves == 7
    assert (tl.stats.host_syncs, tl.stats.splits, tl.stats.trees) \
        == (6, 6, 1)
    counts = np.bincount(tl.last_leaf_id.numpy(), minlength=7)
    np.testing.assert_array_equal(counts, tree.leaf_count[:7])


def test_masked_16bit_codes():
    # more than 256 bins: the (C, N) view rides as int16 (read as uint16
    # by the plain K2 and the split decode)
    jrec, jleaf, jk, trec, tleaf, tk, tl = grow_both(
        {"max_bin": 400, "min_data_in_bin": 1}, "masked")
    assert tl.codes_t.dtype == torch.int16 and tl.num_bins > 256
    assert tk == jk and tk > 3
    np.testing.assert_array_equal(trec[:tk, INTS], jrec[:jk, INTS])
    np.testing.assert_array_equal(tleaf, jleaf)


def test_k2_and_k3t_plain_on_the_column_view():
    x, g, h = _data(n=700)
    cfg = TConfig({"objective": "binary", "verbosity": -1})
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg,
                                             label=np.zeros(700)),
                               device="cpu")
    gh = torch.stack([torch.from_numpy(g), torch.from_numpy(h),
                      torch.ones(700)], 1)
    want = khist.build_histogram_plain(tl.codes_t.t().contiguous(), gh, 64)
    assert torch.equal(khist.build_histogram_t(tl.codes_t, gh, 64), want)
    ghq = torch.randint(-127, 128, (700, 3), dtype=torch.int8,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(
        khist.build_histogram_quantized_t(tl.codes_t, ghq, 64),
        khist.build_histogram_quantized_plain(tl.codes_t.t().contiguous(),
                                              ghq, 64))
