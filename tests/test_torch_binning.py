"""Port binning and dataset views vs the JAX package, bit for bit.

lightgbm_tpu_torch keeps its own copy of the host binning (BinMapper,
greedy_find_bin, mapper_from_sample_column) and EFB planning; the same
numpy input must give the same bin bounds, codes and bundle maps.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io import binning as jbin
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io import binning as tbin
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset


def _dense(seed, n=2000):
    r = np.random.RandomState(seed)
    x = r.randn(n, 5)
    x[r.rand(n) < 0.1, 1] = np.nan            # NaN missing
    x[r.rand(n) < 0.4, 2] = 0.0               # zero-heavy column
    x[:, 3] = np.round(x[:, 3] * 2)           # few distinct values
    x[:, 4] = r.exponential(size=n) * 1e3     # skewed scale
    return x


@pytest.mark.parametrize("params", [
    {"max_bin": 63},
    {"max_bin": 255, "zero_as_missing": True},
    {"max_bin": 15, "use_missing": False, "min_data_in_bin": 7},
])
def test_bin_mappers_bit_equal(params):
    x = _dense(3)
    jd = JDataset(x, config=JConfig(dict(params, verbosity=-1)),
                  label=np.zeros(len(x)))
    td = TDataset(x, config=TConfig(dict(params, verbosity=-1)),
                  label=np.zeros(len(x)))
    assert jd.used_features == td.used_features
    for jm, tm in zip(jd.bin_mappers, td.bin_mappers):
        assert jm.to_dict() == tm.to_dict()
    np.testing.assert_array_equal(jd.binned, td.binned)
    for j, t in zip(jd.feature_meta_arrays(), td.feature_meta_arrays()):
        np.testing.assert_array_equal(np.asarray(j), t)


def test_greedy_find_bin_same_bounds():
    r = np.random.RandomState(5)
    dv = np.unique(np.round(r.randn(500), 2))
    cnt = r.randint(1, 30, size=dv.size)
    for max_bin in (4, 16, 63, 255):
        assert jbin.greedy_find_bin(dv, cnt, max_bin, int(cnt.sum()), 3) \
            == tbin.greedy_find_bin(dv, cnt, max_bin, int(cnt.sum()), 3)


def test_efb_sparse_bundle_arrays_bit_equal():
    # a sparse one-hot block bundles under EFB; dense columns stay alone
    r = np.random.RandomState(11)
    n, k = 3000, 12
    cat = r.randint(0, k, n)
    oh = np.zeros((n, k))
    oh[np.arange(n), cat] = r.randint(1, 3, n).astype(float)
    x = sp.csr_matrix(np.concatenate([r.randn(n, 3), oh], axis=1))
    jd = JDataset(x, config=JConfig({"verbosity": -1}), label=np.zeros(n))
    td = TDataset(x, config=TConfig({"verbosity": -1}), label=np.zeros(n))
    assert td.columns is not None and td.bundled.shape[1] < td.num_features
    np.testing.assert_array_equal(jd.binned, td.binned)
    np.testing.assert_array_equal(jd.bundled, td.bundled)
    jb, tb = jd.bundle_arrays(), td.bundle_arrays()
    for j, t in zip(jb[:5], tb[:5]):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(t))
    assert jb[5] == tb[5]
