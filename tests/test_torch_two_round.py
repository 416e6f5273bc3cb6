"""Two-round file loading of the port (io/two_round.py) against the
in-memory path and the JAX package's loader.

Round 1 reservoir-samples the file with the JAX package's seeded draws, so
the mappers and codes equal the JAX ``load_two_round``'s, sampled or not;
with every row in the sample they also equal the in-memory Dataset's, and
training on them writes the same model text.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.two_round import load_two_round as jax_load_two_round
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.io.two_round import load_two_round
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "verbosity": -1}


def _write(path, n=3000, seed=7, header=False):
    """A CSV with the label first, 5 features (NaNs in one, a 6-level
    categorical-like one); returns (x, y)."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 5)
    x[r.rand(n) < 0.1, 2] = np.nan
    x[:, 4] = r.randint(0, 6, n)
    y = ((x[:, 0] - x[:, 1] + 0.3 * r.randn(n)) > 0).astype(np.float64)
    with open(path, "w") as f:
        if header:
            f.write("label," + ",".join("f%d" % i for i in range(5)) + "\n")
        for yi, row in zip(y, x):
            f.write("%g,%s\n" % (yi, ",".join(repr(float(v)) for v in row)))
    return x, y


def _same_bins(a, b):
    assert a.num_data == b.num_data
    assert a.used_features == b.used_features
    assert a.feature_infos() == b.feature_infos()
    np.testing.assert_array_equal(np.asarray(a.binned), np.asarray(b.binned))


@pytest.mark.parametrize("extra", [{}, {"categorical_feature": "4"}])
def test_bins_equal_in_memory_and_jax(tmp_path, extra):
    path = str(tmp_path / "train.csv")
    x, y = _write(path)
    cfg = TConfig(dict(PARAMS, **extra))
    ds, label = load_two_round(path, cfg, chunk_rows=700)
    np.testing.assert_array_equal(label, y)
    mem = TDataset(np.loadtxt(path, delimiter=",")[:, 1:], config=cfg,
                   label=y, categorical_feature=[4] if extra else None)
    _same_bins(ds, mem)
    jds, jlabel = jax_load_two_round(path, JConfig(dict(PARAMS, **extra)),
                                     chunk_rows=700)
    np.testing.assert_array_equal(np.asarray(ds.binned),
                                  np.asarray(jds.binned))
    assert ds.used_features == jds.used_features
    for m, jm in zip(ds.bin_mappers, jds.bin_mappers):
        assert m.num_bin == jm.num_bin and m.bin_type == jm.bin_type
        np.testing.assert_array_equal(np.asarray(m.bin_upper_bound),
                                      np.asarray(jm.bin_upper_bound))


@pytest.mark.parametrize("sample_cnt,chunk", [(500, 700), (1000, 256)])
def test_reservoir_sampled_bins_equal_jax(tmp_path, sample_cnt, chunk):
    path = str(tmp_path / "train.csv")
    _write(path, header=True)
    extra = {"bin_construct_sample_cnt": sample_cnt, "data_random_seed": 5}
    ds, _ = load_two_round(path, TConfig(dict(PARAMS, **extra)),
                           chunk_rows=chunk)
    jds, _ = jax_load_two_round(path, JConfig(dict(PARAMS, **extra)),
                                chunk_rows=chunk)
    np.testing.assert_array_equal(np.asarray(ds.binned),
                                  np.asarray(jds.binned))
    for m, jm in zip(ds.bin_mappers, jds.bin_mappers):
        np.testing.assert_array_equal(np.asarray(m.bin_upper_bound),
                                      np.asarray(jm.bin_upper_bound))


@pytest.mark.parametrize("key", ["two_round", "two_round_loading"])
def test_two_round_trains_the_in_memory_model(tmp_path, key):
    path = str(tmp_path / "train.csv")
    _write(path)
    two = tbasic.Dataset(path, params={key: True})
    # the rows as numpy parses them, as the loader's genfromtxt does
    rows = np.loadtxt(path, delimiter=",")
    mem = tbasic.Dataset(rows[:, 1:], rows[:, 0])
    bst_two = tengine.train(dict(PARAMS, **{key: True}), two, 3,
                            device="cpu")
    bst_mem = tengine.train(PARAMS, mem, 3, device="cpu")
    assert two._inner.__class__ is mem._inner.__class__
    _same_bins(two._inner, mem._inner)

    def trees(b):
        s = b._gbdt.save_model_to_string(0, -1)
        head, _, rest = s.partition("\nparameters:")
        return head + rest.partition("end of parameters")[2]

    assert trees(bst_two) == trees(bst_mem)


def test_side_files(tmp_path):
    path = str(tmp_path / "rank.csv")
    x, y = _write(path, n=400)
    w = np.linspace(0.5, 1.5, 400)
    np.savetxt(path + ".weight", w)
    np.savetxt(path + ".query", [100, 150, 150], fmt="%d")
    ds = tbasic.Dataset(path, params={"two_round": True}).construct()
    np.testing.assert_allclose(ds._inner.metadata.weight, w)
    np.testing.assert_array_equal(
        np.diff(ds._inner.metadata.query_boundaries), [100, 150, 150])
    np.testing.assert_array_equal(ds._inner.label, y)


def test_libsvm_and_row_shard_are_refused(tmp_path):
    path = str(tmp_path / "train.svm")
    with open(path, "w") as f:
        f.write("1 0:0.5 2:1.5\n0 1:0.25\n")
    with pytest.raises(ValueError, match="two_round"):
        load_two_round(path, TConfig(PARAMS))
    ds, _ = load_two_round(str(_write_small(tmp_path)), TConfig(PARAMS))
    with pytest.raises(LightGBMError, match="multi-GPU"):
        TDataset.from_binned(ds.binned, ds.bin_mappers, ds.config,
                             row_shard=(0, ds.num_data))


def _write_small(tmp_path):
    path = tmp_path / "small.csv"
    _write(str(path), n=200)
    return path
