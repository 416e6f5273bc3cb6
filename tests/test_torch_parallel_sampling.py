"""Row sampling, leaf renewal and lambdarank of the port's data-parallel
learner across two processes, on the CPU.

Two gloo ranks run tests/torch_dp_modes_worker.py (kind ``sampling``);
the JAX DeviceDataParallelTreeLearner runs on a 2-device mesh of
conftest's virtual CPU devices. Held here:

* ``utils/random.fold_in`` equals ``jax.random.fold_in``;
* the fused iteration's per-rank bag (0.7) and GOSS (top 0.2, other 0.1)
  from the same bag key, on gradients on a 1/64 grid (2,579 rows, where
  both ranks' GOSS multipliers keep the grid): the weights, and
  the records (INTS and SUMS bit for bit, FLOATS within rtol 1e-5) and
  the ranks' leaf ids in rank order, against the JAX program's, in both
  reduce modes;
* the generic iteration's host bags (RF, pos/neg bagging) and the fused
  bagging and GOSS runs: the ranks' model text byte-equal, RF and pos/neg
  structurally equal to the JAX data-parallel run;
* leaf renewal (regression_l1, quantile, mape; 3 rounds): the same
  structure as the JAX data-parallel run and leaf values within 1e-6;
* lambdarank on ragged queries, one of them cut by the ranks' block
  boundary: each rank's gradients equal the serial objective's of its
  rows, and the trees structurally equal the JAX data-parallel run's.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import create_boosting
from lightgbm_tpu.parallel import learners as jlearners
from lightgbm_tpu.parallel.learners import DeviceDataParallelTreeLearner
from lightgbm_tpu.parallel.mesh import make_mesh

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils import random as trandom

import torch_dp_modes_worker as worker
import torch_dp_worker as base
from test_parallel import assert_trees_structurally_equal
from test_torch_parallel import FLOATS, INTS, SUMS, _free_ports, _run_ranks

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_sampling"))
    port = str(_free_ports(1)[0])
    _run_ranks(lambda r: [sys.executable,
                          os.path.join(HERE, "torch_dp_modes_worker.py"),
                          "sampling", str(r), out, port])
    return [dict(np.load(os.path.join(out, "sampling%d.npz" % r)))
            for r in range(2)]


@pytest.fixture
def two_device_mesh(monkeypatch):
    """The JAX boosting's data-parallel learner on 2 of the 8 devices."""
    monkeypatch.setattr(jlearners, "make_mesh",
                        functools.partial(make_mesh, 2))


@pytest.mark.parametrize("key,data", [(0, 0), (7, 3), (2**31 - 1, 1),
                                      (12345, 2**32 - 1)])
def test_fold_in_equals_jax(key, data):
    want = np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(key), data)) if hasattr(jax.random, "key_data")
        else jax.random.fold_in(jax.random.PRNGKey(key), data))
    got = trandom.fold_in(trandom.prng_key(key), data).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  want.astype(np.uint32))
    # the draws of the folded key, too
    np.testing.assert_array_equal(
        trandom.uniform(trandom.fold_in(trandom.prng_key(key), data),
                        100).numpy(),
        np.asarray(jax.random.uniform(jax.random.fold_in(
            jax.random.PRNGKey(key), data), (100,))))


def _jax_sampled_tree(mode, name, monkeypatch):
    """The JAX data-parallel program with its per-shard sample: records,
    the global leaf map and the weights (the program's w)."""
    monkeypatch.setenv("LGBM_TPU_DP_REDUCE", mode)
    x, y, _, _, gq, hq = base.data(worker.SAMPLE_N)
    cfg = JConfig(dict(worker.PARAMS, **worker.SAMPLES[name]))
    jl = DeviceDataParallelTreeLearner(cfg, JDataset(x, config=cfg, label=y),
                                       mesh=make_mesh(2))
    goss = ((cfg.top_rate, cfg.other_rate) if name == "goss" else None)
    fn = jl._sharded_tree_fn(with_bag_key=True, goss=goss)
    pad = jl.n_pad - len(gq)
    g, h = (jnp.asarray(np.pad(v, (0, pad))) for v in (gq, hq))
    rec, _, leaf, k, _ = jax.jit(fn)(
        jl.codes_pack, jl.codes_row, g, h,
        jax.random.PRNGKey(worker.BAG_SEED),
        jnp.ones(jl.num_features, bool), jax.random.PRNGKey(0))
    k = int(k)
    return np.asarray(rec)[:k], np.asarray(leaf)[:len(gq)], jl.scatter_cols


@pytest.mark.parametrize("name", sorted(worker.SAMPLES))
@pytest.mark.parametrize("mode", ["psum", "scatter"])
def test_per_rank_sample_matches_jax(ranks, mode, name, monkeypatch):
    jrec, jleaf, jscatter = _jax_sampled_tree(mode, name, monkeypatch)
    trec = ranks[0]["%s_%s_rec" % (mode, name)]
    assert jscatter == (2 if mode == "scatter" else 0)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["%s_%s_rec" % (mode, name)],
                                      trec)
    assert len(trec) == len(jrec) > 5
    np.testing.assert_array_equal(trec[:, INTS], jrec[:, INTS])
    np.testing.assert_array_equal(trec[:, SUMS], jrec[:, SUMS])
    np.testing.assert_allclose(trec[:, FLOATS], jrec[:, FLOATS], rtol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([ranks[0]["%s_%s_leaf" % (mode, name)],
                        ranks[1]["%s_%s_leaf" % (mode, name)]]), jleaf)
    # each rank drew its own sample over its real rows: the bag's k =
    # int(real * 0.7); GOSS's top 20% and 10% of the rest of 1,290 / 1,289
    for r, real in ((0, 1290), (1, 1289)):
        w = ranks[r]["%s_%s_w" % (mode, name)]
        assert w[real:].sum() == 0
        want = (int(np.float32(real) * np.float32(0.7)) if name == "bag"
                else int(np.float32(real) * np.float32(0.2))
                + int(np.float32(real) * np.float32(0.1)))
        assert int(w.sum()) == want
    # the two ranks' draws differ (fold_in of the rank)
    assert not np.array_equal(ranks[0]["%s_%s_w" % (mode, name)][:1289],
                              ranks[1]["%s_%s_w" % (mode, name)][:1289])


def _port_model(text, x, y, params=worker.PARAMS, **kw):
    """A port Booster of model text, its trees rebinned on (x, y) binned
    as `params` bin it."""
    serial = tlgb.Dataset(x, y, params=dict(params), **kw)
    serial.construct()
    b = tlgb.Booster(model_str=text, device="cpu")
    for t in b._gbdt.models:
        t.rebin_inner(serial._inner)
    return b


def _jax_run(params, x, label, rounds=3, group=None):
    cfg = JConfig(dict(params))
    ds = JDataset(x, config=cfg, label=label)
    if group is not None:
        ds.metadata.set_group(group)
    jb = create_boosting(cfg, ds)
    for _ in range(rounds):
        jb.train_one_iter()
    assert isinstance(jb.learner, DeviceDataParallelTreeLearner)
    assert jb.learner.shards == 2
    return jb


@pytest.mark.parametrize("name", ["rf", "posneg", "fused_bag",
                                  "fused_goss"])
def test_sampled_runs_byte_equal_on_both_ranks(ranks, name,
                                               two_device_mesh):
    text = str(ranks[0]["text_" + name])
    assert text == str(ranks[1]["text_" + name])
    syncs, trees = ranks[0]["syncs_" + name]
    assert trees == 3 and syncs == 3          # one fetch per tree
    if name in ("rf", "posneg"):
        # the generic iteration's host bag of global rows, cut per rank:
        # the JAX data-parallel run's trees
        params, label = worker.RUNS[name]
        x, y = base.data()[:2]
        jb = _jax_run(params, x, label(x, y))
        assert_trees_structurally_equal(
            jb, _port_model(text, x, y, params)._gbdt, 3, name)


@pytest.mark.parametrize("name", sorted(worker.RENEW))
def test_leaf_renewal_matches_jax(ranks, name, two_device_mesh):
    text = str(ranks[0]["text_" + name])
    assert text == str(ranks[1]["text_" + name])
    params, label = worker.RENEW[name]
    x, y = base.data()[:2]
    jb = _jax_run(params, x, label(x, y))
    port = _port_model(text, x, y, params)._gbdt
    assert_trees_structurally_equal(jb, port, 3, name)
    for ti in range(3):
        jt, tt = jb.models[ti], port.models[ti]
        np.testing.assert_allclose(
            np.asarray(tt.leaf_value[:tt.num_leaves], np.float64),
            np.asarray(jt.leaf_value[:jt.num_leaves], np.float64),
            atol=1e-6, err_msg="%s tree %d" % (name, ti))
    # two learner syncs per tree: the fetch and the gathered leaf map
    assert list(ranks[0]["syncs_" + name]) == [6, 3]


def test_lambdarank_across_a_cut_query(ranks, two_device_mesh):
    xr, rel, sizes = worker.ranking()
    assert len(sizes) >= 100
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    cut = -(-int(bounds[-1]) // 2)                  # rank 1's first row
    assert cut not in bounds                        # a query is cut
    # each rank's gradients are the serial objective's of its rows, at
    # the same scores
    cfg = TConfig(dict(worker.RANK_PARAMS))
    ds = tlgb.Dataset(xr, rel, group=sizes, params=dict(worker.RANK_PARAMS))
    ds.construct()
    obj = create_objective("lambdarank", cfg)
    obj.init(ds._inner.metadata, len(xr), "cpu")
    score = torch.as_tensor(0.3 * xr[:, 0] - 0.2 * xr[:, 3],
                            dtype=torch.float32)
    g, h = obj.get_gradients(score)
    want = np.stack([g.numpy(), h.numpy()])
    for r in range(2):
        n_coll, n_bytes, lo, hi = ranks[r]["rank_gather"]
        np.testing.assert_allclose(ranks[r]["rank_grad"], want[:, lo:hi],
                                   atol=1e-6)
        # one all-gather per iteration of each rank's f32 scores, padded
        # to the ceil block of 1,501 rows
        assert (n_coll, n_bytes) == (1, 4 * cut)
    text = str(ranks[0]["text_rank"])
    assert text == str(ranks[1]["text_rank"])
    jb = _jax_run(worker.RANK_PARAMS, xr, rel, group=sizes)
    port = _port_model(text, xr, rel, worker.RANK_PARAMS, group=sizes)
    assert_trees_structurally_equal(jb, port._gbdt, 3, "lambdarank")
