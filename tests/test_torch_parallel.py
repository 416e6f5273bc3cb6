"""Data-parallel training of the port across processes, on the CPU.

Two gloo ranks run tests/torch_dp_worker.py as subprocesses (a free port
each, a timeout on every communicate). Held here:

* both ranks end with byte-equal split records and model text;
* on gradients on a 1/64 grid (where both packages' histogram sums are
  exact) the records equal the JAX DeviceDataParallelTreeLearner's on a
  2-device mesh (conftest's virtual CPU devices), in psum and
  reduce-scatter modes, and the two modes equal each other;
* on real gradients the end-to-end trees equal the port's serial trees
  structurally (tests/test_parallel.py's assert_trees_structurally_equal);
* distributed bin finding gives the single-process bin bounds bit for bit,
  and replicated ingest the single-process codes;
* LGBM_NetworkInit / Free, Booster.set_network / free_network and a
  two-rank ``python -m lightgbm_tpu_torch task=train num_machines=2
  tree_learner=data device_type=cpu`` run.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.gbdt import create_boosting
from lightgbm_tpu.parallel.learners import DeviceDataParallelTreeLearner
from lightgbm_tpu.parallel.mesh import make_mesh

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

import torch_dp_worker as worker
from test_parallel import assert_trees_structurally_equal

HERE = os.path.dirname(os.path.abspath(__file__))
INTS = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR, tdl.R_DLEFT]
SUMS = [tdl.R_LSG, tdl.R_LSH, tdl.R_LCNT, tdl.R_RSG, tdl.R_RSH, tdl.R_RCNT]
FLOATS = [tdl.R_GAIN, tdl.R_LOUT, tdl.R_ROUT]


def _free_ports(k):
    socks = [socket.socket() for _ in range(k)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _run_ranks(argv_of, env=None, timeout=240):
    """Start rank 0 and rank 1 (argv_of(rank)) and wait for both."""
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=env(r) if env else None)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    ports = ",".join(str(p) for p in _free_ports(4))
    _run_ranks(lambda r: [sys.executable,
                          os.path.join(HERE, "torch_dp_worker.py"), str(r),
                          out, ports])
    res = [dict(np.load(os.path.join(out, "rank%d.npz" % r)))
           for r in range(2)]
    text = [open(os.path.join(out, "model%d.txt" % r)).read()
            for r in range(2)]
    return res, text


def _jax_tree(mode, g, h, monkeypatch):
    """Records and leaf ids of the JAX learner on a 2-device mesh."""
    monkeypatch.setenv("LGBM_TPU_DP_REDUCE", mode)
    x, y = worker.data()[:2]
    cfg = JConfig(dict(worker.PARAMS, tree_learner="data"))
    jl = DeviceDataParallelTreeLearner(cfg, JDataset(x, config=cfg, label=y),
                                       mesh=make_mesh(2))
    got = {}
    jl.replay_tree = lambda rec_h, k, rec_cat_h=None: got.update(
        rec=np.asarray(rec_h), k=k)
    jl.train(jnp.asarray(g), jnp.asarray(h))
    return got["rec"][:got["k"]], np.asarray(jl.last_leaf_id), \
        jl.scatter_cols


def test_ranks_agree_byte_for_byte(ranks):
    res, text = ranks
    assert text[0] == text[1]
    for key in res[0]:
        if key.endswith("_rec") or key in ("bounds", "sharded_codes"):
            np.testing.assert_array_equal(res[0][key], res[1][key],
                                          err_msg=key)
    # one fetch per tree; the default mode scatters at W = 2
    syncs, trees, scatter, auc = res[0]["e2e_meta"]
    assert (syncs, trees, scatter) == (3, 3, 2) and auc > 0.85


@pytest.mark.parametrize("mode", ["psum", "scatter"])
def test_records_match_jax_on_grid_gradients(ranks, mode, monkeypatch):
    res, _ = ranks
    _, _, _, _, gq, hq = worker.data()
    jrec, jleaf, jscatter = _jax_tree(mode, gq, hq, monkeypatch)
    trec = res[0]["%s_grid_rec" % mode]
    k, coll, scatter = res[0]["%s_grid_meta" % mode]
    assert scatter == jscatter == (2 if mode == "scatter" else 0)
    assert k == len(jrec) > 5
    np.testing.assert_array_equal(trec[:, INTS], jrec[:, INTS])
    np.testing.assert_array_equal(trec[:, SUMS], jrec[:, SUMS])
    np.testing.assert_allclose(trec[:, FLOATS], jrec[:, FLOATS], rtol=1e-5)
    # the ranks' leaf ids, in rank order, are the JAX global row -> leaf
    np.testing.assert_array_equal(
        np.concatenate([res[0]["%s_grid_leaf" % mode],
                        res[1]["%s_grid_leaf" % mode]]), jleaf)
    # one collective at the root, one per split step (L - 1); scatter
    # mode adds the totals' all-reduce and one election per scan
    L = worker.PARAMS["num_leaves"]
    assert coll == (L if mode == "psum" else 2 * L + 1)


def test_scatter_equals_psum(ranks):
    res, _ = ranks
    for r in range(2):
        np.testing.assert_array_equal(res[r]["scatter_grid_rec"],
                                      res[r]["psum_grid_rec"])
        np.testing.assert_array_equal(res[r]["scatter_grid_leaf"],
                                      res[r]["psum_grid_leaf"])
    # on real gradients the modes sum in other orders: the same splits
    a, b = res[0]["scatter_real_rec"], res[0]["psum_real_rec"]
    np.testing.assert_array_equal(a[:, [tdl.R_LEAF, tdl.R_FEAT]],
                                  b[:, [tdl.R_LEAF, tdl.R_FEAT]])
    np.testing.assert_array_equal(a[:, [tdl.R_LCNT, tdl.R_RCNT]],
                                  b[:, [tdl.R_LCNT, tdl.R_RCNT]])


def test_end_to_end_trees_equal_serial_structurally(ranks):
    _, text = ranks
    x, y = worker.data()[:2]
    serial = tlgb.train(dict(worker.PARAMS), tlgb.Dataset(x, y), 3,
                        device="cpu")
    dp = tlgb.Booster(model_str=text[0], device="cpu")
    for t in dp._gbdt.models:         # bin thresholds from the model text
        t.rebin_inner(serial.train_set._inner)
    assert_trees_structurally_equal(serial._gbdt, dp._gbdt, 3, "dp")
    np.testing.assert_allclose(dp.predict(x), serial.predict(x), atol=1e-5)


@pytest.mark.parametrize("mode", sorted(worker.MODES))
def test_modes_equal_serial_structurally(ranks, mode):
    # multiclass (3 trees per iteration) and DART (drops rescaled on each
    # rank's scores) on the generic iteration; categorical splits (the
    # bitset words elected with the candidate rows in scatter mode)
    res, _ = ranks
    text = str(res[0]["text_" + mode])
    assert text == str(res[1]["text_" + mode])
    x, y = worker.data()[:2]
    params, label, rows = worker.MODES[mode]
    serial = tlgb.train(dict(params), tlgb.Dataset(rows(x), label(x, y)), 2,
                        device="cpu")
    dp = tlgb.Booster(model_str=text, device="cpu")
    for t in dp._gbdt.models:
        t.rebin_inner(serial.train_set._inner)
    assert dp.num_trees() == serial.num_trees() >= 2
    assert ("\ncat_threshold=" in text) == (mode == "categorical")
    assert_trees_structurally_equal(serial._gbdt, dp._gbdt,
                                    serial.num_trees(), mode)


def test_unbalanced_sorted_labels_match_jax_data_parallel(ranks):
    # is_unbalance on rows sorted by label: rank 0's block holds one class
    # alone, yet every rank weighs the labels and trains as all of them
    # say, as the JAX data-parallel learner (conftest's 8 devices) does
    res, _ = ranks
    params, label, rows = worker.MODES["unbalanced_sorted"]
    x, y = worker.data()[:2]
    xs, ys = rows(x), label(x, y)
    assert ys[:(worker.N + 1) // 2].max() == 0 and 0.2 < ys.mean() < 0.3
    cfg = JConfig(dict(params, tree_learner="data"))
    jb = create_boosting(cfg, JDataset(xs, config=cfg, label=ys))
    for _ in range(2):
        jb.train_one_iter()
    assert isinstance(jb.learner, DeviceDataParallelTreeLearner)
    dp = tlgb.Booster(model_str=str(res[0]["text_unbalanced_sorted"]),
                      device="cpu")
    serial = tlgb.train(dict(params), tlgb.Dataset(xs, ys), 2, device="cpu")
    for t in dp._gbdt.models:
        t.rebin_inner(serial.train_set._inner)
    assert dp.num_trees() == 2
    assert_trees_structurally_equal(jb, dp._gbdt, 2, "jax data-parallel")
    np.testing.assert_allclose(dp.predict(xs, raw_score=True),
                               jb.predict(xs, raw_score=True),
                               rtol=1e-4, atol=1e-5)


def test_distributed_bins_and_replicated_ingest(ranks):
    res, _ = ranks
    x, y = worker.data()[:2]
    cfg = TConfig(dict(worker.PARAMS, tree_learner="data"))
    single = TDataset(x, config=cfg, label=y)
    want = [[repr(float(v)) for v in m.bin_upper_bound]
            for m in single.bin_mappers]
    assert json.loads(str(res[0]["bounds"])) == want
    np.testing.assert_array_equal(res[0]["sharded_codes"], single.binned)


def test_network_entry_points(ranks):
    res, _ = ranks
    for r in range(2):
        # LGBM_NetworkInit: this rank, 2 machines, a sum over both
        assert list(res[r]["capi_identity"]) == [r, 2, 3.0]
        assert list(res[r]["identity"]) == [r, 2]     # set_network
        assert list(res[r]["freed"]) == [1]           # free_network


def test_backend_follows_the_ranks_on_the_host(monkeypatch):
    # every rank posts its host name; NCCL carries CUDA tensors while
    # each rank on the host has a card of its own, else gloo does
    import torch
    import torch.distributed as dist
    from lightgbm_tpu_torch.distributed import bootstrap
    store = dist.HashStore()
    store.set("lgbm_host/0", "another-host")
    store.set("lgbm_host/2", socket.gethostname())
    assert bootstrap._local_ranks(store, 3, 1) == (2, 0)
    assert bootstrap._local_ranks(store, 3, 2) == (2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bootstrap._backend_spec(1) == ("gloo", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert bootstrap._backend_spec(2) == ("cpu:gloo,cuda:nccl", "nccl")
    assert bootstrap._backend_spec(3) == ("gloo", "gloo")


def test_mesh_row_blocks():
    # the JAX learner's ceil blocks: rank 1 of 2 holds 1,500 rows of
    # 3,001 and pads one
    m = tmake_mesh("cpu", size=2, rank=1)
    assert (m.local_n(3001), m.row_block(3001)) == (1501, (1501, 3001))
    m = tmake_mesh("cpu", size=3, rank=2)
    assert m.row_block(4) == (4, 4)


def test_cli_two_ranks(tmp_path):
    x, y = worker.data()[:2]
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, np.nan_to_num(x)]), delimiter=",",
               fmt="%.6f")
    port = _free_ports(1)[0]
    model = tmp_path / "model.txt"

    def env(r):
        return dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
                    LGBM_TPU_COORDINATOR="127.0.0.1:%d" % port,
                    LGBM_TPU_NUM_PROCESSES="2", LGBM_TPU_PROCESS_ID=str(r))
    _run_ranks(lambda r: [
        sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
        "data=%s" % data, "objective=binary", "num_iterations=3",
        "num_leaves=7", "num_machines=2", "tree_learner=data",
        "device_type=cpu", "output_model=%s" % model, "verbosity=-1"],
        env=env)
    # rank 0 writes the model; it predicts what a single-process run
    # of the same file trains, structurally
    b = tlgb.Booster(model_file=str(model), device="cpu")
    assert b.num_trees() == 3
    serial = tlgb.train({"objective": "binary", "num_leaves": 7,
                         "verbosity": -1}, tlgb.Dataset(str(data)), 3,
                        device="cpu")
    for t in b._gbdt.models:
        t.rebin_inner(serial.train_set._inner)
    assert_trees_structurally_equal(serial._gbdt, b._gbdt, 3, "cli")
