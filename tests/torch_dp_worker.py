"""One rank of tests/test_torch_parallel.py's two-process gloo group.

Run as ``python torch_dp_worker.py RANK OUT_DIR P0,P1,P2,P3``: joins the
group through the C ABI (LGBM_NetworkInit on 127.0.0.1:P0,P1, then
LGBM_NetworkFree) and through Booster.set_network (127.0.0.1:P2,P3; the
rank from this process's port in the list), then, on the CPU, finds bins
cooperatively, ingests replicated rows, grows data-parallel trees on this
rank's block in both reduction modes, trains end to end with
tree_learner=data, and writes everything to OUT_DIR/rank<RANK>.npz (and
the model text to OUT_DIR/model<RANK>.txt).
"""
import ctypes
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import lightgbm_tpu_torch as tlgb  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.distributed import ingest  # noqa: E402
from lightgbm_tpu_torch.io.dataset import Dataset  # noqa: E402
from lightgbm_tpu_torch.io.distributed import (  # noqa: E402
    distributed_find_bins)
from lightgbm_tpu_torch.ops.kernels.build import capi_library  # noqa: E402
from lightgbm_tpu_torch.parallel import learners, network  # noqa: E402

N = 3001                       # odd: the last rank's block is padded
PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
          "verbosity": -1}


def _with_categories(x):
    """Column 5 as 12 categories whose effect the label carries."""
    x = x.copy()
    x[:, 5] = np.floor((x[:, 5] + 3) * 2).clip(0, 11)
    return x


def _label_unbalanced(x):
    """A label with about a quarter of the rows positive, from x alone."""
    return (x[:, 0] + 0.5 * np.nan_to_num(x[:, 2]) > 0.8).astype(float)


def _by_label(x):
    """Rows in label order: rank 0's block holds negatives alone."""
    return np.argsort(_label_unbalanced(x), kind="stable")


# end-to-end modes beyond the default: (params, label, rows) of x, y
MODES = {
    "unbalanced_sorted": (dict(PARAMS, is_unbalance=True),
                          lambda x, y: _label_unbalanced(x)[_by_label(x)],
                          lambda x: x[_by_label(x)]),
    "multiclass": (dict(PARAMS, objective="multiclass", num_class=3),
                   lambda x, y: np.digitize(np.nan_to_num(x[:, 0]),
                                            [-0.5, 0.5]).astype(float),
                   lambda x: x),
    "dart": (dict(PARAMS, boosting="dart", drop_rate=0.5, skip_drop=0.0),
             lambda x, y: y, lambda x: x),
    "categorical": (dict(PARAMS, categorical_feature="5"),
                    lambda x, y: ((_with_categories(x)[:, 5] % 3 == 0)
                                  ^ (y > 0)).astype(float),
                    _with_categories)}


def data(n=N, seed=11):
    """Rows with NaNs, labels, real gradients and their 1/64-grid copies
    (on the grid both packages' histogram sums are exact)."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 6)
    x[r.rand(n) < 0.05, 1] = np.nan
    y = (x[:, 0] + 0.5 * np.nan_to_num(x[:, 2]) + 0.5 * r.randn(n) > 0)
    g = ((x[:, 0] > 0.2) - 0.5 + 0.3 * r.randn(n)).astype(np.float32)
    g += 0.4 * np.nan_to_num(x[:, 1]).astype(np.float32)
    h = (0.1 + r.rand(n)).astype(np.float32)
    gq = (np.round(g * 64) / 64).astype(np.float32)
    hq = (np.round(h * 64) / 64).astype(np.float32)
    return x, y.astype(np.float64), g, h, gq, hq


def grow(mode, ds, cfg, g, h):
    """One tree of the data-parallel learner in `mode` on this rank's
    block of (g, h): (records, this block's leaf ids, k, collectives)."""
    os.environ["LGBM_TPU_DP_REDUCE"] = mode
    tl = learners.create_tree_learner(cfg, ds, device="cpu")
    assert isinstance(tl, learners.DeviceDataParallelTreeLearner)
    lo, hi = tl.row_block
    c0 = network.collectives
    rec, leaf, k = tl.grow(torch.from_numpy(g[lo:hi]),
                           torch.from_numpy(h[lo:hi]))
    return rec, leaf.numpy(), k, network.collectives - c0, tl.scatter_cols


def main():
    rank, out = int(sys.argv[1]), sys.argv[2]
    ports = [int(p) for p in sys.argv[3].split(",")]
    os.environ["LGBM_TPU_DEVICE_TYPE"] = "cpu"
    res = {}
    x, y, g, h, gq, hq = data()

    # the C ABI's network entry points
    lib = ctypes.CDLL(capi_library())
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    machines = "127.0.0.1:%d,127.0.0.1:%d" % (ports[0], ports[1])
    rc = lib.LGBM_NetworkInit(machines.encode(), ports[rank], 120, 2)
    assert rc == 0, lib.LGBM_GetLastError()
    res["capi_identity"] = [network.rank(), network.num_machines(),
                            float(network.all_reduce(
                                torch.tensor([rank + 1.0]))[0])]
    assert lib.LGBM_NetworkFree() == 0, lib.LGBM_GetLastError()

    # Booster.set_network on a serial booster
    b0 = tlgb.train(dict(PARAMS), tlgb.Dataset(x, y), 1, device="cpu")
    b0.set_network("127.0.0.1:%d,127.0.0.1:%d" % (ports[2], ports[3]),
                   local_listen_port=ports[2 + rank], num_machines=2)
    res["identity"] = [network.rank(), network.num_machines()]

    cfg = Config(dict(PARAMS, tree_learner="data"))
    lo, hi = ingest.shard_row_block(N, rank, 2)
    mappers = distributed_find_bins(x[lo:hi], cfg)
    res["bounds"] = json.dumps([[repr(float(v)) for v in m.bin_upper_bound]
                                for m in mappers])
    res["sharded_codes"] = ingest.load_sharded(x, cfg, label=y).binned

    ds = Dataset(x, config=cfg, label=y)
    for mode in ("psum", "scatter"):
        for kind, (gg, hh) in (("grid", (gq, hq)), ("real", (g, h))):
            rec, leaf, k, coll, scatter = grow(mode, ds, cfg, gg, hh)
            res["%s_%s_rec" % (mode, kind)] = rec[:k]
            res["%s_%s_leaf" % (mode, kind)] = leaf
            res["%s_%s_meta" % (mode, kind)] = [k, coll, scatter]

    os.environ.pop("LGBM_TPU_DP_REDUCE", None)
    bst = tlgb.train(dict(PARAMS, tree_learner="data", metric="auc"),
                     tlgb.Dataset(x, y), 3, device="cpu")
    lr = bst._gbdt.learner
    res["e2e_meta"] = [lr.stats.host_syncs, lr.stats.trees, lr.scatter_cols,
                       bst.eval_train()[0][2]]
    with open(os.path.join(out, "model%d.txt" % rank), "w") as f:
        f.write(bst.model_to_string())
    # the generic iteration (K trees per iteration, DART's drops),
    # categorical splits, whose bitsets ride the scatter mode's election,
    # and label weights drawn from every rank's labels
    for name, (params, label, rows) in MODES.items():
        res["text_" + name] = tlgb.train(
            dict(params, tree_learner="data"),
            tlgb.Dataset(rows(x), label(x, y)), 2,
            device="cpu").model_to_string()
    b0.free_network()
    res["freed"] = [network.num_machines()]
    np.savez(os.path.join(out, "rank%d.npz" % rank), **{
        k: np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    main()
