"""One rank of a two-process gloo group for the data-parallel mode tests
(tests/test_torch_parallel_sampling.py, _quant.py, _resume.py).

Run as ``python torch_dp_modes_worker.py KIND RANK OUT_DIR PORT [ARG]``:
joins the group on 127.0.0.1:PORT, runs the KIND's cases on the CPU on
this rank's block of tests/torch_dp_worker.py's rows, and writes them to
OUT_DIR/<KIND><RANK>.npz:

* sampling -- one tree of the fused iteration's per-rank bag and GOSS
  samples on 1/64-grid gradients of SAMPLE_N rows (the learner's
  ``sample`` then ``grow_compact``, the fused step's seam) in both reduce
  modes; model
  text of RF, pos/neg bagging, fused bagging and GOSS, the renewal
  objectives and lambdarank; lambdarank's gradients of this rank's rows;
* quant -- ``quantize_gh_pmax``'s packed words of this rank's block, one
  quantized tree per reduce mode and renew setting on real gradients
  (rows without NaN), and constant-hessian trees; model text of quantized
  runs;
* resume -- a checkpoint file (ARG) restored on both ranks: the restored
  model text and this rank's scores;
* empty -- EMPTY_RANKS ranks on EMPTY_N rows, the last rank's block
  empty: one quantized tree and bagged and GOSS trees (1/64-grid
  gradients) of the fused step's seam in both reduce modes, and model
  text of end-to-end runs.
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import lightgbm_tpu_torch as tlgb  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.distributed import bootstrap  # noqa: E402
from lightgbm_tpu_torch.distributed.checkpoint import (  # noqa: E402
    restore_for_resume)
from lightgbm_tpu_torch.io.dataset import Dataset  # noqa: E402
from lightgbm_tpu_torch.ops import quantize as quant_ops  # noqa: E402
from lightgbm_tpu_torch.parallel import learners, network  # noqa: E402
from lightgbm_tpu_torch.utils import random as trandom  # noqa: E402

import torch_dp_worker as base  # noqa: E402

PARAMS = dict(base.PARAMS, tree_learner="data")
BAG_SEED = 5
# rows of the per-rank sample trees: odd (rank 1 pads one row), and each
# rank's GOSS multiplier (real - top) / other is dyadic (1,032 / 129 and
# 1,032 / 128), so the amplified 1/64-grid gradients sum exactly
SAMPLE_N = 2579
SAMPLES = {"bag": dict(bagging_fraction=0.7, bagging_freq=1),
           "goss": dict(boosting="goss", top_rate=0.2, other_rate=0.1)}
# end-to-end runs of 3 rounds: (params, label of (x, y))
RUNS = {
    "rf": (dict(PARAMS, boosting="rf", bagging_fraction=0.8,
                bagging_freq=1), lambda x, y: y),
    "posneg": (dict(PARAMS, pos_bagging_fraction=0.5,
                    neg_bagging_fraction=0.7, bagging_freq=1),
               lambda x, y: y),
    "fused_bag": (dict(PARAMS, bagging_fraction=0.7, bagging_freq=1),
                  lambda x, y: y),
    "fused_goss": (dict(PARAMS, boosting="goss", learning_rate=0.5),
                   lambda x, y: y)}
RENEW = {name: (dict(PARAMS, objective=name, alpha=0.3),
                lambda x, y: x[:, 0] + 0.3 * np.nan_to_num(x[:, 2]) + 2.0)
         for name in ("regression_l1", "quantile", "mape")}
QUANT_RUNS = {
    "quant": dict(PARAMS, quantized_grad=True, grad_bits=8),
    "quant_bag": dict(PARAMS, quantized_grad=True, grad_bits=8,
                      quant_renew=False, bagging_fraction=0.7,
                      bagging_freq=1)}


def ranking(num_queries=120, seed=3):
    """(x, relevance labels, query sizes): ragged queries of 13-37
    documents, 3,001 rows in all (the boundary of two ranks' ceil blocks,
    row 1,501, falls inside a query)."""
    r = np.random.RandomState(seed)
    d = r.randint(-12, 13, size=num_queries // 2)
    sizes = np.full(num_queries, 3001 // num_queries)
    sizes[0::2] += d
    sizes[1::2] -= d
    sizes[-1] += 3001 - sizes.sum()
    x = r.randn(int(sizes.sum()), 6)
    rel = np.clip(np.round(x[:, 0] + 0.5 * x[:, 1] + r.randn(len(x)) * 0.5
                           + 1.5), 0, 4)
    return x, rel, sizes


RANK_PARAMS = dict(PARAMS, objective="lambdarank", min_data_in_leaf=5)

# four ranks' ceil blocks of 9 rows: 3, 3, 3 and none
EMPTY_RANKS = 4
EMPTY_N = 9
EMPTY_PARAMS = dict(PARAMS, min_data_in_leaf=1, min_sum_hessian_in_leaf=0.0)
EMPTY_TREES = {"quant": dict(quantized_grad=True, grad_bits=8), **SAMPLES}
EMPTY_RUNS = {"quant": dict(quantized_grad=True, grad_bits=8),
              "bag": dict(bagging_fraction=0.7, bagging_freq=1),
              "goss": dict(boosting="goss", learning_rate=1.0),
              "posneg": dict(pos_bagging_fraction=0.5,
                             neg_bagging_fraction=0.7, bagging_freq=1),
              "regression_l1": dict(objective="regression_l1")}


def _tree(tl, g, h, **sample):
    """One tree of the fused step's seam: the sample, then grow_compact;
    (records, block leaf ids, k, w)."""
    lo, hi = tl.row_block
    g, h = torch.from_numpy(g[lo:hi]), torch.from_numpy(h[lo:hi])
    w = None
    if sample:
        g, h, w = tl.sample(g, h, BAG_SEED, goss=sample["goss"])
    rec, leaf, k = tl.grow_compact(g, h, 0, w)
    rec_h, k, _ = tl.fetch_tree(rec, k)
    return rec_h[:k], leaf.numpy(), k, (None if w is None else w.numpy())


def sampling(res, x, y, g, h, gq, hq):
    xs, ys, _, _, gs, hs = base.data(SAMPLE_N)
    for mode in ("psum", "scatter"):
        os.environ["LGBM_TPU_DP_REDUCE"] = mode
        for name, extra in SAMPLES.items():
            cfg = Config(dict(PARAMS, **extra))
            tl = learners.create_tree_learner(cfg, Dataset(xs, config=cfg,
                                                           label=ys))
            rec, leaf, k, w = _tree(tl, gs, hs, goss=name == "goss")
            res["%s_%s_rec" % (mode, name)] = rec
            res["%s_%s_leaf" % (mode, name)] = leaf
            res["%s_%s_w" % (mode, name)] = w
    os.environ.pop("LGBM_TPU_DP_REDUCE")
    for name, (params, label) in list(RUNS.items()) + list(RENEW.items()):
        b = tlgb.train(dict(params), tlgb.Dataset(x, label(x, y)), 3,
                       device="cpu")
        res["text_" + name] = b.model_to_string()
        res["syncs_" + name] = [b._gbdt.learner.stats.host_syncs,
                                b._gbdt.learner.stats.trees]
    xr, rel, sizes = ranking()
    b = tlgb.train(dict(RANK_PARAMS), tlgb.Dataset(xr, rel, group=sizes), 3,
                   device="cpu")
    res["text_rank"] = b.model_to_string()
    obj = b._gbdt.objective
    score = torch.as_tensor(0.3 * xr[:, 0] - 0.2 * xr[:, 3],
                            dtype=torch.float32)
    lo, hi = b._gbdt.row_block
    c0, b0 = network.collectives, network.collective_bytes
    grad, hess = obj.get_gradients(score[lo:hi].contiguous())
    res["rank_grad"] = np.stack([grad.numpy(), hess.numpy()])
    res["rank_gather"] = [network.collectives - c0,
                          network.collective_bytes - b0, lo, hi]


def _spy_reduce(tl, calls):
    """Record every call of the learner's histogram reduction: the local
    histogram, [leaf count, hessian total] and the reduced result."""
    orig = tl.reduce_hist

    def spy():
        f = orig()
        if f is None:
            return None

        def reduce(hist, leaf_n=None, qh_total=None):
            out = f(hist, leaf_n, qh_total)
            calls.append((hist.clone(), [float(leaf_n), float(qh_total)],
                          out.clone()))
            return out
        return reduce
    tl.reduce_hist = spy


def quant(res, x, y, g, h, gq, hq):
    cfg = Config(dict(PARAMS, quantized_grad=True))
    tl = learners.create_tree_learner(cfg, Dataset(x, config=cfg, label=y))
    lo, hi = tl.row_block
    for bits in (8, 16):
        packed, s_g, s_h = quant_ops.quantize_gh_pmax(
            tl._pad(torch.from_numpy(g[lo:hi])),
            tl._pad(torch.from_numpy(h[lo:hi])), trandom.prng_key(3),
            grad_bits=bits, n_total=tl.n_pad, rank=tl.mesh.rank,
            reduce_max=network.all_reduce_max)
        res["packed_%d" % bits] = packed.numpy()
        res["scales_%d" % bits] = [float(s_g), float(s_h)]
    ones = np.ones_like(h)
    for mode in ("psum", "scatter"):
        os.environ["LGBM_TPU_DP_REDUCE"] = mode
        for renew in (True, False):
            cfg = Config(dict(PARAMS, quantized_grad=True, grad_bits=8,
                              quant_renew=renew))
            ds = Dataset(np.nan_to_num(x), config=cfg, label=y)
            tl = learners.create_tree_learner(cfg, ds)
            calls = []
            if mode == "scatter":
                _spy_reduce(tl, calls)
                res["missing_types"] = tl.meta["t_missing"].numpy()
            c0, b0 = network.collectives, network.collective_bytes
            rec, leaf, k, _ = _tree(tl, g, h)
            tag = "%s_%s" % (mode, "renew" if renew else "fixed")
            if calls:
                # the root's reduction, then one per split step
                for j, part in enumerate(("in", "n", "out")):
                    res["%s_reduce_%s" % (tag, part)] = np.stack(
                        [np.asarray(c[j]) for c in calls])
                calls.clear()
            res[tag + "_rec"] = rec
            res[tag + "_leaf"] = leaf
            res[tag + "_wire"] = [network.collectives - c0,
                                  network.collective_bytes - b0,
                                  tl.scatter_cols]
            # constant hessians (objective=regression's)
            rec, leaf, k, _ = _tree(tl, g, ones)
            res[tag + "_const_rec"] = rec
            res[tag + "_const_leaf"] = leaf
    os.environ.pop("LGBM_TPU_DP_REDUCE")
    # 240 rows: 127 x 240 <= 32,767, where the JAX package's scatter mode
    # picks an int16 wire; the port's lanes are int32
    small = dict(PARAMS, quantized_grad=True, grad_bits=8, num_leaves=7,
                 min_data_in_leaf=5)
    c0, b0 = network.collectives, network.collective_bytes
    b = tlgb.train(small, tlgb.Dataset(x[:240], y[:240]), 2, device="cpu")
    lr = b._gbdt.learner
    res["small_text"] = b.model_to_string()
    res["small_wire"] = [network.collectives - c0,
                         network.collective_bytes - b0, lr.scatter_cols]
    for name, params in QUANT_RUNS.items():
        b = tlgb.train(dict(params, metric="auc"), tlgb.Dataset(x, y), 3,
                       device="cpu")
        res["text_" + name] = b.model_to_string()
        res["auc_" + name] = b.eval_train()[0][2]


def empty(res):
    x, y, g, h, gq, hq = base.data(EMPTY_N)
    x = np.nan_to_num(x)
    for mode in ("psum", "scatter"):
        os.environ["LGBM_TPU_DP_REDUCE"] = mode
        for name, extra in EMPTY_TREES.items():
            cfg = Config(dict(EMPTY_PARAMS, **extra))
            tl = learners.create_tree_learner(cfg, Dataset(x, config=cfg,
                                                           label=y))
            sample = {} if name == "quant" else {"goss": name == "goss"}
            rec, leaf, k, w = _tree(tl, g if name == "quant" else gq,
                                    h if name == "quant" else hq, **sample)
            res["%s_%s_rec" % (mode, name)] = rec
            res["%s_%s_leaf" % (mode, name)] = leaf
            res["block"] = list(tl.row_block)
    os.environ.pop("LGBM_TPU_DP_REDUCE")
    for name, extra in EMPTY_RUNS.items():
        b = tlgb.train(dict(EMPTY_PARAMS, **extra), tlgb.Dataset(x, y), 3,
                       device="cpu")
        res["text_" + name] = b.model_to_string()


def resume(res, x, y, path):
    params = dict(PARAMS)
    b = tlgb.Booster(params=params, train_set=tlgb.Dataset(x, y),
                     device="cpu")
    data = restore_for_resume(b, path)
    res["text"] = b.model_to_string()
    res["score"] = b._gbdt.score_updater.score.numpy()
    res["block"] = list(b._gbdt.row_block)
    res["iteration"] = [data.iteration, b.current_iteration()]
    # one more iteration from the restored state, byte-equal on both ranks
    b.update()
    res["text_next"] = b.model_to_string()


def main():
    kind, rank, out, port = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        int(sys.argv[4])
    os.environ["LGBM_TPU_DEVICE_TYPE"] = "cpu"
    bootstrap.initialize("127.0.0.1:%d" % port,
                         EMPTY_RANKS if kind == "empty" else 2, rank)
    res = {}
    x, y, g, h, gq, hq = base.data()
    try:
        if kind == "sampling":
            sampling(res, x, y, g, h, gq, hq)
        elif kind == "quant":
            quant(res, x, y, g, h, gq, hq)
        elif kind == "empty":
            empty(res)
        else:
            resume(res, x, y, sys.argv[5])
    finally:
        bootstrap.shutdown()
    np.savez(os.path.join(out, "%s%d.npz" % (kind, rank)), **{
        k: np.asarray(v) for k, v in res.items() if v is not None})


if __name__ == "__main__":
    main()
