"""Quantized lambdarank in the port against the JAX package on the CPU at
a size where quant_max's cap binds (above 32,768 rows the 16-bit row
storage keeps 2^30 / N levels, fewer than 32,767).

Both packages train on the same gradients: the JAX package's lambdarank
gradients at its own run's scores, recorded by a custom objective and
replayed into the port's, so that neither package's ulps in the
objective move a stochastic rounding. Both run the generic iteration over
the compact strategy with quantized_grad at 8 bits and leaf-wise
re-quantization (the JAX package's default). Compared: the stored 16-bit
integers of each round (each package's _quant_prepare on the same
gradients and key), each tree's structure, its leaf values, and the
validation ndcg@10 history. Float runs of both packages on their fused
iteration give the gap to float, and the port's own quantized runs with
and without leaf-wise re-quantization (quant_renew) show where its
leaves grow.

    python tests/rank_quant_witness.py --queries 10000 --rounds 5

prints one JSON object (bench.py's ranking data, make_ranking_like with
20 documents x 28 features per query and the held-out queries of seed
4242; 255 leaves, max_bin 63, learning_rate 0.1, min_data_in_leaf 20).
tests/test_torch_rank.py runs it at 1,700 queries.
"""
import argparse
import itertools
import json
import os
import sys
import time

import numpy as np


def _setup():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    for p in (here, os.path.dirname(here)):
        if p not in sys.path:
            sys.path.insert(0, p)


def rank_params(leaves, quantized):
    p = {"objective": "lambdarank", "num_leaves": leaves, "max_bin": 63,
         "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": ["ndcg"],
         "eval_at": [10], "verbosity": -1}
    if quantized:
        p.update(quantized_grad=True, grad_bits=8)
    return p


def rank_data(n_queries):
    from test_torch_rank import make_ranking_like
    x, y, g, w = make_ranking_like(n_queries, 20, 28)
    xv, yv, gv, _ = make_ranking_like(max(n_queries // 10, 50), 20, 28,
                                      seed=4242, w=w)
    return x, y, g, xv, yv, gv


def replay_quantized(n_queries, rounds, leaves):
    """Train quantized lambdarank in both packages on the JAX package's
    gradients. Returns {"jax": (booster, ndcg history), "torch": ...} and
    the recorded (grad, hess) of each round."""
    import jax.numpy as jnp
    import lightgbm_tpu as jlgb
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import Metadata as JMetadata
    from lightgbm_tpu.objectives import objective as jobj
    x, y, g, xv, yv, gv = rank_data(n_queries)
    meta = JMetadata(len(y))
    meta.set_label(y)
    meta.set_group(g)
    objective = jobj.LambdarankNDCG(JConfig({"objective": "lambdarank"}))
    objective.init(meta, len(y))
    recorded = []

    def record(preds, _):
        gh = tuple(np.asarray(a) for a in objective.get_gradients(
            jnp.asarray(preds, jnp.float32)))
        recorded.append(gh)
        return gh

    rounds_done = itertools.count()

    def replay(_, __):
        return recorded[next(rounds_done)]
    out = {}
    for name, lgb, kw in (("jax", jlgb, {"fobj": record}),
                          ("torch", tlgb, {"fobj": replay,
                                           "device": "cpu"})):
        ds = lgb.Dataset(x, y, group=g)
        ev = {}
        b = lgb.train(rank_params(leaves, True), ds, rounds,
                      valid_sets=[ds.create_valid(xv, yv, group=gv)],
                      valid_names=["v"], evals_result=ev,
                      verbose_eval=False, **kw)
        out[name] = (b, list(ev["v"]["ndcg@10"]))
    return out, recorded


def stored_integers_equal(grad, hess, seed=7):
    """Each package's _quant_prepare (16-bit storage under leaf
    re-quantization) on the same gradients and key: the packed words,
    the scales and the root maxes equal."""
    import jax
    import jax.numpy as jnp
    import torch
    from lightgbm_tpu.models import device_learner as jdl
    from lightgbm_tpu_torch.models import device_learner as tdl
    from lightgbm_tpu_torch.utils import random as trandom
    n = len(grad)
    _, jp, jsg, jsh, jm = jdl._quant_prepare(
        jnp.asarray(grad), jnp.asarray(hess), jnp.ones(n, jnp.float32),
        jax.random.PRNGKey(seed), quant_bits=8, quant_renew=True,
        n_total=n, axis_name=None)
    tp, tsg, tsh, tm = tdl._quant_prepare(
        torch.from_numpy(grad), torch.from_numpy(hess),
        trandom.prng_key(seed), quant_bits=8, quant_renew=True)
    return (np.array_equal(np.asarray(jp), tp.numpy())
            and float(jsg) == float(tsg) and float(jsh) == float(tsh)
            and np.array_equal(np.asarray(jm), tm.numpy()))


def structure(tree):
    k = tree.num_leaves
    return (k, list(tree.split_feature[:k - 1]), list(tree.left_child[:k - 1]),
            list(tree.right_child[:k - 1]), list(tree.leaf_count[:k]))


def leaf_rel_diff(ta, tb):
    """Largest |leaf value difference| relative to max(1, |value|)."""
    a = np.asarray(ta.leaf_value[:ta.num_leaves], np.float64)
    b = np.asarray(tb.leaf_value[:tb.num_leaves], np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))


def main():
    _setup()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--leaves", type=int, default=255)
    a = ap.parse_args()
    os.environ["LGBM_TPU_STRATEGY"] = "compact"
    import torch
    torch.set_num_threads(4)
    t0 = time.time()
    runs, recorded = replay_quantized(a.queries, a.rounds, a.leaves)
    (jb, jh), (tb, th) = runs["jax"], runs["torch"]
    jt, tt = jb._gbdt.models, tb._gbdt.models
    same = [structure(p) == structure(q) for p, q in zip(jt, tt)]
    row = {
        "rows": a.queries * 20, "queries": a.queries, "rounds": a.rounds,
        "leaves": a.leaves, "learner": [jb._gbdt.learner.strategy,
                                        tb._gbdt.learner.strategy],
        "stored_integers_equal": [stored_integers_equal(*gh)
                                  for gh in recorded],
        "same_tree_structure": same,
        "leaf_max_rel_diff": [leaf_rel_diff(p, q) if s else None
                              for p, q, s in zip(jt, tt, same)],
        "max_abs_leaf": {k: [float(np.max(np.abs(
            t.leaf_value[:t.num_leaves]))) for t in b._gbdt.models]
            for k, b in (("jax", jb), ("torch", tb))},
        "quantized_ndcg10": {"jax": jh, "torch": th},
        "ndcg_max_abs_diff": float(np.max(np.abs(np.subtract(jh, th))))}
    import lightgbm_tpu as jlgb
    import lightgbm_tpu_torch as tlgb
    x, y, g, xv, yv, gv = rank_data(a.queries)
    row["float_ndcg10"] = {}
    for name, lgb, kw in (("jax", jlgb, {}), ("torch", tlgb,
                                             {"device": "cpu"})):
        ds = lgb.Dataset(x, y, group=g)
        ev = {}
        lgb.train(rank_params(a.leaves, False), ds, a.rounds,
                  valid_sets=[ds.create_valid(xv, yv, group=gv)],
                  valid_names=["v"], evals_result=ev, verbose_eval=False,
                  **kw)
        row["float_ndcg10"][name] = list(ev["v"]["ndcg@10"])
    # the port's own quantized run (fused iteration), with and without
    # leaf-wise re-quantization
    for renew in (True, False):
        ds = tlgb.Dataset(x, y, group=g)
        ev = {}
        b = tlgb.train(dict(rank_params(a.leaves, True), quant_renew=renew),
                       ds, a.rounds,
                       valid_sets=[ds.create_valid(xv, yv, group=gv)],
                       valid_names=["v"], evals_result=ev,
                       verbose_eval=False, device="cpu")
        row["port_fused_quant_renew_%s" % ("on" if renew else "off")] = {
            "ndcg10": list(ev["v"]["ndcg@10"]),
            "max_abs_leaf": [float(np.max(np.abs(
                t.leaf_value[:t.num_leaves]))) for t in b._gbdt.models]}
    row["seconds"] = time.time() - t0
    print(json.dumps(row))


if __name__ == "__main__":
    main()
