"""Row and feature sampling of the port (bagging, GOSS, feature_fraction)
against the JAX package, on the CPU.

The samplers of the fused iteration (``exact_k_bag_weights``,
``goss_sample``) and the router's plain version (``route_rows_plain``,
the JAX ``route_rows_by_rec``) are held bit for bit against the JAX
functions from the same keys, gradients and records. The generic
iteration's host bag goes through ``DeviceTreeLearner.grow(...,
bag_indices)``: the compact strategy compacts the bag (quantizing grad *
w over all N rows first) and routes the other rows, the masked one weights
its operand; both against the JAX learner's weighted grow from the same
gradients. End to end, ``train`` with bagging, GOSS, pos/neg bagging and
feature_fraction against ``lightgbm_tpu.train``.

Ties. Where a leaf's rows leave a bin empty, two thresholds (or both
missing directions) split its rows alike, and f32 rounding picks one in
each package (ROADMAP section 3). Without sampling every training row is
a row of the tree, so no row tells the two apart. Under bagging the
out-of-bag rows of such a bin do: each package routes them by its own
threshold, and their scores then differ. So the end-to-end check holds
the trees to the same structure and every in-bag row of a tree to the
same leaf in both, and the raw scores to 1e-4 on every row that reaches
the same leaves in both. Under GOSS a score that differs changes the next
sample, so the GOSS runs are held over their warm-up and the first two
sampled trees. 3000-row tasks, 15 leaves, min_gain_to_split 1e-3.
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
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.ops import quantize as jquant
from lightgbm_tpu.ops.histogram import build_histogram_quantized as jhist_q
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.ops import quantize as tquant
from lightgbm_tpu_torch.ops.kernels import histogram as khist
from lightgbm_tpu_torch.ops.kernels import split_key as kkey
from lightgbm_tpu_torch.utils import random as trandom
from test_torch_engine import _params, _structure, _task
from test_torch_learner import _data
from test_torch_masked import FLOATS, INTS

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


@pytest.mark.parametrize("n,bag_k,seed", [(3001, 2400, 0), (3001, 1, 7),
                                          (5000, 4999, 3)])
def test_exact_k_bag_weights_matches_jax(n, bag_k, seed):
    want = jdl.exact_k_bag_weights(jax.random.PRNGKey(seed), n, bag_k)
    got = tdl.exact_k_bag_weights(trandom.prng_key(seed), n, bag_k, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) >= bag_k


@pytest.mark.parametrize("ties", [False, True])
def test_goss_sample_matches_jax(ties):
    # with ties: |g * h| takes 40 values (rows of one leaf share their
    # score), so the stable sorts decide the top set's boundary
    r = np.random.RandomState(2)
    n, top_k, other_k = 3001, 600, 300
    g = r.randn(n).astype(np.float32)
    h = (0.05 + r.rand(n) * 0.2).astype(np.float32)
    if ties:
        grp = r.randint(0, 40, n)
        g, h = g[grp], h[grp]
    multiply = (n - top_k) / other_k
    for seed in (0, 5):
        want = jdl.goss_sample(jnp.asarray(g), jnp.asarray(h),
                               jax.random.PRNGKey(seed), n, top_k, other_k,
                               multiply)
        got = tdl.goss_sample(torch.from_numpy(g), torch.from_numpy(h),
                              trandom.prng_key(seed), n, top_k, other_k,
                              multiply)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("item_bits", [4, 8, 16])
def test_route_rows_plain_matches_jax(item_bits):
    # random packed rows and random records over features of an EFB
    # bundle column and plain columns, each missing type; k = 0 (every
    # row in leaf 0), a few records, and every record
    r = np.random.RandomState(item_bits)
    per, nb = 32 // item_bits, 1 << item_bits
    m, cw, f, L = 2001, 3, 9, 31
    rows = r.randint(-2**31, 2**31, size=(m, cw), dtype=np.int64) \
        .astype(np.int32)
    f_col = r.randint(0, cw * per, f).astype(np.int32)
    f_elide = (np.arange(f) % 3 == 0).astype(np.int32)
    f_numbins = r.randint(3, min(nb, 64), f).astype(np.int32)
    f_base = np.where(f_elide == 1, r.randint(0, nb // 2, f), 0) \
        .astype(np.int32)
    f_missing = (np.arange(f) % 3).astype(np.int32)
    f_default = (r.randint(0, 100, f) % f_numbins).astype(np.int32)
    rec = np.zeros((L - 1, 13), np.float32)
    feats = r.randint(0, f, L - 1)
    rec[:, tdl.R_LEAF] = [r.randint(0, i + 1) for i in range(L - 1)]
    rec[:, tdl.R_FEAT] = feats
    rec[:, tdl.R_THR] = r.randint(0, f_numbins[feats])
    rec[:, tdl.R_DLEFT] = r.randint(0, 2, L - 1)
    table = torch.from_numpy(np.stack([f_col, f_base, f_elide, f_numbins,
                                       f_missing, f_default], axis=1))
    jmeta = [jnp.asarray(a) for a in (f_numbins, f_missing, f_default,
                                      f_col, f_base, f_elide)]
    for k in (0, 5, L - 1):
        want = jdl.route_rows_by_rec(
            jnp.asarray(rows.view(np.uint32)), jnp.asarray(rec),
            jnp.int32(k), *jmeta, item_bits=item_bits, num_leaves=L)
        got = kkey.route_rows(torch.from_numpy(rows), torch.from_numpy(rec),
                              torch.tensor(k, dtype=torch.int32), table,
                              item_bits=item_bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (k == 0) == (not got.any())


def _replay(ds, rec, k):
    """Each row's leaf under the first k records, replayed over the
    training rows' bins (dense features)."""
    nb, mt, db, _, _ = ds.feature_meta_arrays()
    leaf = np.zeros(ds.num_data, np.int64)
    for i in range(k):
        l, f, thr, dl = (int(rec[i, 0]), int(rec[i, 1]), int(rec[i, 2]),
                         rec[i, 3] > 0.5)
        bins = ds.binned[:, f].astype(np.int64)
        missing = (((mt[f] == 2) & (bins == nb[f] - 1))
                   | ((mt[f] == 1) & (bins == db[f])))
        left = np.where(missing, dl, bins <= thr)
        leaf[(leaf == l) & ~left] = i + 1
    return leaf


def _root_histograms(jl, tl, g, h, w, bag, strategy):
    """(JAX, port) int32 root histograms of a quantized tree grown from
    (g, h) on the host bag `bag` (0/1 weights w) with PRNGKey(3): JAX over
    all N rows with the weights, as its grow programs build them (compact:
    the root's re-quantized operand; masked: grad * w quantized, valid =
    w > 0); the port over its compacted bag rows (compact) or weighted
    operand (masked)."""
    n, nb = len(g), tl.col_device_bins
    gj, hj, wj = jnp.asarray(g), jnp.asarray(h), jnp.asarray(w)
    codes = jnp.asarray(jl.dataset.binned)
    if strategy == "masked":
        qkey = jax.random.split(jax.random.PRNGKey(3))[1]
        packed, _, _ = jquant.quantize_gh_core(gj * wj, hj * wj, qkey,
                                               grad_bits=8)
        want = jhist_q(codes, jquant.gh_operand(packed, wj > 0, 8), nb)
        gh, _ = tl.masked_operand(torch.from_numpy(g), torch.from_numpy(h),
                                  3, torch.from_numpy(w))
        got = khist.build_histogram_quantized_t(tl.codes_t, gh, nb)
        return np.asarray(want), got.numpy()
    _, packed, _, _, root_max = jdl._quant_prepare(
        gj, hj, wj, jax.random.PRNGKey(3), quant_bits=8, quant_renew=True,
        n_total=n, axis_name=None)
    qcap = jquant.quant_max(8, n)
    r = [jquant.requant_ratio(root_max[i], qcap) for i in (0, 1)]
    want = jhist_q(codes, jquant.gh_operand_scaled(packed, wj > 0, 8, qcap,
                                                   *r), nb)
    rows, qr = tl.quant_working_buffer(
        torch.from_numpy(g), torch.from_numpy(h), trandom.prng_key(3),
        bag_idx=torch.from_numpy(bag).long(), n_total=n)
    rt = [tquant.requant_ratio(qr.root_max[i], qr.qcap_op) for i in (0, 1)]
    got = khist.build_histogram_quantized_rows(
        rows, tl.codes_pack.shape[1], tl.c_cols, tl.item_bits, *rt,
        qr.qcap_op, 8, nb)
    return np.asarray(want), got.numpy()


def _host_bag(n, frac=0.6, seed=5):
    return np.sort(np.random.RandomState(seed).choice(
        n, int(n * frac), replace=False)).astype(np.int32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_host_bag_records_match_jax(strategy, quant):
    # the generic iteration's host bag, from the same gradients: the JAX
    # learner grows over all rows with 0/1 weights, the port's compact
    # strategy over the compacted bag (quantized over all N rows, then
    # gathered) and its masked strategy over the weighted operand
    x, g, h = _data("dense")
    n = len(x)
    bag = _host_bag(n)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
              "verbosity": -1, "quantized_grad": quant, "grad_bits": 8}
    jcfg, tcfg = JConfig(params), TConfig(params)
    jl = jdl.DeviceTreeLearner(
        jcfg, JDataset(x, config=jcfg, label=np.zeros(n)), strategy=strategy)
    w = np.zeros(n, np.float32)
    w[bag] = 1.0
    jl._ones_w = jnp.ones(n, jnp.float32)
    jrec, _, jleaf, jk, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.ones(jl.num_features, bool), jax.random.PRNGKey(3))
    jrec, jleaf, jk = np.asarray(jrec), np.asarray(jleaf), int(jk)
    tl = tdl.DeviceTreeLearner(
        tcfg, TDataset(x, config=tcfg, label=np.zeros(n)), strategy=strategy,
        device="cpu")
    trec, tleaf, tk = tl.grow(torch.from_numpy(g), torch.from_numpy(h),
                              iter_seed=3, bag_indices=bag)
    assert tk == jk and tk > 3
    if strategy == "compact":
        # one carry: the bag's rows, the operand cap from N
        qcap = tdl.quant_ops.quant_max(8, n) if quant else 0
        assert list(tl._states) == [(len(bag), qcap)]
    # the bounds of the unsampled parity tests (test_torch_masked.py):
    # quantized, the integer histograms are the JAX weighted layout's, so
    # the counts are exact and the f32 columns agree to the split scan's
    # arithmetic (1e-5); float, 1e-4
    np.testing.assert_array_equal(trec[:tk, INTS], jrec[:jk, INTS])
    tol = 1e-5 if quant else 1e-4
    np.testing.assert_allclose(trec[:tk, FLOATS], jrec[:jk, FLOATS],
                               rtol=tol, atol=tol)
    if quant:
        np.testing.assert_array_equal(trec[:tk, [tdl.R_LCNT, tdl.R_RCNT]],
                                      jrec[:jk, [tdl.R_LCNT, tdl.R_RCNT]])
    # the root's counts are the bag's rows
    assert trec[0, tdl.R_LCNT] + trec[0, tdl.R_RCNT] == len(bag)
    if quant:
        # the compaction claim: the root's integer histogram of the
        # port's rows (the bag gathered, quantized over all N rows) is
        # the JAX weighted layout's over all N rows, bit for bit
        want, got = _root_histograms(jl, tl, g, h, w, bag, strategy)
        np.testing.assert_array_equal(got, want)
    # every in-bag row's leaf is the JAX learner's; every row's is the one
    # the port's records give it (the out-of-bag rows' on compact from the
    # router)
    tleaf = tleaf.numpy()
    np.testing.assert_array_equal(tleaf[bag], jleaf[bag])
    np.testing.assert_array_equal(tleaf, _replay(tl.dataset, trec, tk))


def _recorded_bags(monkeypatch, n):
    """Each grown tree's in-bag rows of the port's run, recorded from the
    growth loops' arguments."""
    bags = []
    grow_c = tdl.DeviceTreeLearner.grow_compact
    grow_m = tdl.DeviceTreeLearner.grow_masked

    def compact(self, grad, hess, iter_seed=0, bag_idx=None, oob_idx=None,
                n_total=None):
        inbag = np.ones(n, bool)
        if bag_idx is not None:
            inbag[:] = False
            inbag[bag_idx.numpy()] = True
        bags.append(inbag)
        return grow_c(self, grad, hess, iter_seed, bag_idx, oob_idx, n_total)

    def masked(self, grad, hess, iter_seed=0, w=None):
        bags.append(np.ones(n, bool) if w is None else w.numpy() > 0)
        return grow_m(self, grad, hess, iter_seed, w)

    monkeypatch.setattr(tdl.DeviceTreeLearner, "grow_compact", compact)
    monkeypatch.setattr(tdl.DeviceTreeLearner, "grow_masked", masked)
    return bags


def _assert_same_sampled_trees(tb, jb, x, bags):
    """The same split structure; each tree's in-bag rows in the same leaf
    of both trees; raw scores within 1e-4 on every row that reaches the
    same leaves of both."""
    tm, jm = tb._gbdt.models, jb._gbdt.models
    assert len(bags) == len(tm)
    assert _structure(tm) == _structure(jm)
    separated = np.zeros(len(x), bool)
    for ta, tj, inbag in zip(tm, jm, bags):
        apart = np.array([ta.predict_leaf_row(row) != tj.predict_leaf_row(row)
                          for row in x])
        assert not np.any(apart & inbag)
        separated |= apart
    assert separated.mean() < 0.2
    np.testing.assert_allclose(tb.predict(x, raw_score=True)[~separated],
                               jb.predict(x, raw_score=True)[~separated],
                               rtol=1e-4, atol=1e-4)


SAMPLERS = {
    "bagging": ({"bagging_fraction": 0.5, "bagging_freq": 2}, 6),
    # learning_rate 0.5: a warm-up of 2 iterations, then 2 sampled trees
    "goss": ({"boosting": "goss", "learning_rate": 0.5}, 4),
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_fused_sampling_matches_jax(strategy, sampler, quant, monkeypatch):
    # the fused iteration on both sides: its bags drawn on the device from
    # the same threefry keys
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _task("binary")
    extra, rounds = SAMPLERS[sampler]
    params = dict(_params("binary"), quantized_grad=quant, grad_bits=8,
                  **extra)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=rounds,
                    verbose_eval=False)
    bags = _recorded_bags(monkeypatch, len(x))
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=rounds,
                    device="cpu")
    gb = tb._gbdt
    assert gb.learner.strategy == strategy
    assert gb._fused_eligible()
    # GOSS: its warm-up step and its sampling step
    assert sorted(gb._fused_step) == ([False, True] if sampler == "goss"
                                      else [False])
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees == rounds
    assert tb.num_trees() == jb.num_trees() == rounds
    assert not all(b.all() for b in bags)
    _assert_same_sampled_trees(tb, jb, x, bags)
    # the out-of-bag rows' scores came from the router: the training
    # scores are the model's predictions
    np.testing.assert_allclose(gb.score_updater.score[0].numpy(),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


GENERIC = {
    "pos_neg": {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.7,
                "bagging_freq": 2},
    "bagging": {"bagging_fraction": 0.6, "bagging_freq": 1},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", sorted(GENERIC))
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_generic_sampling_matches_jax(strategy, case, quant, monkeypatch):
    # the generic iteration, whose bags the host draws (pos / neg bagging
    # takes it by itself; bagging and GOSS here with the fused iteration
    # turned off in both packages), one sync per tree
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _task("binary")
    params = dict(_params("binary"), quantized_grad=quant, grad_bits=8,
                  **GENERIC[case])
    rounds = 4 if case == "goss" else 6
    if case != "pos_neg":
        monkeypatch.setattr(jgbdt.GBDT, "_fused_eligible", lambda s: False)
        monkeypatch.setattr(tgbdt.GBDT, "_fused_eligible", lambda s: False)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=rounds,
                    verbose_eval=False)
    bags = _recorded_bags(monkeypatch, len(x))
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=rounds,
                    device="cpu")
    gb = tb._gbdt
    assert not gb._fused_eligible() and gb._fused_step is None
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees == rounds
    assert tb.num_trees() == jb.num_trees() == rounds
    assert not all(b.all() for b in bags)
    _assert_same_sampled_trees(tb, jb, x, bags)
    np.testing.assert_allclose(gb.score_updater.score[0].numpy(),
                               tb.predict(x, raw_score=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_feature_fraction_matches_jax(fused, monkeypatch):
    # the tree's feature sample from the host RandomState, as in JAX
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _task("binary")
    params = dict(_params("binary"), feature_fraction=0.7)
    if not fused:
        monkeypatch.setattr(jgbdt.GBDT, "_fused_eligible", lambda s: False)
        monkeypatch.setattr(tgbdt.GBDT, "_fused_eligible", lambda s: False)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=6,
                    verbose_eval=False)
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=6,
                    device="cpu")
    assert (tb._gbdt._fused_step is not None) == fused
    assert tb.num_trees() == jb.num_trees() == 6
    used = {f for t in tb._gbdt.models
            for f in t.split_feature[:t.num_leaves - 1]}
    assert len(used) > 1
    _assert_same_sampled_trees(tb, jb, x, [np.ones(len(x), bool)] * 6)

