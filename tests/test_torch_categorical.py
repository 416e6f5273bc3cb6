"""Categorical splits: the port against the JAX package on the CPU.

(a) Binning: categorical bin mappers, codes and EFB bundles bit for bit.
(b) The split scan (``per_feature_best_categorical`` and
    ``materialize_cat_split``) on identical random histograms: the same
    feature and left-bin mask, gains within 2e-5 relative.
(c) The split records of both strategies, host loop and device loop,
    against JAX ``_run_grow`` from the same gradients: integer columns,
    left-bin masks (the port's bitset words unpacked) and row -> leaf maps
    equal, f32 columns within 1e-4 relative (the repo's bound for the f32
    scan: a gain is the best candidate's objective less the leaf's, and
    that difference turns a last-bit difference of the two packages' f32
    prefix sums into up to ~2e-5 relative, from equal integer histograms
    too).
(d) ``train()`` end to end, 8 rounds, and (e) model text across packages.

Mirrored ties. The k-vs-rest walk runs from both ends of the sorted bins,
and when a leaf holds rows in its valid bins only, the forward set of k
bins and the backward set of the other n - k are one partition: the two
gains are equal in exact arithmetic, and f32 rounding picks the side each
package calls left (one-hot candidates of a two-bin leaf likewise). The
JAX float histogram sums a bf16 hi / lo split (ROADMAP section 3), so its
rounding differs from the port's and such ties go either way. So (c)
rounds float gradients to multiples of 1/16 (hessians too): every
histogram sum is then exact in both packages, each tie is exact, and both
take the forward walk (its gain wins ties, as in LightGBM). Quantized
histograms are integers and equal anyway. (d) trains with a custom
objective whose gradients are multiples of 1/64 (the same exact sums) and
then asks for equal model text; the built-in binary objective's fused
iteration is held on what ties cannot move: raw training scores within
1e-5 of the JAX package's and of its own predict.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as jlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models import device_learner as jdl
from lightgbm_tpu.models.tree import Tree as JTree
from lightgbm_tpu.ops import bundle as jbundle
from lightgbm_tpu.ops import split as jsplit
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.binning import BIN_CATEGORICAL
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.models.tree import Tree as TTree
from lightgbm_tpu_torch.ops import bundle as tbundle
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.kernels import desc as dsc
from lightgbm_tpu_torch.ops.kernels import split_key as kkey
from lightgbm_tpu_torch.ops.partition import mask_to_words, words_to_mask

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "min_gain_to_split": 1e-3, "verbosity": -1}


def _cat_task(n=3000, seed=5):
    """A 3-category column (one-hot mode), a 40-category column (sorted
    mode) and two numerical ones, per-category effects from randn."""
    r = np.random.RandomState(seed)
    c1, c2 = r.randint(0, 3, n), r.randint(0, 40, n)
    e1, e2 = r.randn(3), r.randn(40)
    xn = r.randn(n, 2)
    x = np.column_stack([c1, c2, xn]).astype(np.float64)
    margin = e1[c1] + e2[c2] + 0.5 * xn[:, 0]
    y = (margin + 0.5 * r.randn(n) > 0).astype(np.float64)
    return x, y, margin


# ---- (a) binning -----------------------------------------------------------

def _binning_data(n=4000, seed=0):
    r = np.random.RandomState(seed)
    # count-sorted: 12 categories of distinct frequencies, 0 the most
    # frequent (LightGBM swaps it out of bin 0)
    p = np.arange(12, 0, -1, dtype=np.float64)
    c0 = r.choice(12, n, p=p / p.sum())
    # a long tail: the 99 % cut sends the rarest to the overflow bin, with
    # NaN and negative values (read as NaN) beside them
    c1 = ((r.zipf(1.4, n) - 1) % 150).astype(np.float64)
    c1[r.rand(n) < 0.02] = np.nan
    c1[r.rand(n) < 0.01] = -3
    # sparse, mutually exclusive columns that EFB bundles: two
    # categorical ones whose most frequent category (bin 0, the default
    # bin) is not 0, and a numerical one
    which = r.randint(0, 12, n)
    c2 = np.where(which == 0, r.randint(0, 6, n), 9)
    c3 = np.where(which == 1, r.randint(1, 9, n), 20)
    s4 = np.where(which == 2, 0.5 + r.rand(n) * 3, 0.0)
    return np.column_stack([c0, c1, c2, c3, s4, r.randn(n)])


@pytest.mark.parametrize("extra", [
    {"max_bin": 255},
    # a sample of 1,000 rows: categories the sample misses go to the
    # last bin; max_bin 15 cuts the count-sorted list
    {"max_bin": 15, "bin_construct_sample_cnt": 1000}])
def test_categorical_binning_matches_jax(extra):
    x = _binning_data()
    params = dict(BASE, categorical_feature=[0, 1, 2, 3], **extra)
    jds = JDataset(x, config=JConfig(params), label=np.zeros(len(x)))
    tds = TDataset(x, config=TConfig(params), label=np.zeros(len(x)))
    assert tds.used_features == jds.used_features
    for fj, ft in zip(jds.bin_mappers, tds.bin_mappers):
        for key in ("bin_type", "num_bin", "missing_type", "default_bin",
                    "bin_2_categorical", "categorical_2_bin"):
            assert getattr(ft, key) == getattr(fj, key), key
    assert [tds.bin_mappers[f].bin_type for f in range(4)] \
        == [BIN_CATEGORICAL] * 4
    assert tds.bin_mappers[0].bin_2_categorical[0] != 0
    np.testing.assert_array_equal(tds.binned, jds.binned)
    # EFB: the same columns, and each feature's logical bins decoded from
    # the bundled codes equal to its own codes
    assert tds.columns is not None
    assert [c.features for c in tds.columns] \
        == [c.features for c in jds.columns]
    assert any(len(c.features) > 1 and any(
        tds.bin_mappers[tds.used_features[f]].bin_type == BIN_CATEGORICAL
        for f in c.features) for c in tds.columns)
    for a, b in zip(tds.bundle_arrays(), jds.bundle_arrays()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    codes, f_col, f_base, f_elide = tds.bundle_arrays()[:4]
    nb, _, db, _, _ = tds.feature_meta_arrays()
    for f in range(tds.num_features):
        col = np.asarray(codes)[:, f_col[f]].astype(np.int64)
        got = tbundle.logical_bins_for_feature(
            torch.from_numpy(col), int(f_base[f]), int(db[f]), int(nb[f]),
            int(f_elide[f])).numpy()
        want = np.asarray(jbundle.logical_bins_for_feature(
            jnp.asarray(col, jnp.int32), f_base[f], db[f], nb[f],
            f_elide[f]))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tds.binned[:, f])


# ---- (b) the scan ----------------------------------------------------------

SCAN = dict(l1=0.1, l2=1.0, cat_l2=10.0, cat_smooth=10.0,
            max_delta_step=0.0, min_data_in_leaf=20, min_sum_hessian=1e-3,
            min_gain_to_split=0.0, max_cat_threshold=32,
            max_cat_to_onehot=4, min_data_per_group=100)
SCAN_CASES = {
    "onehot": dict(max_cat_to_onehot=64),
    "sorted": {},
    "ctr_ties": {},
    "max_cat_threshold": dict(max_cat_threshold=3),
    "cat_l2": dict(cat_l2=0.0, l1=0.0),
    "cat_smooth": dict(cat_smooth=0.5),
    "min_data_per_group": dict(min_data_per_group=400, max_delta_step=0.7),
    "masked_feature": {},
}


def _scan_hist(case, r, f=5, b=64):
    nb = np.array([3, 20, 40, 64, 64], np.int32)
    mt = np.array([0, 2, 0, 2, 1], np.int32)
    hists = []
    for _ in range(2):
        c = r.randint(0, 60, (f, b)).astype(np.float32)
        c[np.arange(b)[None, :] >= nb[:, None]] = 0
        h = (c * (0.2 + 0.05 * r.rand(f, b))).astype(np.float32)
        g = (r.randn(f, b) * c * 0.3).astype(np.float32)
        if case == "ctr_ties":
            # equal g / (h + cat_smooth) over several bins of a feature
            g[2, 5:15] = (h[2, 5:15] + 10.0) * np.float32(0.75)
            g[3, ::3] = (h[3, ::3] + 10.0) * np.float32(-0.5)
        hists.append(np.stack([g, h, c], -1))
    return np.stack(hists).astype(np.float32), nb, mt


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_categorical_scan_matches_jax(case):
    r = np.random.RandomState(sorted(SCAN_CASES).index(case))
    hist, nb, mt = _scan_hist(case, r)
    kw = dict(SCAN, **SCAN_CASES[case])
    # the leaves' totals: one feature's sums (a histogram sums to them)
    tot = hist[:, 1].sum(axis=1)                           # (2, 3)
    fm = np.ones(5, bool)
    t = torch.from_numpy
    rel, aux = tsplit.per_feature_best_categorical(
        t(hist), t(tot[:, 0]), t(tot[:, 1]), t(tot[:, 2]), t(nb), t(mt),
        t(fm), torch.full((2,), -np.inf), torch.full((2,), np.inf), **kw)
    if case == "masked_feature":
        fm[int(torch.argmax(rel[0]))] = False
    got = tsplit.find_best_split_categorical(
        t(hist), t(tot[:, 0]), t(tot[:, 1]), t(tot[:, 2]), t(nb), t(mt),
        t(fm), torch.full((2,), -np.inf), torch.full((2,), np.inf), **kw)
    assert got.left_mask.any(dim=1).all()
    for i in range(2):
        want = jsplit.find_best_split_categorical(
            jnp.asarray(hist[i]), tot[i, 0], tot[i, 1], tot[i, 2],
            jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(fm),
            jnp.float32(-np.inf), jnp.float32(np.inf), num_bins=64, **kw)
        assert int(got.feature[i]) == int(want.feature)
        np.testing.assert_array_equal(got.left_mask[i].numpy(),
                                      np.asarray(want.left_mask))
        for name in ("gain", "left_sum_grad", "left_sum_hess", "left_count",
                     "right_sum_grad", "right_sum_hess", "right_count",
                     "left_output", "right_output"):
            np.testing.assert_allclose(
                float(getattr(got, name)[i]), float(getattr(want, name)),
                rtol=2e-5, atol=1e-5, err_msg=name)
    use_onehot, _, _, use_fwd = aux[:4]
    if case == "onehot":
        assert bool(use_onehot.all())
    elif case == "sorted":
        # both walk directions win some feature of some leaf
        sorted_f = ~use_onehot
        assert bool(use_fwd[:, sorted_f].any()) \
            and bool((~use_fwd[:, sorted_f]).any())


def test_bitset_words_round_trip():
    r = np.random.RandomState(3)
    m = torch.from_numpy(r.rand(4, 40) > 0.5)
    w = mask_to_words(m, 2)
    assert w.dtype == torch.int32 and w.shape == (4, 2)
    assert torch.equal(words_to_mask(w, 40), m)
    m[:, 31] = True                     # the sign bit of word 0
    assert torch.equal(words_to_mask(mask_to_words(m, 2), 40), m)


# ---- (c) split records -----------------------------------------------------

def _grads(x, margin, dyadic, seed=7):
    r = np.random.RandomState(seed)
    g = (margin - margin.mean() + 0.3 * r.randn(len(x))).astype(np.float32)
    h = (0.1 + r.rand(len(x))).astype(np.float32)
    if dyadic:
        g = (np.round(np.clip(g, -4, 4) * 16) / 16).astype(np.float32)
        h = (np.round(h * 16 + 1) / 16).astype(np.float32)
    return g, h


def _masks(words, k, b):
    return words_to_mask(torch.as_tensor(np.asarray(words)), b)[:k].numpy()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_split_records_match_jax(strategy, quant):
    x, _, margin = _cat_task()
    g, h = _grads(x, margin, dyadic=not quant)
    params = dict(BASE, objective="binary", categorical_feature=[0, 1],
                  quantized_grad=quant, grad_bits=8)
    n = len(x)
    jds = JDataset(x, config=JConfig(params), label=np.zeros(n))
    tds = TDataset(x, config=TConfig(params), label=np.zeros(n))
    jl = jdl.DeviceTreeLearner(JConfig(params), jds, strategy=strategy)
    jrec, jcat, jleaf, jk, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jnp.ones(n, jnp.float32),
        jnp.ones(jds.num_features, bool), jax.random.PRNGKey(3))
    jrec, jcat, jk = np.asarray(jrec), np.asarray(jcat), int(jk)
    tl = tdl.DeviceTreeLearner(TConfig(params), tds, strategy=strategy,
                               device="cpu")
    assert tl.has_cat and tl.cat_words == 2
    trec, tleaf, tk = tl.grow(torch.from_numpy(g), torch.from_numpy(h),
                              iter_seed=3)
    tcat = tl.last_rec_cat
    assert tk == jk and tk > 8
    cat_rows = tds.feature_meta_arrays()[3][trec[:tk, tdl.R_FEAT]
                                            .astype(int)] == 1
    assert cat_rows.sum() >= 3 and (~cat_rows).sum() >= 2
    ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR, tdl.R_LCNT, tdl.R_RCNT]
    np.testing.assert_array_equal(trec[:tk, ints], jrec[:jk, ints])
    np.testing.assert_array_equal(_masks(tcat, tk, jcat.shape[1]),
                                  jcat[:jk] > 0.5)
    floats = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_RSG, tdl.R_RSH,
              tdl.R_LOUT, tdl.R_ROUT]
    np.testing.assert_allclose(trec[:tk, floats], jrec[:jk, floats],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))

    # the host loop (the oracle) grows the device loop's tree exactly
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    if strategy == "masked":
        gh, scale3 = tl.masked_operand(gt, ht, 3)
        hrec, hleaf, hk, hcat = tdl.grow_tree(
            tl.codes_t, gh, tl._ones_mask, tl.meta, scale3=scale3,
            **tl._statics())
    else:
        quant_rows = None
        if quant:
            data, quant_rows = tl.quant_working_buffer(
                gt, ht, tdl.trandom.prng_key(3))
        else:
            data = tl.working_buffer(gt, ht)
        hrec, hleaf, hk, hcat = tdl.grow_tree_compact_core(
            data, torch.empty_like(data), tl._ones_mask, tl.meta,
            c_cols=tl.c_cols, item_bits=tl.item_bits, quant=quant_rows,
            **tl._statics())
    assert hk == tk
    np.testing.assert_array_equal(hrec, trec)
    np.testing.assert_array_equal(hcat, tcat)
    assert torch.equal(hleaf, tleaf)

    # the replayed trees: the same bitset nodes
    ttree = tl.replay_tree(trec, tk, tcat)
    jtree = jl.replay_tree(jrec, jk, jcat)
    for key in ("cat_boundaries", "cat_threshold", "cat_boundaries_inner",
                "cat_threshold_inner"):
        assert getattr(ttree, key) == getattr(jtree, key), key


def _jax_cat_inputs(seed, cw=3, item_bits=8, f=6, L=31):
    r = np.random.RandomState(seed)
    per = 32 // item_bits
    rows = r.randint(0, 2**31, size=(2001, cw), dtype=np.int64) \
        .astype(np.int32)
    f_col = r.randint(0, cw * per, f).astype(np.int32)
    f_elide = (np.arange(f) % 3 == 0).astype(np.int32)
    f_numbins = r.randint(3, 64, f).astype(np.int32)
    f_base = np.where(f_elide == 1, r.randint(0, 100, f), 0).astype(np.int32)
    f_missing = (np.arange(f) % 3).astype(np.int32)
    f_default = (r.randint(0, 100, f) % f_numbins).astype(np.int32)
    f_cat = (np.arange(f) % 2).astype(np.int32)
    rec = np.zeros((L - 1, 13), np.float32)
    feats = r.randint(0, f, L - 1)
    rec[:, tdl.R_LEAF] = [r.randint(0, i + 1) for i in range(L - 1)]
    rec[:, tdl.R_FEAT] = feats
    rec[:, tdl.R_THR] = np.where(f_cat[feats] == 1, 0,
                                 r.randint(0, f_numbins[feats]))
    rec[:, tdl.R_DLEFT] = r.randint(0, 2, L - 1)
    masks = (r.rand(L - 1, 64) < 0.5) & (f_cat[feats] == 1)[:, None]
    # the JAX lookup clips a bin past the mask to its last bin, the port's
    # sends it right: no feature of a learner has such bins, and with the
    # last bit clear the two agree on these random codes
    masks[:, -1] = False
    meta = (f_numbins, f_missing, f_default, f_col, f_base, f_elide)
    return rows, meta, f_cat, rec, masks


def test_split_key_and_router_plain_decode_categorical_as_jax():
    """The split key's plain packed and column entries and the router's
    with categorical descriptors / records, bit for bit against the JAX
    packed_go_left and route_rows_by_rec with cat_mask / rec_cat."""
    rows, meta, f_cat, rec, masks = _jax_cat_inputs(11)
    nb, mt, db, col, base, elide = meta
    jmeta = [jnp.asarray(a) for a in meta]
    words = mask_to_words(torch.from_numpy(masks), 2)
    jwin = jnp.asarray(rows.view(np.uint32))
    trows = torch.from_numpy(rows)
    for i in range(8):
        f = int(rec[i, tdl.R_FEAT])
        desc = torch.zeros(dsc.size(2), dtype=torch.int32)
        desc[[dsc.GO, dsc.COUNT, dsc.THR, dsc.DLEFT]] = torch.tensor(
            [1, len(rows), int(rec[i, tdl.R_THR]), int(rec[i, tdl.R_DLEFT])],
            dtype=torch.int32)
        desc[dsc.COL:dsc.DEFAULT + 1] = torch.tensor(
            [col[f], base[f], elide[f], nb[f], mt[f], db[f]])
        desc[dsc.CAT] = int(f_cat[f])
        desc[dsc.WORDS:] = words[i]
        want = np.asarray(jdl.packed_go_left(
            jwin, f, int(rec[i, tdl.R_THR]), rec[i, tdl.R_DLEFT] > 0.5,
            *jmeta, item_bits=8, f_categorical=jnp.asarray(f_cat),
            cat_mask=jnp.asarray(masks[i].astype(np.float32))))
        key = torch.full((len(rows),), -1, dtype=torch.int32)
        kkey.split_key(trows, trows, desc, key, item_bits=8, cw=0,
                       renew=False)
        np.testing.assert_array_equal(key.numpy(), np.where(want, 0, 1))
        assert int(desc[dsc.LPHYS]) == int(want.sum())
        # the column entry over the same feature's column of codes
        codes = ((rows[:, col[f] // 4].view(np.uint32) >> (8 * (col[f] % 4)))
                 & 255).astype(np.uint8)
        codes_t = torch.from_numpy(np.tile(codes, (max(col) + 1, 1)))
        cdesc = desc.clone()
        cdesc[dsc.COL], cdesc[dsc.LEAF], cdesc[dsc.NEW_ID] = f % 2, 0, 5
        leaf = torch.zeros(len(rows), dtype=torch.int32)
        gh = torch.ones((len(rows), 3))
        ghl = torch.empty_like(gh)
        kkey.split_key_column(codes_t[:, :], cdesc, leaf, gh, ghl)
        np.testing.assert_array_equal(leaf.numpy(), np.where(want, 0, 5))
        np.testing.assert_array_equal(ghl[:, 0].numpy(), want.astype(float))
    for k in (0, 7, 30):
        want = jdl.route_rows_by_rec(
            jwin, jnp.asarray(rec), jnp.int32(k), *jmeta, item_bits=8,
            num_leaves=31, rec_cat=jnp.asarray(masks.astype(np.float32)),
            f_categorical=jnp.asarray(f_cat))
        got = kkey.route_rows(
            trows, torch.from_numpy(rec), torch.tensor(k, dtype=torch.int32),
            torch.from_numpy(np.stack([col, base, elide, nb, mt, db], 1)),
            item_bits=8, rec_cat=words, f_cat=torch.from_numpy(f_cat))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- (d) train() end to end, (e) model text --------------------------------

def _dyadic_fobj(preds, ds):
    """Binary-logloss gradients rounded to multiples of 1/64 and a
    constant hessian: every histogram sum exact in both packages."""
    y = ds.get_label()
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, dtype=np.float64)))
    g = np.round((p - y) * 64) / 64
    return g.astype(np.float32), np.full(len(y), 0.25, np.float32)


def _raw_probe(x):
    """x with unseen, negative, NaN and fractional categories."""
    xt = x.copy()
    xt[:6, 1] = [45, -3, np.nan, 2.7, 1e12, -0.5]
    xt[6:9, 0] = [7, -1, np.nan]
    return xt


TEXT_KEYS = ("num_leaves", "num_cat", "split_feature", "decision_type",
             "left_child", "right_child", "cat_boundaries", "cat_threshold",
             "leaf_count")


def _text_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(TEXT_KEYS)]


@pytest.mark.parametrize("case", ["compact", "masked-valid",
                                  "compact-bagging"])
def test_train_custom_objective_matches_jax(case, monkeypatch):
    strategy = case.split("-")[0]
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y, _ = _cat_task()
    xv, yv, _ = _cat_task(n=1000, seed=9)
    params = dict(BASE)
    if case.endswith("bagging"):
        params.update(bagging_fraction=0.8, bagging_freq=1)
    kw = {}
    tds = tlgb.Dataset(x, y, categorical_feature=[0, 1])
    if case.endswith("valid"):
        kw = dict(valid_sets=[tds.create_valid(xv, yv)], valid_names=["v"])
    jb = jlgb.train(dict(params), jlgb.Dataset(x, y, categorical_feature=[
        0, 1]), 8, fobj=_dyadic_fobj)
    tb = tlgb.train(dict(params), tds, 8, fobj=_dyadic_fobj, device="cpu",
                    **kw)
    assert tb._gbdt.learner.strategy == strategy
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert "cat_threshold" in tt
    assert _text_lines(tt) == _text_lines(jt)
    for xs in (x, _raw_probe(x), xv):
        np.testing.assert_allclose(tb.predict(xs, raw_score=True),
                                   jb.predict(xs, raw_score=True),
                                   rtol=0, atol=1e-5)
    if kw:
        # the validation set's binned walk gives predict's scores
        np.testing.assert_allclose(
            tb._gbdt.valid_updaters[0].score[0].numpy(),
            tb.predict(xv, raw_score=True), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["compact", "masked", "compact-bagging",
                                  "compact-goss", "masked-goss-quantized"])
def test_fused_binary_training_scores_match(case, monkeypatch):
    strategy = case.split("-")[0]
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y, _ = _cat_task()
    params = dict(BASE, objective="binary")
    if case.endswith("bagging"):
        params.update(bagging_fraction=0.8, bagging_freq=1)
    if "goss" in case:
        # GOSS samples from the third iteration on (1 / learning_rate)
        params.update(boosting="goss", learning_rate=0.5,
                      quantized_grad=case.endswith("quantized"))
    tb = tlgb.train(dict(params), tlgb.Dataset(x, y, categorical_feature=[
        0, 1]), 8, device="cpu")
    gb = tb._gbdt
    assert gb._fused_step is not None and gb.learner.strategy == strategy
    assert any(t.num_cat for t in gb.models)
    # the fused step's scores (the router's leaves for out-of-bag rows)
    # are predict's
    own = tb.predict(x, raw_score=True)
    np.testing.assert_allclose(gb.score_updater.score[0].numpy(), own,
                               rtol=0, atol=1e-5)
    if case in ("compact", "masked"):
        jb = jlgb.train(dict(params), jlgb.Dataset(
            x, y, categorical_feature=[0, 1]), 8)
        np.testing.assert_allclose(own, jb.predict(x, raw_score=True),
                                   rtol=0, atol=1e-5)


def test_model_text_crosses_packages():
    x, y, _ = _cat_task()
    xt = _raw_probe(x)
    params = dict(BASE, objective="binary")
    jb = jlgb.train(dict(params), jlgb.Dataset(
        x, y, categorical_feature=[0, 1]), 6)
    tb = tlgb.train(dict(params), tlgb.Dataset(
        x, y, categorical_feature=[0, 1]), 6, device="cpu")
    jtext, ttext = jb.model_to_string(), tb.model_to_string()
    back = convert.booster_from_model_string(jtext, device="cpu")
    np.testing.assert_allclose(back.predict(xt, raw_score=True),
                               jb.predict(xt, raw_score=True), rtol=0,
                               atol=1e-6)
    jback = jlgb.Booster(model_str=ttext)
    np.testing.assert_allclose(jback.predict(xt, raw_score=True),
                               tb.predict(xt, raw_score=True), rtol=0,
                               atol=1e-6)
    # re-binning a loaded tree's bitsets onto a dataset's bins
    tds = tlgb.Dataset(x, y, categorical_feature=[0, 1]).construct()._inner
    jds = jlgb.Dataset(x, y, categorical_feature=[0, 1]).construct()._inner
    for block in jtext.split("Tree=")[1:3]:
        body = "Tree=" + block.split("\n\n")[0]
        tt, jt = TTree.from_string(body), JTree.from_string(body)
        tt.rebin_inner(tds)
        jt.rebin_inner(jds)
        assert tt.cat_threshold_inner == jt.cat_threshold_inner
        assert tt.cat_boundaries_inner == jt.cat_boundaries_inner


# ---- the surface -----------------------------------------------------------

@pytest.mark.parametrize("how", ["indices", "names", "name:", "params",
                                 "train", "cv"])
def test_categorical_feature_is_taken(how):
    x, y, _ = _cat_task(n=1500)
    names = ["small", "big", "n0", "n1"]
    params = dict(BASE, objective="binary", num_leaves=7)
    ds_kw = {"feature_name": names}
    spec = {"indices": [0, 1], "names": ["small", "big"],
            "name:": ["name:small", "name:big"], "train": ["small", "big"],
            "cv": [0, 1]}.get(how)
    if how == "params":
        params["categorical_feature"] = "0,1"
    elif how not in ("train", "cv"):
        ds_kw["categorical_feature"] = spec
    ds = tlgb.Dataset(x, y, **ds_kw)
    if how == "cv":
        res = tlgb.cv(params, ds, 3, nfold=3, metrics=["auc"],
                      categorical_feature=spec, device="cpu")
        assert len(res["auc-mean"]) == 3
    else:
        tlgb.train(params, ds, 3, device="cpu",
                   **({"categorical_feature": spec} if how == "train"
                      else {}))
    mappers = ds._inner.bin_mappers
    assert [m.bin_type for m in mappers] \
        == [BIN_CATEGORICAL, BIN_CATEGORICAL, 0, 0]
