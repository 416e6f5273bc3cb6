"""The port's masked strategy vs the JAX package's, split record by split
record, with float and with quantized gradients, and its device loop vs
its host loop.

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

``grow`` runs the masked core's device loop (``grow_masked``: one gated
split step, num_leaves - 1 times, eager here); it must give the host
loop's (``grow_tree``) records and row -> leaf map exactly. The split
key's column entry (``split_key_column_plain``) is held bit for bit
against the JAX body's decode and row update.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import bundle as jbundle
from lightgbm_tpu.ops.partition import decide_left as jdecide_left
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import \
    DeviceTreeLearner as JLearner
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.ops.kernels import desc as dsc
from lightgbm_tpu_torch.ops.kernels import histogram as khist
from lightgbm_tpu_torch.ops.kernels import partition as kpart
from lightgbm_tpu_torch.ops.kernels import split_key as kkey
from test_torch_learner import _data as _learner_data

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


def grow_both(params, strategy, seed=3, n=3000, data=None):
    """(jrec, jleaf, jk, trec, tleaf, tk, port learner) for one tree, on
    `data` (x, g, h) or _data(n=n)."""
    x, g, h = data or _data(n=n)
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
    assert tdl.resolve_strategy(cfg, ds) == "chunk"
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "sideways")
    with pytest.raises(tdl.LightGBMError, match="sideways"):
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
    # the device loop: one fetch for the whole tree
    assert (tl.stats.host_syncs, tl.stats.splits, tl.stats.trees) \
        == (1, 6, 1)
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


def test_masked_bundled_matches_jax():
    # EFB bundle columns: the split key's column entry unmaps the
    # members' logical bins
    jrec, jleaf, jk, trec, tleaf, tk, tl = grow_both(
        {"lambda_l1": 0.1, "max_depth": 4}, "masked",
        data=_learner_data("bundled"))
    assert tl.meta["f_elide"].any()
    assert tk == jk and tk > 3
    np.testing.assert_array_equal(trec[:tk, INTS], jrec[:jk, INTS])
    np.testing.assert_allclose(trec[:tk, FLOATS], jrec[:jk, FLOATS],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tleaf, jleaf)


DEVICE_LOOP_CASES = {
    "float": ("dense", {}),
    "quant8": ("dense", {"quantized_grad": True, "grad_bits": 8}),
    "quant16": ("dense", {"quantized_grad": True, "grad_bits": 16}),
    "codes16": ("dense", {"max_bin": 400, "min_data_in_bin": 1}),
    "bundled": ("bundled", {"lambda_l1": 0.1, "max_depth": 4}),
    "stops_early": ("dense", {"min_gain_to_split": 20.0}),
    "quant8_stops_early": ("dense", {"quantized_grad": True,
                                     "grad_bits": 8,
                                     "min_gain_to_split": 20.0}),
}


@pytest.mark.parametrize("case", sorted(DEVICE_LOOP_CASES))
def test_device_loop_equals_host_loop(case):
    # the device loop (eager here) against the host loop from the same
    # operand: records and row -> leaf map equal; a stopped tree's gated
    # steps write nothing; one fetch per tree
    kind, extra = DEVICE_LOOP_CASES[case]
    x, g, h = _learner_data(kind)
    cfg = TConfig(dict({"objective": "binary", "num_leaves": 15,
                        "max_bin": 63, "min_data_in_leaf": 20,
                        "min_gain_to_split": 1e-3, "verbosity": -1},
                       **extra))
    tl = tdl.DeviceTreeLearner(cfg, TDataset(x, config=cfg,
                                             label=np.zeros(len(x))),
                               strategy="masked", device="cpu")
    if case == "codes16":
        assert tl.codes_t.dtype == torch.int16
    if case == "bundled":
        assert tl.meta["f_elide"].any()
    g, h = torch.from_numpy(g), torch.from_numpy(h)
    for seed in (3, 4):
        rec, leaf, k = tl.grow(g, h, iter_seed=seed)
        gh, scale3 = tl.masked_operand(g, h, seed)
        hrec, hleaf, hk = tdl.grow_tree(tl.codes_t, gh, tl._ones_mask,
                                        tl.meta, scale3=scale3,
                                        **tl._statics())
        assert k == hk and k > 3
        if "stops_early" in case:
            assert k < 14
            assert not rec[k:].any()           # nothing written after
        np.testing.assert_array_equal(rec, hrec)
        assert torch.equal(leaf, hleaf)
    assert tl.stats.host_syncs == 2            # one fetch per tree


def test_fetch_tree_counts_k4_rows_on_compact_only():
    # K4's window rows come from the records of a compact tree; a masked
    # tree runs no K4 and leaves the count as it was
    x, g, h = _data()
    cfg = TConfig({"objective": "binary", "num_leaves": 7,
                   "verbosity": -1})
    ds = TDataset(x, config=cfg, label=np.zeros(len(x)))
    g, h = torch.from_numpy(g), torch.from_numpy(h)
    for strategy in ("compact", "masked"):
        tl = tdl.DeviceTreeLearner(cfg, ds, strategy=strategy, device="cpu")
        before = kpart.rows_win
        rec, _, k = tl.grow(g, h)
        moved = int(rec[:k, tdl.R_LCNT].sum() + rec[:k, tdl.R_RCNT].sum())
        assert k == 6
        assert kpart.rows_win - before == (moved if strategy == "compact"
                                           else 0)


def _column_desc(feat_row, thr, dleft, leaf, new_id, go=1):
    d = torch.zeros(dsc.SIZE, dtype=torch.int32)
    d[dsc.GO], d[dsc.THR], d[dsc.DLEFT] = go, thr, dleft
    d[dsc.COL:dsc.COL + 6] = torch.as_tensor(feat_row)
    d[dsc.LEAF], d[dsc.NEW_ID] = leaf, new_id
    return d


@pytest.mark.parametrize("op", ["f32", "int8", "int32"])
@pytest.mark.parametrize("code_bits", [8, 16])
def test_split_key_column_plain_matches_jax(code_bits, op):
    # features of EFB bundle columns and plain columns, each missing type,
    # over (C, N) codes (16-bit codes above 32767 ride as negative int16);
    # against the JAX body's decode and update (device_learner.py:402-419)
    r = np.random.RandomState(code_bits)
    n, c, f = 2003, 5, 12
    top = 256 if code_bits == 8 else 40_000
    codes = r.randint(0, top, size=(c, n))
    codes_t = torch.from_numpy(codes.astype(np.uint8)) if code_bits == 8 \
        else torch.from_numpy(codes.astype(np.uint16).view(np.int16))
    f_col = r.randint(0, c, f)
    f_elide = (np.arange(f) % 3 == 0).astype(np.int32)
    f_numbins = r.randint(3, min(top, 1000), f)
    f_base = np.where(f_elide == 1, r.randint(0, top // 2, f), 0)
    f_missing = np.arange(f) % 3
    f_default = r.randint(0, 1000, f) % f_numbins
    table = np.stack([f_col, f_base, f_elide, f_numbins, f_missing,
                      f_default], axis=1)
    leaf0 = r.randint(0, 4, n).astype(np.int32)
    if op == "f32":
        gh = r.randn(n, 3).astype(np.float32)
    else:
        gh = r.randint(-127, 128, (n, 3)).astype(
            np.int8 if op == "int8" else np.int32)
    for feat in range(f):
        thr, dleft = int(r.randint(0, f_numbins[feat])), feat % 2
        leaf, new_id = feat % 4, 4 + feat
        desc = _column_desc(table[feat], thr, dleft, leaf, new_id)
        leaf_id = torch.from_numpy(leaf0.copy())
        ghl = torch.full((n, 3), 7, dtype=torch.from_numpy(gh).dtype)
        kkey.split_key_column(codes_t, desc, leaf_id, torch.from_numpy(gh),
                              ghl)
        col = jnp.asarray(codes[f_col[feat]].astype(np.int32))
        fbins = jbundle.logical_bins_for_feature(
            col, int(f_base[feat]), int(f_default[feat]),
            int(f_numbins[feat]), int(f_elide[feat]))
        go_left = np.asarray(jdecide_left(
            fbins, thr, dleft > 0, int(f_missing[feat]),
            int(f_default[feat]), int(f_numbins[feat])))
        parent = leaf0 == leaf
        np.testing.assert_array_equal(
            leaf_id.numpy(), np.where(parent & ~go_left, new_id, leaf0))
        np.testing.assert_array_equal(
            ghl.numpy(), gh * (parent & go_left)[:, None].astype(gh.dtype))
    # GO = 0 changes nothing
    desc[dsc.GO] = 0
    before = (leaf_id.clone(), ghl.clone())
    kkey.split_key_column(codes_t, desc, leaf_id, torch.from_numpy(gh), ghl)
    assert torch.equal(leaf_id, before[0]) and torch.equal(ghl, before[1])
