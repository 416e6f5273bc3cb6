"""The compact core's device loop and the fused boosting iteration, on the
CPU, against the port's host loop and against the JAX package.

The device loop (``DeviceTreeLearner.grow_compact``: one split step, run
num_leaves - 1 times with every write gated) runs here eagerly through
the kernels' plain versions (the masked core's device loop has its own
tests in test_torch_masked.py). It must give the host loop's
(``grow_tree_compact_core``) records and row -> leaf map exactly, float
and quantized, also for a tree that stops early (a large
min_gain_to_split), where the gated steps after the stop must change
nothing. The split-key kernel's plain version is held bit for bit against
the JAX package's window decode (``packed_go_left``, ``decide_left``,
``_quant_side_maxes``), ``leaf_values_from_rec`` against the JAX replay,
and ten rounds of ``train`` on the fused iteration, on either strategy,
against ``lightgbm_tpu.train`` (whose binary path is fused too) within the
bounds of test_torch_engine.py. n = 3000, num_leaves = 15, as in
test_torch_learner.py.
"""
import os
import re
import weakref

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
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.models import device_learner as tdl
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import fused
from lightgbm_tpu_torch.ops import quantize as quant_ops
from lightgbm_tpu_torch.ops.kernels import build
from lightgbm_tpu_torch.ops.kernels import desc as dsc
from lightgbm_tpu_torch.ops.kernels import split_key as kkey
from test_torch_engine import _assert_same_splits, _params, _task
from test_torch_learner import _data

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "min_gain_to_split": 1e-3, "verbosity": -1, "max_bin": 63}
CASES = {
    "dense63": ("dense", {}),
    "nibble15": ("dense", {"max_bin": 15, "lambda_l2": 1.0}),
    "monotone": ("dense", {"max_delta_step": 0.4,
                           "monotone_constraints": [1, -1, 0, 0, 0, 0]}),
    "bundled": ("bundled", {"lambda_l1": 0.1, "max_depth": 4}),
    "stops_early": ("dense", {"min_gain_to_split": 20.0}),
    "quant8": ("dense", {"quantized_grad": True, "grad_bits": 8}),
    "quant16": ("dense", {"quantized_grad": True, "grad_bits": 16}),
    "quant8_no_renew": ("dense", {"quantized_grad": True, "grad_bits": 8,
                                  "quant_renew": False}),
    "quant16_no_renew": ("dense", {"quantized_grad": True, "grad_bits": 16,
                                   "quant_renew": False}),
    "quant8_nibble_stops_early": ("dense", {
        "quantized_grad": True, "grad_bits": 8, "max_bin": 15,
        "min_gain_to_split": 20.0}),
}


def _learner(kind, extra):
    x, g, h = _data(kind)
    cfg = TConfig(dict(BASE, **extra))
    ds = TDataset(x, config=cfg, label=np.zeros(len(x)))
    tl = tdl.DeviceTreeLearner(cfg, ds, strategy="compact", device="cpu")
    return x, tl, torch.from_numpy(g), torch.from_numpy(h)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_loop_equals_host_loop(case):
    x, tl, g, h = _learner(*CASES[case])
    for seed in (3, 4):
        rec, leaf, k = tl.grow(g, h, iter_seed=seed)
        quant = None
        if tl.quant_bits:
            data, quant = tl.quant_working_buffer(
                g, h, tdl.trandom.prng_key(seed))
        else:
            data = tl.working_buffer(g, h)
        hrec, hleaf, hk = tdl.grow_tree_compact_core(
            data, torch.empty_like(data), tl._ones_mask, tl.meta,
            c_cols=tl.c_cols, item_bits=tl.item_bits, quant=quant,
            **tl._statics())
        assert k == hk and k > 3
        if "stops_early" in case:
            assert k < 14
            assert not rec[k:].any()           # nothing written after
        np.testing.assert_array_equal(rec, hrec)
        assert torch.equal(leaf, hleaf)
    assert tl.stats.host_syncs == 2            # one fetch per tree


@pytest.mark.parametrize("case", ["dense63", "bundled"])
def test_device_loop_matches_jax(case):
    # the bounds of test_torch_learner.py (the JAX histogram sums a bf16
    # hi / lo split): integer columns and row -> leaf map equal, floats
    # within 1e-4
    kind, extra = CASES[case]
    x, g, h = _data(kind)
    params = dict(BASE, **extra)
    jcfg = JConfig(params)
    jds = JDataset(x, config=jcfg, label=np.zeros(len(x)))
    jl = jdl.DeviceTreeLearner(jcfg, jds, strategy="compact")
    jl._ones_w = jnp.ones(len(x), jnp.float32)
    jrec, _, jleaf, jk, _ = jl._run_grow(
        jnp.asarray(g), jnp.asarray(h), jl._ones_w,
        jnp.ones(jds.num_features, bool), jax.random.PRNGKey(0))
    _, tl, tg, th = _learner(kind, extra)
    trec, tleaf, tk = tl.grow(tg, th, iter_seed=0)
    jrec, jk = np.asarray(jrec), int(jk)
    assert tk == jk and tk > 3
    ints = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR]
    np.testing.assert_array_equal(trec[:tk, ints], jrec[:jk, ints])
    floats = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_LCNT, tdl.R_RSG,
              tdl.R_RSH, tdl.R_RCNT, tdl.R_LOUT, tdl.R_ROUT]
    np.testing.assert_allclose(trec[:tk, floats], jrec[:jk, floats],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


def _window(item_bits, seed, n=4000, d=9):
    """Random packed rows (codes in words [0, 7), a (qg|qh) word at 7)."""
    r = np.random.RandomState(seed)
    win = r.randint(-2**31, 2**31, size=(n, d), dtype=np.int64) \
        .astype(np.int32)
    q = r.randint(-32767, 32768, size=(n, 2))
    win[:, 7] = quant_ops.pack_gh(torch.from_numpy(q[:, 0]),
                                  torch.from_numpy(q[:, 1])).numpy()
    return win


@pytest.mark.parametrize("item_bits", [4, 8])
def test_split_key_plain_matches_jax(item_bits):
    # features of one EFB bundle column and plain columns, each missing
    # type; the window lies inside the spare buffer (SRC = 1)
    per = 32 // item_bits
    nb = 1 << item_bits
    data = torch.from_numpy(_window(item_bits, 1))
    spare = torch.from_numpy(_window(item_bits, item_bits))
    r = np.random.RandomState(item_bits)
    f = 12
    f_col = r.randint(0, 7 * per, f).astype(np.int32)
    f_elide = (np.arange(f) % 3 == 0).astype(np.int32)
    f_numbins = r.randint(3, nb // 2, f).astype(np.int32)
    f_base = np.where(f_elide == 1, r.randint(0, nb // 2, f), 0) \
        .astype(np.int32)
    f_missing = (np.arange(f) % 3).astype(np.int32)
    f_default = (r.randint(0, 100, f) % f_numbins).astype(np.int32)
    jmeta = [jnp.asarray(a) for a in (f_numbins, f_missing, f_default,
                                      f_col, f_base, f_elide)]
    begin, count = 123, 3001
    jwin = jnp.asarray(spare.numpy()[begin:begin + count].view(np.uint32))
    for feat in range(f):
        thr = int(r.randint(0, f_numbins[feat]))
        dleft = int(feat % 2)
        desc = torch.tensor([1, 1, begin, count, 0, 0, thr, dleft,
                             f_col[feat], f_base[feat], f_elide[feat],
                             f_numbins[feat], f_missing[feat],
                             f_default[feat], 0, 0, 0, 0, 0, 0, 0],
                            dtype=torch.int32)
        assert desc.shape == (dsc.SIZE,)
        key = torch.full((len(data),), -1, dtype=torch.int32)
        kkey.split_key(data, spare, desc, key, item_bits=item_bits, cw=7,
                       renew=True)
        go_left = jdl.packed_go_left(jwin, feat, thr, dleft > 0, *jmeta,
                                     item_bits=item_bits)
        want = np.where(np.asarray(go_left), 0, 1).astype(np.int32)
        np.testing.assert_array_equal(key[:count].numpy(), want)
        assert (key[count:] == -1).all()
        assert int(desc[dsc.LPHYS]) == int(np.asarray(go_left).sum())
        maxes = jdl._quant_side_maxes(jwin, go_left, jnp.ones(count, bool),
                                      cw=7, gw=1)
        np.testing.assert_array_equal(
            desc[dsc.SIDE_MAX:dsc.LEAF].numpy().astype(np.float32),
            np.asarray(maxes).reshape(-1))
    # GO = 0 changes nothing
    desc[dsc.GO] = 0
    before = (desc.clone(), key.clone())
    kkey.split_key(data, spare, desc, key, item_bits=item_bits, cw=7,
                   renew=True)
    assert torch.equal(desc, before[0]) and torch.equal(key, before[1])


def test_leaf_values_from_rec_matches_jax():
    # records of real trees (one that stops early), of a tree cut after a
    # few splits (k < the records written), and of no split at all
    for case in ("dense63", "stops_early"):
        _, tl, g, h = _learner(*CASES[case])
        rec, _, k = tl.grow(g, h, iter_seed=3)
        for kk in (k, 3, 1, 0):
            got = fused.leaf_values_from_rec(
                torch.from_numpy(rec), torch.tensor(kk, dtype=torch.int32),
                15)
            want = jdl.leaf_values_from_rec(jnp.asarray(rec),
                                            jnp.int32(kk), 15)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fused_against_jax(strategy, grow_program, monkeypatch):
    # ten rounds on the fused iteration, against the JAX package's fused
    # binary path: the same split structure, raw scores within 1e-4
    monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
    x, y = _task("binary")
    params = dict(_params("binary"), grow_program=grow_program)
    jb = jlgb.train(params, jlgb.Dataset(x, y), num_boost_round=10,
                    verbose_eval=False)
    tb = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=10,
                    device="cpu")
    gb = tb._gbdt
    assert gb.learner.strategy == jb._gbdt.learner.strategy == strategy
    assert gb._fused_eligible() and gb._fused_step is not None
    assert gb.learner.stats.host_syncs == gb.learner.stats.trees == 10
    assert tb.num_trees() == jb.num_trees() == 10
    _assert_same_splits(gb.models, jb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grow_program", ["per_split", "fused_tree"])
def test_fused_train_matches_jax(grow_program, monkeypatch):
    _fused_against_jax("compact", grow_program, monkeypatch)


@pytest.mark.parametrize("grow_program", ["per_split", "fused_tree"])
def test_fused_masked_train_matches_jax(grow_program, monkeypatch):
    # the masked strategy's device loop under the fused iteration (the JAX
    # package's fused step covers the masked core too)
    _fused_against_jax("masked", grow_program, monkeypatch)


def test_fused_first_iteration_without_split(monkeypatch):
    # no split at the first iteration: the generic iteration takes over and
    # leaves the boost-from-average constant tree; the fused attempt
    # committed nothing, so on either strategy the model and the training
    # scores are those of a run on the generic iteration alone
    x, y = _task("binary", n=600)
    params = dict(_params("binary"), min_gain_to_split=1e6)
    for strategy in ("compact", "masked"):
        monkeypatch.setenv("LGBM_TPU_STRATEGY", strategy)
        fused = tlgb.train(params, tlgb.Dataset(x, y), num_boost_round=3,
                           device="cpu")
        with monkeypatch.context() as m:
            m.setattr(GBDT, "_fused_eligible",
                      lambda self: False)
            generic = tlgb.train(params, tlgb.Dataset(x, y),
                                 num_boost_round=3, device="cpu")
        fb, gb = fused._gbdt, generic._gbdt
        assert fb.learner.strategy == strategy
        assert fb._fused_step is not None and gb._fused_step is None
        assert fb.num_trees() == gb.num_trees() == 1
        assert fb.models[0].num_leaves == 1
        assert torch.equal(fb.score_updater.score, gb.score_updater.score)
        np.testing.assert_allclose(fused.predict(x, raw_score=True),
                                   fb.objective.boost_from_score(0),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("source", ["split_key", "partition", "histogram"])
def test_descriptor_fields_match_the_sources(source):
    # the CUDA sources repeat the descriptor's field numbers they read
    with open(os.path.join(build.CSRC, source + ".cu")) as fh:
        found = re.findall(r"constexpr int kDesc(\w+) = (\d+);", fh.read())
    names = {"Go": "GO", "Src": "SRC", "Begin": "BEGIN", "Count": "COUNT",
             "Lphys": "LPHYS", "LeftSmall": "LEFT_SMALL", "Thr": "THR",
             "Dleft": "DLEFT", "Col": "COL", "Base": "BASE",
             "Elide": "ELIDE", "NumBins": "NUMBINS", "Missing": "MISSING",
             "Default": "DEFAULT", "SideMax": "SIDE_MAX", "Leaf": "LEAF",
             "NewId": "NEW_ID", "Cat": "CAT", "Words": "WORDS"}
    assert len(found) >= 4
    for name, value in found:
        assert getattr(dsc, names[name]) == int(value), name


@pytest.mark.parametrize("strategy", ["compact", "masked"])
def test_dropped_learner_is_freed_at_once(strategy):
    # the split loop's step holds no reference to its learner, so a
    # dropped learner (and on the card its CUDA graph) is freed by
    # reference counting, never later by the cyclic collector while
    # another learner captures its step
    _, tl, g, h = _learner(*CASES["dense63"])
    if strategy == "masked":
        tl = tdl.DeviceTreeLearner(tl.config, tl.dataset, strategy="masked",
                                   device="cpu")
    tl.grow(g, h)
    assert tl._loop is not None
    gone = weakref.ref(tl)
    del tl
    assert gone() is None
