"""Quantized gradients on the port's data-parallel learner across two
processes, on the CPU.

Two gloo ranks run tests/torch_dp_modes_worker.py (kind ``quant``); the
JAX DeviceDataParallelTreeLearner and quantize_gh_pmax run on a 2-device
mesh of conftest's virtual CPU devices. Held here, on real gradients:

* ``ops/quantize.quantize_gh_pmax`` (the group's max-abs scales, the cap
  from the global row count, the noise of fold_in(key, rank)): each rank's
  packed words are the JAX shard's bit for bit, at 8 and 16 bits;
* one quantized tree (grad_bits 8, with and without leaf
  re-quantization) in psum and reduce-scatter modes, on rows without NaN:
  leaf, feature and threshold equal JAX's, gains and sums within rtol
  1e-5, the ranks' leaf ids in rank order the JAX global leaf map, and
  every split's counts add up to its leaf's. In psum mode the counts
  equal JAX's. In scatter mode the count lane is rebuilt per bin,
  rounded, so a left count summed from the left and one taken as the
  leaf's count less the right differ, and a split's default direction
  decides which it records. On these rows no feature has a missing bin,
  so both sweeps split the same rows with the same integer sums: the
  direction is a tie, which each package's f32 dequantized sums break
  their own way. So in scatter mode every reduction is held bit for bit
  against JAX's make_scatter_reduce_q on the same inputs; every split's
  counts against its leaf's rebuilt count lane, replayed from those
  reductions, in its own direction (JAX's too, on every leaf whose
  ancestors' counts are JAX's); the integer sums of both sweeps equal
  wherever the directions differ; and the counts equal JAX's on the
  splits whose default direction, and their ancestors', is JAX's;
* with constant hessians (objective=regression's) the scatter mode's
  rebuilt count lane is exact: scatter equals psum bit for bit;
* the collectives each mode issues, and their bytes;
* quantized end-to-end runs (and a bagged one): ranks byte-equal; on
  240 rows, where the JAX package would pick an int16 wire, the lanes
  travel as int32 (gloo and NCCL reduce no int16).
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.models.device_learner import make_scatter_reduce_q
from lightgbm_tpu.ops import quantize as jquant
from lightgbm_tpu.parallel.learners import DeviceDataParallelTreeLearner
from lightgbm_tpu.parallel.mesh import make_mesh

from lightgbm_tpu_torch.models import device_learner as tdl

import torch_dp_modes_worker as worker
import torch_dp_worker as base
from test_torch_parallel import _free_ports, _run_ranks

try:
    from jax import shard_map
except ImportError:                                  # older jax
    from jax.experimental.shard_map import shard_map

HERE = os.path.dirname(os.path.abspath(__file__))
INTS = [tdl.R_LEAF, tdl.R_FEAT, tdl.R_THR]
COUNTS = [tdl.R_LCNT, tdl.R_RCNT]
FLOATS = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_RSG, tdl.R_RSH]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_quant"))
    port = str(_free_ports(1)[0])
    _run_ranks(lambda r: [sys.executable,
                          os.path.join(HERE, "torch_dp_modes_worker.py"),
                          "quant", str(r), out, port])
    return [dict(np.load(os.path.join(out, "quant%d.npz" % r)))
            for r in range(2)]


@pytest.mark.parametrize("bits", [8, 16])
def test_packed_words_equal_jax_shards(ranks, bits):
    _, _, g, h, _, _ = base.data()
    n = len(g)
    local_n = -(-n // 2)
    pad = 2 * local_n - n
    mesh = make_mesh(2)

    def local(gl, hl, key):
        return jquant.quantize_gh_pmax(gl, hl, key, grad_bits=bits,
                                       n_total=2 * local_n,
                                       axis_name="data")
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P("data"), P("data"), P()),
                           out_specs=(P("data"), P(), P()),
                           check_vma=False))
    packed, s_g, s_h = fn(jnp.asarray(np.pad(g, (0, pad))),
                          jnp.asarray(np.pad(h, (0, pad))),
                          jax.random.PRNGKey(3))
    packed = np.asarray(packed)
    for r in range(2):
        np.testing.assert_array_equal(
            ranks[r]["packed_%d" % bits],
            packed[r * local_n:(r + 1) * local_n])
        np.testing.assert_array_equal(
            np.float32(ranks[r]["scales_%d" % bits]),
            np.float32([s_g, s_h]))
    # the padding row quantizes to 0, and the ranks' noise differs
    assert ranks[1]["packed_%d" % bits][-1] == 0


def _jax_quant_tree(mode, renew, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_DP_REDUCE", mode)
    x, y, g, h, _, _ = base.data()
    cfg = JConfig(dict(worker.PARAMS, quantized_grad=True, grad_bits=8,
                       quant_renew=renew))
    jl = DeviceDataParallelTreeLearner(
        cfg, JDataset(np.nan_to_num(x), config=cfg, label=y),
        mesh=make_mesh(2))
    got = {}
    jl.replay_tree = lambda rec_h, k, rec_cat_h=None: got.update(
        rec=np.asarray(rec_h), k=k)
    jl.train(jnp.asarray(g), jnp.asarray(h))
    return got["rec"][:got["k"]], np.asarray(jl.last_leaf_id)


def _same_direction_subtree(trec, jrec):
    """(k,) bool: split i and every split above it took JAX's default
    direction (the scatter mode's rebuilt counts of a leaf depend on the
    direction its ancestors' scans summed from)."""
    clean = {0: True}
    out = np.zeros(len(trec), bool)
    for i in range(len(trec)):
        leaf = int(trec[i, tdl.R_LEAF])
        out[i] = clean[leaf] and trec[i, tdl.R_DLEFT] == jrec[i, tdl.R_DLEFT]
        clean[leaf] = clean[i + 1] = out[i]
    return out


def _parent_counts(rec, n):
    """(k,) the count of the leaf each split of `rec` cuts (the root's n,
    then each child's count as its split recorded it)."""
    count = {0: n}
    out = np.zeros(len(rec))
    for i, r in enumerate(rec):
        leaf = int(r[tdl.R_LEAF])
        out[i] = count[leaf]
        count[leaf], count[i + 1] = r[tdl.R_LCNT], r[tdl.R_RCNT]
    return out


@pytest.mark.parametrize("renew", [True, False])
@pytest.mark.parametrize("mode", ["psum", "scatter"])
def test_quantized_records_match_jax(ranks, mode, renew, monkeypatch):
    tag = "%s_%s" % (mode, "renew" if renew else "fixed")
    jrec, jleaf = _jax_quant_tree(mode, renew, monkeypatch)
    trec = ranks[0][tag + "_rec"]
    np.testing.assert_array_equal(ranks[1][tag + "_rec"], trec)
    assert len(trec) == len(jrec) > 5
    np.testing.assert_array_equal(trec[:, INTS], jrec[:, INTS])
    n = len(base.data()[0])
    for rec in (trec, jrec):
        np.testing.assert_array_equal(
            rec[:, tdl.R_LCNT] + rec[:, tdl.R_RCNT], _parent_counts(rec, n))
    same = (_same_direction_subtree(trec, jrec) if mode == "scatter"
            else np.ones(len(trec), bool))
    assert same.sum() >= len(trec) // 2
    np.testing.assert_array_equal(trec[same][:, COUNTS],
                                  jrec[same][:, COUNTS])
    np.testing.assert_allclose(trec[:, FLOATS], jrec[:, FLOATS], rtol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([ranks[0][tag + "_leaf"], ranks[1][tag + "_leaf"]]),
        jleaf)


def _scatter_reductions(ranks, tag):
    """The scatter tree `tag`'s reductions, as the port made them and as
    JAX's make_scatter_reduce_q makes them from the same inputs (the
    ranks' local int32 histograms, the leaf's count and hessian total) on
    the 2-device mesh: two (calls, C, B, 3) int32, the ranks' column
    slices put together."""
    local = [ranks[r][tag + "_reduce_in"] for r in range(2)]
    args = ranks[0][tag + "_reduce_n"]
    np.testing.assert_array_equal(ranks[1][tag + "_reduce_n"], args)
    c_cols = local[0].shape[1]
    n_pad = 2 * -(-len(base.data()[0]) // 2)
    reduce_q = make_scatter_reduce_q("data", 2, c_cols,
                                     jquant.wire_dtype(8, n_pad))
    fn = jax.jit(shard_map(reduce_q, mesh=make_mesh(2),
                           in_specs=(P("data"), P(), P()),
                           out_specs=P("data"), check_vma=False))
    want = np.stack([np.asarray(fn(
        jnp.asarray(np.concatenate([local[0][i], local[1][i]])),
        jnp.float32(args[i, 0]), jnp.float32(args[i, 1])))[:c_cols]
        for i in range(len(args))])
    got = np.concatenate([ranks[r][tag + "_reduce_out"]
                          for r in range(2)], axis=1)[:, :c_cols]
    return got, want


@pytest.mark.parametrize("renew", ["renew", "fixed"])
def test_scatter_count_lane_is_jax_rebuild(ranks, renew):
    # the root's reduction, then one per split step (15 leaves)
    got, want = _scatter_reductions(ranks, "scatter_" + renew)
    assert len(got) == 15
    np.testing.assert_array_equal(got, want)


def test_scatter_counts_follow_each_direction(ranks, monkeypatch):
    """Without leaf re-quantization a leaf's histogram is the reduced one
    of the smaller child, or its parent's less its sibling's: replayed
    from the reductions, it gives every split's recorded counts in the
    split's own default direction, the port's on every split, JAX's on
    every leaf whose ancestors' counts are the port's."""
    got, _ = _scatter_reductions(ranks, "scatter_fixed")
    trec = ranks[0]["scatter_fixed_rec"]
    jrec, _ = _jax_quant_tree("scatter", False, monkeypatch)
    # no feature has a missing bin: both sweeps cut every leaf alike
    assert not ranks[0]["missing_types"].any()

    def left_count(hist, count, r):
        cnt = hist[int(r[tdl.R_FEAT]), :, 2].astype(np.int64)
        t = int(r[tdl.R_THR])
        return count - cnt[t + 1:].sum() if r[tdl.R_DLEFT] > 0.5 \
            else cnt[:t + 1].sum()

    hist = {0: got[0]}
    count = {0: len(base.data()[0])}
    same = {0: True}
    checked = ties = 0
    for i, (t, j) in enumerate(zip(trec, jrec)):
        leaf = int(t[tdl.R_LEAF])
        h = hist[leaf]
        assert t[tdl.R_LCNT] == left_count(h, count[leaf], t)
        if same[leaf]:
            assert j[tdl.R_LCNT] == left_count(h, count[leaf], j)
            checked += 1
        if t[tdl.R_DLEFT] != j[tdl.R_DLEFT]:
            # every row lies in one bin of each column, so both sweeps
            # have the same integer g and h sums: equal gains, a tie
            lanes = h[:, :, :2].astype(np.int64)
            tot = lanes.sum(axis=1)
            assert (tot == tot[0]).all()
            col, thr = lanes[int(t[tdl.R_FEAT])], int(t[tdl.R_THR])
            np.testing.assert_array_equal(col[:thr + 1].sum(axis=0),
                                          tot[0] - col[thr + 1:].sum(axis=0))
            ties += 1
        small = got[i + 1]
        sib = h - small
        lc, rc = t[tdl.R_LCNT], t[tdl.R_RCNT]
        hist[leaf], hist[i + 1] = (small, sib) if lc <= rc else (sib, small)
        count[leaf], count[i + 1] = lc, rc
        same[leaf] = same[i + 1] = bool(
            same[leaf] and lc == j[tdl.R_LCNT] and rc == j[tdl.R_RCNT])
    assert ties > 0 and checked > len(trec) // 2


@pytest.mark.parametrize("renew", ["renew", "fixed"])
def test_constant_hessian_scatter_equals_psum(ranks, renew):
    for r in range(2):
        for part in ("rec", "leaf"):
            np.testing.assert_array_equal(
                ranks[r]["scatter_%s_const_%s" % (renew, part)],
                ranks[r]["psum_%s_const_%s" % (renew, part)])


def test_collectives_and_wire_bytes(ranks):
    # 15 leaves: the root and 14 split steps, 6 columns x 64 bins. psum:
    # one int32 (C, B, 3) all-reduce each, plus the scales' max (and,
    # renewing, the root's and each split's side maxes). Scatter: the
    # totals, then the two int32 lanes (the wire of 3,002 rows at 8 bits
    # is int32: 127 x 3,002 > 32,767), and each scan's election
    L, C, B = 15, 6, 64
    hist = C * B * 3 * 4
    for r in range(2):
        coll, nbytes, scatter = ranks[r]["psum_fixed_wire"]
        assert (coll, nbytes, scatter) == (L + 1, L * hist + 8, 0)
        coll, nbytes, _ = ranks[r]["psum_renew_wire"]
        assert (coll, nbytes) == (2 * L + 1,
                                  L * hist + 8 + 8 + (L - 1) * 16)
        coll, nbytes, scatter = ranks[r]["scatter_fixed_wire"]
        assert scatter == 2 and coll == 2 * L + 2
        lanes = C * B * 2 * 4
        assert nbytes > L * lanes and nbytes < L * hist


@pytest.mark.parametrize("name", sorted(worker.QUANT_RUNS))
def test_quantized_runs_byte_equal_on_both_ranks(ranks, name):
    assert str(ranks[0]["text_" + name]) == str(ranks[1]["text_" + name])
    assert ranks[0]["auc_" + name] > 0.9


def test_small_run_lanes_travel_as_int32(ranks):
    # 2 rounds of 7 leaves on 240 rows, where JAX's rule (127 x 240 <=
    # 32,767) would pick an int16 wire: per tree the scales' max, the
    # root's totals and lanes and the root's election, then per split
    # step the lanes, the election and (renewing) the side maxes' max
    assert str(ranks[0]["small_text"]) == str(ranks[1]["small_text"])
    coll, nbytes, scatter = ranks[0]["small_wire"]
    assert int(scatter) == 2
    lanes = 6 * 64 * 2 * 4                # (C, B, 2) as int32, not int16
    assert int(nbytes) > 2 * 7 * lanes
