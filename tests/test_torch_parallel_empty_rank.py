"""A data-parallel rank whose row block is empty, on the CPU.

Four gloo ranks share 9 rows in ceil blocks of 3, 3, 3 and none; they run
tests/torch_dp_modes_worker.py (kind ``empty``). The last rank runs every
tree on its all-padding block at weight 0, as the JAX data-parallel
program's ``alive`` guard does, and enters every collective with the
others. Held here against the JAX DeviceDataParallelTreeLearner on a
4-device mesh of conftest's virtual CPU devices: one quantized tree (real
gradients, psum mode) and bagged and GOSS trees (1/64-grid gradients)
through the fused step's seam, records and the global leaf map; and
end-to-end quantized, bagged, GOSS, pos/neg and regression_l1 runs whose
model text is byte-equal on all four ranks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.parallel.learners import DeviceDataParallelTreeLearner
from lightgbm_tpu.parallel.mesh import make_mesh

from lightgbm_tpu_torch.models import device_learner as tdl

import torch_dp_modes_worker as worker
import torch_dp_worker as base
from test_torch_parallel import _free_ports

HERE = os.path.dirname(os.path.abspath(__file__))
W = worker.EMPTY_RANKS
INTS = [tdl.R_LEAF, tdl.R_LCNT, tdl.R_RCNT]
CUT = [tdl.R_FEAT, tdl.R_THR]
FLOATS = [tdl.R_GAIN, tdl.R_LSG, tdl.R_LSH, tdl.R_RSG, tdl.R_RSH]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_empty"))
    port = str(_free_ports(1)[0])
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_modes_worker.py"),
         "empty", str(r), out, port], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(W)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [dict(np.load(os.path.join(out, "empty%d.npz" % r)))
            for r in range(W)]


def test_last_block_is_empty(ranks):
    assert [list(r["block"]) for r in ranks] == [[0, 3], [3, 6], [6, 9],
                                                 [9, 9]]


def _jax_tree(mode, name, monkeypatch):
    """The JAX data-parallel program's tree on the 4-device mesh: the
    quantized one through the learner's train, the sampled ones through
    its fused step's sharded tree with the bag key; (records, global leaf
    map)."""
    monkeypatch.setenv("LGBM_TPU_DP_REDUCE", mode)
    x, y, g, h, gq, hq = base.data(worker.EMPTY_N)
    cfg = JConfig(dict(worker.EMPTY_PARAMS, **worker.EMPTY_TREES[name]))
    jl = DeviceDataParallelTreeLearner(
        cfg, JDataset(np.nan_to_num(x), config=cfg, label=y),
        mesh=make_mesh(W))
    n = worker.EMPTY_N
    if name == "quant":
        got = {}
        jl.replay_tree = lambda rec_h, k, rec_cat_h=None: got.update(
            rec=np.asarray(rec_h), k=k)
        jl.train(jnp.asarray(g), jnp.asarray(h))
        return got["rec"][:got["k"]], np.asarray(jl.last_leaf_id)[:n]
    goss = (cfg.top_rate, cfg.other_rate) if name == "goss" else None
    fn = jl._sharded_tree_fn(with_bag_key=True, goss=goss)
    pad = jl.n_pad - n
    rec, _, leaf, k, _ = jax.jit(fn)(
        jl.codes_pack, jl.codes_row,
        *(jnp.asarray(np.pad(v, (0, pad))) for v in (gq, hq)),
        jax.random.PRNGKey(worker.BAG_SEED),
        jnp.ones(jl.num_features, bool), jax.random.PRNGKey(0))
    return np.asarray(rec)[:int(k)], np.asarray(leaf)[:n]


@pytest.mark.parametrize("mode,name", [("psum", "quant"), ("psum", "bag"),
                                       ("scatter", "bag"), ("psum", "goss"),
                                       ("scatter", "goss")])
def test_trees_match_jax_with_an_empty_rank(ranks, mode, name,
                                            monkeypatch):
    tag = "%s_%s" % (mode, name)
    trec = ranks[0][tag + "_rec"]
    for r in range(1, W):
        np.testing.assert_array_equal(ranks[r][tag + "_rec"], trec)
    assert len(ranks[W - 1][tag + "_leaf"]) == 0
    jrec, jleaf = _jax_tree(mode, name, monkeypatch)
    assert len(trec) == len(jrec) > 0
    np.testing.assert_array_equal(trec[:, INTS], jrec[:, INTS])
    np.testing.assert_allclose(trec[:, FLOATS], jrec[:, FLOATS], rtol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([ranks[r][tag + "_leaf"] for r in range(W)]), jleaf)
    # On 9 rows two features may cut a leaf's rows alike. The sampled
    # trees' 1/64-grid sums are exact, so both packages break such a tie
    # alike; the quantized scan's f32 dequantized prefix sums round in
    # each package's order, so there a split may name the other feature
    # of a tie: same counts and sums (above), same rows (the leaf maps)
    other = (trec[:, CUT] != jrec[:, CUT]).any(axis=1)
    assert other.sum() <= (1 if name == "quant" else 0)


@pytest.mark.parametrize("name", sorted(worker.EMPTY_RUNS))
def test_runs_byte_equal_on_every_rank(ranks, name):
    text = str(ranks[0]["text_" + name])
    assert "split_feature" in text
    for r in range(1, W):
        assert str(ranks[r]["text_" + name]) == text
