"""Split scan: the port's find_best_split vs the JAX package's.

Random histograms built from random rows, every missing type, with l1,
l2 and max_delta_step. The winning feature, threshold and default_left
must be equal (default_left where the feature has a missing type); gains
and child sums within rtol 1e-5 (XLA and torch may
associate the cumsums differently, so values agree to f32 rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _leaf(seed, f=8, b=64, p=4000):
    r = np.random.RandomState(seed)
    nb = r.randint(3, b + 1, size=f).astype(np.int32)
    codes = np.stack([r.randint(0, nb[j], size=p) for j in range(f)], 1)
    g = (r.randn(p) + 0.3 * (codes[:, 0] > nb[0] // 2)).astype(np.float32)
    h = (r.rand(p) * 0.5 + 0.05).astype(np.float32)
    hist = np.zeros((f, b, 3), np.float64)
    for j in range(f):
        for k, w in enumerate((g, h, np.ones(p, np.float32))):
            hist[j, :, k] = np.bincount(codes[:, j], weights=w, minlength=b)
    tot = hist[0].sum(axis=0)
    meta = dict(
        nb=nb, missing=(np.arange(f) % 3).astype(np.int32),
        default=np.array([r.randint(0, n) for n in nb], np.int32),
        mask=np.ones(f, bool), mono=np.zeros(f, np.int32))
    return hist.astype(np.float32), tot.astype(np.float32), meta


@pytest.mark.parametrize("seed,l1,l2,mds", [
    (0, 0.0, 0.0, 0.0), (1, 0.5, 0.0, 0.0), (2, 0.0, 3.0, 0.0),
    (3, 0.0, 0.0, 0.7), (4, 1.0, 2.0, 0.3), (5, 0.0, 1.0, 0.0)])
def test_find_best_split_matches_jax(seed, l1, l2, mds):
    hist, tot, m = _leaf(seed)
    kw = dict(l1=l1, l2=l2, max_delta_step=mds, min_data_in_leaf=20,
              min_sum_hessian=1e-3, min_gain_to_split=0.0)
    j = jsplit.find_best_split(
        jnp.asarray(hist), tot[0], tot[1], tot[2], jnp.asarray(m["nb"]),
        jnp.asarray(m["missing"]), jnp.asarray(m["default"]),
        jnp.asarray(m["mask"]), jnp.asarray(m["mono"]),
        jnp.float32(-np.inf), jnp.float32(np.inf),
        num_bins=hist.shape[1], **kw)
    t = tsplit.find_best_split(
        torch.from_numpy(hist)[None], *(torch.tensor([v]) for v in tot),
        torch.from_numpy(m["nb"]), torch.from_numpy(m["missing"]),
        torch.from_numpy(m["default"]), torch.from_numpy(m["mask"]),
        torch.from_numpy(m["mono"]), torch.tensor([-np.inf]),
        torch.tensor([np.inf]), **kw)
    assert int(t.feature[0]) == int(j.feature)
    assert int(t.threshold[0]) == int(j.threshold)
    if m["missing"][int(j.feature)] != 0:
        # with nothing missing both directions give the same split and,
        # in exact arithmetic, the same gain: the direction is then decided
        # by f32 rounding and carries no meaning
        assert bool(t.default_left[0]) == bool(j.default_left)
    for name in ("gain", "left_sum_grad", "left_sum_hess", "left_count",
                 "right_sum_grad", "right_sum_hess", "right_count",
                 "left_output", "right_output"):
        np.testing.assert_allclose(float(getattr(t, name)[0]),
                                   float(getattr(j, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_leaf_helpers_match_jax():
    r = np.random.RandomState(9)
    g = r.randn(50).astype(np.float32)
    h = (r.rand(50) + 0.1).astype(np.float32)
    for l1, l2, mds in ((0.0, 0.0, 0.0), (0.3, 1.0, 0.5)):
        np.testing.assert_allclose(
            tsplit.leaf_split_gain(torch.from_numpy(g), torch.from_numpy(h),
                                   l1, l2, mds).numpy(),
            np.asarray(jsplit.leaf_split_gain(g, h, l1, l2, mds)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tsplit.calculate_leaf_output(torch.from_numpy(g),
                                         torch.from_numpy(h), l1, l2,
                                         mds).numpy(),
            np.asarray(jsplit.calculate_leaf_output(g, h, l1, l2, mds)),
            rtol=1e-6)


def test_batched_children_equal_single_scans():
    # a leaf scanned beside another one gives the same winner as alone
    hist_a, tot_a, m = _leaf(7)
    kw = dict(l1=0.1, l2=1.0, max_delta_step=0.0, min_data_in_leaf=20,
              min_sum_hessian=1e-3, min_gain_to_split=0.0)
    meta = [torch.from_numpy(m[k]) for k in ("nb", "missing", "default",
                                               "mask", "mono")]
    both = tsplit.find_best_split(
        torch.from_numpy(np.stack([hist_a, hist_a[::-1].copy()])),
        *(torch.tensor([tot_a[i], tot_a[i]]) for i in range(3)), *meta,
        torch.full((2,), -np.inf), torch.full((2,), np.inf), **kw)
    one = tsplit.find_best_split(
        torch.from_numpy(hist_a)[None], *(torch.tensor([v]) for v in tot_a),
        *meta, torch.tensor([-np.inf]), torch.tensor([np.inf]), **kw)
    assert int(both.feature[0]) == int(one.feature[0])
    assert float(both.gain[0]) == float(one.gain[0])
