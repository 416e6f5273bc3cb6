"""The pointwise objectives quantized, and leaf renewal under bagging:
the port's train() (device="cpu") against the JAX package's on
tests/test_torch_objectives.py's tasks (3,000 x 8 rows, 15 leaves), on
the compact strategy.

Quantized runs, one objective per family, are held as the existing
quantized tests hold them: the same splits, raw predictions within 1e-4.
The renewal under bagging 0.7 is held to 1e-5, with each leaf's rows the
in-bag rows.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_objectives import _assert_same_partitions, _params, _task

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


@pytest.mark.parametrize("objective", ["huber", "quantile", "poisson",
                                       "cross_entropy"])
def test_quantized_objective_matches_jax(objective, monkeypatch):
    # one objective per family (L2-like, renewal, log link, cross
    # entropy), quantized at 8 bits on compact; both packages on their
    # default iteration, so the same threefry draws quantize the same
    # gradients (renewal: the generic iteration on both)
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _task(objective)
    p = _params(objective, quantized_grad=True, grad_bits=8)
    jb = jlgb.train(p, jlgb.Dataset(x, y), 6, verbose_eval=False)
    tb = tlgb.train(p, tlgb.Dataset(x, y), 6, device="cpu")
    assert tb._gbdt.learner.quant_bits == 8
    _assert_same_partitions(jb._gbdt.models, tb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-4, atol=1e-4)


def test_renewal_uses_the_in_bag_rows(monkeypatch):
    # bagging 0.7 on the generic iteration (the host bag of both
    # packages, from the same RandomState): each leaf's value is the
    # median of its in-bag rows' residuals, as in the JAX package
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    x, y = _task("regression_l1")
    p = _params("regression_l1", bagging_fraction=0.7, bagging_freq=1)
    jb = jlgb.train(p, jlgb.Dataset(x, y), 4, verbose_eval=False)
    tb = tlgb.train(p, tlgb.Dataset(x, y), 4, device="cpu")
    _assert_same_partitions(jb._gbdt.models, tb._gbdt.models, x)
    np.testing.assert_allclose(tb.predict(x, raw_score=True),
                               jb.predict(x, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    # the last tree: its leaves' rows are in-bag rows, 70 % of all
    gb = tb._gbdt
    lr = gb.learner
    rows = np.concatenate([lr.leaf_rows(l)
                           for l in range(gb.models[-1].num_leaves)])
    assert len(rows) == int(len(y) * 0.7)
    assert np.array_equal(np.sort(rows), lr._bag_rows)
