"""Leaf-value refit: new leaf outputs from new data, the trees' structure
kept (the reference's task=refit, gbdt.cpp:298-321 RefitTree +
FitByExistingTree).

Port of lightgbm_tpu/continual/refit.py. The rows' leaves of every tree
(``pred_leaf``) are known, so the per-(tree, leaf) sums of gradient,
hessian and count are one ``index_add_`` on the booster's device over
the T x L segments, in f64, so that two refits agree to the last digits
(the JAX package sums in f32 with ``jax.ops.segment_sum``). The (T, L, 3)
sums come to the host, where the leaf formula runs in f64 and writes each
tree in place. ``LGBM_TPU_HOST_REFIT=1`` takes the host loop instead
(``GBDT._refit_leaves_host``), the oracle. The cross-rank sum of a
row-sharded refit waits for the multi-GPU slice.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..ops.predict import tree_chunks
from ..utils.envs import host_refit_env

# stats layout along the last axis of the (T, L, 3) sums
STAT_GRAD, STAT_HESS, STAT_COUNT = 0, 1, 2

# leaf_stats calls (each one index_add_ on the device)
dispatches = 0


def device_refit_enabled() -> bool:
    """The device sums unless LGBM_TPU_HOST_REFIT=1 asks for the host
    loop."""
    return not host_refit_env()


def leaf_stats(leaf_preds, grad: torch.Tensor, hess: torch.Tensor, *,
               num_tree_per_iteration: int, max_leaves: int) -> np.ndarray:
    """Host (T, L, 3) f64 sums [grad, hess, count] per (tree, leaf) from
    index_add_ on grad's device (one call, or one per chunk of trees
    past ops.predict.WALK_ELEMENTS). leaf_preds: (N, T) leaf of every row
    in every tree; grad / hess: (K, N) per-class gradients, tree t reads
    class t % K."""
    global dispatches
    dev = grad.device
    leaf_preds = np.asarray(leaf_preds)
    n, t_count = leaf_preds.shape
    width = max(int(max_leaves), 1)
    out = torch.zeros((t_count * width, 3), dtype=torch.float64,
                      device=dev)
    g64, h64 = grad.to(torch.float64), hess.to(torch.float64)
    # trees in chunks whose (T_chunk, N, 3) f64 operand stays bounded
    for a, b in tree_chunks(n, t_count):
        ids = torch.as_tensor(leaf_preds[:, a:b], device=dev).long()
        tix = torch.arange(a, b, device=dev)
        tree_class = tix % max(num_tree_per_iteration, 1)
        seg = ids.T + (tix * width)[:, None]                   # (T_c, N)
        g = g64.index_select(0, tree_class)
        h = h64.index_select(0, tree_class)
        vals = torch.stack([g, h, torch.ones_like(g)], dim=-1)
        out.index_add_(0, seg.reshape(-1), vals.reshape(-1, 3))
    dispatches += 1
    return out.reshape(t_count, width, 3).cpu().numpy()


def _threshold_l1(s: float, l1: float) -> float:
    return math.copysign(max(0.0, abs(s) - l1), s)


def apply_leaf_values(models: List, stats: np.ndarray, *, lambda_l1: float,
                      lambda_l2: float, max_delta_step: float,
                      decay_rate: float, shrinkage_rate: float) -> None:
    """The host finish: the reference leaf formula in f64 over the sums,
    written back in place; a leaf no row reached (count 0) keeps its
    value, as the host loop skips it."""
    for ti, tree in enumerate(models):
        sg = stats[ti, :, STAT_GRAD]
        sh = stats[ti, :, STAT_HESS]
        cnt = stats[ti, :, STAT_COUNT]
        for leaf in range(tree.num_leaves):
            if cnt[leaf] <= 0.0:
                continue
            out = -_threshold_l1(float(sg[leaf]), lambda_l1) \
                / (float(sh[leaf]) + lambda_l2)
            if max_delta_step > 0:
                out = float(np.clip(out, -max_delta_step, max_delta_step))
            old = float(tree.leaf_value[leaf])
            tree.set_leaf_output(
                leaf, decay_rate * old + (1.0 - decay_rate) * out
                * shrinkage_rate)


def refit_leaves_device(models: List, leaf_preds, grad, hess, *,
                        lambda_l1: float, lambda_l2: float,
                        max_delta_step: float, decay_rate: float,
                        shrinkage_rate: float,
                        num_tree_per_iteration: int) -> None:
    """One stats dispatch on the device, then the host finish in place."""
    if not models:
        return
    stats = leaf_stats(leaf_preds, grad, hess,
                       num_tree_per_iteration=num_tree_per_iteration,
                       max_leaves=max(t.num_leaves for t in models))
    apply_leaf_values(models, stats, lambda_l1=lambda_l1,
                      lambda_l2=lambda_l2, max_delta_step=max_delta_step,
                      decay_rate=decay_rate, shrinkage_rate=shrinkage_rate)
