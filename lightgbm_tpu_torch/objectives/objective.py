"""Objective functions as torch tensor math.

Port of lightgbm_tpu/objectives/objective.py (reference:
src/objective/{regression,binary,multiclass,xentropy,rank}_objective.hpp):
the same gradients and hessians, boost-from-score, output
transform, leaf renewal (regression_l1, quantile, mape: the weighted
percentile ``_percentile`` in f64 on the host) and model-text string.
Labels and weights live on the device the objective is initialised for;
scores arrive there as (N,) f32 tensors, or (K, N) for the two multiclass
objectives (class-major, as the reference's num_data * k + i). A scalar
divided by a tensor is written as a 0-d tensor over it: torch's
``scalar / tensor`` multiplies by the reciprocal, which rounds otherwise
than the division XLA makes.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from ..io.dataset import query_slots
from ..utils import log

K_EPSILON = 1e-15


def _percentile(values: np.ndarray, weights: Optional[np.ndarray],
                alpha: float) -> float:
    """Weighted percentile, reference semantics (regression_objective.hpp:20-76
    PercentileFun/WeightedPercentileFun)."""
    n = len(values)
    if n == 0:
        return 0.0
    if weights is None:
        if n <= 1:
            return float(values[0])
        order = np.argsort(values, kind="stable")
        float_pos = (1.0 - alpha) * n
        pos = int(math.floor(float_pos))
        if pos < 1:
            return float(values[order[0]])
        if pos >= n:
            return float(values[order[n - 1]])
        bias = float_pos - pos
        v1 = float(values[order[pos - 1]])
        v2 = float(values[order[pos]])
        return v1 * (1.0 - bias) + v2 * bias
    order = np.argsort(values, kind="stable")
    w = weights[order]
    v = values[order]
    cum = np.cumsum(w) - 0.5 * w
    threshold = alpha * np.sum(w)
    idx = int(np.searchsorted(cum, threshold, side="left"))
    idx = min(max(idx, 0), n - 1)
    if idx > 0 and cum[idx] > threshold:
        # interpolate like the reference's weighted percentile
        c1, c2 = cum[idx - 1], cum[idx]
        if c2 > c1:
            t = (threshold - c1) / (c2 - c1)
            return float(v[idx - 1] * (1 - t) + v[idx] * t)
    return float(v[idx])


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def _softmax(score: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis 0 of (K, N), as jax.nn.softmax forms
    it: exp(x - max) over its sum."""
    e = torch.exp(score - score.max(dim=0, keepdim=True).values)
    return e / e.sum(dim=0, keepdim=True)


class Objective:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "none"

    def __init__(self, config):
        self.config = config
        self.num_class = 1
        self.label: Optional[np.ndarray] = None
        self.weight = None

    def init(self, metadata, num_data: int, device=None) -> None:
        self.num_data = num_data
        self.device = torch.device(device or "cpu")
        self.label = metadata.label
        self.weight = metadata.weight
        self._label_dev = self._to_dev(self.label)
        self._weight_dev = self._to_dev(self.weight)

    def row_block(self, lo: int, hi: int) -> "Objective":
        """This objective on rows [lo, hi) of those it was set up on: its
        per-row arrays sliced, while what it drew from every label (the
        label weights, the class counts, which classes train) stays. A
        data-parallel rank computes its block's gradients with it."""
        out = copy.copy(self)
        for key, val in vars(self).items():
            if isinstance(val, (torch.Tensor, np.ndarray)) and val.ndim \
                    and val.shape[-1] == self.num_data:
                part = val[..., lo:hi]
                setattr(out, key, part.contiguous()
                        if isinstance(part, torch.Tensor) else part.copy())
            elif isinstance(val, list) and val and all(
                    isinstance(o, Objective) for o in val):
                setattr(out, key, [o.row_block(lo, hi) for o in val])
        out.num_data = hi - lo
        return out

    def _to_dev(self, x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def get_gradients(self, score: torch.Tensor):
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return scores

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    @property
    def is_renew_tree_output(self) -> bool:
        return False

    def renew_leaf_output(self, residuals: np.ndarray,
                          weights: Optional[np.ndarray]) -> float:
        raise NotImplementedError

    def class_need_train(self, class_id: int) -> bool:
        return True

    def to_string(self) -> str:
        return self.name

    def _apply_weight(self, grad, hess):
        if self._weight_dev is not None:
            return grad * self._weight_dev, hess * self._weight_dev
        return grad, hess


class RegressionL2(Objective):
    """reference: regression_objective.hpp:78 RegressionL2loss."""
    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(getattr(config, "reg_sqrt", False))

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lbl = np.sign(self.label) * np.sqrt(np.abs(self.label))
            self._label_dev = self._to_dev(lbl)
            self._trans_label = lbl
        else:
            self._trans_label = self.label

    def get_gradients(self, score):
        grad = score - self._label_dev
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return float(np.sum(self._trans_label * self.weight)
                         / np.sum(self.weight))
        return float(np.mean(self._trans_label))

    def convert_output(self, scores):
        if self.sqrt:
            return torch.sign(scores) * scores * scores
        return scores

    def to_string(self):
        return f"{self.name} sqrt" if self.sqrt else self.name


class RegressionL1(RegressionL2):
    """reference: regression_objective.hpp:189 RegressionL1loss."""
    name = "regression_l1"

    def get_gradients(self, score):
        grad = torch.sign(score - self._label_dev)
        return self._apply_weight(grad, torch.ones_like(score))

    def boost_from_score(self, class_id):
        return _percentile(np.asarray(self.label, dtype=np.float64),
                           self.weight, 0.5)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def renew_leaf_output(self, residuals, weights):
        return _percentile(residuals, weights, 0.5)


class Huber(RegressionL2):
    """reference: regression_objective.hpp:275 RegressionHuberLoss."""
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        diff = score - self._label_dev
        grad = torch.where(diff.abs() <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return self._apply_weight(grad, torch.ones_like(score))


class Fair(RegressionL2):
    """reference: regression_objective.hpp:337 RegressionFairLoss."""
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self._label_dev
        ax = x.abs()
        grad = self.c * x / (ax + self.c)
        hess = score.new_tensor(self.c * self.c) / ((ax + self.c) ** 2)
        return self._apply_weight(grad, hess)


class Poisson(RegressionL2):
    """reference: regression_objective.hpp:384 RegressionPoissonLoss (log
    link)."""
    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if np.any(self.label < 0):
            log.fatal("[%s]: at least one target label is negative",
                      self.name)

    def get_gradients(self, score):
        grad = torch.exp(score) - self._label_dev
        hess = torch.exp(score + self.max_delta_step)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        mean = RegressionL2.boost_from_score(self, class_id)
        return math.log(max(mean, 1e-20))

    def convert_output(self, scores):
        return torch.exp(scores)


class Quantile(RegressionL2):
    """reference: regression_objective.hpp:464 RegressionQuantileloss."""
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        delta = score - self._label_dev
        grad = torch.where(delta >= 0, torch.full_like(score, 1.0 - self.alpha),
                           torch.full_like(score, -self.alpha))
        return self._apply_weight(grad, torch.ones_like(score))

    def boost_from_score(self, class_id):
        return _percentile(np.asarray(self.label, dtype=np.float64),
                           self.weight, self.alpha)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def renew_leaf_output(self, residuals, weights):
        return _percentile(residuals, weights, self.alpha)


class MAPE(RegressionL1):
    """reference: regression_objective.hpp:562 RegressionMAPELOSS. Its
    gradients carry the MAPE weights (and the dataset's) already; leaf
    renewal weighs each row by them too (``leaf_renew_weight``)."""
    name = "mape"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        label = np.asarray(self.label, dtype=np.float64)
        w = 1.0 / np.maximum(1.0, np.abs(label))
        if self.weight is not None:
            w = w * self.weight
        self._mape_w = w
        self._mape_w_dev = self._to_dev(w)

    def get_gradients(self, score):
        diff = score - self._label_dev
        return torch.sign(diff) * self._mape_w_dev, self._mape_w_dev.clone()

    def boost_from_score(self, class_id):
        return _percentile(np.asarray(self.label, dtype=np.float64),
                           self._mape_w, 0.5)

    @property
    def leaf_renew_weight(self) -> np.ndarray:
        return self._mape_w


class Gamma(Poisson):
    """reference: regression_objective.hpp:661 RegressionGammaLoss."""
    name = "gamma"

    def get_gradients(self, score):
        inv = torch.exp(-score)
        grad = 1.0 - self._label_dev * inv
        hess = self._label_dev * inv
        return self._apply_weight(grad, hess)


class Tweedie(Poisson):
    """reference: regression_objective.hpp:696 RegressionTweedieLoss."""
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        e1 = torch.exp((1.0 - self.rho) * score)
        e2 = torch.exp((2.0 - self.rho) * score)
        grad = -self._label_dev * e1 + e2
        hess = (-self._label_dev * (1.0 - self.rho) * e1
                + (2.0 - self.rho) * e2)
        return self._apply_weight(grad, hess)


class BinaryLogloss(Objective):
    """reference: binary_objective.hpp:21 BinaryLogloss."""
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        is_pos = self.label > 0
        cnt_pos = int(np.sum(is_pos))
        cnt_neg = num_data - cnt_pos
        self.need_train = cnt_pos > 0 and cnt_neg > 0
        if not self.need_train:
            log.warning("Contains only one class")
        w_neg, w_pos = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self._signed_label = self._to_dev(np.where(is_pos, 1.0, -1.0))
        self._label_weight = self._to_dev(np.where(is_pos, w_pos, w_neg))
        self._pavg = (np.sum(self.weight[is_pos]) / np.sum(self.weight)
                      if self.weight is not None
                      else cnt_pos / max(1, num_data))

    def get_gradients(self, score):
        lbl = self._signed_label
        response = -lbl * self.sigmoid / (
            1.0 + torch.exp(lbl * self.sigmoid * score))
        abs_r = torch.abs(response)
        grad = response * self._label_weight
        hess = abs_r * (self.sigmoid - abs_r) * self._label_weight
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id):
        pavg = min(max(self._pavg, K_EPSILON), 1.0 - K_EPSILON)
        return math.log(pavg / (1.0 - pavg)) / self.sigmoid

    def convert_output(self, scores):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * scores))

    def class_need_train(self, class_id):
        return self.need_train

    def to_string(self):
        return f"{self.name} sigmoid:{self.sigmoid:g}"


class CrossEntropy(Objective):
    """reference: xentropy_objective.hpp:44 CrossEntropy."""
    name = "cross_entropy"

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        if np.any((self.label < 0) | (self.label > 1)):
            log.fatal("[%s]: label must be in [0, 1]", self.name)

    def get_gradients(self, score):
        z = _sigmoid(score)
        return self._apply_weight(z - self._label_dev, z * (1.0 - z))

    def boost_from_score(self, class_id):
        if self.weight is not None:
            pavg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            pavg = float(np.mean(self.label))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        return math.log(pavg / (1.0 - pavg))

    def convert_output(self, scores):
        return _sigmoid(scores)


class CrossEntropyLambda(CrossEntropy):
    """reference: xentropy_objective.hpp:148 CrossEntropyLambda: the
    unweighted gradients are cross_entropy's; weights enter through the
    lambda parameterization, not as a product."""
    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        if self._weight_dev is None:
            z = _sigmoid(score)
            return z - self._label_dev, z * (1.0 - z)
        w = self._weight_dev
        y = self._label_dev
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        return grad, a * (1.0 + y * b)

    def boost_from_score(self, class_id):
        if self.weight is not None:
            havg = float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        else:
            havg = float(np.mean(self.label))
        return math.log(max(math.exp(havg) - 1.0, K_EPSILON))

    def convert_output(self, scores):
        return torch.log1p(torch.exp(scores))


class MulticlassSoftmax(Objective):
    """reference: multiclass_objective.hpp:24 MulticlassSoftmax; gradients
    over the (K, N) scores."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        label_int = self.label.astype(np.int32)
        if np.any((label_int < 0) | (label_int >= self.num_class)):
            log.fatal("Label must be in [0, %d) for multiclass",
                      self.num_class)
        self._onehot = torch.as_tensor(
            np.arange(self.num_class)[:, None] == label_int[None, :],
            device=self.device)
        counts = np.bincount(label_int, minlength=self.num_class,
                             weights=self.weight)
        self._class_probs = counts / max(counts.sum(), 1e-10)

    def get_gradients(self, score):
        p = _softmax(score)
        grad = p - self._onehot.float()
        hess = 2.0 * p * (1.0 - p)
        if self._weight_dev is not None:
            grad = grad * self._weight_dev[None, :]
            hess = hess * self._weight_dev[None, :]
        return grad, hess

    def boost_from_score(self, class_id):
        return math.log(max(K_EPSILON, self._class_probs[class_id]))

    def convert_output(self, scores):
        return _softmax(scores)

    def row_block(self, lo, hi):
        out = super().row_block(lo, hi)
        out._class_probs = self._class_probs      # per class, not per row
        return out

    def class_need_train(self, class_id):
        p = self._class_probs[class_id]
        return K_EPSILON < abs(p) < 1.0 - K_EPSILON

    def to_string(self):
        return f"{self.name} num_class:{self.num_class}"


class MulticlassOVA(Objective):
    """reference: multiclass_objective.hpp:180 MulticlassOVA: K binary
    objectives, class k's on the labels == k."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        self._binary = [BinaryLogloss(config) for _ in range(self.num_class)]

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        label_int = self.label.astype(np.int32)
        onehot = (np.arange(self.num_class)[:, None]
                  == label_int[None, :]).astype(np.float32)
        for k, b in enumerate(self._binary):
            b.init(_Labels(onehot[k], self.weight), num_data, self.device)

    def get_gradients(self, score):
        pairs = [b.get_gradients(score[k])
                 for k, b in enumerate(self._binary)]
        return (torch.stack([g for g, _ in pairs]),
                torch.stack([h for _, h in pairs]))

    def boost_from_score(self, class_id):
        return self._binary[class_id].boost_from_score(0)

    def convert_output(self, scores):
        return _sigmoid(self.sigmoid * scores)

    def to_string(self):
        return (f"{self.name} num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")


class _Labels:
    """The metadata one of OVA's binary objectives sees."""

    def __init__(self, label, weight):
        self.label = label
        self.weight = weight


# elements of one (queries, L, L) pair tensor of lambdarank's gradient: the
# queries run in chunks of at most this many pair slots (64 MB per f32
# tensor), so the working set does not grow with the number of queries
_PAIR_BUDGET = 1 << 24


class LambdarankNDCG(Objective):
    """LambdaRank with NDCG weighting (reference: rank_objective.hpp:23;
    the JAX package's LambdarankNDCG). Queries are padded into (Q, L)
    slots, L = max(8, the next power of two of the largest query); the
    pair loop (rank_objective.hpp:83-190) becomes masked (L, L) tensors per
    query, with the exact sigmoid in place of the reference's table and
    every pair of a query (max_position enters only the inverse max DCG),
    as in the JAX package. The slots, padded labels and gains and the
    inverse max DCGs are built on the host at init; the gradient is torch
    ops on the objective's device with no host sync, run over chunks of
    queries (_PAIR_BUDGET) and gathered back to the rows (each row has one
    slot)."""
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdamart_norm)
        self.optimize_pos_at = int(config.max_position)
        self.label_gain = np.asarray(config.label_gain, dtype=np.float64)

    def init(self, metadata, num_data, device=None):
        super().init(metadata, num_data, device)
        qb = metadata.query_boundaries
        if qb is None:
            log.fatal("Lambdarank tasks require query information")
        qb = np.asarray(qb, dtype=np.int64)
        L = max(8, 1 << (int(np.diff(qb).max()) - 1).bit_length())
        self.pad_len = L
        idx, mask, counts = query_slots(qb, L)
        pos = np.arange(L)
        labels = np.where(mask, self.label[idx], 0.0)
        gains = self.label_gain[labels.astype(np.int32)]
        discounts = 1.0 / np.log2(pos + 2.0)
        # max DCG at max_position per query (reference
        # DCGCalculator::CalMaxDCGAtK): the valid gains sorted down
        top = -np.sort(-np.where(mask, gains, -np.inf), axis=1)
        keep = pos[None, :] < np.minimum(self.optimize_pos_at,
                                         counts)[:, None]
        max_dcg = np.where(keep, top * discounts, 0.0).sum(axis=1)
        inv_max_dcg = np.where(max_dcg > 0,
                               1.0 / np.where(max_dcg > 0, max_dcg, 1.0),
                               0.0)

        def dev(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=self.device)
        self._idx = dev(idx, torch.int64)
        self._mask = dev(mask, torch.bool)
        self._labels_pad = dev(labels, torch.float32)
        self._gains = dev(gains, torch.float32)
        self._discount = dev(discounts, torch.float32)
        self._inv_max_dcg = dev(inv_max_dcg, torch.float32)
        # the sorted slot of a query's last document (its worst score)
        self._last = dev(np.maximum(counts - 1, 0), torch.int64)
        # each row's slot q * L + position in the flat (Q * L) layout
        self._slot = dev(np.repeat(np.arange(len(counts)) * L
                                   - qb[:-1], counts)
                         + np.arange(num_data), torch.int64)
        self._chunk = max(1, _PAIR_BUDGET // (L * L))

    def get_gradients(self, score):
        q, L = self._idx.shape
        lam = torch.empty((q, L), dtype=torch.float32, device=score.device)
        hes = torch.empty_like(lam)
        for q0 in range(0, q, self._chunk):
            sl = slice(q0, q0 + self._chunk)
            self._query_gradients(score, sl, lam[sl], hes[sl])
        grad = lam.reshape(-1)[self._slot]
        hess = hes.reshape(-1)[self._slot]
        return self._apply_weight(grad, hess)

    def _query_gradients(self, score, sl, lam_out, hes_out):
        """The lambdas and hessians of the queries `sl`, written into
        their (q, L) document slots."""
        mask = self._mask[sl]
        # (fills with Python scalars: a tensor made from a host value
        # would be a host-to-device copy, which synchronizes)
        s = score[self._idx[sl]].masked_fill(~mask, float("-inf"))
        # rank -> document slot; a stable sort keeps tied documents (all
        # scores are 0 at the first iteration) in document order
        order = torch.argsort(-s, dim=1, stable=True)
        s_srt = s.gather(1, order)
        lbl_srt = self._labels_pad[sl].gather(1, order)
        gain_srt = self._gains[sl].gather(1, order)
        valid_srt = mask.gather(1, order)
        disc = self._discount[None, :] * valid_srt
        best = s_srt[:, 0]
        worst = s_srt.gather(1, self._last[sl][:, None])[:, 0]
        inv_max_dcg = self._inv_max_dcg[sl]

        # pair tensors over rank positions (i = high, j = low); padded
        # slots hold -inf, so their differences are NaN or inf and every
        # use is masked by torch.where (0 * NaN is NaN)
        delta_s = s_srt[:, :, None] - s_srt[:, None, :]
        pair_ok = (valid_srt[:, :, None] & valid_srt[:, None, :]
                   & (lbl_srt[:, :, None] > lbl_srt[:, None, :]))
        dcg_gap = gain_srt[:, :, None] - gain_srt[:, None, :]
        paired_disc = (disc[:, :, None] - disc[:, None, :]).abs()
        delta_ndcg = dcg_gap * paired_disc * inv_max_dcg[:, None, None]
        if self.norm:
            norm_ok = (best != worst)[:, None, None]
            delta_ndcg = torch.where(
                norm_ok, delta_ndcg / (0.01 + delta_s.abs()), delta_ndcg)
        p = 1.0 / (1.0 + torch.exp(self.sigmoid * delta_s))
        zero = s.new_zeros(())
        p_lambda = torch.where(pair_ok, -self.sigmoid * delta_ndcg * p, zero)
        p_hess = torch.where(
            pair_ok, self.sigmoid * self.sigmoid * delta_ndcg * p * (1.0 - p),
            zero)

        lam_srt = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
        hes_srt = p_hess.sum(dim=2) + p_hess.sum(dim=1)
        if self.norm:
            sum_lambdas = -2.0 * p_lambda.sum(dim=(1, 2))
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas) / sum_lambdas.clamp_min(1e-20),
                s.new_ones(()))
            lam_srt = lam_srt * factor[:, None]
            hes_srt = hes_srt * factor[:, None]
        # back to document slots (order is a permutation of each row)
        lam_out.scatter_(1, order, lam_srt)
        hes_out.scatter_(1, order, hes_srt)


_CLASSES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
}

OBJECTIVE_NAMES = sorted(_CLASSES)


def create_objective(name: str, config) -> Optional[Objective]:
    """Factory (reference: objective_function.cpp:15-50); None for a custom
    objective (none / null / custom / na: the caller's gradients)."""
    name = str(name).lower()
    if name in ("none", "null", "custom", "na"):
        return None
    cls = _CLASSES.get(name)
    if cls is None:
        log.fatal("objective=%s is not supported by this port yet "
                  "(supported: %s)", name, ", ".join(OBJECTIVE_NAMES))
    return cls(config)


def parse_objective_from_model(text: str, config) -> Optional[Objective]:
    """Recreate an objective from its model-file string, e.g.
    'binary sigmoid:1', 'multiclass num_class:3' or 'regression sqrt':
    every parameter a to_string writes."""
    parts = text.strip().split()
    if not parts:
        return None
    name = parts[0]
    for tok in parts[1:]:
        if tok == "sqrt":
            config.reg_sqrt = True
        elif ":" in tok:
            k, v = tok.split(":", 1)
            if k == "num_class":
                config.num_class = int(v)
            elif k == "sigmoid":
                config.sigmoid = float(v)
    return create_objective(name, config)
