"""Evaluation metrics of the port.

The metrics of lightgbm_tpu/metrics/metric.py (reference:
src/metric/{regression,binary,multiclass,xentropy,rank,map}_metric.hpp):
l1, l2, rmse, quantile, huber, fair, poisson, mape, gamma, gamma_deviance,
tweedie, binary_logloss, binary_error, auc, multi_logloss, multi_error
(over (K, N) scores), cross_entropy, cross_entropy_lambda, kldiv, and the
ranking metrics ndcg and map over a dataset's query groups (``eval_at``).
Scores come in
raw; metrics apply the objective's ConvertOutput exactly like the
reference's Metric::Eval(score, objective) contract.

Port of lightgbm_tpu/metrics/metric.py: the reductions are host numpy on
fetched scores, as in the JAX package; only the objective's output
transform runs through torch (on the CPU).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..io.dataset import query_slots
from ..utils import log


def _weighted_mean(values: np.ndarray, weight: Optional[np.ndarray]) -> float:
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


class Metric:
    higher_better = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self.metadata = metadata

    @property
    def names(self) -> List[str]:
        return [self.name]

    def eval(self, score: np.ndarray, objective) -> List[float]:
        raise NotImplementedError

    def _convert(self, score: np.ndarray, objective) -> np.ndarray:
        if objective is not None:
            import torch
            out = objective.convert_output(
                torch.as_tensor(np.asarray(score, dtype=np.float32)))
            return out.numpy()
        return score


class _PointwiseRegression(Metric):
    """Template for averaged pointwise losses
    (reference: regression_metric.hpp:22 RegressionMetric<T>)."""

    def point_loss(self, y, p):
        raise NotImplementedError

    def transform(self, v: float) -> float:
        return v

    def eval(self, score, objective):
        p = self._convert(score, objective).reshape(-1)
        loss = self.point_loss(self.label, p)
        return [self.transform(_weighted_mean(loss, self.weight))]


class L2Metric(_PointwiseRegression):
    name = "l2"

    def point_loss(self, y, p):
        return (y - p) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def transform(self, v):
        return math.sqrt(v)


class L1Metric(_PointwiseRegression):
    name = "l1"

    def point_loss(self, y, p):
        return np.abs(y - p)


class QuantileMetric(_PointwiseRegression):
    name = "quantile"

    def point_loss(self, y, p):
        a = self.config.alpha
        d = y - p
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseRegression):
    name = "huber"

    def point_loss(self, y, p):
        a = self.config.alpha
        d = np.abs(y - p)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegression):
    name = "fair"

    def point_loss(self, y, p):
        c = self.config.fair_c
        x = np.abs(y - p)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegression):
    name = "poisson"

    def point_loss(self, y, p):
        eps = 1e-10
        return p - y * np.log(np.maximum(p, eps))


class MAPEMetric(_PointwiseRegression):
    name = "mape"

    def point_loss(self, y, p):
        return np.abs((y - p) / np.maximum(1.0, np.abs(y)))


class GammaMetric(_PointwiseRegression):
    name = "gamma"

    def point_loss(self, y, p):
        eps = 1e-10
        psafe = np.maximum(p, eps)
        return y / psafe + np.log(psafe)  # negative log-likelihood (shape=1)


class GammaDevianceMetric(_PointwiseRegression):
    name = "gamma_deviance"

    def point_loss(self, y, p):
        eps = 1e-10
        frac = y / np.maximum(p, eps)
        return 2.0 * (frac - np.log(np.maximum(frac, eps)) - 1.0)


class TweedieMetric(_PointwiseRegression):
    name = "tweedie"

    def point_loss(self, y, p):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        psafe = np.maximum(p, eps)
        a = y * np.power(psafe, 1.0 - rho) / (1.0 - rho)
        b = np.power(psafe, 2.0 - rho) / (2.0 - rho)
        return -a + b


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective):
        p = np.clip(self._convert(score, objective).reshape(-1), 1e-15, 1 - 1e-15)
        y = (self.label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [_weighted_mean(loss, self.weight)]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score, objective):
        p = self._convert(score, objective).reshape(-1)
        y = (self.label > 0).astype(np.float64)
        err = ((p > 0.5) != (y > 0)).astype(np.float64)
        return [_weighted_mean(err, self.weight)]


class AUCMetric(Metric):
    """Weighted sort-based AUC (reference: binary_metric.hpp:159)."""
    name = "auc"
    higher_better = True

    def eval(self, score, objective):
        s = np.asarray(score).reshape(-1)
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-s, kind="stable")
        s_s, y_s, w_s = s[order], y[order], w[order]
        pos_w = y_s * w_s
        neg_w = (1 - y_s) * w_s
        # handle ties: group by equal score
        boundary = np.concatenate([[True], s_s[1:] != s_s[:-1]])
        group = np.cumsum(boundary) - 1
        n_groups = group[-1] + 1
        gpos = np.bincount(group, weights=pos_w, minlength=n_groups)
        gneg = np.bincount(group, weights=neg_w, minlength=n_groups)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(gneg)[:-1]])
        auc_sum = np.sum(gpos * (cum_neg_before + 0.5 * gneg))
        total_pos = pos_w.sum()
        total_neg = neg_w.sum()
        if total_pos == 0 or total_neg == 0:
            return [1.0]
        # reference accumulates pos-above-neg; ours counts neg ranked below
        return [1.0 - auc_sum / (total_pos * total_neg)]


class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score, objective):
        p = self._convert(score, objective)  # (K, N)
        y = self.label.astype(np.int64)
        py = np.clip(p[y, np.arange(len(y))], 1e-15, None)
        return [_weighted_mean(-np.log(py), self.weight)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score, objective):
        p = self._convert(score, objective)
        pred = np.argmax(p, axis=0)
        err = (pred != self.label.astype(np.int64)).astype(np.float64)
        return [_weighted_mean(err, self.weight)]


class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, score, objective):
        p = np.clip(self._convert(score, objective).reshape(-1), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [_weighted_mean(loss, self.weight)]


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score, objective):
        # score -> lambda parameterization (reference xentropy_metric.hpp:166)
        s = np.asarray(score).reshape(-1)
        hhat = np.log1p(np.exp(s))
        w = self.weight if self.weight is not None else np.ones_like(s)
        z = np.clip(1.0 - np.exp(-w * hhat), 1e-15, 1 - 1e-15)
        y = self.label
        loss = -(y * np.log(z) + (1 - y) * np.log(1 - z))
        return [float(np.mean(loss))]


class KLDivMetric(Metric):
    name = "kldiv"

    def eval(self, score, objective):
        p = np.clip(self._convert(score, objective).reshape(-1), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        kl = (y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p)))
        return [_weighted_mean(kl, self.weight)]


def _query_slots(query_boundaries, values, fill):
    """(Q, L) per-query layout of the (N,) `values`: row i of query q at
    [q, i - start], `fill` past each query's end; and the (Q,) counts."""
    idx, mask, counts = query_slots(query_boundaries)
    return np.where(mask, np.asarray(values)[idx], fill), counts


def _ranked(query_boundaries, score, values):
    """`values` in each query's order of decreasing score (ties in row
    order, as a stable sort of -score), padded with 0 past its end; the
    (Q,) counts; and the (L,) positions."""
    s, counts = _query_slots(query_boundaries,
                             np.asarray(score, dtype=np.float64).reshape(-1),
                             -np.inf)
    v, _ = _query_slots(query_boundaries, values, 0.0)
    order = np.argsort(-s, axis=1, kind="stable")
    return (np.take_along_axis(v, order, axis=1), counts,
            np.arange(s.shape[1]))


class NDCGMetric(Metric):
    """NDCG at eval_at positions (reference: rank_metric.hpp:19 +
    dcg_calculator.cpp:42-129), every query weighing 1 as in the JAX
    package; a query without relevant documents scores 1. The JAX
    package's per-query loop, over (Q, L) padded arrays."""
    name = "ndcg"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("NDCG metric requires query information")
        self.eval_at = [int(k) for k in (self.config.eval_at
                                         or [1, 2, 3, 4, 5])]
        self.label_gain = np.asarray(self.config.label_gain,
                                     dtype=np.float64)

    @property
    def names(self):
        return [f"ndcg@{k}" for k in self.eval_at]

    def eval(self, score, objective):
        qb = self.metadata.query_boundaries
        gains = self.label_gain[self.label.astype(np.int64)]
        got, counts, pos = _ranked(qb, score, gains)
        ideal = -np.sort(-_query_slots(qb, gains, 0.0)[0], axis=1)
        disc = 1.0 / np.log2(pos + 2.0)
        out = []
        for k in self.eval_at:
            top = pos[None, :] < np.minimum(k, counts)[:, None]
            max_dcg = np.where(top, ideal * disc, 0.0).sum(axis=1)
            dcg = np.where(top, got * disc, 0.0).sum(axis=1)
            per_query = np.where(
                max_dcg <= 0, 1.0,
                dcg / np.where(max_dcg <= 0, 1.0, max_dcg))
            out.append(float(per_query.sum() / max(len(counts), 1)))
        return out


class MapMetric(Metric):
    """Mean average precision at eval_at positions (reference:
    map_metric.hpp:20): the JAX package's per-query loop over (Q, L)
    padded arrays."""
    name = "map"
    higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("MAP metric requires query information")
        self.eval_at = [int(k) for k in (self.config.eval_at
                                         or [1, 2, 3, 4, 5])]

    @property
    def names(self):
        return [f"map@{k}" for k in self.eval_at]

    def eval(self, score, objective):
        qb = self.metadata.query_boundaries
        rel = (self.label > 0).astype(np.float64)
        rel_sorted, counts, pos = _ranked(qb, score, rel)
        prec = np.cumsum(rel_sorted, axis=1) / (pos + 1.0)
        n_rel = _query_slots(qb, rel, 0.0)[0].sum(axis=1).astype(np.int64)
        out = []
        for k in self.eval_at:
            kk = np.minimum(k, counts)
            top = pos[None, :] < kk[:, None]
            denom = np.minimum(kk, n_rel)
            denom = np.where(denom == 0, 1, denom)
            hits = np.where(top, prec * rel_sorted, 0.0).sum(axis=1)
            out.append(float((hits / denom).sum() / max(len(counts), 1)))
        return out


_CLASSES = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "multi_logloss": MultiLoglossMetric,
    "multi_error": MultiErrorMetric, "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric, "kldiv": KLDivMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
}

METRIC_NAMES = sorted(_CLASSES)

# objective name -> default metric (reference: config metric defaulting)
_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "lambdarank": "ndcg",
}



def create_metric(name: str, config) -> Optional[Metric]:
    name = str(name).lower()
    if name in ("", "none", "null", "na", "custom"):
        return None
    cls = _CLASSES.get(name)
    if cls is None:
        log.warning("Unknown metric type name: %s", name)
        return None
    return cls(config)


def create_metrics(metric_names: Sequence[str], config,
                   objective_name: str) -> List[Metric]:
    names = list(metric_names or [])
    if not names:
        default = _DEFAULT_FOR_OBJECTIVE.get(objective_name)
        names = [default] if default else []
    out = []
    for n in names:
        m = create_metric(n, config)
        if m is not None:
            out.append(m)
    return out
