"""Evaluation metrics of the port: l2, rmse, binary_logloss and auc.

The subset of lightgbm_tpu/metrics/metric.py that the binary and
regression objectives use (reference: src/metric/{regression,binary}_
metric.hpp). Scores come
in raw; metrics apply the objective's ConvertOutput exactly like the
reference's Metric::Eval(score, objective) contract.

Port of lightgbm_tpu/metrics/metric.py: the reductions are host numpy on
fetched scores, as in the JAX package; only the objective's output
transform runs through torch (on the CPU).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

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


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score, objective):
        p = np.clip(self._convert(score, objective).reshape(-1), 1e-15, 1 - 1e-15)
        y = (self.label > 0).astype(np.float64)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [_weighted_mean(loss, self.weight)]


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


_CLASSES = {
    "l2": L2Metric, "rmse": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "auc": AUCMetric,
}

METRIC_NAMES = sorted(_CLASSES)

# objective name -> default metric (reference: config metric defaulting)
_DEFAULT_FOR_OBJECTIVE = {"regression": "l2", "binary": "binary_logloss"}


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
