"""Objective functions as torch tensor math.

Port of the binary and L2 objectives of lightgbm_tpu/objectives/
objective.py (reference: src/objective/{regression,binary}_objective.hpp):
the same gradients and hessians, boost-from-score, output transform and
model-text name. Labels and weights live on the device the objective is
initialised for; scores arrive there as (N,) f32 tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils import log

K_EPSILON = 1e-15


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


_CLASSES = {
    "regression": RegressionL2,
    "binary": BinaryLogloss,
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
    'binary sigmoid:1'."""
    parts = text.strip().split()
    if not parts:
        return None
    name = parts[0]
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "sigmoid":
                config.sigmoid = float(v)
    return create_objective(name, config)
