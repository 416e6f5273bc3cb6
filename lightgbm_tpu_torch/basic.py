"""User-facing Dataset and Booster of the port.

Port of lightgbm_tpu/basic.py for the slices this package covers: binary
and L2 regression GBDT, serial learner, float or quantized gradients
(``quantized_grad``, ``grad_bits``, ``quant_renew``), the compact and
masked growth strategies, no sampling, no categorical features. Every
parameter outside that slice raises LightGBMError naming its key. Both
classes run on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np

from .config import Config
from .io.dataset import Dataset as _InnerDataset
from .metrics import METRIC_NAMES
from .models.gbdt import GBDT
from .objectives import OBJECTIVE_NAMES
from .utils.device import resolve_device
from .utils.log import LightGBMError


def check_supported(cfg: Config) -> None:
    """Raise LightGBMError for the first parameter outside the slice."""
    bad = None
    if cfg.objective not in OBJECTIVE_NAMES:
        bad = "objective=%s" % cfg.objective
    elif cfg.boosting not in ("gbdt", "gbrt", "plain"):
        bad = "boosting=%s" % cfg.boosting
    elif cfg.num_class > 1:
        bad = "num_class=%d" % cfg.num_class
    elif cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        bad = "bagging_fraction=%g" % cfg.bagging_fraction
    elif cfg.bagging_freq > 0 and cfg.pos_bagging_fraction < 1.0:
        bad = "pos_bagging_fraction=%g" % cfg.pos_bagging_fraction
    elif cfg.bagging_freq > 0 and cfg.neg_bagging_fraction < 1.0:
        bad = "neg_bagging_fraction=%g" % cfg.neg_bagging_fraction
    elif cfg.feature_fraction < 1.0:
        bad = "feature_fraction=%g" % cfg.feature_fraction
    elif cfg.feature_fraction_bynode < 1.0:
        bad = "feature_fraction_bynode=%g" % cfg.feature_fraction_bynode
    elif cfg.categorical_feature:
        bad = "categorical_feature"
    elif cfg.quantized_grad and cfg.tree_learner != "serial":
        bad = "quantized_grad with tree_learner=%s" % cfg.tree_learner
    elif cfg.tree_learner != "serial":
        bad = "tree_learner=%s" % cfg.tree_learner
    elif cfg.stream_mode != "off":
        bad = "stream_mode=%s" % cfg.stream_mode
    elif cfg.grow_program != "per_split":
        bad = "grow_program=%s" % cfg.grow_program
    elif cfg.forcedsplits_filename:
        bad = "forcedsplits_filename"
    elif cfg.cegb_tradeoff > 0 and (
            cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled
            or cfg.cegb_penalty_feature_lazy):
        bad = "cegb_tradeoff"
    elif cfg.on_nonfinite != "off":
        bad = "on_nonfinite=%s" % cfg.on_nonfinite
    elif cfg.two_round:
        bad = "two_round"
    else:
        unknown = [m for m in cfg.metric if m not in METRIC_NAMES]
        if unknown:
            bad = "metric=%s" % unknown[0]
    if bad is not None:
        raise LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                            "(binary/regression GBDT, serial learner, "
                            "float or quantized gradients, no sampling, "
                            "no categorical features)" % bad)


class Dataset:
    """Lazily constructed training data (reference: basic.py:711). The
    binning runs on the host; its device views are made on the device of
    the Booster that trains on it (``device``, if given, is the default
    for that Booster)."""

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name="auto", params=None, device=None):
        if isinstance(data, str):
            raise LightGBMError("file input is not supported by "
                                "lightgbm_tpu_torch yet; pass an array")
        self.data = data
        self.label = label
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.params = copy.deepcopy(params) or {}
        self.device = device
        self._inner: Optional[_InnerDataset] = None

    def construct(self) -> "Dataset":
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        check_supported(cfg)
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        self._inner = _InnerDataset(
            self.data, config=cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names)
        self.data = None
        return self

    def _update_params(self, params: Dict[str, Any]) -> None:
        if self._inner is None:
            self.params.update(params or {})


class Booster:
    """Training / prediction handle (reference: basic.py:1658)."""

    def __init__(self, params=None, train_set: Optional[Dataset] = None,
                 model_file=None, model_str=None, device=None):
        self.params = copy.deepcopy(params) or {}
        if device is None and train_set is not None:
            device = train_set.device
        self.device = resolve_device(device)
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set._update_params(self.params)
            train_set.construct()
            cfg = train_set._inner.config
            cfg.update(self.params)
            check_supported(cfg)
            self._gbdt = GBDT(cfg, train_set._inner, device=self.device)
            self.train_set = train_set
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._gbdt = GBDT.load_model_from_string(
                model_str, Config(self.params), device=self.device)
        else:
            raise TypeError("need at least one of train_set, model_file, "
                            "model_str")

    def update(self) -> bool:
        """One boosting iteration; True when training stopped early."""
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def eval_train(self):
        return self._gbdt.eval_metrics()

    def predict(self, data, num_iteration=None, raw_score=False,
                start_iteration=0):
        if hasattr(data, "values"):
            data = data.values
        return self._gbdt.predict(np.asarray(data),
                                  num_iteration=num_iteration,
                                  raw_score=raw_score,
                                  start_iteration=start_iteration)

    def model_to_string(self, num_iteration=-1, start_iteration=0) -> str:
        return self._gbdt.save_model_to_string(start_iteration, num_iteration)

    def save_model(self, filename, num_iteration=-1,
                   start_iteration=0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self
