"""Training entry point.

Port of lightgbm_tpu/engine.py::train (reference: python-package/lightgbm/
engine.py:18) without validation sets, callbacks, custom objectives or
resumption, which this slice does not carry yet: it boosts
``num_boost_round`` iterations, or until no split is found.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Booster, Dataset
from .utils.log import LightGBMError

__all__ = ["train"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, device=None, **kwargs) -> Booster:
    """Train a booster on the card (``device="cpu"`` runs the kernels'
    plain PyTorch versions on the CPU instead)."""
    unsupported = [k for k, v in kwargs.items() if v is not None]
    if unsupported:
        raise LightGBMError("train(%s=...) is not supported by "
                            "lightgbm_tpu_torch yet" % unsupported[0])
    params = copy.deepcopy(params or {})
    for key in ("num_boost_round", "num_iterations", "num_iteration",
                "n_iter", "num_tree", "num_trees", "num_round",
                "num_rounds", "n_estimators"):
        if key in params:
            num_boost_round = params.pop(key)
    for key in ("early_stopping_round", "early_stopping_rounds"):
        if params.get(key):
            raise LightGBMError("%s is not supported by lightgbm_tpu_torch "
                                "yet (no validation sets)" % key)
    booster = Booster(params=params, train_set=train_set, device=device)
    for _ in range(int(num_boost_round)):
        if booster.update():
            break
    return booster
