"""Carry models between the JAX package and the port.

A GBDT's weights are its trees. Two routes bring a model the JAX package
made into the port, so both packages predict from the same model:

* ``booster_from_model_string``: model text v2.3.1, as
  ``lightgbm_tpu.Booster.model_to_string`` writes it;
* ``ensemble_from_arrays``: the numpy form of the padded ensemble arrays
  that ``lightgbm_tpu.ops.predict.trees_to_arrays`` builds.
"""
from __future__ import annotations

from typing import Any, Mapping

from .basic import Booster
from .ops.predict import EnsembleArrays, ensemble_from_numpy
from .utils.device import resolve_device


def booster_from_model_string(text: str, device=None) -> Booster:
    """A port Booster that predicts with the trees of `text`."""
    return Booster(model_str=text, device=device)


def ensemble_from_arrays(arrays: Mapping[str, Any],
                         device=None) -> EnsembleArrays:
    """The port's ensemble tensors from the fields of a JAX EnsembleArrays
    as a mapping of host arrays (``{k: np.asarray(v) for k, v in
    arrays._asdict().items()}``); feed the result to
    ops.predict.predict_raw_ensemble."""
    return ensemble_from_numpy(
        *(arrays[k] for k in ("split_feature", "threshold", "threshold_bin",
                              "decision_type", "left_child", "right_child",
                              "leaf_value")),
        max_depth=int(arrays["max_depth"]), device=resolve_device(device),
        cat_boundaries=arrays.get("cat_boundaries"),
        cat_threshold=arrays.get("cat_threshold"))
