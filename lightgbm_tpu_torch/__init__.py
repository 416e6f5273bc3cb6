"""lightgbm_tpu_torch: the PyTorch / CUDA port of lightgbm_tpu.

It trains GBDT, GOSS, DART and random forest with every objective of the
JAX package (lambdarank over query groups too, and custom objectives)
on one NVIDIA H100 through the compact and masked growth cores, with
hand-written Hopper kernels for the histograms and the stable row
partition, evaluates validation sets with early stopping and callbacks,
cross-validates, writes and reads model text v2.3.1, predicts leaf
indices, TreeSHAP contributions and early-stopped scores, refits leaves
on new rows, reads CSV / TSV / LibSVM files and pandas frames, and has
the scikit-learn estimators. Training checkpoints and resumes (the JAX
package's checkpoint format), guards against non-finite values, injects
faults for tests, exits cleanly on preemption, and records telemetry.
It serves models online (`serving`: a bucketed predictor cache,
registry, micro-batcher and HTTP server; `fleet`: the canary router and
placement; `python -m lightgbm_tpu_torch task=serve`). It imports torch
and numpy, never jax nor lightgbm_tpu.

    import lightgbm_tpu_torch as lgb
    dtrain = lgb.Dataset(x, y)
    bst = lgb.train({"objective": "binary"}, dtrain, 100,
                    valid_sets=[dtrain.create_valid(xv, yv)],
                    early_stopping_rounds=5)
    p = bst.predict(x)

Entry points run on the card; ``device="cpu"`` runs the kernels' plain
PyTorch versions on the CPU instead.
"""
from . import telemetry
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, record_telemetry, reset_parameter)
from .engine import CVBooster, cv, train
from .sklearn import (LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor,
                      LightGBMNotFittedError)
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "train", "cv", "CVBooster",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "record_telemetry", "telemetry",
           "EarlyStopException", "LightGBMError",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
           "LightGBMNotFittedError"]
