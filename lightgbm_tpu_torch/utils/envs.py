"""Environment knobs of the port (copied from lightgbm_tpu/utils/envs.py
where the port has the feature)."""
from __future__ import annotations

import os


def strategy_env(default: str = "auto") -> str:
    """LGBM_TPU_STRATEGY: auto | masked | compact -- the growth strategy
    read by the device learner's resolve_strategy (the JAX package also
    takes chunk, which this port refuses)."""
    return os.environ.get("LGBM_TPU_STRATEGY", default).strip().lower()


def host_learner_env() -> bool:
    """LGBM_TPU_HOST_LEARNER=1: create_tree_learner takes the host-loop
    SerialTreeLearner whatever the device learner supports."""
    return os.environ.get("LGBM_TPU_HOST_LEARNER", "0") == "1"


def host_refit_env() -> bool:
    """LGBM_TPU_HOST_REFIT=1: a refit sums each leaf's gradients in the
    host loop (GBDT._refit_leaves_host, the oracle) instead of one
    index_add_ on the device."""
    return os.environ.get("LGBM_TPU_HOST_REFIT", "0") == "1"
