"""Environment knobs of the port (copied from lightgbm_tpu/utils/envs.py
where the port has the feature)."""
from __future__ import annotations

import os


def strategy_env(default: str = "auto") -> str:
    """LGBM_TPU_STRATEGY: auto | masked | compact -- the growth strategy
    read by the device learner's resolve_strategy (the JAX package also
    takes chunk, which this port refuses)."""
    return os.environ.get("LGBM_TPU_STRATEGY", default).strip().lower()
