"""Environment knobs of the port (copied from lightgbm_tpu/utils/envs.py
where the port has the feature)."""
from __future__ import annotations

import os


def strategy_env(default: str = "auto") -> str:
    """LGBM_TPU_STRATEGY: auto | masked | compact | chunk -- the growth
    strategy read by the device learner's resolve_strategy."""
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


def chunk_rows_env() -> int:
    """LGBM_TPU_CHUNK: the chunk core's rows per chunk (CH), floored at
    8,192; default 65,536 (the JAX package's)."""
    return max(8192, int(os.environ.get("LGBM_TPU_CHUNK", "65536")))


def chunk_fuse_hist_env() -> bool:
    """False when LGBM_TPU_CHUNK_NO_FUSE_HIST is 1 / true / yes / on (the
    JAX package's flag): the chunk core then builds the smaller child's
    histogram in a pass of its own after the move, not inside the move
    passes."""
    return os.environ.get("LGBM_TPU_CHUNK_NO_FUSE_HIST", "0").strip() \
        .lower() not in ("1", "true", "yes", "on")
