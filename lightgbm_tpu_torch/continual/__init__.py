"""Closed-loop continual learning (port of lightgbm_tpu/continual/).

* `refit` -- leaf-value refit on the booster's device: one f64
  ``index_add_`` over the leaf routes (`Booster.refit`).
* `update` -- incremental continuation: bin fresh raw rows through the
  FROZEN BinMapper set and append them to a constructed Dataset (and to
  a live `DeviceDataShard` wire store), so an `init_model` warm-start
  top-up trains on history + fresh rows without re-binning history.
* `loop` -- the policy daemon: `drift_psi` watchdog fires -> refit or
  warm-continue per `continual_policy` -> checkpoint -> canary through
  the fleet router -> auto-promote / roll back on the audited gate
  (with the labelled-feedback AUC check of serving/feedback.py).
"""
from . import loop, refit, update

__all__ = ["loop", "refit", "update"]
