"""Non-finite sentries + loss-spike recovery (port of
lightgbm_tpu/resilience/sentries.py).

Iteration boundaries are the natural consistency points of GBDT, so
guards live there: one device reduction over the iteration's operands —
gradients/hessians on the generic path (``all_finite``: one host bool,
the policy's one sync), the updated score row on the fused path (the
finite flag the fused step computes on the device and the tree's one
fetch brings back, so guarding adds no sync there) — and a host-side
policy dispatch.

Policies (`on_nonfinite` parameter, dispatched in models/gbdt.py):

* ``raise``      — stop with NonFiniteError naming the iteration.
* ``skip_iter``  — drop the iteration (no tree, no score change); the
                   iteration counter advances so seeds keep moving.
* ``rollback``   — undo the previous iteration (whose tree corrupted the
                   scores, or simply re-establish a known-good state),
                   recompute gradients once, and continue; a second
                   consecutive failure raises.

The loss-spike detector is a callback: if the training metric worsens by
more than `threshold` (relative), the last iteration is rolled back and
the learning rate optionally cut — the boosting-level analog of gradient
clipping.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils import log
from ..utils.log import LightGBMError

__all__ = ["NonFiniteError", "all_finite", "loss_spike_guard", "POLICIES"]

POLICIES = ("off", "raise", "skip_iter", "rollback")


class NonFiniteError(LightGBMError):
    """Non-finite values detected in a guarded training step."""


def all_finite(*arrays) -> bool:
    """ONE device reduction over any number of tensors (isfinite, all,
    and-ed on the device); the bool() is the only host sync."""
    flag = None
    for a in arrays:
        ok = torch.isfinite(torch.as_tensor(a)).all()
        flag = ok if flag is None else flag & ok.to(flag.device)
    return True if flag is None else bool(flag)


def loss_spike_guard(threshold: float = 2.0, lr_cut: float = 1.0,
                     verbose: bool = True) -> Callable:
    """Callback: watch the training metric; on a relative worsening
    > `threshold` (or a non-finite value), roll back the iteration and
    multiply the learning rate by `lr_cut` (1.0 = keep it).

    Runs at order 22 — after record_evaluation, before early stopping —
    so a rolled-back spike cannot trip the early-stopping counters of
    later, healthier iterations.
    """
    if threshold <= 0:
        raise ValueError("threshold must be positive")
    if not (0.0 < lr_cut <= 1.0):
        raise ValueError("lr_cut must be in (0, 1]")
    state = {"prev": None, "rollbacks": 0}

    def _train_entry(env):
        train_name = getattr(env.model, "_train_data_name", "training")
        for item in env.evaluation_result_list or []:
            if item[0] in (train_name, "training"):
                return float(item[2]), bool(item[3])
        return None

    def _callback(env) -> None:
        import math
        entry = _train_entry(env)
        if entry is None:
            return
        val, higher_better = entry
        prev = state["prev"]
        if prev is None or not math.isfinite(prev):
            state["prev"] = val
            return
        denom = max(abs(prev), 1e-12)
        worsening = ((prev - val) if higher_better else (val - prev)) / denom
        if math.isfinite(val) and worsening <= threshold:
            state["prev"] = val
            return
        state["rollbacks"] += 1
        if verbose:
            log.warning(
                "loss spike at iteration %d (train metric %g -> %g): "
                "rolling back", env.iteration + 1, prev, val)
        from ..telemetry import events as telem_events
        telem_events.emit("rollback", iteration=env.iteration,
                          reason="loss_spike", prev=prev, value=val)
        env.model.rollback_one_iter()
        if lr_cut < 1.0 and hasattr(env.model, "reset_parameter"):
            cur = float(env.params.get("learning_rate", 0.1))
            new_lr = cur * lr_cut
            env.model.reset_parameter({"learning_rate": new_lr})
            env.params["learning_rate"] = new_lr
            if verbose:
                log.warning("loss spike: learning_rate cut %g -> %g",
                            cur, new_lr)
        # prev stays at the pre-spike value: the retrained iteration is
        # judged against the last healthy state
    _callback.order = 22
    _callback._spike_state = state
    return _callback
