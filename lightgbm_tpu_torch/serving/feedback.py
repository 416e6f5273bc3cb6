"""Labeled-feedback store: ground truth per answering version (port of
lightgbm_tpu/serving/feedback.py).

`POST /feedback` lands here: clients that later learn the true label
of a prediction post it back together with the score and the version
that answered (the predict response carries `version` for exactly this
round trip). The store keeps a bounded per-version window of
(label, score) pairs and computes AUC on demand — the quality half of
the canary promotion gate (`CanaryRouter` holds until the canary has
`feedback_min_labels` labels and demotes/holds when its AUC trails the
stable's by more than `feedback_auc_epsilon`).

AUC is the tie-corrected Mann-Whitney statistic (average ranks), so it
is exact for quantized/duplicate scores. Binary labels only — a label
is "positive" iff > 0.5; regression feedback would gate on a different
statistic and is out of scope here.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events

__all__ = ["FeedbackStore", "binary_auc"]


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> Optional[float]:
    """Tie-corrected Mann-Whitney AUC; None while only one class has
    been observed (the statistic is undefined there — callers treat
    None as "not enough evidence", never as 0)."""
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    pos = labels > 0.5
    npos = int(pos.sum())
    nneg = int(labels.size - npos)
    if npos == 0 or nneg == 0:
        return None
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    s_sorted = scores[order]
    i = 0
    while i < s_sorted.size:
        j = i
        while j + 1 < s_sorted.size and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0   # average 1-based rank
        i = j + 1
    return float((ranks[pos].sum() - npos * (npos + 1) / 2.0)
                 / (npos * nneg))


class FeedbackStore:
    """Bounded per-version (label, score) windows, thread-safe."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._labels: Dict[str, List[float]] = {}
        self._scores: Dict[str, List[float]] = {}

    def record(self, version: str, labels, scores) -> int:
        """Append one feedback batch against `version`; returns the
        number of labels now held for it."""
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        if labels.size != scores.size:
            raise ValueError(
                f"feedback labels ({labels.size}) and scores "
                f"({scores.size}) must align")
        with self._lock:
            ls = self._labels.setdefault(version, [])
            ss = self._scores.setdefault(version, [])
            ls.extend(float(v) for v in labels)
            ss.extend(float(v) for v in scores)
            if len(ls) > self.capacity:
                del ls[:len(ls) - self.capacity]
                del ss[:len(ss) - self.capacity]
            count = len(ls)
        telem_counters.incr("serve_feedback_labels", float(labels.size))
        telem_events.emit("serve_feedback", version=version,
                          labels=int(labels.size), total=count)
        return count

    def auc(self, version: Optional[str]) -> Tuple[Optional[float], int]:
        """(AUC or None, label count) for one version's window."""
        if version is None:
            return None, 0
        with self._lock:
            ls = list(self._labels.get(version) or [])
            ss = list(self._scores.get(version) or [])
        if not ls:
            return None, 0
        return binary_auc(np.asarray(ls), np.asarray(ss)), len(ls)

    def labels(self, version: str) -> int:
        with self._lock:
            return len(self._labels.get(version) or [])

    def reset(self, version: Optional[str] = None) -> None:
        with self._lock:
            if version is None:
                self._labels.clear()
                self._scores.clear()
            else:
                self._labels.pop(version, None)
                self._scores.pop(version, None)

    def snapshot(self) -> dict:
        with self._lock:
            versions = sorted(self._labels)
            counts = {v: len(self._labels[v]) for v in versions}
        out = {}
        for v in versions:
            auc, n = self.auc(v)
            out[v] = {"labels": counts[v],
                      "auc": (round(auc, 6) if auc is not None else None),
                      "window": n}
        return {"capacity": self.capacity, "versions": out}
