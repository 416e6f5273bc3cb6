"""Drift monitors: training-time baselines vs served-traffic windows (port
of lightgbm_tpu/serving/drift.py; the same sidecar format both ways).

The continual-learning loop needs a trigger: "the traffic
this model serves no longer looks like the data it trained on". This
module supplies it in two halves:

* **Baseline capture** (training side) — `compute_baseline(dataset,
  scores)` records, per used numerical feature, the binning edges the
  model actually trained with (BinMapper.bin_upper_bound, merged down
  to at most DRIFT_BINS quantile-shaped groups so a finite serving
  window's sampling noise stays far below the PSI threshold) and the
  bin occupancy over the train set (one `np.bincount` per feature over
  `Dataset.binned` — the codes already exist, capture is cheap), plus a
  decile histogram of the *converted* train scores (the same
  objective transform serving applies by default, so served
  predictions are comparable). The baseline is a small JSON-able dict:
  the CLI writes it to a ``<model>.drift.json`` sidecar next to the
  model (model text stays bit-identical).

* **DriftMonitor** (serving side, numpy-only) — keeps a sliding window
  of served rows/scores binned by the *baseline's* edges and computes
  PSI (population stability index) per feature and for the score
  distribution:  ``psi = sum((p - q) * ln(p / q))`` with epsilon
  smoothing. Above threshold it fires the ``drift_psi`` watchdog
  (telemetry/watchdogs.fire_drift → watchdog_fires counter + watchdog
  event — which the canary router's existing watchdog gate turns into
  a demotion input) and emits a ``drift`` event with the full PSI
  snapshot for run reports. Checks are throttled (every `check_every`
  rows once `min_rows` are windowed) and a fire arms a one-window
  cooldown, so a drifted stream alarms once per window, not per row.

The conventional PSI folklore thresholds: < 0.1 stable, 0.1–0.25
moderate shift, > 0.25 action; the default threshold (0.2, the
``drift_psi_threshold`` param / watchdogs `drift_psi` knob) sits in
that band. Same-distribution windows land well under 0.05 with the
epsilon smoothing, which is the false-positive guard the tests pin.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..telemetry import events, watchdogs

__all__ = ["compute_baseline", "save_baseline", "load_baseline",
           "psi", "DriftMonitor", "BASELINE_FORMAT"]

BASELINE_FORMAT = "lgbm_tpu_drift_baseline"
SCORE_BINS = 10
DRIFT_BINS = 16
_EPS = 1e-4


def psi(expected, observed) -> float:
    """Population stability index between two occupancy vectors
    (epsilon-smoothed + renormalized, so empty bins don't blow up)."""
    p = np.asarray(expected, dtype=np.float64) + _EPS
    q = np.asarray(observed, dtype=np.float64) + _EPS
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((p - q) * np.log(p / q)))


def _coarsen(edges: List[float], occ: np.ndarray,
             has_nan: bool) -> tuple:
    """Merge fine training bins into at most DRIFT_BINS roughly
    equal-occupancy groups (the trailing missing bin stays its own
    group). PSI over a finite window carries ~(bins-1)/window of pure
    sampling noise, so judging a 512-row serving window against 255
    training bins would fire on noise alone; 16 merged bins keep the
    noise floor well under the 0.2 threshold while quantile-shaped
    groups stay sensitive to real shift."""
    nan_occ = occ[-1] if has_nan else None
    core = occ[:-1] if has_nan else occ       # aligned with edges+1
    if core.size <= DRIFT_BINS:
        return edges, occ
    target = core.sum() / DRIFT_BINS
    new_edges: List[float] = []
    new_occ: List[float] = []
    acc = 0.0
    for i, v in enumerate(core):
        acc += float(v)
        if (acc >= target and i < core.size - 1
                and len(new_edges) < DRIFT_BINS - 1):
            new_edges.append(edges[i])        # group's upper bound
            new_occ.append(acc)
            acc = 0.0
    new_occ.append(acc)
    if nan_occ is not None:
        new_occ.append(float(nan_occ))
    return new_edges, np.asarray(new_occ, dtype=np.float64)


def compute_baseline(dataset, scores=None) -> dict:
    """Capture the drift baseline from a binned training Dataset (+
    optionally the converted train scores). Only numerical features
    carry edges a standalone monitor can re-apply; categorical features
    are skipped."""
    from ..io.binning import BIN_NUMERICAL
    features: List[dict] = []
    n = int(dataset.binned.shape[0]) if dataset.binned is not None else 0
    for j, f in enumerate(getattr(dataset, "used_features", [])):
        mapper = dataset.bin_mappers[f]
        if mapper.bin_type != BIN_NUMERICAL:
            continue
        edges = [float(b) for b in mapper.bin_upper_bound
                 if math.isfinite(b)]
        has_nan = bool(mapper.bin_upper_bound
                       and isinstance(mapper.bin_upper_bound[-1], float)
                       and math.isnan(mapper.bin_upper_bound[-1]))
        num_bins = len(edges) + 1 + (1 if has_nan else 0)
        codes = np.asarray(dataset.binned[:, j]).astype(np.int64)
        occ = np.bincount(codes, minlength=num_bins).astype(np.float64)
        total = occ.sum()
        if total <= 0:
            continue
        edges, occ = _coarsen(edges, occ, has_nan)
        features.append({"index": int(f), "edges": edges,
                         "has_nan": has_nan,
                         "occupancy": [round(float(v), 8)
                                       for v in occ / occ.sum()]})
    baseline = {"format": BASELINE_FORMAT, "version": 1,
                "n_rows": n, "features": features}
    if scores is not None:
        s = np.asarray(scores, dtype=np.float64).ravel()
        if s.size:
            qs = [i / SCORE_BINS for i in range(1, SCORE_BINS)]
            edges = np.quantile(s, qs)
            codes = np.searchsorted(edges, s, side="left")
            occ = np.bincount(codes,
                              minlength=SCORE_BINS).astype(np.float64)
            baseline["score"] = {
                "edges": [float(e) for e in edges],
                "occupancy": [round(float(v), 8)
                              for v in occ / occ.sum()]}
    return baseline


def save_baseline(baseline: dict, path: str) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(baseline, fh, sort_keys=True)
    return path


def load_baseline(path: str) -> Optional[dict]:
    """Read a baseline sidecar; None when missing/unreadable (serving
    without drift monitoring beats not serving)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            baseline = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if baseline.get("format") != BASELINE_FORMAT:
        return None
    return baseline


class _Window:
    """Fixed-size ring of bin codes. Pushes are vectorized block
    writes; occupancy is one bincount over the valid region at check
    time (the ring is small — recount beats bookkeeping)."""

    def __init__(self, num_bins: int, window: int):
        self.codes = np.zeros(window, dtype=np.int32)
        self.num_bins = num_bins
        self.window = window
        self.idx = 0
        self.size = 0

    def push(self, codes: np.ndarray) -> None:
        codes = np.asarray(codes, dtype=np.int32).ravel()
        if codes.size > self.window:
            codes = codes[-self.window:]
        k = codes.size
        end = self.idx + k
        if end <= self.window:
            self.codes[self.idx:end] = codes
        else:
            split = self.window - self.idx
            self.codes[self.idx:] = codes[:split]
            self.codes[:end - self.window] = codes[split:]
        self.idx = end % self.window
        self.size = min(self.window, self.size + k)

    def occupancy(self) -> np.ndarray:
        return np.bincount(self.codes[:self.size],
                           minlength=self.num_bins)


class DriftMonitor:
    """Sliding-window PSI monitor over served traffic, judged against a
    training-time baseline (see module docstring)."""

    def __init__(self, baseline: dict, threshold: Optional[float] = None,
                 window: int = 512, min_rows: int = 256,
                 check_every: int = 64, min_interval_s: float = 1.0):
        self.threshold = (float(threshold) if threshold is not None
                          else watchdogs.drift_threshold())
        self.window = int(window)
        self.min_rows = int(min_rows)
        self.check_every = max(1, int(check_every))
        # rate limit on top of the row throttle: under large-batch
        # traffic every request crosses the row boundary, and on a
        # small host a busy evaluation worker steals cycles from the
        # request path. Drift is a minutes-scale phenomenon; 1 Hz
        # evaluation of a 512-row window is plenty. 0 disables (tests).
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._features: List[dict] = []
        for feat in baseline.get("features", []):
            num_bins = (len(feat["edges"]) + 1
                        + (1 if feat.get("has_nan") else 0))
            self._features.append({
                "index": int(feat["index"]),
                "edges": np.asarray(feat["edges"], dtype=np.float64),
                "has_nan": bool(feat.get("has_nan")),
                "expected": np.asarray(feat["occupancy"],
                                       dtype=np.float64),
                "win": _Window(num_bins, self.window)})
        score = baseline.get("score")
        self._score = None
        if score and score.get("edges"):
            self._score = {
                "edges": np.asarray(score["edges"], dtype=np.float64),
                "expected": np.asarray(score["occupancy"],
                                       dtype=np.float64),
                "win": _Window(SCORE_BINS, self.window)}
        self._pending: List[tuple] = []
        self._pending_rows = 0
        self._rows = 0
        self._next_check = self.min_rows
        self._cooldown_until = 0
        self._fires = 0
        self._last_psi: Dict[str, float] = {}
        self._version: Optional[str] = None
        self._last_check_t = 0.0
        # serializes evaluations; distinct from _lock (the pending
        # buffer) so a running check never blocks the request path
        self._eval_lock = threading.Lock()
        self._wake = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # -- request path ----------------------------------------------------
    def observe(self, rows, preds=None,
                version: Optional[str] = None) -> None:
        """Buffer one request's rows (+ served predictions). The
        request path never bins or computes PSI — crossing the check
        boundary just wakes the evaluation worker, so the per-request
        cost is a lock + list append; the check itself runs
        off-thread)."""
        if not self._features and self._score is None:
            return
        # no dtype conversion here — copying a float32 batch on the
        # request path costs more than everything else in this method;
        # the worker converts when it bins
        x = np.asarray(rows)
        if x.ndim == 1:
            x = x.reshape(1, -1)
        with self._lock:
            self._pending.append((x, preds))
            self._pending_rows += x.shape[0]
            self._rows += x.shape[0]
            if version is not None:
                self._version = version
            # only the newest `window` rows can survive in the ring —
            # drop whole buffered blocks the next check would overwrite
            # anyway, so the worker's bill stays O(window) no matter
            # how much traffic arrived since the last check
            while (self._pending_rows - self._pending[0][0].shape[0]
                   >= self.window):
                self._pending_rows -= self._pending.pop(0)[0].shape[0]
            if self._rows < self._next_check:
                return
            now = time.monotonic()
            if now - self._last_check_t < self.min_interval_s:
                return               # retry on a later request
            self._last_check_t = now
            self._next_check = self._rows + self.check_every
            if self._worker is None and not self._closed:
                self._worker = threading.Thread(
                    target=self._loop, name="drift-monitor", daemon=True)
                self._worker.start()
        self._wake.set()

    # -- evaluation (worker thread / explicit) ---------------------------
    def _loop(self) -> None:
        while True:
            self._wake.wait()
            self._wake.clear()
            if self._closed:
                return
            self.check_now()

    def check_now(self) -> Dict[str, float]:
        """Bin buffered rows and run one PSI judgment synchronously
        (the worker's body; also the deterministic hook for tests).
        Only the pending-buffer swap holds the request-path lock; the
        windows and PSI math are worker-only state."""
        with self._eval_lock:
            with self._lock:
                pending, self._pending = self._pending, []
                self._pending_rows = 0
                version = self._version
            self._bin_pending(pending)
            psis = self._psi()
        self._judge(psis, version)
        return psis

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        worker = self._worker
        if worker is not None:
            worker.join(timeout=2.0)

    def _bin_pending(self, pending: List[tuple]) -> None:
        """Bin the buffered rows through the baseline's edges into the
        sliding windows (vectorized over the whole buffered block)."""
        if not pending:
            return
        x = (pending[0][0] if len(pending) == 1
             else np.concatenate([p[0] for p in pending], axis=0))
        x = np.asarray(x, dtype=np.float64)
        for feat in self._features:
            f = feat["index"]
            if f >= x.shape[1]:
                continue
            v = x[:, f]
            codes = np.searchsorted(feat["edges"], v, side="left")
            nan_mask = np.isnan(v)
            if nan_mask.any():
                # nan rides the trailing missing bin when the model
                # trained with one, else the overflow bin
                codes = np.where(nan_mask,
                                 feat["win"].num_bins - 1, codes)
            feat["win"].push(codes)
        if self._score is not None:
            preds = [p[1] for p in pending if p[1] is not None]
            if preds:
                s = np.concatenate(
                    [np.asarray(p, dtype=np.float64).ravel()
                     for p in preds])
                codes = np.searchsorted(self._score["edges"], s,
                                        side="left")
                self._score["win"].push(codes)

    def _psi(self) -> Dict[str, float]:
        psis: Dict[str, float] = {}
        for feat in self._features:
            win = feat["win"]
            if win.size < self.min_rows:
                continue
            psis[f"feature_{feat['index']}"] = round(
                psi(feat["expected"], win.occupancy()), 6)
        if self._score is not None \
                and self._score["win"].size >= self.min_rows:
            psis["score"] = round(
                psi(self._score["expected"],
                    self._score["win"].occupancy()), 6)
        with self._lock:
            self._last_psi = psis
        return psis

    def _judge(self, psis: Dict[str, float],
               version: Optional[str]) -> None:
        if not psis:
            return
        worst = max(psis, key=psis.get)
        worst_psi = psis[worst]
        if worst_psi <= self.threshold:
            return
        with self._lock:
            if self._rows < self._cooldown_until:
                return
            self._cooldown_until = self._rows + self.window
            self._fires += 1
        fired = watchdogs.fire_drift(worst, worst_psi, self.threshold,
                                     version=version)
        if fired:
            events.emit("drift", version=version, worst=worst,
                        psi=worst_psi, threshold=self.threshold,
                        rows=self._rows, window=self.window, psis=psis)

    def snapshot(self) -> dict:
        with self._lock:
            return {"rows": self._rows, "window": self.window,
                    "threshold": self.threshold, "fires": self._fires,
                    "psi": dict(self._last_psi)}
