"""Versioned model registry with warm-up and hot swap (port of
lightgbm_tpu/serving/registry.py).

The serving unit of deployment is a PreparedModel: tensorized once
(through the GBDT's bucketed ensemble arrays), warmed by building the
predictor cache's entries for the configured batch buckets, then
published atomically. Readers never see a half-loaded model: `get()`
resolves against an immutable snapshot, and swapping is one dict+pointer
update under the lock. Old versions stay queryable until `unload()`.

Models load on the registry's device: the card unless ``device="cpu"``
(without a card the constructor raises); a placement plan overrides it
per version. Model text written by either package loads. With an
`export_cache` (fleet.ExportCache) a load restores the model's cached
entries before its warm-up and saves them after it, so a restarted
replica installs the entries it had warm instead of building them.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..utils import log
from ..utils.timer import timer
from .predictor import PredictorCache, PreparedModel, _concrete

DEFAULT_WARM_BUCKETS = (1, 16, 256)


class ModelNotFound(KeyError):
    pass


class ModelRegistry:
    """Holds live model versions and the shared predictor cache."""

    def __init__(self, predictor: Optional[PredictorCache] = None,
                 warm_buckets: Sequence[int] = DEFAULT_WARM_BUCKETS,
                 warm_raw_score: Sequence[bool] = (False,),
                 export_cache=None, placement=None, device=None):
        self.device = _concrete(device)
        self.predictor = predictor or PredictorCache()
        self.warm_buckets = tuple(warm_buckets)
        self.warm_raw_score = tuple(warm_raw_score)
        # fleet hooks: a fleet.ExportCache persists which entries were
        # warm; a fleet.PlacementPlan pins versions to distinct cards
        # (None: every version on `device`)
        self.export_cache = export_cache
        self.placement = placement
        self._lock = threading.RLock()
        self._models: Dict[str, PreparedModel] = {}
        self._latest: Optional[str] = None
        self._pinned_versions: Dict[str, tuple] = {}
        self._version_counter = itertools.count(1)
        # version -> training-time drift baseline (serving.drift),
        # auto-discovered from a <model>.drift.json sidecar or the
        # booster's cached baseline at load()
        self.drift_baselines: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    def load(self, source, version: Optional[str] = None,
             num_iteration: Optional[int] = None,
             warm: bool = True) -> str:
        """Prepare `source` (Booster, GBDT, model string, or model file
        path) for serving and publish it as `version` (auto 'v<N>' when
        None). Warm-up happens BEFORE publication, so a hot swap never
        exposes a cold model to traffic. Returns the version id."""
        gbdt = self._to_gbdt(source)
        if num_iteration is None:
            # parity with Booster.predict: an early-stopped booster
            # serves its best iteration unless told otherwise
            best = getattr(source, "best_iteration", -1)
            if isinstance(best, int) and best > 0:
                num_iteration = best
        with self._lock:
            ver = version or f"v{next(self._version_counter)}"
            if ver in self._models:
                raise ValueError(f"model version {ver!r} already loaded")
        from ..telemetry import events as telem_events
        with timer("serve_model_load"):
            t0 = time.monotonic()
            device = (self.placement.assign(ver)
                      if self.placement is not None else self.device)
            prepared = PreparedModel(gbdt, ver, num_iteration,
                                     device=device)
            restored = {}
            if self.export_cache is not None:
                # install the cached entries BEFORE warm-up: a full
                # restore turns the warm loop below into pure hits (no
                # entry built) -- the fleet restart property
                restored = self.export_cache.restore(
                    prepared, self.predictor, self.warm_buckets,
                    self.warm_raw_score)
            if warm:
                for raw in self.warm_raw_score:
                    for b in self.warm_buckets:
                        self.predictor.warm(prepared, b, raw_score=raw)
                telem_events.emit(
                    "serve_warmup", version=ver,
                    buckets=list(self.warm_buckets),
                    restored=restored.get("restored", 0),
                    warm_s=round(time.monotonic() - t0, 6))
            if self.export_cache is not None:
                self.export_cache.save(prepared, self.predictor)
        baseline = self._discover_drift_baseline(source)
        with self._lock:
            previous = self._latest
            self._models[ver] = prepared
            self._latest = ver
            if baseline is not None:
                self.drift_baselines[ver] = baseline
        telem_events.emit("serve_swap", version=ver, previous=previous)
        log.info("serving: loaded model %s (%d trees, %d features)",
                 ver, prepared.n_trees, prepared.num_features)
        return ver

    def _discover_drift_baseline(self, source) -> Optional[dict]:
        """Find the training-time drift baseline that rode along with
        `source`: a ``<path>.drift.json`` sidecar when loading from a
        model file, or the baseline cached on a live Booster/GBDT."""
        from . import drift as serve_drift
        if isinstance(source, str) and "\n" not in source \
                and "Tree=" not in source and os.path.exists(
                    source + ".drift.json"):
            return serve_drift.load_baseline(source + ".drift.json")
        gbdt = (source._gbdt if hasattr(source, "_gbdt") else source)
        cached = getattr(gbdt, "_drift_baseline", None)
        return cached if isinstance(cached, dict) else None

    def _to_gbdt(self, source):
        if hasattr(source, "_gbdt"):           # Booster
            return source._gbdt
        if hasattr(source, "ensemble_arrays"):  # GBDT
            return source
        from ..models.gbdt import GBDT
        if isinstance(source, str):
            if "\n" in source or "Tree=" in source:
                return GBDT.load_model_from_string(source,
                                                   device=self.device)
            return GBDT.load_model(source, device=self.device)
        raise TypeError(f"cannot load model from {type(source).__name__}")

    # ------------------------------------------------------------------
    def get(self, version: Optional[str] = None) -> PreparedModel:
        """Resolve a version tag (None/'latest' -> newest) to its model."""
        with self._lock:
            if version in (None, "latest"):
                version = self._latest
            if version is None:
                raise ModelNotFound("no model loaded")
            model = self._models.get(version)
            if model is None:
                raise ModelNotFound(f"unknown model version {version!r}")
            return model

    def unload(self, version: str) -> None:
        with self._lock:
            if version not in self._models:
                raise ModelNotFound(f"unknown model version {version!r}")
            del self._models[version]
            self.drift_baselines.pop(version, None)
            if self._latest == version:
                self._latest = (max(self._models) if self._models else None)
        self.unpin_version(version)
        if self.placement is not None:
            self.placement.release(version)

    # -- eviction pins (fleet router) -----------------------------------
    def pin_version(self, version: str) -> None:
        """Protect a routed version's entries from LRU eviction. Pins are
        refcounted by shape signature: two same-shape versions (the
        periodic-retrain case) share entries, so the signature stays
        pinned until the LAST pinned version releases it."""
        model = self.get(version)
        with self._lock:
            self._pinned_versions[version] = model.shape_sig
        self.predictor.pin(model.shape_sig)

    def unpin_version(self, version: str) -> None:
        with self._lock:
            sig = self._pinned_versions.pop(version, None)
            if sig is None:
                return
            still_pinned = sig in self._pinned_versions.values()
        if not still_pinned:
            self.predictor.unpin(sig)

    def pinned_versions(self) -> List[str]:
        with self._lock:
            return sorted(self._pinned_versions)

    def versions(self) -> List[dict]:
        with self._lock:
            return [{"version": v,
                     "latest": v == self._latest,
                     "pinned": v in self._pinned_versions,
                     "device": m.device_key or None,
                     "num_trees": m.n_trees,
                     "num_features": m.num_features,
                     "num_class": m.num_class}
                    for v, m in sorted(self._models.items())]

    @property
    def latest(self) -> Optional[str]:
        with self._lock:
            return self._latest
