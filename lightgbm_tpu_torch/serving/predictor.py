"""Bucketed predictor cache for online inference (port of
lightgbm_tpu/serving/predictor.py).

`Booster.predict` sizes everything to the call; an online server wants
each request to land on buffers that already exist. This module keeps
one entry per (ensemble shape signature, batch bucket, raw_score,
device) and sends a request through the entry of its bucket: the walk of
`ops/predict.py` over the bucketed ensemble, then the average-output
division, then the objective's link, all on the model's device.

What an entry is here. The JAX package's entry is an AOT-compiled XLA
executable. PyTorch compiles nothing per shape, so an entry is the
prepared bucket:

* its device input buffer, (bucket, F) f32, which every flush of the
  bucket overwrites (the allocation XLA's buffer donation saves);
* its pinned host output buffer, (bucket, K) f32, that the scores come
  back to (on the CPU: plain tensors);
* one warm-up run of the walk at its shape when it is built, so the
  caching allocator already holds the walk's temporaries.

`compile_count` counts entries built; the counters `serve_compiles` and
`serve_compile_seconds` keep their JAX names (an entry build and its
seconds), so `/stats` and `/metrics` read alike in both packages.

The properties the JAX cache has, kept:

* batch shapes are power-of-two bucketed with `_bucket_up`, and a small
  request rides the smallest already-built bucket that fits it, so after
  warm-up no request inside the warmed buckets builds an entry;
* the key is the ensemble's SHAPE signature, not the model version: a hot
  swap to a model of the same padded shape reuses every entry;
* LRU eviction under `max_entries` never drops an entry whose shape
  signature is pinned (`pin` / `unpin`, driven by the canary router and
  the registry);
* `install()` / `entries()` are the seam a persistent entry cache plugs
  into (an installed entry counts neither a build nor a miss).

Staging: a request is padded up to its bucket in a pooled pinned host
buffer, copied to the entry's device buffer without blocking, and the
buffer goes back to its pool once the stream has passed the copy (the
flush ends in a stream sync for the scores, which orders it). An entry is used
by one flush at a time (its lock), so the threads that call `predict` --
the batcher's worker, registry warm-ups, direct callers -- never share a
device buffer mid-flight; each flush runs on its thread's current stream
of the model's device.

`donate` stays in `cache_info` for the same reading in both packages;
the port donates nothing (the entry's input buffer is reused instead),
so it reports 0.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import predict as predict_ops
from ..ops.predict import _bucket_up
from ..telemetry import counters as telem_counters
from ..telemetry import spans as telem_spans
from ..utils import log
from ..utils.device import resolve_device
from ..utils.timer import timer


def _concrete(device) -> torch.device:
    """resolve_device, with a bare 'cuda' pinned to the current ordinal
    (so two spellings of one card key the same entries)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PreparedModel:
    """A Booster/GBDT tensorized once for serving.

    Holds the bucketed EnsembleArrays on its device plus the static
    context of the scoring function. Immutable after construction -- hot
    swaps publish a new PreparedModel. `device` (default: the card) places
    every tensor, and through the family key every entry, on one device;
    the tree -> class map stays on the host (the walk reads it per tree).
    """

    def __init__(self, gbdt, version: str,
                 num_iteration: Optional[int] = None, device=None):
        self.device = _concrete(device)
        arrays, tree_class, n_models = gbdt.ensemble_arrays(
            num_iteration, 0, bucket=True)
        if not n_models:
            raise ValueError("cannot serve a model with no trees")
        if arrays.split_feature.device != self.device:
            arrays = predict_ops.EnsembleArrays(
                *(a.to(self.device) for a in arrays[:-1]), arrays.max_depth)
        self.version = version
        self.device_key = str(self.device)     # 'cuda:0', 'cpu'
        self.arrays = arrays
        self.tree_class = tree_class
        self.n_trees = n_models
        # the host-side model the tensors came from: a retrain starts
        # from the served version's model text, which only the gbdt
        # writes (save_model_to_string)
        self.gbdt = gbdt
        self.num_class = gbdt.num_class
        self.max_depth = arrays.max_depth
        self.num_features = gbdt.max_feature_idx + 1
        self.objective = gbdt.objective
        self.denom = float(
            max(1, n_models // max(gbdt.num_tree_per_iteration, 1))
            if gbdt.average_output else 1)
        # identifies the output transform for entry sharing: two models
        # convert identically iff the objective serializes the same
        self.convert_key = (gbdt.objective.to_string()
                            if gbdt.objective is not None else "")
        self.shape_sig = tuple(
            (tuple(a.shape), str(a.dtype)) for a in arrays[:-1])

    @classmethod
    def from_booster(cls, booster, version: str,
                     num_iteration: Optional[int] = None,
                     device=None) -> "PreparedModel":
        gbdt = getattr(booster, "_gbdt", booster)
        return cls(gbdt, version, num_iteration, device=device)


class _Entry:
    """One prepared bucket: the device input buffer, the host buffer the
    scores come back to, and the lock that gives it to one flush."""

    __slots__ = ("bucket", "x_dev", "out_host", "lock", "build_s")

    def __init__(self, bucket: int, n_features: int, num_class: int,
                 device: torch.device):
        self.bucket = bucket
        self.x_dev = torch.zeros((bucket, n_features), dtype=torch.float32,
                                 device=device)
        self.out_host = torch.empty((bucket, num_class),
                                    dtype=torch.float32,
                                    pin_memory=device.type == "cuda")
        self.lock = threading.Lock()
        self.build_s = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class PredictorCache:
    """(shape signature, batch bucket, raw_score, device) -> prepared
    entry, LRU-bounded with pin protection.

    `compile_count` counts entries built (the JAX package's compiles): every
    entry of the serving path is built by `_build` below; entries that
    arrive through `install()` count as neither builds nor misses.
    """

    def __init__(self, max_batch_rows: int = 4096,
                 max_entries: Optional[int] = None):
        self.max_batch_rows = max_batch_rows
        self.max_entries = (int(max_entries) if max_entries else None)
        self._exec: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        # family key (everything but the bucket) -> sorted built buckets:
        # a small request rides an already-built larger bucket instead of
        # building its own power of two
        self._buckets: Dict[Tuple, list] = {}
        self._pinned_sigs: set = set()
        self._lock = threading.Lock()
        # key -> Event for a build in flight: the build runs outside
        # _lock while duplicate requests for the SAME key wait
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._staging: Dict[Tuple, list] = {}
        self.compile_count = 0
        self.install_count = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------
    @staticmethod
    def _score(model: PreparedModel, x_dev: torch.Tensor,
               raw_score: bool) -> torch.Tensor:
        """(bucket, K) f32 scores on the model's device: the walk, the
        average-output division, the objective's link."""
        out = predict_ops.predict_raw_ensemble(
            x_dev, model.arrays, model.tree_class, model.num_class)
        if model.denom != 1.0:
            out = out / model.denom
        if not raw_score and model.objective is not None:
            out = model.objective.convert_output(out.T).T
        return out

    def family(self, model: PreparedModel, n_features: int,
               raw_score: bool) -> Tuple:
        return (model.shape_sig, n_features, model.max_depth,
                model.num_class, bool(raw_score),
                "" if raw_score else model.convert_key,
                model.device_key)

    def _pick_bucket(self, family: Tuple, n: int) -> int:
        """Smallest already-built bucket that fits n rows, else n's own
        power-of-two bucket (which will build)."""
        with self._lock:
            for b in self._buckets.get(family, ()):
                if b >= n:
                    return b
        return _bucket_up(n)

    # -- pinning / eviction ---------------------------------------------
    def pin(self, shape_sig) -> None:
        """Protect every entry of this ensemble shape signature from LRU
        eviction (the router pins its stable + canary versions)."""
        with self._lock:
            self._pinned_sigs.add(shape_sig)

    def unpin(self, shape_sig) -> None:
        with self._lock:
            self._pinned_sigs.discard(shape_sig)

    def pinned(self) -> set:
        with self._lock:
            return set(self._pinned_sigs)

    def _evict_locked(self) -> None:
        """Drop least-recently-used unpinned entries until the cache fits
        max_entries (caller holds the lock). Pinned families are never
        dropped, even over budget: a routed version must stay servable
        without a build stall."""
        if self.max_entries is None:
            return
        while len(self._exec) > self.max_entries:
            victim = None
            for key in self._exec:          # OrderedDict: LRU first
                if key[0][0] not in self._pinned_sigs:
                    victim = key
                    break
            if victim is None:
                log.warning(
                    "serving: predictor cache over budget (%d > %d) but "
                    "every entry is pinned; not evicting",
                    len(self._exec), self.max_entries)
                return
            del self._exec[victim]
            fam, bucket = victim[0], victim[1][-1]
            if bucket in self._buckets.get(fam, ()):
                self._buckets[fam].remove(bucket)
            self.evictions += 1
            telem_counters.incr("serve_cache_evictions")

    # -- build / install ------------------------------------------------
    @staticmethod
    def _key(family: Tuple, bucket: int) -> Tuple:
        return (family, (bucket,))

    def _build(self, family, bucket, model: PreparedModel, n_features: int,
               raw_score: bool) -> _Entry:
        """Allocate the entry's buffers and run the walk once at its
        shape. Claimed under the lock, built unlocked, installed under
        the lock: a second thread asking for the same key waits on the
        claimant's event; threads asking for other keys sail through."""
        key = self._key(family, bucket)
        while True:
            with self._lock:
                entry = self._exec.get(key)
                if entry is not None:
                    return entry
                waiter = self._inflight.get(key)
                if waiter is None:
                    self._inflight[key] = threading.Event()
                    break
            waiter.wait()

        try:
            t0 = time.perf_counter()
            with timer("serve_compile"), \
                    telem_spans.span("serve_compile", bucket=bucket):
                entry = _Entry(bucket, n_features, model.num_class,
                               model.device)
                self._score(model, entry.x_dev, raw_score)
                _sync(model.device)
            entry.build_s = time.perf_counter() - t0
            # builds are rare: counted unconditionally so the /metrics
            # build counters exist even with telemetry off
            telem_counters.incr("serve_compiles")
            telem_counters.add_seconds("serve_compile_seconds",
                                       entry.build_s)
            with self._lock:
                self._exec[key] = entry
                self._buckets.setdefault(family, []).append(bucket)
                self._buckets[family].sort()
                self.compile_count += 1
                self._evict_locked()
            log.debug("serving: built predictor bucket=%d", bucket)
            return entry
        finally:
            with self._lock:
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()

    def install(self, family: Tuple, bucket: int, entry) -> None:
        """Register an entry that did NOT come from `_build` (a persistent
        entry cache's restore). Counts neither a build nor a miss."""
        key = self._key(family, int(bucket))
        with self._lock:
            if key in self._exec:
                return
            self._exec[key] = entry
            if bucket not in self._buckets.setdefault(family, []):
                self._buckets[family].append(int(bucket))
                self._buckets[family].sort()
            self.install_count += 1
            self._evict_locked()

    def entries(self) -> List[Tuple[Tuple, int, object]]:
        """Snapshot of (family, bucket, entry)."""
        with self._lock:
            return [(key[0], key[1][-1], entry)
                    for key, entry in self._exec.items()]

    # -- staging ---------------------------------------------------------
    def _stage(self, x: np.ndarray, bucket: int, device: torch.device):
        """Pad x up to `bucket` rows in a host tensor (pinned for a card).
        Returns (padded tensor, pool key); the tensor goes back to the
        pool after its copy to the device has run."""
        n, f = x.shape
        pkey = (bucket, f, device.type)
        with self._lock:
            pool = self._staging.setdefault(pkey, [])
            buf = pool.pop() if pool else None
        if buf is None:
            buf = torch.empty((bucket, f), dtype=torch.float32,
                              pin_memory=device.type == "cuda")
        host = buf.numpy()
        host[:n] = x
        host[n:] = 0.0
        return buf, pkey

    def _unstage(self, buf, pkey) -> None:
        with self._lock:
            pool = self._staging.setdefault(pkey, [])
            if len(pool) < 4:       # bound the pool per shape
                pool.append(buf)

    # ------------------------------------------------------------------
    def predict(self, model: PreparedModel, x: np.ndarray,
                raw_score: bool = False) -> np.ndarray:
        """(N, num_class) f64 scores; pads N up to its power-of-two bucket
        and slices back, so any N <= max_batch_rows reuses a warm entry."""
        x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
        if x.ndim == 1:
            x = x.reshape(1, -1)
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, model.num_class), dtype=np.float64)
        if x.shape[1] < model.num_features:
            raise ValueError(
                f"request has {x.shape[1]} features, model "
                f"{model.version} needs {model.num_features}")
        if n > self.max_batch_rows:
            parts = [self.predict(model, x[i:i + self.max_batch_rows],
                                  raw_score)
                     for i in range(0, n, self.max_batch_rows)]
            return np.concatenate(parts, axis=0)
        family = self.family(model, x.shape[1], raw_score)
        bucket = self._pick_bucket(family, n)
        key = self._key(family, bucket)
        with self._lock:
            entry = self._exec.get(key)
            if entry is not None:
                self._exec.move_to_end(key)   # LRU touch
        if entry is None:
            self.misses += 1
            entry = self._build(family, bucket, model, x.shape[1],
                                raw_score)
        else:
            self.hits += 1
        dev = model.device
        with entry.lock, timer("serve_execute"), \
                telem_spans.span("serve_execute", rows=n, bucket=bucket):
            staged, token = self._stage(x, bucket, dev)
            if telem_counters.is_active():
                telem_counters.incr("transfer_h2d_bytes",
                                    staged.numel() * 4)
            entry.x_dev.copy_(staged, non_blocking=True)
            out = self._score(model, entry.x_dev, raw_score)
            entry.out_host.copy_(out, non_blocking=True)
            # the stream has passed the staging copy and the scores' copy
            _sync(dev)
            self._unstage(staged, token)
            result = entry.out_host[:n].numpy().astype(np.float64)
        if telem_counters.is_active():
            telem_counters.incr("transfer_d2h_bytes", result.nbytes)
        return result

    def warm(self, model: PreparedModel, bucket_rows: int,
             raw_score: bool = False) -> None:
        """Build (if needed) and run one dummy batch, so the first real
        request in this bucket is a pure cache hit."""
        bucket = min(_bucket_up(max(1, bucket_rows)), self.max_batch_rows)
        dummy = np.zeros((bucket, model.num_features), dtype=np.float32)
        self.predict(model, dummy, raw_score=raw_score)

    def cache_info(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._exec),
                    "compiles": self.compile_count,
                    "installs": self.install_count,
                    "evictions": self.evictions,
                    "pinned_sigs": len(self._pinned_sigs),
                    "max_entries": self.max_entries or 0,
                    "donate": 0,
                    "hits": self.hits, "misses": self.misses}
