"""Online inference subsystem (port of lightgbm_tpu/serving/).

Layers (each usable on its own):

* `registry` — versioned, hot-swappable PreparedModels with warm-up and
  optional device placement (fleet hook)
* `predictor` — shape-bucketed predictor cache (one prepared entry per
  bucket: its device input buffer, its pinned output buffer, a warm-up
  walk) with LRU eviction, router pins and a pinned staging pool
* `batcher` — micro-batching scheduler with admission control
* `server` — in-process API + stdlib JSON-over-HTTP front end, with
  the fleet canary router on the un-versioned request path
* `stats` — request counters and latency histograms
* `trace` — sampled per-request span traces (X-Request-Id propagation)
* `slo` — dual-window p99/error-rate burn-rate monitor
* `drift` — training-baseline vs served-traffic PSI drift monitor
* `shed` — brownout load shedding: priority classes (pinned /
  versioned / shadow) over the batcher queue, levels driven by `slo`
* `feedback` — labelled-feedback store and its AUC (the router's
  quality gate)
* `transforms` — edge feature transforms: raw CSV/JSON rows binned by
  the model's training-time mappers

Everything runs on the card unless ``device="cpu"`` is given (without a
card, `ServingApp()` and `ModelRegistry()` raise). Quick start::

    from lightgbm_tpu_torch.serving import ServingApp
    app = ServingApp()
    app.registry.load(booster)            # tensorize + build the buckets
    out, version = app.batcher.submit([[...row...]])

or over HTTP: ``python -m lightgbm_tpu_torch task=serve
input_model=model.txt``.
"""
from .batcher import MicroBatcher, OverloadedError, RequestTimeout
from .drift import DriftMonitor
from .predictor import PredictorCache, PreparedModel
from .registry import ModelNotFound, ModelRegistry
from .server import ServingApp, make_http_server, run_http_server
from .shed import LoadShedder
from .slo import SloMonitor
from .stats import LatencyHistogram, ServingStats
from .transforms import EdgeTransform

__all__ = [
    "MicroBatcher", "OverloadedError", "RequestTimeout",
    "DriftMonitor", "SloMonitor", "LoadShedder", "EdgeTransform",
    "PredictorCache", "PreparedModel",
    "ModelNotFound", "ModelRegistry",
    "ServingApp", "make_http_server", "run_http_server",
    "LatencyHistogram", "ServingStats",
]
