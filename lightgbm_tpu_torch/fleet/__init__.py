"""Fleet control plane (port of lightgbm_tpu/fleet/): the layer above
`serving/` that runs models on cards for many replicas.

- `export_cache` — persistent predictor-entry cache: which (family,
  bucket) entries were warm, next to the model file, so a restarted
  replica installs them instead of building them.
- `placement` — pin model versions to distinct CUDA ordinals.
- `router` — canary/shadow traffic router over the registry's version
  pinning: weighted split, shadow mirroring, counter-gated promotion,
  watchdog-triggered demotion, the audit log.
- `manifest` — the versioned fleet deploy artifact: replicas poll and
  converge on it, and the router's promote/demote decisions publish
  back into it, so one canary rollout spans N processes.
- `gateway` — stdlib HTTP front over the replica set: deterministic
  weighted selection, health-aware ejection, retry with backoff,
  hedging, edge feature transforms (raw CSV/JSON in, predictions out).

The manifest and the gateway speak the JAX package's formats, so a
fleet may mix replicas of both packages.
"""
from .export_cache import ExportCache, cache_dir_for_model
from .gateway import (FleetGateway, Replica, make_gateway_server,
                      run_gateway_server)
from .manifest import (ManifestFollower, ManifestPublisher, load_manifest,
                       new_manifest, save_manifest)
from .placement import PlacementPlan, parse_placement_spec
from .router import CanaryRouter, RouterState

__all__ = ["ExportCache", "cache_dir_for_model", "PlacementPlan",
           "parse_placement_spec", "CanaryRouter", "RouterState",
           "ManifestFollower", "ManifestPublisher", "load_manifest",
           "new_manifest", "save_manifest",
           "FleetGateway", "Replica", "make_gateway_server",
           "run_gateway_server"]
