"""Fleet control plane (port of lightgbm_tpu/fleet/): the layer above
`serving/` that routes traffic between model versions and places them
on cards.

- `router` — canary/shadow traffic router over the registry's version
  pinning: weighted split, shadow mirroring, counter-gated promotion,
  watchdog-triggered demotion, the audit log.
- `placement` — pin model versions to distinct CUDA ordinals.

The JAX package's persistent executable cache, fleet manifest and
gateway are not ported yet: asking this package for them raises, naming
their item in ROADMAP.md.
"""
from ..utils.log import LightGBMError
from .placement import PlacementPlan, parse_placement_spec
from .router import CanaryRouter, RouterState

__all__ = ["PlacementPlan", "parse_placement_spec", "CanaryRouter",
           "RouterState"]

_NOT_YET = {
    "ExportCache": "export_cache", "cache_dir_for_model": "export_cache",
    "FleetGateway": "gateway", "Replica": "gateway",
    "make_gateway_server": "gateway", "run_gateway_server": "gateway",
    "ManifestFollower": "manifest", "ManifestPublisher": "manifest",
    "load_manifest": "manifest", "new_manifest": "manifest",
    "save_manifest": "manifest"}


def __getattr__(name):
    if name in _NOT_YET:
        raise LightGBMError(
            "fleet.%s (lightgbm_tpu/fleet/%s.py) is not supported by "
            "lightgbm_tpu_torch yet (ROADMAP.md section 1, the rest of "
            "fleet/)" % (name, _NOT_YET[name]))
    raise AttributeError(name)
