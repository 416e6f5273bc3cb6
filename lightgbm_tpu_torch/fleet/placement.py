"""Multi-model placement: pin model versions to distinct cards (port of
lightgbm_tpu/fleet/placement.py, over CUDA ordinals).

One process serving several boosters wants each version's tensors and
predictor entries resident on its own card: co-locating them on card 0
serializes every request behind one device and makes the predictor cache
thrash between ensembles. A PlacementPlan hands each version a sticky
device; the PreparedModel moves its tensors there and carries the device
in its entry family key, so two placed versions never share entries.

Assignment is deliberately dumb and predictable:

* explicit — a spec like ``"stable=0,canary=1"`` pins versions to CUDA
  ordinals (the operator's escape hatch); an ordinal at or above
  ``torch.cuda.device_count()`` is an error naming it, never a fall back
  to card 0 or to the CPU;
* round-robin — unassigned versions take the least-loaded card, ties
  broken by ordinal, so N versions over D cards spread evenly and a
  re-loaded version keeps its slot (sticky until `release`).

The plan is host-side bookkeeping: it lists the cards only when a device
is first resolved, so it is constructible (and testable) anywhere;
`devices=` gives it an explicit list instead.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils import log
from ..utils.log import LightGBMError

__all__ = ["PlacementPlan", "parse_placement_spec"]


def parse_placement_spec(spec: str) -> Dict[str, int]:
    """``"stable=0,canary=1"`` -> {"stable": 0, "canary": 1}.
    Empty / "auto" -> {} (pure round-robin)."""
    out: Dict[str, int] = {}
    spec = (spec or "").strip()
    if spec in ("", "auto", "round_robin"):
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"placement spec entry {part!r} is not version=ordinal")
        version, ordinal = part.split("=", 1)
        out[version.strip()] = int(ordinal)
    return out


class PlacementPlan:
    """version -> device assignment, sticky and thread-safe."""

    def __init__(self, spec: str = "", devices: Optional[List] = None):
        self._explicit = parse_placement_spec(spec)
        self._devices = devices          # resolved lazily
        self._assigned: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _resolve_devices(self) -> List:
        if self._devices is None:
            import torch
            count = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if count == 0:
                raise LightGBMError(
                    "placement needs a CUDA device and none is available "
                    "(serve without serve_placement, or with "
                    "device_type=cpu, to run on the CPU)")
            self._devices = [torch.device("cuda", i) for i in range(count)]
        return self._devices

    # ------------------------------------------------------------------
    def assign(self, version: str):
        """The device for `version`, assigning one if new. Explicit spec
        entries win; otherwise least-loaded round-robin."""
        devices = self._resolve_devices()
        with self._lock:
            if version in self._assigned:
                return devices[self._assigned[version]]
            if version in self._explicit:
                ordinal = self._explicit[version]
                if not 0 <= ordinal < len(devices):
                    raise LightGBMError(
                        "placement pins version %r to device ordinal %d, "
                        "but only %d device(s) exist (ordinals 0..%d)"
                        % (version, ordinal, len(devices),
                           len(devices) - 1))
            else:
                load = [0] * len(devices)
                for o in self._assigned.values():
                    load[o] += 1
                for o in self._explicit.values():
                    if 0 <= o < len(devices):
                        load[o] += 1
                ordinal = min(range(len(devices)), key=lambda i: load[i])
            self._assigned[version] = ordinal
            log.info("placement: version %s -> device %d (%s)",
                     version, ordinal, devices[ordinal])
            return devices[ordinal]

    def device_for(self, version: str):
        """Assigned device or None — never assigns."""
        with self._lock:
            ordinal = self._assigned.get(version)
        if ordinal is None:
            return None
        return self._resolve_devices()[ordinal]

    def release(self, version: str) -> None:
        """Free the slot (version retired) so round-robin rebalances."""
        with self._lock:
            self._assigned.pop(version, None)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._assigned)
