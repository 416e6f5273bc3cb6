"""Fleet manifest: one versioned deploy artifact N replicas converge on
(port of lightgbm_tpu/fleet/manifest.py; the same file format, so either
package reads a manifest the other wrote).

The canary router spans one process; the fleet needs its state machine
to span N of them without an external control plane. The mechanism is a
small versioned JSON file:

    {"format": "lgbm_tpu_fleet_manifest", "version": 1, "rev": 7,
     "models":  {"v1": "/models/m1.txt", "v2": "/models/m2.txt"},
     "stable":  "v1",
     "canary":  {"version": "v2", "weight": 0.1, "shadow": false},
     "replicas": [{"url": "http://h0:8080", "weight": 1.0}, ...],
     "updated_unix": 1722... }

* ``rev`` is a monotonically increasing write counter -- followers
  apply a manifest exactly once per rev, so polling is idempotent.
* ``models`` maps version tags to model files (model text of either
  package); followers load tags they don't have yet (warm before
  publish, through ModelRegistry.load).
* ``stable``/``canary`` mirror the router state machine. A follower
  whose current canary equals the manifest's ``stable`` *promotes* --
  that is how one replica's counter-gated promotion propagates to the
  whole fleet, each replica recording the transition in its own audit
  log, no restarts.
* ``replicas`` is the gateway's serving set + selection weights.

Writers: `ManifestPublisher` -- seeded by the deploy tooling and bound to
`CanaryRouter.on_transition` on the deciding replica, so promote/demote
decisions flow back into the artifact. Writes are atomic (temp file +
os.replace) and skipped when the computed state is unchanged, which is
what keeps a publisher+follower replica from ping-ponging revs.

Readers: `ManifestFollower` -- polls the file and converges a ServingApp
onto it (load missing models, stable/deploy/promote/demote as diffs
dictate). Every apply bumps ``manifest_applies`` / ``manifest_rev`` and
emits a ``manifest_apply`` event. A model the follower cannot load
because its file is missing or not model text is logged and skipped,
as in the JAX package; a load that fails on the card (out of memory, a
failed launch, no card) raises.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log
from ..utils.device import is_device_error

__all__ = ["MANIFEST_FORMAT", "new_manifest", "load_manifest",
           "save_manifest", "ManifestPublisher", "ManifestFollower"]

MANIFEST_FORMAT = "lgbm_tpu_fleet_manifest"


def new_manifest(models: Optional[Dict[str, str]] = None,
                 stable: Optional[str] = None,
                 canary: Optional[dict] = None,
                 replicas: Optional[List[dict]] = None) -> dict:
    return {"format": MANIFEST_FORMAT, "version": 1, "rev": 0,
            "models": dict(models or {}), "stable": stable,
            "canary": canary, "replicas": list(replicas or []),
            "updated_unix": time.time()}


def load_manifest(path: str) -> Optional[dict]:
    """None (not an error) on missing/unreadable/foreign files -- a
    follower keeps polling through a mid-write race or an empty path.

    A file that reads but does not parse is counted (``manifest_torn``)
    and evented: our own writes are atomic (save_manifest), so truncated
    JSON means a non-atomic writer or a torn copy. Still None -- the
    follower keeps the previously applied revision, the safe state."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    try:
        m = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        telem_counters.incr("manifest_torn")
        telem_events.emit("manifest_torn", path=str(path),
                          size_bytes=len(raw))
        log.warning("manifest: %s is torn/unparseable (%d bytes); "
                    "keeping the previously applied revision", path,
                    len(raw))
        return None
    if not isinstance(m, dict) or m.get("format") != MANIFEST_FORMAT:
        return None
    return m


def save_manifest(manifest: dict, path: str) -> str:
    """Atomic publish: temp file in the same directory + os.replace, so
    a poll never reads a torn manifest."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".manifest_", dir=directory)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, sort_keys=True, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


class ManifestPublisher:
    """Single-writer side: read-modify-write with rev bump, bound to a
    router's `on_transition` so canary decisions become fleet state."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._registry = None

    def seed(self, models: Dict[str, str], stable: Optional[str] = None,
             replicas: Optional[List[dict]] = None) -> dict:
        """Create/overwrite the artifact (the deploy tool's one write)."""
        manifest = new_manifest(models=models, stable=stable,
                                replicas=replicas)
        manifest["rev"] = 1
        with self._lock:
            save_manifest(manifest, self.path)
        telem_counters.incr("manifest_publishes")
        return manifest

    def update(self, fn) -> Optional[dict]:
        """Apply `fn(manifest)` (mutating in place); bump rev and write
        only when the state actually changed -- idempotent updates don't
        spin follower revs."""
        with self._lock:
            manifest = load_manifest(self.path)
            if manifest is None:
                manifest = new_manifest()
            before = json.dumps({k: v for k, v in manifest.items()
                                 if k not in ("rev", "updated_unix")},
                                sort_keys=True)
            fn(manifest)
            after = json.dumps({k: v for k, v in manifest.items()
                                if k not in ("rev", "updated_unix")},
                               sort_keys=True)
            if after == before:
                return None
            manifest["rev"] = int(manifest.get("rev", 0)) + 1
            manifest["updated_unix"] = time.time()
            save_manifest(manifest, self.path)
        telem_counters.incr("manifest_publishes")
        log.info("manifest: published rev %d (stable=%s canary=%s)",
                 manifest["rev"], manifest.get("stable"),
                 (manifest.get("canary") or {}).get("version"))
        return manifest

    def add_model(self, version: str, source: str) -> Optional[dict]:
        """Record a model source so followers can load `version` --
        ship the file reference first, then canary it via the router."""
        def _apply(m: dict) -> None:
            m.setdefault("models", {})[version] = str(source)
        return self.update(_apply)

    def bind_router(self, router, registry=None) -> None:
        """Subscribe to the router's transitions (its `_notify` calls
        `on_transition` after every stable/deploy/promote/demote)."""
        self._registry = registry
        router.on_transition = self.on_transition

    # router hook: action in stable/deploy/promote/demote
    def on_transition(self, action: str, version: str, **detail) -> None:
        def _apply(m: dict) -> None:
            if action == "stable":
                m["stable"] = version
            elif action == "deploy":
                m["canary"] = {"version": version,
                               "weight": float(detail.get("weight", 0.1)),
                               "shadow": bool(detail.get("shadow", False))}
            elif action == "promote":
                m["stable"] = version
                m["canary"] = None
            elif action == "demote":
                m["canary"] = None
        self.update(_apply)


class ManifestFollower:
    """Reader side: poll the artifact, converge a ServingApp onto it.

    Convergence is a diff against the app's *current* router state, so
    applying the same manifest twice is a no-op and a replica that
    already took a transition locally (the publisher's own follower)
    doesn't repeat it."""

    def __init__(self, app, path: str, poll_s: float = 0.5):
        self.app = app
        self.path = path
        self.poll_s = float(poll_s)
        self._applied_rev = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one convergence step -------------------------------------------
    def poll_once(self) -> bool:
        """Apply the manifest if its rev is new; True when applied. A
        device fault while loading a model raises, and the rev stays
        unapplied."""
        manifest = load_manifest(self.path)
        if manifest is None:
            return False
        rev = int(manifest.get("rev", 0))
        if rev <= self._applied_rev:
            return False
        self._apply(manifest)
        self._applied_rev = rev
        telem_counters.incr("manifest_applies")
        telem_counters.set_gauge("manifest_rev", rev)
        telem_events.emit("manifest_apply", rev=rev,
                          stable=manifest.get("stable"),
                          canary=(manifest.get("canary") or {}
                                  ).get("version"))
        return True

    def _apply(self, manifest: dict) -> None:
        registry, router = self.app.registry, self.app.router
        loaded = {v["version"] for v in registry.versions()}
        for ver, source in (manifest.get("models") or {}).items():
            if ver in loaded:
                continue
            try:
                registry.load(source, version=ver)
            except Exception as exc:   # noqa: BLE001 — converge the rest
                if is_device_error(exc):
                    raise
                log.warning("manifest: loading %s from %s failed: %s",
                            ver, source, exc)
        stable = manifest.get("stable")
        canary = manifest.get("canary") or None
        if stable:
            if router.canary == stable:
                # the fleet promoted our canary: take the transition
                # locally so this replica's audit log records it
                router.promote(missing_ok=True)
            elif router.stable != stable:
                router.set_stable(stable)
        if canary and canary.get("version") != stable:
            want = canary["version"]
            if router.canary != want:
                if router.canary is not None:
                    router.demote("manifest_replaced", missing_ok=True)
                try:
                    router.deploy(want,
                                  weight=float(canary.get("weight", 0.1)),
                                  shadow=bool(canary.get("shadow", False)))
                except Exception as exc:   # noqa: BLE001
                    if is_device_error(exc):
                        raise
                    log.warning("manifest: deploy %s failed: %s",
                                want, exc)
        elif canary is None and router.canary is not None:
            router.demote("manifest_demote", missing_ok=True)

    # -- polling loop ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lgbm-torch-manifest")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception as exc:   # noqa: BLE001 — keep polling
                # a device fault leaves the rev unapplied: the next poll
                # tries it again and logs it again
                log.warning("manifest: poll failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
