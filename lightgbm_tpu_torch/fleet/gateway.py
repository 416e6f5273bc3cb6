"""Fleet gateway: one HTTP front over N replica servers (stdlib-only;
port of lightgbm_tpu/fleet/gateway.py, the same counters and the same
``/healthz``, ``/stats`` and ``/gateway`` bodies, so both packages'
gateways read alike). It touches no device: the replicas behind it run
the model on their cards.

Clients talk to ONE endpoint; the gateway owns replica selection, health
and retries. JSON over ThreadingHTTPServer, nothing outside the stdlib.

* **Deterministic weighted selection** -- smooth weighted round-robin
  over the manifest's replica weights: each pick adds every routable
  replica's weight to its accumulator, takes the max, and subtracts
  the total from the winner. Exact proportions on every prefix, no
  RNG (the same discipline as the canary router's error-diffusion
  split).
* **Health-aware ejection** -- a background loop polls each replica's
  ``/healthz``; non-ok answers (draining, degraded -- the body carries
  the SLO reason and shed level) eject the replica from rotation until
  it reports ok again. Connect failures on the request path eject
  immediately.
* **Retry with backoff** -- a connect-level failure is retried against
  the next replica in the rotation after a short backoff; replica
  *application* errors (4xx/5xx with a JSON body) pass through
  untouched -- a 429 shed decision is load signal, not retry fodder.
* **Tail-latency hedging** -- with ``gateway_hedge_ms`` set, a
  ``/predict`` still unanswered after that delay is duplicated to a
  second replica (deterministically the next WRR pick) and the FIRST
  answer wins; the loser is discarded. Counted as
  ``gateway_hedged_requests`` / ``gateway_hedge_wins``.
* **Edge transforms** -- with a `serving.transforms.EdgeTransform`
  attached (auto-discovered from the manifest stable model's
  ``.transform.json`` sidecar), ``POST /predict`` additionally accepts
  ``{"csv": "raw,rows\\n..."}`` or a ``text/csv`` body, and JSON rows
  may carry nulls for missing values -- clients send raw features.

Endpoints: ``POST /predict`` (forwarded), ``GET /healthz`` (gateway +
per-replica rollup), ``GET /stats`` (selection/retry/ejection counters,
replica states, manifest rev), ``GET /gateway`` (config snapshot).
"""
from __future__ import annotations

import json
import queue
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..utils import log
from .manifest import load_manifest

__all__ = ["FleetGateway", "Replica", "make_gateway_server",
           "run_gateway_server"]


class Replica:
    """One backend in the rotation (all mutation under the gateway lock)."""

    def __init__(self, url: str, weight: float = 1.0):
        self.url = url.rstrip("/")
        self.weight = float(weight)
        self.current = 0.0              # smooth-WRR accumulator
        self.healthy = True
        self.ejected_until = 0.0
        self.picks = 0
        self.failures = 0
        self.last_status = "unknown"
        self.last_reason: Optional[str] = None

    def routable(self, now: float) -> bool:
        return self.healthy or now >= self.ejected_until

    def snapshot(self, now: float) -> dict:
        return {"url": self.url, "weight": self.weight,
                "healthy": self.healthy,
                "ejected_for_s": max(0.0, round(self.ejected_until - now,
                                                3)),
                "picks": self.picks, "failures": self.failures,
                "last_status": self.last_status,
                "last_reason": self.last_reason}


class FleetGateway:
    """Replica selection + health + retry; transport-agnostic core with
    an HTTP adapter below (mirrors the ServingApp/_Handler split)."""

    def __init__(self, replicas: Optional[List] = None,
                 manifest_path: Optional[str] = None,
                 transform=None, retries: int = 1,
                 backoff_s: float = 0.05, eject_s: float = 2.0,
                 health_period_s: float = 0.5, timeout_s: float = 10.0,
                 hedge_s: float = 0.0):
        self.manifest_path = manifest_path
        self.transform = transform
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.eject_s = float(eject_s)
        self.health_period_s = float(health_period_s)
        self.timeout_s = float(timeout_s)
        self.hedge_s = float(hedge_s)
        self.manifest_rev = 0
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        for rep in replicas or []:
            if isinstance(rep, str):
                self.add_replica(rep)
            else:
                self.add_replica(rep["url"], float(rep.get("weight", 1.0)))
        if manifest_path:
            self.refresh_manifest()

    # -- replica set -----------------------------------------------------
    def add_replica(self, url: str, weight: float = 1.0) -> None:
        with self._lock:
            url = url.rstrip("/")
            if url in self._replicas:
                self._replicas[url].weight = float(weight)
            else:
                self._replicas[url] = Replica(url, weight)

    def refresh_manifest(self) -> bool:
        """Adopt the manifest's replica set/weights (and discover the
        stable model's edge-transform sidecar on first sight)."""
        manifest = load_manifest(self.manifest_path)
        if manifest is None:
            return False
        rev = int(manifest.get("rev", 0))
        for rep in manifest.get("replicas") or []:
            if isinstance(rep, str):
                self.add_replica(rep)
            else:
                self.add_replica(rep["url"], float(rep.get("weight", 1.0)))
        if self.transform is None:
            self._discover_transform(manifest)
        if rev != self.manifest_rev:
            self.manifest_rev = rev
            telem_counters.set_gauge("gateway_manifest_rev", rev)
        return True

    def _discover_transform(self, manifest: dict) -> None:
        from ..serving.transforms import EdgeTransform, load_transform
        stable = manifest.get("stable")
        source = (manifest.get("models") or {}).get(stable)
        if not source or "\n" in str(source):
            return
        spec = load_transform(str(source) + ".transform.json")
        if spec is not None:
            self.transform = EdgeTransform(spec)
            log.info("gateway: edge transform discovered for %s (%d "
                     "mapped features)", stable,
                     len(self.transform.mappers))

    # -- selection -------------------------------------------------------
    def pick(self, exclude=()) -> Optional[Replica]:
        """Smooth weighted round-robin over routable replicas: exact
        weight proportions on every prefix, deterministic."""
        now = time.monotonic()
        with self._lock:
            pool = [r for r in self._replicas.values()
                    if r.routable(now) and r.url not in exclude]
            if not pool:
                return None
            total = sum(r.weight for r in pool) or 1.0
            for r in pool:
                r.current += r.weight
            best = max(pool, key=lambda r: (r.current, r.url))
            best.current -= total
            best.picks += 1
            return best

    # -- request path ----------------------------------------------------
    def predict(self, payload: dict) -> tuple:
        """Forward one predict; returns (http_status, body_dict). Only
        connect-level failures are retried (against a different
        replica, after backoff); application errors pass through. With
        ``hedge_s > 0`` a slow answer is raced against a second
        replica (first answer wins)."""
        telem_counters.incr("gateway_requests")
        payload = self._transform_payload(payload)
        data = json.dumps(payload).encode()
        if self.hedge_s > 0:
            return self._predict_hedged(data)
        return self._predict_serial(data)

    def _dispatch_one(self, replica: Replica, data: bytes) -> tuple:
        """One POST to one replica. ('answer', status, body) covers
        everything the replica actually said — 429 (shed) / 5xx are its
        call and pass through; ('connect_error', replica, reason) means
        the replica never answered."""
        try:
            req = urllib.request.Request(
                replica.url + "/predict", data=data,
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return "answer", resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                return "answer", exc.code, json.loads(exc.read())
            except Exception:   # noqa: BLE001
                return "answer", exc.code, {"error": f"http_{exc.code}"}
        except Exception as exc:   # noqa: BLE001 — connect failure
            return "connect_error", replica, str(exc)

    def _predict_serial(self, data: bytes, tried=None) -> tuple:
        tried = set(tried or ())
        last_error = "no replica available"
        for attempt in range(self.retries + 1):
            replica = self.pick(exclude=tried)
            if replica is None and tried:
                replica = self.pick()      # all tried: any routable one
            if replica is None:
                telem_counters.incr("gateway_no_replica")
                return 503, {"error": f"no routable replica "
                                      f"({last_error})"}
            if attempt > 0:
                telem_counters.incr("gateway_retries")
                time.sleep(self.backoff_s * attempt)
            kind, a, b = self._dispatch_one(replica, data)
            if kind == "answer":
                return a, b
            last_error = f"{replica.url}: {b}"
            tried.add(replica.url)
            self._eject(replica, f"connect_error: {b}")
        return 502, {"error": f"all replicas failed ({last_error})"}

    def _predict_hedged(self, data: bytes) -> tuple:
        """Hedged dispatch: primary pick fires immediately; if no
        answer lands within hedge_s, the NEXT deterministic pick gets a
        duplicate and the first answer wins. Lanes always report (a
        connect failure is a report, and ejects), so the collect loop
        terminates without its own deadline; if every lane connect-
        fails, fall back to the serial retry path with those replicas
        excluded."""
        primary = self.pick()
        if primary is None:
            telem_counters.incr("gateway_no_replica")
            return 503, {"error": "no routable replica"}
        answers: queue.Queue = queue.Queue()

        def _lane(which: str, replica: Replica) -> None:
            answers.put((which, replica, self._dispatch_one(replica,
                                                            data)))

        threading.Thread(target=_lane, args=("primary", primary),
                         daemon=True, name="lgbm-torch-gw-hedge0").start()
        outstanding, hedged, tried = 1, False, set()
        while outstanding:
            try:
                which, replica, res = answers.get(
                    timeout=None if hedged else self.hedge_s)
            except queue.Empty:
                # the hedge fires exactly once: duplicate to the next
                # deterministic pick (None when only one replica is
                # routable — then just keep waiting on the primary)
                hedged = True
                backup = self.pick(exclude={primary.url})
                if backup is not None:
                    telem_counters.incr("gateway_hedged_requests")
                    telem_events.emit("gateway_hedge", primary=primary.url,
                                      backup=backup.url)
                    threading.Thread(
                        target=_lane, args=("backup", backup),
                        daemon=True, name="lgbm-torch-gw-hedge1").start()
                    outstanding += 1
                continue
            outstanding -= 1
            if res[0] == "answer":
                if which == "backup":
                    telem_counters.incr("gateway_hedge_wins")
                return res[1], res[2]
            tried.add(replica.url)
            self._eject(replica, f"connect_error: {res[2]}")
        return self._predict_serial(data, tried=tried)

    def _transform_payload(self, payload: dict) -> dict:
        """Edge featurization: raw CSV text / JSON rows (with nulls)
        become bin-canonical numeric rows via the model's own training
        mappers, so what the replica scores is bit-identical to
        client-side pre-binning (Dataset.real_threshold grid)."""
        if self.transform is None:
            return payload
        out = dict(payload)
        if "csv" in out:
            rows = self.transform.parse_csv(out.pop("csv"))
        elif out.get("rows") and any(
                v is None for row in out["rows"] for v in row):
            rows = self.transform.parse_rows(out["rows"])
        else:
            return out
        out["rows"] = [[float(v) for v in row]
                       for row in self.transform.prebin_rows(rows)]
        return out

    # -- health ----------------------------------------------------------
    def _eject(self, replica: Replica, reason: str) -> None:
        with self._lock:
            was_healthy = replica.healthy
            replica.healthy = False
            replica.failures += 1
            replica.ejected_until = time.monotonic() + self.eject_s
            replica.last_reason = reason
        if was_healthy:
            telem_counters.incr("gateway_ejections")
            telem_events.emit("gateway_eject", url=replica.url,
                              reason=reason)
            log.warning("gateway: ejected %s (%s)", replica.url, reason)
        self._gauge_healthy()

    def _restore(self, replica: Replica) -> None:
        with self._lock:
            was_healthy = replica.healthy
            replica.healthy = True
            replica.ejected_until = 0.0
            replica.last_reason = None
        if not was_healthy:
            telem_events.emit("gateway_restore", url=replica.url)
            log.info("gateway: restored %s", replica.url)
        self._gauge_healthy()

    def _gauge_healthy(self) -> None:
        with self._lock:
            n = sum(1 for r in self._replicas.values() if r.healthy)
        telem_counters.set_gauge("gateway_healthy_replicas", n)

    def check_health(self) -> None:
        """One health sweep (the background loop's body, callable
        directly by tests): poll every replica's /healthz and eject/
        restore on the answer — the degrade *reason* in the body is
        kept so `GET /stats` explains every ejection."""
        if self.manifest_path:
            self.refresh_manifest()
        with self._lock:
            replicas = list(self._replicas.values())
        for replica in replicas:
            status, body = self._healthz(replica)
            replica.last_status = status
            if status == "ok":
                self._restore(replica)
            else:
                reason = (body.get("reason") or status) if body else status
                self._eject(replica, str(reason))

    def _healthz(self, replica: Replica) -> tuple:
        try:
            with urllib.request.urlopen(
                    replica.url + "/healthz", timeout=self.timeout_s) as r:
                body = json.loads(r.read())
                return str(body.get("status", "ok")), body
        except urllib.error.HTTPError as exc:      # 503 carries a body
            try:
                body = json.loads(exc.read())
                return str(body.get("status", f"http_{exc.code}")), body
            except Exception:   # noqa: BLE001
                return f"http_{exc.code}", None
        except Exception as exc:   # noqa: BLE001
            return f"unreachable: {exc}", None

    def start_health_loop(self) -> None:
        if self._health_thread is not None:
            return
        self._stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_run, daemon=True, name="lgbm-torch-gw-health")
        self._health_thread.start()

    def _health_run(self) -> None:
        while not self._stop.wait(self.health_period_s):
            try:
                self.check_health()
            except Exception as exc:   # noqa: BLE001 — keep sweeping
                log.warning("gateway: health sweep failed: %s", exc)

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None

    # -- introspection ---------------------------------------------------
    def health(self) -> dict:
        now = time.monotonic()
        with self._lock:
            reps = [r.snapshot(now) for r in self._replicas.values()]
        healthy = sum(1 for r in reps if r["healthy"])
        return {"status": "ok" if healthy else "no_replicas",
                "replicas": len(reps), "healthy_replicas": healthy}

    def stats(self) -> dict:
        now = time.monotonic()
        with self._lock:
            reps = [r.snapshot(now) for r in
                    sorted(self._replicas.values(), key=lambda r: r.url)]
        return {"replicas": reps, "manifest_rev": self.manifest_rev,
                "counters": {
                    "gateway_requests":
                        telem_counters.get("gateway_requests"),
                    "gateway_retries":
                        telem_counters.get("gateway_retries"),
                    "gateway_ejections":
                        telem_counters.get("gateway_ejections"),
                    "gateway_no_replica":
                        telem_counters.get("gateway_no_replica"),
                    "gateway_hedged_requests":
                        telem_counters.get("gateway_hedged_requests"),
                    "gateway_hedge_wins":
                        telem_counters.get("gateway_hedge_wins")},
                "transform": (self.transform.describe()
                              if self.transform is not None else None)}

    def config(self) -> dict:
        return {"manifest_path": self.manifest_path,
                "retries": self.retries, "backoff_s": self.backoff_s,
                "eject_s": self.eject_s,
                "health_period_s": self.health_period_s,
                "timeout_s": self.timeout_s, "hedge_s": self.hedge_s}


class _GatewayHandler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-gateway/1.0"
    protocol_version = "HTTP/1.1"

    @property
    def gw(self) -> FleetGateway:
        return self.server.gateway

    def log_message(self, fmt, *args):
        log.debug("gateway http: " + fmt, *args)

    def _reply(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            body = self.gw.health()
            self._reply(200 if body["status"] == "ok" else 503, body)
        elif self.path == "/stats":
            self._reply(200, self.gw.stats())
        elif self.path == "/gateway":
            self._reply(200, self.gw.config())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/predict":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            if (self.headers.get("Content-Type") or "").startswith(
                    "text/csv"):
                payload = {"csv": raw.decode()}
            else:
                payload = json.loads(raw or b"{}")
            code, body = self.gw.predict(payload)
            self._reply(code, body)
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:   # noqa: BLE001 — keep serving
            log.warning("gateway: internal error: %s", exc)
            self._reply(500, {"error": str(exc)})


def make_gateway_server(gateway: FleetGateway, host: str = "127.0.0.1",
                        port: int = 8080) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((host, port), _GatewayHandler)
    httpd.gateway = gateway
    httpd.daemon_threads = True
    return httpd


def run_gateway_server(gateway: FleetGateway, host: str = "127.0.0.1",
                       port: int = 8080, background: bool = False):
    httpd = make_gateway_server(gateway, host, port)
    gateway.start_health_loop()
    log.info("gateway: listening on http://%s:%d over %d replica(s)",
             *httpd.server_address[:2], len(gateway.stats()["replicas"]))
    if background:
        t = threading.Thread(target=httpd.serve_forever,
                             name="lgbm-torch-gw-http", daemon=True)
        t.start()
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:   # pragma: no cover
        pass
    finally:
        gateway.stop()
        httpd.server_close()
    return httpd
