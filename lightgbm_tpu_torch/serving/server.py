"""In-process serving API + stdlib HTTP front end (JSON, no deps; port of
lightgbm_tpu/serving/server.py, the same endpoints and JSON keys).

The app layer (`ServingApp`) is plain dict-in/dict-out so embedders and
tests drive it without sockets; the HTTP layer is a thin
ThreadingHTTPServer adapter over it.

Endpoints:

* ``POST /predict``  {"rows": [[...], ...], "raw_score": false,
  "version": "v1" | "latest", "timeout_ms": 100} ->
  {"predictions": [...], "version": "v1", "num_rows": N}; an incoming
  ``X-Request-Id`` header is honored (else generated) and always
  echoed back — sampled requests additionally emit a linked
  trace_span timeline (serving/trace.py)
* ``GET  /stats``    counters + latency histograms (p50/p95/p99) +
  predictor cache info
* ``GET  /metrics``  the same counters in Prometheus text format, plus
  the process-wide telemetry counters (predictor entry builds and their
  seconds, transfer bytes, peak RSS and device memory) — scrape-ready
* ``GET  /models``   loaded versions
* ``POST /models``   {"model_file": path} | {"model_str": text}
  [, "version": tag] — load + warm + hot-swap to latest
* ``GET  /healthz``  registry + batcher liveness: 200 with
  ``status=ok`` when routable, 503 with ``status=draining``/
  ``degraded`` during graceful shutdown or after a dead batcher worker
* ``GET  /router``   canary router state (stable/canary/weight/history)
* ``GET  /router/audit``  the router decision log: every transition
  with the exact gate snapshot that justified it
* ``POST /router``   {"action": "stable"|"deploy"|"promote"|"demote"
  [, "version", "weight", "shadow"]} — drive the canary state machine
* ``POST /drain``    graceful drain for rolling restarts: stop
  admitting, flush the queue, reply with the final health snapshot
* ``POST /feedback`` {"version": "v1", "labels": [...],
  "scores": [...]} — record ground-truth labels against the version
  that answered (the /predict response carries it); feeds the router's
  labeled-feedback AUC promotion gate (serving/feedback.py)
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..fleet.router import CanaryRouter
from ..utils import log
from . import trace as serve_trace
from .batcher import MicroBatcher, OverloadedError, RequestTimeout
from .registry import ModelNotFound, ModelRegistry
from .shed import PRIORITIES
from .stats import ServingStats


class BadRequest(ValueError):
    pass


class ServingApp:
    """Transport-agnostic serving facade: registry + batcher + stats +
    canary router. Without a `registry` it makes one on `device` (the
    card unless ``device="cpu"``; without a card that raises). The
    router is idle (pass-through to `latest`) until a stable version is
    installed via `POST /router {"action": "stable"}` or
    `app.router.set_stable`.

    Optional observability attachments: `slo` (serving.slo.SloMonitor —
    folds into /healthz, /metrics and the router's demotion gate),
    `drift` (serving.drift.DriftMonitor — windows served traffic
    against the model's training baseline) and `shed`
    (serving.shed.LoadShedder — priority-class brownout admission in
    the batcher, level changes logged to the router audit channel)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 batcher: Optional[MicroBatcher] = None,
                 stats: Optional[ServingStats] = None,
                 router: Optional[CanaryRouter] = None,
                 slo=None, drift=None, shed=None, feedback=None,
                 device=None, **batcher_kwargs):
        from .feedback import FeedbackStore
        self.registry = registry or ModelRegistry(device=device)
        self.stats = stats or ServingStats()
        self.shed = shed
        self.batcher = batcher or MicroBatcher(
            self.registry, stats=self.stats, shed=shed, **batcher_kwargs)
        if shed is not None and self.batcher.shed is None:
            self.batcher.shed = shed
        self.slo = slo
        self.drift = drift
        self.feedback = feedback or FeedbackStore()
        self.router = router or CanaryRouter(self.registry, self.stats,
                                             slo=slo,
                                             feedback=self.feedback)
        if slo is not None and getattr(self.router, "slo", None) is None:
            self.router.slo = slo
        if getattr(self.router, "feedback", None) is None:
            self.router.feedback = self.feedback
        if shed is not None and shed.audit is None:
            # brownout level changes land in the same bounded decision
            # log as canary transitions (GET /router/audit)
            shed.audit = self.router.audit_note

    # ------------------------------------------------------------------
    def predict(self, payload: dict,
                request_id: Optional[str] = None) -> dict:
        rows = payload.get("rows")
        if rows is None:
            raise BadRequest("missing 'rows'")
        raw_score = bool(payload.get("raw_score", False))
        version = payload.get("version")
        # priority class for shed admission: explicit tag wins, else
        # routed traffic is "pinned" (the SLO class) and explicit-
        # version requests are "versioned" (replay/debug traffic)
        priority = payload.get("priority") or (
            "versioned" if version else "pinned")
        if priority not in PRIORITIES:
            raise BadRequest(f"unknown priority {priority!r} "
                             f"(one of {', '.join(PRIORITIES)})")
        # sampled per-request timeline (None when sampled out / tracing
        # off); the request id itself is handled by the HTTP layer so
        # the response header exists whether or not this is sampled
        trace = serve_trace.start(request_id or payload.get("request_id"))
        # an explicit version tag bypasses the router (debugging, shadow
        # replay); everything else is routed stable/canary per weight
        routed = version is None and self.router.active
        if routed:
            t_route = time.monotonic()
            version = self.router.route()
            if trace is not None:
                trace.span("router", time.monotonic() - t_route,
                           version=version)
        t0 = time.monotonic()
        try:
            out, version_used = self.batcher.submit(
                rows, version=version, raw_score=raw_score,
                timeout_ms=payload.get("timeout_ms"), trace=trace,
                priority=priority)
        except Exception as exc:
            # error series keyed by the *requested* tag — no answer
            # resolved one, and "which version is erroring" is exactly
            # the canary question these labels exist to answer
            requested = version or self.registry.latest or "latest"
            dt = time.monotonic() - t0
            self.stats.observe_version(requested, error=True)
            if self.slo is not None:
                self.slo.observe(requested, dt, error=True)
            if trace is not None:
                trace.span("server", dt, version=requested,
                           status="error", error=type(exc).__name__)
            if routed:
                # errors drive the demotion gate — evaluate before the
                # error propagates so a bleeding canary is cut promptly
                self.router.evaluate()
            raise
        dt = time.monotonic() - t0
        self.stats.observe("serve_request", dt)
        self.stats.observe_version(version_used, dt)
        if self.slo is not None:
            self.slo.observe(version_used, dt)
        if self.drift is not None:
            self.drift.observe(rows, out, version=version_used)
        if routed:
            shadow = self.router.shadow_target()
            if shadow is not None:
                self._mirror(rows, shadow, raw_score)
            self.router.evaluate()
        preds = (out[:, 0] if out.ndim == 2 and out.shape[1] == 1 else out)
        if trace is not None:
            trace.span("server", dt, version=version_used,
                       rows=int(out.shape[0]), status="ok")
        return {"predictions": preds.tolist(), "version": version_used,
                "num_rows": int(out.shape[0])}

    def _mirror(self, rows, version: str, raw_score: bool) -> None:
        """Shadow traffic: replay the request against `version` off the
        response path. The caller never waits; results are discarded but
        the canary's per-version counters accumulate, which is the whole
        point — measurement without user exposure."""
        self.stats.incr("serve_shadow_mirrored")

        def _run():
            t0 = time.monotonic()
            try:
                _, ver = self.batcher.submit(rows, version=version,
                                             raw_score=raw_score,
                                             priority="shadow")
                self.stats.observe_version(ver, time.monotonic() - t0)
            except Exception as exc:   # noqa: BLE001 — shadow never throws
                self.stats.observe_version(version, error=True)
                log.debug("serving: shadow mirror to %s failed: %s",
                          version, exc)
            self.router.evaluate()

        threading.Thread(target=_run, daemon=True,
                         name="lgbm-torch-shadow").start()

    def feedback_record(self, payload: dict) -> dict:
        """POST /feedback: ground-truth labels for earlier predictions,
        keyed by the version that answered them. Labels accumulate in
        the bounded per-version store the router's AUC promotion gate
        reads."""
        version = payload.get("version")
        if not version:
            raise BadRequest("feedback needs 'version' (echo the one "
                             "the /predict response carried)")
        labels = payload.get("labels")
        scores = payload.get("scores", payload.get("predictions"))
        if labels is None or scores is None:
            raise BadRequest("feedback needs 'labels' and 'scores'")
        try:
            count = self.feedback.record(version, labels, scores)
        except ValueError as exc:
            raise BadRequest(str(exc)) from exc
        self.stats.incr("serve_feedback_batches")
        # fresh labels are gate evidence — re-judge the canary now
        # rather than waiting for the next predict
        self.router.evaluate()
        return {"version": version, "recorded": len(labels),
                "total_labels": count}

    def load_model(self, payload: dict) -> dict:
        if "model_file" in payload:
            source = payload["model_file"]
        elif "model_str" in payload:
            source = payload["model_str"]
        else:
            raise BadRequest("need 'model_file' or 'model_str'")
        version = self.registry.load(source, version=payload.get("version"))
        self.stats.incr("serve_model_loads")
        return {"version": version, "latest": True}

    def models(self) -> dict:
        return {"models": self.registry.versions(),
                "latest": self.registry.latest}

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["predictor_cache"] = self.registry.predictor.cache_info()
        snap["models"] = self.registry.versions()
        snap["router"] = self.router.snapshot()
        snap["feedback"] = self.feedback.snapshot()
        if self.registry.export_cache is not None:
            snap["export_cache"] = self.registry.export_cache.info()
        if self.slo is not None:
            snap["slo"] = self.slo.snapshot()
        if self.drift is not None:
            snap["drift"] = self.drift.snapshot()
        if self.shed is not None:
            snap["shed"] = self.shed.snapshot()
        return snap

    # -- fleet control ---------------------------------------------------
    def router_action(self, payload: dict) -> dict:
        """POST /router — the canary state machine's control surface:
        {"action": "stable"|"deploy"|"promote"|"demote", ...}."""
        action = payload.get("action")
        if action == "stable":
            version = payload.get("version") or self.registry.latest
            if version is None:
                raise BadRequest("no version to make stable")
            self.router.set_stable(version)
        elif action == "deploy":
            version = payload.get("version")
            if not version:
                raise BadRequest("deploy needs 'version'")
            self.router.deploy(version,
                               weight=float(payload.get("weight", 0.10)),
                               shadow=bool(payload.get("shadow", False)))
        elif action == "promote":
            self.router.promote()
        elif action == "demote":
            self.router.demote(payload.get("reason", "manual"))
        else:
            raise BadRequest(f"unknown router action {action!r}")
        return self.router.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text format: serving counters/latency + process
        telemetry counters (served at GET /metrics, next to /stats)."""
        from .. import telemetry
        return telemetry.prometheus_text(
            self.stats.snapshot(), self.registry.predictor.cache_info(),
            slo=self.slo.snapshot() if self.slo is not None else None,
            drift=self.drift.snapshot() if self.drift is not None
            else None)

    def health(self) -> dict:
        """Liveness for load balancers: registry + batcher state, plus
        the SLO fast window when a monitor is attached. ``status`` is
        ``ok`` (routable), ``draining`` (shutdown in progress — stop
        routing, in-flight work still completes) or ``degraded``
        (batcher worker dead/closed, or the fast SLO window is burning
        — servable but violating its objectives). The HTTP layer maps
        non-``ok`` to 503. Degradation is *explained*: ``reason`` names
        which SLO window is burning (with the violation string) or that
        the batcher died, and ``shed_level`` reports the current
        brownout level — one curl tells an operator (or the fleet
        gateway, which records it per ejection) exactly why a replica
        left rotation."""
        batcher_alive = self.batcher.alive()
        draining = self.batcher.draining
        status = ("draining" if draining
                  else "ok" if batcher_alive else "degraded")
        reasons = []
        if not draining and not batcher_alive:
            reasons.append("batcher_dead")
        body = {"status": status,
                "model_loaded": self.registry.latest is not None,
                "batcher_alive": batcher_alive,
                "draining": draining,
                "queued_rows": self.batcher.queued_rows}
        if self.slo is not None:
            snap = self.slo.snapshot()
            body["slo"] = snap
            if snap["fast"].get("burning"):
                if body["status"] == "ok":
                    body["status"] = "degraded"
                reasons.append("slo_fast_burn: "
                               + str(snap["fast"].get("violation")))
            elif snap["slow"].get("burning"):
                # slow burn doesn't degrade routability, but the reason
                # is surfaced so the shed level below is explainable
                reasons.append("slo_slow_burn: "
                               + str(snap["slow"].get("violation")))
        body["shed_level"] = (self.shed.level()
                              if self.shed is not None else 0)
        body["reason"] = "; ".join(reasons) if reasons else None
        return body

    def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful shutdown: stop admitting, flush in-flight batches,
        then close the batcher."""
        self.batcher.drain(timeout_s)

    def close(self) -> None:
        self.batcher.close()
        if self.drift is not None:
            self.drift.close()


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightgbm-tpu-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> ServingApp:
        return self.server.app

    def log_message(self, fmt, *args):   # route to our logger, not stderr
        log.debug("http: " + fmt, *args)

    def _reply(self, code: int, body: dict,
               headers: Optional[dict] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, code: int, text: str,
                    content_type: str = "text/plain; version=0.0.4") -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _payload(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return {}
        try:
            return json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError as exc:
            raise BadRequest(f"invalid JSON body: {exc}") from exc

    def _dispatch(self, fn, headers: Optional[dict] = None) -> None:
        try:
            self._reply(200, fn(), headers)
        except BadRequest as exc:
            self._reply(400, {"error": str(exc)}, headers)
        except ModelNotFound as exc:
            self._reply(404, {"error": str(exc)}, headers)
        except OverloadedError as exc:
            self._reply(429, {"error": str(exc)}, headers)
        except RequestTimeout as exc:
            self._reply(504, {"error": str(exc)}, headers)
        except ValueError as exc:
            self._reply(400, {"error": str(exc)}, headers)
        except Exception as exc:   # noqa: BLE001 — JSON 500, keep serving
            log.warning("serving: internal error: %s", exc)
            self._reply(500, {"error": str(exc)}, headers)

    def do_GET(self):
        if self.path == "/stats":
            self._dispatch(self.app.stats_snapshot)
        elif self.path == "/metrics":
            try:
                self._reply_text(200, self.app.metrics_text())
            except Exception as exc:   # noqa: BLE001 — keep serving
                log.warning("serving: /metrics failed: %s", exc)
                self._reply(500, {"error": str(exc)})
        elif self.path == "/models":
            self._dispatch(self.app.models)
        elif self.path == "/router":
            self._dispatch(lambda: self.app.router.snapshot())
        elif self.path == "/router/audit":
            # the decision log: every stable/deploy/promote/demote with
            # the gate snapshot (counter deltas + thresholds) it was
            # decided on, plus the latest "hold" evaluation
            self._dispatch(lambda: self.app.router.audit_snapshot())
        elif self.path in ("/healthz", "/health"):
            # non-ok health is a 503 so load balancers stop routing
            # while drain/degradation is in progress
            try:
                body = self.app.health()
                self._reply(200 if body.get("status") == "ok" else 503,
                            body)
            except Exception as exc:   # noqa: BLE001 — keep serving
                self._reply(500, {"error": str(exc)})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path == "/predict":
            # every request gets an id (incoming X-Request-Id honored)
            # and the id always comes back in the response header —
            # whether or not this request was sampled for a full trace
            rid = ((self.headers.get("X-Request-Id") or "").strip()
                   or serve_trace.new_request_id())
            self._dispatch(
                lambda: self.app.predict(self._payload(), request_id=rid),
                headers={"X-Request-Id": rid})
        elif self.path == "/models":
            self._dispatch(lambda: self.app.load_model(self._payload()))
        elif self.path == "/router":
            self._dispatch(lambda: self.app.router_action(self._payload()))
        elif self.path == "/drain":
            # rollout tooling: stop admitting, flush in-flight work,
            # answer when the queue is empty — the caller then restarts
            # this process knowing zero requests were dropped
            def _drain():
                payload = self._payload()
                self.app.drain(float(payload.get("timeout_s", 5.0)))
                return self.app.health()
            self._dispatch(_drain)
        elif self.path == "/feedback":
            self._dispatch(
                lambda: self.app.feedback_record(self._payload()))
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})


def make_http_server(app: ServingApp, host: str = "127.0.0.1",
                     port: int = 8080) -> ThreadingHTTPServer:
    """Bind (port=0 for ephemeral) and return the server; caller runs
    serve_forever(), typically via `run_http_server`."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.app = app
    httpd.daemon_threads = True
    return httpd


def run_http_server(app: ServingApp, host: str = "127.0.0.1",
                    port: int = 8080, background: bool = False):
    httpd = make_http_server(app, host, port)
    log.info("serving: listening on http://%s:%d (POST /predict, "
             "GET /stats)", *httpd.server_address[:2])
    if background:
        t = threading.Thread(target=httpd.serve_forever,
                             name="lgbm-torch-http", daemon=True)
        t.start()
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:   # pragma: no cover
        pass
    finally:
        # graceful exit: stop admitting, flush what is queued, then
        # close — in-flight requests get answers, not connection resets
        app.drain()
        httpd.server_close()
        app.close()
    return httpd
