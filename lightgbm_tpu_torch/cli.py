"""Command-line application: train / predict / refit / convert_model /
serve / gateway / continual (port of lightgbm_tpu/cli.py).

Equivalent of the reference CLI (reference: src/main.cpp,
src/application/application.cpp:30-261). Usage matches the reference:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]
    python -m lightgbm_tpu_torch task=train data=binary.train \\
        objective=binary output_model=model.txt

`task=serve` (no reference equivalent) starts the online-inference HTTP
server on a saved model:

    python -m lightgbm_tpu_torch task=serve input_model=model.txt \\
        serve_port=8080

`task=gateway` is the fleet's HTTP front over ``task=serve`` replicas
(``gateway_manifest=`` or ``gateway_replicas=``); `task=continual` wraps
an embedded ``task=serve`` in the drift -> retrain -> canary -> promote
loop (``data=`` re-read at every retrain). A replica follows a fleet
manifest with ``serve_manifest=`` and keeps its warm entries across a
restart with ``serve_export_cache=auto``.

Every task that runs a model runs it on the card. ``device_type=cpu``
(or its alias ``device=cpu``) on the command line or in the config file
runs it on the CPU instead; the schema's default ``device_type``
(``cpu``, LightGBM's own) is not read as that request, so a command line
without the key needs a card and raises without one. The gateway holds
no model and touches no device.

Data-parallel training runs one process per device: ``num_machines=N
tree_learner=data`` with ``machines=host:port,...`` (or
``machine_list_filename``, or the LGBM_TPU_COORDINATOR /
_NUM_PROCESSES / _PROCESS_ID trio) joins the process group
(parallel/network.py); every rank reads the whole data file and trains
the same model, and rank 0 writes the model and its sidecars. Not ported
yet, refused naming its item in ROADMAP.md: elastic rejoin
(``LGBM_TPU_REJOIN``) and the supervised bring-up (``dist_heartbeat_ms >
0``).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config
from .utils import log
from .utils.log import LightGBMError

_DEVICE_KEYS = ("device_type", "device")


def parse_cli_args(argv) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" not in arg:
            log.warning("Unknown argument: %s", arg)
            continue
        k, v = arg.split("=", 1)
        params[k.strip()] = v.strip()
    # config file first, CLI args override (reference: main.cpp + config.cpp)
    if "config" in params:
        path = params.pop("config")
        with open(path) as f:
            file_params = {}
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line and "=" in line:
                    k, v = line.split("=", 1)
                    file_params[k.strip()] = v.strip()
        file_params.update(params)
        params = file_params
    return params


def cli_device(params: Dict[str, str]) -> Optional[str]:
    """The device a task runs on: None (the card) unless the command line
    names the CPU with ``device_type=cpu`` / ``device=cpu``;
    ``cuda`` / ``gpu`` name the card."""
    for key in _DEVICE_KEYS:
        if key in params:
            value = str(params[key]).strip().lower()
            if value == "cpu":
                return "cpu"
            if value in ("cuda", "gpu"):
                return None
            raise LightGBMError("%s=%s: lightgbm_tpu_torch runs on cuda "
                                "(the default) or cpu" % (key, value))
    return None


def _not_yet(what: str, item: str) -> LightGBMError:
    return LightGBMError("%s is not supported by lightgbm_tpu_torch yet "
                         "(ROADMAP.md section 1, %s)" % (what, item))


def run(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    params = parse_cli_args(argv)
    task = params.get("task")
    if task == "serve":
        # serve_* keys are serving-stack options, not training Config
        # parameters: dispatch before Config so they aren't warned away
        _serve(params)
        return 0
    if task == "gateway":
        _gateway(params)
        return 0
    if task == "continual":
        _continual(params)
        return 0
    cfg = Config(params)
    if cfg.task in ("train", "refit"):
        try:
            _train(params, cfg)
        finally:
            if cfg.num_machines > 1:
                from .parallel import network
                network.free()
    elif cfg.task in ("predict",):
        _predict(params, cfg)
    elif cfg.task == "convert_model":
        _convert_model(params, cfg)
    else:
        log.fatal("Unknown task: %s", cfg.task)
    return 0


# every spelling the config surface accepts for the boosting budget; a
# resumed run only adopts the checkpoint's recorded target_rounds when
# NONE of these was given explicitly (an explicit budget always wins)
_NUM_ITER_ALIASES = ("num_iterations", "num_iteration", "n_iter",
                     "num_tree", "num_trees", "num_round", "num_rounds",
                     "num_boost_round", "n_estimators")


def _init_network(cfg: Config) -> None:
    """Join the process group of a multi-machine run (num_machines > 1);
    a replacement process (LGBM_TPU_REJOIN) is a later slice's."""
    if os.environ.get("LGBM_TPU_REJOIN", "") == "1":
        raise _not_yet("LGBM_TPU_REJOIN (elastic rejoin)",
                       "item 5, multi-GPU elastic rejoin")
    if cfg.num_machines > 1:
        from .parallel import network
        machines = cfg.machines
        if not machines and cfg.machine_list_filename:
            with open(cfg.machine_list_filename) as f:
                machines = ",".join(
                    line.strip().replace(" ", ":") for line in f
                    if line.strip())
        network.init_from_params(machines, cfg.local_listen_port,
                                 cfg.num_machines,
                                 machine_rank=cfg.machine_rank,
                                 coordinator=cfg.coordinator,
                                 supervise=cfg.dist_heartbeat_ms > 0)


def _train(params: Dict[str, str], cfg: Config) -> None:
    _init_network(cfg)
    device = cli_device(params)
    # graceful preemption: SIGTERM/SIGINT arms a flag that the boosting
    # loop checks at the next iteration boundary (emergency checkpoint,
    # exit code 76; resilience/preempt.py)
    from .distributed.checkpoint import (DistributedCheckpointManager,
                                         restore_for_resume)
    from .resilience import faults, preempt
    preempt.install_handlers()
    if not cfg.data:
        log.fatal("No training data: set data=<file>")
    if cfg.task == "refit":
        if not cfg.input_model:
            log.fatal("task=refit requires input_model")
        prev = Booster(model_file=cfg.input_model, device=device)
        x, y, _ = _load_matrix(cfg.data)
        prev.refit(x, y)
        prev.save_model(cfg.output_model)
        log.info("Refit model saved to %s", cfg.output_model)
        return
    t0 = time.time()
    train_set = Dataset(cfg.data, params=params, device=device)
    train_set.construct()
    log.info("Finished loading data in %.3f seconds", time.time() - t0)
    booster = Booster(params=params, train_set=train_set)
    for i, vpath in enumerate(cfg.valid or []):
        vset = train_set.create_valid(vpath)
        booster.add_valid(vset, f"valid_{i + 1}" if i else "valid_1")
    if cfg.input_model:
        from .engine import _load_init_model
        _load_init_model(booster, cfg.input_model)
    ckpt_dir = cfg.output_model + ".ckpt"
    resume_meta = None
    if cfg.resume:
        # resume=auto resumes from the run's own checkpoint directory;
        # any other value is a checkpoint file or directory path. Across
        # ranks rank 0 reads it and broadcasts the bytes
        src = (ckpt_dir if str(cfg.resume).lower() in ("auto", "true", "1")
               else cfg.resume)
        data = restore_for_resume(booster, src)
        resume_meta = data.meta or {}
        log.info("Resumed training at iteration %d",
                 booster.current_iteration())
    mgr = None
    if cfg.checkpoint_freq > 0:
        # rank 0 writes, every rank meets at the barrier after a save
        mgr = DistributedCheckpointManager(ckpt_dir,
                                           keep_last=cfg.snapshot_keep)
    num_iters = cfg.num_iterations
    if resume_meta is not None and resume_meta.get("target_rounds") \
            and not any(k in params for k in _NUM_ITER_ALIASES):
        # the checkpoint (emergency-preempt or periodic) recorded the
        # run's original budget: a bare `resume=auto` relaunch finishes
        # THAT run, not the config default
        num_iters = int(resume_meta["target_rounds"])
        log.info("resume: continuing to the checkpoint's recorded "
                 "target of %d rounds", num_iters)
    metric_freq = max(1, cfg.metric_freq)
    snapshot_freq = cfg.snapshot_freq
    t0 = time.time()

    def _emergency_exit(it):
        """Graceful-preemption exit (as engine._preempt_exit): checkpoint
        at THIS iteration boundary, stamp target_rounds, and leave with
        the contract exit code 76."""
        from . import telemetry
        m = mgr or DistributedCheckpointManager(
            ckpt_dir, keep_last=cfg.snapshot_keep)
        path = m.save(booster,
                      extra_meta={"target_rounds": int(num_iters),
                                  "preempted": True,
                                  "preempt_reason": preempt.reason()},
                      allow_rejoin=False) or ckpt_dir
        telemetry.events.emit("preempt", phase="exit", iteration=int(it),
                              path=path, exit_code=preempt.PREEMPT_EXIT_CODE)
        telemetry.events.flush()
        log.warning("preempted (%s): emergency checkpoint at iteration "
                    "%d -> %s; exiting %d (resume=auto continues to "
                    "round %d)", preempt.reason(), it, path,
                    preempt.PREEMPT_EXIT_CODE, num_iters)
        raise SystemExit(preempt.PREEMPT_EXIT_CODE)

    preempt.resolve_group_sync()
    try:
        for it in range(booster.current_iteration(), num_iters):
            # chaos boundary, same placement as engine.train
            faults.kill_point(it)
            faults.set_epoch(it)
            if preempt.group_requested():
                _emergency_exit(it)                 # never returns
            t_it = time.time()
            stop = booster.update()
            log.info("%.6f seconds elapsed, finished iteration %d",
                     time.time() - t_it, it + 1)
            if (it + 1) % metric_freq == 0:
                for dname, mname, val, _ in booster.eval():
                    log.info("Iteration:%d, %s %s : %g", it + 1,
                             dname, mname, val)
            if snapshot_freq > 0 and (it + 1) % snapshot_freq == 0:
                _write_snapshot(booster, cfg, it + 1)
            if mgr is not None and (it + 1) % cfg.checkpoint_freq == 0:
                mgr.save(booster,
                         extra_meta={"target_rounds": int(num_iters)})
            if stop:
                break
    finally:
        faults.set_epoch(-1)
    log.info("Finished training in %.3f seconds", time.time() - t0)
    from . import telemetry
    if telemetry.enabled():
        # one-line JSON so CLI logs are grep-able
        import json
        log.info("telemetry summary: %s",
                 json.dumps(telemetry.telemetry_summary()))
        if telemetry.events.sink_path():
            telemetry.events.flush()
            log.info("telemetry events written to %s",
                     telemetry.events.sink_path())
        if telemetry.mode() == "trace":
            trace_path = cfg.output_model + ".trace.json"
            telemetry.dump_trace(trace_path)
            log.info("telemetry trace written to %s", trace_path)
    # drift baseline: a sidecar so serving can judge served traffic
    # against the training data (computed on every rank: the score fetch
    # of a data-parallel run is a collective)
    baseline = None
    try:
        baseline = booster._gbdt.drift_baseline()
    except Exception as exc:   # noqa: BLE001 — baseline is best-effort
        log.warning("drift baseline capture failed: %s", exc)
    from .distributed import bootstrap
    if bootstrap.rank() != 0:
        log.info("rank %d: model output is rank-0 work", bootstrap.rank())
        return
    booster.save_model(cfg.output_model)
    log.info("Model saved to %s", cfg.output_model)
    if baseline:
        from .serving.drift import save_baseline
        sidecar = save_baseline(baseline, cfg.output_model + ".drift.json")
        log.info("Drift baseline saved to %s (%d features)",
                 sidecar, len(baseline.get("features", [])))
    # edge-transform sidecar: the fitted bin mappers, so a gateway can
    # accept raw CSV/JSON rows (serving/transforms.py)
    try:
        from .serving.transforms import capture_transform, save_transform
        spec = capture_transform(train_set)
        sidecar = save_transform(spec, cfg.output_model + ".transform.json")
        log.info("Edge transform saved to %s (%d mapped features)",
                 sidecar, len(spec.get("mappers", {})))
    except Exception as exc:   # noqa: BLE001 — sidecar is best-effort
        log.warning("edge transform capture failed: %s", exc)


def _write_snapshot(booster: Booster, cfg: Config, iteration: int) -> None:
    """Model-text snapshot, atomic (temp file + os.replace) and rotated
    to the newest `snapshot_keep` files."""
    import glob
    import re
    from .distributed import bootstrap
    from .resilience.checkpoint import atomic_write_text
    if bootstrap.rank() != 0:     # snapshots are rank-0 work, as the model
        return
    atomic_write_text(f"{cfg.output_model}.snapshot_iter_{iteration}",
                      booster.model_to_string(num_iteration=-1))
    snaps = []
    for p in glob.glob(f"{cfg.output_model}.snapshot_iter_*"):
        m = re.search(r"\.snapshot_iter_(\d+)$", p)
        if m:
            snaps.append((int(m.group(1)), p))
    snaps.sort()
    for _, p in snaps[:max(0, len(snaps) - max(1, cfg.snapshot_keep))]:
        try:
            os.unlink(p)
        except OSError:  # pragma: no cover - raced away
            pass


def _load_matrix(path: str):
    from .io.parser import parse_file
    return parse_file(path)


def _predict(params: Dict[str, str], cfg: Config) -> None:
    if not cfg.input_model:
        log.fatal("task=predict requires input_model")
    if not cfg.data:
        log.fatal("No prediction data: set data=<file>")
    booster = Booster(model_file=cfg.input_model, device=cli_device(params))
    x, _, _ = _load_matrix(cfg.data)
    t0 = time.time()
    preds = booster.predict(
        x, raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index,
        pred_contrib=cfg.predict_contrib,
        num_iteration=cfg.num_iteration_predict
        if cfg.num_iteration_predict > 0 else None)
    log.info("Finished prediction in %.3f seconds", time.time() - t0)
    out = cfg.output_result or "LightGBM_predict_result.txt"
    preds = np.atleast_2d(np.asarray(preds))
    if preds.shape[0] == 1 and preds.size > preds.shape[1]:
        preds = preds.T
    if preds.ndim == 1:
        preds = preds.reshape(-1, 1)
    if preds.shape[0] != x.shape[0]:
        preds = preds.reshape(x.shape[0], -1)
    with open(out, "w") as f:
        for row in preds:
            f.write("\t".join(f"{v:g}" for v in np.atleast_1d(row)) + "\n")
    log.info("Prediction results saved to %s", out)


def _serve(params: Dict[str, str], block: bool = True):
    """task=serve: load + warm a saved model, run the HTTP server.

    Options (all `serve_*` to stay clear of the training namespace):
    serve_host, serve_port, serve_max_batch, serve_max_delay_ms,
    serve_queue_rows, serve_timeout_ms, serve_warm_buckets (csv),
    serve_export_cache (``auto``/``1`` or an explicit directory -- keep
    the warm entries' specs next to the model, so a restart installs
    them instead of building them), serve_placement (``auto`` or
    ``version=ordinal,...`` CUDA pins), serve_predictor_cache_entries
    (LRU bound, 0 = unbounded), serve_slo_p99_ms / serve_slo_error_rate
    (burn-rate SLOs -- either non-zero arms the monitor),
    serve_trace_sample (request-trace sampling rate; env
    LGBM_TPU_TRACE_SAMPLE wins when set), drift_psi_threshold (PSI alarm
    level when the model ships a ``.drift.json`` baseline sidecar),
    serve_shed (``auto`` arms the brownout load shedder whenever an SLO
    monitor is armed; 1/0 force), feedback_min_labels /
    feedback_auc_epsilon (the router's labelled feedback gate),
    serve_manifest (fleet manifest path to poll and converge on -- may
    replace input_model entirely: the replica loads whatever the
    manifest deploys), serve_manifest_poll_s (poll period),
    serve_manifest_publish (bind this replica's router transitions back
    into the manifest -- exactly one replica per fleet should). The
    model runs on the card unless ``device_type=cpu``.
    """
    from .serving import (ModelRegistry, PredictorCache, ServingApp,
                          run_http_server)
    device = cli_device(params)
    model_file = params.get("input_model") or params.get("model")
    manifest_path = str(params.get("serve_manifest", "")).strip() or None
    if not model_file and not manifest_path:
        log.fatal("task=serve requires input_model or serve_manifest")
    warm = [int(v) for v in
            str(params.get("serve_warm_buckets", "1,16,256")).split(",") if v]
    export_cache = None
    cache_opt = str(params.get("serve_export_cache", "")).strip()
    if cache_opt and cache_opt.lower() not in ("0", "false", "off"):
        from .fleet import ExportCache, cache_dir_for_model
        cache_dir = (cache_dir_for_model(model_file or manifest_path)
                     if cache_opt.lower() in ("1", "true", "on", "auto")
                     else cache_opt)
        export_cache = ExportCache(cache_dir)
    placement = None
    place_opt = str(params.get("serve_placement", "")).strip()
    if place_opt and place_opt.lower() not in ("0", "false", "off"):
        from .fleet import PlacementPlan
        placement = PlacementPlan(
            "" if place_opt.lower() in ("1", "true", "on") else place_opt)
    max_entries = int(params.get("serve_predictor_cache_entries", 0)) or None
    registry = ModelRegistry(
        predictor=PredictorCache(max_entries=max_entries),
        warm_buckets=warm, export_cache=export_cache, placement=placement,
        device=device)
    slo = None
    slo_p99 = float(params.get("serve_slo_p99_ms", 0.0) or 0.0)
    slo_err = float(params.get("serve_slo_error_rate", 0.0) or 0.0)
    if slo_p99 > 0.0 or slo_err > 0.0:
        from .serving.slo import SloMonitor
        slo = SloMonitor(p99_ms=slo_p99, error_rate=slo_err)
    shed = None
    shed_opt = str(params.get("serve_shed", "auto")).strip().lower()
    if shed_opt in ("1", "true", "on") or (shed_opt == "auto"
                                           and slo is not None):
        from .serving.shed import LoadShedder
        shed = LoadShedder(slo=slo)
    from .serving import trace as serve_trace
    if os.environ.get("LGBM_TPU_TRACE_SAMPLE", "").strip():
        serve_trace.configure()           # env wins over the param
    elif "serve_trace_sample" in params:
        serve_trace.configure(float(params["serve_trace_sample"]))
    app = ServingApp(
        registry,
        slo=slo,
        shed=shed,
        max_batch=int(params.get("serve_max_batch", 256)),
        max_delay_ms=float(params.get("serve_max_delay_ms", 2.0)),
        max_queue_rows=int(params.get("serve_queue_rows", 4096)),
        default_timeout_ms=float(params.get("serve_timeout_ms", 5000.0)))
    fb_min = int(params.get("feedback_min_labels", 0) or 0)
    if fb_min > 0:
        # labeled-feedback promotion gate (POST /feedback): the canary
        # must accrue fb_min labels and hold AUC within epsilon of stable
        app.router.feedback_min_labels = fb_min
        app.router.feedback_auc_epsilon = float(
            params.get("feedback_auc_epsilon", 0.02))
    t0 = time.time()
    if model_file:
        version = registry.load(model_file)
        app.router.set_stable(version)
        baseline = registry.drift_baselines.get(version)
        if baseline is not None:
            from .serving.drift import DriftMonitor
            thr = params.get("drift_psi_threshold")
            app.drift = DriftMonitor(
                baseline,
                threshold=(float(thr) if thr is not None else None))
            log.info("Drift monitor armed (threshold %.3f, %d features)",
                     app.drift.threshold,
                     len(baseline.get("features", [])))
        log.info("Loaded + warmed model %s on %s in %.3f seconds (buckets "
                 "%s%s)", version, registry.get(version).device_key,
                 time.time() - t0, warm,
                 ", export cache %s" % export_cache.last_restore
                 if export_cache else "")
    follower = None
    if manifest_path:
        from .fleet.manifest import ManifestFollower, ManifestPublisher
        follower = ManifestFollower(
            app, manifest_path,
            poll_s=float(params.get("serve_manifest_poll_s", 0.5)))
        # converge BEFORE binding the port, so /healthz only reports ok
        # once the manifest's models are loaded and warmed -- and before
        # binding the publisher, so the initial convergence doesn't
        # republish its own state
        follower.poll_once()
        pub_opt = str(params.get("serve_manifest_publish", "")).lower()
        if pub_opt in ("1", "true", "on"):
            ManifestPublisher(manifest_path).bind_router(app.router,
                                                         registry)
        follower.start()
        log.info("Manifest follower armed on %s (rev %d, stable %s%s)",
                 manifest_path, follower._applied_rev, app.router.stable,
                 ", export cache %s" % export_cache.last_restore
                 if export_cache else "")
    if app.router.stable is None and registry.latest is None:
        log.fatal("task=serve: no model from input_model or manifest")
    httpd = run_http_server(
        app, host=params.get("serve_host", "127.0.0.1"),
        port=int(params.get("serve_port", 8080)), background=not block)
    if block:
        if follower is not None:
            follower.stop()
        _exit_clean()
    httpd.follower = follower
    return httpd


def _exit_clean() -> None:
    """Stopped (SIGINT), drained, the worker threads joined and the
    socket closed: leave without the interpreter's finalization. There a
    daemon thread still inside a torch call is ended by pthread_exit,
    which aborts the process ("terminate called without an active
    exception": one stop in 34 on the card) and turns a clean stop into
    exit code -6."""
    import atexit
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _gateway(params: Dict[str, str], block: bool = True):
    """task=gateway: the fleet HTTP front over N task=serve replicas
    (either package's). It holds no model and touches no device.

    Options (all ``gateway_*``): gateway_host, gateway_port,
    gateway_manifest (fleet manifest supplying the replica set, model
    sources and the edge-transform sidecar), gateway_replicas
    (comma-separated base URLs when running without a manifest),
    gateway_retries, gateway_backoff_ms, gateway_eject_s,
    gateway_health_period_s, gateway_timeout_ms, gateway_transform
    (explicit ``.transform.json`` path for raw CSV/JSON ingestion),
    gateway_hedge_ms (tail-latency hedging: duplicate a /predict to a
    second replica after this many ms without an answer; 0 = off).
    """
    from .fleet.gateway import FleetGateway, run_gateway_server
    replicas = [u for u in
                str(params.get("gateway_replicas", "")).split(",") if u]
    manifest = str(params.get("gateway_manifest", "")).strip() or None
    if not replicas and not manifest:
        log.fatal("task=gateway requires gateway_replicas or "
                  "gateway_manifest")
    transform = None
    tpath = params.get("gateway_transform")
    if tpath:
        from .serving.transforms import EdgeTransform, load_transform
        spec = load_transform(tpath)
        if spec is None:
            log.fatal("gateway_transform %s is not an edge-transform "
                      "sidecar", tpath)
        transform = EdgeTransform(spec)
    gateway = FleetGateway(
        replicas=replicas, manifest_path=manifest, transform=transform,
        retries=int(params.get("gateway_retries", 1)),
        backoff_s=float(params.get("gateway_backoff_ms", 50.0)) / 1e3,
        eject_s=float(params.get("gateway_eject_s", 2.0)),
        health_period_s=float(params.get("gateway_health_period_s", 0.5)),
        timeout_s=float(params.get("gateway_timeout_ms", 10000.0)) / 1e3,
        hedge_s=float(params.get("gateway_hedge_ms", 0.0)) / 1e3)
    return run_gateway_server(
        gateway, host=params.get("gateway_host", "127.0.0.1"),
        port=int(params.get("gateway_port", 8088)),
        background=not block)


def _continual(params: Dict[str, str], block: bool = True):
    """task=continual: the closed loop drift -> retrain -> canary ->
    audited promote, wrapped around an embedded ``task=serve``.

    All ``serve_*`` options apply (the drift monitor needs the model's
    ``.drift.json`` sidecar to arm -- train writes it). Loop options:
    ``data=<file>`` (the refreshed training extract, RE-READ at every
    retrain so an operator pipeline can keep it current),
    ``continual_policy`` (refit/continue/auto), ``continual_cooldown_s``,
    ``continual_topup_rounds``, ``continual_canary_weight``,
    ``refit_decay_rate``, ``feedback_min_labels`` /
    ``feedback_auc_epsilon`` (labelled-feedback promotion gate),
    ``continual_checkpoint_dir`` (persist every retrained model + drift
    sidecar), ``continual_poll_s``. Retraining runs on the card unless
    ``device_type=cpu``.
    """
    from .continual.loop import ContinualLoop
    from .continual.update import continue_training
    data_path = str(params.get("data", "")).strip()
    if not data_path:
        log.fatal("task=continual requires data=<file> — the refreshed "
                  "training extract re-read at every retrain")
    policy = str(params.get("continual_policy", "auto")).strip() or "auto"
    if policy not in ("refit", "continue", "auto"):
        log.fatal("continual_policy must be one of refit/continue/auto, "
                  "got %s", policy)
    device = cli_device(params)
    httpd = _serve(params, block=False)
    app = httpd.app
    decay = float(params.get("refit_decay_rate", 0.9))
    topup = int(params.get("continual_topup_rounds", 10))

    def retrain(action: str) -> Booster:
        # start from the version traffic trusts NOW (router stable),
        # via model text so the served tensors are never mutated while
        # they are still taking traffic
        stable = app.router.stable or app.registry.latest
        prev = Booster(model_str=app.registry.get(stable).gbdt
                       .save_model_to_string(num_iteration=-1),
                       device=device)
        x, y, _ = _load_matrix(data_path)
        if action == "refit":
            return prev.refit(x, y, decay_rate=decay)
        return continue_training(prev, Dataset(x, label=y, device=device),
                                 num_boost_round=topup)

    loop = ContinualLoop(
        app.registry, app.router, retrain, policy=policy,
        cooldown_s=float(params.get("continual_cooldown_s", 30.0)),
        canary_weight=float(params.get("continual_canary_weight", 0.2)),
        poll_s=float(params.get("continual_poll_s", 1.0)),
        checkpoint_dir=(str(params.get("continual_checkpoint_dir", ""))
                        .strip() or None))
    loop.start()
    log.info("continual loop armed (policy %s, cooldown %.1fs, data %s)",
             policy, loop.cooldown_s, data_path)
    if not block:
        return httpd, loop
    # the serve thread is already running (block=False serve above);
    # park here until the operator stops the process
    import threading
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        loop.stop()
        if httpd.follower is not None:
            httpd.follower.stop()
        httpd.shutdown()
        app.drain()
        httpd.server_close()
        app.close()
    # the loop's thread may have been inside a torch call
    _exit_clean()


def _convert_model(params: Dict[str, str], cfg: Config) -> None:
    """Model -> C++ if-else source (reference: gbdt_model_text.cpp:128
    ModelToIfElse)."""
    if not cfg.input_model:
        log.fatal("task=convert_model requires input_model")
    booster = Booster(model_file=cfg.input_model, device=cli_device(params))
    out = cfg.convert_model or "gbdt_prediction.cpp"
    from .io.codegen import model_to_ifelse
    with open(out, "w") as f:
        f.write(model_to_ifelse(booster._gbdt))
    log.info("Converted model saved to %s", out)


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
