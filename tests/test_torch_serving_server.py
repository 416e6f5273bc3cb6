"""The port's HTTP front end and CLI against the JAX package's.

Both packages serve the same JAX-written model text over HTTP on
127.0.0.1 (the port on the CPU); one sequence of calls covers every
endpoint of the JAX server's docstring, and each answer's status and JSON
keys (nested, counters and versions included) must equal the JAX app's,
with predictions within 1e-6. Then `task=serve` in process, `task=train`'s
sidecars against the JAX CLI's, the fleet and continual paths on the CPU
(the export cache, manifests, `task=gateway`, `task=continual`), and the
path this package still refuses (naming its item in ROADMAP.md).
"""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import serving as jserving
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu_torch import serving as tserving
from lightgbm_tpu_torch import telemetry as ttelemetry
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


def _data(n=600, seed=7):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    return x, (m + 0.5 * r.randn(n) > 0).astype(np.float64)


def _text(seed, rounds=5):
    x, y = _data(seed=seed)
    b = jlgb.train({"objective": "binary", "num_leaves": 15,
                    "min_data_in_leaf": 20, "max_bin": 63,
                    "verbosity": -1}, jlgb.Dataset(x, y), rounds,
                   verbose_eval=False)
    return b.model_to_string(num_iteration=-1)


BASELINE = {"format": "lgbm_tpu_drift_baseline", "version": 1,
            "n_rows": 1000, "features": [
                {"index": 0, "edges": [-0.5, 0.0, 0.5], "has_nan": False,
                 "occupancy": [0.25, 0.25, 0.25, 0.25]}]}


def _start(pkg, text, **app_kw):
    slo = pkg.SloMonitor(p99_ms=10000.0)
    kw = dict(slo=slo, shed=pkg.LoadShedder(slo=slo),
              drift=pkg.DriftMonitor(BASELINE, min_interval_s=0),
              max_batch=32, max_delay_ms=2.0, max_queue_rows=256)
    reg_kw = {"device": "cpu"} if pkg is tserving else {}
    reg = pkg.ModelRegistry(warm_buckets=(8,), **reg_kw)
    reg.load(text, version="v1")
    app = pkg.ServingApp(reg, **kw, **app_kw)
    httpd = pkg.make_http_server(app, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, app, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, app):
    httpd.shutdown()
    httpd.server_close()
    app.close()


def _call(base, method, path, payload=None, headers=None):
    data = None if method == "GET" else json.dumps(payload or {}).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=dict({"Content-Type":
                                               "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            body, code, hdrs = resp.read(), resp.status, dict(resp.headers)
    except urllib.error.HTTPError as exc:
        body, code, hdrs = exc.read(), exc.code, dict(exc.headers)
    try:
        return code, json.loads(body), hdrs
    except ValueError:
        return code, body.decode(), hdrs


def _shape(obj):
    """The JSON keys of an answer, nested (list items by their union)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        shapes = [_shape(v) for v in obj if isinstance(v, (dict, list))]
        return ["list", json.dumps(shapes, sort_keys=True)
                if shapes else "scalars"]
    return "value"


def _families(text):
    return sorted({ln.split("{")[0].split(" ")[0]
                   for ln in text.splitlines()
                   if ln and not ln.startswith("#")
                   and ("serve_" in ln or "predictor_cache_" in ln)})


def test_every_endpoint_answers_like_the_jax_app():
    text, text2 = _text(7), _text(11)
    x, y = _data(seed=99)
    for tel in (jtelemetry, ttelemetry):
        tel.reset()
    servers = [_start(jserving, text), _start(tserving, text)]
    rows = x[:4].tolist()
    calls = [
        ("GET", "/healthz", None),
        ("GET", "/health", None),
        ("POST", "/predict", {"rows": rows}),
        ("POST", "/predict", {"rows": rows, "raw_score": True}),
        ("POST", "/predict", {"rows": x[:40].tolist(), "version": "v1"}),
        ("POST", "/models", {"model_str": text2, "version": "v2"}),
        ("GET", "/models", None),
        ("POST", "/router", {"action": "stable", "version": "v1"}),
        ("POST", "/router", {"action": "deploy", "version": "v2",
                             "weight": 0.5}),
        ("POST", "/predict", {"rows": rows}),
        ("POST", "/predict", {"rows": rows}),
        ("POST", "/predict", {"rows": rows, "priority": "versioned",
                              "version": "v2"}),
        ("GET", "/router", None),
        ("GET", "/router/audit", None),
        ("POST", "/feedback", {"version": "v1", "labels": y[:6].tolist(),
                               "scores": np.linspace(0, 1, 6).tolist()}),
        ("POST", "/router", {"action": "demote", "reason": "test"}),
        ("POST", "/router", {"action": "deploy", "version": "v2",
                             "shadow": True}),
        ("POST", "/router", {"action": "promote"}),
        ("GET", "/stats", None),
        ("GET", "/nope", None),
        ("POST", "/nope", {}),
        ("POST", "/predict", {}),
        ("POST", "/predict", {"rows": rows, "priority": "bogus"}),
        ("POST", "/predict", {"rows": rows, "version": "no-such"}),
        ("POST", "/router", {"action": "bogus"}),
        ("POST", "/feedback", {"labels": [1]}),
        ("POST", "/models", {}),
    ]
    try:
        for method, path, payload in calls:
            (jc, jb, _), (tc, tb, _) = [_call(base, method, path, payload)
                                        for _, _, base in servers]
            assert tc == jc, (method, path, tc, jc)
            assert _shape(tb) == _shape(jb), (method, path)
            if path == "/predict" and tc == 200:
                assert tb["version"] == jb["version"]
                np.testing.assert_allclose(tb["predictions"],
                                           jb["predictions"], atol=1e-6)
        jm, tm = [_call(base, "GET", "/metrics")[1]
                  for _, _, base in servers]
        assert "lgbm_tpu_serve_requests_total" in tm
        assert _families(tm) == _families(jm)
        # a request id is honored and echoed
        for _, _, base in servers:
            code, _, hdrs = _call(base, "POST", "/predict", {"rows": rows},
                                  headers={"X-Request-Id": "rid-7"})
            assert code == 200 and hdrs.get("X-Request-Id") == "rid-7"
        (jc, jb, _), (tc, tb, _) = [_call(base, "POST", "/drain", {})
                                    for _, _, base in servers]
        assert tc == jc == 200 and _shape(tb) == _shape(jb)
        (jc, jb, _), (tc, tb, _) = [_call(base, "GET", "/healthz")
                                    for _, _, base in servers]
        assert tc == jc == 503 and tb["status"] == jb["status"] == \
            "draining"
        # after the drain the batcher is closed: both answer alike
        (jc, jb, _), (tc, tb, _) = [_call(base, "POST", "/predict",
                                          {"rows": rows})
                                    for _, _, base in servers]
        assert tc == jc and _shape(tb) == _shape(jb)
    finally:
        for httpd, app, _ in servers:
            _stop(httpd, app)


def test_http_trace_spans_carry_the_request_id():
    from lightgbm_tpu_torch.serving import trace as ttrace
    from lightgbm_tpu_torch.telemetry import events
    ttelemetry.set_mode("summary")
    ttrace.configure(1.0)
    httpd, app, base = _start(tserving, _text(7))
    try:
        x, _ = _data(seed=5)
        code, body, hdrs = _call(base, "POST", "/predict",
                                 {"rows": x[:3].tolist()},
                                 headers={"X-Request-Id": "trace-me"})
        assert code == 200 and hdrs["X-Request-Id"] == "trace-me"
        spans = [e for e in events.events("trace_span")
                 if e.get("trace") == "trace-me"]
        assert {s["span"] for s in spans} >= {"batcher", "predictor",
                                              "server"}
    finally:
        _stop(httpd, app)
        ttelemetry.set_mode("off")
        ttelemetry.reset()
        ttrace.reset()


def test_drain_flushes_queued_requests_then_closes():
    text = _text(7)
    x, _ = _data(seed=5)
    reg = tserving.ModelRegistry(warm_buckets=(4,), device="cpu")
    reg.load(text)
    batcher = tserving.MicroBatcher(reg, max_batch=8, start=False)
    handles = batcher.submit_async(x[:3].tolist())
    assert batcher.queued_rows == 3
    batcher.drain(timeout_s=5.0)
    out, version = handles[0].wait(0.1)          # already flushed
    ref = jlgb.Booster(model_str=text).predict(x[:3])
    np.testing.assert_allclose(out[:, 0], ref, atol=1e-6)
    assert not batcher.alive()
    with pytest.raises(RuntimeError):
        batcher.submit_async(x[:1].tolist())


# ---------------------------------------------------------------------------
# the CLI

def test_cli_serve_task_in_process(tmp_path):
    from lightgbm_tpu_torch.cli import _serve
    text = _text(7)
    path = tmp_path / "model.txt"
    path.write_text(text)
    httpd = _serve({"task": "serve", "input_model": str(path),
                    "device_type": "cpu", "serve_port": "0",
                    "serve_warm_buckets": "4", "serve_max_batch": "32",
                    "serve_slo_p99_ms": "10000"}, block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        x, _ = _data(seed=5)
        code, out, _ = _call(base, "POST", "/predict",
                             {"rows": x[:2].tolist()})
        assert code == 200
        np.testing.assert_allclose(
            out["predictions"], jlgb.Booster(model_str=text).predict(x[:2]),
            atol=1e-6)
        assert httpd.app.router.stable == out["version"]
        assert httpd.app.shed is not None      # serve_shed=auto with SLO
        assert httpd.app.registry.versions()[0]["device"] == "cpu"
        code, health, _ = _call(base, "POST", "/drain", {})
        assert code == 200 and health["status"] == "draining"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.app.close()


def _write_csv(tmp_path):
    r = np.random.RandomState(0)
    x = r.randn(500, 6)
    x[r.rand(500) < 0.05, 3] = np.nan
    y = (x[:, 0] + 0.5 * r.randn(500) > 0).astype(int)
    path = str(tmp_path / "train.csv")
    np.savetxt(path, np.column_stack([y, x]), delimiter=",", fmt="%.6f")
    return path


def test_cli_train_sidecars_equal_the_jax_clis(tmp_path):
    from lightgbm_tpu.cli import run as jrun
    from lightgbm_tpu_torch.cli import run as trun
    from lightgbm_tpu_torch.serving.drift import load_baseline
    data = _write_csv(tmp_path)
    common = [f"data={data}", "objective=binary", "num_iterations=4",
              "num_leaves=7", "min_data_in_leaf=20", "verbosity=-1"]
    jm, tm = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jrun(["task=train", f"output_model={jm}"] + common) == 0
    assert trun(["task=train", f"output_model={tm}", "device_type=cpu"]
                + common) == 0
    with open(jm + ".transform.json") as a, open(tm + ".transform.json") as b:
        assert json.load(b) == json.load(a)
    jb, tb = load_baseline(jm + ".drift.json"), load_baseline(
        tm + ".drift.json")
    assert tb["features"] == jb["features"] and tb["features"]
    assert tb["n_rows"] == jb["n_rows"]
    assert tb["score"]["occupancy"] == jb["score"]["occupancy"]
    np.testing.assert_allclose(tb["score"]["edges"], jb["score"]["edges"],
                               rtol=0, atol=1e-5)
    # the port's task=predict reads the JAX-written model
    jout, tout = str(tmp_path / "jp.txt"), str(tmp_path / "tp.txt")
    assert jrun(["task=predict", f"data={data}", f"input_model={jm}",
                 f"output_result={jout}"]) == 0
    assert trun(["task=predict", f"data={data}", f"input_model={jm}",
                 f"output_result={tout}", "device=cpu"]) == 0
    np.testing.assert_allclose(np.loadtxt(tout), np.loadtxt(jout),
                               rtol=1e-5, atol=1e-6)


def test_refused_paths_name_their_slice(tmp_path, monkeypatch):
    from lightgbm_tpu_torch.cli import run
    monkeypatch.delenv("LGBM_TPU_REJOIN", raising=False)
    # num_machines > 1 trains data-parallel since the multi-GPU slice
    # (tests/test_torch_parallel.py); its supervised bring-up is refused
    with pytest.raises(LightGBMError, match=r"ROADMAP\.md section 1"):
        run(["task=train", "data=x.csv", "num_machines=2",
             "dist_heartbeat_ms=100", "device_type=cpu"])


def _stop_serve(httpd):
    httpd.shutdown()
    httpd.server_close()
    httpd.app.close()
    if getattr(httpd, "follower", None) is not None:
        httpd.follower.stop()


def _lifted(tmp_path, what):
    """Each path the port refused until the fleet and continual slice,
    run on the CPU."""
    from lightgbm_tpu_torch import fleet
    from lightgbm_tpu_torch.cli import _continual, _gateway, _serve, run
    model = str(tmp_path / "m.txt")
    with open(model, "w") as f:
        f.write(_text(7, rounds=2))
    serve = {"task": "serve", "input_model": model, "device_type": "cpu",
             "serve_port": "0", "serve_warm_buckets": "4"}
    x, y = _data(seed=3)
    if what == "gateway":
        httpd = _serve(serve, block=False)
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        gw = _gateway({"task": "gateway", "gateway_replicas": url,
                       "gateway_port": "0"}, block=False)
        try:
            base = "http://127.0.0.1:%d" % gw.server_address[1]
            code, out, _ = _call(base, "POST", "/predict",
                                 {"rows": x[:3].tolist()})
            assert code == 200
            np.testing.assert_allclose(
                out["predictions"],
                jlgb.Booster(model_str=_text(7, rounds=2)).predict(x[:3]),
                atol=1e-6)
        finally:
            gw.shutdown()
            gw.server_close()
            gw.gateway.stop()
            _stop_serve(httpd)
    elif what == "continual":
        with pytest.raises(LightGBMError,
                           match="task=continual requires data=<file>"):
            run(["task=continual", "device_type=cpu"])
        data = str(tmp_path / "train.csv")
        np.savetxt(data, np.column_stack([y, x]), delimiter=",",
                   fmt="%.6f")
        httpd, loop = _continual(dict(serve, task="continual", data=data,
                                      continual_poll_s="60"), block=False)
        try:
            base = "http://127.0.0.1:%d" % httpd.server_address[1]
            assert _call(base, "GET", "/healthz")[0] == 200
            assert loop.step() == "wait"        # no drift fire yet
            assert loop.snapshot()["policy"] == "auto"
        finally:
            loop.stop()
            _stop_serve(httpd)
    elif what == "export_cache":
        httpd = _serve(dict(serve, serve_export_cache="auto"), block=False)
        _stop_serve(httpd)
        assert fleet.ExportCache(model + ".xcache").info()["entries"] == 1
        again = _serve(dict(serve, serve_export_cache="auto"), block=False)
        try:
            assert again.app.registry.predictor.cache_info() \
                ["compiles"] == 0
        finally:
            _stop_serve(again)
    elif what == "manifest":
        mpath = str(tmp_path / "manifest.json")
        fleet.ManifestPublisher(mpath).seed({"v1": model}, stable="v1")
        m = dict(serve, serve_manifest=mpath)
        del m["input_model"]
        httpd = _serve(m, block=False)
        try:
            assert httpd.app.router.stable == "v1"
            assert httpd.app.registry.versions()[0]["device"] == "cpu"
        finally:
            _stop_serve(httpd)
    elif what == "registry_export_cache":
        reg = tserving.ModelRegistry(
            export_cache=fleet.ExportCache(str(tmp_path / "c")),
            warm_buckets=(1, 8), device="cpu")
        reg.load(model)
        assert reg.export_cache.info()["entries"] == 2
    elif what == "fleet_ExportCache":
        assert fleet.ExportCache(str(tmp_path / "none")).info() \
            ["entries"] == 0
    elif what == "fleet_FleetGateway":
        gw = fleet.FleetGateway(replicas=["http://a", "http://b"])
        # equal weights: ties go to the larger url, as in the JAX package
        assert [gw.pick().url for _ in range(4)] == [
            "http://b", "http://a", "http://b", "http://a"]
    elif what == "fleet_ManifestFollower":
        app = tserving.ServingApp(device="cpu", start=False)
        try:
            assert fleet.ManifestFollower(
                app, str(tmp_path / "no.json")).poll_once() is False
        finally:
            app.close()


@pytest.mark.parametrize("what", [
    "gateway", "continual", "export_cache", "manifest",
    "registry_export_cache", "fleet_ExportCache", "fleet_FleetGateway",
    "fleet_ManifestFollower"])
def test_lifted_paths_run_on_the_cpu(tmp_path, what):
    _lifted(tmp_path, what)


def test_cli_device_key(monkeypatch):
    from lightgbm_tpu_torch.cli import cli_device
    assert cli_device({}) is None                 # the card
    assert cli_device({"device_type": "cpu"}) == "cpu"
    assert cli_device({"device": "CPU"}) == "cpu"
    assert cli_device({"device_type": "gpu"}) is None
    with pytest.raises(LightGBMError):
        cli_device({"device_type": "tpu"})
    monkeypatch.setenv("LGBM_TPU_REJOIN", "1")
    from lightgbm_tpu_torch.cli import run
    with pytest.raises(LightGBMError, match="multi-GPU"):
        run(["task=train", "data=x.csv", "device_type=cpu"])
    assert os.environ["LGBM_TPU_REJOIN"] == "1"
