"""The port's fleet control plane against the JAX package's: the gateway's
weighted round-robin and ejection, manifests written by either package,
a gateway over two in-process port replicas (on the CPU, ephemeral ports)
serving a JAX-made model file named in the manifest, and the persistent
entry cache.

Predictions are held within 1e-6 of the JAX `Booster.predict` of the same
model text; the gateway's JSON bodies to the JAX gateway's key sets;
`decide`-like pure functions (the WRR pick) to equal sequences. Threads
are ordered by events and joins; no test asserts a latency.
"""
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import fleet as jfleet
from lightgbm_tpu.serving.transforms import capture_transform, \
    save_transform
from lightgbm_tpu_torch import fleet as tfleet
from lightgbm_tpu_torch import serving as tserving
from lightgbm_tpu_torch.fleet import export_cache as texport
from lightgbm_tpu_torch.telemetry import counters as tcounters

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 8


def _data(n=400, seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(n, F)
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    return x, (m + 0.5 * r.randn(n) > 0).astype(np.float64)


_MODELS = {}


def _jax_model(path, seed=5):
    """A JAX-trained model file with its edge-transform sidecar (trained
    once per seed); its JAX Booster (the reference predictions) and
    rows."""
    if seed not in _MODELS:
        x, y = _data(seed=seed)
        ds = jlgb.Dataset(x, y, free_raw_data=False)
        bst = jlgb.train({"objective": "binary", "num_leaves": 7,
                          "max_bin": 31, "verbosity": -1}, ds,
                         num_boost_round=3, verbose_eval=False)
        _MODELS[seed] = (bst, x, capture_transform(ds.construct()._inner))
    bst, x, spec = _MODELS[seed]
    bst.save_model(path)
    save_transform(spec, path + ".transform.json")
    return bst, x


def _post(url, payload, content_type="application/json", timeout=30):
    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _serve_http(app):
    httpd = tserving.make_http_server(app, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_address[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shape(obj):
    """The JSON keys of an answer, nested (list items by their union)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        shapes = [_shape(v) for v in obj if isinstance(v, (dict, list))]
        return ["list", json.dumps(shapes, sort_keys=True)
                if shapes else "scalars"]
    return "value"


# ---------------------------------------------------------------------------
# selection: the same smooth-WRR sequence as the JAX gateway

@pytest.mark.parametrize("ejected", [None, "http://b"])
def test_wrr_pick_sequence_equals_jax(ejected):
    reps = [{"url": "http://a", "weight": 1.0},
            {"url": "http://b", "weight": 2.0},
            {"url": "http://c", "weight": 3.0}]
    seqs = []
    for pkg in (jfleet, tfleet):
        gw = pkg.FleetGateway(replicas=reps, eject_s=600.0)
        if ejected:
            gw._eject(gw._replicas[ejected], "test")
        seqs.append([gw.pick().url for _ in range(60)])
    assert seqs[1] == seqs[0]
    counts = {u: seqs[1].count(u) for u in set(seqs[1])}
    if ejected:
        assert counts == {"http://a": 15, "http://c": 45}
    else:
        assert counts == {"http://a": 10, "http://b": 20, "http://c": 30}


# ---------------------------------------------------------------------------
# manifests: either package reads the other's, torn reads, once per rev

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_manifest_written_by_one_package_loads_in_the_other(tmp_path,
                                                            writer):
    w, r = (jfleet, tfleet) if writer == "jax" else (tfleet, jfleet)
    path = str(tmp_path / "manifest.json")
    pub = w.ManifestPublisher(path)
    pub.seed({"v1": "/m/v1.txt"}, stable="v1",
             replicas=[{"url": "http://a", "weight": 1.0}])
    pub.add_model("v2", "/m/v2.txt")
    pub.on_transition("deploy", "v2", weight=0.25)
    assert pub.update(lambda m: None) is None      # unchanged: no rev
    got = r.load_manifest(path)
    assert got == w.load_manifest(path)
    assert got["format"] == "lgbm_tpu_fleet_manifest" and got["rev"] == 3
    assert got["canary"] == {"version": "v2", "weight": 0.25,
                             "shadow": False}
    # the reader's publisher continues the writer's revisions
    r.ManifestPublisher(path).on_transition("promote", "v2")
    back = w.load_manifest(path)
    assert back["rev"] == 4 and back["stable"] == "v2" \
        and back["canary"] is None


def test_manifest_follower_applies_a_rev_once_and_survives_a_torn_read(
        tmp_path):
    path = str(tmp_path / "jax_model.txt")
    _jax_model(path)
    mpath = str(tmp_path / "manifest.json")
    app = tserving.ServingApp(device="cpu", max_batch=16, start=False)
    follower = tfleet.ManifestFollower(app, mpath, poll_s=0.1)
    try:
        assert follower.poll_once() is False        # no manifest yet
        jfleet.ManifestPublisher(mpath).seed({"v1": path}, stable="v1")
        applies = tcounters.get("manifest_applies")
        assert follower.poll_once() is True
        assert follower.poll_once() is False        # same rev
        assert tcounters.get("manifest_applies") == applies + 1
        assert tcounters.get("manifest_rev") == 1
        assert app.registry.latest == "v1" and app.router.stable == "v1"
        with open(mpath, "rb") as fh:
            full = fh.read()
        with open(mpath, "wb") as fh:
            fh.write(full[:len(full) // 2])         # torn: half a doc
        torn = tcounters.get("manifest_torn")
        assert follower.poll_once() is False
        assert app.router.stable == "v1"            # previous rev kept
        assert tcounters.get("manifest_torn") == torn + 1
        gw = tfleet.FleetGateway(manifest_path=mpath)
        assert gw.refresh_manifest() is False
        with open(mpath, "wb") as fh:
            fh.write(full)
        assert follower.poll_once() is False        # converged
        assert gw.refresh_manifest() is True
    finally:
        app.close()


@pytest.mark.parametrize("fault", ["missing_file", "device"])
def test_manifest_follower_logs_file_faults_and_raises_device_faults(
        tmp_path, fault, monkeypatch):
    path = str(tmp_path / "m.txt")
    _jax_model(path)
    mpath = str(tmp_path / "manifest.json")
    app = tserving.ServingApp(device="cpu", max_batch=16, start=False)
    follower = tfleet.ManifestFollower(app, mpath)
    try:
        if fault == "missing_file":
            tfleet.ManifestPublisher(mpath).seed(
                {"v1": path, "v2": str(tmp_path / "gone.txt")},
                stable="v1")
            assert follower.poll_once() is True     # the rest converges
            assert [v["version"] for v in app.registry.versions()] \
                == ["v1"]
            return

        def cuda_fault(*_, **__):
            raise RuntimeError("CUDA error: an illegal memory access "
                               "was encountered")
        monkeypatch.setattr(app.registry, "load", cuda_fault)
        tfleet.ManifestPublisher(mpath).seed({"v1": path}, stable="v1")
        with pytest.raises(RuntimeError, match="CUDA error"):
            follower.poll_once()
        assert follower._applied_rev == -1          # rev stays unapplied
    finally:
        app.close()


def test_manifest_rollout_spans_two_port_replicas(tmp_path):
    v1, v2 = str(tmp_path / "v1.txt"), str(tmp_path / "v2.txt")
    _jax_model(v1)
    _jax_model(v2, seed=11)
    mpath = str(tmp_path / "manifest.json")
    apps = [tserving.ServingApp(device="cpu", max_batch=16, start=False)
            for _ in range(2)]
    followers = [tfleet.ManifestFollower(a, mpath) for a in apps]
    try:
        pub = tfleet.ManifestPublisher(mpath)
        pub.seed({"v1": v1}, stable="v1")
        for f in followers:
            f.poll_once()
        pub.bind_router(apps[0].router, apps[0].registry)
        pub.add_model("v2", v2)
        apps[0].registry.load(v2, version="v2")
        apps[0].router.deploy("v2", weight=0.25)
        assert jfleet.load_manifest(mpath)["canary"]["version"] == "v2"
        assert followers[1].poll_once() is True
        assert apps[1].router.canary == "v2"
        apps[0].router.promote()
        assert followers[1].poll_once() is True
        snap = apps[1].router.snapshot()
        assert snap["stable"] == "v2" and snap["canary"] is None
        actions = [d["action"] for d in
                   apps[1].router.audit_snapshot()["decisions"]]
        assert actions == ["stable", "deploy", "promote"]
    finally:
        for a in apps:
            a.close()


# ---------------------------------------------------------------------------
# a gateway over two in-process port replicas

@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    path = str(tmp / "jax_model.txt")
    jbst, x = _jax_model(path)
    apps, servers = [], []
    for _ in range(2):
        app = tserving.ServingApp(device="cpu", max_batch=64,
                                  max_delay_ms=1.0)
        apps.append(app)
        servers.append(_serve_http(app))
    mpath = str(tmp / "manifest.json")
    tfleet.ManifestPublisher(mpath).seed(
        {"v1": path}, stable="v1",
        replicas=[{"url": servers[0][1], "weight": 1.0},
                  {"url": servers[1][1], "weight": 3.0}])
    for app in apps:
        tfleet.ManifestFollower(app, mpath).poll_once()
    yield {"path": path, "jbst": jbst, "x": x, "manifest": mpath,
           "urls": [u for _, u in servers], "apps": apps}
    for (httpd, _), app in zip(servers, apps):
        httpd.shutdown()
        httpd.server_close()
        app.close()


def _gateway_http(gw):
    httpd = tfleet.make_gateway_server(gw, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_address[1]


def test_gateway_answers_like_the_jax_booster_and_splits_by_weight(fleet):
    gw = tfleet.FleetGateway(manifest_path=fleet["manifest"])
    httpd, url = _gateway_http(gw)
    try:
        x = fleet["x"]
        ref = fleet["jbst"].predict(x)
        code, body = _post(url + "/predict", {"rows": x.tolist()})
        assert code == 200 and body["version"] == "v1"
        np.testing.assert_allclose(body["predictions"], ref, rtol=0,
                                   atol=1e-6)
        for i in range(7):
            code, body = _post(url + "/predict", {"rows": x[i:i + 1]
                                                  .tolist()})
            assert code == 200
            assert abs(body["predictions"][0] - ref[i]) <= 1e-6
        # 8 picks at weights 1 and 3: exactly 2 and 6
        picks = {r["url"]: r["picks"] for r in gw.stats()["replicas"]}
        assert picks == {fleet["urls"][0]: 2, fleet["urls"][1]: 6}
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_gateway_csv_body_is_bit_identical_to_json(fleet):
    gw = tfleet.FleetGateway(manifest_path=fleet["manifest"])
    assert gw.transform is not None              # the manifest's sidecar
    httpd, url = _gateway_http(gw)
    try:
        rows = fleet["x"][:16]
        csv = "\n".join(",".join("%.9g" % v for v in row) for row in rows)
        code, via_csv = _post(url + "/predict", csv.encode(),
                              content_type="text/csv")
        assert code == 200
        _, via_json = _post(url + "/predict", {"rows": rows.tolist()})
        _, direct = _post(fleet["urls"][0] + "/predict",
                          {"rows": rows.tolist()})
        assert via_csv["predictions"] == via_json["predictions"] \
            == direct["predictions"]
        holey = [[None if j == 2 else float(v) for j, v in enumerate(r)]
                 for r in rows[:4]]
        code, via_null = _post(url + "/predict", {"rows": holey})
        assert code == 200 and len(via_null["predictions"]) == 4
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_gateway_retries_past_a_dead_replica(fleet):
    dead = "http://127.0.0.1:%d" % _free_port()
    gw = tfleet.FleetGateway(replicas=[{"url": dead, "weight": 9.0},
                                       {"url": fleet["urls"][0]}],
                             retries=1, backoff_s=0.0)
    retries = tcounters.get("gateway_retries")
    code, body = gw.predict({"rows": fleet["x"][:2].tolist()})
    assert code == 200 and len(body["predictions"]) == 2
    assert tcounters.get("gateway_retries") == retries + 1
    rep = gw._replicas[dead]
    assert not rep.healthy and "connect_error" in rep.last_reason
    gw.check_health()
    assert gw._replicas[fleet["urls"][0]].last_status == "ok"
    assert gw.health()["healthy_replicas"] == 1


def test_gateway_hedges_past_a_stalled_replica(fleet):
    release = threading.Event()

    class Stalled(BaseHTTPRequestHandler):
        def log_message(self, *_):
            pass

        def do_POST(self):
            release.wait(60)
            self.send_response(500)
            self.end_headers()

    stalled = ThreadingHTTPServer(("127.0.0.1", 0), Stalled)
    stalled.daemon_threads = True
    threading.Thread(target=stalled.serve_forever, daemon=True).start()
    try:
        # weight 9 against 1: the first pick is the stalled replica; it
        # answers only once `release` is set, after the hedge has won
        gw = tfleet.FleetGateway(
            replicas=[{"url": "http://127.0.0.1:%d"
                       % stalled.server_address[1], "weight": 9.0},
                      {"url": fleet["urls"][1], "weight": 1.0}],
            hedge_s=0.05, timeout_s=60.0)
        hedged = tcounters.get("gateway_hedged_requests")
        wins = tcounters.get("gateway_hedge_wins")
        code, body = gw.predict({"rows": fleet["x"][:3].tolist()})
        assert code == 200 and len(body["predictions"]) == 3
        assert tcounters.get("gateway_hedged_requests") == hedged + 1
        assert tcounters.get("gateway_hedge_wins") == wins + 1
        assert gw.config()["hedge_s"] == 0.05
    finally:
        release.set()
        stalled.shutdown()
        stalled.server_close()


@pytest.mark.parametrize("path", ["/healthz", "/stats", "/gateway",
                                  "/nope"])
def test_gateway_bodies_have_the_jax_key_sets(fleet, path):
    answers = []
    for pkg in (jfleet, tfleet):
        gw = pkg.FleetGateway(manifest_path=fleet["manifest"])
        gw.predict({"rows": fleet["x"][:1].tolist()})
        httpd = pkg.make_gateway_server(gw, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            answers.append(_get("http://127.0.0.1:%d%s"
                                % (httpd.server_address[1], path)))
        finally:
            httpd.shutdown()
            httpd.server_close()
    (jc, jb), (tc, tb) = answers
    assert tc == jc and _shape(tb) == _shape(jb)


def test_cli_gateway_subprocess_forwards_and_exits_on_sigint(fleet):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=gateway",
         "gateway_manifest=" + fleet["manifest"],
         "gateway_port=%d" % port],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        base = "http://127.0.0.1:%d" % port
        for _ in range(600):
            try:
                code, cfg = _get(base + "/gateway", timeout=2)
                break
            except OSError:
                if proc.poll() is not None:
                    break
                threading.Event().wait(0.1)
        assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
        assert code == 200 and cfg["manifest_path"] == fleet["manifest"]
        x = fleet["x"][:5]
        code, body = _post(base + "/predict", {"rows": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(body["predictions"],
                                   fleet["jbst"].predict(x), atol=1e-6)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# the persistent entry cache

def _cached_registry(cache_dir, buckets=(1, 16, 256)):
    return tserving.ModelRegistry(warm_buckets=buckets, device="cpu",
                                  export_cache=tfleet.ExportCache(cache_dir))


def test_export_cache_restart_installs_every_warm_entry(tmp_path):
    path = str(tmp_path / "m.txt")
    jbst, x = _jax_model(path)
    cache = tfleet.cache_dir_for_model(path)
    first = _cached_registry(cache)
    first.load(path, version="v1")
    assert first.predictor.compile_count == 3
    assert first.export_cache.info()["entries"] == 3
    hits = tcounters.get("export_cache_hits")
    again = _cached_registry(cache)                # the restarted process
    again.load(path, version="v1")
    info = again.predictor.cache_info()
    assert again.export_cache.last_restore == {"restored": 3, "rebuilt": 0,
                                               "missed": 0}
    assert tcounters.get("export_cache_hits") == hits + 3
    assert tcounters.get("export_cache_last_restored") == 3
    assert info["compiles"] == 0 and info["installs"] == 3
    m = again.get("v1")
    for n in (1, 9, 16, 200, 256):
        out = again.predictor.predict(m, x[:n])
        np.testing.assert_allclose(out[:, 0], jbst.predict(x[:n]),
                                   atol=1e-6)
    assert again.predictor.compile_count == 0       # 0 built at buckets


def test_export_cache_env_mismatch_rebuilds_and_rewrites(tmp_path):
    path = str(tmp_path / "m.txt")
    _jax_model(path)
    cache = str(tmp_path / "cache")
    _cached_registry(cache, buckets=(4,)).load(path, version="v1")
    (entry,) = [os.path.join(cache, f) for f in os.listdir(cache)]
    with open(entry, "rb") as fh:
        raw = fh.read()
    magic = raw[:raw.index(b"\n") + 1]
    (hlen,) = struct.unpack(">I", raw[len(magic):len(magic) + 4])
    header = json.loads(raw[len(magic) + 4:len(magic) + 4 + hlen])
    header["env"]["torch"] = "0.0.0"                # another torch wrote it
    new = json.dumps(header).encode()
    with open(entry, "wb") as fh:
        fh.write(magic + struct.pack(">I", len(new)) + new
                 + raw[len(magic) + 4 + hlen:])
    rebuilds = tcounters.get("export_cache_rebuilds")
    reg = _cached_registry(cache, buckets=(4,))
    reg.load(path, version="v1")
    assert reg.export_cache.last_restore == {"restored": 0, "rebuilt": 1,
                                             "missed": 0}
    assert tcounters.get("export_cache_rebuilds") == rebuilds + 1
    assert reg.predictor.compile_count == 1         # built the usual way
    third = _cached_registry(cache, buckets=(4,))   # rewritten in place
    third.load(path, version="v1")
    assert third.export_cache.last_restore["restored"] == 1
    assert third.predictor.compile_count == 0


def test_export_cache_corrupt_and_jax_entries_are_misses(tmp_path):
    path = str(tmp_path / "m.txt")
    _jax_model(path)
    cache = str(tmp_path / "cache")
    first = _cached_registry(cache)
    first.load(path, version="v1")
    m = first.get("v1")
    fam = first.predictor.family(m, m.num_features, False)
    ec = first.export_cache
    with open(ec._path(fam, 16), "r+b") as fh:      # torn: cut short
        fh.truncate(20)
    header = json.dumps({"env": {}, "native_len": 0, "trees_len": 0,
                         "hlo_len": 0}).encode()
    with open(ec._path(fam, 256), "wb") as fh:      # a JAX-format entry
        fh.write(b"LGBMTPUXC1\n" + struct.pack(">I", len(header)) + header)
    assert jfleet.ExportCache(cache)._read_entry(ec._path(fam, 256)) \
        is not None
    misses = tcounters.get("export_cache_misses")
    again = _cached_registry(cache)
    again.load(path, version="v1")
    assert again.export_cache.last_restore == {"restored": 1, "rebuilt": 0,
                                               "missed": 2}
    assert tcounters.get("export_cache_misses") == misses + 2
    # bucket 1 installed; 16 and 256 built by the warm-up
    assert again.predictor.compile_count == 2
    # the JAX package reads no port entry either
    jcache = jfleet.ExportCache(cache)
    assert jcache._read_entry(ec._path(fam, 1)) is None


def test_export_cache_file_conventions_are_the_jax_ones(tmp_path):
    assert tfleet.cache_dir_for_model("/m/model.txt") \
        == jfleet.cache_dir_for_model("/m/model.txt") == "/m/model.txt.xcache"
    fam = ((((4, 15), "torch.int32"),), 8, 4, 1, False, "sigmoid:1",
           "cpu")
    for bucket in (1, 16, 4096):
        assert tfleet.ExportCache.entry_name(fam, bucket) \
            == jfleet.ExportCache.entry_name(fam, bucket)
    path = str(tmp_path / "m.txt")
    _jax_model(path)
    cache = str(tmp_path / "cache")
    _cached_registry(cache, buckets=(8,)).load(path, version="v1")
    names = os.listdir(cache)
    assert len(names) == 1 and names[0].endswith(".xc") \
        and len(names[0]) == 35                     # no .tmp left behind
    with open(os.path.join(cache, names[0]), "rb") as fh:
        raw = fh.read()
    assert raw.startswith(texport._MAGIC) and raw[len(texport._MAGIC) - 1:
                                                  len(texport._MAGIC)] \
        == b"\n"
    (hlen,) = struct.unpack(">I", raw[len(texport._MAGIC):
                                      len(texport._MAGIC) + 4])
    header = json.loads(raw[len(texport._MAGIC) + 4:
                            len(texport._MAGIC) + 4 + hlen])
    assert header["env"] == texport.env_fingerprint("cpu")
    assert header["env"]["donate"] == "0" and header["bucket"] == 8
    assert header["payload_len"] == len(raw) - len(texport._MAGIC) - 4 \
        - hlen


def test_export_cache_writers_sharing_a_directory_never_collide(tmp_path):
    # two replicas on one `<manifest>.xcache/` write the same entries at
    # start-up: each write goes through a temp file of its own
    ec = tfleet.ExportCache(str(tmp_path / "shared.xcache"))
    os.makedirs(ec.cache_dir)
    model = type("M", (), {"device": torch.device("cpu"),
                           "version": "v1"})()
    fam = ((((4, 15), "torch.int32"),), 8, 4, 1, False, "sigmoid:1",
           "cpu")
    errors, start = [], threading.Barrier(4)

    def writer():
        start.wait()
        for _ in range(100):
            try:
                ec._write_entry(ec._path(fam, 16), fam, 16, model)
            except OSError as exc:
                errors.append(exc)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert os.listdir(ec.cache_dir) == [ec.entry_name(fam, 16)]
    assert ec._read_entry(ec._path(fam, 16))[1] == texport._spec(fam, 16)
