"""The port's telemetry (lightgbm_tpu_torch/telemetry, utils/timer.py)
and its hooks in training.

Off costs nothing by structure: every hook returns the shared null span,
no iteration is recorded, no counter moves, and the model text is byte
for byte the same in every mode. No test here times the overhead (that
is measured on the card, by chip_smoke's resilience phase). The modes,
spans, counters, recorder, flight recorder, watchdogs, Prometheus text
and postmortem bundles are held to the JAX package's behaviour
(tests/test_telemetry.py, tests/test_observability.py) on the JAX tests'
sizes (600 x 10 rows).
"""
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch import telemetry
from lightgbm_tpu_torch.callback import record_telemetry
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.resilience import faults
from lightgbm_tpu_torch.telemetry import (bundle, counters, events,
                                          recorder, spans, watchdogs)
from lightgbm_tpu_torch.utils import timer
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
        "verbosity": -1}


@pytest.fixture(autouse=True)
def _telemetry_off_after(monkeypatch):
    """Telemetry is process-wide: every test starts and ends off, with
    its state cleared."""
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    for var in ("LGBM_TPU_TELEMETRY", "LGBM_TPU_EVENTS",
                "LGBM_TPU_XLA_TRACE", "LGBM_TPU_BUNDLE_DIR",
                "LGBM_TPU_WATCHDOGS"):
        monkeypatch.delenv(var, raising=False)
    telemetry.set_mode("off")
    telemetry.reset()
    faults.clear()
    yield
    telemetry.set_mode("off")
    telemetry.reset()
    faults.clear()


def make_binary(n=600, f=10, seed=7):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + r.randn(n) * 0.5 > 0).astype(np.float64)
    return x, y


def _train(params=None, rounds=6, **kw):
    x, y = make_binary()
    return tengine.train(dict(BASE, **(params or {})), tbasic.Dataset(x, y),
                         num_boost_round=rounds, verbose_eval=False,
                         device="cpu", **kw)


def _text(bst):
    return bst._gbdt.save_model_to_string(0, -1)


# ---------------------------------------------------------------------------
# modes and null hooks

def test_mode_gating_and_null_hooks():
    assert telemetry.mode() == "off"
    assert recorder.phase("x") is spans.NULL_SPAN
    assert recorder.iteration(0) is spans.NULL_SPAN
    assert spans.span("x") is spans.NULL_SPAN
    telemetry.set_mode("summary")
    assert recorder.phase("x") is not spans.NULL_SPAN
    assert spans.span("x") is spans.NULL_SPAN      # spans need trace
    telemetry.set_mode("trace")
    assert spans.span("x") is not spans.NULL_SPAN
    with pytest.raises(ValueError):
        telemetry.set_mode("verbose")


def test_off_records_nothing_and_moves_no_counter():
    _train({"metric": "auc"}, rounds=4)
    assert recorder.phase_breakdown()["iterations"] == 0
    assert recorder.last_iteration() is None
    assert spans.events() == [] and events.events() == []
    assert counters.snapshot()["counters"] == {}


def test_param_against_env(monkeypatch):
    assert telemetry.resolve_mode("summary") == "summary"
    monkeypatch.setenv("LGBM_TPU_TELEMETRY", "trace")
    assert telemetry.resolve_mode("summary") == "trace"   # env wins
    _train({"telemetry": "summary"}, rounds=1)
    assert telemetry.mode() == "trace"
    monkeypatch.delenv("LGBM_TPU_TELEMETRY")
    _train({"telemetry": "summary"}, rounds=1)
    assert telemetry.mode() == "summary"
    # a default-off param does not stomp a mode set programmatically
    _train(rounds=1)
    assert telemetry.mode() == "summary"
    _train({"telemetry": "off"}, rounds=1)
    assert telemetry.mode() == "off"
    with pytest.raises(LightGBMError):
        Config({"telemetry": "everything"})


# ---------------------------------------------------------------------------
# spans

def test_span_nesting_and_chrome_trace_roundtrip(tmp_path):
    telemetry.set_mode("trace")
    with spans.span("outer", kind="test"):
        with spans.span("inner_a"):
            time.sleep(0.002)
        with spans.span("inner_b"):
            time.sleep(0.002)
    path = telemetry.dump_trace(str(tmp_path / "trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    evs = {e["name"]: e for e in doc["traceEvents"]}
    assert {"outer", "inner_a", "inner_b"} <= set(evs)
    assert evs["process_name"]["ph"] == "M"
    for ev in evs.values():
        if ev["ph"] == "M":
            continue
        assert ev["ph"] == "X" and ev["dur"] >= 0 and "ts" in ev
        assert ev["pid"] == os.getpid()
    outer = evs["outer"]
    for inner in (evs["inner_a"], evs["inner_b"]):
        assert inner["ts"] >= outer["ts"] - 1
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["args"] == {"kind": "test"}
    spans.clear()
    assert spans.events() == []


def test_span_ring_is_bounded():
    telemetry.set_mode("trace")
    cap = spans._events.maxlen
    for i in range(cap + 50):
        spans.add_event("e%d" % i, 0.0)
    assert len(spans.events()) == cap


def test_trace_mode_traces_training_and_the_device_profile(tmp_path,
                                                           monkeypatch):
    """Under trace mode the iteration and its phases land in the span
    ring; with LGBM_TPU_XLA_TRACE a torch.profiler session runs beside it
    and dump_trace writes its Chrome trace into that directory."""
    monkeypatch.setenv("LGBM_TPU_XLA_TRACE", str(tmp_path / "prof"))
    _train({"telemetry": "trace"}, rounds=2)
    assert telemetry.device_trace_active()
    path = telemetry.dump_trace(str(tmp_path / "trace.json"))
    assert not telemetry.device_trace_active()
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"iteration", "grow_dispatch", "host_sync"} <= names
    prof = telemetry.device_trace_path()
    assert os.path.dirname(prof) == str(tmp_path / "prof")
    assert json.load(open(prof))["traceEvents"]


# ---------------------------------------------------------------------------
# counters

def test_counters_stay_exact_under_threads():
    threads = [threading.Thread(
        target=lambda: [counters.incr("hammer") for _ in range(5000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counters.get("hammer") == 8 * 5000


def test_summary_counts_transfers_and_trees():
    telemetry.set_mode("summary")
    bst = _train({"metric": "auc"}, rounds=4)
    snap = telemetry.telemetry_summary()
    c = snap["counters"]
    assert c["grow_trees"] == bst.num_trees() == 4
    assert c["grow_dispatches"] == 4
    assert snap["gauges"]["grow_dispatches_per_tree"] == 1.0
    # each tree's one fetch and the training scores fetched for the metric
    assert c["transfer_d2h_bytes"] > 4 * 600 * 4
    assert snap["gauges"]["peak_rss_bytes"] > 0
    assert snap["phase_breakdown"]["iterations"] == 4


def test_one_off_counters_count_with_telemetry_off():
    counters.note_capture(0.25)
    counters.note_kernel_build(3, 12.0)
    c = counters.snapshot()["counters"]
    assert c == {"graph_captures": 1, "graph_capture_seconds": 0.25,
                 "kernel_builds": 3, "kernel_build_seconds": 12.0}


def test_prometheus_text_parses():
    telemetry.set_mode("summary")
    _train(rounds=2)
    counters.set_gauge('odd{label="v"}', 2.5)
    text = telemetry.prometheus_text()
    line_re = re.compile(
        r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+="[^"]*"\})? '
        r'-?[0-9.eE+-]+$')
    typed = set()
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            assert kind in ("counter", "gauge") and name not in typed
            typed.add(name)
            continue
        assert line_re.match(line), line
    assert "lgbm_tpu_grow_trees_total 2" in text
    assert 'lgbm_tpu_odd{label="v"} 2.5' in text


# ---------------------------------------------------------------------------
# the recorder

def test_recorder_phases_appear_and_sum_within_the_wall(monkeypatch):
    x, y = make_binary()
    xv, yv = make_binary(n=200, seed=99)
    telemetry.set_mode("summary")
    # the fused iteration with a guard and a validation set
    tengine.train(dict(BASE, on_nonfinite="raise", metric="auc"),
                  tbasic.Dataset(x, y), num_boost_round=3,
                  valid_sets=[tbasic.Dataset(xv, yv)], verbose_eval=False,
                  device="cpu")
    fused = recorder.phase_breakdown()
    # the generic iteration, with a bag
    telemetry.reset()
    monkeypatch.setattr(GBDT, "_fused_eligible", lambda self: False)
    _train({"bagging_fraction": 0.8, "bagging_freq": 1}, rounds=3)
    generic = recorder.phase_breakdown()
    seen = set(fused["phases"]) | set(generic["phases"])
    assert {"gradient", "bagging", "boost_avg", "grow_dispatch", "sentry",
            "host_sync", "tree_replay", "score_update", "eval"} <= seen
    for bd in (fused, generic):
        assert bd["iterations"] == 3
        assert 0 < bd["phase_sum_s"] <= bd["wall_s"]
    assert "eval" in fused["phases"]        # outside the iteration bracket
    last = recorder.last_iteration()
    assert last["iteration"] == 2
    assert sum(last["phases"].values()) <= last["wall_s"]


def test_record_telemetry_logs_a_line_per_period(capsys):
    from lightgbm_tpu_torch.utils import log
    level = log.get_verbosity()
    log.set_verbosity(1)
    try:
        _train({"telemetry": "summary", "verbosity": 1}, rounds=4,
               callbacks=[record_telemetry(period=2)])
    finally:
        log.set_verbosity(level)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if "telemetry wall=" in ln]
    assert len(lines) == 2
    assert lines[0].split("]")[2].strip().startswith("[2")
    assert "grow_dispatch=" in lines[0] and "host_sync=" in lines[0]


# ---------------------------------------------------------------------------
# the model is the same in every mode

@pytest.mark.parametrize("mode", ["summary", "trace", "events"])
def test_model_text_is_the_same_in_every_mode(mode, tmp_path, monkeypatch):
    """Byte for byte, parameters block included: the mode comes from the
    env var, which wins over the (unchanged) param."""
    params = {"metric": "auc", "bagging_fraction": 0.8, "bagging_freq": 1}
    base = _text(_train(params, rounds=5))
    assert telemetry.mode() == "off"
    monkeypatch.setenv("LGBM_TPU_TELEMETRY",
                       "summary" if mode == "events" else mode)
    if mode == "events":
        monkeypatch.setenv("LGBM_TPU_EVENTS", str(tmp_path / "ev.jsonl"))
    got = _text(_train(params, rounds=5))
    assert telemetry.mode() == ("summary" if mode == "events" else mode)
    assert got == base
    assert recorder.phase_breakdown()["iterations"] == 5
    if mode == "events":
        assert (tmp_path / "ev.jsonl").stat().st_size > 0


# ---------------------------------------------------------------------------
# the flight recorder, watchdogs, bundles

def test_events_jsonl_one_record_per_iteration(tmp_path, monkeypatch):
    sink = tmp_path / "events.jsonl"
    monkeypatch.setenv("LGBM_TPU_EVENTS", str(sink))
    monkeypatch.setattr(GBDT, "_fused_eligible", lambda self: False)
    _train({"telemetry": "summary", "metric": "auc"}, rounds=4)
    telemetry.set_mode("off")               # closes the sink
    recs = [json.loads(ln) for ln in sink.read_text().splitlines()]
    its = [r for r in recs if r["kind"] == "iteration"]
    assert [r["iteration"] for r in its] == [0, 1, 2, 3]
    for r in its:
        assert r["grad_norms"]["grad_l2"] > 0      # the generic iteration
        assert "training:auc" in r["metrics"]
        assert r["wall_s"] > 0 and "grow_dispatch" in r["phases"]


@pytest.mark.parametrize("shape", [(1, 500), (3, 64), (1, 0)])
def test_grad_norms_equal_the_jax_summary(shape):
    """The generic iteration's record: reduced on the pair's device, read
    after the tree's fetch, equal to the JAX package's host summary."""
    from lightgbm_tpu.models.gbdt import _grad_norm_summary
    from lightgbm_tpu_torch.models import gbdt as tgbdt
    r = np.random.RandomState(3)
    g = (r.randn(*shape) * 10).astype(np.float32)
    h = r.rand(*shape).astype(np.float32)
    got = tgbdt._grad_norm_read(tgbdt._grad_norm_start(
        torch.from_numpy(g), torch.from_numpy(h)))
    want = _grad_norm_summary(g, h)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_events_record_the_stream_and_the_quantization(monkeypatch):
    telemetry.set_mode("summary")
    _train({"quantized_grad": True, "grad_bits": 4}, rounds=2)
    its = events.events("iteration")
    assert its[-1]["quant"]["grad_bits"] == 4
    assert "grad_norms" not in its[-1]          # the fused iteration
    telemetry.reset()
    monkeypatch.delenv("LGBM_TPU_STRATEGY")
    _train({"stream_mode": "chunked"}, rounds=2)
    st = events.events("iteration")[-1]["stream"]
    assert st["h2d_bytes"] > 0 and st["peak_bytes"] > 0
    assert counters.get("transfer_h2d_bytes") > 0


def test_watchdogs_fire_on_synthetic_anomalies():
    telemetry.set_mode("summary")
    watchdogs.configure("slow_iter=3,grad_spike=10,overlap=0.5")
    for i in range(6):
        telemetry.record_iteration({
            "iteration": i, "wall_s": 0.01,
            "grad_norms": {"grad_l2": 1.0},
            "stream": {"overlap_fraction": 0.9}})
    assert watchdogs.fired() == {}
    telemetry.record_iteration({
        "iteration": 6, "wall_s": 0.5, "grad_norms": {"grad_l2": 50.0},
        "stream": {"overlap_fraction": 0.1}})
    assert watchdogs.fired() == {"slow_iter": 1, "grad_spike": 1,
                                 "overlap": 1}
    assert counters.get("watchdog_fires") == 3
    assert len(events.events("watchdog")) == 3
    assert not watchdogs.loss_guard_requested()
    watchdogs.configure("arm_loss_guard=1")
    assert watchdogs.loss_guard_requested()
    watchdogs.configure("off")
    assert not watchdogs.loss_guard_requested()


def test_bundle_has_its_manifest_and_a_torn_one_is_skipped(tmp_path,
                                                          monkeypatch):
    root = tmp_path / "bundles"
    monkeypatch.setenv("LGBM_TPU_BUNDLE_DIR", str(root))
    monkeypatch.setenv("LGBM_TPU_BUNDLE_KEEP", "2")
    telemetry.set_mode("trace")
    _train(rounds=2)
    torn = root / "bundle-00000000-000000-torn-r0-p1"
    os.makedirs(torn)
    (torn / "events.jsonl").write_text("{")
    paths = [bundle.capture("test%d" % i) for i in range(3)]
    done = bundle.complete_bundles(str(root))
    assert done == sorted(os.path.basename(p) for p in paths[1:])
    assert torn.exists()                      # rotation leaves it alone
    man = json.load(open(os.path.join(paths[-1], "MANIFEST.json")))
    assert man["reason"] == "test2"
    assert {"events.jsonl", "trace.json", "counters.json", "env.json",
            "config.json"} <= set(man["files"])
    env = json.load(open(os.path.join(paths[-1], "env.json")))
    assert env["torch"] == torch.__version__ and "jax" not in env
    assert bundle.maybe_capture("test2") is not None     # a new reason
    assert bundle.maybe_capture("test2") is None          # cooldown


def test_fault_and_skip_iter_events_appear():
    telemetry.set_mode("summary")
    faults.install("nan_grad@iter=2")
    bst = _train({"on_nonfinite": "skip_iter"}, rounds=4)
    assert bst.num_trees() == 3
    kinds = [e["kind"] for e in events.events()]
    assert "fault" in kinds and "skip_iter" in kinds
    fault = events.events("fault")[0]
    assert fault["fault"] == "nan_grad" and fault["iteration"] == 2
    assert events.events("skip_iter")[0]["iteration"] == 2


# ---------------------------------------------------------------------------
# utils/timer.py

def test_timer_accumulates_and_device_trace_writes(tmp_path):
    timer.reset()
    timer.enable(True)
    try:
        with timer.timer("a"):
            time.sleep(0.001)
        timer.add("b", 0.5)
        acc = timer.report()
    finally:
        timer.enable(False)
        timer.reset()
    assert acc["a"] > 0 and acc["b"] == 0.5
    with timer.device_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None
    out = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    assert len(out) == 1
    assert json.load(open(tmp_path / out[0]))["traceEvents"]
