"""The port's serving control plane against the JAX package's: the canary
router, the SLO monitor, the load shedder, the drift monitor, the edge
transforms, trace sampling, the feedback store and the placement plan.

These are host-side modules (numpy and the standard library), so the two
packages must decide alike on the same inputs: route sequences, gate
decisions and audit records (timestamps aside) equal; SLO windows and
brownout levels equal under one injected clock; drift baselines equal and
PSI within 1e-12; transform bins equal; the same requests sampled; AUCs
equal.
"""
import json
import math
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu.fleet import router as jrouter
from lightgbm_tpu.serving import drift as jdrift
from lightgbm_tpu.serving import feedback as jfeedback
from lightgbm_tpu.serving import shed as jshed
from lightgbm_tpu.serving import slo as jslo
from lightgbm_tpu.serving import stats as jstats
from lightgbm_tpu.serving import trace as jtrace
from lightgbm_tpu.serving import transforms as jtransforms
from lightgbm_tpu_torch import telemetry as ttelemetry
from lightgbm_tpu_torch.fleet import PlacementPlan, parse_placement_spec
from lightgbm_tpu_torch.fleet import router as trouter
from lightgbm_tpu_torch.serving import drift as tdrift
from lightgbm_tpu_torch.serving import feedback as tfeedback
from lightgbm_tpu_torch.serving import shed as tshed
from lightgbm_tpu_torch.serving import slo as tslo
from lightgbm_tpu_torch.serving import stats as tstats
from lightgbm_tpu_torch.serving import trace as ttrace
from lightgbm_tpu_torch.serving import transforms as ttransforms
from lightgbm_tpu_torch.utils.log import LightGBMError

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _telemetry_off_after(monkeypatch):
    """Telemetry is process-wide in both packages: every test starts and
    ends off, with its state cleared."""
    for var in ("LGBM_TPU_TELEMETRY", "LGBM_TPU_EVENTS",
                "LGBM_TPU_BUNDLE_DIR", "LGBM_TPU_WATCHDOGS",
                "LGBM_TPU_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    for tel in (jtelemetry, ttelemetry):
        tel.set_mode("off")
        tel.reset()
    yield
    for tel in (jtelemetry, ttelemetry):
        tel.set_mode("off")
        tel.reset()
    jtrace.reset()
    ttrace.reset()


class _Registry:
    """The registry surface the router uses: versions, and pins."""

    def __init__(self, versions):
        self.known = set(versions)
        self.pins = []

    def get(self, version):
        if version not in self.known:
            raise KeyError(version)
        return version

    def pin_version(self, version):
        self.pins.append(("pin", version))

    def unpin_version(self, version):
        self.pins.append(("unpin", version))


def _strip_t(obj):
    if isinstance(obj, dict):
        return {k: _strip_t(v) for k, v in obj.items() if k != "t"}
    if isinstance(obj, list):
        return [_strip_t(v) for v in obj]
    return obj


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# router

@pytest.mark.parametrize("weight", [0.1, 0.25, 1 / 3])
def test_router_route_sequence_equals_jax(weight):
    seqs = []
    for mod, st in ((jrouter, jstats), (trouter, tstats)):
        reg = _Registry({"s", "c"})
        r = mod.CanaryRouter(reg, st.ServingStats())
        r.set_stable("s")
        r.deploy("c", weight=weight)
        seqs.append(([r.route() for _ in range(1000)], r.snapshot(),
                     reg.pins))
    (jseq, jsnap, jpins), (tseq, tsnap, tpins) = seqs
    assert tseq == jseq
    assert tseq.count("c") == math.floor(1000 * weight)
    assert _strip_t(tsnap) == _strip_t(jsnap)
    assert tpins == jpins


SCENARIOS = ("promote", "error_spike", "error_rate", "p99", "watchdog",
             "feedback_hold_then_demote", "slo_burn")


def _drive(mod, st, counters, fb_mod, slo_mod, scenario):
    """One scenario's counter series against one package's router: the
    decision after each step, the audit log and the last evaluation."""
    reg = _Registry({"s", "c"})
    stats = st.ServingStats()
    kw = dict(min_requests=6, max_error_rate=0.2, p99_ratio=3.0,
              demote_errors=3)
    fb = slo = None
    if scenario == "feedback_hold_then_demote":
        fb = fb_mod.FeedbackStore()
        kw.update(feedback=fb, feedback_min_labels=8,
                  feedback_auc_epsilon=0.05)
    if scenario == "slo_burn":
        slo = slo_mod.SloMonitor(p99_ms=5.0, min_requests=3)
        kw["slo"] = slo
    r = mod.CanaryRouter(reg, stats, **kw)
    r.set_stable("s")
    for _ in range(10):
        stats.observe_version("s", 0.002)
    r.deploy("c", weight=0.5)
    out = []
    for i in range(12):
        err = ((scenario == "error_spike" and i >= 2)
               or (scenario == "error_rate" and i in (1, 4)))
        lat = 0.020 if scenario in ("p99", "slo_burn") else 0.002
        stats.observe_version("c", None if err else lat, error=err)
        if slo is not None:
            slo.observe("c", lat)
        if scenario == "watchdog" and i == 4:
            counters.incr("watchdog_fires")
        if fb is not None and i == 3:
            y = np.tile([0.0, 1.0], 8)
            fb.record("s", y, y)                        # stable AUC 1
            fb.record("c", y[:4], np.linspace(0, 1, 4))
        if fb is not None and i == 8:
            y = np.tile([0.0, 1.0], 4)
            fb.record("c", y, y[::-1])                  # canary AUC low
        out.append(r.evaluate())
        if r.canary is None:
            break
    return out, _strip_t(r.audit_snapshot()), _strip_t(r.history)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_gate_decisions_and_audit_equal_jax(scenario, monkeypatch):
    from lightgbm_tpu.telemetry import counters as jcounters
    from lightgbm_tpu_torch.telemetry import counters as tcounters
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    jout = _drive(jrouter, jstats, jcounters, jfeedback, jslo, scenario)
    tout = _drive(trouter, tstats, tcounters, tfeedback, tslo, scenario)
    assert tout == jout
    decisions = tout[0]
    assert decisions[-1] in ("promoted", "demoted")
    want = "promoted" if scenario == "promote" else "demoted"
    assert decisions[-1] == want


def test_router_demotes_on_drift_fire():
    """The drift monitor's fire lands in the watchdog counter the router's
    gate reads: a drifting canary is cut."""
    reg = _Registry({"s", "c"})
    r = trouter.CanaryRouter(reg, tstats.ServingStats(), min_requests=50)
    r.set_stable("s")
    r.deploy("c", weight=0.5)
    assert r.evaluate() == "hold"
    mon = tdrift.DriftMonitor(_synthetic_baseline(), threshold=0.2,
                              window=128, min_rows=64, min_interval_s=0)
    mon.observe(np.full((128, 2), 0.9), version="c")
    assert max(mon.check_now().values()) > 1.0
    assert mon.snapshot()["fires"] == 1
    assert r.evaluate() == "demoted"
    assert r.history[-1]["reason"] == "watchdog_fire"
    mon.close()


# ---------------------------------------------------------------------------
# SLO + shed

def _slo_trace(slo_mod, shed_mod, clock):
    slo = slo_mod.SloMonitor(p99_ms=5.0, error_rate=0.2,
                             fast_window_s=10.0, slow_window_s=60.0,
                             min_requests=4)
    shed = shed_mod.LoadShedder(slo=slo, refresh_s=0.25)
    notes = []
    shed.audit = lambda action, version, **d: notes.append(
        (action, version, d))
    out = []
    steps = ([(0.001, False)] * 6 + [(0.050, False)] * 6
             + [(None, True)] * 3 + [(0.001, False)] * 12)
    for i, (lat, err) in enumerate(steps):
        clock.now += 1.5
        slo.observe("v1" if i % 3 else "v2", lat, error=err)
        snap = slo.snapshot()
        out.append((snap, slo.burning(), slo.version_violation("v1"),
                    shed.level(),
                    [shed.admit(p, q, 1, 10)
                     for p in shed_mod.PRIORITIES for q in (2, 6, 9)]))
    shed.set_level(2, "test")
    out.append((shed.level(), shed.admit("versioned", 0, 1, 10),
                shed.snapshot()))
    shed.set_level(None)
    out.append((shed.level(), shed.snapshot()))
    return out, notes


def test_slo_and_shed_levels_equal_jax(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    jout = _slo_trace(jslo, jshed, clock)
    clock.now = 1000.0
    tout = _slo_trace(tslo, tshed, clock)
    assert tout == jout
    levels = [row[3] for row in tout[0][:-2]]
    assert max(levels) == 2 and levels[-1] < 2   # burns, then clears
    assert tshed.PRIORITIES == jshed.PRIORITIES


# ---------------------------------------------------------------------------
# drift

def _synthetic_baseline():
    return {"format": tdrift.BASELINE_FORMAT, "version": 1,
            "n_rows": 1000, "features": [
                {"index": 0, "edges": [-0.5, 0.0, 0.5], "has_nan": False,
                 "occupancy": [0.25, 0.25, 0.25, 0.25]},
                {"index": 1, "edges": [-0.5, 0.0, 0.5], "has_nan": False,
                 "occupancy": [0.25, 0.25, 0.25, 0.25]}]}


@pytest.fixture(scope="module")
def binned_pair():
    r = np.random.RandomState(5)
    x = r.randn(3000, 6)
    x[r.rand(3000) < 0.05, 2] = np.nan
    x[:, 4] = r.randint(0, 6, size=3000)
    y = (x[:, 0] + 0.3 * r.randn(3000) > 0).astype(float)
    params = {"max_bin": 255, "verbosity": -1}
    jd = jlgb.Dataset(x, y, params=params, categorical_feature=[4])
    td = tlgb.Dataset(x, y, params=params, categorical_feature=[4])
    return jd.construct(), td.construct(), x


def test_drift_baseline_and_psi_equal_jax(binned_pair):
    jd, td, x = binned_pair
    scores = 1 / (1 + np.exp(-x[:, 0]))
    jb = jdrift.compute_baseline(jd._inner, scores=scores)
    tb = tdrift.compute_baseline(td._inner, scores=scores)
    assert tb == jb
    assert len(tb["features"]) == 5          # the categorical is skipped
    r = np.random.RandomState(9)
    served = np.concatenate([x[:300], x[300:600] + 0.8])
    preds = 1 / (1 + np.exp(-served[:, 0]))
    psis = []
    for mod, b in ((jdrift, jb), (tdrift, tb)):
        mon = mod.DriftMonitor(b, threshold=10.0, window=512, min_rows=128,
                               check_every=64, min_interval_s=0)
        for i in range(0, 600, 75):
            mon.observe(served[i:i + 75], preds[i:i + 75], version="v1")
        psis.append(mon.check_now())
        mon.close()
    assert set(psis[1]) == set(psis[0]) and psis[1]
    for k in psis[0]:
        assert abs(psis[1][k] - psis[0][k]) <= 1e-12, k
    for p, q in ((np.ones(4), r.rand(4)), (r.rand(16), r.rand(16))):
        assert abs(tdrift.psi(p, q) - jdrift.psi(p, q)) <= 1e-12


def test_drift_fires_once_per_window_and_sidecar_roundtrip(tmp_path):
    ttelemetry.set_mode("summary")
    mon = tdrift.DriftMonitor(_synthetic_baseline(), threshold=0.2,
                              window=256, min_rows=128, check_every=64,
                              min_interval_s=0)
    for _ in range(8):
        mon.observe(np.full((64, 2), 0.9))
    assert max(mon.check_now().values()) > 1.0
    assert mon.snapshot()["fires"] == 1
    for _ in range(2):                         # inside the cooldown
        mon.observe(np.full((64, 2), 0.9))
    mon.check_now()
    assert mon.snapshot()["fires"] == 1
    mon.close()
    from lightgbm_tpu_torch.telemetry import counters, events
    assert counters.get("watchdog_fires") >= 1
    assert [e for e in events.events("watchdog")
            if e.get("monitor") == "drift_psi"]
    assert events.events("drift")
    path = tdrift.save_baseline(_synthetic_baseline(),
                                str(tmp_path / "m.txt.drift.json"))
    assert jdrift.load_baseline(path) == tdrift.load_baseline(path)
    assert tdrift.load_baseline(str(tmp_path / "missing.json")) is None


# ---------------------------------------------------------------------------
# transforms

def test_transform_bins_equal_jax(binned_pair, tmp_path):
    jd, td, x = binned_pair
    js = json.loads(json.dumps(jtransforms.capture_transform(jd)))
    ts = json.loads(json.dumps(ttransforms.capture_transform(td)))
    assert ts == js
    path = ttransforms.save_transform(ts, str(tmp_path / "t.json"))
    assert jtransforms.load_transform(path) == \
        ttransforms.load_transform(path)
    je, te = jtransforms.EdgeTransform(js), ttransforms.EdgeTransform(ts)
    rows = x[:200].copy()
    rows[::17, 1] = np.nan
    np.testing.assert_array_equal(te.bin_rows(rows), je.bin_rows(rows))
    np.testing.assert_array_equal(te.prebin_rows(rows),
                                  je.prebin_rows(rows))
    text = "\n".join(",".join("" if np.isnan(v) else repr(float(v))
                              for v in row) for row in rows[:5])
    np.testing.assert_array_equal(te.parse_csv(text), je.parse_csv(text))
    assert te.describe() == je.describe()


# ---------------------------------------------------------------------------
# trace sampling + feedback

@pytest.mark.parametrize("rate", [0.25, 0.4, 1.0])
def test_trace_sampling_equal_jax(rate):
    picks = []
    for tel, tr in ((jtelemetry, jtrace), (ttelemetry, ttrace)):
        tel.set_mode("summary")
        tr.configure(rate)
        picks.append([tr.start("r%d" % i) is not None for i in range(40)])
        tel.set_mode("off")
    assert picks[1] == picks[0]
    assert sum(picks[1]) == math.floor(40 * rate)
    assert ttrace.start("x") is None             # events off: no trace


def test_trace_spans_land_in_the_event_stream():
    ttelemetry.set_mode("summary")
    ttrace.configure(1.0)
    t = ttrace.start("abc")
    t.span("router", 0.001, version="v1")
    from lightgbm_tpu_torch.telemetry import events
    spans = events.events("trace_span")
    assert spans and spans[-1]["trace"] == "abc"
    assert spans[-1]["span"] == "router"


def test_feedback_auc_equal_jax():
    r = np.random.RandomState(11)
    labels = (r.rand(500) > 0.4).astype(float)
    scores = np.round(labels * 0.3 + r.rand(500), 1)   # many ties
    assert tfeedback.binary_auc(labels, scores) == \
        jfeedback.binary_auc(labels, scores)
    assert tfeedback.binary_auc(np.ones(4), np.arange(4)) is None
    snaps = []
    for mod in (jfeedback, tfeedback):
        fs = mod.FeedbackStore(capacity=300)
        for i in range(0, 500, 100):
            fs.record("v%d" % (i // 250), labels[i:i + 100],
                      scores[i:i + 100])
        snaps.append((fs.snapshot(), fs.auc("v0"), fs.labels("v1")))
    assert snaps[1] == snaps[0]
    with pytest.raises(ValueError):
        tfeedback.FeedbackStore().record("v", [1, 0], [0.5])


# ---------------------------------------------------------------------------
# placement

def test_placement_plan_assignment_and_bad_ordinal():
    devices = ["d0", "d1", "d2", "d3"]
    plan = PlacementPlan("stable=0,canary=1", devices=devices)
    assert plan.assign("stable") == "d0"
    assert plan.assign("canary") == "d1"
    other = plan.assign("other")          # least-loaded: d2 or d3
    assert other in ("d2", "d3")
    assert plan.assign("other") == other  # sticky
    assert plan.device_for("nope") is None
    assert plan.snapshot()["stable"] == 0
    plan.release("other")
    assert "other" not in plan.snapshot()
    assert parse_placement_spec("auto") == {}
    with pytest.raises(ValueError):
        parse_placement_spec("stable")
    bad = PlacementPlan("canary=4", devices=devices)
    with pytest.raises(LightGBMError, match="ordinal 4"):
        bad.assign("canary")
    assert bad.assign("other") in devices
