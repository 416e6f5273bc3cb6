"""The port's continual loop against the JAX package's: the pure policy
kernel over a grid, frozen-mapper row appends and the shard wire packing
(bit-equal codes), a warm continuation on appended rows, a ContinualLoop
episode's event sequence, and `task=continual` as a subprocess.

Same numpy inputs from a seed through both packages (the port on the
CPU). Codes and packed words are held bit-equal; a continuation to the
parity conventions of ROADMAP.md (15 leaves, min_gain_to_split 1e-3:
tree structure equal, thresholds between the same training values,
predictions within 1e-5).
"""
import dataclasses
import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import types
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu import telemetry as jtelemetry
from lightgbm_tpu.continual import loop as jloop
from lightgbm_tpu.continual import update as jupdate
from lightgbm_tpu.fleet import CanaryRouter as JRouter
from lightgbm_tpu.serving import ModelRegistry as JRegistry
from lightgbm_tpu.serving.stats import ServingStats as JStats
from lightgbm_tpu.telemetry import watchdogs as jwatchdogs
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import telemetry as ttelemetry
from lightgbm_tpu_torch.continual import loop as tloop
from lightgbm_tpu_torch.continual import update as tupdate
from lightgbm_tpu_torch.fleet import CanaryRouter as TRouter
from lightgbm_tpu_torch.io.stream import DeviceDataShard
from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
from lightgbm_tpu_torch.serving import ModelRegistry as TRegistry
from lightgbm_tpu_torch.serving.stats import ServingStats as TStats
from lightgbm_tpu_torch.telemetry import watchdogs as twatchdogs

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the pure policy kernel: equal to the JAX package's over a grid

@pytest.mark.parametrize("policy", ["refit", "continue", "auto"])
def test_decide_equals_jax_over_a_grid(policy):
    states = [(0, None, float("-inf")), (1, "refit", 100.0),
              (2, "continue", 100.0), (3, "refit", 140.0)]
    grid = itertools.product(range(5), states,
                             (100.0, 105.0, 111.0, 150.0, 2100.0),
                             (0.0, 10.0), (None, 10.0))
    n = 0
    for fires, st, now, cooldown, reset in grid:
        jst, tst = jloop.PolicyState(*st), tloop.PolicyState(*st)
        ja, jn = jloop.decide(policy, fires, jst, now, cooldown, reset)
        ta, tn = tloop.decide(policy, fires, tst, now, cooldown, reset)
        assert ta == ja, (fires, st, now, cooldown, reset)
        assert dataclasses.astuple(tn) == dataclasses.astuple(jn)
        n += ta != "wait"
    assert n > 0
    for mod in (jloop, tloop):
        with pytest.raises(ValueError):
            mod.decide("yolo", 1, mod.PolicyState(), 0.0, 1.0)


# ---------------------------------------------------------------------------
# frozen-mapper appends and the wire packing: bit-equal codes

def _mixed(n, seed, unseen=False):
    """Dense columns (NaN in one), four mutually exclusive sparse ones
    (bundled by EFB) and a categorical one; `unseen` draws categories
    the training rows never had."""
    r = np.random.RandomState(seed)
    x = np.zeros((n, 10))
    x[:, :4] = r.randn(n, 4)
    x[r.rand(n) < 0.1, 1] = np.nan
    slot = r.randint(0, 8, n)
    for j in range(4):
        on = slot == j
        x[on, 4 + j] = r.rand(on.sum()) + 0.5
    x[:, 8] = r.randint(0, 6 if not unseen else 9, n)
    x[:, 9] = r.randn(n) * 3
    y = (x[:, 0] + np.nan_to_num(x[:, 1]) + (x[:, 8] > 2)
         + 0.5 * r.randn(n) > 0.5).astype(np.float64)
    return x, y


@pytest.mark.parametrize("bits,max_bin", [(4, 15), (8, 63), (16, 1023)])
def test_bin_rows_and_pack_codes_are_bit_equal_to_jax(bits, max_bin):
    x, y = _mixed(2000, 3)
    xn, yn = _mixed(300, 4, unseen=True)
    params = {"max_bin": max_bin, "verbosity": -1,
              "categorical_feature": "8"}
    jds = jlgb.Dataset(x, y, params=params).construct()
    tds = tlgb.Dataset(x, y, params=params).construct()
    jcodes, tcodes = jupdate.bin_rows(jds, xn), tupdate.bin_rows(tds, xn)
    assert tcodes.dtype == jcodes.dtype
    np.testing.assert_array_equal(tcodes, jcodes)
    ji, ti = jds._inner, tds._inner
    assert ti.bundled is not None and len(ti.columns) < ti.num_features
    old = ti.binned.copy()
    assert jupdate.append_rows(jds, xn, yn) == 2300
    assert tupdate.append_rows(tds, xn, yn) == 2300
    np.testing.assert_array_equal(ti.binned, ji.binned)
    np.testing.assert_array_equal(ti.bundled, ji.bundled)
    np.testing.assert_array_equal(ti.metadata.label, ji.metadata.label)
    assert ti.num_data == ti.metadata.num_data == 2300
    np.testing.assert_array_equal(ti.binned[:2000], old)
    # the wire layout: the JAX package's packing, the learner's, and a
    # live shard's append of the new block
    codes = ti.binned if bits != 4 else ti.binned & 0xF
    packed = tupdate.pack_codes(codes, bits)
    np.testing.assert_array_equal(packed, jupdate.pack_codes(codes, bits))
    np.testing.assert_array_equal(packed, DeviceTreeLearner.pack_codes(
        types.SimpleNamespace(item_bits=bits), codes))
    np.testing.assert_array_equal(
        tupdate.pack_codes(codes, bits, col_target=16),
        jupdate.pack_codes(codes, bits, col_target=16))
    shard = DeviceDataShard(tupdate.pack_codes(codes[:2000], bits),
                            item_bits=bits, c_cols=codes.shape[1])
    assert shard.append_rows(tupdate.pack_codes(codes[2000:], bits)) \
        == 2300
    np.testing.assert_array_equal(shard.wire.numpy().view(np.uint32),
                                  packed)
    with pytest.raises(ValueError):
        shard.append_rows(packed[:, :-1])


def _task(n, seed, shift=0.0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 6) + shift
    m = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    return x, (m + 0.5 * r.randn(n) > 0).astype(np.float64)


PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.2, "min_data_in_leaf": 20,
          "min_gain_to_split": 1e-3, "verbosity": -1}


def _structure(trees):
    return [(list(t.split_feature[:t.num_leaves - 1]),
             list(t.left_child[:t.num_leaves - 1]),
             list(t.right_child[:t.num_leaves - 1]),
             list(t.leaf_count[:t.num_leaves])) for t in trees]


def test_append_rows_and_continue_training_match_jax():
    x, y = _task(3000, 1)
    xn, yn = _task(600, 2, shift=0.7)
    xall = np.vstack([x, xn])
    jds, tds = jlgb.Dataset(x, y), tlgb.Dataset(x, y)
    jb = jlgb.train(PARAMS, jds, 3, verbose_eval=False)
    tb = tlgb.train(PARAMS, tds, 3, device="cpu")
    assert tb._gbdt.learner is not None
    jupdate.append_rows(jds, xn, yn)
    tupdate.append_rows(tds, xn, yn, booster=tb)
    # the trained Booster's learner (its copies of the old rows) is gone;
    # it still predicts
    assert tb._gbdt.learner is None and tds._inner._cache == {}
    assert np.all(np.isfinite(tb.predict(xn)))
    jc = jupdate.continue_training(jb, jds, 2)
    tc = tupdate.continue_training(tb, tds, 2)
    assert len(tc._gbdt.models) == len(jc._gbdt.models) == 5
    assert _structure(tc._gbdt.models) == _structure(jc._gbdt.models)
    for ta, tj in zip(tc._gbdt.models, jc._gbdt.models):
        for node in range(ta.num_leaves - 1):
            col = xall[:, ta.split_feature[node]]
            lo, hi = sorted((ta.threshold[node], tj.threshold[node]))
            assert not np.any((col > lo) & (col <= hi))
    np.testing.assert_allclose(tc.predict(xall), jc.predict(xall),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tupdate.bin_rows(tds, np.zeros((5, 2)))
    with pytest.raises(ValueError):
        tupdate.append_rows(tlgb.Dataset(x, y), x[:5], y[:5])


# ---------------------------------------------------------------------------
# a ContinualLoop episode: the JAX package's event sequence

def _episode(pkg, action):
    """One fire -> retrain -> canary -> promote episode with a fake
    clock; the continual_* events as (kind, action, episode)."""
    lgb, reg_cls, stats_cls, router_cls, loop_mod, update_mod, tel, wd = pkg
    x, y = _task(2000, 5)
    xn, yn = _task(400, 6, shift=0.5)
    kw = {"device": "cpu"} if lgb is tlgb else {}
    ds = lgb.Dataset(x, y, **kw)
    bst = lgb.train(PARAMS, ds, 3, **({"device": "cpu"} if lgb is tlgb
                                      else {"verbose_eval": False}))
    reg = reg_cls(warm_buckets=(1,), **kw)
    stats = stats_cls()
    router = router_cls(reg, stats, min_requests=1, p99_ratio=1000.0)
    reg.load(bst, version="v0")
    router.set_stable("v0")

    def retrain(act):
        text = reg.get(router.stable).gbdt.save_model_to_string(
            num_iteration=-1)
        prev = lgb.Booster(model_str=text, **kw)
        if act == "refit":
            return prev.refit(xn, yn, decay_rate=0.9)
        update_mod.append_rows(ds, xn, yn)
        return update_mod.continue_training(prev, ds, 2, params=PARAMS)

    clock = [0.0]
    loop = loop_mod.ContinualLoop(reg, router, retrain, policy=action,
                                  cooldown_s=5.0, canary_weight=0.5,
                                  time_fn=lambda: clock[0])
    tel.set_mode("summary")
    tel.events.reset()
    wd.reset()
    try:
        outs = [loop.step()]
        wd.fire_drift("test", 1.0, 0.2)
        clock[0] = 10.0
        outs.append(loop.step())
        canary = router.canary
        outs.append(loop.step())
        stats.observe_version(canary, 0.001)
        outs.append(router.evaluate())
        outs.append(loop.step())
        events = [(e["kind"], e.get("action"), e.get("episode"))
                  for e in tel.events.events()
                  if e["kind"].startswith("continual_")
                  and e["kind"] != "continual_append"]
        return outs, events, router.stable == canary, \
            len(reg.get(canary).gbdt.models)
    finally:
        wd.reset()
        tel.set_mode("off")
        tel.reset()


@pytest.mark.parametrize("action", ["refit", "continue"])
def test_loop_episode_emits_the_jax_event_sequence(action):
    jax_pkg = (jlgb, JRegistry, JStats, JRouter, jloop, jupdate,
               jtelemetry, jwatchdogs)
    torch_pkg = (tlgb, TRegistry, TStats, TRouter, tloop, tupdate,
                 ttelemetry, twatchdogs)
    j, t = _episode(jax_pkg, action), _episode(torch_pkg, action)
    assert t == j
    outs, events, promoted, trees = t
    assert outs == ["wait", "deployed", "pending", "promoted", "promoted"]
    assert [e[0] for e in events] == [
        "continual_fire", "continual_retrain", "continual_deploy",
        "continual_promote"]
    assert [e[1:] for e in events] == [(action, 1), (action, 1), (None, 1),
                                       (action, 1)]
    assert promoted and trees == (3 if action == "refit" else 5)


# ---------------------------------------------------------------------------
# task=continual as a subprocess on the CPU

def test_cli_continual_subprocess_answers_and_exits_on_sigint(tmp_path):
    x, y = _task(600, 8)
    data = str(tmp_path / "train.csv")
    np.savetxt(data, np.column_stack([y, x]), delimiter=",", fmt="%.6f")
    model = str(tmp_path / "model.txt")
    tlgb.train(PARAMS, tlgb.Dataset(x, y), 2, device="cpu").save_model(
        model)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=continual",
         "input_model=" + model, "data=" + data, "device_type=cpu",
         "serve_port=%d" % port, "serve_warm_buckets=4",
         "continual_poll_s=0.2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        health = None
        for _ in range(600):
            try:
                with urllib.request.urlopen(
                        "http://127.0.0.1:%d/healthz" % port,
                        timeout=2) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                if proc.poll() is not None:
                    break
                try:
                    proc.wait(timeout=0.1)
                except subprocess.TimeoutExpired:
                    pass
        assert health is not None and health["status"] == "ok", \
            proc.stdout.read().decode()[-2000:] if proc.poll() is not None \
            else health
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
