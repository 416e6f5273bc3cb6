"""Fault-tolerant training in the port (lightgbm_tpu_torch/resilience and
its seams in models/gbdt.py, engine.py, callback.py and basic.py) against
its own uninterrupted runs and the JAX package.

A resumed run's model text is byte-equal to the uninterrupted run's in
every mode (the scores come back bit for bit from the stored f32 arrays,
the RNG states mid-stream). Checkpoints move between the packages in both
directions: the same header, manifest and npz keys. The fault layer draws
from the same seeded RandomState as the JAX package's, so one spec
poisons the same rows, and both packages' sentries then grow the same
trees (the generic iteration in both, as a gradient fault plan forces).
The kill / preempt cases run a training subprocess that dies (exit 137)
or checkpoints and exits (76). Sizes are the JAX tests'
(tests/test_resilience.py): 600 x 10 rows, 7 leaves.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.resilience import checkpoint as jckpt
from lightgbm_tpu.resilience import faults as jfaults
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch import engine as tengine
from lightgbm_tpu_torch.callback import CallbackEnv, checkpoint
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.resilience import faults, preempt
from lightgbm_tpu_torch.resilience.checkpoint import (
    CheckpointError, CheckpointManager, atomic_write_text, find_checkpoint,
    load_checkpoint)
from lightgbm_tpu_torch.resilience.sentries import (NonFiniteError,
                                                     all_finite,
                                                     loss_spike_guard)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
        "min_gain_to_split": 1e-3,
        "verbosity": -1}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # compact unless a case asks for masked (600 rows would pick masked)
    monkeypatch.setenv("LGBM_TPU_STRATEGY", "compact")
    monkeypatch.setenv("LGBM_TPU_CHUNK", "8192")
    monkeypatch.delenv("LGBM_TPU_FAULT_SPEC", raising=False)
    faults.clear()
    jfaults.clear()
    preempt.clear()
    yield
    faults.clear()
    jfaults.clear()
    preempt.clear()


def make_binary(n=600, f=10, seed=7):
    r = np.random.RandomState(seed)
    x = r.randn(n, f)
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + r.randn(n) * 0.5 > 0).astype(np.float64)
    return x, y


def _auc(scores, label):
    order = np.argsort(scores)
    lab = label[order]
    n1 = lab.sum()
    n0 = len(lab) - n1
    ranks = np.arange(1, len(lab) + 1)
    return float((ranks[lab > 0].sum() - n1 * (n1 + 1) / 2) / (n0 * n1))


def _train(params, rounds, x, y, **kw):
    return tengine.train(dict(params), tbasic.Dataset(x, y),
                         num_boost_round=rounds, verbose_eval=False,
                         device="cpu", **kw)


def _text(bst):
    return bst._gbdt.save_model_to_string(0, -1)


def _trees_text(text):
    """Model text without its parameters block (each package writes its
    own config there)."""
    head, _, rest = text.partition("\nparameters:")
    _, _, tail = rest.partition("end of parameters")
    return head + tail


def _structure(trees):
    return [(list(t.split_feature[:t.num_leaves - 1]),
             list(t.left_child[:t.num_leaves - 1]),
             list(t.right_child[:t.num_leaves - 1]),
             list(t.leaf_count[:t.num_leaves])) for t in trees]


def _assert_same_trees(trees_a, trees_b, x):
    """The convention of tests/test_torch_engine.py: the same structure,
    thresholds equal up to empty bins, leaf values within f32 tolerance."""
    assert _structure(trees_a) == _structure(trees_b)
    for ta, tb in zip(trees_a, trees_b):
        for node in range(ta.num_leaves - 1):
            col = x[:, ta.split_feature[node]]
            lo, hi = sorted((ta.threshold[node], tb.threshold[node]))
            assert not np.any((col > lo) & (col <= hi))
        np.testing.assert_allclose(ta.leaf_value[:ta.num_leaves],
                                   tb.leaf_value[:tb.num_leaves],
                                   rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# the checkpoint file format and its manager

def test_atomic_write_is_atomic_and_clean(tmp_path):
    path = tmp_path / "out.txt"
    atomic_write_text(str(path), "hello")
    atomic_write_text(str(path), "world")
    assert path.read_text() == "world"
    assert [p for p in os.listdir(tmp_path) if ".tmp" in p] == []


def test_checkpoint_rotation_and_latest(tmp_path):
    x, y = make_binary(n=400)
    bst = _train(BASE, 3, x, y)
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    paths = []
    for _ in range(3):                       # saves at iterations 3, 4, 5
        paths.append(mgr.save(bst))
        bst.update()
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2
    assert os.path.basename(paths[-1]) in names
    assert mgr.latest().iteration == 5


def test_checkpoint_checksum_rejects_truncation(tmp_path):
    x, y = make_binary(n=400)
    bst = _train(BASE, 4, x, y)
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    good = mgr.save(bst)
    bst.update()
    bad = mgr.save(bst)
    blob = open(bad, "rb").read()
    open(bad, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(CheckpointError):
        load_checkpoint(bad)
    data = mgr.latest()                      # falls back to the older one
    assert data.path == good and data.iteration == 4
    assert find_checkpoint(str(tmp_path)).iteration == 4


# ---------------------------------------------------------------------------
# resume == the uninterrupted run, byte for byte

RESUME_CASES = {
    "float": {},
    "quantized": {"quantized_grad": True, "grad_bits": 8},
    "bagging": {"bagging_fraction": 0.8, "bagging_freq": 3,
                "feature_fraction": 0.9},
    # 1 / learning_rate = 4 warm-up iterations, then sampled
    "goss": {"boosting": "goss", "learning_rate": 0.25, "top_rate": 0.3,
             "other_rate": 0.2},
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0},
    "bynode": {"feature_fraction_bynode": 0.5},
    "categorical": {"categorical_feature": [8, 9]},
    "masked": {},
    "stream_chunked": {"stream_mode": "chunked"},
    "stream_goss": {"stream_mode": "goss", "boosting": "goss",
                    "learning_rate": 0.25, "top_rate": 0.3,
                    "other_rate": 0.2},
}


def _case_data(case):
    x, y = make_binary()
    if case == "categorical":
        r = np.random.RandomState(3)
        x[:, 8] = r.randint(0, 6, len(x))
        x[:, 9] = r.randint(0, 12, len(x))
        y = ((x[:, 8] % 2 == 0) ^ (x[:, 0] > 0.3)).astype(np.float64)
    return x, y


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resume_is_byte_equal_to_the_uninterrupted_run(tmp_path, case,
                                                       monkeypatch):
    if case == "masked":
        monkeypatch.setenv("LGBM_TPU_STRATEGY", "masked")
    elif case.startswith("stream"):
        monkeypatch.delenv("LGBM_TPU_STRATEGY")
    x, y = _case_data(case)
    params = dict(BASE, **RESUME_CASES[case])
    full = _train(params, 12, x, y)
    _train(params, 7, x, y,
           callbacks=[checkpoint(str(tmp_path), checkpoint_freq=7)])
    resumed = _train(params, 12, x, y, resume_from=str(tmp_path))
    assert resumed.current_iteration() == 12
    assert _text(resumed) == _text(full)
    if case.startswith("stream"):
        data = find_checkpoint(str(tmp_path))
        assert data.meta["version"] == 2 and "stream" in data.state
    if case == "goss":
        # the resumed iterations are sampled ones
        assert resumed._gbdt._fused_step.get(True) is not None


def test_resume_skips_torn_checkpoint(tmp_path):
    x, y = make_binary()
    params = dict(BASE, bagging_fraction=0.8, bagging_freq=3)
    full = _train(params, 8, x, y)
    _train(params, 6, x, y,
           callbacks=[checkpoint(str(tmp_path), checkpoint_freq=2)])
    ckpts = CheckpointManager(str(tmp_path)).checkpoints()
    assert [it for it, _ in ckpts] == [2, 4, 6]
    newest = ckpts[-1][1]
    blob = open(newest, "rb").read()
    open(newest, "wb").write(blob[:len(blob) // 2])
    assert find_checkpoint(str(tmp_path)).iteration == 4
    resumed = _train(params, 8, x, y, resume_from=str(tmp_path))
    assert resumed.current_iteration() == 8
    assert _text(resumed) == _text(full)


def test_resume_restores_evals_result_and_best_iteration(tmp_path):
    x, y = make_binary(n=300)
    xv, yv = make_binary(n=300, seed=99)
    params = dict(BASE, learning_rate=0.5, num_leaves=31)

    def run(resume_from=None):
        evals = {}
        bst = tengine.train(
            dict(params), tbasic.Dataset(x, y), num_boost_round=40,
            valid_sets=[tbasic.Dataset(xv, yv)], valid_names=["v"],
            early_stopping_rounds=5, evals_result=evals, verbose_eval=False,
            callbacks=[checkpoint(str(tmp_path), checkpoint_freq=4)],
            resume_from=resume_from, device="cpu")
        return bst, evals

    full, evals_full = run()
    assert 0 < full.best_iteration < 40      # the overfit run stops early
    ckpts = CheckpointManager(str(tmp_path)).checkpoints()
    early = [p for it, p in ckpts if it <= full.best_iteration]
    resumed, evals_res = run(early[0] if early else ckpts[0][1])
    assert resumed.best_iteration == full.best_iteration
    assert evals_res["v"] == evals_full["v"]
    assert _text(resumed) == _text(full)


def test_booster_checkpoint_roundtrip(tmp_path):
    x, y = make_binary(n=400)
    bst = _train(BASE, 6, x, y)
    path = bst.save_checkpoint(str(tmp_path))
    for _ in range(3):
        bst.update()
    fresh = tbasic.Booster(dict(BASE), tbasic.Dataset(x, y), device="cpu")
    fresh.restore_checkpoint(path)
    assert fresh.current_iteration() == 6
    for _ in range(3):
        fresh.update()
    assert _text(fresh) == _text(bst)


# ---------------------------------------------------------------------------
# checkpoints across the two packages

# no bagging: out-of-bag rows between a tied threshold pair go each
# package's way (ROADMAP.md section 3), which the row check below sees
CROSS = dict(BASE, feature_fraction=0.9)


def test_jax_checkpoint_loads_and_resumes_in_the_port(tmp_path):
    x, y = make_binary()
    jdir, jdir2 = str(tmp_path / "jax"), str(tmp_path / "jax2")
    jlgb.train(dict(CROSS), jlgb.Dataset(x, y), num_boost_round=7,
               verbose_eval=False,
               callbacks=[jlgb.callback.checkpoint(jdir, checkpoint_freq=7)])
    jdata = jckpt.find_checkpoint(jdir)
    assert jdata.iteration == 7
    # the port reads it: the same iteration, trees, scores and bag RNG
    port = tbasic.Booster(dict(CROSS), tbasic.Dataset(x, y), device="cpu")
    port.restore_checkpoint(jdata.path)
    g = port._gbdt
    assert g.iter == 7 and port.current_iteration() == 7
    assert _trees_text(_text(port)) == _trees_text(jdata.model_text)
    np.testing.assert_array_equal(g.score_updater.score.numpy(),
                                  jdata.state["train_score"])
    jrng = jdata.state["bag_rng"]
    trng = g._bag_rng.get_state()
    assert trng[0] == jrng[0] and trng[2:] == jrng[2:]
    np.testing.assert_array_equal(trng[1], jrng[1])
    # both packages resume it to 12 rounds: the same trees
    os.makedirs(jdir2)
    import shutil
    shutil.copy(jdata.path, jdir2)
    jres = jlgb.train(dict(CROSS), jlgb.Dataset(x, y), num_boost_round=12,
                      verbose_eval=False, resume_from=jdir2)
    tres = _train(CROSS, 12, x, y, resume_from=jdir)
    assert tres.current_iteration() == jres.current_iteration() == 12
    _assert_same_trees(tres._gbdt.models, jres._gbdt.models, x)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    x, y = make_binary()
    bst = _train(CROSS, 7, x, y,
                 callbacks=[checkpoint(str(tmp_path), checkpoint_freq=7)])
    path = CheckpointManager(str(tmp_path)).checkpoints()[-1][1]
    jdata = jckpt.load_checkpoint(path)       # the JAX reader, unchanged
    assert jdata.iteration == 7 and jdata.meta["target_rounds"] == 7
    assert jdata.model_text == _text(bst)
    np.testing.assert_array_equal(jdata.state["train_score"],
                                  bst._gbdt.score_updater.score.numpy())
    # and a JAX booster takes it up and goes on training
    jb = jlgb.Booster(dict(CROSS), jlgb.Dataset(x, y))
    jckpt.restore_checkpoint(jb, jdata)
    assert jb.current_iteration() == 7
    jb.update()
    assert jb.current_iteration() == 8


# ---------------------------------------------------------------------------
# kill and resume, graceful preemption (subprocesses)

_CHILD = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from lightgbm_tpu_torch import basic, engine
from lightgbm_tpu_torch.callback import checkpoint
r = np.random.RandomState(7)
x = r.randn(600, 10)
logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
y = (logit + r.randn(600) * 0.5 > 0).astype(np.float64)
engine.train(dict({params!r}), basic.Dataset(x, y), num_boost_round=12,
             verbose_eval=False, device="cpu",
             callbacks=[checkpoint({d!r}, checkpoint_freq={freq})])
"""


def _child(spec, directory, params, freq):
    env = dict(os.environ, LGBM_TPU_FAULT_SPEC=spec, PYTHONPATH=ROOT,
               LGBM_TPU_NO_SIGNAL_HANDLERS="1")
    code = _CHILD.format(root=ROOT, params=params, d=str(directory),
                         freq=freq)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_kill_at_iteration_7_then_resume_is_byte_equal(tmp_path):
    params = dict(BASE, bagging_fraction=0.8, bagging_freq=1)
    r = _child("kill_rank@iter=7", tmp_path, params, 5)
    assert r.returncode == 137, r.stderr[-2000:]
    assert [it for it, _ in CheckpointManager(str(tmp_path)).checkpoints()] \
        == [5]
    x, y = make_binary()
    full = _train(params, 12, x, y)
    resumed = _train(params, 12, x, y, resume_from=str(tmp_path))
    assert _text(resumed) == _text(full)


def test_preempt_exits_76_and_resumes_to_the_target(tmp_path):
    params = dict(BASE)
    r = _child("preempt@iter=4", tmp_path, params, 100)
    assert r.returncode == 76, r.stderr[-2000:]
    data = find_checkpoint(str(tmp_path))
    assert data.iteration == 4 and data.meta["target_rounds"] == 12
    assert data.meta["preempted"] is True
    x, y = make_binary()
    full = _train(params, 12, x, y)
    resumed = tengine.train(dict(params), tbasic.Dataset(x, y),
                            num_boost_round=None, verbose_eval=False,
                            resume_from=str(tmp_path), device="cpu")
    assert resumed.current_iteration() == 12
    assert _text(resumed) == _text(full)
    with pytest.raises(ValueError):
        tengine.train(dict(params), tbasic.Dataset(x, y),
                      num_boost_round=None, device="cpu")


def test_preempt_flag_without_a_vote():
    """One process: no vote across ranks, the group's answer is the local
    flag, first arm wins, clear resets it."""
    assert preempt.resolve_group_sync() is False
    assert not preempt.group_requested()
    preempt.arm("first")
    preempt.arm("second")
    assert preempt.requested() and preempt.group_requested()
    assert preempt.reason() == "first"
    assert preempt.resolve_group_sync() is False
    preempt.clear()
    assert not preempt.group_requested() and preempt.reason() == ""


# ---------------------------------------------------------------------------
# sentries, with the same fault spec as the JAX package

def test_all_finite():
    assert all_finite(torch.ones(3), torch.zeros(2))
    assert not all_finite(torch.ones(3), torch.tensor([1.0, np.nan]))
    assert not all_finite(torch.tensor([np.inf]))


def test_nonfinite_raise_names_iteration():
    x, y = make_binary(n=400)
    faults.install("nan_grad@iter=5")
    with pytest.raises(NonFiniteError, match="iteration 5"):
        _train(dict(BASE, on_nonfinite="raise"), 10, x, y)
    jfaults.install("nan_grad@iter=5")
    with pytest.raises(Exception, match="iteration 5"):
        jlgb.train(dict(BASE, on_nonfinite="raise"), jlgb.Dataset(x, y),
                   num_boost_round=10, verbose_eval=False)


def test_nonfinite_skip_iter_grows_the_jax_trees():
    x, y = make_binary()
    params = dict(BASE, on_nonfinite="skip_iter")
    plan = faults.install("nan_grad@iter=5")
    bst = _train(params, 12, x, y)
    assert bst.num_trees() == 11            # iteration 5 grew no tree
    assert np.isfinite(bst.predict(x)).all()
    jplan = jfaults.install("nan_grad@iter=5")
    jb = jlgb.train(dict(params), jlgb.Dataset(x, y), num_boost_round=12,
                    verbose_eval=False)
    assert plan.events == jplan.events == ["nan_grad@iter=5"]
    _assert_same_trees(bst._gbdt.models, jb._gbdt.models, x)


@pytest.mark.parametrize("quantized", [False, True])
def test_nonfinite_rollback_completes_with_auc_parity(quantized):
    """Rollback at iteration 7 redoes iteration 6 once, so 15 calls grow
    14 trees: the JAX package's own rollback run's, with the clean run's
    leaves for every training row (the fault fires once)."""
    x, y = make_binary()
    params = dict(BASE, quantized_grad=quantized, grad_bits=8)
    clean = _train(params, 15, x, y)
    spec = "nan_grad@iter=7,frac=0.05"
    plan = faults.install(spec)
    faulted = _train(dict(params, on_nonfinite="rollback"), 15, x, y)
    preds = faulted.predict(x)
    assert np.isfinite(preds).all()
    assert abs(_auc(clean.predict(x), y) - _auc(preds, y)) <= 0.005
    assert faulted.num_trees() == 14
    leaves = faulted.predict(x, pred_leaf=True)
    np.testing.assert_array_equal(leaves,
                                  clean.predict(x, pred_leaf=True)[:, :14])
    jplan = jfaults.install(spec)
    jb = jlgb.train(dict(params, on_nonfinite="rollback"),
                    jlgb.Dataset(x, y), num_boost_round=15,
                    verbose_eval=False)
    assert plan.events == jplan.events == ["nan_grad@iter=7"]
    assert len(jb._gbdt.models) == 14
    # the same trees as the JAX package's: structure and leaf values as
    # _assert_same_trees holds them, and each training row in the same
    # leaf (a threshold may sit anywhere in bins that no row of its node
    # fills)
    jtrees = jb._gbdt.models
    assert _structure(faulted._gbdt.models) == _structure(jtrees)
    for ta, tb in zip(faulted._gbdt.models, jtrees):
        np.testing.assert_allclose(ta.leaf_value[:ta.num_leaves],
                                   tb.leaf_value[:tb.num_leaves],
                                   rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(
        leaves, np.asarray(jb.predict(x, pred_leaf=True)))


@pytest.mark.parametrize("spec,iteration", [
    ("nan_grad@iter=3,frac=0.05", 3),
    ("inf_grad@iter=2,frac=0.2;seed=11", 2),
    ("nan_grad@p=0.5;seed=5", 0),
])
def test_fault_plan_poisons_the_jax_rows(spec, iteration):
    import jax.numpy as jnp
    g = np.random.RandomState(1).randn(1, 500).astype(np.float32)
    h = np.ones_like(g)
    plan, jplan = faults.FaultPlan(spec), jfaults.FaultPlan(spec)
    for it in range(iteration + 1):
        tg, _ = plan.inject_gradients(torch.from_numpy(g), torch.from_numpy(h),
                                      it)
        jg, _ = jplan.inject_gradients(jnp.asarray(g), jnp.asarray(h), it)
    np.testing.assert_array_equal(~np.isfinite(tg.numpy()),
                                  ~np.isfinite(np.asarray(jg)))
    assert (~np.isfinite(tg.numpy())).any()
    assert plan.events == jplan.events


def _fused_run(policy):
    x, y = make_binary()
    xv, yv = make_binary(n=200, seed=99)
    bst = tengine.train(dict(BASE, on_nonfinite=policy),
                        tbasic.Dataset(x, y), num_boost_round=5,
                        valid_sets=[tbasic.Dataset(xv, yv)],
                        verbose_eval=False, device="cpu")
    assert bst._gbdt._fused_step is not None
    return bst


def test_fused_guard_skip_iter_commits_nothing():
    bst = _fused_run("skip_iter")
    g = bst._gbdt
    # a test-only poke: no fault verb reaches inside the fused step
    g.score_updater.score[0, 3] = float("nan")
    text, it = _text(bst), g.iter
    score = g.score_updater.score.clone()
    vscore = g.valid_updaters[0].score.clone()
    syncs = g.learner.stats.host_syncs
    assert bst.update() is False
    assert g.learner.stats.host_syncs == syncs + 1   # the tree's one fetch
    assert g.iter == it + 1 and _text(bst) == text
    np.testing.assert_array_equal(g.score_updater.score.numpy(),
                                  score.numpy())
    np.testing.assert_array_equal(g.valid_updaters[0].score.numpy(),
                                  vscore.numpy())


def test_fused_guard_rollback_redoes_once_then_raises(monkeypatch):
    bst = _fused_run("rollback")
    g = bst._gbdt
    calls = []
    inner = GBDT._train_one_iter_fused

    def counted(self):
        calls.append(self.iter)
        return inner(self)
    monkeypatch.setattr(GBDT, "_train_one_iter_fused", counted)
    g.score_updater.score[0, 3] = float("nan")
    with pytest.raises(NonFiniteError, match="after rollback"):
        bst.update()
    # iteration 5 tripped, iteration 4 was rolled back and redone once
    assert calls == [5, 4]
    assert g.num_trees() == 4


def test_fused_guard_raise_names_the_iteration():
    bst = _fused_run("raise")
    bst._gbdt.score_updater.score[0, 0] = float("inf")
    with pytest.raises(NonFiniteError, match="iteration 5"):
        bst.update()


# ---------------------------------------------------------------------------
# the fault grammar, collective retry, the loss-spike guard

@pytest.mark.parametrize("spec", [
    "nan_grad@iter=7,frac=0.5;fail_collective@p=0.1;delay_ms=50;seed=9",
    "inf_grad@p=0.05",
    "kill_rank@iter=3,code=9;preempt@iter=2",
    "fail_request@version=v2,n=5;fail_collective@n=2",
])
def test_fault_spec_grammar_matches_jax(spec):
    clauses, seed, delay = faults.parse_spec(spec)
    jclauses, jseed, jdelay = jfaults.parse_spec(spec)
    assert (seed, delay) == (jseed, jdelay)
    assert [(c.name, c.args) for c in clauses] \
        == [(c.name, c.args) for c in jclauses]
    assert faults.FaultPlan(spec).has_gradient_faults \
        == jfaults.FaultPlan(spec).has_gradient_faults


def test_fault_spec_rejects_bad_grammar():
    with pytest.raises(ValueError):
        faults.parse_spec("explode@iter=1")
    with pytest.raises(ValueError):
        faults.parse_spec("just_nonsense")


def test_run_collective_retries_then_succeeds():
    faults.install("fail_collective@n=2")
    calls = []
    out = faults.run_collective(lambda: calls.append(1) or 42,
                                site="t", base_delay_s=0.001)
    assert out == 42 and len(calls) == 1
    assert faults.active_plan().collective_calls == 3


def test_run_collective_exhausts_budget():
    faults.install("fail_collective@n=99")
    with pytest.raises(faults.TransientCollectiveError):
        faults.run_collective(lambda: 1, site="t", retries=2,
                              base_delay_s=0.001)


def test_run_collective_clean_path_untouched():
    assert faults.active_plan() is None
    assert faults.run_collective(lambda: "ok") == "ok"


def test_loss_spike_guard_unit():
    calls = []

    class FakeModel:
        _train_data_name = "training"

        def rollback_one_iter(self):
            calls.append("rollback")

        def reset_parameter(self, p):
            calls.append(("lr", p["learning_rate"]))

    guard = loss_spike_guard(threshold=0.5, lr_cut=0.5, verbose=False)
    params = {"learning_rate": 0.1}

    def env(it, val):
        return CallbackEnv(
            model=FakeModel(), params=params, iteration=it,
            begin_iteration=0, end_iteration=10,
            evaluation_result_list=[("training", "binary_logloss",
                                     val, False)])
    guard(env(0, 0.50))
    guard(env(1, 0.45))
    guard(env(2, 0.60))
    assert calls == []
    guard(env(3, 1.20))
    assert calls == ["rollback", ("lr", 0.05)]
    assert params["learning_rate"] == 0.05
    guard(env(4, 0.44))
    assert len(calls) == 2
    with pytest.raises(ValueError):
        loss_spike_guard(threshold=0.0)
    with pytest.raises(ValueError):
        loss_spike_guard(lr_cut=0.0)


def test_loss_spike_guard_rolls_back():
    """A learning rate of 40 at iteration 5 blows the training loss up;
    the guard takes that iteration back."""
    x, y = make_binary(n=400)
    guard = loss_spike_guard(threshold=0.5, lr_cut=0.5, verbose=False)
    params = dict(BASE, metric="binary_logloss")
    lrs = [0.3] * 5 + [40.0] + [0.3] * 6
    bst = _train(params, 12, x, y, callbacks=[guard], learning_rates=lrs)
    assert guard._spike_state["rollbacks"] == 1
    assert bst.num_trees() == 11
    assert np.isfinite(bst.predict(x)).all()
