"""The port's serving core against the JAX package's: the bucketed
ensemble, the predictor cache, the registry and the micro-batcher.

One model text per case is trained in the JAX package (binary, 3-class
multiclass, one categorical column, a random forest for the average
output's divisor) and read by both packages' registries; the port's runs
on the CPU. Scores agree within 1e-6 (both walk the same f32 values; the
link runs in f32 on each side). The port's cache builds an entry where
the JAX cache compiles, so over one request sequence its entries, builds,
hits and misses equal the JAX counts. Batcher tests order their threads
with events (or flush inline), never with sleeps.
"""
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.serving import ModelRegistry as JRegistry
from lightgbm_tpu.serving.stats import LatencyHistogram as JHistogram
from lightgbm_tpu_torch.models.gbdt import GBDT as TGBDT
from lightgbm_tpu_torch.serving import (MicroBatcher, ModelNotFound,
                                        ModelRegistry, OverloadedError,
                                        PredictorCache, RequestTimeout)
from lightgbm_tpu_torch.serving.stats import LatencyHistogram

# these tests share the host with timing-sensitive tests in other
# workers: one CPU thread for torch keeps them from bursting
torch.set_num_threads(1)

KINDS = ("binary", "multiclass", "categorical", "rf")


def _data(kind, n=600, seed=7):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8)
    if kind == "categorical":
        x[:, 0] = r.randint(0, 8, size=n)
    m = 1.5 * x[:, 1] - x[:, 2] + 0.5 * x[:, 3] * x[:, 4]
    if kind == "categorical":
        m = m + np.where(np.isin(x[:, 0], (1, 4, 6)), 1.5, -1.0)
    noisy = m + 0.5 * r.randn(n)
    if kind == "multiclass":
        return x, np.digitize(noisy, [-0.7, 0.7]).astype(np.float64)
    return x, (noisy > 0).astype(np.float64)


def _params(kind):
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "learning_rate": 0.3, "max_bin": 63, "verbosity": -1}
    if kind == "multiclass":
        p.update(objective="multiclass", num_class=3)
    elif kind == "categorical":
        p["categorical_feature"] = [0]
    elif kind == "rf":
        p.update(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    return p


def _jax_text(kind, seed=7, rounds=6):
    x, y = _data(kind, seed=seed)
    mp = pytest.MonkeyPatch()
    mp.setenv("LGBM_TPU_NO_VMAP_K", "1")
    try:
        p = _params(kind)
        cat = p.pop("categorical_feature", "auto")
        b = jlgb.train(p, jlgb.Dataset(x, y, categorical_feature=cat),
                       rounds, verbose_eval=False)
    finally:
        mp.undo()
    return b.model_to_string(num_iteration=-1), x


@pytest.fixture(scope="module")
def texts():
    return {k: _jax_text(k) for k in KINDS}


def _port_booster(text):
    return tlgb.Booster(model_str=text, device="cpu")


def _port_train(seed, rounds=8):
    x, y = _data("binary", seed=seed)
    return tlgb.train(_params("binary"), tlgb.Dataset(x, y), rounds,
                      device="cpu"), x


# ---------------------------------------------------------------------------
# the bucketed ensemble

@pytest.mark.parametrize("kind", KINDS)
def test_bucketed_ensemble_matches_jax(texts, kind):
    from lightgbm_tpu.models.gbdt import GBDT as JGBDT
    text, _ = texts[kind]
    ja, jtc, jn = JGBDT.load_model_from_string(text).ensemble_arrays(
        None, 0, bucket=True)
    ta, ttc, tn = TGBDT.load_model_from_string(text).ensemble_arrays(
        None, 0, bucket=True)
    assert tn == jn
    for name in ("split_feature", "threshold", "threshold_bin",
                 "decision_type", "left_child", "right_child", "leaf_value",
                 "cat_boundaries", "cat_threshold"):
        assert tuple(getattr(ta, name).shape) == \
            tuple(getattr(ja, name).shape), name
    assert ta.max_depth == ja.max_depth
    assert ta.split_feature.shape[0] & (ta.split_feature.shape[0] - 1) == 0
    np.testing.assert_array_equal(ttc.numpy(), np.asarray(jtc))
    assert ttc.device.type == "cpu"          # the class map stays on host
    # padding trees are single-leaf trees of value 0
    assert torch.all(ta.leaf_value[tn:] == 0)
    assert torch.all(ta.left_child[tn:, 0] == -1)


def test_predict_raw_unchanged_by_bucketing(texts):
    text, x = texts["binary"]
    g = TGBDT.load_model_from_string(text)
    plain = g.predict_raw(x[:64])
    arrays, tc, _ = g.ensemble_arrays(None, 0, bucket=True)
    from lightgbm_tpu_torch.ops import predict as tpredict
    bucketed = tpredict.predict_raw_ensemble(
        torch.as_tensor(x[:64], dtype=torch.float32), arrays, tc,
        g.num_class).numpy().astype(np.float64)
    np.testing.assert_array_equal(bucketed, plain)


# ---------------------------------------------------------------------------
# predictor + registry

SIZES = (1, 5, 16, 33)


@pytest.mark.parametrize("kind", KINDS)
def test_predictor_matches_jax(texts, kind):
    text, x = texts[kind]
    jreg = JRegistry(warm_buckets=(1,))
    jreg.load(text)
    treg = ModelRegistry(warm_buckets=(1,), device="cpu")
    treg.load(text)
    jm, tm = jreg.get(), treg.get()
    assert tm.denom == float(np.asarray(jm.denom))
    assert tm.convert_key == jm.convert_key
    bst = _port_booster(text)
    raws = (False, True) if kind == "binary" else (False,)
    for raw in raws:
        for n in SIZES:
            got = treg.predictor.predict(tm, x[:n], raw_score=raw)
            want = jreg.predictor.predict(jm, x[:n], raw_score=raw)
            assert got.shape == want.shape == (n, tm.num_class)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            ref = bst.predict(x[:n], raw_score=raw)
            np.testing.assert_allclose(got.reshape(ref.shape), ref,
                                       rtol=0, atol=1e-6)
    ti, ji = treg.predictor.cache_info(), jreg.predictor.cache_info()
    for key in ("entries", "compiles", "hits", "misses", "evictions",
                "installs", "pinned_sigs", "max_entries"):
        assert ti[key] == ji[key], key
    assert set(ti) == set(ji)
    assert ti["donate"] == 0


def test_cache_counts_match_jax_over_a_request_sequence(texts):
    text, x = texts["binary"]
    jreg = JRegistry(warm_buckets=(4,))
    jreg.load(text)
    treg = ModelRegistry(warm_buckets=(4,), device="cpu")
    treg.load(text)
    for n in (1, 3, 4, 2, 9, 4, 1, 8, 16, 3, 12):
        raw = n % 3 == 0
        treg.predictor.predict(treg.get(), x[:n], raw_score=raw)
        jreg.predictor.predict(jreg.get(), x[:n], raw_score=raw)
        ti, ji = treg.predictor.cache_info(), jreg.predictor.cache_info()
        assert [ti[k] for k in ("entries", "compiles", "hits", "misses")] \
            == [ji[k] for k in ("entries", "compiles", "hits", "misses")]


def test_no_new_entry_after_warmup_and_same_shape_swap(texts):
    """After warm-up no request inside the warmed buckets builds an
    entry; a same-shape model (a refit, and a retrain whose depth rounds
    alike) swaps in with none and answers with its own predictions."""
    bst, x = _port_train(seed=7)
    reg = ModelRegistry(warm_buckets=(16,), device="cpu")
    reg.load(bst.model_to_string())
    m = reg.get()
    builds = reg.predictor.compile_count
    for n in (1, 2, 3, 5, 7, 8, 11, 16, 16, 1):
        reg.predictor.predict(m, x[:n])
    assert reg.predictor.compile_count == builds
    refit = _port_booster(bst.model_to_string())
    xn, yn = _data("binary", seed=99)
    refit.refit(xn, yn, decay_rate=0.9)
    reg.load(refit.model_to_string(), version="refit", warm=False)
    m2 = reg.get("refit")
    assert m2.shape_sig == m.shape_sig
    assert reg.predictor.family(m2, 8, False) == \
        reg.predictor.family(m, 8, False)
    out = reg.predictor.predict(m2, x[:9])
    assert reg.predictor.compile_count == builds
    np.testing.assert_allclose(out[:, 0], refit.predict(x[:9]), atol=1e-6)
    assert np.abs(out[:, 0] - bst.predict(x[:9])).max() > 1e-4
    bst3, _ = _port_train(seed=11)
    reg.load(bst3, version="v3", warm=False)
    assert reg.get("v3").shape_sig == m.shape_sig


def test_lru_never_drops_a_pinned_signature():
    bst_a, x = _port_train(seed=1, rounds=4)
    bst_b, _ = _port_train(seed=2, rounds=8)
    bst_c, _ = _port_train(seed=3, rounds=16)
    predictor = PredictorCache(max_entries=2)
    reg = ModelRegistry(predictor=predictor, warm_buckets=(8,),
                        device="cpu")
    v1 = reg.load(bst_a)
    reg.pin_version(v1)
    v2 = reg.load(bst_b)
    assert predictor.evictions == 0      # 2 entries, fits
    reg.load(bst_c)                      # 3rd entry: eviction pressure
    assert predictor.evictions == 1
    # LRU order: the pinned entry first, then the two newer ones; the
    # victim was the least recently used unpinned entry (v2's)
    fams = [fam for fam, _, _ in predictor.entries()]
    assert fams[0][0] == reg.get(v1).shape_sig
    assert reg.get(v2).shape_sig not in [f[0] for f in fams]
    builds = predictor.compile_count
    out = predictor.predict(reg.get(v1), x[:5])    # pinned: still warm
    assert predictor.compile_count == builds
    np.testing.assert_allclose(out[:, 0], bst_a.predict(x[:5]), atol=1e-6)
    predictor.predict(reg.get(v2), x[:5])          # victim: rebuilds
    assert predictor.compile_count == builds + 1
    assert [r["pinned"] for r in reg.versions()] == [True, False, False]
    # v2's rebuild evicted v3's entry; with every signature pinned, v3's
    # rebuild evicts nothing: over budget beats a build stall
    evictions = predictor.evictions
    reg.pin_version(v2)
    reg.pin_version("v3")
    predictor.predict(reg.get("v3"), x[:5])
    assert predictor.cache_info()["entries"] == 3
    assert predictor.evictions == evictions
    # pins are refcounted by shape signature
    reg.unpin_version(v1)
    assert reg.get(v1).shape_sig not in predictor.pinned()


def test_registry_versions_unload_and_sources(texts, tmp_path):
    text, x = texts["binary"]
    bst = _port_booster(text)
    reg = ModelRegistry(warm_buckets=(1,), device="cpu")
    with pytest.raises(ModelNotFound):
        reg.get()
    v1 = reg.load(bst)
    v2 = reg.load(text, version="prod")
    path = tmp_path / "model.txt"
    path.write_text(text)
    v3 = reg.load(str(path))
    assert reg.latest == v3
    assert [m["version"] for m in reg.versions()] == sorted([v1, v2, v3])
    assert reg.versions()[0]["device"] == "cpu"
    for v in (v1, v2, v3):
        out = reg.predictor.predict(reg.get(v), x[:3])
        np.testing.assert_allclose(out[:, 0], bst.predict(x[:3]),
                                   atol=1e-6)
    reg.unload(v3)
    # as in the JAX registry: the newest by name takes over
    assert reg.get().version == max(v1, v2)
    with pytest.raises(ModelNotFound):
        reg.get(v3)
    with pytest.raises(ValueError):
        reg.load(bst, version=v1)
    bst.best_iteration = 2               # an early-stopped booster
    v4 = reg.load(bst, version="best")
    assert reg.get(v4).n_trees == 2


# ---------------------------------------------------------------------------
# micro-batcher

@pytest.fixture(scope="module")
def stack_model(texts):
    text, x = texts["binary"]
    return _port_booster(text), text, x


def _manual_stack(text, **kw):
    reg = ModelRegistry(warm_buckets=(16,), device="cpu")
    reg.load(text)
    return reg, MicroBatcher(reg, start=False, **kw)


def test_batcher_coalesces_single_rows(stack_model):
    bst, text, x = stack_model
    reg, batcher = _manual_stack(text)
    assert batcher.flush() == 0          # empty flush: a no-op
    handles = [batcher.submit_async(x[i])[0] for i in range(5)]
    assert batcher.flush() == 5          # one batch, five requests
    assert batcher.stats.get("serve_batches") == 1
    for i, h in enumerate(handles):
        out, ver = h.wait(1.0)
        assert ver == reg.latest
        np.testing.assert_allclose(out[:, 0], bst.predict(x[i:i + 1]),
                                   atol=1e-6)


def test_batcher_oversize_split_and_reassembled(stack_model):
    bst, text, x = stack_model
    _, batcher = _manual_stack(text, max_batch=16)
    handles = batcher.submit_async(x[:50])
    assert len(handles) == 4
    assert batcher.stats.get("serve_requests_split") == 1
    flushed = 0
    while True:
        rows = batcher.flush()
        if not rows:
            break
        flushed += rows
    assert flushed == 50
    out = np.concatenate([h.wait(1.0)[0] for h in handles], axis=0)
    np.testing.assert_allclose(out[:, 0], bst.predict(x[:50]), atol=1e-6)


def test_batcher_overload_fast_fail(stack_model):
    _, text, x = stack_model
    _, batcher = _manual_stack(text, max_queue_rows=4)
    batcher.submit_async(x[:3])
    with pytest.raises(OverloadedError):
        batcher.submit_async(x[:2])      # 3 + 2 > 4: reject immediately
    assert batcher.stats.get("serve_rejected_overload") == 1
    batcher.submit_async(x[:1])          # still room for 1
    assert batcher.flush() == 4


def test_batcher_deadline_expires_in_queue(stack_model, monkeypatch):
    _, text, x = stack_model
    _, batcher = _manual_stack(text)
    from lightgbm_tpu_torch.serving import batcher as tbatcher
    clock = [1000.0]
    monkeypatch.setattr(tbatcher.time, "monotonic", lambda: clock[0])
    h = batcher.submit_async(x[:2], timeout_ms=10)[0]
    clock[0] += 0.05                     # the deadline lapses queued
    batcher.flush()
    with pytest.raises(RequestTimeout):
        h.wait(1.0)
    assert batcher.stats.get("serve_timeouts") == 1
    h2 = batcher.submit_async(x[:1], timeout_ms=10)[0]
    with pytest.raises(RequestTimeout):
        h2.wait(0.01)                    # nobody flushes: waiter gives up


def test_batcher_hot_swap_mid_flight_versions_consistent(stack_model):
    """A multi-chunk request pinned before a hot swap is served entirely
    by the version it resolved; later requests see the new version. The
    request is enqueued before the swap, so no thread timing decides."""
    bst, text, x = stack_model
    reg, batcher = _manual_stack(text, max_batch=16)
    v1 = reg.latest
    handles = batcher.submit_async(x[:40])
    assert batcher.flush() == 16         # first chunk on v1
    bst2, _ = _port_train(seed=11)
    reg.load(bst2, version="v2")         # hot swap mid-flight
    while batcher.flush():
        pass
    parts = [h.wait(1.0) for h in handles]
    assert {ver for _, ver in parts} == {v1}
    out = np.concatenate([p for p, _ in parts], axis=0)
    np.testing.assert_allclose(out[:, 0], bst.predict(x[:40]), atol=1e-6)
    h = batcher.submit_async(x[:3])[0]
    batcher.flush()
    res2, ver2 = h.wait(1.0)
    assert ver2 == "v2"
    np.testing.assert_allclose(res2[:, 0], bst2.predict(x[:3]), atol=1e-6)


def test_batcher_worker_coalesces_concurrent_clients(stack_model):
    """Worker-thread mode: eight clients released together by a barrier
    complete without manual flushing, in fewer batches than requests
    would take if a flush could not hold several."""
    bst, text, x = stack_model
    reg = ModelRegistry(warm_buckets=(16,), device="cpu")
    reg.load(text)
    batcher = MicroBatcher(reg, max_batch=16, max_delay_ms=20.0)
    barrier = threading.Barrier(8)
    outs = [None] * 8

    def client(i):
        barrier.wait()
        outs[i], _ = batcher.submit(x[i:i + 1], timeout_ms=30000)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out[:, 0], bst.predict(x[i:i + 1]),
                                       atol=1e-6)
        assert batcher.stats.get("serve_requests") == 8
        assert 1 <= batcher.stats.get("serve_batches") <= 8
        assert batcher.stats.get("serve_rows") == 8
    finally:
        batcher.close()


# ---------------------------------------------------------------------------
# stats

def test_latency_histogram_percentiles_equal_jax():
    samples = np.random.RandomState(3).lognormal(-6, 2, size=2000)
    samples = np.concatenate([samples, [0.0, -1.0, 1e-7, 500.0]])
    th, jh = LatencyHistogram(), JHistogram()
    for s in samples:
        th.record(float(s))
        jh.record(float(s))
    assert th.snapshot() == jh.snapshot()
    for p in (1, 50, 90, 95, 99, 99.9, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert LatencyHistogram().snapshot() == JHistogram().snapshot()
