"""The port's C ABI (lightgbm_tpu_torch/csrc/c_api.cpp over
lightgbm_tpu_torch/capi_impl.py), driven by ctypes as external bindings
drive it: the cases of tests/test_c_api.py and
tests/test_c_api_concurrent.py on lib_lightgbm_tpu_torch.so, held against
the JAX package's capi/lib_lightgbm_tpu.so on the same calls (return codes,
errors for a bad handle, eval names, CalcNumPredict / GetNumPredict) and
against the port's Booster (byte-equal model text, equal predictions).

Every call trains on the CPU: BoosterCreate's parameter string says
device_type=cpu, and the calls that carry no parameter string (a model
file or string load) read LGBM_TPU_DEVICE_TYPE=cpu, set for this module.
"""
import ctypes
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops.kernels.build import capi_library

from conftest import make_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(REPO, "capi", "lib_lightgbm_tpu.so")
CPU = b" device_type=cpu"
DBL_P = ctypes.POINTER(ctypes.c_double)


@pytest.fixture(scope="module")
def cpu_env():
    old = os.environ.get("LGBM_TPU_DEVICE_TYPE")
    os.environ["LGBM_TPU_DEVICE_TYPE"] = "cpu"
    yield
    if old is None:
        os.environ.pop("LGBM_TPU_DEVICE_TYPE", None)
    else:
        os.environ["LGBM_TPU_DEVICE_TYPE"] = old


def _open(path):
    lib = ctypes.CDLL(path)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def lib(cpu_env):
    return _open(capi_library())


@pytest.fixture(scope="module")
def jlib(cpu_env):
    if not os.path.exists(JAX_LIB):
        r = subprocess.run(["make", "-C", os.path.dirname(JAX_LIB)],
                           capture_output=True)
        if r.returncode != 0:
            pytest.skip("the JAX package's C API lib did not build")
    return _open(JAX_LIB)


def _check(lib, rc):
    assert rc == 0, lib.LGBM_GetLastError().decode()


def _vp(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _dataset(lib, x, y, params=b""):
    xf = np.ascontiguousarray(x, dtype=np.float64)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        _vp(xf), 1, x.shape[0], x.shape[1], 1, params, None,
        ctypes.byref(ds)))
    yl = np.ascontiguousarray(y, dtype=np.float32)
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", _vp(yl), len(y), 0))
    return ds


def _booster(lib, ds, params, iters):
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(iters):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    return bst


def _predict(lib, bst, x, predict_type=0, parameter=b""):
    xf = np.ascontiguousarray(x, dtype=np.float64)
    out = np.zeros(x.shape[0], dtype=np.float64)
    n = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterPredictForMat(
        bst, _vp(xf), 1, x.shape[0], x.shape[1], 1, predict_type, -1,
        parameter, ctypes.byref(n), out.ctypes.data_as(DBL_P)))
    assert n.value == x.shape[0]
    return out


def _model_text(lib, bst):
    n = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0,
                                                  ctypes.byref(n), None))
    buf = ctypes.create_string_buffer(n.value)
    _check(lib, lib.LGBM_BoosterSaveModelToString(bst, 0, -1, n.value,
                                                  ctypes.byref(n), buf))
    return buf.value.decode()


def _port_booster(x, y, dparams, params, iters):
    """The same training through the port's Booster on the CPU."""
    b = tlgb.Booster(params=dict(params), device="cpu",
                     train_set=tlgb.Dataset(x, y, params=dict(dparams),
                                            device="cpu"))
    for _ in range(iters):
        b.update()
    return b


def _kv(s):
    return dict(t.split("=", 1) for t in s.decode().split())


def _eval_surface(lib, bst):
    """Eval names, counts, higher-better flags, CalcNumPredict for the
    four predict types and GetNumPredict of the training data."""
    cnt = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(cnt)))
    bufs = [ctypes.create_string_buffer(128) for _ in range(8)]
    arr = (ctypes.c_char_p * 8)(*[ctypes.addressof(b) for b in bufs])
    n = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetEvalNames(bst, ctypes.byref(n), arr))
    hb = (ctypes.c_int * 8)()
    _check(lib, lib.LGBM_BoosterGetEvalHigherBetter(bst, ctypes.byref(n),
                                                    hb))
    calc = []
    for ptype in range(4):
        v = ctypes.c_int64()
        _check(lib, lib.LGBM_BoosterCalcNumPredict(bst, 37, ptype, -1,
                                                   ctypes.byref(v)))
        calc.append(v.value)
    v = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterGetNumPredict(bst, 0, ctypes.byref(v)))
    return {"counts": cnt.value,
            "names": [b.value.decode() for b in bufs[:n.value]],
            "higher_better": list(hb[:n.value]), "calc_num_predict": calc,
            "num_predict": v.value}


def test_c_api_train_predict_save(lib, jlib, tmp_path):
    x, y = make_binary(600, 8)
    params = b"objective=binary num_leaves=15 verbosity=-1 " \
        b"metric=binary_logloss,auc" + CPU
    surfaces = {}
    for name, lb in (("port", lib), ("jax", jlib)):
        ds = _dataset(lb, x, y, b"max_bin=63")
        n = ctypes.c_int32()
        _check(lb, lb.LGBM_DatasetGetNumData(ds, ctypes.byref(n)))
        assert n.value == 600
        _check(lb, lb.LGBM_DatasetGetNumFeature(ds, ctypes.byref(n)))
        assert n.value == 8
        bst = _booster(lb, ds, params, 10)
        it = ctypes.c_int()
        _check(lb, lb.LGBM_BoosterGetCurrentIteration(bst,
                                                      ctypes.byref(it)))
        assert it.value == 10
        surfaces[name] = _eval_surface(lb, bst)
        if name == "port":
            pbst, pds = bst, ds
    assert surfaces["port"] == surfaces["jax"]
    assert surfaces["port"]["names"] == ["binary_logloss", "auc"]

    out_len = ctypes.c_int()
    results = (ctypes.c_double * 8)()
    _check(lib, lib.LGBM_BoosterGetEval(pbst, 0, ctypes.byref(out_len),
                                        results))
    ref = _port_booster(x, y, {"max_bin": "63"}, _kv(params), 10)
    want = {m: v for _, m, v, _ in ref.eval_train()}
    assert out_len.value == 2
    np.testing.assert_allclose(results[:2], [want["binary_logloss"],
                                             want["auc"]], rtol=1e-12)
    # byte-equal model text and equal predictions: the port's Booster
    assert _model_text(lib, pbst) == ref.model_to_string()
    pred = _predict(lib, pbst, x)
    np.testing.assert_array_equal(pred, ref.predict(x))
    assert np.mean((pred > 0.5) == (y > 0)) > 0.85

    # save / load round trip (the load reads LGBM_TPU_DEVICE_TYPE)
    model_path = str(tmp_path / "capi_model.txt").encode()
    _check(lib, lib.LGBM_BoosterSaveModel(pbst, 0, -1, model_path))
    bst2 = ctypes.c_void_p()
    niter = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(
        model_path, ctypes.byref(niter), ctypes.byref(bst2)))
    assert niter.value == 10
    np.testing.assert_array_equal(_predict(lib, bst2, x), pred)
    imp = (ctypes.c_double * 8)()
    _check(lib, lib.LGBM_BoosterFeatureImportance(pbst, 0, 0, imp))
    np.testing.assert_array_equal(list(imp), ref.feature_importance())
    for h in (pbst, bst2):
        _check(lib, lib.LGBM_BoosterFree(h))
    _check(lib, lib.LGBM_DatasetFree(pds))


def test_c_api_custom_objective(lib):
    x, y = make_binary(400, 6)
    ds = _dataset(lib, x, y)
    bst = ctypes.c_void_p()
    params = b"objective=none verbosity=-1 num_leaves=7" + CPU
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    ref = tlgb.Booster(params=_kv(params), device="cpu",
                       train_set=tlgb.Dataset(x, y, device="cpu"))
    fin = ctypes.c_int()
    score = np.zeros(400, dtype=np.float64)
    for _ in range(5):
        p = 1.0 / (1.0 + np.exp(-score))
        grad = (p - y).astype(np.float32)
        hess = (p * (1 - p)).astype(np.float32)
        _check(lib, lib.LGBM_BoosterUpdateOneIterCustom(
            bst, grad.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hess.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(fin)))
        ref.update(fobj=lambda preds, _ds, g=grad, h=hess: (g, h))
        score = _predict(lib, bst, x, predict_type=1)
    np.testing.assert_array_equal(score, ref.predict(x, raw_score=True))
    assert _model_text(lib, bst) == ref.model_to_string()
    acc = np.mean(((1 / (1 + np.exp(-score))) > 0.5) == (y > 0))
    assert acc > 0.8


def test_c_api_csc_and_sparse_predict(lib):
    """CSC construction + CSR/CSC prediction (reference c_api.h:191/:698)."""
    x, y = make_binary(400, 6)
    xf = np.ascontiguousarray(x, dtype=np.float64)
    col_ptr = np.arange(0, 401 * 6, 400, dtype=np.int32)[:7]
    indices = np.tile(np.arange(400, dtype=np.int32), 6)
    data = np.ascontiguousarray(xf.T.reshape(-1))
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromCSC(
        _vp(col_ptr), 2, _vp(indices), _vp(data), 1, ctypes.c_int64(7),
        ctypes.c_int64(2400), ctypes.c_int64(400), b"", None,
        ctypes.byref(ds)))
    yl = np.ascontiguousarray(y, dtype=np.float32)
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", _vp(yl), 400, 0))
    params = b"objective=binary num_leaves=7 verbosity=-1" + CPU
    bst = _booster(lib, ds, params, 5)
    dense = _predict(lib, bst, x)
    ref = _port_booster(x, y, {}, _kv(params), 5)
    np.testing.assert_array_equal(dense, ref.predict(x))

    indptr = np.arange(0, 401 * 6, 6, dtype=np.int32)[:401]
    csr_idx = np.tile(np.arange(6, dtype=np.int32), 400)
    csr_data = np.ascontiguousarray(xf.reshape(-1))
    out2 = (ctypes.c_double * 400)()
    olen = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterPredictForCSR(
        bst, _vp(indptr), 2, _vp(csr_idx), _vp(csr_data), 1,
        ctypes.c_int64(401), ctypes.c_int64(2400), ctypes.c_int64(6),
        0, -1, b"", ctypes.byref(olen), out2))
    np.testing.assert_allclose(np.array(out2[:400]), dense, rtol=1e-9)
    out3 = (ctypes.c_double * 1)()
    row = np.ascontiguousarray(xf[3])
    _check(lib, lib.LGBM_BoosterPredictForMatSingleRow(
        bst, _vp(row), 1, 6, 1, 0, -1, b"", ctypes.byref(olen), out3))
    assert abs(out3[0] - dense[3]) < 1e-9


def test_c_api_booster_admin_functions(lib, jlib):
    """Merge, shuffle, leaf get/set, ResetParameter, CalcNumPredict,
    GetPredict, NumberOfTotalModel, feature names, DumpModel; the counts
    and names held against the JAX package's library."""
    x, y = make_binary(500, 5)
    params = b"objective=binary num_leaves=7 verbosity=-1" + CPU
    seen = {}
    for name, lb in (("port", lib), ("jax", jlib)):
        b1 = _booster(lb, _dataset(lb, x, y), params, 3)
        b2 = _booster(lb, _dataset(lb, x, y), params, 2)
        _check(lb, lb.LGBM_BoosterMerge(b1, b2))
        total, per = ctypes.c_int(), ctypes.c_int()
        _check(lb, lb.LGBM_BoosterNumberOfTotalModel(b1,
                                                     ctypes.byref(total)))
        _check(lb, lb.LGBM_BoosterNumModelPerIteration(b1,
                                                       ctypes.byref(per)))
        bufs = [ctypes.create_string_buffer(128) for _ in range(5)]
        arr = (ctypes.c_char_p * 5)(*[ctypes.addressof(b) for b in bufs])
        cnt = ctypes.c_int()
        _check(lb, lb.LGBM_BoosterGetFeatureNames(b2, ctypes.byref(cnt),
                                                  arr))
        seen[name] = (total.value, per.value,
                      [b.value.decode() for b in bufs], _eval_surface(lb, b2))
        if name == "port":
            pb1, pb2 = b1, b2
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == (5, 1)

    val = ctypes.c_double()
    _check(lib, lib.LGBM_BoosterGetLeafValue(pb1, 0, 1, ctypes.byref(val)))
    _check(lib, lib.LGBM_BoosterSetLeafValue(
        pb1, 0, 1, ctypes.c_double(val.value + 1.5)))
    val2 = ctypes.c_double()
    _check(lib, lib.LGBM_BoosterGetLeafValue(pb1, 0, 1, ctypes.byref(val2)))
    assert abs(val2.value - val.value - 1.5) < 1e-12
    _check(lib, lib.LGBM_BoosterResetParameter(pb1, b"learning_rate=0.05"))
    _check(lib, lib.LGBM_BoosterShuffleModels(pb1, 0, -1))

    n64 = ctypes.c_int64()
    out = np.zeros(500, dtype=np.float64)
    _check(lib, lib.LGBM_BoosterGetPredict(pb2, 0, ctypes.byref(n64),
                                           out.ctypes.data_as(DBL_P)))
    assert n64.value == 500
    ref = _port_booster(x, y, {}, _kv(params), 2)
    np.testing.assert_allclose(out, ref.predict(x), rtol=1e-6, atol=1e-7)

    out_len = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterDumpModel(pb2, 0, -1, 0,
                                          ctypes.byref(out_len), None))
    buf = ctypes.create_string_buffer(out_len.value)
    _check(lib, lib.LGBM_BoosterDumpModel(pb2, 0, -1, out_len.value,
                                          ctypes.byref(out_len), buf))
    assert json.loads(buf.value.decode()) == json.loads(json.dumps(
        ref.dump_model()))


def test_c_api_streaming_dataset_and_subset(lib):
    """CreateFromSampledColumn + PushRows + GetSubset."""
    x, y = make_binary(300, 4)
    xf = np.ascontiguousarray(x, dtype=np.float64)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromSampledColumn(
        None, None, 4, None, 0, 300, b"", ctypes.byref(ds)))
    for lo in (0, 150):
        part = np.ascontiguousarray(xf[lo:lo + 150])
        _check(lib, lib.LGBM_DatasetPushRows(ds, _vp(part), 1, 150, 4, lo))
    yl = np.ascontiguousarray(y, dtype=np.float32)
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", _vp(yl), 300, 0))
    params = b"objective=binary num_leaves=7 verbosity=-1" + CPU
    bst = _booster(lib, ds, params, 1)
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 1
    assert _model_text(lib, bst) == _port_booster(
        x, y, {}, _kv(params), 1).model_to_string()
    idx = np.arange(0, 300, 2, dtype=np.int32)
    sub = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetGetSubset(ds, _vp(idx), 150, b"",
                                          ctypes.byref(sub)))
    n = ctypes.c_int32()
    _check(lib, lib.LGBM_DatasetGetNumData(sub, ctypes.byref(n)))
    assert n.value == 150


def test_c_api_predict_for_file(lib, tmp_path):
    x, y = make_binary(200, 4)
    data_file = tmp_path / "pred_in.csv"
    np.savetxt(data_file, np.column_stack([y, x]), delimiter=",",
               fmt="%.6f")
    params = b"objective=binary num_leaves=7 verbosity=-1" + CPU
    bst = _booster(lib, _dataset(lib, x, y), params, 3)
    out_file = tmp_path / "pred_out.txt"
    _check(lib, lib.LGBM_BoosterPredictForFile(
        bst, str(data_file).encode(), 0, 0, -1, b"label_column=0",
        str(out_file).encode()))
    preds = np.loadtxt(out_file)
    ref = _port_booster(x, y, {}, _kv(params), 3)
    np.testing.assert_allclose(
        preds, ref.predict(np.loadtxt(data_file, delimiter=",")[:, 1:]),
        rtol=1e-12)


def test_c_api_network_init_with_functions(lib, jlib):
    for lb in (lib, jlib):
        _check(lb, lb.LGBM_NetworkInitWithFunctions(2, 0, None, None))
        _check(lb, lb.LGBM_NetworkFree())
    from lightgbm_tpu_torch.parallel import network
    assert (network.num_machines(), network.rank()) == (1, 0)


def test_c_api_set_last_error(lib):
    lib.LGBM_SetLastError(b"custom error 42")
    assert lib.LGBM_GetLastError().decode() == "custom error 42"
    lib.LGBM_SetLastError(b"")


def test_c_api_merge_continuation(lib, tmp_path):
    """BoosterCreate + BoosterMerge: the R bindings' init_model
    continuation; the merged history seeds continued training."""
    x, y = make_binary(800, 6)
    params = b"objective=binary verbosity=-1 seed=3" + CPU
    bst1 = _booster(lib, _dataset(lib, x, y, b"max_bin=63"), params, 4)
    model_file = str(tmp_path / "cont.txt").encode()
    _check(lib, lib.LGBM_BoosterSaveModel(bst1, 0, -1, model_file))
    loaded = ctypes.c_void_p()
    it = ctypes.c_int(0)
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(
        model_file, ctypes.byref(it), ctypes.byref(loaded)))
    assert it.value == 4
    bst2 = _booster(lib, _dataset(lib, x, y, b"max_bin=63"), params, 0)
    _check(lib, lib.LGBM_BoosterMerge(bst2, loaded))
    cur = ctypes.c_int(0)
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst2, ctypes.byref(cur)))
    assert cur.value == 4
    raw1 = _predict(lib, bst1, x, 1)
    np.testing.assert_allclose(_predict(lib, bst2, x, 1), raw1, rtol=1e-6)
    seeded = np.zeros(800, dtype=np.float64)
    n64 = ctypes.c_int64(0)
    _check(lib, lib.LGBM_BoosterGetPredict(bst2, 0, ctypes.byref(n64),
                                           seeded.ctypes.data_as(DBL_P)))
    np.testing.assert_allclose(seeded, 1.0 / (1.0 + np.exp(-raw1)),
                               rtol=1e-5, atol=1e-5)
    fin = ctypes.c_int()
    for _ in range(4):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst2, ctypes.byref(fin)))
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst2, ctypes.byref(cur)))
    assert cur.value == 8

    def logloss(p_raw):
        p = 1.0 / (1.0 + np.exp(-p_raw))
        return -np.mean(y * np.log(p + 1e-9) + (1 - y) * np.log(1 - p + 1e-9))
    assert logloss(_predict(lib, bst2, x, 1)) < logloss(raw1) - 1e-4


# -- concurrency (tests/test_c_api_concurrent.py) --------------------------

@pytest.fixture(scope="module")
def booster(lib):
    x, y = make_binary(700, 8)
    params = b"objective=binary num_leaves=15 verbosity=-1" + CPU
    bst = _booster(lib, _dataset(lib, x, y, b"max_bin=63"), params, 8)
    xf = np.ascontiguousarray(x, dtype=np.float64)
    return bst, xf, _predict(lib, bst, x), _predict(lib, bst, x, 1)


def _dispatch_stats(lib):
    r, b, m = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    _check(lib, lib.LGBM_TPU_PredictDispatchStats(
        ctypes.byref(r), ctypes.byref(b), ctypes.byref(m)))
    return r.value, b.value, m.value


def _threads(fns):
    errors = []

    def wrap(fn):
        try:
            fn()
        except Exception as e:   # surface thread failures in the test
            errors.append(e)
    ts = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors[0]


def test_concurrent_single_row_dense(lib, booster):
    bst, xf, bulk, _ = booster
    reqs0, batches0, _ = _dispatch_stats(lib)
    n_threads, per_thread = 8, 50
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        out = (ctypes.c_double * 1)()
        olen = ctypes.c_int64()
        barrier.wait()
        for i in range(per_thread):
            ridx = (tid * per_thread + i) % xf.shape[0]
            row = np.ascontiguousarray(xf[ridx])
            _check(lib, lib.LGBM_BoosterPredictForMatSingleRow(
                bst, _vp(row), 1, 8, 1, 0, -1, b"", ctypes.byref(olen),
                out))
            assert olen.value == 1
            assert abs(out[0] - bulk[ridx]) < 1e-12, (tid, i, ridx)
    _threads([lambda t=t: worker(t) for t in range(n_threads)])
    reqs1, batches1, max_batch = _dispatch_stats(lib)
    assert reqs1 - reqs0 == n_threads * per_thread
    assert batches1 - batches0 < reqs1 - reqs0
    assert max_batch >= 2


def test_concurrent_csr_single_row_matches_dense(lib, booster):
    bst, xf, bulk, _ = booster

    def worker(tid):
        out = (ctypes.c_double * 1)()
        olen = ctypes.c_int64()
        for i in range(25):
            ridx = (tid * 25 + i) % xf.shape[0]
            row = np.ascontiguousarray(xf[ridx])
            nz = np.nonzero(row)[0].astype(np.int32)
            indptr = np.array([0, len(nz)], dtype=np.int32)
            vals = np.ascontiguousarray(row[nz])
            _check(lib, lib.LGBM_BoosterPredictForCSRSingleRow(
                bst, _vp(indptr), 2, _vp(nz), _vp(vals), 1,
                ctypes.c_int64(2), ctypes.c_int64(len(nz)),
                ctypes.c_int64(8), 0, -1, b"", ctypes.byref(olen), out))
            assert abs(out[0] - bulk[ridx]) < 1e-12, (tid, i, ridx)
    _threads([lambda t=t: worker(t) for t in range(4)])


def test_concurrent_mixed_configs_and_error_isolation(lib, jlib, booster):
    """Normal and raw predicts batch apart but coexist; a bogus handle
    fails only its own caller, with the JAX library's return code."""
    bst, xf, bulk, bulk_raw = booster
    row0 = np.zeros(8)

    def bad_rc(lb):
        out = (ctypes.c_double * 1)()
        olen = ctypes.c_int64()
        rc = lb.LGBM_BoosterPredictForMatSingleRow(
            ctypes.c_void_p(0xdead0), _vp(row0), 1, 8, 1, 0, -1, b"",
            ctypes.byref(olen), out)
        return rc, lb.LGBM_GetLastError().decode()
    rc, msg = bad_rc(lib)
    jrc, jmsg = bad_rc(jlib)
    assert rc == jrc != 0 and msg and jmsg

    def good(raw):
        out = (ctypes.c_double * 1)()
        olen = ctypes.c_int64()
        for i in range(30):
            row = np.ascontiguousarray(xf[i])
            _check(lib, lib.LGBM_BoosterPredictForMatSingleRow(
                bst, _vp(row), 1, 8, 1, 1 if raw else 0, -1, b"",
                ctypes.byref(olen), out))
            want = bulk_raw[i] if raw else bulk[i]
            assert abs(out[0] - want) < 1e-12

    def bad():
        for _ in range(10):
            rc, msg = bad_rc(lib)
            assert rc != 0 and msg != ""
    _threads([lambda: good(False), lambda: good(True), bad])


_CHILD_HEAD = r"""
import ctypes, os, sys, numpy as np
sys.path.insert(0, %r)
from lightgbm_tpu_torch.ops.kernels.build import capi_library
lib = ctypes.CDLL(capi_library())
lib.LGBM_GetLastError.restype = ctypes.c_char_p
rng = np.random.RandomState(1)
x = rng.randn(300, 6); y = (x[:, 0] > 0).astype(np.float32)
xf = np.ascontiguousarray(x, dtype=np.float64)
ds = ctypes.c_void_p()
assert lib.LGBM_DatasetCreateFromMat(
    xf.ctypes.data_as(ctypes.c_void_p), 1, 300, 6, 1, b"", None,
    ctypes.byref(ds)) == 0, lib.LGBM_GetLastError()
assert lib.LGBM_DatasetSetField(
    ds, b"label", y.ctypes.data_as(ctypes.c_void_p), 300, 0) == 0
bst = ctypes.c_void_p()
assert lib.LGBM_BoosterCreate(
    ds, b"objective=binary num_leaves=7 verbosity=-1 device_type=cpu",
    ctypes.byref(bst)) == 0, lib.LGBM_GetLastError()
fin = ctypes.c_int()
for _ in range(3):
    assert lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)) == 0

def single_row(i):
    out = (ctypes.c_double * 1)()
    n = ctypes.c_int64()
    row = np.ascontiguousarray(xf[i])
    rc = lib.LGBM_BoosterPredictForMatSingleRow(
        bst, row.ctypes.data_as(ctypes.c_void_p), 1, 6, 1, 0, -1, b"",
        ctypes.byref(n), out)
    assert rc == 0, lib.LGBM_GetLastError()
    return out[0]
""" % REPO


@pytest.mark.parametrize("case", ["fork_respawns_worker",
                                  "dispatch_disabled"])
def test_dispatcher_in_a_fresh_process(case):
    """fork() after a dispatch: the child respawns the dispatcher's worker
    (per-pid latch + atfork protocol); LGBM_TPU_PREDICT_BATCH=0 takes the
    direct path (the env is latched at the first predict)."""
    if case == "fork_respawns_worker":
        body = r"""
before = single_row(5)
pid = os.fork()
if pid == 0:
    try:
        assert abs(single_row(5) - before) < 1e-12
        os._exit(0)
    except BaseException:
        os._exit(1)
_, status = os.waitpid(pid, 0)
assert status == 0, status
assert abs(single_row(5) - before) < 1e-12
print("OK")
"""
        env = dict(os.environ)
    else:
        body = r"""
bulk = np.zeros(300)
n = ctypes.c_int64()
assert lib.LGBM_BoosterPredictForMat(
    bst, xf.ctypes.data_as(ctypes.c_void_p), 1, 300, 6, 1, 0, -1, b"",
    ctypes.byref(n), bulk.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double))) == 0
assert abs(single_row(7) - bulk[7]) < 1e-12
r = ctypes.c_int64(); b = ctypes.c_int64(); m = ctypes.c_int64()
assert lib.LGBM_TPU_PredictDispatchStats(
    ctypes.byref(r), ctypes.byref(b), ctypes.byref(m)) == 0
assert r.value == 0, "direct path must not touch the dispatcher"
print("OK")
"""
        env = dict(os.environ, LGBM_TPU_PREDICT_BATCH="0")
    env["LGBM_TPU_DEVICE_TYPE"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _CHILD_HEAD + body],
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, (r.stdout[-500:], r.stderr[-2000:])
    assert "OK" in r.stdout
