"""The R .Call glue over the port's C ABI, without an R interpreter.

Port of tests/test_r_glue_exec.py: the REAL glue
(R-package/src/lightgbm_tpu_R.cpp) is compiled against the stub R
headers (tools/rstub/) and linked with the mock R runtime
(tools/rmock/rmock.cpp) and the port's library
(lightgbm_tpu_torch/_build/lib_lightgbm_tpu_torch.so) into a temporary
directory, here by g++ directly (tools/rmock/Makefile links the JAX
package's library). The cases drive the glue's marshalling as R would:
column-major matrices, float down-conversion of fields, strings, the
error path, finalizers, and PROTECT balance on every call (rmock_invoke
returns -3 on imbalance). Golden cross-check: predictions through the
glue equal the same model's predictions through the plain C ABI.

The boosters train on the CPU: their parameter strings say
device_type=cpu, and the model-string load reads
LGBM_TPU_DEVICE_TYPE=cpu, set for this module.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from lightgbm_tpu_torch.ops.kernels.build import capi_library

from conftest import make_binary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEXP = ctypes.c_void_p


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not available")
    old = os.environ.get("LGBM_TPU_DEVICE_TYPE")
    os.environ["LGBM_TPU_DEVICE_TYPE"] = "cpu"
    capi = capi_library()
    out = str(tmp_path_factory.mktemp("rglue") / "lib_rglue_exec.so")
    r = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-fPIC", "-Wall",
         "-I" + os.path.join(REPO, "tools", "rstub"), "-shared", "-o", out,
         os.path.join(REPO, "tools", "rmock", "rmock.cpp"),
         os.path.join(REPO, "R-package", "src", "lightgbm_tpu_R.cpp"),
         capi, "-Wl,-rpath," + os.path.dirname(capi)],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    lib = ctypes.CDLL(out)
    for name, restype, argtypes in [
            ("rmock_init", ctypes.c_int, []),
            ("rmock_nil", SEXP, []),
            ("rmock_real_vector", SEXP, [ctypes.POINTER(ctypes.c_double),
                                         ctypes.c_long]),
            ("rmock_int_vector", SEXP, [ctypes.POINTER(ctypes.c_int),
                                        ctypes.c_long]),
            ("rmock_scalar_int", SEXP, [ctypes.c_int]),
            ("rmock_string", SEXP, [ctypes.c_char_p]),
            ("rmock_type", ctypes.c_int, [SEXP]),
            ("rmock_len", ctypes.c_long, [SEXP]),
            ("rmock_real_ptr", ctypes.POINTER(ctypes.c_double), [SEXP]),
            ("rmock_int_ptr", ctypes.POINTER(ctypes.c_int), [SEXP]),
            ("rmock_string_elt", ctypes.c_char_p, [SEXP, ctypes.c_long]),
            ("rmock_extptr_addr", ctypes.c_void_p, [SEXP]),
            ("rmock_last_error", ctypes.c_char_p, []),
            ("rmock_protect_depth", ctypes.c_int, []),
            ("rmock_entry_name", ctypes.c_char_p, [ctypes.c_int]),
            ("rmock_entry_nargs", ctypes.c_int, [ctypes.c_int]),
            ("rmock_run_finalizer", ctypes.c_int, [SEXP]),
            ("rmock_invoke", ctypes.c_int,
             [ctypes.c_char_p, ctypes.POINTER(SEXP), ctypes.c_int,
              ctypes.POINTER(SEXP)]),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    n = lib.rmock_init()
    assert n == 27, f"registration table has {n} entries"
    table = {lib.rmock_entry_name(i).decode(): lib.rmock_entry_nargs(i)
             for i in range(n)}
    # spot-check the registration table the way R resolves .Call
    assert table["LGBMTPU_DatasetCreateFromMat_R"] == 5
    assert table["LGBMTPU_BoosterPredictForMat_R"] == 6
    assert table["LGBMTPU_BoosterUpdateOneIter_R"] == 1
    yield lib
    if old is None:
        os.environ.pop("LGBM_TPU_DEVICE_TYPE", None)
    else:
        os.environ["LGBM_TPU_DEVICE_TYPE"] = old


def call(rt, name, *args):
    """Invoke a .Call entry; assert success and protect balance."""
    arr = (SEXP * max(len(args), 1))(*args)
    out = SEXP()
    rc = rt.rmock_invoke(name.encode(), arr, len(args), ctypes.byref(out))
    assert rc != -3, f"{name}: PROTECT stack imbalance"
    assert rc == 0, f"{name}: rc={rc} err={rt.rmock_last_error().decode()}"
    return out


def call_expect_error(rt, name, *args):
    arr = (SEXP * max(len(args), 1))(*args)
    out = SEXP()
    rc = rt.rmock_invoke(name.encode(), arr, len(args), ctypes.byref(out))
    assert rc == -1, f"{name}: expected Rf_error, rc={rc}"
    return rt.rmock_last_error().decode()


def _reals(rt, vals):
    a = np.ascontiguousarray(vals, dtype=np.float64)
    return rt.rmock_real_vector(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), a.size)


@pytest.fixture(scope="module")
def trained(rt):
    """Dataset + 5-iteration booster built ENTIRELY through .Call."""
    x, y = make_binary(500, 6)
    xf = np.asfortranarray(x, dtype=np.float64)  # R matrices: col-major
    mat = _reals(rt, xf.reshape(-1, order="F"))
    ds = call(rt, "LGBMTPU_DatasetCreateFromMat_R", mat,
              rt.rmock_scalar_int(500), rt.rmock_scalar_int(6),
              rt.rmock_string(b"max_bin=63"), rt.rmock_nil())
    assert rt.rmock_type(ds) == 22  # EXTPTRSXP
    call(rt, "LGBMTPU_DatasetSetField_R", ds, rt.rmock_string(b"label"),
         _reals(rt, y))
    bst = call(rt, "LGBMTPU_BoosterCreate_R", ds,
               rt.rmock_string(b"objective=binary num_leaves=15 "
                               b"verbosity=-1 metric=binary_logloss "
                               b"device_type=cpu"))
    for _ in range(5):
        call(rt, "LGBMTPU_BoosterUpdateOneIter_R", bst)
    return ds, bst, x, y


def test_dataset_dims_marshal(rt, trained):
    ds, _, x, _ = trained
    nd = call(rt, "LGBMTPU_DatasetGetNumData_R", ds)
    assert rt.rmock_int_ptr(nd)[0] == x.shape[0]
    nf = call(rt, "LGBMTPU_DatasetGetNumFeature_R", ds)
    assert rt.rmock_int_ptr(nf)[0] == x.shape[1]


def test_field_roundtrip_downcasts_to_float(rt, trained):
    """label SetField marshals double->float32 (the C ABI field type);
    GetField returns what the engine stored."""
    ds, _, _, y = trained
    got = call(rt, "LGBMTPU_DatasetGetField_R", ds,
               rt.rmock_string(b"label"))
    n = rt.rmock_len(got)
    assert n == len(y)
    vals = np.ctypeslib.as_array(rt.rmock_real_ptr(got), shape=(n,))
    np.testing.assert_array_equal(vals, y.astype(np.float32))


def test_training_progresses_and_eval(rt, trained):
    _, bst, _, _ = trained
    it = call(rt, "LGBMTPU_BoosterGetCurrentIteration_R", bst)
    assert rt.rmock_int_ptr(it)[0] == 5
    names = call(rt, "LGBMTPU_BoosterGetEvalNames_R", bst)
    assert rt.rmock_len(names) == 1
    assert rt.rmock_string_elt(names, 0) == b"binary_logloss"
    ev = call(rt, "LGBMTPU_BoosterGetEval_R", bst, rt.rmock_scalar_int(0))
    assert rt.rmock_real_ptr(ev)[0] < 0.6  # learned something


def test_predict_matches_c_abi_golden(rt, trained):
    """Column-major predictions through the glue == row-major through
    the plain C ABI for the same booster."""
    _, bst, x, _ = trained
    xf = np.asfortranarray(x, dtype=np.float64)
    mat = _reals(rt, xf.reshape(-1, order="F"))
    pred = call(rt, "LGBMTPU_BoosterPredictForMat_R", bst, mat,
                rt.rmock_scalar_int(x.shape[0]),
                rt.rmock_scalar_int(x.shape[1]),
                rt.rmock_scalar_int(0),   # predict_type normal
                rt.rmock_scalar_int(-1))  # num_iteration
    n = rt.rmock_len(pred)
    assert n == x.shape[0]
    via_r = np.ctypeslib.as_array(rt.rmock_real_ptr(pred), shape=(n,)).copy()

    capi = ctypes.CDLL(capi_library())
    handle = ctypes.c_void_p(rt.rmock_extptr_addr(bst))
    xr = np.ascontiguousarray(x, dtype=np.float64)
    out = np.zeros(x.shape[0], dtype=np.float64)
    olen = ctypes.c_int64()
    rc = capi.LGBM_BoosterPredictForMat(
        handle, xr.ctypes.data_as(ctypes.c_void_p), 1, x.shape[0],
        x.shape[1], 1, 0, -1, b"", ctypes.byref(olen),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0
    np.testing.assert_allclose(via_r, out, rtol=1e-12)


def test_model_string_roundtrip(rt, trained):
    _, bst, x, _ = trained
    s = call(rt, "LGBMTPU_BoosterSaveModelToString_R", bst,
             rt.rmock_scalar_int(-1))
    model_txt = rt.rmock_string_elt(s, 0)
    assert b"tree" in model_txt
    loaded = call(rt, "LGBMTPU_BoosterLoadModelFromString_R",
                  rt.rmock_string(model_txt))
    xf = np.asfortranarray(x[:50], dtype=np.float64)
    mat = _reals(rt, xf.reshape(-1, order="F"))
    p1 = call(rt, "LGBMTPU_BoosterPredictForMat_R", loaded, mat,
              rt.rmock_scalar_int(50), rt.rmock_scalar_int(x.shape[1]),
              rt.rmock_scalar_int(0), rt.rmock_scalar_int(-1))
    p2 = call(rt, "LGBMTPU_BoosterPredictForMat_R", trained[1], mat,
              rt.rmock_scalar_int(50), rt.rmock_scalar_int(x.shape[1]),
              rt.rmock_scalar_int(0), rt.rmock_scalar_int(-1))
    a1 = np.ctypeslib.as_array(rt.rmock_real_ptr(p1), shape=(50,))
    a2 = np.ctypeslib.as_array(rt.rmock_real_ptr(p2), shape=(50,))
    np.testing.assert_allclose(a1, a2, rtol=1e-9)
    # GC the loaded booster: finalizer fires once, then the cleared
    # extptr makes the second fire a no-op (R can finalize twice)
    assert rt.rmock_run_finalizer(loaded) == 0
    assert rt.rmock_extptr_addr(loaded) is None
    assert rt.rmock_run_finalizer(loaded) == 0


def test_error_path_reports_through_rf_error(rt):
    msg = call_expect_error(
        rt, "LGBMTPU_DatasetCreateFromFile_R",
        rt.rmock_string(b"/nonexistent/file.csv"),
        rt.rmock_string(b""), rt.rmock_nil())
    assert "DatasetCreateFromFile" in msg and "failed" in msg


def test_custom_objective_grad_hess_marshal(rt):
    """UpdateOneIterCustom: R doubles -> float casts + the length
    validation Rf_error."""
    x, y = make_binary(300, 5)
    xf = np.asfortranarray(x, dtype=np.float64)
    mat = _reals(rt, xf.reshape(-1, order="F"))
    ds = call(rt, "LGBMTPU_DatasetCreateFromMat_R", mat,
              rt.rmock_scalar_int(300), rt.rmock_scalar_int(5),
              rt.rmock_string(b""), rt.rmock_nil())
    call(rt, "LGBMTPU_DatasetSetField_R", ds, rt.rmock_string(b"label"),
         _reals(rt, y))
    bst = call(rt, "LGBMTPU_BoosterCreate_R", ds,
               rt.rmock_string(b"objective=none num_leaves=7 verbosity=-1 "
                               b"device_type=cpu"))
    p = np.full(300, 0.5)
    grad, hess = p - y, p * (1 - p)
    call(rt, "LGBMTPU_BoosterUpdateOneIterCustom_R", bst,
         _reals(rt, grad), _reals(rt, hess))
    it = call(rt, "LGBMTPU_BoosterGetCurrentIteration_R", bst)
    assert rt.rmock_int_ptr(it)[0] == 1
    # mismatched lengths must hit the glue's own Rf_error
    msg = call_expect_error(rt, "LGBMTPU_BoosterUpdateOneIterCustom_R",
                            bst, _reals(rt, grad[:100]), _reals(rt, hess))
    assert "same length" in msg
    # dataset finalizer path
    assert rt.rmock_run_finalizer(ds) == 0
    assert rt.rmock_extptr_addr(ds) is None
