// C ABI of lightgbm_tpu_torch: LGBM_*-compatible entry points.
//
// The port's copy of the C shim (the same entry points, GIL handling,
// predict dispatcher and LGBM_TPU_PREDICT_BATCH switch), dispatching to
// lightgbm_tpu_torch.capi_impl (reference: src/c_api.cpp,
// include/LightGBM/c_api.h:40-1018). The engine is the in-process Python /
// PyTorch runtime: each C call acquires the GIL, marshals raw buffers to
// numpy without copies where possible, and calls capi_impl. Loaded inside
// a running Python process (ctypes), it reuses the live interpreter;
// loaded by a host with no interpreter (R, Java), it starts one, which
// needs the library linked against libpython (see the README).
//
// Build: ops/kernels/build.py::capi_library (g++ against Python.h only,
// into lightgbm_tpu_torch/_build/lib_lightgbm_tpu_torch.so; the Python
// symbols resolve when the library is loaded into an interpreter).

#include <Python.h>

#include "c_api.h"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdarg>
#include <condition_variable>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>

#include <pthread.h>
#include <unistd.h>
#include <vector>

// LGBM_API and the handle typedefs come from c_api.h; including the
// header here makes the compiler cross-check every definition against
// the published declaration.

namespace {

std::mutex g_init_mutex;
thread_local std::string g_last_error;
bool g_we_initialized = false;

void SetError(const std::string& msg) { g_last_error = msg; }

class Gil {
 public:
  Gil() {
    {
      std::lock_guard<std::mutex> lk(g_init_mutex);
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        g_we_initialized = true;
      }
    }
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// fetch lightgbm_tpu_torch.capi_impl.<name>
PyObject* ImplFn(const char* name) {
  PyObject* mod = PyImport_ImportModule("lightgbm_tpu_torch.capi_impl");
  if (!mod) return nullptr;
  PyObject* fn = PyObject_GetAttrString(mod, name);
  Py_DECREF(mod);
  return fn;
}

bool CheckPyErr() {
  if (PyErr_Occurred()) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    PyObject* s = value ? PyObject_Str(value) : nullptr;
    SetError(s && PyUnicode_Check(s) ? PyUnicode_AsUTF8(s) : "python error");
    Py_XDECREF(s);
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
    return true;
  }
  return false;
}

// Call impl fn with args tuple; returns new ref or nullptr (error set).
PyObject* Call(const char* name, PyObject* args) {
  PyObject* fn = ImplFn(name);
  if (!fn) {
    CheckPyErr();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* ret = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (!ret) CheckPyErr();
  return ret;
}

int CallVoidV(const char* name, const char* fmt, ...) {
  Gil gil;
  va_list va;
  va_start(va, fmt);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  if (!args) {
    CheckPyErr();
    return -1;
  }
  PyObject* r = Call(name, args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

PyObject* MemView(const void* data, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<void*>(data)), nbytes, PyBUF_READ);
}

PyObject* MemViewW(void* data, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory(reinterpret_cast<char*>(data), nbytes,
                                 PyBUF_WRITE);
}

}  // namespace

LGBM_API const char* LGBM_GetLastError() { return g_last_error.c_str(); }

// The reference ships this as an inline header helper
// (include/LightGBM/c_api.h:1040); exporting it keeps bindings that link
// the symbol (rather than inlining the header) working.
LGBM_API void LGBM_SetLastError(const char* msg) {
  g_last_error = msg ? msg : "";
}

// ---------------------------------------------------------------------------
// Dataset
// ---------------------------------------------------------------------------

LGBM_API int LGBM_DatasetCreateFromFile(const char* filename,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out) {
  Gil gil;
  PyObject* r = Call("dataset_create_from_file",
                     Py_BuildValue("(ssL)", filename, parameters,
                                   (long long)(intptr_t)reference));
  if (!r) return -1;
  *out = reinterpret_cast<DatasetHandle>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  return 0;
}

// data_type: 0 = float32 (C_API_DTYPE_FLOAT32), 1 = float64
LGBM_API int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                       int32_t nrow, int32_t ncol,
                                       int is_row_major,
                                       const char* parameters,
                                       const DatasetHandle reference,
                                       DatasetHandle* out) {
  Gil gil;
  Py_ssize_t itemsize = data_type == 0 ? 4 : 8;
  PyObject* mv = MemView(data, (Py_ssize_t)nrow * ncol * itemsize);
  PyObject* r = Call("dataset_create_from_mat",
                     Py_BuildValue("(NiiiisL)", mv, data_type, nrow, ncol,
                                   is_row_major, parameters,
                                   (long long)(intptr_t)reference));
  if (!r) return -1;
  *out = reinterpret_cast<DatasetHandle>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetCreateFromCSR(
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col, const char* parameters, const DatasetHandle reference,
    DatasetHandle* out) {
  Gil gil;
  Py_ssize_t isz = indptr_type == 2 ? 4 : 8;  // C_API_DTYPE_INT32=2
  Py_ssize_t dsz = data_type == 0 ? 4 : 8;
  PyObject* args = Py_BuildValue(
      "(NiNNiLLLsL)", MemView(indptr, nindptr * isz), indptr_type,
      MemView(indices, nelem * 4), MemView(data, nelem * dsz), data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col, parameters,
      (long long)(intptr_t)reference);
  PyObject* r = Call("dataset_create_from_csr", args);
  if (!r) return -1;
  *out = reinterpret_cast<DatasetHandle>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetFree(DatasetHandle handle) {
  return CallVoidV("dataset_free", "(L)", (long long)(intptr_t)handle);
}

LGBM_API int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out) {
  Gil gil;
  PyObject* r = Call("dataset_get_num_data",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int32_t)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out) {
  Gil gil;
  PyObject* r = Call("dataset_get_num_feature",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int32_t)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

// field_data type: 0=float32, 1=float64, 2=int32
LGBM_API int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                                  const void* field_data, int num_element,
                                  int type) {
  Gil gil;
  Py_ssize_t sz = (type == 2) ? 4 : (type == 0 ? 4 : 8);
  PyObject* args = Py_BuildValue(
      "(LsNii)", (long long)(intptr_t)handle, field_name,
      MemView(field_data, (Py_ssize_t)num_element * sz), num_element, type);
  PyObject* r = Call("dataset_set_field", args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                                  int* out_len, const void** out_ptr,
                                  int* out_type) {
  Gil gil;
  PyObject* r = Call("dataset_get_field",
                     Py_BuildValue("(Ls)", (long long)(intptr_t)handle,
                                   field_name));
  if (!r) return -1;
  // returns (ptr:int, len:int, type:int) — buffers owned by impl cache
  PyObject* p0 = PyTuple_GetItem(r, 0);
  PyObject* p1 = PyTuple_GetItem(r, 1);
  PyObject* p2 = PyTuple_GetItem(r, 2);
  *out_ptr = reinterpret_cast<const void*>(PyLong_AsLongLong(p0));
  *out_len = (int)PyLong_AsLong(p1);
  *out_type = (int)PyLong_AsLong(p2);
  Py_DECREF(r);
  return 0;
}

// ---------------------------------------------------------------------------
// Booster
// ---------------------------------------------------------------------------

LGBM_API int LGBM_BoosterCreate(const DatasetHandle train_data,
                                const char* parameters, BoosterHandle* out) {
  Gil gil;
  PyObject* r = Call("booster_create",
                     Py_BuildValue("(Ls)", (long long)(intptr_t)train_data,
                                   parameters));
  if (!r) return -1;
  *out = reinterpret_cast<BoosterHandle>(PyLong_AsLongLong(r));
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterCreateFromModelfile(const char* filename,
                                             int* out_num_iterations,
                                             BoosterHandle* out) {
  Gil gil;
  PyObject* r = Call("booster_create_from_modelfile",
                     Py_BuildValue("(s)", filename));
  if (!r) return -1;
  *out = reinterpret_cast<BoosterHandle>(
      PyLong_AsLongLong(PyTuple_GetItem(r, 0)));
  *out_num_iterations = (int)PyLong_AsLong(PyTuple_GetItem(r, 1));
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterLoadModelFromString(const char* model_str,
                                             int* out_num_iterations,
                                             BoosterHandle* out) {
  Gil gil;
  PyObject* r = Call("booster_load_from_string",
                     Py_BuildValue("(s)", model_str));
  if (!r) return -1;
  *out = reinterpret_cast<BoosterHandle>(
      PyLong_AsLongLong(PyTuple_GetItem(r, 0)));
  *out_num_iterations = (int)PyLong_AsLong(PyTuple_GetItem(r, 1));
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterFree(BoosterHandle handle) {
  return CallVoidV("booster_free", "(L)", (long long)(intptr_t)handle);
}

LGBM_API int LGBM_BoosterAddValidData(BoosterHandle handle,
                                      const DatasetHandle valid_data) {
  return CallVoidV("booster_add_valid", "(LL)",
                   (long long)(intptr_t)handle,
                   (long long)(intptr_t)valid_data);
}

LGBM_API int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                       int* is_finished) {
  Gil gil;
  PyObject* r = Call("booster_update_one_iter",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *is_finished = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                             const float* grad,
                                             const float* hess,
                                             int* is_finished) {
  Gil gil;
  PyObject* n = Call("booster_num_total_rows",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!n) return -1;
  long long total = PyLong_AsLongLong(n);
  Py_DECREF(n);
  PyObject* args = Py_BuildValue(
      "(LNN)", (long long)(intptr_t)handle,
      MemView(grad, total * 4), MemView(hess, total * 4));
  PyObject* r = Call("booster_update_one_iter_custom", args);
  if (!r) return -1;
  *is_finished = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  return CallVoidV("booster_rollback_one_iter", "(L)",
                   (long long)(intptr_t)handle);
}

LGBM_API int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out) {
  Gil gil;
  PyObject* r = Call("booster_current_iteration",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out) {
  Gil gil;
  PyObject* r = Call("booster_num_classes",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out) {
  Gil gil;
  PyObject* r = Call("booster_eval_counts",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                 int* out_len, double* out_results) {
  Gil gil;
  PyObject* r = Call("booster_get_eval",
                     Py_BuildValue("(Li)", (long long)(intptr_t)handle,
                                   data_idx));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    out_results[i] = PyFloat_AsDouble(PyList_GetItem(r, i));
  }
  *out_len = (int)n;
  Py_DECREF(r);
  return 0;
}

// out_strs: caller-allocated array of char buffers (reference sizes them at
// 128 bytes each, c_api.cpp GetEvalNames)
LGBM_API int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                                      char** out_strs) {
  Gil gil;
  PyObject* r = Call("booster_eval_names",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    std::snprintf(out_strs[i], 128, "%s", s ? s : "");
  }
  *out_len = (int)n;
  Py_DECREF(r);
  return 0;
}

// Extension beyond the reference surface: per-eval-slot direction flags so
// thin bindings (R) can early-stop correctly on auc/ndcg/map.
LGBM_API int LGBM_BoosterGetEvalHigherBetter(BoosterHandle handle,
                                             int* out_len, int* out_flags) {
  Gil gil;
  PyObject* r = Call("booster_eval_higher_better",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    out_flags[i] = (int)PyLong_AsLong(PyList_GetItem(r, i));
  }
  *out_len = (int)n;
  Py_DECREF(r);
  return 0;
}

// predict_type: 0=normal, 1=raw, 2=leaf index, 3=contrib (reference
// C_API_PREDICT_* in c_api.h)
LGBM_API int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                                       int data_type, int32_t nrow,
                                       int32_t ncol, int is_row_major,
                                       int predict_type, int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result) {
  Gil gil;
  Py_ssize_t itemsize = data_type == 0 ? 4 : 8;
  PyObject* args = Py_BuildValue(
      "(LNiiiiiis)", (long long)(intptr_t)handle,
      MemView(data, (Py_ssize_t)nrow * ncol * itemsize), data_type, nrow,
      ncol, is_row_major, predict_type, num_iteration, parameter);
  PyObject* r = Call("booster_predict_for_mat", args);
  if (!r) return -1;
  // r = bytes of float64 results
  char* buf;
  Py_ssize_t nbytes;
  if (PyBytes_AsStringAndSize(r, &buf, &nbytes) != 0) {
    Py_DECREF(r);
    CheckPyErr();
    return -1;
  }
  std::memcpy(out_result, buf, nbytes);
  *out_len = nbytes / 8;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                                   int num_iteration, const char* filename) {
  return CallVoidV("booster_save_model", "(Liis)",
                   (long long)(intptr_t)handle, start_iteration,
                   num_iteration, filename);
}

LGBM_API int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                           int start_iteration,
                                           int num_iteration,
                                           int64_t buffer_len,
                                           int64_t* out_len, char* out_str) {
  Gil gil;
  PyObject* r = Call("booster_save_model_to_string",
                     Py_BuildValue("(Lii)", (long long)(intptr_t)handle,
                                   start_iteration, num_iteration));
  if (!r) return -1;
  Py_ssize_t n;
  const char* s = PyUnicode_AsUTF8AndSize(r, &n);
  *out_len = n + 1;
  if (buffer_len >= n + 1) {
    std::memcpy(out_str, s, n + 1);
  }
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterFeatureImportance(BoosterHandle handle,
                                           int num_iteration,
                                           int importance_type,
                                           double* out_results) {
  Gil gil;
  PyObject* r = Call("booster_feature_importance",
                     Py_BuildValue("(Lii)", (long long)(intptr_t)handle,
                                   num_iteration, importance_type));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    out_results[i] = PyFloat_AsDouble(PyList_GetItem(r, i));
  }
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out) {
  Gil gil;
  PyObject* r = Call("booster_num_feature",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

namespace {

// Copy a Python bytes result (float64 array) into out_result/out_len.
int BytesToDoubles(PyObject* r, int64_t* out_len, double* out_result) {
  if (!r) return -1;
  char* buf;
  Py_ssize_t nbytes;
  if (PyBytes_AsStringAndSize(r, &buf, &nbytes) != 0) {
    Py_DECREF(r);
    CheckPyErr();
    return -1;
  }
  std::memcpy(out_result, buf, nbytes);
  *out_len = nbytes / 8;
  Py_DECREF(r);
  return 0;
}

Py_ssize_t DtypeSize(int t) { return (t == 0 || t == 2) ? 4 : 8; }

}  // namespace

// ---------------------------------------------------------------------------
// Extended dataset constructors (reference: c_api.h:62-380)
// ---------------------------------------------------------------------------

LGBM_API int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t ncol_ptr, int64_t nelem,
                                       int64_t num_row,
                                       const char* parameters,
                                       const DatasetHandle reference,
                                       DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(NiNNiLLLsL)", MemView(col_ptr, ncol_ptr * DtypeSize(col_ptr_type)),
      col_ptr_type, MemView(indices, nelem * 4),
      MemView(data, nelem * DtypeSize(data_type)), data_type,
      (long long)ncol_ptr, (long long)nelem, (long long)num_row,
      parameters ? parameters : "", (long long)(intptr_t)reference);
  PyObject* r = Call("dataset_create_from_csc", args);
  if (!r) return -1;
  *out = (DatasetHandle)(intptr_t)PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                                        int data_type, int32_t* nrow,
                                        int32_t ncol, int is_row_major,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out) {
  Gil gil;
  PyObject* mats = PyList_New(nmat);
  PyObject* rows = PyList_New(nmat);
  for (int32_t i = 0; i < nmat; ++i) {
    PyList_SetItem(mats, i, MemView(data[i], (Py_ssize_t)nrow[i] * ncol *
                                                 DtypeSize(data_type)));
    PyList_SetItem(rows, i, PyLong_FromLong(nrow[i]));
  }
  PyObject* args = Py_BuildValue("(NiNiisL)", mats, data_type, rows, ncol,
                                 is_row_major, parameters ? parameters : "",
                                 (long long)(intptr_t)reference);
  PyObject* r = Call("dataset_create_from_mats", args);
  if (!r) return -1;
  *out = (DatasetHandle)(intptr_t)PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

// The funptr is a std::function<void(int, std::vector<std::pair<int,double>>&)>*
// (reference c_api.cpp RowFunctionFromCSRFunc usage) — call it row by row to
// densify, then construct normally.
LGBM_API int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                           int64_t num_col,
                                           const char* parameters,
                                           const DatasetHandle reference,
                                           DatasetHandle* out) {
  using RowFn =
      std::function<void(int, std::vector<std::pair<int, double>>&)>;
  auto* fn = reinterpret_cast<RowFn*>(get_row_funptr);
  std::vector<double> dense((size_t)num_rows * num_col, 0.0);
  std::vector<std::pair<int, double>> row;
  for (int i = 0; i < num_rows; ++i) {
    row.clear();
    (*fn)(i, row);
    for (auto& kv : row) {
      if (kv.first >= 0 && kv.first < num_col)
        dense[(size_t)i * num_col + kv.first] = kv.second;
    }
  }
  return LGBM_DatasetCreateFromMat(dense.data(), /*data_type=*/1, num_rows,
                                   (int32_t)num_col, /*is_row_major=*/1,
                                   parameters, reference, out);
}

LGBM_API int LGBM_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int* num_per_col, int32_t num_sample_row, int32_t num_total_row,
    const char* parameters, DatasetHandle* out) {
  (void)sample_data;
  (void)sample_indices;
  (void)num_per_col;
  (void)num_sample_row;
  Gil gil;
  // bin mappers are fit lazily from the full pushed data (superset of the
  // reference's sample-based FindBin)
  PyObject* r = Call("dataset_create_from_sampled_column",
                     Py_BuildValue("(iis)", num_total_row, ncol,
                                   parameters ? parameters : ""));
  if (!r) return -1;
  *out = (DatasetHandle)(intptr_t)PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                           int64_t num_total_row,
                                           DatasetHandle* out) {
  Gil gil;
  PyObject* r = Call("dataset_create_by_reference",
                     Py_BuildValue("(LL)", (long long)(intptr_t)reference,
                                   (long long)num_total_row));
  if (!r) return -1;
  *out = (DatasetHandle)(intptr_t)PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                                  int data_type, int32_t nrow, int32_t ncol,
                                  int32_t start_row) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiiii)", (long long)(intptr_t)dataset,
      MemView(data, (Py_ssize_t)nrow * ncol * DtypeSize(data_type)),
      data_type, nrow, ncol, start_row);
  PyObject* r = Call("dataset_push_rows", args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset,
                                       const void* indptr, int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int64_t start_row) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLi)", (long long)(intptr_t)dataset,
      MemView(indptr, nindptr * DtypeSize(indptr_type)), indptr_type,
      MemView(indices, nelem * 4),
      MemView(data, nelem * DtypeSize(data_type)), data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col,
      (int)start_row);
  PyObject* r = Call("dataset_push_rows_by_csr", args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                   const int32_t* used_row_indices,
                                   int32_t num_used_row_indices,
                                   const char* parameters,
                                   DatasetHandle* out) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNis)", (long long)(intptr_t)handle,
      MemView(used_row_indices, (Py_ssize_t)num_used_row_indices * 4),
      num_used_row_indices, parameters ? parameters : "");
  PyObject* r = Call("dataset_get_subset", args);
  if (!r) return -1;
  *out = (DatasetHandle)(intptr_t)PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                    const char* filename) {
  return CallVoidV("dataset_save_binary", "(Ls)",
                   (long long)(intptr_t)handle, filename);
}

LGBM_API int LGBM_DatasetDumpText(DatasetHandle handle,
                                  const char* filename) {
  return CallVoidV("dataset_dump_text", "(Ls)", (long long)(intptr_t)handle,
                   filename);
}

LGBM_API int LGBM_DatasetUpdateParam(DatasetHandle handle,
                                     const char* parameters) {
  return CallVoidV("dataset_update_param", "(Ls)",
                   (long long)(intptr_t)handle, parameters ? parameters : "");
}

LGBM_API int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                         const char** feature_names,
                                         int num_feature_names) {
  Gil gil;
  PyObject* names = PyList_New(num_feature_names);
  for (int i = 0; i < num_feature_names; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(feature_names[i]));
  }
  PyObject* r = Call("dataset_set_feature_names",
                     Py_BuildValue("(LN)", (long long)(intptr_t)handle,
                                   names));
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                         char** feature_names, int* num) {
  Gil gil;
  PyObject* r = Call("dataset_get_feature_names",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    std::snprintf(feature_names[i], 128, "%s", s ? s : "");
  }
  *num = (int)n;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_DatasetAddFeaturesFrom(DatasetHandle target,
                                         DatasetHandle source) {
  return CallVoidV("dataset_add_features_from", "(LL)",
                   (long long)(intptr_t)target, (long long)(intptr_t)source);
}

// ---------------------------------------------------------------------------
// Extended booster entry points (reference: c_api.h:427-1018)
// ---------------------------------------------------------------------------

LGBM_API int LGBM_BoosterMerge(BoosterHandle handle,
                               BoosterHandle other_handle) {
  return CallVoidV("booster_merge", "(LL)", (long long)(intptr_t)handle,
                   (long long)(intptr_t)other_handle);
}

LGBM_API int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
                                       int end_iter) {
  return CallVoidV("booster_shuffle_models", "(Lii)",
                   (long long)(intptr_t)handle, start_iter, end_iter);
}

LGBM_API int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                           const DatasetHandle train_data) {
  return CallVoidV("booster_reset_training_data", "(LL)",
                   (long long)(intptr_t)handle,
                   (long long)(intptr_t)train_data);
}

LGBM_API int LGBM_BoosterResetParameter(BoosterHandle handle,
                                        const char* parameters) {
  return CallVoidV("booster_reset_parameter", "(Ls)",
                   (long long)(intptr_t)handle, parameters ? parameters : "");
}

LGBM_API int LGBM_BoosterRefit(BoosterHandle handle, const int32_t* leaf_preds,
                               int32_t nrow, int32_t ncol) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNii)", (long long)(intptr_t)handle,
      MemView(leaf_preds, (Py_ssize_t)nrow * ncol * 4), nrow, ncol);
  PyObject* r = Call("booster_refit", args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
                                              int* out_tree_per_iteration) {
  Gil gil;
  PyObject* r = Call("booster_num_model_per_iteration",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out_tree_per_iteration = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle,
                                            int* out_models) {
  Gil gil;
  PyObject* r = Call("booster_number_of_total_model",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  *out_models = (int)PyLong_AsLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                         char** out_strs) {
  Gil gil;
  PyObject* r = Call("booster_get_feature_names",
                     Py_BuildValue("(L)", (long long)(intptr_t)handle));
  if (!r) return -1;
  Py_ssize_t n = PyList_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    std::snprintf(out_strs[i], 128, "%s", s ? s : "");
  }
  *out_len = (int)n;
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                      int leaf_idx, double* out_val) {
  Gil gil;
  PyObject* r = Call("booster_get_leaf_value",
                     Py_BuildValue("(Lii)", (long long)(intptr_t)handle,
                                   tree_idx, leaf_idx));
  if (!r) return -1;
  *out_val = PyFloat_AsDouble(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                      int leaf_idx, double val) {
  return CallVoidV("booster_set_leaf_value", "(Liid)",
                   (long long)(intptr_t)handle, tree_idx, leaf_idx, val);
}

LGBM_API int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                                       int64_t* out_len) {
  Gil gil;
  PyObject* r = Call("booster_get_num_predict",
                     Py_BuildValue("(Li)", (long long)(intptr_t)handle,
                                   data_idx));
  if (!r) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                    int64_t* out_len, double* out_result) {
  Gil gil;
  PyObject* r = Call("booster_get_predict",
                     Py_BuildValue("(Li)", (long long)(intptr_t)handle,
                                   data_idx));
  return BytesToDoubles(r, out_len, out_result);
}

LGBM_API int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                                        int predict_type, int num_iteration,
                                        int64_t* out_len) {
  Gil gil;
  PyObject* r = Call("booster_calc_num_predict",
                     Py_BuildValue("(Liii)", (long long)(intptr_t)handle,
                                   num_row, predict_type, num_iteration));
  if (!r) return -1;
  *out_len = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return 0;
}

LGBM_API int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                        const char* data_filename,
                                        int data_has_header, int predict_type,
                                        int num_iteration,
                                        const char* parameter,
                                        const char* result_filename) {
  return CallVoidV("booster_predict_for_file", "(Lsiiiss)",
                   (long long)(intptr_t)handle, data_filename,
                   data_has_header, predict_type, num_iteration,
                   parameter ? parameter : "", result_filename);
}

LGBM_API int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                                       const void* indptr, int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int predict_type,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLiis)", (long long)(intptr_t)handle,
      MemView(indptr, nindptr * DtypeSize(indptr_type)), indptr_type,
      MemView(indices, nelem * 4),
      MemView(data, nelem * DtypeSize(data_type)), data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col, predict_type,
      num_iteration, parameter ? parameter : "");
  return BytesToDoubles(Call("booster_predict_for_csr", args), out_len,
                        out_result);
}

namespace {

// ---------------------------------------------------------------------------
// Concurrent single-row prediction dispatcher.
//
// The reference serializes booster *mutation* only and lets concurrent
// readers run OMP-parallel (reference: src/c_api.cpp:98 — the lock scope
// around Boosting ends before Predict). Here the engine is the embedded
// Python/PyTorch runtime: every call into it must hold the GIL, so naive
// concurrent single-row predicts from host threads (Java/Spark scoring,
// R parallel predict) would serialize on the interpreter, one full
// interpreter round-trip per row. Instead of queueing callers on the
// GIL, single-row predicts enqueue GIL-free into this dispatcher; a
// worker thread coalesces every waiting request with an identical
// (booster, dtype, ncol, predict params) signature into ONE vectorized
// k-row predict and scatters the per-row results back. Concurrency
// becomes batching: k threads pay ~one interpreter round-trip instead
// of k, so aggregate throughput *rises* with caller concurrency.
// Disable with LGBM_TPU_PREDICT_BATCH=0 (falls back to the direct,
// GIL-serialized path).
struct PredictReq {
  intptr_t handle = 0;
  std::vector<char> row;  // one densified row in the staging dtype
  int data_type = 1;      // 0 = float32, 1 = float64
  int ncol = 0;
  int predict_type = 0;
  int num_iteration = -1;
  std::string param;
  double* out = nullptr;
  int64_t* out_len = nullptr;
  int rc = 0;
  bool done = false;
  std::string err;
};

class PredictDispatcher {
 public:
  static PredictDispatcher& Get() {
    static PredictDispatcher* d = [] {
      auto* p = new PredictDispatcher();  // leaked on purpose: outlives
      // any caller; worker thread is detached.
      // fork() while the worker (or a Submit) holds mu_ would leave the
      // child's mutex locked by a thread that no longer exists; the
      // classic atfork protocol serializes fork against the lock and
      // rebuilds child state from scratch.
      instance_ = p;
      pthread_atfork(
          [] { instance_->mu_.lock(); },
          [] { instance_->mu_.unlock(); },
          [] {
            new (&instance_->mu_) std::mutex();
            new (&instance_->cv_work_) std::condition_variable();
            new (&instance_->cv_done_) std::condition_variable();
            instance_->queue_.clear();
            instance_->worker_started_ = false;
          });
      return p;
    }();
    return *d;
  }

  int Submit(PredictReq* req) {
    std::unique_lock<std::mutex> lk(mu_);
    // fork() kills the (detached) worker thread but not the latched
    // flag: a child inheriting worker_started_=true would enqueue and
    // wait forever. Re-spawn per-pid; inherited queue entries are the
    // parent's stack pointers, dead in this process — drop them.
    if (worker_started_ && worker_pid_ != getpid()) {
      worker_started_ = false;
      queue_.clear();
    }
    if (!worker_started_) {
      worker_started_ = true;
      worker_pid_ = getpid();
      std::thread([this] { Run(); }).detach();
    }
    queue_.push_back(req);
    cv_work_.notify_one();
    cv_done_.wait(lk, [req] { return req->done; });
    n_reqs_ += 1;
    // the worker's error lands in ITS thread-local g_last_error; copy it
    // into the caller's so LGBM_GetLastError works from this thread
    if (req->rc != 0 && !req->err.empty()) SetError(req->err);
    return req->rc;
  }

  void Stats(int64_t* reqs, int64_t* batches, int64_t* max_batch) {
    std::lock_guard<std::mutex> lk(mu_);
    *reqs = n_reqs_;
    *batches = n_batches_;
    *max_batch = max_batch_;
  }

 private:
  static bool SameBatch(const PredictReq* a, const PredictReq* b) {
    return a->handle == b->handle && a->data_type == b->data_type &&
           a->ncol == b->ncol && a->predict_type == b->predict_type &&
           a->num_iteration == b->num_iteration && a->param == b->param;
  }

  void Run() {
    for (;;) {
      std::vector<PredictReq*> batch;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this] { return !queue_.empty(); });
        // take the front request plus every queued request it can batch
        // with; the rest keep their order (no starvation: the next
        // round starts from the first unmatched request)
        PredictReq* front = queue_.front();
        std::deque<PredictReq*> rest;
        for (PredictReq* r : queue_) {
          (SameBatch(front, r) ? (void)batch.push_back(r)
                               : (void)rest.push_back(r));
        }
        queue_.swap(rest);
        n_batches_ += 1;
        if (static_cast<int64_t>(batch.size()) > max_batch_)
          max_batch_ = static_cast<int64_t>(batch.size());
      }
      ExecBatch(batch);
      {
        std::lock_guard<std::mutex> lk(mu_);
        for (PredictReq* r : batch) r->done = true;
      }
      cv_done_.notify_all();
    }
  }

  void ExecBatch(std::vector<PredictReq*>& batch) {
    if (ExecGroup(batch) || batch.size() == 1) return;
    // a failing vectorized call must not fate-share: one request's
    // error (or a transient failure only the k-row shape triggers)
    // would otherwise poison every coalesced neighbor. Retry each
    // request singly so exactly the guilty ones fail, like the
    // serialized direct path.
    for (PredictReq* q : batch) {
      std::vector<PredictReq*> one{q};
      q->rc = 0;
      q->err.clear();
      ExecGroup(one);
    }
  }

  // Returns true on success; on failure marks every request in the
  // group failed with the worker-thread error text.
  bool ExecGroup(std::vector<PredictReq*>& batch) {
    PredictReq* f = batch.front();
    const size_t rowb = static_cast<size_t>(f->ncol) * DtypeSize(f->data_type);
    std::vector<char> dense(batch.size() * rowb);
    for (size_t i = 0; i < batch.size(); ++i)
      std::memcpy(dense.data() + i * rowb, batch[i]->row.data(), rowb);
    Gil gil;
    PyObject* args = Py_BuildValue(
        "(LNiiiiiis)", (long long)f->handle,
        MemView(dense.data(), static_cast<Py_ssize_t>(dense.size())),
        f->data_type, static_cast<int>(batch.size()), f->ncol,
        /*is_row_major=*/1, f->predict_type, f->num_iteration,
        f->param.c_str());
    PyObject* r = Call("booster_predict_for_mat", args);
    char* buf = nullptr;
    Py_ssize_t nbytes = 0;
    if (r && PyBytes_AsStringAndSize(r, &buf, &nbytes) != 0) {
      CheckPyErr();
      Py_DECREF(r);
      r = nullptr;
    }
    if (!r) {
      for (PredictReq* q : batch) {
        q->rc = -1;
        q->err = g_last_error;  // worker TLS; Submit republishes it
      }
      return false;
    }
    // every row yields the same number of doubles (same model + params)
    const int64_t per = nbytes / 8 / static_cast<int64_t>(batch.size());
    for (size_t i = 0; i < batch.size(); ++i) {
      std::memcpy(batch[i]->out, buf + i * per * 8,
                  static_cast<size_t>(per) * 8);
      *batch[i]->out_len = per;
    }
    Py_DECREF(r);
    return true;
  }

  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::deque<PredictReq*> queue_;
  bool worker_started_ = false;
  pid_t worker_pid_ = -1;
  int64_t n_reqs_ = 0, n_batches_ = 0, max_batch_ = 0;
  static PredictDispatcher* instance_;
};

PredictDispatcher* PredictDispatcher::instance_ = nullptr;

bool DispatchEnabled() {
  static const int enabled = [] {
    const char* e = std::getenv("LGBM_TPU_PREDICT_BATCH");
    return (e && std::string(e) == "0") ? 0 : 1;
  }();
  if (!enabled) return false;
  // A caller that already holds the GIL (embedded host on its main
  // thread, ctypes.PyDLL) would deadlock the dispatcher: it parks on
  // cv_done_ holding the GIL the worker needs. The direct path's
  // PyGILState_Ensure is re-entrant — send GIL holders there.
  if (Py_IsInitialized() && PyGILState_Check()) return false;
  return true;
}

}  // namespace

// Extension beyond the reference ABI: dispatcher observability, so tests
// (and operators) can assert concurrent predicts really batched instead
// of serializing one-by-one.
LGBM_API int LGBM_TPU_PredictDispatchStats(int64_t* out_reqs,
                                           int64_t* out_batches,
                                           int64_t* out_max_batch) {
  PredictDispatcher::Get().Stats(out_reqs, out_batches, out_max_batch);
  return 0;
}

LGBM_API int LGBM_BoosterPredictForCSRSingleRow(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t nindptr,
    int64_t nelem, int64_t num_col, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result) {
  // densify-to-zeros is exactly the CSR semantic (missing entries are
  // 0.0, capi_impl._csr_view -> toarray; duplicate indices SUM, as
  // scipy's does), so a single CSR row can ride the batching dispatcher
  // as a dense float64 row. Very wide rows (> 1M cols = 8 MB staging
  // each) and malformed input (index out of range, indptr outside
  // [0, nelem]) keep the direct sparse path — the latter so the error
  // surfaces loudly there instead of being silently dropped here.
  bool csr_ok = nindptr == 2 && num_col > 0 &&
                num_col <= (int64_t(1) << 20);
  const int64_t lo = !csr_ok ? 0
                     : indptr_type == 2
                         ? static_cast<const int32_t*>(indptr)[0]
                         : static_cast<const int64_t*>(indptr)[0];
  const int64_t hi = !csr_ok ? 0
                     : indptr_type == 2
                         ? static_cast<const int32_t*>(indptr)[1]
                         : static_cast<const int64_t*>(indptr)[1];
  if (csr_ok && (lo < 0 || hi < lo || hi > nelem)) csr_ok = false;
  for (int64_t e = lo; csr_ok && e < hi; ++e) {
    if (indices[e] < 0 || indices[e] >= num_col) csr_ok = false;
  }
  if (DispatchEnabled() && csr_ok) {
    PredictReq req;
    req.handle = reinterpret_cast<intptr_t>(handle);
    req.row.assign(static_cast<size_t>(num_col) * 8, 0);
    double* drow = reinterpret_cast<double*>(req.row.data());
    for (int64_t e = lo; e < hi; ++e) {
      drow[indices[e]] +=
          data_type == 0
              ? static_cast<double>(static_cast<const float*>(data)[e])
              : static_cast<const double*>(data)[e];
    }
    req.data_type = 1;
    req.ncol = static_cast<int>(num_col);
    req.predict_type = predict_type;
    req.num_iteration = num_iteration;
    req.param = parameter ? parameter : "";
    req.out = out_result;
    req.out_len = out_len;
    return PredictDispatcher::Get().Submit(&req);
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLiis)", (long long)(intptr_t)handle,
      MemView(indptr, nindptr * DtypeSize(indptr_type)), indptr_type,
      MemView(indices, nelem * 4),
      MemView(data, nelem * DtypeSize(data_type)), data_type,
      (long long)nindptr, (long long)nelem, (long long)num_col, predict_type,
      num_iteration, parameter ? parameter : "");
  return BytesToDoubles(Call("booster_predict_for_csr_single_row", args),
                        out_len, out_result);
}

LGBM_API int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                                       const void* col_ptr, int col_ptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t ncol_ptr, int64_t nelem,
                                       int64_t num_row, int predict_type,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result) {
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiNNiLLLiis)", (long long)(intptr_t)handle,
      MemView(col_ptr, ncol_ptr * DtypeSize(col_ptr_type)), col_ptr_type,
      MemView(indices, nelem * 4),
      MemView(data, nelem * DtypeSize(data_type)), data_type,
      (long long)ncol_ptr, (long long)nelem, (long long)num_row, predict_type,
      num_iteration, parameter ? parameter : "");
  return BytesToDoubles(Call("booster_predict_for_csc", args), out_len,
                        out_result);
}

LGBM_API int LGBM_BoosterPredictForMatSingleRow(
    BoosterHandle handle, const void* data, int data_type, int ncol,
    int is_row_major, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result) {
  (void)is_row_major;  // a single row has one layout
  if (DispatchEnabled() && ncol > 0) {
    PredictReq req;
    req.handle = reinterpret_cast<intptr_t>(handle);
    const char* p = static_cast<const char*>(data);
    req.row.assign(p, p + static_cast<size_t>(ncol) * DtypeSize(data_type));
    req.data_type = data_type;
    req.ncol = ncol;
    req.predict_type = predict_type;
    req.num_iteration = num_iteration;
    req.param = parameter ? parameter : "";
    req.out = out_result;
    req.out_len = out_len;
    return PredictDispatcher::Get().Submit(&req);
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiiiiis)", (long long)(intptr_t)handle,
      MemView(data, (Py_ssize_t)ncol * DtypeSize(data_type)), data_type,
      ncol, is_row_major, predict_type, num_iteration,
      parameter ? parameter : "");
  return BytesToDoubles(Call("booster_predict_for_mat_single_row", args),
                        out_len, out_result);
}

LGBM_API int LGBM_BoosterPredictForMats(BoosterHandle handle,
                                        const void** data, int data_type,
                                        int32_t nrow, int32_t ncol,
                                        int predict_type, int num_iteration,
                                        const char* parameter,
                                        int64_t* out_len,
                                        double* out_result) {
  // array of nrow row-pointers -> one contiguous buffer
  Py_ssize_t isz = DtypeSize(data_type);
  std::vector<char> dense((size_t)nrow * ncol * isz);
  for (int32_t i = 0; i < nrow; ++i) {
    std::memcpy(dense.data() + (size_t)i * ncol * isz, data[i],
                (size_t)ncol * isz);
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(LNiiiiiis)", (long long)(intptr_t)handle,
      MemView(dense.data(), (Py_ssize_t)nrow * ncol * isz), data_type, nrow,
      ncol, /*is_row_major=*/1, predict_type, num_iteration,
      parameter ? parameter : "");
  PyObject* r = Call("booster_predict_for_mat", args);
  return BytesToDoubles(r, out_len, out_result);
}

LGBM_API int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                                   int num_iteration, int64_t buffer_len,
                                   int64_t* out_len, char* out_str) {
  Gil gil;
  PyObject* r = Call("booster_dump_model",
                     Py_BuildValue("(Lii)", (long long)(intptr_t)handle,
                                   start_iteration, num_iteration));
  if (!r) return -1;
  Py_ssize_t n;
  const char* s = PyUnicode_AsUTF8AndSize(r, &n);
  *out_len = n + 1;
  if (buffer_len >= n + 1) {
    std::memcpy(out_str, s, n + 1);
  }
  Py_DECREF(r);
  return 0;
}

// ---------------------------------------------------------------------------
// Network
// ---------------------------------------------------------------------------

LGBM_API int LGBM_NetworkInit(const char* machines, int local_listen_port,
                              int listen_time_out, int num_machines) {
  return CallVoidV("network_init", "(siii)", machines, local_listen_port,
                   listen_time_out, num_machines);
}

// The injected host collectives are not used (collectives run on
// torch.distributed);
// identity is recorded (see capi_impl.network_init_with_functions)
LGBM_API int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                           void* reduce_scatter_ext_fun,
                                           void* allgather_ext_fun) {
  (void)reduce_scatter_ext_fun;
  (void)allgather_ext_fun;
  return CallVoidV("network_init_with_functions", "(ii)", num_machines, rank);
}

LGBM_API int LGBM_NetworkFree() {
  return CallVoidV("network_free", "()");
}
