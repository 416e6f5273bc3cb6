/* C ABI of lightgbm_tpu_torch — the stable surface external bindings
 * (SWIG/Java, R, ctypes) link against; the same declarations as the JAX
 * package's capi/c_api.h. Role of the reference's
 * include/LightGBM/c_api.h; declarations match csrc/c_api.cpp exactly (the
 * implementation drives the Python engine in-process).
 *
 * Conventions (same as the reference):
 *   - every function except LGBM_GetLastError/LGBM_SetLastError returns
 *     0 on success, nonzero on failure; the message is in
 *     LGBM_GetLastError().
 *   - data_type: 0 = float32, 1 = float64 (C_API_DTYPE_FLOAT32/64)
 *   - predict_type: 0 = normal, 1 = raw score, 2 = leaf index,
 *     3 = SHAP contribs (C_API_PREDICT_*)
 */
#ifndef LIGHTGBM_TPU_C_API_H_
#define LIGHTGBM_TPU_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
#define LGBM_EXTERN_C extern "C"
#else
#define LGBM_EXTERN_C
#endif

#if defined(SWIG)
#define LGBM_API
#elif defined(_MSC_VER)
#define LGBM_API LGBM_EXTERN_C __declspec(dllexport)
#else
#define LGBM_API LGBM_EXTERN_C __attribute__((visibility("default")))
#endif

typedef void* DatasetHandle;
typedef void* BoosterHandle;

#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32 (2)
#define C_API_DTYPE_INT64 (3)

#define C_API_PREDICT_NORMAL (0)
#define C_API_PREDICT_RAW_SCORE (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB (3)

/* ---- error handling ---------------------------------------------------- */
LGBM_API const char* LGBM_GetLastError();
LGBM_API void LGBM_SetLastError(const char* msg);

/* ---- dataset construction ---------------------------------------------- */
LGBM_API int LGBM_DatasetCreateFromFile(const char* filename,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                       int32_t nrow, int32_t ncol,
                                       int is_row_major,
                                       const char* parameters,
                                       const DatasetHandle reference,
                                       DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                                        int data_type, int32_t* nrow,
                                        int32_t ncol, int is_row_major,
                                        const char* parameters,
                                        const DatasetHandle reference,
                                        DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateFromCSR(
    const void* indptr, int indptr_type, const int32_t* indices,
    const void* data, int data_type, int64_t nindptr, int64_t nelem,
    int64_t num_col, const char* parameters, const DatasetHandle reference,
    DatasetHandle* out);
/* get_row_funptr is a std::function<void(int,
 * std::vector<std::pair<int, double>>&)>* — the mmlspark streaming
 * contract (reference c_api.cpp RowFunctionFromCSRFunc). */
LGBM_API int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                           int64_t num_col,
                                           const char* parameters,
                                           const DatasetHandle reference,
                                           DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t ncol_ptr, int64_t nelem,
                                       int64_t num_row,
                                       const char* parameters,
                                       const DatasetHandle reference,
                                       DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int* num_per_col, int32_t num_sample_row, int32_t num_total_row,
    const char* parameters, DatasetHandle* out);
LGBM_API int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                           int64_t num_total_row,
                                           DatasetHandle* out);
LGBM_API int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                                  int data_type, int32_t nrow, int32_t ncol,
                                  int32_t start_row);
LGBM_API int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset,
                                       const void* indptr, int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int64_t start_row);
LGBM_API int LGBM_DatasetGetSubset(const DatasetHandle handle,
                                   const int32_t* used_row_indices,
                                   int32_t num_used_row_indices,
                                   const char* parameters,
                                   DatasetHandle* out);
LGBM_API int LGBM_DatasetFree(DatasetHandle handle);

/* ---- dataset accessors -------------------------------------------------- */
LGBM_API int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out);
LGBM_API int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out);
LGBM_API int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                                  const void* field_data, int num_element,
                                  int type);
LGBM_API int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                                  int* out_len, const void** out_ptr,
                                  int* out_type);
LGBM_API int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                         const char** feature_names,
                                         int num_feature_names);
LGBM_API int LGBM_DatasetGetFeatureNames(DatasetHandle handle,
                                         char** feature_names, int* num);
LGBM_API int LGBM_DatasetAddFeaturesFrom(DatasetHandle target,
                                         DatasetHandle source);
LGBM_API int LGBM_DatasetSaveBinary(DatasetHandle handle,
                                    const char* filename);
LGBM_API int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename);
LGBM_API int LGBM_DatasetUpdateParam(DatasetHandle handle,
                                     const char* parameters);

/* ---- booster lifecycle -------------------------------------------------- */
LGBM_API int LGBM_BoosterCreate(const DatasetHandle train_data,
                                const char* parameters, BoosterHandle* out);
LGBM_API int LGBM_BoosterCreateFromModelfile(const char* filename,
                                             int* out_num_iterations,
                                             BoosterHandle* out);
LGBM_API int LGBM_BoosterLoadModelFromString(const char* model_str,
                                             int* out_num_iterations,
                                             BoosterHandle* out);
LGBM_API int LGBM_BoosterFree(BoosterHandle handle);
LGBM_API int LGBM_BoosterMerge(BoosterHandle handle,
                               BoosterHandle other_handle);
LGBM_API int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
                                       int end_iter);
LGBM_API int LGBM_BoosterAddValidData(BoosterHandle handle,
                                      const DatasetHandle valid_data);
LGBM_API int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                           const DatasetHandle train_data);
LGBM_API int LGBM_BoosterResetParameter(BoosterHandle handle,
                                        const char* parameters);

/* ---- training ----------------------------------------------------------- */
LGBM_API int LGBM_BoosterUpdateOneIter(BoosterHandle handle,
                                       int* is_finished);
LGBM_API int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                             const float* grad,
                                             const float* hess,
                                             int* is_finished);
LGBM_API int LGBM_BoosterRollbackOneIter(BoosterHandle handle);
LGBM_API int LGBM_BoosterRefit(BoosterHandle handle, const int32_t* leaf_preds,
                               int32_t nrow, int32_t ncol);

/* ---- booster accessors -------------------------------------------------- */
LGBM_API int LGBM_BoosterGetCurrentIteration(BoosterHandle handle, int* out);
LGBM_API int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out);
LGBM_API int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
                                              int* out_tree_per_iteration);
LGBM_API int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle,
                                            int* out_models);
LGBM_API int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out);
LGBM_API int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                         char** out_strs);
LGBM_API int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                                      int leaf_idx, double* out_val);
LGBM_API int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                                      int leaf_idx, double val);
LGBM_API int LGBM_BoosterFeatureImportance(BoosterHandle handle,
                                           int num_iteration,
                                           int importance_type,
                                           double* out_results);

/* ---- evaluation --------------------------------------------------------- */
LGBM_API int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);
LGBM_API int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                                      char** out_strs);
LGBM_API int LGBM_BoosterGetEvalHigherBetter(BoosterHandle handle,
                                             int* out_len, int* out_flags);
LGBM_API int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx,
                                 int* out_len, double* out_results);
LGBM_API int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                                       int64_t* out_len);
LGBM_API int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                                    int64_t* out_len, double* out_result);

/* ---- prediction --------------------------------------------------------- */
LGBM_API int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                                        int predict_type, int num_iteration,
                                        int64_t* out_len);
LGBM_API int LGBM_BoosterPredictForFile(BoosterHandle handle,
                                        const char* data_filename,
                                        int data_has_header, int predict_type,
                                        int num_iteration,
                                        const char* parameter,
                                        const char* result_filename);
LGBM_API int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                                       int data_type, int32_t nrow,
                                       int32_t ncol, int is_row_major,
                                       int predict_type, int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result);
LGBM_API int LGBM_BoosterPredictForMatSingleRow(
    BoosterHandle handle, const void* data, int data_type, int ncol,
    int is_row_major, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result);
LGBM_API int LGBM_BoosterPredictForMats(BoosterHandle handle,
                                        const void** data, int data_type,
                                        int32_t nrow, int32_t ncol,
                                        int predict_type, int num_iteration,
                                        const char* parameter,
                                        int64_t* out_len,
                                        double* out_result);
LGBM_API int LGBM_BoosterPredictForCSR(BoosterHandle handle,
                                       const void* indptr, int indptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t nindptr, int64_t nelem,
                                       int64_t num_col, int predict_type,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result);
LGBM_API int LGBM_BoosterPredictForCSRSingleRow(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type, int64_t nindptr,
    int64_t nelem, int64_t num_col, int predict_type, int num_iteration,
    const char* parameter, int64_t* out_len, double* out_result);
LGBM_API int LGBM_BoosterPredictForCSC(BoosterHandle handle,
                                       const void* col_ptr, int col_ptr_type,
                                       const int32_t* indices,
                                       const void* data, int data_type,
                                       int64_t ncol_ptr, int64_t nelem,
                                       int64_t num_row, int predict_type,
                                       int num_iteration,
                                       const char* parameter,
                                       int64_t* out_len, double* out_result);
/* Extension beyond the reference ABI (not in LightGBM): stats of the
 * concurrent single-row predict dispatcher — total requests, vectorized
 * batches executed, and the largest batch. Concurrent SingleRow predict
 * calls coalesce into one vectorized predict per batch (set
 * LGBM_TPU_PREDICT_BATCH=0 to disable and serialize directly). */
LGBM_API int LGBM_TPU_PredictDispatchStats(int64_t* out_reqs,
                                           int64_t* out_batches,
                                           int64_t* out_max_batch);

/* ---- model export ------------------------------------------------------- */
LGBM_API int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                                   int num_iteration, const char* filename);
LGBM_API int LGBM_BoosterSaveModelToString(BoosterHandle handle,
                                           int start_iteration,
                                           int num_iteration,
                                           int64_t buffer_len,
                                           int64_t* out_len, char* out_str);
LGBM_API int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                                   int num_iteration, int64_t buffer_len,
                                   int64_t* out_len, char* out_str);

/* ---- network ------------------------------------------------------------ */
LGBM_API int LGBM_NetworkInit(const char* machines, int local_listen_port,
                              int listen_time_out, int num_machines);
LGBM_API int LGBM_NetworkFree();
LGBM_API int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                           void* reduce_scatter_ext_fun,
                                           void* allgather_ext_fun);

#endif  /* LIGHTGBM_TPU_C_API_H_ */
