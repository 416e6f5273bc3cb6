/* ----------------------------------------------------------------------------
 * This file was automatically generated by SWIG (https://www.swig.org).
 * Version 4.4.1
 *
 * Do not make changes to this file unless you know what you are doing - modify
 * the SWIG interface file instead.
 * ----------------------------------------------------------------------------- */


#define SWIG_VERSION 0x040401
#define SWIGJAVA

/* -----------------------------------------------------------------------------
 *  This section contains generic SWIG labels for method/variable
 *  declarations/attributes, and other compiler dependent labels.
 * ----------------------------------------------------------------------------- */

/* template workaround for compilers that cannot correctly implement the C++ standard */
#ifndef SWIGTEMPLATEDISAMBIGUATOR
# if defined(__SUNPRO_CC) && (__SUNPRO_CC <= 0x560)
#  define SWIGTEMPLATEDISAMBIGUATOR template
# elif defined(__HP_aCC)
/* Needed even with `aCC -AA' when `aCC -V' reports HP ANSI C++ B3910B A.03.55 */
/* If we find a maximum version that requires this, the test would be __HP_aCC <= 35500 for A.03.55 */
#  define SWIGTEMPLATEDISAMBIGUATOR template
# else
#  define SWIGTEMPLATEDISAMBIGUATOR
# endif
#endif

/* inline attribute */
#ifndef SWIGINLINE
# if defined(__cplusplus) || (defined(__GNUC__) && !defined(__STRICT_ANSI__))
#   define SWIGINLINE inline
# else
#   define SWIGINLINE
# endif
#endif

/* attribute recognised by some compilers to avoid 'unused' warnings */
#ifndef SWIGUNUSED
# if defined(__GNUC__)
#   if !(defined(__cplusplus)) || (__GNUC__ > 3 || (__GNUC__ == 3 && __GNUC_MINOR__ >= 4))
#     define SWIGUNUSED __attribute__ ((__unused__))
#   else
#     define SWIGUNUSED
#   endif
# elif defined(__ICC)
#   define SWIGUNUSED __attribute__ ((__unused__))
# else
#   define SWIGUNUSED
# endif
#endif

#ifndef SWIG_MSC_UNSUPPRESS_4505
# if defined(_MSC_VER)
#   pragma warning(disable : 4505) /* unreferenced local function has been removed */
# endif
#endif

#ifndef SWIGUNUSEDPARM
# ifdef __cplusplus
#   define SWIGUNUSEDPARM(p)
# else
#   define SWIGUNUSEDPARM(p) p SWIGUNUSED
# endif
#endif

/* internal SWIG method */
#ifndef SWIGINTERN
# define SWIGINTERN static SWIGUNUSED
#endif

/* internal inline SWIG method */
#ifndef SWIGINTERNINLINE
# define SWIGINTERNINLINE SWIGINTERN SWIGINLINE
#endif

/* exporting methods */
#if defined(__GNUC__)
#  if (__GNUC__ >= 4) || (__GNUC__ == 3 && __GNUC_MINOR__ >= 4)
#    ifndef GCC_HASCLASSVISIBILITY
#      define GCC_HASCLASSVISIBILITY
#    endif
#  endif
#endif

#ifndef SWIGEXPORT
# if defined(_WIN32) || defined(__WIN32__) || defined(__CYGWIN__)
#   if defined(STATIC_LINKED)
#     define SWIGEXPORT
#   else
#     define SWIGEXPORT __declspec(dllexport)
#   endif
# else
#   if defined(__GNUC__) && defined(GCC_HASCLASSVISIBILITY)
#     define SWIGEXPORT __attribute__ ((visibility("default")))
#   else
#     define SWIGEXPORT
#   endif
# endif
#endif

/* calling conventions for Windows */
#ifndef SWIGSTDCALL
# if defined(_WIN32) || defined(__WIN32__) || defined(__CYGWIN__)
#   define SWIGSTDCALL __stdcall
# else
#   define SWIGSTDCALL
# endif
#endif

/* Deal with Microsoft's attempt at deprecating C standard runtime functions */
#if !defined(SWIG_NO_CRT_SECURE_NO_DEPRECATE) && defined(_MSC_VER) && !defined(_CRT_SECURE_NO_DEPRECATE)
# define _CRT_SECURE_NO_DEPRECATE
#endif

/* Deal with Microsoft's attempt at deprecating methods in the standard C++ library */
#if !defined(SWIG_NO_SCL_SECURE_NO_DEPRECATE) && defined(_MSC_VER) && !defined(_SCL_SECURE_NO_DEPRECATE)
# define _SCL_SECURE_NO_DEPRECATE
#endif

/* Deal with Apple's deprecated 'AssertMacros.h' from Carbon-framework */
#if defined(__APPLE__) && !defined(__ASSERT_MACROS_DEFINE_VERSIONS_WITHOUT_UNDERSCORES)
# define __ASSERT_MACROS_DEFINE_VERSIONS_WITHOUT_UNDERSCORES 0
#endif

/* Intel's compiler complains if a variable which was never initialised is
 * cast to void, which is a common idiom which we use to indicate that we
 * are aware a variable isn't used.  So we just silence that warning.
 * See: https://github.com/swig/swig/issues/192 for more discussion.
 */
#ifdef __INTEL_COMPILER
# pragma warning disable 592
#endif

#if defined(__cplusplus) && __cplusplus >=201103L
# define SWIG_NOEXCEPT noexcept
#else
# define SWIG_NOEXCEPT throw()
#endif 

/* -----------------------------------------------------------------------------
 * swigcompat.swg
 *
 * Macros to provide support compatibility with older C and C++ standards.
 *
 * Note that SWIG expects __cplusplus to be defined to the appropriate C++ standard.
 * MSVC users are urged to check and examine the /Zc:__cplusplus compiler option.
 * See https://learn.microsoft.com/en-us/cpp/build/reference/zc-cplusplus.
 * ----------------------------------------------------------------------------- */

/* C99 and C++11 should provide snprintf, but define SWIG_NO_SNPRINTF
 * if you're missing it.
 */
#if ((defined __STDC_VERSION__ && __STDC_VERSION__ >= 199901L) || \
     (defined __cplusplus && __cplusplus >= 201103L) || \
     defined SWIG_HAVE_SNPRINTF) && \
    !defined SWIG_NO_SNPRINTF
# define SWIG_snprintf(O,S,F,A) snprintf(O,S,F,A)
# define SWIG_snprintf2(O,S,F,A,B) snprintf(O,S,F,A,B)
#else
/* Fallback versions ignore the buffer size, but most of our uses either have a
 * fixed maximum possible size or dynamically allocate a buffer that's large
 * enough.
 */
# define SWIG_snprintf(O,S,F,A) sprintf(O,F,A)
# define SWIG_snprintf2(O,S,F,A,B) sprintf(O,F,A,B)
#endif


#include <jni.h>
#include <stdlib.h>
#include <string.h>


/* Support for throwing Java exceptions */
typedef enum {
  SWIG_JavaOutOfMemoryError = 1,
  SWIG_JavaIOException,
  SWIG_JavaRuntimeException,
  SWIG_JavaIndexOutOfBoundsException,
  SWIG_JavaArithmeticException,
  SWIG_JavaIllegalArgumentException,
  SWIG_JavaNullPointerException,
  SWIG_JavaDirectorPureVirtual,
  SWIG_JavaUnknownError,
  SWIG_JavaIllegalStateException,
} SWIG_JavaExceptionCodes;

typedef struct {
  SWIG_JavaExceptionCodes code;
  const char *java_exception;
} SWIG_JavaExceptions_t;


static void SWIGUNUSED SWIG_JavaThrowException(JNIEnv *jenv, SWIG_JavaExceptionCodes code, const char *msg) {
  jclass excep;
  static const SWIG_JavaExceptions_t java_exceptions[] = {
    { SWIG_JavaOutOfMemoryError, "java/lang/OutOfMemoryError" },
    { SWIG_JavaIOException, "java/io/IOException" },
    { SWIG_JavaRuntimeException, "java/lang/RuntimeException" },
    { SWIG_JavaIndexOutOfBoundsException, "java/lang/IndexOutOfBoundsException" },
    { SWIG_JavaArithmeticException, "java/lang/ArithmeticException" },
    { SWIG_JavaIllegalArgumentException, "java/lang/IllegalArgumentException" },
    { SWIG_JavaNullPointerException, "java/lang/NullPointerException" },
    { SWIG_JavaDirectorPureVirtual, "java/lang/RuntimeException" },
    { SWIG_JavaUnknownError,  "java/lang/UnknownError" },
    { SWIG_JavaIllegalStateException, "java/lang/IllegalStateException" },
    { (SWIG_JavaExceptionCodes)0,  "java/lang/UnknownError" }
  };
  const SWIG_JavaExceptions_t *except_ptr = java_exceptions;

  while (except_ptr->code != code && except_ptr->code)
    except_ptr++;

  jenv->ExceptionClear();
  excep = jenv->FindClass(except_ptr->java_exception);
  if (excep)
    jenv->ThrowNew(excep, msg);
}


/* Contract support */

#define SWIG_contract_assert(nullreturn, expr, msg) do { if (!(expr)) {SWIG_JavaThrowException(jenv, SWIG_JavaIllegalArgumentException, msg); return nullreturn; } } while (0)


#ifdef __cplusplus
#include <utility>
/* SwigValueWrapper is described in swig.swg */
template<typename T> class SwigValueWrapper {
  struct SwigSmartPointer {
    T *ptr;
    SwigSmartPointer(T *p) : ptr(p) { }
    ~SwigSmartPointer() { delete ptr; }
    SwigSmartPointer& operator=(SwigSmartPointer& rhs) { T* oldptr = ptr; ptr = 0; delete oldptr; ptr = rhs.ptr; rhs.ptr = 0; return *this; }
    void reset(T *p) { T* oldptr = ptr; ptr = 0; delete oldptr; ptr = p; }
  } pointer;
  SwigValueWrapper& operator=(const SwigValueWrapper<T>& rhs);
  SwigValueWrapper(const SwigValueWrapper<T>& rhs);
public:
  SwigValueWrapper() : pointer(0) { }
  SwigValueWrapper& operator=(const T& t) { SwigSmartPointer tmp(new T(t)); pointer = tmp; return *this; }
#if __cplusplus >=201103L
  SwigValueWrapper& operator=(T&& t) { SwigSmartPointer tmp(new T(std::move(t))); pointer = tmp; return *this; }
  operator T&&() const { return std::move(*pointer.ptr); }
#else
  operator T&() const { return *pointer.ptr; }
#endif
  T *operator&() const { return pointer.ptr; }
  static void reset(SwigValueWrapper& t, T *p) { t.pointer.reset(p); }
};

/*
 * SwigValueInit() is a generic initialisation solution as the following approach:
 * 
 *       T c_result = T();
 * 
 * doesn't compile for all types for example:
 * 
 *       unsigned int c_result = unsigned int();
 */
template <typename T> T SwigValueInit() {
  return T();
}

#if __cplusplus >=201103L
# define SWIG_STD_MOVE(OBJ) std::move(OBJ)
#else
# define SWIG_STD_MOVE(OBJ) OBJ
#endif

#endif

#if defined(__cplusplus) && (__cplusplus >=201103L)
# define SWIG_OVERRIDE override
#else
# define SWIG_OVERRIDE
#endif



#include "../capi/c_api.h"


#include <stdint.h>		// Use the C99 official header


  /* Buffer-managing wrapper: sizes, retries, and returns the model text
   * directly (the raw export fills a caller buffer). */
  char* LGBM_BoosterSaveModelToStringSWIG(BoosterHandle handle,
                                          int start_iteration,
                                          int num_iteration,
                                          int64_t buffer_len,
                                          int64_t* out_len) {
    char* buf = new char[buffer_len];
    int rc = LGBM_BoosterSaveModelToString(handle, start_iteration,
                                           num_iteration, buffer_len,
                                           out_len, buf);
    if (rc == 0 && *out_len > buffer_len) {
      delete[] buf;
      int64_t need = *out_len;
      buf = new char[need];
      rc = LGBM_BoosterSaveModelToString(handle, start_iteration,
                                         num_iteration, need, out_len, buf);
    }
    if (rc != 0) {
      delete[] buf;
      return nullptr;
    }
    return buf;
  }

  char* LGBM_BoosterDumpModelSWIG(BoosterHandle handle,
                                  int start_iteration,
                                  int num_iteration,
                                  int64_t buffer_len,
                                  int64_t* out_len) {
    char* buf = new char[buffer_len];
    int rc = LGBM_BoosterDumpModel(handle, start_iteration, num_iteration,
                                   buffer_len, out_len, buf);
    if (rc == 0 && *out_len > buffer_len) {
      delete[] buf;
      int64_t need = *out_len;
      buf = new char[need];
      rc = LGBM_BoosterDumpModel(handle, start_iteration, num_iteration,
                                 need, out_len, buf);
    }
    if (rc != 0) {
      delete[] buf;
      return nullptr;
    }
    return buf;
  }

  char** LGBM_BoosterGetEvalNamesSWIG(BoosterHandle handle,
                                      int eval_counts) {
    char** names = new char*[eval_counts];
    for (int i = 0; i < eval_counts; ++i) names[i] = new char[128];
    if (LGBM_BoosterGetEvalNames(handle, &eval_counts, names) != 0) {
      for (int i = 0; i < eval_counts; ++i) delete[] names[i];
      delete[] names;
      return nullptr;
    }
    return names;
  }

  /* Single-row dense predict. Get*ArrayElements (copying), NOT
   * GetPrimitiveArrayCritical: the C ABI acquires the embedded CPython
   * GIL, and blocking inside a JNI critical region can deadlock the JVM
   * against GC. */
  int LGBM_BoosterPredictForMatSingle(JNIEnv* jenv,
                                      jdoubleArray data,
                                      BoosterHandle handle,
                                      int data_type,
                                      int ncol,
                                      int is_row_major,
                                      int predict_type,
                                      int num_iteration,
                                      const char* parameter,
                                      int64_t* out_len,
                                      double* out_result) {
    double* p = jenv->GetDoubleArrayElements(data, 0);
    int rc = LGBM_BoosterPredictForMatSingleRow(
        handle, p, data_type, ncol, is_row_major, predict_type,
        num_iteration, parameter, out_len, out_result);
    jenv->ReleaseDoubleArrayElements(data, p, JNI_ABORT);
    return rc;
  }

  /* Single-row sparse predict (same no-critical-region rule). */
  int LGBM_BoosterPredictForCSRSingle(JNIEnv* jenv,
                                      jintArray indices,
                                      jdoubleArray values,
                                      int numNonZeros,
                                      BoosterHandle handle,
                                      int indptr_type,
                                      int data_type,
                                      int64_t nelem,
                                      int64_t num_col,
                                      int predict_type,
                                      int num_iteration,
                                      const char* parameter,
                                      int64_t* out_len,
                                      double* out_result) {
    int* idx = (int*)jenv->GetIntArrayElements(indices, 0);
    double* val = jenv->GetDoubleArrayElements(values, 0);
    int32_t indptr[2] = {0, numNonZeros};
    int rc = LGBM_BoosterPredictForCSRSingleRow(
        handle, indptr, indptr_type, idx, val, data_type, 2, nelem, num_col,
        predict_type, num_iteration, parameter, out_len, out_result);
    jenv->ReleaseDoubleArrayElements(values, val, JNI_ABORT);
    jenv->ReleaseIntArrayElements(indices, (jint*)idx, JNI_ABORT);
    return rc;
  }

  #include <functional>
  #include <utility>
  #include <vector>

  /* Stream an array of Spark SparseVectors into
   * LGBM_DatasetCreateFromCSRFunc (the mmlspark ingestion path; the
   * funptr contract is a std::function<void(int,
   * vector<pair<int,double>>&)>*, see capi/c_api.h). JNI array handles
   * are resolved up front because the row callback may run outside the
   * calling thread. */
  int LGBM_DatasetCreateFromCSRSpark(JNIEnv* jenv,
                                     jobjectArray arrayOfSparseVector,
                                     int num_rows,
                                     int64_t num_col,
                                     const char* parameters,
                                     const DatasetHandle reference,
                                     DatasetHandle* out) {
    jclass cls = jenv->FindClass("org/apache/spark/ml/linalg/SparseVector");
    jmethodID m_indices = jenv->GetMethodID(cls, "indices", "()[I");
    jmethodID m_values = jenv->GetMethodID(cls, "values", "()[D");

    struct Row {
      jintArray jidx;
      jdoubleArray jval;
      int* idx;
      double* val;
      int n;
    };
    std::vector<Row> rows;
    rows.reserve(num_rows);
    // 2 kept array refs per row: grow the local-ref table up front so
    // large partitions don't overflow the JVM's default frame capacity
    jenv->EnsureLocalCapacity(2 * num_rows + 16);
    auto release_all = [&]() {
      for (size_t i = 0; i < rows.size(); ++i) {
        jenv->ReleaseDoubleArrayElements(rows[i].jval, rows[i].val,
                                         JNI_ABORT);
        jenv->ReleaseIntArrayElements(rows[i].jidx, (jint*)rows[i].idx,
                                      JNI_ABORT);
      }
    };
    for (int i = 0; i < num_rows; ++i) {
      jobject sv = jenv->GetObjectArrayElement(arrayOfSparseVector, i);
      jintArray jidx = (jintArray)jenv->CallObjectMethod(sv, m_indices);
      if (jenv->ExceptionCheck()) {
        release_all();
        return -1;
      }
      jdoubleArray jval = (jdoubleArray)jenv->CallObjectMethod(sv, m_values);
      if (jenv->ExceptionCheck()) {
        release_all();
        return -1;
      }
      jenv->DeleteLocalRef(sv);
      int n = jenv->GetArrayLength(jidx);
      int* idx = (int*)jenv->GetIntArrayElements(jidx, 0);
      double* val = jenv->GetDoubleArrayElements(jval, 0);
      Row row = {jidx, jval, idx, val, n};
      rows.push_back(row);
    }

    std::function<void(int, std::vector<std::pair<int, double> >&)> row_fn =
        [&rows](int r, std::vector<std::pair<int, double> >& ret) {
          const Row& row = rows[r];
          ret.clear();
          ret.reserve(row.n);
          for (int j = 0; j < row.n; ++j)
            ret.push_back(std::make_pair(row.idx[j], row.val[j]));
        };

    int rc = LGBM_DatasetCreateFromCSRFunc(&row_fn, num_rows, num_col,
                                           parameters, reference, out);
    release_all();
    return rc;
  }


static int *new_intp(void) { 
  return new int(); 
}

static int *copy_intp(int value) { 
  return new int(value); 
}

static void delete_intp(int *obj) { 
  delete obj; 
}

static void intp_assign(int *obj, int value) {
  *obj = value;
}

static int intp_value(int *obj) {
  return *obj;
}


static long *new_longp(void) { 
  return new long(); 
}

static long *copy_longp(long value) { 
  return new long(value); 
}

static void delete_longp(long *obj) { 
  delete obj; 
}

static void longp_assign(long *obj, long value) {
  *obj = value;
}

static long longp_value(long *obj) {
  return *obj;
}


static double *new_doublep(void) { 
  return new double(); 
}

static double *copy_doublep(double value) { 
  return new double(value); 
}

static void delete_doublep(double *obj) { 
  delete obj; 
}

static void doublep_assign(double *obj, double value) {
  *obj = value;
}

static double doublep_value(double *obj) {
  return *obj;
}


static float *new_floatp(void) { 
  return new float(); 
}

static float *copy_floatp(float value) { 
  return new float(value); 
}

static void delete_floatp(float *obj) { 
  delete obj; 
}

static void floatp_assign(float *obj, float value) {
  *obj = value;
}

static float floatp_value(float *obj) {
  return *obj;
}


static int64_t *new_int64_tp(void) { 
  return new int64_t(); 
}

static int64_t *copy_int64_tp(int64_t value) { 
  return new int64_t(value); 
}

static void delete_int64_tp(int64_t *obj) { 
  delete obj; 
}

static void int64_tp_assign(int64_t *obj, int64_t value) {
  *obj = value;
}

static int64_t int64_tp_value(int64_t *obj) {
  return *obj;
}


static int32_t *new_int32_tp(void) { 
  return new int32_t(); 
}

static int32_t *copy_int32_tp(int32_t value) { 
  return new int32_t(value); 
}

static void delete_int32_tp(int32_t *obj) { 
  delete obj; 
}

static void int32_tp_assign(int32_t *obj, int32_t value) {
  *obj = value;
}

static int32_t int32_tp_value(int32_t *obj) {
  return *obj;
}


long* int64_t_to_long_ptr(int64_t* x) {
   return (long*) x;
}


double* int64_t_to_double_ptr(int64_t* x) {
   return (double*) x;
}


int* int32_t_to_int_ptr(int32_t* x) {
   return (int*) x;
}


int64_t* long_to_int64_t_ptr(long* x) {
   return (int64_t*) x;
}


int64_t* double_to_int64_t_ptr(double* x) {
   return (int64_t*) x;
}


int32_t* int_to_int32_t_ptr(int* x) {
   return (int32_t*) x;
}


void* double_to_voidp_ptr(double* x) {
   return (void*) x;
}


void* float_to_voidp_ptr(float* x) {
   return (void*) x;
}


void* int_to_voidp_ptr(int* x) {
   return (void*) x;
}


void* int32_t_to_voidp_ptr(int32_t* x) {
   return (void*) x;
}


void* int64_t_to_voidp_ptr(int64_t* x) {
   return (void*) x;
}


static double *new_doubleArray(size_t nelements) { 
  return new double[nelements](); 
}

static void delete_doubleArray(double *ary) { 
  delete [] ary; 
}

static double doubleArray_getitem(double *ary, size_t index) {
    return ary[index];
}
static void doubleArray_setitem(double *ary, size_t index, double value) {
    ary[index] = value;
}


static float *new_floatArray(size_t nelements) { 
  return new float[nelements](); 
}

static void delete_floatArray(float *ary) { 
  delete [] ary; 
}

static float floatArray_getitem(float *ary, size_t index) {
    return ary[index];
}
static void floatArray_setitem(float *ary, size_t index, float value) {
    ary[index] = value;
}


static int *new_intArray(size_t nelements) { 
  return new int[nelements](); 
}

static void delete_intArray(int *ary) { 
  delete [] ary; 
}

static int intArray_getitem(int *ary, size_t index) {
    return ary[index];
}
static void intArray_setitem(int *ary, size_t index, int value) {
    ary[index] = value;
}


static long *new_longArray(size_t nelements) { 
  return new long[nelements](); 
}

static void delete_longArray(long *ary) { 
  delete [] ary; 
}

static long longArray_getitem(long *ary, size_t index) {
    return ary[index];
}
static void longArray_setitem(long *ary, size_t index, long value) {
    ary[index] = value;
}


static char* *new_stringArray(size_t nelements) { 
  return new char*[nelements](); 
}

static void delete_stringArray(char* *ary) { 
  delete [] ary; 
}

static char* stringArray_getitem(char* *ary, size_t index) {
    return ary[index];
}
static void stringArray_setitem(char* *ary, size_t index, char* value) {
    ary[index] = value;
}


  void** new_voidpp() { return new void*; }
  void delete_voidpp(void** self) { if (self) delete self; }
  void* voidpp_value(void** self) { return *self; }


#ifdef __cplusplus
extern "C" {
#endif

SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1DTYPE_1FLOAT32_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((0));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1DTYPE_1FLOAT64_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((1));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1DTYPE_1INT32_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((2));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1DTYPE_1INT64_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((3));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1PREDICT_1NORMAL_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((0));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1PREDICT_1RAW_1SCORE_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((1));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1PREDICT_1LEAF_1INDEX_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((2));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_C_1API_1PREDICT_1CONTRIB_1get(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)((3));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jstring JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1GetLastError(JNIEnv *jenv, jclass jcls) {
  jstring jresult = 0 ;
  char *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (char *)LGBM_GetLastError();
  if (result) jresult = jenv->NewStringUTF((const char *)result);
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1SetLastError(JNIEnv *jenv, jclass jcls, jstring jarg1) {
  char *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = 0;
  if (jarg1) {
    arg1 = (char *)jenv->GetStringUTFChars(jarg1, 0);
    if (!arg1) return ;
  }
  LGBM_SetLastError((char const *)arg1);
  if (arg1) jenv->ReleaseStringUTFChars(jarg1, (const char *)arg1);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromFile(JNIEnv *jenv, jclass jcls, jstring jarg1, jstring jarg2, jlong jarg3, jlong jarg4) {
  jint jresult = 0 ;
  char *arg1 = 0 ;
  char *arg2 = 0 ;
  DatasetHandle arg3 = (DatasetHandle)0 ;
  DatasetHandle *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = 0;
  if (jarg1) {
    arg1 = (char *)jenv->GetStringUTFChars(jarg1, 0);
    if (!arg1) return 0;
  }
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  arg3 = *(DatasetHandle *)&jarg3; 
  arg4 = *(DatasetHandle **)&jarg4; 
  result = (int)LGBM_DatasetCreateFromFile((char const *)arg1,(char const *)arg2,arg3,arg4);
  jresult = (jint)result; 
  if (arg1) jenv->ReleaseStringUTFChars(jarg1, (const char *)arg1);
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromMat(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jint jarg4, jint jarg5, jstring jarg6, jlong jarg7, jlong jarg8) {
  jint jresult = 0 ;
  void *arg1 = 0 ;
  int arg2 ;
  int32_t arg3 ;
  int32_t arg4 ;
  int arg5 ;
  char *arg6 = 0 ;
  DatasetHandle arg7 = (DatasetHandle)0 ;
  DatasetHandle *arg8 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void **)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int32_t)jarg3; 
  arg4 = (int32_t)jarg4; 
  arg5 = (int)jarg5; 
  arg6 = 0;
  if (jarg6) {
    arg6 = (char *)jenv->GetStringUTFChars(jarg6, 0);
    if (!arg6) return 0;
  }
  arg7 = *(DatasetHandle *)&jarg7; 
  arg8 = *(DatasetHandle **)&jarg8; 
  result = (int)LGBM_DatasetCreateFromMat((void const *)arg1,arg2,arg3,arg4,arg5,(char const *)arg6,arg7,arg8);
  jresult = (jint)result; 
  if (arg6) jenv->ReleaseStringUTFChars(jarg6, (const char *)arg6);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromMats(JNIEnv *jenv, jclass jcls, jint jarg1, jlong jarg2, jint jarg3, jlong jarg4, jint jarg5, jint jarg6, jstring jarg7, jlong jarg8, jlong jarg9) {
  jint jresult = 0 ;
  int32_t arg1 ;
  void **arg2 = 0 ;
  int arg3 ;
  int32_t *arg4 = 0 ;
  int32_t arg5 ;
  int arg6 ;
  char *arg7 = 0 ;
  DatasetHandle arg8 = (DatasetHandle)0 ;
  DatasetHandle *arg9 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = (int32_t)jarg1; 
  arg2 = *(void ***)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(int32_t **)&jarg4; 
  arg5 = (int32_t)jarg5; 
  arg6 = (int)jarg6; 
  arg7 = 0;
  if (jarg7) {
    arg7 = (char *)jenv->GetStringUTFChars(jarg7, 0);
    if (!arg7) return 0;
  }
  arg8 = *(DatasetHandle *)&jarg8; 
  arg9 = *(DatasetHandle **)&jarg9; 
  result = (int)LGBM_DatasetCreateFromMats(arg1,(void const **)arg2,arg3,arg4,arg5,arg6,(char const *)arg7,arg8,arg9);
  jresult = (jint)result; 
  if (arg7) jenv->ReleaseStringUTFChars(jarg7, (const char *)arg7);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromCSR(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3, jlong jarg4, jint jarg5, jlong jarg6, jlong jarg7, jlong jarg8, jstring jarg9, jlong jarg10, jlong jarg11) {
  jint jresult = 0 ;
  void *arg1 = 0 ;
  int arg2 ;
  int32_t *arg3 = 0 ;
  void *arg4 = 0 ;
  int arg5 ;
  int64_t arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  char *arg9 = 0 ;
  DatasetHandle arg10 = (DatasetHandle)0 ;
  DatasetHandle *arg11 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void **)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(int32_t **)&jarg3; 
  arg4 = *(void **)&jarg4; 
  arg5 = (int)jarg5; 
  arg6 = (int64_t)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = 0;
  if (jarg9) {
    arg9 = (char *)jenv->GetStringUTFChars(jarg9, 0);
    if (!arg9) return 0;
  }
  arg10 = *(DatasetHandle *)&jarg10; 
  arg11 = *(DatasetHandle **)&jarg11; 
  result = (int)LGBM_DatasetCreateFromCSR((void const *)arg1,arg2,(int const *)arg3,(void const *)arg4,arg5,arg6,arg7,arg8,(char const *)arg9,arg10,arg11);
  jresult = (jint)result; 
  if (arg9) jenv->ReleaseStringUTFChars(jarg9, (const char *)arg9);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromCSRFunc(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3, jstring jarg4, jlong jarg5, jlong jarg6) {
  jint jresult = 0 ;
  void *arg1 = 0 ;
  int arg2 ;
  int64_t arg3 ;
  char *arg4 = 0 ;
  DatasetHandle arg5 = (DatasetHandle)0 ;
  DatasetHandle *arg6 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void **)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int64_t)jarg3; 
  arg4 = 0;
  if (jarg4) {
    arg4 = (char *)jenv->GetStringUTFChars(jarg4, 0);
    if (!arg4) return 0;
  }
  arg5 = *(DatasetHandle *)&jarg5; 
  arg6 = *(DatasetHandle **)&jarg6; 
  result = (int)LGBM_DatasetCreateFromCSRFunc(arg1,arg2,arg3,(char const *)arg4,arg5,arg6);
  jresult = (jint)result; 
  if (arg4) jenv->ReleaseStringUTFChars(jarg4, (const char *)arg4);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromCSC(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3, jlong jarg4, jint jarg5, jlong jarg6, jlong jarg7, jlong jarg8, jstring jarg9, jlong jarg10, jlong jarg11) {
  jint jresult = 0 ;
  void *arg1 = 0 ;
  int arg2 ;
  int32_t *arg3 = 0 ;
  void *arg4 = 0 ;
  int arg5 ;
  int64_t arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  char *arg9 = 0 ;
  DatasetHandle arg10 = (DatasetHandle)0 ;
  DatasetHandle *arg11 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void **)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(int32_t **)&jarg3; 
  arg4 = *(void **)&jarg4; 
  arg5 = (int)jarg5; 
  arg6 = (int64_t)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = 0;
  if (jarg9) {
    arg9 = (char *)jenv->GetStringUTFChars(jarg9, 0);
    if (!arg9) return 0;
  }
  arg10 = *(DatasetHandle *)&jarg10; 
  arg11 = *(DatasetHandle **)&jarg11; 
  result = (int)LGBM_DatasetCreateFromCSC((void const *)arg1,arg2,(int const *)arg3,(void const *)arg4,arg5,arg6,arg7,arg8,(char const *)arg9,arg10,arg11);
  jresult = (jint)result; 
  if (arg9) jenv->ReleaseStringUTFChars(jarg9, (const char *)arg9);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromSampledColumn(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jlong jarg4, jint jarg5, jint jarg6, jstring jarg7, jlong jarg8) {
  jint jresult = 0 ;
  double **arg1 = 0 ;
  int **arg2 = 0 ;
  int32_t arg3 ;
  int *arg4 = 0 ;
  int32_t arg5 ;
  int32_t arg6 ;
  char *arg7 = 0 ;
  DatasetHandle *arg8 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double ***)&jarg1; 
  arg2 = *(int ***)&jarg2; 
  arg3 = (int32_t)jarg3; 
  arg4 = *(int **)&jarg4; 
  arg5 = (int32_t)jarg5; 
  arg6 = (int32_t)jarg6; 
  arg7 = 0;
  if (jarg7) {
    arg7 = (char *)jenv->GetStringUTFChars(jarg7, 0);
    if (!arg7) return 0;
  }
  arg8 = *(DatasetHandle **)&jarg8; 
  result = (int)LGBM_DatasetCreateFromSampledColumn(arg1,arg2,arg3,(int const *)arg4,arg5,arg6,(char const *)arg7,arg8);
  jresult = (jint)result; 
  if (arg7) jenv->ReleaseStringUTFChars(jarg7, (const char *)arg7);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateByReference(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jlong jarg3) {
  jint jresult = 0 ;
  DatasetHandle arg1 = (DatasetHandle)0 ;
  int64_t arg2 ;
  DatasetHandle *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = (int64_t)jarg2; 
  arg3 = *(DatasetHandle **)&jarg3; 
  result = (int)LGBM_DatasetCreateByReference(arg1,arg2,arg3);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetPushRows(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jint jarg4, jint jarg5, jint jarg6) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t arg4 ;
  int32_t arg5 ;
  int32_t arg6 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int32_t)jarg4; 
  arg5 = (int32_t)jarg5; 
  arg6 = (int32_t)jarg6; 
  result = (int)LGBM_DatasetPushRows(arg1,(void const *)arg2,arg3,arg4,arg5,arg6);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetPushRowsByCSR(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jlong jarg4, jlong jarg5, jint jarg6, jlong jarg7, jlong jarg8, jlong jarg9, jlong jarg10) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t *arg4 = 0 ;
  void *arg5 = 0 ;
  int arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  int64_t arg9 ;
  int64_t arg10 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(int32_t **)&jarg4; 
  arg5 = *(void **)&jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = (int64_t)jarg9; 
  arg10 = (int64_t)jarg10; 
  result = (int)LGBM_DatasetPushRowsByCSR(arg1,(void const *)arg2,arg3,(int const *)arg4,(void const *)arg5,arg6,arg7,arg8,arg9,arg10);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetGetSubset(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jstring jarg4, jlong jarg5) {
  jint jresult = 0 ;
  DatasetHandle arg1 = (DatasetHandle)0 ;
  int32_t *arg2 = 0 ;
  int32_t arg3 ;
  char *arg4 = 0 ;
  DatasetHandle *arg5 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(int32_t **)&jarg2; 
  arg3 = (int32_t)jarg3; 
  arg4 = 0;
  if (jarg4) {
    arg4 = (char *)jenv->GetStringUTFChars(jarg4, 0);
    if (!arg4) return 0;
  }
  arg5 = *(DatasetHandle **)&jarg5; 
  result = (int)LGBM_DatasetGetSubset(arg1,(int const *)arg2,arg3,(char const *)arg4,arg5);
  jresult = (jint)result; 
  if (arg4) jenv->ReleaseStringUTFChars(jarg4, (const char *)arg4);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetFree(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  result = (int)LGBM_DatasetFree(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetGetNumData(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  int32_t *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(int32_t **)&jarg2; 
  result = (int)LGBM_DatasetGetNumData(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetGetNumFeature(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  int32_t *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(int32_t **)&jarg2; 
  result = (int)LGBM_DatasetGetNumFeature(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetSetField(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2, jlong jarg3, jint jarg4, jint jarg5) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char *arg2 = 0 ;
  void *arg3 = 0 ;
  int arg4 ;
  int arg5 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  arg3 = *(void **)&jarg3; 
  arg4 = (int)jarg4; 
  arg5 = (int)jarg5; 
  result = (int)LGBM_DatasetSetField(arg1,(char const *)arg2,(void const *)arg3,arg4,arg5);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetGetField(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2, jlong jarg3, jlong jarg4, jlong jarg5) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int *arg3 = 0 ;
  void **arg4 = 0 ;
  int *arg5 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  arg3 = *(int **)&jarg3; 
  arg4 = *(void ***)&jarg4; 
  arg5 = *(int **)&jarg5; 
  result = (int)LGBM_DatasetGetField(arg1,(char const *)arg2,arg3,(void const **)arg4,arg5);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetSetFeatureNames(JNIEnv *jenv, jclass jcls, jlong jarg1, jobjectArray jarg2, jint jarg3) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char **arg2 = 0 ;
  int arg3 ;
  jint size2 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  {
    int i = 0;
    if (jarg2) {
      size2 = jenv->GetArrayLength(jarg2);
      
      arg2 = new char*[size2+1];
      
      
      
      for (i = 0; i<size2; i++) {
        jstring j_string = (jstring)jenv->GetObjectArrayElement(jarg2, i);
        const char *c_string = jenv->GetStringUTFChars(j_string, 0);
        
        arg2[i] = new char [strlen(c_string)+1];
        
        
        
        strcpy(arg2[i], c_string);
        jenv->ReleaseStringUTFChars(j_string, c_string);
        jenv->DeleteLocalRef(j_string);
      }
      arg2[i] = 0;
    } else {
      arg2 = 0;
      size2 = 0;
    }
  }
  arg3 = (int)jarg3; 
  result = (int)LGBM_DatasetSetFeatureNames(arg1,(char const **)arg2,arg3);
  jresult = (jint)result; 
  {
    int i;
    for (i=0; i<size2; i++)
    
    delete[] arg2[i];
    delete[] arg2;
    
    
    
    
  }
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetGetFeatureNames(JNIEnv *jenv, jclass jcls, jlong jarg1, jobjectArray jarg2, jlong jarg3) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char **arg2 = 0 ;
  int *arg3 = 0 ;
  jint size2 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  {
    int i = 0;
    if (jarg2) {
      size2 = jenv->GetArrayLength(jarg2);
      
      arg2 = new char*[size2+1];
      
      
      
      for (i = 0; i<size2; i++) {
        jstring j_string = (jstring)jenv->GetObjectArrayElement(jarg2, i);
        const char *c_string = jenv->GetStringUTFChars(j_string, 0);
        
        arg2[i] = new char [strlen(c_string)+1];
        
        
        
        strcpy(arg2[i], c_string);
        jenv->ReleaseStringUTFChars(j_string, c_string);
        jenv->DeleteLocalRef(j_string);
      }
      arg2[i] = 0;
    } else {
      arg2 = 0;
      size2 = 0;
    }
  }
  arg3 = *(int **)&jarg3; 
  result = (int)LGBM_DatasetGetFeatureNames(arg1,arg2,arg3);
  jresult = (jint)result; 
  {
    int i;
    for (i=0; i<size2; i++)
    
    delete[] arg2[i];
    delete[] arg2;
    
    
    
    
  }
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetAddFeaturesFrom(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  DatasetHandle arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = *(DatasetHandle *)&jarg2; 
  result = (int)LGBM_DatasetAddFeaturesFrom(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetSaveBinary(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  result = (int)LGBM_DatasetSaveBinary(arg1,(char const *)arg2);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetDumpText(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  result = (int)LGBM_DatasetDumpText(arg1,(char const *)arg2);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetUpdateParam(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2) {
  jint jresult = 0 ;
  DatasetHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  result = (int)LGBM_DatasetUpdateParam(arg1,(char const *)arg2);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterCreate(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2, jlong jarg3) {
  jint jresult = 0 ;
  DatasetHandle arg1 = (DatasetHandle)0 ;
  char *arg2 = 0 ;
  BoosterHandle *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(DatasetHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  arg3 = *(BoosterHandle **)&jarg3; 
  result = (int)LGBM_BoosterCreate(arg1,(char const *)arg2,arg3);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterCreateFromModelfile(JNIEnv *jenv, jclass jcls, jstring jarg1, jlong jarg2, jlong jarg3) {
  jint jresult = 0 ;
  char *arg1 = 0 ;
  int *arg2 = 0 ;
  BoosterHandle *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = 0;
  if (jarg1) {
    arg1 = (char *)jenv->GetStringUTFChars(jarg1, 0);
    if (!arg1) return 0;
  }
  arg2 = *(int **)&jarg2; 
  arg3 = *(BoosterHandle **)&jarg3; 
  result = (int)LGBM_BoosterCreateFromModelfile((char const *)arg1,arg2,arg3);
  jresult = (jint)result; 
  if (arg1) jenv->ReleaseStringUTFChars(jarg1, (const char *)arg1);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterLoadModelFromString(JNIEnv *jenv, jclass jcls, jstring jarg1, jlong jarg2, jlong jarg3) {
  jint jresult = 0 ;
  char *arg1 = 0 ;
  int *arg2 = 0 ;
  BoosterHandle *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = 0;
  if (jarg1) {
    arg1 = (char *)jenv->GetStringUTFChars(jarg1, 0);
    if (!arg1) return 0;
  }
  arg2 = *(int **)&jarg2; 
  arg3 = *(BoosterHandle **)&jarg3; 
  result = (int)LGBM_BoosterLoadModelFromString((char const *)arg1,arg2,arg3);
  jresult = (jint)result; 
  if (arg1) jenv->ReleaseStringUTFChars(jarg1, (const char *)arg1);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterFree(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  result = (int)LGBM_BoosterFree(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterMerge(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  BoosterHandle arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(BoosterHandle *)&jarg2; 
  result = (int)LGBM_BoosterMerge(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterShuffleModels(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  result = (int)LGBM_BoosterShuffleModels(arg1,arg2,arg3);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterAddValidData(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  DatasetHandle arg2 = (DatasetHandle)0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(DatasetHandle *)&jarg2; 
  result = (int)LGBM_BoosterAddValidData(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterResetTrainingData(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  DatasetHandle arg2 = (DatasetHandle)0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(DatasetHandle *)&jarg2; 
  result = (int)LGBM_BoosterResetTrainingData(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterResetParameter(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  result = (int)LGBM_BoosterResetParameter(arg1,(char const *)arg2);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterUpdateOneIter(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterUpdateOneIter(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterUpdateOneIterCustom(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jlong jarg3, jlong jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  float *arg2 = 0 ;
  float *arg3 = 0 ;
  int *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(float **)&jarg2; 
  arg3 = *(float **)&jarg3; 
  arg4 = *(int **)&jarg4; 
  result = (int)LGBM_BoosterUpdateOneIterCustom(arg1,(float const *)arg2,(float const *)arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterRollbackOneIter(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  result = (int)LGBM_BoosterRollbackOneIter(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterRefit(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jint jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int32_t *arg2 = 0 ;
  int32_t arg3 ;
  int32_t arg4 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int32_t **)&jarg2; 
  arg3 = (int32_t)jarg3; 
  arg4 = (int32_t)jarg4; 
  result = (int)LGBM_BoosterRefit(arg1,(int const *)arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetCurrentIteration(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterGetCurrentIteration(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetNumClasses(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterGetNumClasses(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterNumModelPerIteration(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterNumModelPerIteration(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterNumberOfTotalModel(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterNumberOfTotalModel(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetNumFeature(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterGetNumFeature(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetFeatureNames(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jobjectArray jarg3) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  char **arg3 = 0 ;
  jint size3 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  {
    int i = 0;
    if (jarg3) {
      size3 = jenv->GetArrayLength(jarg3);
      
      arg3 = new char*[size3+1];
      
      
      
      for (i = 0; i<size3; i++) {
        jstring j_string = (jstring)jenv->GetObjectArrayElement(jarg3, i);
        const char *c_string = jenv->GetStringUTFChars(j_string, 0);
        
        arg3[i] = new char [strlen(c_string)+1];
        
        
        
        strcpy(arg3[i], c_string);
        jenv->ReleaseStringUTFChars(j_string, c_string);
        jenv->DeleteLocalRef(j_string);
      }
      arg3[i] = 0;
    } else {
      arg3 = 0;
      size3 = 0;
    }
  }
  result = (int)LGBM_BoosterGetFeatureNames(arg1,arg2,arg3);
  jresult = (jint)result; 
  {
    int i;
    for (i=0; i<size3; i++)
    
    delete[] arg3[i];
    delete[] arg3;
    
    
    
    
  }
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetLeafValue(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jlong jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  double *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(double **)&jarg4; 
  result = (int)LGBM_BoosterGetLeafValue(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterSetLeafValue(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jdouble jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  double arg4 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (double)jarg4; 
  result = (int)LGBM_BoosterSetLeafValue(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterFeatureImportance(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jlong jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  double *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(double **)&jarg4; 
  result = (int)LGBM_BoosterFeatureImportance(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetEvalCounts(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  result = (int)LGBM_BoosterGetEvalCounts(arg1,arg2);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetEvalHigherBetter(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jlong jarg3) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int *arg2 = 0 ;
  int *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(int **)&jarg2; 
  arg3 = *(int **)&jarg3; 
  result = (int)LGBM_BoosterGetEvalHigherBetter(arg1,arg2,arg3);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetEval(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3, jlong jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int *arg3 = 0 ;
  double *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(int **)&jarg3; 
  arg4 = *(double **)&jarg4; 
  result = (int)LGBM_BoosterGetEval(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetNumPredict(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int64_t *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(int64_t **)&jarg3; 
  result = (int)LGBM_BoosterGetNumPredict(arg1,arg2,arg3);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetPredict(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jlong jarg3, jlong jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int64_t *arg3 = 0 ;
  double *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(int64_t **)&jarg3; 
  arg4 = *(double **)&jarg4; 
  result = (int)LGBM_BoosterGetPredict(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterCalcNumPredict(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jint jarg4, jlong jarg5) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  int arg4 ;
  int64_t *arg5 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int)jarg4; 
  arg5 = *(int64_t **)&jarg5; 
  result = (int)LGBM_BoosterCalcNumPredict(arg1,arg2,arg3,arg4,arg5);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForFile(JNIEnv *jenv, jclass jcls, jlong jarg1, jstring jarg2, jint jarg3, jint jarg4, jint jarg5, jstring jarg6, jstring jarg7) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  char *arg2 = 0 ;
  int arg3 ;
  int arg4 ;
  int arg5 ;
  char *arg6 = 0 ;
  char *arg7 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = 0;
  if (jarg2) {
    arg2 = (char *)jenv->GetStringUTFChars(jarg2, 0);
    if (!arg2) return 0;
  }
  arg3 = (int)jarg3; 
  arg4 = (int)jarg4; 
  arg5 = (int)jarg5; 
  arg6 = 0;
  if (jarg6) {
    arg6 = (char *)jenv->GetStringUTFChars(jarg6, 0);
    if (!arg6) return 0;
  }
  arg7 = 0;
  if (jarg7) {
    arg7 = (char *)jenv->GetStringUTFChars(jarg7, 0);
    if (!arg7) return 0;
  }
  result = (int)LGBM_BoosterPredictForFile(arg1,(char const *)arg2,arg3,arg4,arg5,(char const *)arg6,(char const *)arg7);
  jresult = (jint)result; 
  if (arg2) jenv->ReleaseStringUTFChars(jarg2, (const char *)arg2);
  if (arg6) jenv->ReleaseStringUTFChars(jarg6, (const char *)arg6);
  if (arg7) jenv->ReleaseStringUTFChars(jarg7, (const char *)arg7);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForMat(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jint jarg4, jint jarg5, jint jarg6, jint jarg7, jint jarg8, jstring jarg9, jlong jarg10, jlong jarg11) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t arg4 ;
  int32_t arg5 ;
  int arg6 ;
  int arg7 ;
  int arg8 ;
  char *arg9 = 0 ;
  int64_t *arg10 = 0 ;
  double *arg11 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int32_t)jarg4; 
  arg5 = (int32_t)jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int)jarg7; 
  arg8 = (int)jarg8; 
  arg9 = 0;
  if (jarg9) {
    arg9 = (char *)jenv->GetStringUTFChars(jarg9, 0);
    if (!arg9) return 0;
  }
  arg10 = *(int64_t **)&jarg10; 
  arg11 = *(double **)&jarg11; 
  result = (int)LGBM_BoosterPredictForMat(arg1,(void const *)arg2,arg3,arg4,arg5,arg6,arg7,arg8,(char const *)arg9,arg10,arg11);
  jresult = (jint)result; 
  if (arg9) jenv->ReleaseStringUTFChars(jarg9, (const char *)arg9);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForMatSingleRow(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jint jarg4, jint jarg5, jint jarg6, jint jarg7, jstring jarg8, jlong jarg9, jlong jarg10) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int arg4 ;
  int arg5 ;
  int arg6 ;
  int arg7 ;
  char *arg8 = 0 ;
  int64_t *arg9 = 0 ;
  double *arg10 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int)jarg4; 
  arg5 = (int)jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int)jarg7; 
  arg8 = 0;
  if (jarg8) {
    arg8 = (char *)jenv->GetStringUTFChars(jarg8, 0);
    if (!arg8) return 0;
  }
  arg9 = *(int64_t **)&jarg9; 
  arg10 = *(double **)&jarg10; 
  result = (int)LGBM_BoosterPredictForMatSingleRow(arg1,(void const *)arg2,arg3,arg4,arg5,arg6,arg7,(char const *)arg8,arg9,arg10);
  jresult = (jint)result; 
  if (arg8) jenv->ReleaseStringUTFChars(jarg8, (const char *)arg8);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForMats(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jint jarg4, jint jarg5, jint jarg6, jint jarg7, jstring jarg8, jlong jarg9, jlong jarg10) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void **arg2 = 0 ;
  int arg3 ;
  int32_t arg4 ;
  int32_t arg5 ;
  int arg6 ;
  int arg7 ;
  char *arg8 = 0 ;
  int64_t *arg9 = 0 ;
  double *arg10 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void ***)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int32_t)jarg4; 
  arg5 = (int32_t)jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int)jarg7; 
  arg8 = 0;
  if (jarg8) {
    arg8 = (char *)jenv->GetStringUTFChars(jarg8, 0);
    if (!arg8) return 0;
  }
  arg9 = *(int64_t **)&jarg9; 
  arg10 = *(double **)&jarg10; 
  result = (int)LGBM_BoosterPredictForMats(arg1,(void const **)arg2,arg3,arg4,arg5,arg6,arg7,(char const *)arg8,arg9,arg10);
  jresult = (jint)result; 
  if (arg8) jenv->ReleaseStringUTFChars(jarg8, (const char *)arg8);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForCSR(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jlong jarg4, jlong jarg5, jint jarg6, jlong jarg7, jlong jarg8, jlong jarg9, jint jarg10, jint jarg11, jstring jarg12, jlong jarg13, jlong jarg14) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t *arg4 = 0 ;
  void *arg5 = 0 ;
  int arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  int64_t arg9 ;
  int arg10 ;
  int arg11 ;
  char *arg12 = 0 ;
  int64_t *arg13 = 0 ;
  double *arg14 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(int32_t **)&jarg4; 
  arg5 = *(void **)&jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = (int64_t)jarg9; 
  arg10 = (int)jarg10; 
  arg11 = (int)jarg11; 
  arg12 = 0;
  if (jarg12) {
    arg12 = (char *)jenv->GetStringUTFChars(jarg12, 0);
    if (!arg12) return 0;
  }
  arg13 = *(int64_t **)&jarg13; 
  arg14 = *(double **)&jarg14; 
  result = (int)LGBM_BoosterPredictForCSR(arg1,(void const *)arg2,arg3,(int const *)arg4,(void const *)arg5,arg6,arg7,arg8,arg9,arg10,arg11,(char const *)arg12,arg13,arg14);
  jresult = (jint)result; 
  if (arg12) jenv->ReleaseStringUTFChars(jarg12, (const char *)arg12);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForCSRSingleRow(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jlong jarg4, jlong jarg5, jint jarg6, jlong jarg7, jlong jarg8, jlong jarg9, jint jarg10, jint jarg11, jstring jarg12, jlong jarg13, jlong jarg14) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t *arg4 = 0 ;
  void *arg5 = 0 ;
  int arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  int64_t arg9 ;
  int arg10 ;
  int arg11 ;
  char *arg12 = 0 ;
  int64_t *arg13 = 0 ;
  double *arg14 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(int32_t **)&jarg4; 
  arg5 = *(void **)&jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = (int64_t)jarg9; 
  arg10 = (int)jarg10; 
  arg11 = (int)jarg11; 
  arg12 = 0;
  if (jarg12) {
    arg12 = (char *)jenv->GetStringUTFChars(jarg12, 0);
    if (!arg12) return 0;
  }
  arg13 = *(int64_t **)&jarg13; 
  arg14 = *(double **)&jarg14; 
  result = (int)LGBM_BoosterPredictForCSRSingleRow(arg1,(void const *)arg2,arg3,(int const *)arg4,(void const *)arg5,arg6,arg7,arg8,arg9,arg10,arg11,(char const *)arg12,arg13,arg14);
  jresult = (jint)result; 
  if (arg12) jenv->ReleaseStringUTFChars(jarg12, (const char *)arg12);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForCSC(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3, jlong jarg4, jlong jarg5, jint jarg6, jlong jarg7, jlong jarg8, jlong jarg9, jint jarg10, jint jarg11, jstring jarg12, jlong jarg13, jlong jarg14) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  void *arg2 = 0 ;
  int arg3 ;
  int32_t *arg4 = 0 ;
  void *arg5 = 0 ;
  int arg6 ;
  int64_t arg7 ;
  int64_t arg8 ;
  int64_t arg9 ;
  int arg10 ;
  int arg11 ;
  char *arg12 = 0 ;
  int64_t *arg13 = 0 ;
  double *arg14 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = *(void **)&jarg2; 
  arg3 = (int)jarg3; 
  arg4 = *(int32_t **)&jarg4; 
  arg5 = *(void **)&jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int64_t)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = (int64_t)jarg9; 
  arg10 = (int)jarg10; 
  arg11 = (int)jarg11; 
  arg12 = 0;
  if (jarg12) {
    arg12 = (char *)jenv->GetStringUTFChars(jarg12, 0);
    if (!arg12) return 0;
  }
  arg13 = *(int64_t **)&jarg13; 
  arg14 = *(double **)&jarg14; 
  result = (int)LGBM_BoosterPredictForCSC(arg1,(void const *)arg2,arg3,(int const *)arg4,(void const *)arg5,arg6,arg7,arg8,arg9,arg10,arg11,(char const *)arg12,arg13,arg14);
  jresult = (jint)result; 
  if (arg12) jenv->ReleaseStringUTFChars(jarg12, (const char *)arg12);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1TPU_1PredictDispatchStats(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jlong jarg3) {
  jint jresult = 0 ;
  int64_t *arg1 = 0 ;
  int64_t *arg2 = 0 ;
  int64_t *arg3 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  arg2 = *(int64_t **)&jarg2; 
  arg3 = *(int64_t **)&jarg3; 
  result = (int)LGBM_TPU_PredictDispatchStats(arg1,arg2,arg3);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterSaveModel(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jstring jarg4) {
  jint jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  char *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = 0;
  if (jarg4) {
    arg4 = (char *)jenv->GetStringUTFChars(jarg4, 0);
    if (!arg4) return 0;
  }
  result = (int)LGBM_BoosterSaveModel(arg1,arg2,arg3,(char const *)arg4);
  jresult = (jint)result; 
  if (arg4) jenv->ReleaseStringUTFChars(jarg4, (const char *)arg4);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1NetworkInit(JNIEnv *jenv, jclass jcls, jstring jarg1, jint jarg2, jint jarg3, jint jarg4) {
  jint jresult = 0 ;
  char *arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  int arg4 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = 0;
  if (jarg1) {
    arg1 = (char *)jenv->GetStringUTFChars(jarg1, 0);
    if (!arg1) return 0;
  }
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int)jarg4; 
  result = (int)LGBM_NetworkInit((char const *)arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  if (arg1) jenv->ReleaseStringUTFChars(jarg1, (const char *)arg1);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1NetworkFree(JNIEnv *jenv, jclass jcls) {
  jint jresult = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  result = (int)LGBM_NetworkFree();
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1NetworkInitWithFunctions(JNIEnv *jenv, jclass jcls, jint jarg1, jint jarg2, jlong jarg3, jlong jarg4) {
  jint jresult = 0 ;
  int arg1 ;
  int arg2 ;
  void *arg3 = 0 ;
  void *arg4 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = (int)jarg1; 
  arg2 = (int)jarg2; 
  arg3 = *(void **)&jarg3; 
  arg4 = *(void **)&jarg4; 
  result = (int)LGBM_NetworkInitWithFunctions(arg1,arg2,arg3,arg4);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jstring JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterSaveModelToStringSWIG(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jlong jarg4, jlong jarg5) {
  jstring jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  int64_t arg4 ;
  int64_t *arg5 = 0 ;
  char *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int64_t)jarg4; 
  arg5 = *(int64_t **)&jarg5; 
  result = (char *)LGBM_BoosterSaveModelToStringSWIG(arg1,arg2,arg3,arg4,arg5);
  if (result) jresult = jenv->NewStringUTF((const char *)result);
  return jresult;
}


SWIGEXPORT jstring JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterDumpModelSWIG(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2, jint jarg3, jlong jarg4, jlong jarg5) {
  jstring jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  int arg3 ;
  int64_t arg4 ;
  int64_t *arg5 = 0 ;
  char *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int64_t)jarg4; 
  arg5 = *(int64_t **)&jarg5; 
  result = (char *)LGBM_BoosterDumpModelSWIG(arg1,arg2,arg3,arg4,arg5);
  if (result) jresult = jenv->NewStringUTF((const char *)result);
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterGetEvalNamesSWIG(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2) {
  jlong jresult = 0 ;
  BoosterHandle arg1 = 0 ;
  int arg2 ;
  char **result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(BoosterHandle *)&jarg1; 
  arg2 = (int)jarg2; 
  result = (char **)LGBM_BoosterGetEvalNamesSWIG(arg1,arg2);
  *(char ***)&jresult = result; 
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForMatSingle(JNIEnv *jenv, jclass jcls, jdoubleArray jarg2, jlong jarg3, jint jarg4, jint jarg5, jint jarg6, jint jarg7, jint jarg8, jstring jarg9, jlong jarg10, jlong jarg11) {
  jint jresult = 0 ;
  JNIEnv *arg1 = 0 ;
  jdoubleArray arg2 ;
  BoosterHandle arg3 = 0 ;
  int arg4 ;
  int arg5 ;
  int arg6 ;
  int arg7 ;
  int arg8 ;
  char *arg9 = 0 ;
  int64_t *arg10 = 0 ;
  double *arg11 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  
  arg1 = jenv;
  
  arg2 = jarg2; 
  arg3 = *(BoosterHandle *)&jarg3; 
  arg4 = (int)jarg4; 
  arg5 = (int)jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int)jarg7; 
  arg8 = (int)jarg8; 
  arg9 = 0;
  if (jarg9) {
    arg9 = (char *)jenv->GetStringUTFChars(jarg9, 0);
    if (!arg9) return 0;
  }
  arg10 = *(int64_t **)&jarg10; 
  arg11 = *(double **)&jarg11; 
  result = (int)LGBM_BoosterPredictForMatSingle(arg1,SWIG_STD_MOVE(arg2),arg3,arg4,arg5,arg6,arg7,arg8,(char const *)arg9,arg10,arg11);
  jresult = (jint)result; 
  if (arg9) jenv->ReleaseStringUTFChars(jarg9, (const char *)arg9);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1BoosterPredictForCSRSingle(JNIEnv *jenv, jclass jcls, jintArray jarg2, jdoubleArray jarg3, jint jarg4, jlong jarg5, jint jarg6, jint jarg7, jlong jarg8, jlong jarg9, jint jarg10, jint jarg11, jstring jarg12, jlong jarg13, jlong jarg14) {
  jint jresult = 0 ;
  JNIEnv *arg1 = 0 ;
  jintArray arg2 ;
  jdoubleArray arg3 ;
  int arg4 ;
  BoosterHandle arg5 = 0 ;
  int arg6 ;
  int arg7 ;
  int64_t arg8 ;
  int64_t arg9 ;
  int arg10 ;
  int arg11 ;
  char *arg12 = 0 ;
  int64_t *arg13 = 0 ;
  double *arg14 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  
  arg1 = jenv;
  
  arg2 = jarg2; 
  arg3 = jarg3; 
  arg4 = (int)jarg4; 
  arg5 = *(BoosterHandle *)&jarg5; 
  arg6 = (int)jarg6; 
  arg7 = (int)jarg7; 
  arg8 = (int64_t)jarg8; 
  arg9 = (int64_t)jarg9; 
  arg10 = (int)jarg10; 
  arg11 = (int)jarg11; 
  arg12 = 0;
  if (jarg12) {
    arg12 = (char *)jenv->GetStringUTFChars(jarg12, 0);
    if (!arg12) return 0;
  }
  arg13 = *(int64_t **)&jarg13; 
  arg14 = *(double **)&jarg14; 
  result = (int)LGBM_BoosterPredictForCSRSingle(arg1,SWIG_STD_MOVE(arg2),SWIG_STD_MOVE(arg3),arg4,arg5,arg6,arg7,arg8,arg9,arg10,arg11,(char const *)arg12,arg13,arg14);
  jresult = (jint)result; 
  if (arg12) jenv->ReleaseStringUTFChars(jarg12, (const char *)arg12);
  return jresult;
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_LGBM_1DatasetCreateFromCSRSpark(JNIEnv *jenv, jclass jcls, jobjectArray jarg2, jint jarg3, jlong jarg4, jstring jarg5, jlong jarg6, jlong jarg7) {
  jint jresult = 0 ;
  JNIEnv *arg1 = 0 ;
  jobjectArray arg2 ;
  int arg3 ;
  int64_t arg4 ;
  char *arg5 = 0 ;
  DatasetHandle arg6 = (DatasetHandle)0 ;
  DatasetHandle *arg7 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  
  arg1 = jenv;
  
  arg2 = jarg2; 
  arg3 = (int)jarg3; 
  arg4 = (int64_t)jarg4; 
  arg5 = 0;
  if (jarg5) {
    arg5 = (char *)jenv->GetStringUTFChars(jarg5, 0);
    if (!arg5) return 0;
  }
  arg6 = *(DatasetHandle *)&jarg6; 
  arg7 = *(DatasetHandle **)&jarg7; 
  result = (int)LGBM_DatasetCreateFromCSRSpark(arg1,SWIG_STD_MOVE(arg2),arg3,arg4,(char const *)arg5,arg6,arg7);
  jresult = (jint)result; 
  if (arg5) jenv->ReleaseStringUTFChars(jarg5, (const char *)arg5);
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1intp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  int *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (int *)new_intp();
  *(int **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1intp(JNIEnv *jenv, jclass jcls, jint jarg1) {
  jlong jresult = 0 ;
  int arg1 ;
  int *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (int)jarg1; 
  result = (int *)copy_intp(arg1);
  *(int **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1intp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  int *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  delete_intp(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_intp_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2) {
  int *arg1 = 0 ;
  int arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  arg2 = (int)jarg2; 
  intp_assign(arg1,arg2);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_intp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  int *arg1 = 0 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  result = (int)intp_value(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1longp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  long *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (long *)new_longp();
  *(long **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1longp(JNIEnv *jenv, jclass jcls, jint jarg1) {
  jlong jresult = 0 ;
  long arg1 ;
  long *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (long)jarg1; 
  result = (long *)copy_longp(arg1);
  *(long **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1longp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  long *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  delete_longp(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_longp_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2) {
  long *arg1 = 0 ;
  long arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  arg2 = (long)jarg2; 
  longp_assign(arg1,arg2);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_longp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  long *arg1 = 0 ;
  long result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  result = (long)longp_value(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1doublep(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  double *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (double *)new_doublep();
  *(double **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1doublep(JNIEnv *jenv, jclass jcls, jdouble jarg1) {
  jlong jresult = 0 ;
  double arg1 ;
  double *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (double)jarg1; 
  result = (double *)copy_doublep(arg1);
  *(double **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1doublep(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  double *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  delete_doublep(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_doublep_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jdouble jarg2) {
  double *arg1 = 0 ;
  double arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  arg2 = (double)jarg2; 
  doublep_assign(arg1,arg2);
}


SWIGEXPORT jdouble JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_doublep_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jdouble jresult = 0 ;
  double *arg1 = 0 ;
  double result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  result = (double)doublep_value(arg1);
  jresult = (jdouble)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1floatp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  float *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (float *)new_floatp();
  *(float **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1floatp(JNIEnv *jenv, jclass jcls, jfloat jarg1) {
  jlong jresult = 0 ;
  float arg1 ;
  float *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (float)jarg1; 
  result = (float *)copy_floatp(arg1);
  *(float **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1floatp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  float *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  delete_floatp(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_floatp_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jfloat jarg2) {
  float *arg1 = 0 ;
  float arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  arg2 = (float)jarg2; 
  floatp_assign(arg1,arg2);
}


SWIGEXPORT jfloat JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_floatp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jfloat jresult = 0 ;
  float *arg1 = 0 ;
  float result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  result = (float)floatp_value(arg1);
  jresult = (jfloat)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1int64_1tp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  int64_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (int64_t *)new_int64_tp();
  *(int64_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1int64_1tp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int64_t arg1 ;
  int64_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (int64_t)jarg1; 
  result = (int64_t *)copy_int64_tp(arg1);
  *(int64_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1int64_1tp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  int64_t *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  delete_int64_tp(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int64_1tp_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  int64_t *arg1 = 0 ;
  int64_t arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  arg2 = (int64_t)jarg2; 
  int64_tp_assign(arg1,arg2);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int64_1tp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int64_t *arg1 = 0 ;
  int64_t result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  result = (int64_t)int64_tp_value(arg1);
  jresult = (jlong)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1int32_1tp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  int32_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (int32_t *)new_int32_tp();
  *(int32_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_copy_1int32_1tp(JNIEnv *jenv, jclass jcls, jint jarg1) {
  jlong jresult = 0 ;
  int32_t arg1 ;
  int32_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (int32_t)jarg1; 
  result = (int32_t *)copy_int32_tp(arg1);
  *(int32_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1int32_1tp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  int32_t *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int32_t **)&jarg1; 
  delete_int32_tp(arg1);
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int32_1tp_1assign(JNIEnv *jenv, jclass jcls, jlong jarg1, jint jarg2) {
  int32_t *arg1 = 0 ;
  int32_t arg2 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int32_t **)&jarg1; 
  arg2 = (int32_t)jarg2; 
  int32_tp_assign(arg1,arg2);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int32_1tp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jint jresult = 0 ;
  int32_t *arg1 = 0 ;
  int32_t result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int32_t **)&jarg1; 
  result = (int32_t)int32_tp_value(arg1);
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int64_1t_1to_1long_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int64_t *arg1 = 0 ;
  long *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  result = (long *)int64_t_to_long_ptr(arg1);
  *(long **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int64_1t_1to_1double_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int64_t *arg1 = 0 ;
  double *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  result = (double *)int64_t_to_double_ptr(arg1);
  *(double **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int32_1t_1to_1int_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int32_t *arg1 = 0 ;
  int *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int32_t **)&jarg1; 
  result = (int *)int32_t_to_int_ptr(arg1);
  *(int **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_long_1to_1int64_1t_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  long *arg1 = 0 ;
  int64_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  result = (int64_t *)long_to_int64_t_ptr(arg1);
  *(int64_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_double_1to_1int64_1t_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  double *arg1 = 0 ;
  int64_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  result = (int64_t *)double_to_int64_t_ptr(arg1);
  *(int64_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int_1to_1int32_1t_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int *arg1 = 0 ;
  int32_t *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  result = (int32_t *)int_to_int32_t_ptr(arg1);
  *(int32_t **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_double_1to_1voidp_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  double *arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  result = (void *)double_to_voidp_ptr(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_float_1to_1voidp_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  float *arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  result = (void *)float_to_voidp_ptr(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int_1to_1voidp_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int *arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  result = (void *)int_to_voidp_ptr(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int32_1t_1to_1voidp_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int32_t *arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int32_t **)&jarg1; 
  result = (void *)int32_t_to_voidp_ptr(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_int64_1t_1to_1voidp_1ptr(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  int64_t *arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int64_t **)&jarg1; 
  result = (void *)int64_t_to_voidp_ptr(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1doubleArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  size_t arg1 ;
  double *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (size_t)jarg1; 
  result = (double *)new_doubleArray(SWIG_STD_MOVE(arg1));
  *(double **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1doubleArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  double *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  delete_doubleArray(arg1);
}


SWIGEXPORT jdouble JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_doubleArray_1getitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jdouble jresult = 0 ;
  double *arg1 = 0 ;
  size_t arg2 ;
  double result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  arg2 = (size_t)jarg2; 
  result = (double)doubleArray_getitem(arg1,SWIG_STD_MOVE(arg2));
  jresult = (jdouble)result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_doubleArray_1setitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jdouble jarg3) {
  double *arg1 = 0 ;
  size_t arg2 ;
  double arg3 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(double **)&jarg1; 
  arg2 = (size_t)jarg2; 
  arg3 = (double)jarg3; 
  doubleArray_setitem(arg1,SWIG_STD_MOVE(arg2),arg3);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1floatArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  size_t arg1 ;
  float *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (size_t)jarg1; 
  result = (float *)new_floatArray(SWIG_STD_MOVE(arg1));
  *(float **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1floatArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  float *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  delete_floatArray(arg1);
}


SWIGEXPORT jfloat JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_floatArray_1getitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jfloat jresult = 0 ;
  float *arg1 = 0 ;
  size_t arg2 ;
  float result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  arg2 = (size_t)jarg2; 
  result = (float)floatArray_getitem(arg1,SWIG_STD_MOVE(arg2));
  jresult = (jfloat)result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_floatArray_1setitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jfloat jarg3) {
  float *arg1 = 0 ;
  size_t arg2 ;
  float arg3 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(float **)&jarg1; 
  arg2 = (size_t)jarg2; 
  arg3 = (float)jarg3; 
  floatArray_setitem(arg1,SWIG_STD_MOVE(arg2),arg3);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1intArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  size_t arg1 ;
  int *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (size_t)jarg1; 
  result = (int *)new_intArray(SWIG_STD_MOVE(arg1));
  *(int **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1intArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  int *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  delete_intArray(arg1);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_intArray_1getitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  int *arg1 = 0 ;
  size_t arg2 ;
  int result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  arg2 = (size_t)jarg2; 
  result = (int)intArray_getitem(arg1,SWIG_STD_MOVE(arg2));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_intArray_1setitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3) {
  int *arg1 = 0 ;
  size_t arg2 ;
  int arg3 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(int **)&jarg1; 
  arg2 = (size_t)jarg2; 
  arg3 = (int)jarg3; 
  intArray_setitem(arg1,SWIG_STD_MOVE(arg2),arg3);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1longArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  size_t arg1 ;
  long *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (size_t)jarg1; 
  result = (long *)new_longArray(SWIG_STD_MOVE(arg1));
  *(long **)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1longArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  long *arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  delete_longArray(arg1);
}


SWIGEXPORT jint JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_longArray_1getitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jint jresult = 0 ;
  long *arg1 = 0 ;
  size_t arg2 ;
  long result;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  arg2 = (size_t)jarg2; 
  result = (long)longArray_getitem(arg1,SWIG_STD_MOVE(arg2));
  jresult = (jint)result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_longArray_1setitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jint jarg3) {
  long *arg1 = 0 ;
  size_t arg2 ;
  long arg3 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(long **)&jarg1; 
  arg2 = (size_t)jarg2; 
  arg3 = (long)jarg3; 
  longArray_setitem(arg1,SWIG_STD_MOVE(arg2),arg3);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1stringArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  size_t arg1 ;
  char **result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = (size_t)jarg1; 
  result = (char **)new_stringArray(SWIG_STD_MOVE(arg1));
  *(char ***)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1stringArray(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  char **arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(char ***)&jarg1; 
  delete_stringArray(arg1);
}


SWIGEXPORT jstring JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_stringArray_1getitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2) {
  jstring jresult = 0 ;
  char **arg1 = 0 ;
  size_t arg2 ;
  char *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(char ***)&jarg1; 
  arg2 = (size_t)jarg2; 
  result = (char *)stringArray_getitem(arg1,SWIG_STD_MOVE(arg2));
  if (result) jresult = jenv->NewStringUTF((const char *)result);
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_stringArray_1setitem(JNIEnv *jenv, jclass jcls, jlong jarg1, jlong jarg2, jstring jarg3) {
  char **arg1 = 0 ;
  size_t arg2 ;
  char *arg3 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(char ***)&jarg1; 
  arg2 = (size_t)jarg2; 
  arg3 = 0;
  if (jarg3) {
    arg3 = (char *)jenv->GetStringUTFChars(jarg3, 0);
    if (!arg3) return ;
  }
  stringArray_setitem(arg1,SWIG_STD_MOVE(arg2),arg3);
  if (arg3) jenv->ReleaseStringUTFChars(jarg3, (const char *)arg3);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_new_1voidpp(JNIEnv *jenv, jclass jcls) {
  jlong jresult = 0 ;
  void **result = 0 ;
  
  (void)jenv;
  (void)jcls;
  result = (void **)new_voidpp();
  *(void ***)&jresult = result; 
  return jresult;
}


SWIGEXPORT void JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_delete_1voidpp(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  void **arg1 = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void ***)&jarg1; 
  delete_voidpp(arg1);
}


SWIGEXPORT jlong JNICALL Java_com_lightgbm_tpu_lightgbmlibtpuJNI_voidpp_1value(JNIEnv *jenv, jclass jcls, jlong jarg1) {
  jlong jresult = 0 ;
  void **arg1 = 0 ;
  void *result = 0 ;
  
  (void)jenv;
  (void)jcls;
  arg1 = *(void ***)&jarg1; 
  result = (void *)voidpp_value(arg1);
  *(void **)&jresult = result; 
  return jresult;
}


#ifdef __cplusplus
}
#endif

