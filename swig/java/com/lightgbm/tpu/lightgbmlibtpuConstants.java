/* ----------------------------------------------------------------------------
 * This file was automatically generated by SWIG (https://www.swig.org).
 * Version 4.4.1
 *
 * Do not make changes to this file unless you know what you are doing - modify
 * the SWIG interface file instead.
 * ----------------------------------------------------------------------------- */

package com.lightgbm.tpu;

public interface lightgbmlibtpuConstants {
  public final static int C_API_DTYPE_FLOAT32 = lightgbmlibtpuJNI.C_API_DTYPE_FLOAT32_get();
  public final static int C_API_DTYPE_FLOAT64 = lightgbmlibtpuJNI.C_API_DTYPE_FLOAT64_get();
  public final static int C_API_DTYPE_INT32 = lightgbmlibtpuJNI.C_API_DTYPE_INT32_get();
  public final static int C_API_DTYPE_INT64 = lightgbmlibtpuJNI.C_API_DTYPE_INT64_get();
  public final static int C_API_PREDICT_NORMAL = lightgbmlibtpuJNI.C_API_PREDICT_NORMAL_get();
  public final static int C_API_PREDICT_RAW_SCORE = lightgbmlibtpuJNI.C_API_PREDICT_RAW_SCORE_get();
  public final static int C_API_PREDICT_LEAF_INDEX = lightgbmlibtpuJNI.C_API_PREDICT_LEAF_INDEX_get();
  public final static int C_API_PREDICT_CONTRIB = lightgbmlibtpuJNI.C_API_PREDICT_CONTRIB_get();
}
