// K1 / K2 / K3 / K3t: per-(feature, bin) histograms of [grad, hess, count]
// for Hopper, float or exact integer.
//
// Replaces, in lightgbm_tpu/ops/pallas/histogram_kernel.py:
//   * _hist_kernel, the body of build_histogram_pallas (K1, (P, F) codes)
//     and build_histogram_pallas_t (K2, (F, P) codes): f32 operand, f32
//     sums;
//   * _hist_kernel_q, the body of build_histogram_pallas_quantized (K3) and
//     build_histogram_pallas_quantized_t (K3t): int8 (grad_bits <= 8) or
//     int32 operand [qg, qh, valid], exact int32 sums.
// The TPU kernels build a one-hot tile in VMEM and contract it with the
// operand on the MXU, because the TPU has no scatter atomics. Hopper has
// fast shared-memory atomics, so this kernel is the per-workgroup
// local-memory histogram of the reference's histogram256.cl, templated on
// the code, operand and accumulator types:
//
//   * each block zeroes a (feature tile x B x 3) histogram of 4-byte slots
//     (f32 or int32) in shared memory (28 features x 64 bins x 12 B =
//     21.5 KB at the main path's shapes; up to 96 KB as dynamic shared
//     memory, feature-tiled over blockIdx.y when F * B * 12 exceeds that);
//   * threads walk the rows grid-stride; a row whose operand is all zero
//     (outside the leaf, on the masked strategy) is skipped before its
//     codes are read; the others atomicAdd their three lanes into the
//     shared slots of each feature's bin;
//   * each block then adds its nonzero slots into the global result with
//     one atomicAdd per slot.
//
// Codes are uint8, uint16 or int32 with element strides, so one kernel
// reads the byte view of the compact core's packed working rows ((P, F),
// row stride = the row's byte count) and the masked strategy's
// column-major codes ((F, P) seen as (P, F) with row stride 1 and column
// stride P: consecutive threads read consecutive code bytes).
//
// Bound on the H100: bytes. The function reads P*F code bytes and the
// operand (12*P bytes f32, 3*P int8) once and writes 12*F*B bytes, against
// 3*P*F adds; at F=28 that is under one add per byte, far below the card's
// balance point. The design reads every code and operand word exactly once
// (no one-hot in device memory), and the grid is capped at two blocks per
// SM so that the per-block flush (F*B*3 global atomics) stays small next to
// the row traffic.
//
// Numerics: the count lane sums exact small integers and is exact in any
// order. The f32 grad and hess lanes are sums whose order depends on atomic
// scheduling, so they vary in the last bits from run to run; skipping a
// zero row changes no sum. The integer lanes are associative, so K3 / K3t
// are bit-exact in any launch and atomic order, against the plain version
// and the TPU kernel; int32 cannot overflow, as quant_max caps qmax * N at
// 2^30.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 96 * 1024;

template <typename CodeT, typename OpT, typename AccT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const CodeT* __restrict__ codes, long long P, int F,
            long long row_stride, long long col_stride,
            const OpT* __restrict__ gh, long long gh_stride, int B,
            int feat_tile, AccT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
  AccT* sh = reinterpret_cast<AccT*>(hist_smem);
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int slots = ft * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) sh[i] = AccT(0);
  __syncthreads();

  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < P;
       r += step) {
    const OpT* g = gh + r * gh_stride;
    const AccT gv = (AccT)g[0], hv = (AccT)g[1], cv = (AccT)g[2];
    if (gv == AccT(0) && hv == AccT(0) && cv == AccT(0)) continue;
    const CodeT* row = codes + r * row_stride + (long long)f0 * col_stride;
    for (int f = 0; f < ft; ++f) {
      const int code = (int)row[(long long)f * col_stride];
      // codes outside [0, B) contribute nothing, as in the one-hot form
      if (code >= 0 && code < B) {
        AccT* s = sh + (f * B + code) * 3;
        atomicAdd(s, gv);
        atomicAdd(s + 1, hv);
        atomicAdd(s + 2, cv);
      }
    }
  }
  __syncthreads();

  AccT* o = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const AccT v = sh[i];
    if (v != AccT(0)) atomicAdd(o + i, v);
  }
}

template <typename CodeT, typename OpT, typename AccT>
int launch(const void* codes, long long P, int F, long long row_stride,
           long long col_stride, const void* gh, long long gh_stride, int B,
           void* out, int grid_x, cudaStream_t stream) {
  int feat_tile = kMaxSmemBytes / (B * 12);
  if (feat_tile < 1) return (int)cudaErrorInvalidValue;
  if (feat_tile > F) feat_tile = F;
  const size_t smem = (size_t)feat_tile * B * 12;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<CodeT, OpT, AccT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(grid_x, (F + feat_tile - 1) / feat_tile);
  hist_kernel<CodeT, OpT, AccT><<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), P, F, row_stride, col_stride,
      static_cast<const OpT*>(gh), gh_stride, B, feat_tile,
      static_cast<AccT*>(out));
  return (int)cudaGetLastError();
}

template <typename OpT, typename AccT>
int launch_codes(const void* codes, int code_bytes, long long P, int F,
                 long long row_stride, long long col_stride, const void* gh,
                 long long gh_stride, int B, void* out, int grid_x,
                 cudaStream_t s) {
  switch (code_bytes) {
    case 1:
      return launch<uint8_t, OpT, AccT>(codes, P, F, row_stride, col_stride,
                                        gh, gh_stride, B, out, grid_x, s);
    case 2:
      return launch<uint16_t, OpT, AccT>(codes, P, F, row_stride, col_stride,
                                         gh, gh_stride, B, out, grid_x, s);
    case 4:
      return launch<int32_t, OpT, AccT>(codes, P, F, row_stride, col_stride,
                                        gh, gh_stride, B, out, grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// codes: (P, F) bin codes of `code_bytes` bytes each (1: uint8, 2: uint16,
// 4: int32), element strides row_stride / col_stride. gh: (P, 3) operand
// with unit column stride and row stride gh_stride, of kind `op_kind`:
// 0 = f32 (out f32), 1 = int8 (out int32), 2 = int32 (out int32). out:
// (F, B, 3), zeroed by the caller.
extern "C" int lgbt_hist_launch(const void* codes, int code_bytes, long long P,
                                int F, long long row_stride,
                                long long col_stride, const void* gh,
                                int op_kind, long long gh_stride, int B,
                                void* out, int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op_kind) {
    case 0:
      return launch_codes<float, float>(codes, code_bytes, P, F, row_stride,
                                        col_stride, gh, gh_stride, B, out,
                                        grid_x, s);
    case 1:
      return launch_codes<int8_t, int>(codes, code_bytes, P, F, row_stride,
                                       col_stride, gh, gh_stride, B, out,
                                       grid_x, s);
    case 2:
      return launch_codes<int32_t, int>(codes, code_bytes, P, F, row_stride,
                                        col_stride, gh, gh_stride, B, out,
                                        grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
