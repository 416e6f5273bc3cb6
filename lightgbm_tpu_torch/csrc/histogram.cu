// K1: per-(feature, bin) histogram of [grad, hess, count] for Hopper.
//
// Replaces lightgbm_tpu/ops/pallas/histogram_kernel.py::_hist_kernel, the
// body of build_histogram_pallas. The TPU kernel builds a one-hot tile in
// VMEM and contracts it with gh on the MXU, because the TPU has no scatter
// atomics. Hopper has fast shared-memory atomics, so this kernel is the
// per-workgroup local-memory histogram of the reference's histogram256.cl:
//
//   * each block zeroes a (feature tile x B x 3) f32 histogram in shared
//     memory (28 features x 64 bins x 12 B = 21.5 KB at the main path's
//     shapes; up to 96 KB as dynamic shared memory, feature-tiled over
//     blockIdx.y when F * B * 12 exceeds that);
//   * threads walk the rows grid-stride and atomicAdd grad, hess and count
//     into the shared slots of each feature's bin;
//   * each block then adds its nonzero partial sums into the global result
//     with one atomicAdd per slot.
//
// Bound on the H100: bytes. The function reads P*F code bytes and 12*P gh
// bytes once and writes 12*F*B bytes, against 3*P*F f32 adds; at F=28 that
// is under one add per byte, far below the card's balance point. The design
// reads every code and gh word exactly once (no one-hot in device memory),
// and the grid is capped at two blocks per SM so that the per-block flush
// (F*B*3 global atomics) stays small next to the row traffic.
//
// Numerics: the count lane sums exact small integers and is exact in any
// order. The grad and hess lanes are f32 sums whose order depends on atomic
// scheduling, so they vary in the last bits from run to run.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 96 * 1024;

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const CodeT* __restrict__ codes, long long P, int F,
            long long row_stride, long long col_stride,
            const float* __restrict__ gh, long long gh_stride, int B,
            int feat_tile, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int slots = ft * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < P;
       r += step) {
    const float* g = gh + r * gh_stride;
    const float gv = g[0], hv = g[1], cv = g[2];
    const CodeT* row = codes + r * row_stride + (long long)f0 * col_stride;
    for (int f = 0; f < ft; ++f) {
      const int code = (int)row[(long long)f * col_stride];
      // codes outside [0, B) contribute nothing, as in the one-hot form
      if (code >= 0 && code < B) {
        float* s = sh + (f * B + code) * 3;
        atomicAdd(s, gv);
        atomicAdd(s + 1, hv);
        atomicAdd(s + 2, cv);
      }
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const float v = sh[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

template <typename CodeT>
int launch(const void* codes, long long P, int F, long long row_stride,
           long long col_stride, const float* gh, long long gh_stride, int B,
           float* out, int grid_x, cudaStream_t stream) {
  int feat_tile = kMaxSmemBytes / (B * 12);
  if (feat_tile < 1) return (int)cudaErrorInvalidValue;
  if (feat_tile > F) feat_tile = F;
  const size_t smem = (size_t)feat_tile * B * 12;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(grid_x, (F + feat_tile - 1) / feat_tile);
  hist_kernel<CodeT><<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), P, F, row_stride, col_stride, gh,
      gh_stride, B, feat_tile, out);
  return (int)cudaGetLastError();
}

}  // namespace

// codes: (P, F) bin codes of `code_bytes` bytes each (1: uint8, 2: uint16,
// 4: int32), element strides row_stride / col_stride. gh: (P, 3) f32 with
// row stride gh_stride. out: (F, B, 3) f32, zeroed by the caller.
extern "C" int lgbt_hist_launch(const void* codes, int code_bytes, long long P,
                                int F, long long row_stride,
                                long long col_stride, const float* gh,
                                long long gh_stride, int B, float* out,
                                int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1:
      return launch<uint8_t>(codes, P, F, row_stride, col_stride, gh,
                             gh_stride, B, out, grid_x, s);
    case 2:
      return launch<uint16_t>(codes, P, F, row_stride, col_stride, gh,
                              gh_stride, B, out, grid_x, s);
    case 4:
      return launch<int32_t>(codes, P, F, row_stride, col_stride, gh,
                             gh_stride, B, out, grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
