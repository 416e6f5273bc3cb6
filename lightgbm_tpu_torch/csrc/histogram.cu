// K1 / K2 / K3 / K3t: per-(feature, bin) histograms of [grad, hess, count]
// for Hopper, float or exact integer.
//
// Replaces, in lightgbm_tpu/ops/pallas/histogram_kernel.py:
//   * _hist_kernel, the body of build_histogram_pallas (K1, (P, F) codes)
//     and build_histogram_pallas_t (K2, (F, P) codes): f32 operand, f32
//     sums (hist_fixed_kernel below);
//   * _hist_kernel_q, the body of build_histogram_pallas_quantized (K3) and
//     build_histogram_pallas_quantized_t (K3t): int8 (grad_bits <= 8) or
//     int32 operand [qg, qh, valid], exact int32 sums (hist_kernel).
// The TPU kernels build a one-hot tile in VMEM and contract it with the
// operand on the MXU, because the TPU has no scatter atomics. Hopper has
// fast shared-memory atomics, so both kernels here are the per-workgroup
// local-memory histogram of the reference's histogram256.cl:
//
//   * each block zeroes a (feature tile x B x 3) histogram of int32 slots
//     in shared memory (28 features x 64 bins x 12 B = 21.5 KB at the main
//     path's shapes, twice that for the float kernel's hi and lo words; up
//     to 96 KB as dynamic shared memory, 48 KB for the float kernel unless
//     one feature needs more, feature-tiled over blockIdx.y when F
//     features exceed that);
//   * threads walk the rows grid-stride; a row whose operand is all zero
//     (outside the leaf, on the masked strategy) is skipped before its
//     codes are read; the others atomicAdd their lanes into the shared
//     slots of each feature's bin;
//   * each block then adds its nonzero slots into the global result with
//     one atomicAdd per slot.
//
// Why the float kernel sums in fixed point. In the SASS for sm_90a an
// atomicAdd(float*) on shared memory is a compare-and-swap loop (21
// ATOMS.CAST.SPIN per f32 instantiation of a float hist_kernel, no
// ATOMS.ADD), which retries under contention on popular bins, while
// atomicAdd(int*) is one native ATOMS.ADD; with the same walk, grid and
// contention the int32 form ran 5.5x faster (0.0565 against 0.3108 ms at
// P=1M, F=28, B=64 on an H100 80GB HBM3 at 700 W, chip_smoke.py phases
// k1, k3). So hist_fixed_kernel adds f32 values as integers:
//
//   * a pre-pass over the block's own rows counts its live rows n and sums
//     |v| per lane (grad, hess, count) into S, in a fixed order;
//   * per lane, s = 30 - E where S < 2^E (frexp): x = v * 2^s is exact
//     (a power-of-two scale) and |x| < 2^30. The hi word is rint(x); the
//     residual x - hi is exact and at most 1/2, and the lo word is
//     rint((x - hi) * 2^L) with L = 31 - ceil(log2 n). Both are native
//     int32 shared atomics; a zero word is not added;
//   * at the flush each slot forms hi * 2^L + lo in int64, rounds it once
//     to f32 and scales it by 2^-(s + L), then adds it to the global
//     (F, B, 3) result with one native f32 global atomicAdd (RED.ADD.F32).
//
// No int32 slot can overflow: a slot gets at most one term per live row,
// so its hi words sum to at most S * 2^s + n / 2 < 2^30 (1 + 2^-15) + n / 2
// (S is an f32 sum of at most 2^16 terms: relative error < 2^-15) and its
// lo words to at most n * 2^(L-1) <= 2^30; launch_fixed grows the grid so
// that no block walks more than kMaxRowsPerBlock = 2^16 rows, which also
// keeps L >= 15.
//
// Numerics of the float kernel: each term is kept to 2^-(s + L + 1) =
// 2^(E + ceil(log2 n) - 62) absolute, at most 2^(ceil(log2 n) - 60) of the
// block's sum of |v| (2^-49 at the main path's ~1,900 rows per block),
// whatever the term's own size: the integer analogue of the TPU kernel's
// bf16 hi/lo split (lightgbm_tpu/ops/histogram.py:65-78), and finer than
// an f32 running sum, whose error grows with the slot's partial sum.
// Within a block the sums are integers and so independent of order; the
// blocks' f32 partials meet in global atomics in any order, so results may
// differ in the last bits from run to run. The count lane runs the same arithmetic; with integer
// weights (every caller passes 0 / 1) x = v * 2^s is an integer (s >= 13),
// lo is 0, and the counts are exact. Operand values must be finite, as
// gradients and hessians are. The integer kernel's lanes are associative,
// so K3 / K3t are bit-exact in any launch and atomic order, against the
// plain version and the TPU kernel; int32 cannot overflow, as quant_max
// caps qmax * N at 2^30.
//
// Codes are uint8, uint16 or int32 with element strides, so one kernel
// reads the byte view of the compact core's packed working rows ((P, F),
// row stride = the row's byte count) and the masked strategy's
// column-major codes ((F, P) seen as (P, F) with row stride 1 and column
// stride P: consecutive threads read consecutive code bytes). The float
// kernel reads a row's uint8 codes as whole 32-bit words where the row
// stride and the base are 4-byte aligned (the packed rows: 44 bytes at
// D = 11), and loads the codes of 16 features before their atomics, so
// that up to 16 loads are in flight together (the (F, N) view reads one
// byte per feature, each from another cache line).
//
// Bound on the H100: bytes. The function reads P*F code bytes and the
// operand (12*P bytes f32, 3*P int8) once and writes 12*F*B bytes, against
// 3*P*F adds; at F=28 that is under one add per byte, far below the card's
// balance point. The design reads every code word once and the operand
// twice (the float pre-pass; the second read mostly hits L2), with no
// one-hot in device memory. The launcher's grid (ops/kernels/histogram.py)
// holds two blocks per SM for the integer kernel and four for the float
// one, whose longer work per row between atomics needs more warps in
// flight (PERF.md has the times), so that the per-block flush (F*B*3
// global atomics) stays small next to the row traffic.
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

// Splits v into the hi and lo words of its block's fixed point (see the
// note at the top): x = v * 2^s, hi = rint(x), lo = rint((x - hi) * 2^L).
__device__ __forceinline__ void fixed_split(float v, int s, int L, int& hi,
                                            int& lo) {
  const float x = ldexpf(v, s);
  hi = __float2int_rn(x);
  lo = __float2int_rn(ldexpf(x - (float)hi, L));
}

constexpr int kWarps = kThreads / 32;
// the float kernel's feature tile: 48 KB of hi / lo words, so that four
// blocks fit on an SM (the launcher's grid for it)
constexpr int kFixedTileBytes = 48 * 1024;
constexpr int kMaxBlockSmemBytes = 227 * 1024;
// features whose codes one thread loads ahead of their atomics (a multiple
// of 4: whole 32-bit code words)
constexpr int kCodeChunk = 16;
// rows one block of the float kernel may walk: bounds its fixed-point words
// (see the note at the top)
constexpr long long kMaxRowsPerBlock = 1ll << 16;

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
hist_fixed_kernel(const CodeT* __restrict__ codes, long long P, int F,
                  long long row_stride, long long col_stride,
                  const float* __restrict__ gh, long long gh_stride, int B,
                  int feat_tile, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int slots = ft * B * 3;
  // dynamic shared memory: hi words, lo words, then the pre-pass's
  // per-warp sums (3 floats, 1 int each)
  int* hi_sh = reinterpret_cast<int*>(hist_smem);
  int* lo_sh = hi_sh + feat_tile * B * 3;
  float* warp_abs = reinterpret_cast<float*>(lo_sh + feat_tile * B * 3);
  int* warp_live = reinterpret_cast<int*>(warp_abs + 3 * kWarps);
  for (int i = threadIdx.x; i < 2 * feat_tile * B * 3; i += blockDim.x)
    hi_sh[i] = 0;

  // pre-pass: the block's live rows and per-lane sums of |v|, reduced in a
  // fixed order (thread, then warp shuffle, then warps in turn)
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long r0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  int live = 0;
  for (long long r = r0; r < P; r += step) {
    const float* g = gh + r * gh_stride;
    const float gv = g[0], hv = g[1], cv = g[2];
    if (gv == 0.f && hv == 0.f && cv == 0.f) continue;
    a0 += fabsf(gv);
    a1 += fabsf(hv);
    a2 += fabsf(cv);
    ++live;
  }
  for (int o = 16; o > 0; o >>= 1) {
    a0 += __shfl_xor_sync(0xffffffffu, a0, o);
    a1 += __shfl_xor_sync(0xffffffffu, a1, o);
    a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    live += __shfl_xor_sync(0xffffffffu, live, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_abs[3 * warp] = a0;
    warp_abs[3 * warp + 1] = a1;
    warp_abs[3 * warp + 2] = a2;
    warp_live[warp] = live;
  }
  __syncthreads();
  float S[3] = {0.f, 0.f, 0.f};
  int n = 0;
  for (int w = 0; w < kWarps; ++w) {
    for (int j = 0; j < 3; ++j) S[j] += warp_abs[3 * w + j];
    n += warp_live[w];
  }
  if (n == 0) return;  // every row of this block is zero: nothing to add
  const int L = 31 - (n > 1 ? 32 - __clz(n - 1) : 0);
  int sc[3];
  for (int j = 0; j < 3; ++j) {
    int E;
    frexpf(S[j], &E);
    sc[j] = 30 - E;
  }

  // the row walk: per live row, three hi / lo pairs; per feature, their
  // nonzero words into the code's slot
  const bool words = sizeof(CodeT) == 1 && col_stride == 1 &&
                     (row_stride & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes + f0) & 3) == 0;
  for (long long r = r0; r < P; r += step) {
    const float* g = gh + r * gh_stride;
    const float gv = g[0], hv = g[1], cv = g[2];
    if (gv == 0.f && hv == 0.f && cv == 0.f) continue;
    int h0, h1, h2, l0, l1, l2;
    fixed_split(gv, sc[0], L, h0, l0);
    fixed_split(hv, sc[1], L, h1, l1);
    fixed_split(cv, sc[2], L, h2, l2);
    const CodeT* row = codes + r * row_stride + (long long)f0 * col_stride;
    auto add = [&](int f, int code) {
      // codes outside [0, B) contribute nothing, as in the one-hot form
      if (code < 0 || code >= B) return;
      const int i = (f * B + code) * 3;
      if (h0) atomicAdd(hi_sh + i, h0);
      if (h1) atomicAdd(hi_sh + i + 1, h1);
      if (h2) atomicAdd(hi_sh + i + 2, h2);
      if (l0) atomicAdd(lo_sh + i, l0);
      if (l1) atomicAdd(lo_sh + i + 1, l1);
      if (l2) atomicAdd(lo_sh + i + 2, l2);
    };
    // the codes of up to kCodeChunk features are loaded before their
    // atomics, so that their loads are in flight together (the (F, N)
    // view reads one byte per feature, each from another cache line)
    for (int f = 0; f < ft; f += kCodeChunk) {
      const int m = min(kCodeChunk, ft - f);
      int c[kCodeChunk];
#pragma unroll
      for (int k = 0; k < kCodeChunk; k += 4) {
        if (words && k + 4 <= m) {
          const uint32_t q =
              reinterpret_cast<const uint32_t*>(row)[(f + k) >> 2];
          c[k] = q & 0xff;
          c[k + 1] = (q >> 8) & 0xff;
          c[k + 2] = (q >> 16) & 0xff;
          c[k + 3] = q >> 24;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            c[k + t] = k + t < m
                           ? (int)row[(long long)(f + k + t) * col_stride]
                           : -1;
        }
      }
#pragma unroll
      for (int k = 0; k < kCodeChunk; ++k) add(f + k, c[k]);
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * B * 3;
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int h = hi_sh[i], l = lo_sh[i];
    if (h == 0 && l == 0) continue;
    const long long t = (long long)h * (1ll << L) + l;
    const int j = i % 3;
    const int sj = j == 0 ? sc[0] : (j == 1 ? sc[1] : sc[2]);
    atomicAdd(o + i, ldexpf(__ll2float_rn(t), -(sj + L)));
  }
}

template <typename CodeT>
int launch_fixed(const void* codes, long long P, int F, long long row_stride,
                 long long col_stride, const void* gh, long long gh_stride,
                 int B, void* out, int grid_x, cudaStream_t stream) {
  // a tile of hi and lo words: 24 bytes per (feature, bin), at least one
  // feature, at most what a block may hold; whole 32-bit code words per
  // tile where four features fit
  const int tile_bytes = max(kFixedTileBytes, B * 24);
  if (tile_bytes + kWarps * 16 > kMaxBlockSmemBytes)
    return (int)cudaErrorInvalidValue;
  int feat_tile = tile_bytes / (B * 24);
  if (feat_tile > F) feat_tile = F;
  if (feat_tile < F && feat_tile >= 4) feat_tile &= ~3;
  const size_t smem = (size_t)feat_tile * B * 24 + kWarps * 16;
  const long long min_grid = (P + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock;
  if (grid_x < min_grid) grid_x = (int)min_grid;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_fixed_kernel<CodeT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(grid_x, (F + feat_tile - 1) / feat_tile);
  hist_fixed_kernel<CodeT><<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), P, F, row_stride, col_stride,
      static_cast<const float*>(gh), gh_stride, B, feat_tile,
      static_cast<float*>(out));
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
    case 0:  // f32: the fixed-point kernel
      switch (code_bytes) {
        case 1:
          return launch_fixed<uint8_t>(codes, P, F, row_stride, col_stride,
                                       gh, gh_stride, B, out, grid_x, s);
        case 2:
          return launch_fixed<uint16_t>(codes, P, F, row_stride, col_stride,
                                        gh, gh_stride, B, out, grid_x, s);
        case 4:
          return launch_fixed<int32_t>(codes, P, F, row_stride, col_stride,
                                       gh, gh_stride, B, out, grid_x, s);
        default:
          return (int)cudaErrorInvalidValue;
      }
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
