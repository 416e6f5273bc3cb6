// K1 / K2 / K3 / K3t: per-(feature, bin) histograms of [grad, hess, count]
// for Hopper, float or exact integer.
//
// Replaces, in lightgbm_tpu/ops/pallas/histogram_kernel.py:
//   * _hist_kernel, the body of build_histogram_pallas (K1, (P, F) codes)
//     and build_histogram_pallas_t (K2, (F, P) codes): f32 operand, f32
//     sums (hist_fixed_kernel below);
//   * _hist_kernel_q, the body of build_histogram_pallas_quantized (K3) and
//     build_histogram_pallas_quantized_t (K3t): int8 (grad_bits <= 8) or
//     int32 operand [qg, qh, valid], exact int32 sums (hist_int_kernel);
//     and, counted as K3, the compact core's operand build fused into it:
//     lightgbm_tpu/models/device_learner.py _quant_win_operand followed by
//     K3 (hist_rows_kernel, which reads the packed quantized rows in place).
// The TPU kernels build a one-hot tile in VMEM and contract it with the
// operand on the MXU, because the TPU has no scatter atomics. Hopper has
// fast shared-memory atomics, so every kernel here is the per-workgroup
// local-memory histogram of the reference's histogram256.cl:
//
//   * each block zeroes a (feature tile x B) histogram of int32 slot words
//     in shared memory (up to 96 KB of them, more only where one feature
//     needs more, feature-tiled over blockIdx.y when F features exceed
//     that);
//   * threads walk the rows grid-stride; a row whose operand is all zero
//     (outside the leaf, on the masked strategy) is skipped before its
//     codes are read; the others load the codes of up to 16 features
//     (kCodeChunk) before their atomics, so those loads are in flight
//     together, and atomicAdd their lanes into each feature's bin;
//   * the blocks' tiles then meet in the global result (the integer
//     kernels: see below).
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
// gradients and hessians are.
//
// The integer kernels (hist_int_kernel, hist_rows_kernel). Every lane is
// an integer, so K3 / K3t and the packed-row entry are bit-exact in any
// launch and atomic order, against the plain version and the TPU kernel.
// What holds them is the rate of shared-memory atomics (a 64-bit one is a
// CAS loop on sm_90a, so 32-bit words it is), then the row loads, which do
// not overlap with the atomics (PERF.md); the design:
//
//   * Two atomics per (row, feature) where the lanes allow it. Where qg,
//     qh lie in [-128, 127] -- the int8 operand, and the packed-row entry at
//     qcap_op <= 127, whose count is 1 -- qg goes to one word of the slot
//     and w = qh * 2^k + valid to another, k = kPackShift = 13, for a valid
//     lane of 0 or 1 (every caller's: ops/quantize.py gh_operand,
//     gh_operand_scaled). A row of the int8 operand whose valid lane is any
//     other value (the contract takes any int8) adds qh * 2^k to w, and its
//     valid, whole, to the slot's third word in a second walk that only a
//     block holding such a row takes; the flush adds the third words of
//     those blocks to the count. Over the n <= R rows of a block that hit
//     the slot, w sums to W = H * 2^k + C with 0 <= C <= R and -128 R <= H
//     <= 127 R. With R = kMaxPackedRowsPerBlock = 2,048 (8 rows per
//     thread) that is H in [-2^18, 2^18) and C in [0, 2^11], so W stays
//     inside int32 and the flush decodes it exactly: C is the low k bits
//     sign-extended (their range [-2^12, 2^12) holds C), H = (W - C) >>
//     k. The qg word and the third word sum to at most 2^18 in
//     magnitude. The launcher grows the grid so that no block walks more
//     than R rows. Negative hessians (a custom objective) need nothing
//     more: the bound is on |qh|. The int32 operand (grad_bits 16: |q| up
//     to quant_max, at most 2^30 / N) and the packed-row entry above 127
//     keep three atomics; quant_max caps qmax * N at 2^30, so no int32 sum
//     can overflow. Blocks' sums meet modulo 2^32, as the plain version's
//     int64 sums cast to int32 do.
//   * Slots of three words (a packing kernel uses two): the odd stride
//     spreads a warp's adds to one feature's bins over all 32 banks, and a
//     slot's words sit at immediate offsets from one address. The adds are
//     not predicated on a nonzero lane (a zero adds nothing; the branch
//     cost more than the add).
//   * The flush of a packing kernel: blocks run in thread-block clusters
//     of kCluster = 8, whose tiles meet in distributed shared memory; each
//     block sums an eighth of the output words over the 8 tiles and adds
//     each nonzero sum with one coalesced global atomic: at the root 62
//     clusters add 5,376 words each, where 496 lone blocks would add 8
//     times as many. A three-word kernel's tiles are large (two blocks per
//     SM at 256 bins): clusters of them would leave SMs idle, so each of
//     its blocks flushes alone.
//   * The launcher owns the output's initialisation: a grid of one
//     cluster (up to 2,048 rows when packing) stores every output word, a
//     larger one adds into an output the launcher zeroes first
//     (cudaMemsetAsync on the launch's stream), so the caller passes an
//     uninitialised buffer.
//   * One wave: the launcher cuts the grid to the clusters the card holds
//     at once (cudaOccupancyMaxActiveClusters; a partial second wave of
//     clusters costs more than fewer blocks walking more rows).
//   * The packed-row entry (hist_rows_kernel) reads the compact core's
//     working rows -- code words | (qg << 16 | qh) word | row id, D int32
//     words -- in place: qg is the arithmetic high half of word cw, qh its
//     sign-extended low half, each re-quantized as clamp(rint(q * r),
//     -qcap_op, qcap_op) in f32 with round-half-even (rintf of one
//     __fmul_rn, no contraction: torch.round of the f32 product), r read
//     from device memory; the count is 1. Codes are the row's 4-, 8- or
//     16-bit fields (code f is field f % (32 / bits) of word f / (32 /
//     bits), low field first), read as whole 32-bit words. This replaces
//     the ~18 separate tensor launches of the two-step operand build.
//
// Codes of K1 / K2 / K3 / K3t are uint8, uint16 or int32 with element
// strides, so one kernel reads the byte view of the compact core's packed
// working rows ((P, F), row stride = the row's byte count) and the masked
// strategy's column-major codes ((F, P) seen as (P, F) with row stride 1
// and column stride P: consecutive threads read consecutive code bytes).
// A row's codes are read as whole 32-bit words where the row stride and
// the base are 4-byte aligned (every packed row); the (F, N) view reads
// one code per feature, each from another cache line, 16 loads at once.
//
// Bound on the H100: bytes. The function reads P*F code bytes and the
// operand (12*P bytes f32, 3*P int8, or the rows' 4*D*P) once and writes
// 12*F*B bytes, against 3*P*F adds; at F=28 that is under one add per
// byte, far below the card's balance point. The design reads every code
// word once and the operand twice for the float kernel (its pre-pass; the
// second read mostly hits L2), once for the integer ones, with no one-hot
// in device memory. PERF.md has the times and the variants measured.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 96 * 1024;
// split descriptor fields read by the device-window entries
// (ops/kernels/desc.py; the tests read these)
constexpr int kDescGo = 0;
constexpr int kDescSrc = 1;
constexpr int kDescBegin = 2;
constexpr int kDescCount = 3;
constexpr int kDescLphys = 4;
constexpr int kDescLeftSmall = 5;

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

// One block's part of a float histogram over P rows: row_gh(r, g, h, c)
// gives a row's three f32 lanes, row_codes(r, f, m, code) its codes of
// tile features [f, f + m) (-1 past m). `out` is the tile's (ft, B, 3),
// zeroed by the launcher; feat_tile sizes the shared-memory tile.
template <typename RowGh, typename RowCodes>
__device__ __forceinline__ void fixed_hist_body(long long P, int ft, int B,
                                                int feat_tile,
                                                float* __restrict__ out,
                                                RowGh row_gh,
                                                RowCodes row_codes) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
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
    float gv, hv, cv;
    row_gh(r, gv, hv, cv);
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
  for (long long r = r0; r < P; r += step) {
    float gv, hv, cv;
    row_gh(r, gv, hv, cv);
    if (gv == 0.f && hv == 0.f && cv == 0.f) continue;
    int h0, h1, h2, l0, l1, l2;
    fixed_split(gv, sc[0], L, h0, l0);
    fixed_split(hv, sc[1], L, h1, l1);
    fixed_split(cv, sc[2], L, h2, l2);
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
    // atomics, so that their loads are in flight together
    for (int f = 0; f < ft; f += kCodeChunk) {
      int c[kCodeChunk];
      row_codes(r, f, min(kCodeChunk, ft - f), c);
#pragma unroll
      for (int k = 0; k < kCodeChunk; ++k) add(f + k, c[k]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    const int h = hi_sh[i], l = lo_sh[i];
    if (h == 0 && l == 0) continue;
    const long long t = (long long)h * (1ll << L) + l;
    const int j = i % 3;
    const int sj = j == 0 ? sc[0] : (j == 1 ? sc[1] : sc[2]);
    atomicAdd(out + i, ldexpf(__ll2float_rn(t), -(sj + L)));
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
hist_fixed_kernel(const CodeT* __restrict__ codes, long long P, int F,
                  long long row_stride, long long col_stride,
                  const float* __restrict__ gh, long long gh_stride, int B,
                  int feat_tile, float* __restrict__ out) {
  const int f0 = blockIdx.y * feat_tile;
  const bool words = sizeof(CodeT) == 1 && col_stride == 1 &&
                     (row_stride & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes + f0) & 3) == 0;
  fixed_hist_body(
      P, min(feat_tile, F - f0), B, feat_tile, out + (long long)f0 * B * 3,
      [=](long long r, float& gv, float& hv, float& cv) {
        const float* g = gh + r * gh_stride;
        gv = g[0];
        hv = g[1];
        cv = g[2];
      },
      // the (F, N) view reads one byte per feature, each from another
      // cache line
      [=](long long r, int f, int m, int (&c)[kCodeChunk]) {
        const CodeT* row = codes + r * row_stride + (long long)f0 * col_stride;
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
      });
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
  // the blocks add into out
  const cudaError_t z = cudaMemsetAsync(out, 0, (size_t)F * B * 12, stream);
  if (z != cudaSuccess) return (int)z;
  dim3 grid(grid_x, (F + feat_tile - 1) / feat_tile);
  hist_fixed_kernel<CodeT><<<grid, kThreads, smem, stream>>>(
      static_cast<const CodeT*>(codes), P, F, row_stride, col_stride,
      static_cast<const float*>(gh), gh_stride, B, feat_tile,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---- the integer kernels ------------------------------------------------

// a packed slot word is qh * 2^kPackShift + valid; rows one block of a
// packing instantiation may walk (see the note at the top)
constexpr int kPackShift = 13;
constexpr long long kMaxPackedRowsPerBlock = 8 * kThreads;
// blocks of one thread-block cluster of a packing kernel, which sum their
// tiles through distributed shared memory before one global atomic per
// output word; a three-word kernel's tiles are large (two blocks per SM at
// 256 bins), clusters of them would leave SMs idle, and each of its blocks
// flushes on its own (a cluster of one)
constexpr int kCluster = 8;

__host__ __device__ constexpr int cluster_size(bool pack) {
  return pack ? kCluster : 1;
}
// blocks per SM the integer kernels' registers leave room for (the
// wrapper's grid, ops/kernels/histogram.py _BLOCKS_PER_SM)
constexpr int kIntBlocksPerSM = 4;

// The codes of features [f, f + m) of one row of a strided view, m <=
// kCodeChunk, into c (-1 past m): whole 32-bit words where `words` (unit
// column stride, 4-byte aligned row starts) and the word holds only
// features below m, else one element load each.
template <typename CodeT>
__device__ __forceinline__ void strided_codes(const CodeT* row,
                                              long long col_stride,
                                              bool words, int f, int m,
                                              int (&c)[kCodeChunk]) {
  constexpr int per = sizeof(CodeT) < 4 ? 4 / (int)sizeof(CodeT) : 1;
  constexpr uint32_t mask = sizeof(CodeT) == 1 ? 0xffu : 0xffffu;
#pragma unroll
  for (int k = 0; k < kCodeChunk; k += per) {
    if (per > 1 && words && k + per <= m) {
      const uint32_t q =
          reinterpret_cast<const uint32_t*>(row)[(f + k) / per];
#pragma unroll
      for (int t = 0; t < per; ++t)
        c[k + t] = (int)((q >> (t * 8 * (int)sizeof(CodeT))) & mask);
    } else {
#pragma unroll
      for (int t = 0; t < per; ++t)
        c[k + t] = k + t < m
                       ? (int)row[(long long)(f + k + t) * col_stride]
                       : -1;
    }
  }
}

// The codes of features [f, f + m) from a packed row's code words of kBits
// fields each (feature f0 of the tile at field 0 of codes[0]), into c (-1
// past m). A word holding any feature below m lies in the row's code words.
template <int kBits>
__device__ __forceinline__ void word_codes(const uint32_t* codes, int f,
                                           int m, int (&c)[kCodeChunk]) {
  constexpr int per = 32 / kBits;
  constexpr uint32_t mask = (1u << kBits) - 1u;
#pragma unroll
  for (int k = 0; k < kCodeChunk; k += per) {
    const uint32_t q = k < m ? codes[(f + k) / per] : 0u;
#pragma unroll
    for (int t = 0; t < per; ++t)
      c[k + t] = k + t < m ? (int)((q >> (t * kBits)) & mask) : -1;
  }
}

// clamp(rint(q * r), -cap, cap) in f32, as torch.round(q.float() * r)
// .clamp(-cap, cap): one rounded multiply (never contracted), then round
// half to even
__device__ __forceinline__ int requant(int q, float r, float cap) {
  return (int)fminf(fmaxf(rintf(__fmul_rn((float)q, r)), -cap), cap);
}

// The rows of one block's walk (from r0 by step) whose valid lane is not 0
// / 1 (no caller builds one): their valid, whole, into the third word of
// each code's slot.
template <typename RowOp, typename RowCodes>
__device__ __forceinline__ void add_odd_valid(long long r0, long long step,
                                           long long P, int ft, int B,
                                           int* sh, RowOp row_op,
                                           RowCodes row_codes) {
  for (long long r = r0; r < P; r += step) {
    int g, h, c;
    if (!row_op(r, g, h, c) || (unsigned)c <= 1u) continue;
    for (int f = 0; f < ft; f += kCodeChunk) {
      int code[kCodeChunk];
      row_codes(r, f, min(kCodeChunk, ft - f), code);
#pragma unroll
      for (int k = 0; k < kCodeChunk; ++k)
        if ((unsigned)code[k] < (unsigned)B)
          atomicAdd(sh + ((f + k) * B + code[k]) * 3 + 2, c);
    }
  }
}

// One block's part of an integer histogram over P rows: row_op(r, g, h, c)
// gives a row's lanes (false: a zero row, whose codes are not read),
// row_codes(r, f, m, code) its codes of tile features [f, f + m). A slot
// is three int32 words (a packing kernel uses two of them, and the third
// for a valid lane other than 0 / 1 where kOddValid): the odd stride
// spreads a warp's adds to one feature's bins over all 32 banks, and the
// lanes' words sit at immediate offsets from one address. One int after
// the tile says whether the block met such a valid lane. `out` is the
// tile's (ft, B, 3); where the grid is one cluster along x, every word of
// it is stored, else added (the launcher zeroed it).
template <bool kPack, bool kOddValid, typename RowOp, typename RowCodes>
__device__ __forceinline__ void int_hist_body(long long P, int ft, int B,
                                              int* __restrict__ sh,
                                              int* __restrict__ out,
                                              RowOp row_op,
                                              RowCodes row_codes) {
  constexpr int kWords = 3;
  const int slots = ft * B;
  int* odd_sh = sh + slots * kWords;
  for (int i = threadIdx.x; i < slots * kWords; i += kThreads) sh[i] = 0;
  __syncthreads();

  const long long step = (long long)gridDim.x * kThreads;
  const long long r0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool odd = false;
  for (long long r = r0; r < P; r += step) {
    int g, h, c;
    if (!row_op(r, g, h, c)) continue;
    // a valid lane of 0 or 1 rides in qh's word; another value is added
    // after the walk
    const int cp = kPack && (!kOddValid || (unsigned)c <= 1u) ? c : 0;
    if (kOddValid) odd |= c != cp;
    const int hc = kPack ? h * (1 << kPackShift) + cp : 0;
    for (int f = 0; f < ft; f += kCodeChunk) {
      int code[kCodeChunk];
      row_codes(r, f, min(kCodeChunk, ft - f), code);
#pragma unroll
      for (int k = 0; k < kCodeChunk; ++k) {
        // codes outside [0, B) contribute nothing, as in the one-hot form
        if ((unsigned)code[k] >= (unsigned)B) continue;
        int* s = sh + ((f + k) * B + code[k]) * 3;
        atomicAdd(s, g);
        if (kPack) {
          atomicAdd(s + 1, hc);
        } else {
          atomicAdd(s + 1, h);
          atomicAdd(s + 2, c);
        }
      }
    }
  }
  if (kOddValid) {
    const int any = __syncthreads_or(odd);
    if (any) add_odd_valid(r0, step, P, ft, B, sh, row_op, row_codes);
    if (threadIdx.x == 0) *odd_sh = any;
  }

  // the flush: the cluster's kCs tiles meet in distributed shared memory
  // (a cluster of one reads its own); block `rank` sums output words
  // rank * kThreads + t + k * kCs * kThreads over every tile (each tile's
  // packed word decoded on its own) and adds each nonzero sum with one
  // global atomic, so consecutive threads add consecutive words
  constexpr int kCs = cluster_size(kPack);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (kCs > 1)
    cluster.sync();
  else
    __syncthreads();
  const int rank = kCs > 1 ? (int)cluster.block_rank() : 0;
  const bool store = gridDim.x == kCs;
  // the tiles whose third words hold valid lanes other than 0 / 1
  unsigned odd_tiles = 0;
  if (kOddValid) {
#pragma unroll
    for (int q = 0; q < kCs; ++q)
      odd_tiles |= (unsigned)(*(kCs > 1 ? cluster.map_shared_rank(odd_sh, q)
                                        : odd_sh) != 0) << q;
  }
#pragma unroll 4
  for (int j = rank * kThreads + threadIdx.x; j < 3 * slots;
       j += kCs * kThreads) {
    const int slot = j / 3, lane = j - 3 * slot;
    int v = 0;
#pragma unroll
    for (int q = 0; q < kCs; ++q) {
      const int* t =
          (kCs > 1 ? cluster.map_shared_rank(sh, q) : sh) + slot * kWords;
      if (!kPack || lane == 0) {
        v += t[lane];
      } else {
        const int w = t[1];
        const int c =
            (int)((unsigned)w << (32 - kPackShift)) >> (32 - kPackShift);
        v += lane == 2 ? c : (w - c) >> kPackShift;
      }
    }
    if (kOddValid && odd_tiles && lane == 2) {
      for (int q = 0; q < kCs; ++q)
        if ((odd_tiles >> q) & 1u)
          v += (kCs > 1 ? cluster.map_shared_rank(sh, q)
                        : sh)[slot * kWords + 2];
    }
    if (store)
      out[j] = v;
    else if (v)
      atomicAdd(out + j, v);
  }
  // no block leaves while another reads its tile
  if (kCs > 1) cluster.sync();
}

// K3 / K3t: (P, F) codes of any element strides + a (P, 3) operand.
template <typename CodeT, typename OpT, bool kPack>
__global__ void __launch_bounds__(kThreads, kIntBlocksPerSM)
hist_int_kernel(const CodeT* __restrict__ codes, long long P, int F,
                long long row_stride, long long col_stride,
                const OpT* __restrict__ gh, long long gh_stride, int B,
                int feat_tile, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
  const int f0 = blockIdx.y * feat_tile;
  const CodeT* base = codes + (long long)f0 * col_stride;
  const bool words =
      sizeof(CodeT) < 4 && col_stride == 1 &&
      ((row_stride * (long long)sizeof(CodeT)) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(base) & 3) == 0;
  int_hist_body<kPack, kPack>(
      P, min(feat_tile, F - f0), B, reinterpret_cast<int*>(hist_smem),
      out + (long long)f0 * B * 3,
      [=](long long r, int& g, int& h, int& c) {
        const OpT* p = gh + r * gh_stride;
        g = (int)p[0];
        h = (int)p[1];
        c = (int)p[2];
        return (g | h | c) != 0;
      },
      [=](long long r, int f, int m, int (&cd)[kCodeChunk]) {
        strided_codes(base + r * row_stride, col_stride, words, f, m, cd);
      });
}

// The packed-row entry: (W, D) int32 rows, codes of kBits in words [0, cw),
// the (qg << 16 | qh) word at cw; re-quantized at the ratios *r_g, *r_h.
template <int kBits, bool kPack>
__device__ __forceinline__ void rows_hist_body(
    const int* __restrict__ rows, long long W, int D, int cw, int c_cols,
    const float* __restrict__ r_g, const float* __restrict__ r_h,
    int qcap_op, int B, int feat_tile, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char hist_smem[];
  const int f0 = blockIdx.y * feat_tile;
  const float rg = *r_g, rh = *r_h, cap = (float)qcap_op;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(rows) + f0 / (32 / kBits);
  int_hist_body<kPack, false>(
      W, min(feat_tile, c_cols - f0), B, reinterpret_cast<int*>(hist_smem),
      out + (long long)f0 * B * 3,
      [=](long long r, int& g, int& h, int& c) {
        const int w = rows[r * D + cw];
        const int lo = w & 0xffff;
        g = requant(w >> 16, rg, cap);
        h = requant(lo >= 0x8000 ? lo - 0x10000 : lo, rh, cap);
        c = 1;
        return true;
      },
      [=](long long r, int f, int m, int (&cd)[kCodeChunk]) {
        word_codes<kBits>(words + r * D, f, m, cd);
      });
}

template <int kBits, bool kPack>
__global__ void __launch_bounds__(kThreads, kIntBlocksPerSM)
hist_rows_kernel(const int* __restrict__ rows, long long W, int D, int cw,
                 int c_cols, const float* __restrict__ r_g,
                 const float* __restrict__ r_h, int qcap_op, int B,
                 int feat_tile, int* __restrict__ out) {
  rows_hist_body<kBits, kPack>(rows, W, D, cw, c_cols, r_g, r_h, qcap_op, B,
                               feat_tile, out);
}

// The device-window entries read their rows from the split descriptor
// (ops/kernels/desc.py): the smaller child of the split, which the
// partition kernel has just moved to the other buffer -- rows [begin +
// (left_small ? 0 : lphys), + (left_small ? lphys : count - lphys)) of
// buffer 1 - src. A descriptor whose go is 0 returns at once (every block
// alike); the root's descriptor names all rows of buffer 0.
struct DescWindow {
  const int* rows;
  long long n;
};

__device__ __forceinline__ DescWindow desc_window(const int* buf0,
                                                  const int* buf1,
                                                  const int* desc, int D) {
  const long long begin = desc[kDescBegin], count = desc[kDescCount];
  const long long lphys = desc[kDescLphys];
  const bool left_small = desc[kDescLeftSmall] != 0;
  const long long off = begin + (left_small ? 0 : lphys);
  return {(desc[kDescSrc] ? buf0 : buf1) + off * D,
          left_small ? lphys : count - lphys};
}

template <int kBits, bool kPack>
__global__ void __launch_bounds__(kThreads, kIntBlocksPerSM)
hist_rows_window_kernel(const int* buf0, const int* buf1,
                        const int* __restrict__ desc, int D, int cw,
                        int c_cols, const float* __restrict__ r_g,
                        const float* __restrict__ r_h, int qcap_op, int B,
                        int feat_tile, int* __restrict__ out) {
  if (!desc[kDescGo]) return;
  const DescWindow win = desc_window(buf0, buf1, desc, D);
  rows_hist_body<kBits, kPack>(win.rows, win.n, D, cw, c_cols, r_g, r_h,
                               qcap_op, B, feat_tile, out);
}

// K1 over the same window: codes of kBits in words [0, cw), the f32
// (grad, hess, weight) at words cw .. cw + 2.
template <int kBits>
__global__ void __launch_bounds__(kThreads)
hist_fixed_window_kernel(const int* buf0, const int* buf1,
                         const int* __restrict__ desc, int D, int cw,
                         int c_cols, int B, int feat_tile,
                         float* __restrict__ out) {
  if (!desc[kDescGo]) return;
  const DescWindow win = desc_window(buf0, buf1, desc, D);
  const int* rows = win.rows;
  const int f0 = blockIdx.y * feat_tile;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(rows) + f0 / (32 / kBits);
  fixed_hist_body(
      win.n, min(feat_tile, c_cols - f0), B, feat_tile,
      out + (long long)f0 * B * 3,
      [=](long long r, float& gv, float& hv, float& cv) {
        const float* g = reinterpret_cast<const float*>(rows + r * D + cw);
        gv = g[0];
        hv = g[1];
        cv = g[2];
      },
      [=](long long r, int f, int m, int (&c)[kCodeChunk]) {
        word_codes<kBits>(words + r * D, f, m, c);
      });
}

// The integer kernels' feature tile: at most kMaxSmemBytes of slot words,
// a multiple of `align` features (whole code words of a packed row) where
// F needs more than one tile, at least `align`; 0 where that and the 16
// bytes after it (the block's flag) do not fit a block's shared memory.
int int_feat_tile(int F, int B, int slot_bytes, int align) {
  int t = kMaxSmemBytes / (B * slot_bytes);
  if (t >= F) return F;
  t = t >= 8 ? t & ~7 : t - t % align;
  if (t < align) t = align;
  if ((long long)t * B * slot_bytes + 16 > kMaxBlockSmemBytes) return 0;
  return t;
}

// Clusters of `cs` blocks of `kernel` at `smem` bytes that the card holds
// at once (cudaOccupancyMaxActiveClusters, cached per device, kernel and
// size); 0 where the query fails.
template <typename Kernel>
int max_clusters(Kernel kernel, size_t smem, int cs) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const auto key = std::make_tuple(
      dev, reinterpret_cast<const void*>(kernel), smem + ((size_t)cs << 40));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    n = 0;
  }
  cache[key] = n;
  return n;
}

// The launch shape of an integer kernel: feature tile, shared bytes, grid.
// The grid along x is whole clusters: the wrapper's grid_x, cut to the
// clusters the card holds at once (one wave: a partial second wave of
// clusters costs more than fewer blocks walking more rows), but grown so
// that a packing kernel's block walks at most kMaxPackedRowsPerBlock rows.
// Returns a CUDA error, 0 on success.
template <bool kPack, typename Kernel>
int int_launch_shape(Kernel kernel, long long P, int F, int B, int align,
                     int grid_x, int& feat_tile, size_t& smem, dim3& grid) {
  feat_tile = int_feat_tile(F, B, 12, align);
  if (feat_tile < 1) return (int)cudaErrorInvalidValue;
  smem = (size_t)feat_tile * B * 12 + 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (F + feat_tile - 1) / feat_tile;
  const int cs = cluster_size(kPack);
  grid_x = (grid_x + cs - 1) / cs * cs;
  const int wave = max_clusters(kernel, smem, cs) / tiles * cs;
  if (wave >= cs && grid_x > wave) grid_x = wave;
  if (kPack) {
    const long long min_grid =
        (P + kMaxPackedRowsPerBlock - 1) / kMaxPackedRowsPerBlock;
    if (grid_x < min_grid) grid_x = (int)min_grid;
  }
  grid_x = (grid_x + cs - 1) / cs * cs;
  grid = dim3(grid_x, tiles);
  return 0;
}

// Launches an integer kernel in clusters of `cs` blocks along x, into
// `out` of `out_bytes`: a grid of more than one cluster adds into it, so
// it is zeroed first on the same stream.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), dim3 grid, size_t smem,
                     int cs, void* out, size_t out_bytes, cudaStream_t s,
                     Args... args) {
  if ((int)grid.x > cs) {
    const cudaError_t e = cudaMemsetAsync(out, 0, out_bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename CodeT, typename OpT, bool kPack>
int launch_operand(const void* codes, long long P, int F,
                   long long row_stride, long long col_stride,
                   const void* gh, long long gh_stride, int B, void* out,
                   int grid_x, cudaStream_t s) {
  auto kernel = hist_int_kernel<CodeT, OpT, kPack>;
  int feat_tile;
  size_t smem;
  dim3 grid;
  const int e = int_launch_shape<kPack>(kernel, P, F, B, 1, grid_x,
                                        feat_tile, smem, grid);
  if (e) return e;
  return launch_clustered(
      kernel, grid, smem, cluster_size(kPack), out, (size_t)F * B * 12, s,
      static_cast<const CodeT*>(codes), P, F,
      row_stride, col_stride, static_cast<const OpT*>(gh), gh_stride, B,
      feat_tile, static_cast<int*>(out));
}

// int8 operands pack, int32 ones do not
template <typename OpT>
int launch_codes(const void* codes, int code_bytes, long long P, int F,
                 long long row_stride, long long col_stride, const void* gh,
                 long long gh_stride, int B, void* out, int grid_x,
                 cudaStream_t s) {
  constexpr bool pack = sizeof(OpT) == 1;
  switch (code_bytes) {
    case 1:
      return launch_operand<uint8_t, OpT, pack>(codes, P, F, row_stride,
                                                col_stride, gh, gh_stride, B,
                                                out, grid_x, s);
    case 2:
      return launch_operand<uint16_t, OpT, pack>(codes, P, F, row_stride,
                                                 col_stride, gh, gh_stride,
                                                 B, out, grid_x, s);
    case 4:
      return launch_operand<int32_t, OpT, pack>(codes, P, F, row_stride,
                                                col_stride, gh, gh_stride, B,
                                                out, grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int kBits, bool kPack>
int launch_rows(const void* rows, long long W, int D, int cw, int c_cols,
                const void* r_g, const void* r_h, int qcap_op, int B,
                void* out, int grid_x, cudaStream_t s) {
  auto kernel = hist_rows_kernel<kBits, kPack>;
  int feat_tile;
  size_t smem;
  dim3 grid;
  const int e = int_launch_shape<kPack>(kernel, W, c_cols, B, 32 / kBits,
                                        grid_x, feat_tile, smem, grid);
  if (e) return e;
  return launch_clustered(
      kernel, grid, smem, cluster_size(kPack), out, (size_t)c_cols * B * 12,
      s, static_cast<const int*>(rows), W, D, cw,
      c_cols, static_cast<const float*>(r_g), static_cast<const float*>(r_h),
      qcap_op, B, feat_tile, static_cast<int*>(out));
}

template <int kBits>
int launch_rows_bits(const void* rows, long long W, int D, int cw,
                     int c_cols, const void* r_g, const void* r_h,
                     int qcap_op, int B, void* out, int grid_x,
                     cudaStream_t s) {
  // lanes clamped to |q| <= qcap_op <= 127 pack, as the int8 operand does
  if (qcap_op <= 127)
    return launch_rows<kBits, true>(rows, W, D, cw, c_cols, r_g, r_h,
                                    qcap_op, B, out, grid_x, s);
  return launch_rows<kBits, false>(rows, W, D, cw, c_cols, r_g, r_h,
                                   qcap_op, B, out, grid_x, s);
}

// The integer window entry at the shape of the largest window, n_max
// rows: packing kernels grow the grid so that no block walks more than
// kMaxPackedRowsPerBlock of them.
template <int kBits, bool kPack>
int launch_rows_window(const void* buf0, const void* buf1, const void* desc,
                       long long n_max, int D, int cw, int c_cols,
                       const void* r_g, const void* r_h, int qcap_op, int B,
                       void* out, int grid_x, cudaStream_t s) {
  auto kernel = hist_rows_window_kernel<kBits, kPack>;
  int feat_tile;
  size_t smem;
  dim3 grid;
  const int e = int_launch_shape<kPack>(kernel, n_max, c_cols, B, 32 / kBits,
                                        grid_x, feat_tile, smem, grid);
  if (e) return e;
  return launch_clustered(
      kernel, grid, smem, cluster_size(kPack), out, (size_t)c_cols * B * 12,
      s, static_cast<const int*>(buf0), static_cast<const int*>(buf1),
      static_cast<const int*>(desc), D, cw, c_cols,
      static_cast<const float*>(r_g), static_cast<const float*>(r_h), qcap_op,
      B, feat_tile, static_cast<int*>(out));
}

template <int kBits>
int launch_window_bits(const void* buf0, const void* buf1, const void* desc,
                       long long n_max, int D, int cw, int c_cols, int quant,
                       const void* r_g, const void* r_h, int qcap_op, int B,
                       void* out, int grid_x, cudaStream_t s) {
  if (quant) {
    // lanes clamped to |q| <= qcap_op <= 127 pack, as the int8 operand does
    if (qcap_op <= 127)
      return launch_rows_window<kBits, true>(buf0, buf1, desc, n_max, D, cw,
                                             c_cols, r_g, r_h, qcap_op, B,
                                             out, grid_x, s);
    return launch_rows_window<kBits, false>(buf0, buf1, desc, n_max, D, cw,
                                            c_cols, r_g, r_h, qcap_op, B, out,
                                            grid_x, s);
  }
  const int align = 32 / kBits;
  // the float kernel's feature tile: whole code words where F needs more
  // than one tile
  int feat_tile = kFixedTileBytes / (B * 24);
  if (feat_tile >= c_cols) {
    feat_tile = c_cols;
  } else {
    feat_tile -= feat_tile % align;
    if (feat_tile < align) feat_tile = align;
  }
  const size_t smem = (size_t)feat_tile * B * 24 + kWarps * 16;
  if (smem > (size_t)kMaxBlockSmemBytes) return (int)cudaErrorInvalidValue;
  const long long min_grid = (n_max + kMaxRowsPerBlock - 1) / kMaxRowsPerBlock;
  if (grid_x < min_grid) grid_x = (int)min_grid;
  auto kernel = hist_fixed_window_kernel<kBits>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // the blocks add into out
  const cudaError_t z = cudaMemsetAsync(out, 0, (size_t)c_cols * B * 12, s);
  if (z != cudaSuccess) return (int)z;
  kernel<<<dim3(grid_x, (c_cols + feat_tile - 1) / feat_tile), kThreads, smem,
           s>>>(static_cast<const int*>(buf0), static_cast<const int*>(buf1),
                static_cast<const int*>(desc), D, cw, c_cols, B, feat_tile,
                static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// codes: (P, F) bin codes of `code_bytes` bytes each (1: uint8, 2: uint16,
// 4: int32), element strides row_stride / col_stride. gh: (P, 3) operand
// with unit column stride and row stride gh_stride, of kind `op_kind`:
// 0 = f32 (out f32), 1 = int8 (out int32), 2 = int32 (out int32). out:
// (F, B, 3), initialised by the launcher (any contents on entry).
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
      return launch_codes<int8_t>(codes, code_bytes, P, F, row_stride,
                                  col_stride, gh, gh_stride, B, out, grid_x,
                                  s);
    case 2:
      return launch_codes<int32_t>(codes, code_bytes, P, F, row_stride,
                                   col_stride, gh, gh_stride, B, out, grid_x,
                                   s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The packed-row entry: rows (W, D) int32, contiguous, codes of item_bits
// (4, 8 or 16) in words [0, cw) with c_cols codes, the (qg << 16 | qh) word
// at cw; r_g, r_h: device pointers to the f32 ratios; out: (c_cols, B, 3)
// int32, initialised by the launcher.
extern "C" int lgbt_hist_rows_launch(const void* rows, long long W, int D,
                                     int cw, int c_cols, int item_bits,
                                     const void* r_g, const void* r_h,
                                     int qcap_op, int B, void* out,
                                     int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (item_bits) {
    case 4:
      return launch_rows_bits<4>(rows, W, D, cw, c_cols, r_g, r_h, qcap_op,
                                 B, out, grid_x, s);
    case 8:
      return launch_rows_bits<8>(rows, W, D, cw, c_cols, r_g, r_h, qcap_op,
                                 B, out, grid_x, s);
    case 16:
      return launch_rows_bits<16>(rows, W, D, cw, c_cols, r_g, r_h, qcap_op,
                                  B, out, grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The device-window entries: K1 (quant = 0: f32 out) or K3's packed-row
// entry (quant = 1: int32 out, re-quantized at *r_g, *r_h) over the window
// the split descriptor `desc` names in buf0 / buf1, the compact core's two
// (N, D) int32 working buffers; n_max: the most rows a window can have
// (N), which sizes the grid. The grid is fixed whatever the window, so the
// launch replays from a CUDA graph; the launcher always zeroes out
// (c_cols, B, 3) first.
extern "C" int lgbt_hist_window_launch(const void* buf0, const void* buf1,
                                       const void* desc, long long n_max,
                                       int D, int cw, int c_cols,
                                       int item_bits, int quant,
                                       const void* r_g, const void* r_h,
                                       int qcap_op, int B, void* out,
                                       int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (item_bits) {
    case 4:
      return launch_window_bits<4>(buf0, buf1, desc, n_max, D, cw, c_cols,
                                   quant, r_g, r_h, qcap_op, B, out, grid_x,
                                   s);
    case 8:
      return launch_window_bits<8>(buf0, buf1, desc, n_max, D, cw, c_cols,
                                   quant, r_g, r_h, qcap_op, B, out, grid_x,
                                   s);
    case 16:
      return launch_window_bits<16>(buf0, buf1, desc, n_max, D, cw, c_cols,
                                    quant, r_g, r_h, qcap_op, B, out, grid_x,
                                    s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
