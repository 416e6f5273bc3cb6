// K4: stable three-way partition of a packed row window for Hopper.
//
// Replaces lightgbm_tpu/ops/pallas/partition_kernel.py::_partition_kernel,
// the body of stable_partition3: reorder a (W, D) 32-bit row window so that
// key-0 rows come first, then key 1, then key 2, each group in its original
// order -- exactly take(win, argsort(key, stable)). The TPU kernel compacts
// each block with a one-hot permutation matmul over byte planes because the
// TPU has no cheap scatter; on Hopper the rows are moved through shared
// memory instead.
//
// Bound on the H100: bytes. The function reads W*D words and W keys once and
// writes W*D words, W*(8D + 4) bytes, with no arithmetic to speak of
// (W = 1M, D = 11: 92 MB, 0.0275 ms at 3.35 TB/s). Most calls on the
// growth path are small child windows, where launches and the chain of
// dependent steps, not bytes, set the time. The design:
//
//   * One launch per call: a persistent cooperative kernel, grid = blocks
//     per SM x SMs (capped by the tiles), each block owning a contiguous
//     range of T-row tiles.
//       A. each block counts the keys of its rows;
//       -- one grid-wide barrier (cooperative launch: all blocks resident);
//       B. each block reads the grid's (key 0, key 1) counts from L2 and
//          derives its own key-major destination bases and the totals;
//       C. the block moves its tiles in order.
//     The first tile's rows and keys are requested before A, so they land
//     during the count and the barrier; later tiles' keys are loaded one
//     tile ahead.
//   * Coalesced row moves: a tile of T rows x D words is one contiguous run,
//     copied to shared memory with 16-byte cp.async loads (the range is
//     widened to 16-byte boundaries, which never leaves the pages the
//     window lies on, so any row slice of a buffer works), double-buffered:
//     tile i+1 loads while tile i is written. Rows are ranked per key with
//     warp ballots; the warps' counts are combined by a shuffle scan; shared
//     memory holds the inverse map from output slot to tile row. The key-s
//     rows of a tile go to one contiguous destination run of cnt_s * D
//     words, written with consecutive threads on consecutive words, so every
//     store fills whole sectors.
//   * Tile size from D: T = 256 rows where both staged tiles fit in 96 KB
//     (D <= 48), fewer for wider rows, never fewer than 4; D up to 6,144
//     words (192 KB staged, with the opt-in shared-memory attribute).
//
// The result is bit-exact: rows are copied as 32-bit words, never converted.
// Keys must lie in {0, 1, 2}. The output is a second buffer (out-of-place):
// the caller ping-pongs two working buffers.
//
// Two entries launch it: one takes the window as host ints (pointers, W);
// the device-window entry reads it from the split descriptor in device
// memory (which buffer, first row, row count, go) on a fixed grid of the
// most blocks the card holds, so the compact core's split step, captured
// as a CUDA graph, replays one launch at every split. Its blocks share
// out the window's tiles; at small windows most of them only count and
// meet the barrier, a fixed cost of the full wave.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing (the caller passes 2 * grid int32 of scratch),
// returns the launch's CUDA error (a refused cooperative launch included).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;                // rows per tile, one per thread
constexpr int kMinTile = 4;                  // keeps tile starts 16-byte aligned
constexpr int kStageBytes = 96 * 1024;       // both staged tiles, aimed at
constexpr int kMaxStageBytes = 192 * 1024;   // ... and at most
constexpr int kMaxD = kMaxStageBytes / (8 * kMinTile);
// split descriptor fields read by the device-window entry
// (ops/kernels/desc.py; the tests read these)
constexpr int kDescGo = 0;
constexpr int kDescSrc = 1;
constexpr int kDescBegin = 2;
constexpr int kDescCount = 3;

// rows per tile for D-word rows, a multiple of 4; 0 where D is not taken
__host__ __device__ inline int tile_rows(int D) {
  if (D < 1 || D > kMaxD) return 0;
  const int t = (kStageBytes / (8 * D)) & ~3;
  return t < kMinTile ? kMinTile : (t > kMaxTile ? kMaxTile : t);
}

// words of one staged tile: T*D words plus up to 3 before them (the
// 16-byte alignment of the window), in whole 16-byte chunks
__host__ __device__ inline int stage_words(int T, int D) {
  return (T * D + 6) & ~3;
}

// dynamic shared memory: two staged tiles and the slot -> row map
__host__ __device__ inline int smem_bytes(int D) {
  const int T = tile_rows(D);
  return (2 * stage_words(T, D) + T) * 4;
}

__device__ __forceinline__ void cp_async16(int* smem, const int4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// stage rows [r0, r0 + n) of the window: 16-byte chunks from win16 (the
// window's start rounded down to 16 bytes, `a` words before it)
__device__ __forceinline__ void load_tile(int* stage, const int4* win16,
                                          int r0, int n, int D, int a) {
  const int4* src = win16 + (long long)r0 * D / 4;   // r0 * D % 4 == 0
  const int chunks = (a + n * D + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(stage + 4 * c, src + c);
  cp_async_commit();
}

// One launch's work over the window win -> out; every block of the grid
// calls it (a block with no tile still counts and meets the barrier).
__device__ __forceinline__ void partition_body(
    const int32_t* __restrict__ win, const int32_t* __restrict__ key, int W,
    int D, int T, int* counts, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int red[4][kWarps];
  __shared__ int wsum[kWarps];
  const int sw = stage_words(T, D);
  int* slot_row = smem + 2 * sw;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, b = blockIdx.x;
  const int ntiles = (int)(((long long)W + T - 1) / T);
  const int t_lo = (int)((long long)b * ntiles / nb);
  const int t_hi = (int)((long long)(b + 1) * ntiles / nb);
  const int r_lo = t_lo * T;
  const int r_hi = (int)min((long long)t_hi * T, (long long)W);
  const int a = (int)((reinterpret_cast<uintptr_t>(win) >> 2) & 3);
  const int4* win16 = reinterpret_cast<const int4*>(win - a);

  // the first tile's rows and keys, in flight through the count and the
  // barrier (a block of the device-window entry may have no tile)
  int k_next = -1;
  if (t_lo < t_hi) {
    load_tile(smem, win16, r_lo, min(T, W - r_lo), D, a);
    k_next = tid < min(T, W - r_lo) ? key[r_lo + tid] : -1;
  }

  // ---- A: count this block's keys ------------------------------------
  int c0 = 0, c1 = 0;
  for (long long r = r_lo + tid; r < r_hi; r += kThreads) {
    const int k = key[r];
    c0 += k == 0;
    c1 += k == 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
  }
  if (lane == 0) {
    red[0][warp] = c0;
    red[1][warp] = c1;
  }
  __syncthreads();
  if (tid == 0) {
    int s0 = 0, s1 = 0;
    for (int w = 0; w < kWarps; ++w) {
      s0 += red[0][w];
      s1 += red[1][w];
    }
    counts[2 * b] = s0;
    counts[2 * b + 1] = s1;
  }
  cg::this_grid().sync();

  // ---- B: destination bases from the grid's counts ----------------------
  int p0 = 0, p1 = 0, s0 = 0, s1 = 0;
  for (int i = tid; i < nb; i += kThreads) {
    const int x0 = __ldcg(counts + 2 * i), x1 = __ldcg(counts + 2 * i + 1);
    s0 += x0;
    s1 += x1;
    if (i < b) {
      p0 += x0;
      p1 += x1;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p0 += __shfl_xor_sync(0xffffffffu, p0, o);
    p1 += __shfl_xor_sync(0xffffffffu, p1, o);
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (lane == 0) {                    // (the grid barrier ordered red's reads)
    red[0][warp] = p0;
    red[1][warp] = p1;
    red[2][warp] = s0;
    red[3][warp] = s1;
  }
  __syncthreads();
  p0 = p1 = s0 = s1 = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    p0 += red[0][w];
    p1 += red[1][w];
    s0 += red[2][w];
    s1 += red[3][w];
  }
  // next destination row of each key: key-major over the whole window
  int base0 = p0, base1 = s0 + p1, base2 = s0 + s1 + (r_lo - p0 - p1);

  // ---- C: move the tiles ------------------------------------------------
  const unsigned lt = (1u << lane) - 1u;
  const unsigned magic = D > 1 ? (unsigned)((0x100000000ull + D - 1) / D) : 0u;
  for (int t = t_lo; t < t_hi; ++t) {
    int* cur = (t - t_lo) & 1 ? smem + sw : smem;
    int* next = (t - t_lo) & 1 ? smem : smem + sw;
    const int r0 = t * T;
    const int n = min(T, W - r0);
    const int k = k_next;
    if (t + 1 < t_hi) {
      const int n_next = min(T, W - r0 - T);
      load_tile(next, win16, r0 + T, n_next, D, a);
      k_next = tid < n_next ? key[r0 + T + tid] : -1;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // stable ranks: ballots within the warp, a shuffle scan over the warps'
    // (key 0 | key 1 << 16) counts
    const unsigned m0 = __ballot_sync(0xffffffffu, k == 0);
    const unsigned m1 = __ballot_sync(0xffffffffu, k == 1);
    if (lane == 0) wsum[warp] = __popc(m0) | (__popc(m1) << 16);
    __syncthreads();
    int v = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    int pre = __shfl_sync(0xffffffffu, v, (warp + 31) & 31);
    if (warp == 0) pre = 0;
    const int tot = __shfl_sync(0xffffffffu, v, kWarps - 1);
    const int n0 = tot & 0xffff, n1 = tot >> 16;
    if (tid < n) {
      const int q0 = (pre & 0xffff) + __popc(m0 & lt);
      const int q1 = (pre >> 16) + __popc(m1 & lt);
      const int slot = k == 0 ? q0 : k == 1 ? n0 + q1
                                            : n0 + n1 + (tid - q0 - q1);
      slot_row[slot] = tid;
    }
    __syncthreads();                  // slot map and staged tile ready
    // output slot j, word w (e = j * D + w) -> the key's run
    const int e01 = n0 * D, e012 = (n0 + n1) * D;
    const long long d0 = (long long)base0 * D;
    const long long d1 = (long long)(base1 - n0) * D;
    const long long d2 = (long long)(base2 - n0 - n1) * D;
    const int* src = cur + a;
    for (int e = tid; e < n * D; e += kThreads) {
      const int j = D > 1 ? (int)__umulhi((unsigned)e, magic) : e;
      const int w = e - j * D;
      const int val = src[slot_row[j] * D + w];
      out[(e < e01 ? d0 : e < e012 ? d1 : d2) + e] = val;
    }
    base0 += n0;
    base1 += n1;
    base2 += n - n0 - n1;
    __syncthreads();                  // before the buffers are reused
  }
}

__global__ void __launch_bounds__(kThreads)
partition_kernel(const int32_t* __restrict__ win,
                 const int32_t* __restrict__ key, int W, int D, int T,
                 int* counts, int32_t* __restrict__ out) {
  partition_body(win, key, W, D, T, counts, out);
}

// The device-window entry: the window is rows [begin, begin + count) of
// the buffer the descriptor names (src), moved to the same rows of the
// other buffer; a descriptor whose go is 0 returns at once (every block
// alike, so none waits at the barrier).
__global__ void __launch_bounds__(kThreads)
partition_window_kernel(int32_t* buf0, int32_t* buf1,
                        const int* __restrict__ desc,
                        const int32_t* __restrict__ key, int D, int T,
                        int* counts) {
  if (!desc[kDescGo]) return;
  const long long off = (long long)desc[kDescBegin] * D;
  const bool src = desc[kDescSrc] != 0;
  partition_body((src ? buf1 : buf0) + off, key, desc[kDescCount], D, T,
                 counts, (src ? buf0 : buf1) + off);
}

}  // namespace

extern "C" int lgbt_partition_tile_rows(int D) { return tile_rows(D); }

extern "C" int lgbt_partition_smem_bytes(int D) {
  return tile_rows(D) ? smem_bytes(D) : 0;
}

template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// *grid = the most blocks of `kernel` over D-word rows that can be
// resident at once on the current device: the cooperative launch's limit
template <typename Kernel>
static int max_grid(Kernel kernel, int D, int* grid) {
  if (!tile_rows(D)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = set_smem(kernel, smem_bytes(D));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                      smem_bytes(D));
  *grid = per * sms;
  return (int)e;
}

extern "C" int lgbt_partition_max_grid(int D, int* grid) {
  return max_grid(partition_kernel, D, grid);
}

// the same for the device-window entry (its grid, fixed at every split)
extern "C" int lgbt_partition_window_max_grid(int D, int* grid) {
  return max_grid(partition_window_kernel, D, grid);
}

// win: (W, D) int32 rows, contiguous. key: (W,) int32 in {0, 1, 2}.
// grid: 1 .. min(ceil(W / T), lgbt_partition_max_grid). scratch: 2 * grid
// int32. out: (W, D) int32, not overlapping win.
extern "C" int lgbt_partition_launch(const int32_t* win, const int32_t* key,
                                     int W, int D, int grid, int* scratch,
                                     int32_t* out, void* stream) {
  int T = tile_rows(D);
  if (!T || W < 1 || grid < 1 || (long long)grid * T >= (long long)W + T)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D);
  cudaError_t e = set_smem(partition_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&win, &key, &W, &D, &T, &scratch, &out};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(partition_kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The device-window entry, whose window is read from the split descriptor
// in device memory (ops/kernels/desc.py): go, src, begin, count. The same
// arguments and grid serve every split, so the launch replays from a CUDA
// graph: grid = lgbt_partition_window_max_grid(D), and the blocks take the
// window's tiles as they come (blocks past the last tile only count and
// meet the barrier). Launched with cudaLaunchKernelEx and the cooperative
// attribute, which stream capture records. key: the window's keys at
// key[0, count). scratch: 2 * grid int32.
extern "C" int lgbt_partition_window_launch(int32_t* buf0, int32_t* buf1,
                                            const int* desc,
                                            const int32_t* key, int D,
                                            int grid, int* scratch,
                                            void* stream) {
  int T = tile_rows(D);
  if (!T || grid < 1) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(D);
  cudaError_t e = set_smem(partition_window_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, partition_window_kernel, buf0, buf1, desc,
                         key, D, T, scratch);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
