// K4: stable three-way partition of a packed row window for Hopper.
//
// Replaces lightgbm_tpu/ops/pallas/partition_kernel.py::_partition_kernel,
// the body of stable_partition3: reorder a (W, D) 32-bit row window so that
// key-0 rows come first, then key 1, then key 2, each group in its original
// order -- exactly take(win, argsort(key, stable)). The TPU kernel compacts
// each block with a one-hot permutation matmul over byte planes because the
// TPU has no cheap scatter; on Hopper a row scatter is the natural form:
//
//   1. count: each block counts the keys of its 1024-row tile;
//   2. scan: one block turns the (3, nblocks) counts into exclusive
//      destination offsets (key-major, so stream s of block b starts after
//      all rows of smaller keys and the key-s rows of earlier blocks);
//   3. scatter: each block walks its tile in four 256-row steps; a warp
//      ranks its rows per key with __ballot_sync and __popc of the lanes
//      below it, warps are ordered through shared memory, and every thread
//      copies its own D-word row to its destination.
//
// Bound on the H100: bytes. The function reads W*D words and W keys once and
// writes W*D words, with no arithmetic to speak of. Reading rows in tile
// order keeps the loads coalesced; the writes go to at most three ordered
// runs per step, so they coalesce as well. The output is a second buffer
// (out-of-place): the caller ping-pongs two working buffers.
//
// The result is bit-exact: rows are copied as 32-bit words, never converted.
// Keys must lie in {0, 1, 2}.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing (the caller passes 2 * 3 * nblocks int32 of scratch),
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ key, int W, int nb,
             int* __restrict__ counts) {
  __shared__ int c[3];
  if (threadIdx.x < 3) c[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kTile;
  int mine[3] = {0, 0, 0};
  for (int sub = 0; sub < kTile / kThreads; ++sub) {
    const int r = base + sub * kThreads + threadIdx.x;
    const int k = r < W ? key[r] : -1;
#pragma unroll
    for (int s = 0; s < 3; ++s) mine[s] += __popc(__ballot_sync(0xffffffffu, k == s));
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < 3; ++s) atomicAdd(&c[s], mine[s]);
  }
  __syncthreads();
  if (threadIdx.x < 3) counts[threadIdx.x * nb + blockIdx.x] = c[threadIdx.x];
}

// exclusive scan of the key-major (3, nb) counts with one block
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int n, int* __restrict__ starts) {
  __shared__ int s[kScanThreads];
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, threadIdx.x * per);
  const int hi = min(n, lo + per);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += counts[i];
  s[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? s[threadIdx.x - off] : 0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  int run = s[threadIdx.x] - local;
  for (int i = lo; i < hi; ++i) {
    starts[i] = run;
    run += counts[i];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ win, const int32_t* __restrict__ key,
               int W, int D, int nb, const int* __restrict__ starts,
               int32_t* __restrict__ out) {
  __shared__ int base[3];
  __shared__ int wc[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x < 3) base[threadIdx.x] = starts[threadIdx.x * nb + blockIdx.x];
  __syncthreads();
  for (int sub = 0; sub < kTile / kThreads; ++sub) {
    const long long r = (long long)blockIdx.x * kTile + sub * kThreads + threadIdx.x;
    const int k = r < W ? key[r] : -1;
    int rank = 0;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const unsigned m = __ballot_sync(0xffffffffu, k == s);
      if (k == s) rank = __popc(m & lt);
      if (lane == 0) wc[s][warp] = __popc(m);
    }
    __syncthreads();
    if (k >= 0 && k < 3) {
      int dest = base[k] + rank;
      for (int w = 0; w < warp; ++w) dest += wc[k][w];
      const int32_t* src = win + r * D;
      int32_t* dst = out + (long long)dest * D;
      for (int j = 0; j < D; ++j) dst[j] = src[j];
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      int add = 0;
      for (int w = 0; w < kWarps; ++w) add += wc[threadIdx.x][w];
      base[threadIdx.x] += add;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int lgbt_partition_tile_rows() { return kTile; }

// win: (W, D) int32 rows, contiguous. key: (W,) int32 in {0, 1, 2}.
// scratch: 2 * 3 * nb int32 with nb = ceil(W / tile). out: (W, D) int32.
extern "C" int lgbt_partition_launch(const int32_t* win, const int32_t* key,
                                     int W, int D, int* scratch, int32_t* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (W + kTile - 1) / kTile;
  int* counts = scratch;
  int* starts = scratch + 3 * nb;
  count_kernel<<<nb, kThreads, 0, s>>>(key, W, nb, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, 3 * nb, starts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<<<nb, kThreads, 0, s>>>(win, key, W, D, nb, starts, out);
  return (int)cudaGetLastError();
}
