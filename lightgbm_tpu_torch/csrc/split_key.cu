// Split key: each row's side of a split over one window of the compact
// core's packed rows, for Hopper.
//
// Replaces the window decode that the JAX compact core runs inside its
// growth program (lightgbm_tpu/models/device_learner.py packed_go_left,
// with ops/bundle.py logical_bins_for_feature and ops/partition.py
// decide_left, and _quant_side_maxes under leaf re-quantization; XLA fuses
// them, there is no Pallas kernel). Per row of the window it decodes the
// split feature's code from its packed word, unmaps the feature's logical
// bin from an EFB bundle column, applies the numerical decision with the
// missing bin sent to the default side, and writes key3 (0 = left,
// 1 = right) for the partition kernel. It also counts the rows that go
// left -- the exact physical count that places the children's windows --
// and, under re-quantization, each side's max |qg| and |qh| of the rows'
// stored (qg << 16 | qh) words, which seed the children's ratios.
//
// Everything it needs is read from the split descriptor in device memory
// (ops/kernels/desc.py: go, the buffer holding the leaf, its first row and
// row count, the threshold, default_left and the feature's column, base,
// elide flag, bin count, missing type and default bin), so the launch has
// the same arguments and grid at every split and replays from a CUDA
// graph. A descriptor whose go is 0 (the tree has stopped) returns at once.
// The left count and the side maxes are added into the descriptor with
// atomics; the step zeroes those fields when it writes the descriptor.
//
// Bound on the H100: bytes. Per row it reads one code word (and the gh
// word under re-quantization) and writes one key: 8 (12) bytes, 8 MB at
// 1M rows, 0.0024 ms at 3.35 TB/s. Rows are D words apart, so each read
// pulls a 32-byte sector for 4 useful bytes; the kernel is one grid-stride
// pass with a block reduction and makes no attempt to do better (fusing it
// into the partition kernel, which reads every row anyway, is later work).
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, returns the launch's CUDA error.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// split descriptor fields (ops/kernels/desc.py; the tests read these)
constexpr int kDescGo = 0;
constexpr int kDescSrc = 1;
constexpr int kDescBegin = 2;
constexpr int kDescCount = 3;
constexpr int kDescLphys = 4;
constexpr int kDescThr = 6;
constexpr int kDescDleft = 7;
constexpr int kDescCol = 8;
constexpr int kDescBase = 9;
constexpr int kDescElide = 10;
constexpr int kDescNumBins = 11;
constexpr int kDescMissing = 12;
constexpr int kDescDefault = 13;
// left |qg|, left |qh|, right |qg|, right |qh|
constexpr int kDescSideMax = 14;

template <int kBits, bool kRenew>
__global__ void __launch_bounds__(kThreads)
split_key_kernel(const int32_t* __restrict__ buf0,
                 const int32_t* __restrict__ buf1, int* desc,
                 int32_t* __restrict__ key, int D, int cw) {
  if (!desc[kDescGo]) return;
  const int count = desc[kDescCount];
  const int thr = desc[kDescThr];
  const bool dleft = desc[kDescDleft] != 0;
  const int col = desc[kDescCol], base = desc[kDescBase];
  const bool elide = desc[kDescElide] != 0;
  const int nb = desc[kDescNumBins], missing = desc[kDescMissing];
  const int def = desc[kDescDefault];
  const int32_t* rows = (desc[kDescSrc] ? buf1 : buf0)
                        + (long long)desc[kDescBegin] * D;
  constexpr int per = 32 / kBits;
  constexpr uint32_t mask = (1u << kBits) - 1u;
  const int word = col / per, shift = (col % per) * kBits;

  int nleft = 0, lg = 0, lh = 0, rg = 0, rh = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count;
       i += gridDim.x * kThreads) {
    const int32_t* row = rows + (long long)i * D;
    int bin = (int)(((uint32_t)row[word] >> shift) & mask);
    if (elide) {
      // a bundle member: codes [base, base + nb - 2] are its non-default
      // bins, anything else is the feature at its default bin
      const int j = bin - base;
      bin = (j >= 0 && j < nb - 1) ? j + (j >= def) : def;
    }
    const bool is_missing =
        (missing == 1 && bin == def) || (missing == 2 && bin == nb - 1);
    const bool left = is_missing ? dleft : bin <= thr;
    key[i] = left ? 0 : 1;
    nleft += left;
    if (kRenew) {
      const int w = row[cw];
      const int lo = w & 0xffff;
      const int qg = abs(w >> 16), qh = abs(lo >= 0x8000 ? lo - 0x10000 : lo);
      if (left) {
        lg = max(lg, qg);
        lh = max(lh, qh);
      } else {
        rg = max(rg, qg);
        rh = max(rh, qh);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    nleft += __shfl_xor_sync(0xffffffffu, nleft, o);
    if (kRenew) {
      lg = max(lg, __shfl_xor_sync(0xffffffffu, lg, o));
      lh = max(lh, __shfl_xor_sync(0xffffffffu, lh, o));
      rg = max(rg, __shfl_xor_sync(0xffffffffu, rg, o));
      rh = max(rh, __shfl_xor_sync(0xffffffffu, rh, o));
    }
  }
  __shared__ int red[5][kWarps];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = nleft;
    red[1][warp] = lg;
    red[2][warp] = lh;
    red[3][warp] = rg;
    red[4][warp] = rh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0, m[4] = {0, 0, 0, 0};
    for (int w = 0; w < kWarps; ++w) {
      s += red[0][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = max(m[j], red[1 + j][w]);
    }
    if (s) atomicAdd(desc + kDescLphys, s);
    if (kRenew) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m[j]) atomicMax(desc + kDescSideMax + j, m[j]);
    }
  }
}

template <int kBits>
int launch_bits(const int32_t* buf0, const int32_t* buf1, int* desc,
                int32_t* key, int D, int cw, int renew, int grid,
                cudaStream_t s) {
  if (renew)
    split_key_kernel<kBits, true><<<grid, kThreads, 0, s>>>(buf0, buf1, desc,
                                                           key, D, cw);
  else
    split_key_kernel<kBits, false><<<grid, kThreads, 0, s>>>(buf0, buf1,
                                                            desc, key, D, cw);
  return (int)cudaGetLastError();
}

}  // namespace

// buf0, buf1: the two (N, D) int32 working buffers; desc: the split
// descriptor (its go, src, begin, count and feature fields read, its left
// count and side maxes added to); key: N int32, the window's keys written
// to key[0, count). item_bits: 4, 8 or 16 bits per code; renew: also the
// side maxes of word cw. grid: any number of blocks of 256 threads.
extern "C" int lgbt_split_key_launch(const int32_t* buf0, const int32_t* buf1,
                                     int* desc, int32_t* key, int D, int cw,
                                     int item_bits, int renew, int grid,
                                     void* stream) {
  if (grid < 1 || D < 1 || (renew && (cw < 0 || cw >= D)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (item_bits) {
    case 4:
      return launch_bits<4>(buf0, buf1, desc, key, D, cw, renew, grid, s);
    case 8:
      return launch_bits<8>(buf0, buf1, desc, key, D, cw, renew, grid, s);
    case 16:
      return launch_bits<16>(buf0, buf1, desc, key, D, cw, renew, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
