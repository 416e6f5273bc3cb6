// Split key: each row's side of a split, for Hopper, in three entries.
//
// The packed entry (split_key_kernel) works on one window of the compact
// core's packed rows. It replaces the window decode that the JAX compact
// core runs inside its growth program (lightgbm_tpu/models/
// device_learner.py packed_go_left, with ops/bundle.py
// logical_bins_for_feature and ops/partition.py decide_left, and
// _quant_side_maxes under leaf re-quantization; XLA fuses them, there is
// no Pallas kernel). Per row of the window it decodes the split feature's
// code from its packed word, unmaps the feature's logical bin from an EFB
// bundle column, applies the numerical decision with the missing bin sent
// to the default side, and writes key3 (0 = left, 1 = right) for the
// partition kernel. It also counts the rows that go left -- the exact
// physical count that places the children's windows -- and, under
// re-quantization, each side's max |qg| and |qh| of the rows' stored
// (qg << 16 | qh) words, which seed the children's ratios.
//
// The column entry (split_key_column_kernel) serves the masked core. It
// replaces the split body's decode and row update of the JAX grow_tree
// (lightgbm_tpu/models/device_learner.py:402-419: the same
// logical_bins_for_feature and decide_left over the split feature's
// column of the (C, N) codes, the leaf_id rewrite and gh * lmask). Per row
// of all N rows: a row of the split leaf reads its code from the column,
// is decided by the same device function, and moves to the new leaf id
// when it goes right; the left child's histogram operand gets the row's
// gh when the row is in the split leaf and goes left, else 0.
//
// The router entry (route_rows_kernel) serves bagged compact trees. It
// replaces the JAX route_rows_by_rec (lightgbm_tpu/models/
// device_learner.py:2174, a fori_loop of packed_go_left over the split
// records; no Pallas kernel): the rows left out of a tree's bag still need
// their leaf. Per packed row (one thread each), it walks the tree's first k
// split records in order and moves the row to leaf i + 1 where it sits in
// record i's leaf and goes right, with the same decode as the packed entry
// (read through make_split / goes_left, so the partition and the router
// cannot drift apart). The records and k stay in device memory; each block
// stages its chunk of records, turned into decisions, in shared memory.
//
// Categorical splits (the JAX cat_mask / rec_cat, lightgbm_tpu/models/
// device_learner.py:409-414 and packed_go_left): a split of a categorical
// feature sends a row left iff the bit of its logical bin is set in the
// split's bitset, W int32 words (bin b at bit b % 32 of word b / 32); a
// bin past the words goes right. The first two entries read the flag and
// the words from the descriptor (its CAT field and the W words after it;
// W is a launch argument, 0 for a learner without categorical features);
// the router reads each record's words from a (max_rec, W) array and the
// feature's flag from a per-feature array, and stages the words beside
// the record's decision in shared memory.
//
// Everything the first two entries need is read from the split
// descriptor in device memory (ops/kernels/desc.py: go, the threshold,
// default_left and the feature's column, base, elide flag, bin count,
// missing type and default bin; the packed entry also the buffer holding the leaf, its
// first row and row count, the column entry the leaf and the new id), so
// each launch has the same arguments and grid at every split and replays
// from a CUDA graph. A descriptor whose go is 0 (the tree has stopped)
// returns at once. The packed entry adds the left count and the side
// maxes into the descriptor with atomics; the step zeroes those fields
// when it writes the descriptor.
//
// Bound on the H100: bytes. Packed entry: per row one code word (and the
// gh word under re-quantization) read and one key written, 8 (12) bytes,
// 8 MB at 1M rows, 0.0024 ms at 3.35 TB/s. Rows are D words apart, so
// each read pulls a 32-byte sector for 4 useful bytes; the kernel is one
// grid-stride pass with a block reduction and makes no attempt to do
// better (fusing it into the partition kernel, which reads every row
// anyway, is later work). Column entry: per row the leaf id (4 bytes),
// the code (1 or 2), the gh operand (12, 3 or 12 bytes for f32, int8 and
// int32) read and the operand row written, each row read and written
// once in a coalesced grid-stride pass; at 60,000 rows ~1.8 MB, ~0.55 us,
// under the launch's own cost.
//
// Router: per row its CW code words read (only the words of the split
// features on its path are touched, through L1) and one leaf id written,
// so the byte bound is M * (4 * CW + 4); its work, O(M * k) comparisons
// in registers against the staged records, is far below the f32 rate.
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
constexpr int kDescLeaf = 18;
constexpr int kDescNewId = 19;
constexpr int kDescCat = 20;
constexpr int kDescWords = 21;

// One split's decision, read from the descriptor.
struct Split {
  int thr, col, base, nb, missing, def;
  bool dleft, elide, cat;
};

// A split from its threshold, default-left flag and the feature's six
// fields (column, EFB base, elide flag, bin count, missing type, default
// bin), in the order of the descriptor and of the learner's feature table.
__device__ __forceinline__ Split make_split(int thr, bool dleft,
                                            const int* feat, bool cat) {
  Split s;
  s.thr = thr;
  s.dleft = dleft;
  s.cat = cat;
  s.col = feat[0];
  s.base = feat[1];
  s.elide = feat[2] != 0;
  s.nb = feat[3];
  s.missing = feat[4];
  s.def = feat[5];
  return s;
}

// The descriptor's split; categorical when it has bitset words and its
// CAT field is set.
__device__ __forceinline__ Split read_split(const int* desc, int words) {
  return make_split(desc[kDescThr], desc[kDescDleft] != 0, desc + kDescCol,
                    words > 0 && desc[kDescCat] != 0);
}

// The decision of a row from its raw code: a bundle member's codes [base,
// base + nb - 2] are its non-default bins, anything else is the feature at
// its default bin. A categorical split sends the bin left iff its bit is
// set in the split's `words` bitset words; a numerical one sends the
// missing bin to the default side, any other bin left iff bin <= thr.
__device__ __forceinline__ bool goes_left(int bin, const Split& s,
                                          const int* words, int n_words) {
  if (s.elide) {
    const int j = bin - s.base;
    bin = (j >= 0 && j < s.nb - 1) ? j + (j >= s.def) : s.def;
  }
  if (s.cat)
    return bin >= 0 && (bin >> 5) < n_words &&
           (((uint32_t)words[bin >> 5] >> (bin & 31)) & 1u);
  const bool is_missing =
      (s.missing == 1 && bin == s.def) || (s.missing == 2 && bin == s.nb - 1);
  return is_missing ? s.dleft : bin <= s.thr;
}

template <int kBits, bool kRenew>
__global__ void __launch_bounds__(kThreads)
split_key_kernel(const int32_t* __restrict__ buf0,
                 const int32_t* __restrict__ buf1, int* desc,
                 int32_t* __restrict__ key, int D, int cw, int n_words) {
  if (!desc[kDescGo]) return;
  const int count = desc[kDescCount];
  const Split sp = read_split(desc, n_words);
  const int* words = desc + kDescWords;
  const int32_t* rows = (desc[kDescSrc] ? buf1 : buf0)
                        + (long long)desc[kDescBegin] * D;
  constexpr int per = 32 / kBits;
  constexpr uint32_t mask = (1u << kBits) - 1u;
  const int word = sp.col / per, shift = (sp.col % per) * kBits;

  int nleft = 0, lg = 0, lh = 0, rg = 0, rh = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count;
       i += gridDim.x * kThreads) {
    const int32_t* row = rows + (long long)i * D;
    const bool left = goes_left(
        (int)(((uint32_t)row[word] >> shift) & mask), sp, words, n_words);
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

// The column entry: all n rows of the masked core, codes_t the (C, n)
// column codes (uint8, or 16-bit codes read as uint16), leaf_id (n,) the
// row -> leaf map (rows of leaf LEAF going right get NEW_ID), gh / ghl
// (n, 3) the tree's operand and the left child's, row-major.
template <typename CodeT, typename OpT>
__global__ void __launch_bounds__(kThreads)
split_key_column_kernel(const CodeT* __restrict__ codes_t, long long n,
                        const int* __restrict__ desc,
                        int32_t* __restrict__ leaf_id,
                        const OpT* __restrict__ gh, OpT* __restrict__ ghl,
                        int n_words) {
  if (!desc[kDescGo]) return;
  const Split sp = read_split(desc, n_words);
  const int* words = desc + kDescWords;
  const int leaf = desc[kDescLeaf], new_id = desc[kDescNewId];
  const CodeT* __restrict__ col = codes_t + (long long)sp.col * n;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += (long long)gridDim.x * kThreads) {
    bool left = false;
    if (leaf_id[r] == leaf) {
      left = goes_left((int)col[r], sp, words, n_words);
      if (!left) leaf_id[r] = new_id;
    }
    OpT* out = ghl + 3 * r;
    if (left) {
      const OpT* in = gh + 3 * r;
      out[0] = in[0];
      out[1] = in[1];
      out[2] = in[2];
    } else {
      out[0] = OpT(0);
      out[1] = OpT(0);
      out[2] = OpT(0);
    }
  }
}

template <typename CodeT, typename OpT>
int launch_column(const void* codes_t, long long n, const int* desc,
                  int32_t* leaf_id, const void* gh, void* ghl, int n_words,
                  int grid, cudaStream_t s) {
  split_key_column_kernel<CodeT, OpT><<<grid, kThreads, 0, s>>>(
      static_cast<const CodeT*>(codes_t), n, desc, leaf_id,
      static_cast<const OpT*>(gh), static_cast<OpT*>(ghl), n_words);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_column_op(const void* codes_t, long long n, const int* desc,
                     int32_t* leaf_id, const void* gh, void* ghl,
                     int op_kind, int n_words, int grid, cudaStream_t s) {
  switch (op_kind) {
    case 0:
      return launch_column<CodeT, float>(codes_t, n, desc, leaf_id, gh, ghl,
                                         n_words, grid, s);
    case 1:
      return launch_column<CodeT, int8_t>(codes_t, n, desc, leaf_id, gh,
                                          ghl, n_words, grid, s);
    case 2:
      return launch_column<CodeT, int32_t>(codes_t, n, desc, leaf_id, gh,
                                           ghl, n_words, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// split record columns (models/device_learner.py R_*) read by the router
constexpr int kRecCols = 13;
constexpr int kRecLeaf = 0;
constexpr int kRecFeat = 1;
constexpr int kRecThr = 2;
constexpr int kRecDleft = 3;
constexpr int kFeatFields = 6;
// records staged per block and pass: at most kRecChunk, fewer where the
// records' bitset words would take the chunk past kRouteSmem bytes of
// shared memory (Split 28 B + leaf 4 B + 4 W B per record: 8 KB at W = 0,
// 16 KB at W = 8 (256 bins), 40 KB at W = 32 (1,024 bins))
constexpr int kRecChunk = 256;
constexpr int kRouteSmem = 48 * 1024;

__host__ __device__ constexpr int route_rec_bytes(int n_words) {
  return (int)sizeof(Split) + 4 + 4 * n_words;
}

// The router: rows (m, cw) packed code words, one row per thread; rec the
// tree's (max_rec, 13) f32 split records of which the first *k_ptr are
// real; table (num_features, 6) the feature fields; with n_words > 0,
// rec_cat (max_rec, n_words) the records' bitset words and f_cat
// (num_features,) the categorical flags; leaf (m,) written. chunk records
// are staged per pass, in dynamic shared memory.
template <int kBits>
__global__ void __launch_bounds__(kThreads)
route_rows_kernel(const int32_t* __restrict__ rows, long long m, int cw,
                  const float* __restrict__ rec, const int* __restrict__ k_ptr,
                  int max_rec, const int* __restrict__ table,
                  int num_features, const int* __restrict__ rec_cat,
                  int n_words, const int* __restrict__ f_cat, int chunk,
                  int32_t* __restrict__ leaf_out) {
  extern __shared__ int smem[];
  Split* s_split = reinterpret_cast<Split*>(smem);
  int* s_leaf = smem + chunk * ((int)sizeof(Split) / 4);
  int* s_words = s_leaf + chunk;
  constexpr int per = 32 / kBits;
  constexpr uint32_t mask = (1u << kBits) - 1u;
  const int k = min(*k_ptr, max_rec);
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int32_t* row = rows + (r < m ? r : 0) * (long long)cw;
  int leaf = 0;
  for (int base = 0; base < k; base += chunk) {
    const int nc = min(chunk, k - base);
    __syncthreads();
    for (int j = threadIdx.x; j < nc; j += kThreads) {
      const float* rc = rec + (long long)(base + j) * kRecCols;
      const int feat =
          min(max((int)rc[kRecFeat], 0), num_features - 1);
      s_split[j] = make_split((int)rc[kRecThr], rc[kRecDleft] > 0.5f,
                              table + feat * kFeatFields,
                              n_words > 0 && f_cat[feat] != 0);
      s_leaf[j] = (int)rc[kRecLeaf];
    }
    for (int j = threadIdx.x; j < nc * n_words; j += kThreads)
      s_words[j] = rec_cat[(long long)base * n_words + j];
    __syncthreads();
    if (r < m) {
      for (int j = 0; j < nc; ++j) {
        if (s_leaf[j] != leaf) continue;
        const Split sp = s_split[j];
        const uint32_t word = (uint32_t)__ldg(row + sp.col / per);
        const int code = (int)((word >> ((sp.col % per) * kBits)) & mask);
        if (!goes_left(code, sp, s_words + j * n_words, n_words))
          leaf = base + j + 1;
      }
    }
  }
  if (r < m) leaf_out[r] = leaf;
}

template <int kBits>
int launch_route(const int32_t* rows, long long m, int cw, const float* rec,
                 const int* k_ptr, int max_rec, const int* table,
                 int num_features, const int* rec_cat, int n_words,
                 const int* f_cat, int32_t* leaf, cudaStream_t s) {
  const long long grid = (m + kThreads - 1) / kThreads;
  const int fit = kRouteSmem / route_rec_bytes(n_words);
  const int chunk = fit < kRecChunk ? fit : kRecChunk;
  route_rows_kernel<kBits><<<(unsigned)grid, kThreads,
                             chunk * route_rec_bytes(n_words), s>>>(
      rows, m, cw, rec, k_ptr, max_rec, table, num_features, rec_cat,
      n_words, f_cat, chunk, leaf);
  return (int)cudaGetLastError();
}

template <int kBits>
int launch_bits(const int32_t* buf0, const int32_t* buf1, int* desc,
                int32_t* key, int D, int cw, int renew, int n_words, int grid,
                cudaStream_t s) {
  if (renew)
    split_key_kernel<kBits, true><<<grid, kThreads, 0, s>>>(
        buf0, buf1, desc, key, D, cw, n_words);
  else
    split_key_kernel<kBits, false><<<grid, kThreads, 0, s>>>(
        buf0, buf1, desc, key, D, cw, n_words);
  return (int)cudaGetLastError();
}

}  // namespace

// buf0, buf1: the two (N, D) int32 working buffers; desc: the split
// descriptor (its go, src, begin, count and feature fields read, its left
// count and side maxes added to); key: N int32, the window's keys written
// to key[0, count). item_bits: 4, 8 or 16 bits per code; renew: also the
// side maxes of word cw; n_words: the descriptor's bitset words (0: no
// categorical split). grid: any number of blocks of 256 threads.
extern "C" int lgbt_split_key_launch(const int32_t* buf0, const int32_t* buf1,
                                     int* desc, int32_t* key, int D, int cw,
                                     int item_bits, int renew, int n_words,
                                     int grid, void* stream) {
  if (grid < 1 || D < 1 || n_words < 0 || (renew && (cw < 0 || cw >= D)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (item_bits) {
    case 4:
      return launch_bits<4>(buf0, buf1, desc, key, D, cw, renew, n_words,
                            grid, s);
    case 8:
      return launch_bits<8>(buf0, buf1, desc, key, D, cw, renew, n_words,
                            grid, s);
    case 16:
      return launch_bits<16>(buf0, buf1, desc, key, D, cw, renew, n_words,
                             grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The column entry. codes_t: (C, n) column codes of code_bytes 1 (uint8)
// or 2 (16 bits, read unsigned); desc: the split descriptor (go, the
// decision's fields, the leaf and the new id read); leaf_id: n int32,
// rewritten; gh, ghl: (n, 3) row-major operands of op_kind 0 (f32), 1
// (int8) or 2 (int32), ghl written in full; n_words: the descriptor's
// bitset words. grid: any number of blocks of 256 threads.
extern "C" int lgbt_split_key_column_launch(const void* codes_t,
                                            int code_bytes, long long n,
                                            const int* desc, int32_t* leaf_id,
                                            const void* gh, void* ghl,
                                            int op_kind, int n_words,
                                            int grid, void* stream) {
  if (grid < 1 || n < 1 || n_words < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1:
      return launch_column_op<uint8_t>(codes_t, n, desc, leaf_id, gh, ghl,
                                       op_kind, n_words, grid, s);
    case 2:
      return launch_column_op<uint16_t>(codes_t, n, desc, leaf_id, gh, ghl,
                                        op_kind, n_words, grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The router. rows: (m, cw) int32 packed code rows, item_bits 4, 8 or 16
// bits per code; rec: (max_rec, 13) f32 split records in device memory, of
// which the first *k (an int in device memory) are walked; table:
// (num_features, 6) int32 feature fields; rec_cat: (max_rec, n_words) int32
// bitset words and f_cat: (num_features,) int32 categorical flags (both
// unread when n_words is 0); leaf: m int32, written. The grid is fixed by
// m: one thread per row.
extern "C" int lgbt_route_rows_launch(const int32_t* rows, long long m, int cw,
                                      int item_bits, const float* rec,
                                      const int* k, int max_rec,
                                      const int* table, int num_features,
                                      const int* rec_cat, int n_words,
                                      const int* f_cat, int32_t* leaf,
                                      void* stream) {
  if (m < 1 || cw < 1 || max_rec < 0 || num_features < 1 || n_words < 0 ||
      route_rec_bytes(n_words) > kRouteSmem ||
      (n_words > 0 && (rec_cat == nullptr || f_cat == nullptr)) ||
      (m + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (item_bits) {
    case 4:
      return launch_route<4>(rows, m, cw, rec, k, max_rec, table,
                             num_features, rec_cat, n_words, f_cat, leaf, s);
    case 8:
      return launch_route<8>(rows, m, cw, rec, k, max_rec, table,
                             num_features, rec_cat, n_words, f_cat, leaf, s);
    case 16:
      return launch_route<16>(rows, m, cw, rec, k, max_rec, table,
                              num_features, rec_cat, n_words, f_cat, leaf, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
