// ADC scoring of a PQ-coded candidate corpus on Hopper: three kernels
// that share one layout (codes (N, D) uint8 or int32, one LUT (D, K) f32
// per query) and one contract.
//
//   pq_score_batched  luts (B, D, K), codes (N, D) -> scores (B, N),
//                     scores[b, n] = sum over d = 0..D-1 of
//                     luts[b, d, codes[n, d]]
//   pq_score          the same kernel launched with B = 1
//   pq_topk           the same scores reduced to each query's top k,
//                     ordered by (score desc, id asc), padded with
//                     (-inf, INT32_MAX) when k > N
//
// Replace the TPU kernels src/repro/kernels/pq_score/pq_score.py::
// pq_score (body _score_kernel), pq_score_batched (_score_batched_kernel)
// and pq_topk (_topk_kernel).  Those fed the MXU a one-hot (N, D, K)
// operand only because the MXU cannot gather; Hopper gathers from shared
// memory, so here each thread looks its codes up in LUTs staged there.
//
// Bounds on an H100 (3.35 TB/s, 67 TFLOP/s f32):
//   * pq_score / pq_score_batched: bytes.  They read N*D code bytes and
//     B*D*K*4 LUT bytes and write B*N*4 score bytes; the B*N*D adds are
//     a fraction of that at any B.  One pass over the codes serves a
//     chunk of up to kMaxQ queries (their LUTs in shared memory, their
//     sums in registers), so the code stream is read ceil(B / kMaxQ)
//     times, from L2 after the first; each thread writes out[b, n] for
//     its own n, so a warp's stores are coalesced along n.
//   * pq_topk: operations (the B*N*D adds; it writes only B*k pairs).
//     The TPU kernel carried a running top-k from one grid step to the
//     next; blocks here run in no order, so it takes two passes:
//       1. one block per (query, tile of T candidates) scores the tile,
//          bitonic-sorts its (score, id) pairs in shared memory under the
//          total order (score desc, id asc) and writes the first k;
//       2. one block per group of partial lists sorts their pairs the
//          same way and keeps the first k, repeated until one list is
//          left (at N = 1M, T = 8192, k = 100: 123 lists, one round).
//     The order is total (ids are unique; padding pairs are equal; no
//     score is -0.0, see below), so the result equals a stable
//     descending sort of pq_score_batched's scores, bit for bit.
//
// Every score is summed in the order d = 0..D-1 with __fadd_rn, starting
// from +0.0, as the plain version (ref.py) sums: the two are
// bit-identical.  +0.0 is where the JAX package's sum starts too, so a
// row of -0.0 terms scores +0.0 there and here.  Codes are widened in
// registers and clamped to [0, K), as mgqe_decode does (codes from a
// build always lie in range).  At D % 8 == 0 a thread loads its row's
// uint8 codes 8 bytes at a time.
//
// The shape limits below (queries per launch, LUT bytes, tile sizes,
// shared memory) are checked here and only here: an entry point given a
// shape past them returns cudaErrorInvalidValue, and pq_topk_scratch
// tells the caller how much scratch a pq_topk launch needs.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;           // queries per block, batched kernel
constexpr int kScoreThreads = 256;  // threads per block, batched kernel
constexpr int kMaxSortThreads = 1024;
constexpr int kMaxMerge = 16384;    // pairs one merge block sorts (128 KB)
constexpr int kMaxTile = 8192;      // largest pass-1 tile
constexpr int kInvalidId = 0x7fffffff;
constexpr size_t kLutBudget = 96 * 1024;  // LUT bytes a block stages
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;   // dynamic shared memory per block

template <typename CodeT>
__device__ __forceinline__ int widen(CodeT raw, int K) {
  int c = static_cast<int>(raw);
  c = c < 0 ? 0 : c;
  return c < K ? c : K - 1;
}

// Adds lut[q][d][c] to acc[q] for the block's nq queries.
template <int QMAX>
__device__ __forceinline__ void add_term(float (&acc)[QMAX],
                                         const float* lut_s, int d, int c,
                                         int K, int dk, int nq) {
  const float* l = lut_s + d * K + c;
#pragma unroll
  for (int q = 0; q < QMAX; ++q)
    if (q < nq) acc[q] = __fadd_rn(acc[q], l[q * dk]);
}

// Scores of one candidate row for nq queries whose LUTs (nq, D, K) lie
// in shared memory.
template <typename CodeT, int QMAX>
__device__ __forceinline__ void score_row(const CodeT* __restrict__ row,
                                          const float* lut_s, int D, int K,
                                          int nq, bool vec8,
                                          float (&acc)[QMAX]) {
  const int dk = D * K;
#pragma unroll
  for (int q = 0; q < QMAX; ++q) acc[q] = 0.0f;
  if constexpr (sizeof(CodeT) == 1) {
    if (vec8) {
      const unsigned long long* w =
          reinterpret_cast<const unsigned long long*>(row);
      for (int j = 0; j < D / 8; ++j) {
        const unsigned long long word = w[j];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int c = static_cast<int>((word >> (8 * b)) & 0xffull);
          add_term<QMAX>(acc, lut_s, j * 8 + b, c < K ? c : K - 1, K, dk,
                         nq);
        }
      }
      return;
    }
  }
  for (int d = 0; d < D; ++d)
    add_term<QMAX>(acc, lut_s, d, widen(row[d], K), K, dk, nq);
}

// grid (ceil(N / block_n), ceil(B / nq)); a block scores block_n
// candidates for nq queries.
template <typename CodeT>
__global__ void score_kernel(const float* __restrict__ luts,
                             const CodeT* __restrict__ codes,
                             float* __restrict__ out, long long N, int B,
                             int D, int K, int block_n, int nq, bool vec8) {
  extern __shared__ __align__(16) float lut_s[];     // (nq, D, K)
  const int q0 = blockIdx.y * nq;
  const int nqb = min(nq, B - q0);
  const int dk = D * K;
  const float* src = luts + static_cast<size_t>(q0) * dk;
  for (int i = threadIdx.x; i < nqb * dk; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * block_n;
  const long long stop = min(start + block_n, N);
  for (long long n = start + threadIdx.x; n < stop; n += blockDim.x) {
    float acc[kMaxQ];
    score_row<CodeT, kMaxQ>(codes + n * D, lut_s, D, K, nqb, vec8, acc);
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q)
      if (q < nqb) out[static_cast<size_t>(q0 + q) * N + n] = acc[q];
  }
}

// (sa, ia) comes first under (score desc, id asc)
__device__ __forceinline__ bool first(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sorts P (a power of two) pairs in shared memory, first-ranked first.
// Ends with a barrier.
__device__ void bitonic_sort(float* s, int* id, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float si = s[i], sj = s[j];
        const int ii = id[i], ij = id[j];
        const bool up = (i & size) == 0;
        if (up ? first(sj, ij, si, ii) : first(si, ii, sj, ij)) {
          s[i] = sj;
          s[j] = si;
          id[i] = ij;
          id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// Pass 1. grid (n_tiles, B); block (query b, tile t) writes the first k
// of its tile's sorted pairs to out[(b * n_tiles + t) * k ...].
template <typename CodeT>
__global__ void topk_tile_kernel(const float* __restrict__ luts,
                                 const CodeT* __restrict__ codes,
                                 float* __restrict__ out_s,
                                 int* __restrict__ out_i, long long N, int D,
                                 int K, int tile, int k, bool vec8) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                   // (tile,)
  int* id = reinterpret_cast<int*>(smem + tile);     // (tile,)
  float* lut_s = smem + 2 * tile;                    // (D, K)
  const int b = blockIdx.y;
  const int dk = D * K;
  const float* src = luts + static_cast<size_t>(b) * dk;
  for (int i = threadIdx.x; i < dk; i += blockDim.x) lut_s[i] = src[i];
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int j = threadIdx.x; j < tile; j += blockDim.x) {
    const long long n = base + j;
    if (n < N) {
      float acc[1];
      score_row<CodeT, 1>(codes + n * D, lut_s, D, K, 1, vec8, acc);
      s[j] = acc[0];
      id[j] = static_cast<int>(n);
    } else {
      s[j] = -INFINITY;
      id[j] = kInvalidId;
    }
  }
  __syncthreads();
  bitonic_sort(s, id, tile);
  const size_t dst = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_s[dst + j] = s[j];
    out_i[dst + j] = id[j];
  }
}

// Pass 2. grid (groups, B); block (query b, group g) sorts the pairs of
// lists [g * group, g * group + group) of query b (P slots, the rest
// padding) and writes the first k to out[(b * groups + g) * k ...].
__global__ void topk_merge_kernel(const float* __restrict__ in_s,
                                  const int* __restrict__ in_i,
                                  float* __restrict__ out_s,
                                  int* __restrict__ out_i, int lists,
                                  int group, int k, int P) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                                   // (P,)
  int* id = reinterpret_cast<int*>(smem + P);        // (P,)
  const int b = blockIdx.y;
  const int first_list = blockIdx.x * group;
  const int cnt = min(group, lists - first_list);
  const size_t src = (static_cast<size_t>(b) * lists + first_list) * k;
  const int m = cnt * k;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    if (j < m) {
      s[j] = in_s[src + j];
      id[j] = in_i[src + j];
    } else {
      s[j] = -INFINITY;
      id[j] = kInvalidId;
    }
  }
  __syncthreads();
  bitonic_sort(s, id, P);
  const size_t dst = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_s[dst + j] = s[j];
    out_i[dst + j] = id[j];
  }
}

int next_pow2(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

int sort_threads(int P) {
  const int t = P / 2;
  return t < 32 ? 32 : (t > kMaxSortThreads ? kMaxSortThreads : t);
}

template <typename Kern>
int allow_smem(Kern kern, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool use_vec8(const void* codes, int code_bytes, int D) {
  return code_bytes == 1 && D % 8 == 0
         && (reinterpret_cast<uintptr_t>(codes) & 7u) == 0;
}

template <typename CodeT>
int launch_scores(const float* luts, const CodeT* codes, float* out,
                  long long N, int B, int D, int K, int block_n, bool vec8,
                  cudaStream_t stream) {
  const size_t lut_bytes = static_cast<size_t>(D) * K * sizeof(float);
  int nq = static_cast<int>(kLutBudget / lut_bytes);
  nq = nq < kMaxQ ? nq : kMaxQ;
  nq = nq < B ? nq : B;
  const size_t smem = lut_bytes * nq;
  auto kern = score_kernel<CodeT>;
  const int err = allow_smem(kern, smem);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((N + block_n - 1) / block_n),
                  static_cast<unsigned>((B + nq - 1) / nq));
  kern<<<grid, kScoreThreads, smem, stream>>>(luts, codes, out, N, B, D, K,
                                              block_n, nq, vec8);
  return repro_last_error();
}

template <typename CodeT>
int launch_topk(const float* luts, const CodeT* codes, float* out_s,
                int* out_i, float* s0, int* i0, float* s1, int* i1,
                long long N, int B, int D, int K, int k, int tile,
                bool vec8, cudaStream_t stream) {
  const long long n_tiles = N > 0 ? (N + tile - 1) / tile : 1;
  const size_t smem1 = static_cast<size_t>(tile) * 8
                       + static_cast<size_t>(D) * K * sizeof(float);
  auto kern1 = topk_tile_kernel<CodeT>;
  int err = allow_smem(kern1, smem1);
  if (err) return err;
  float* dst_s = n_tiles == 1 ? out_s : s0;
  int* dst_i = n_tiles == 1 ? out_i : i0;
  kern1<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B)),
          sort_threads(tile), smem1, stream>>>(luts, codes, dst_s, dst_i, N,
                                               D, K, tile, k, vec8);
  err = repro_last_error();
  if (err) return err;
  err = allow_smem(topk_merge_kernel, static_cast<size_t>(kMaxMerge) * 8);
  if (err) return err;
  long long lists = n_tiles;
  const int gmax = kMaxMerge / k;
  while (lists > 1) {
    const int group = static_cast<int>(lists < gmax ? lists : gmax);
    const long long groups = (lists + group - 1) / group;
    const int P = next_pow2(static_cast<long long>(group) * k);
    const float* src_s = dst_s;
    const int* src_i = dst_i;
    if (groups == 1) {
      dst_s = out_s;
      dst_i = out_i;
    } else {
      dst_s = src_s == s0 ? s1 : s0;
      dst_i = src_i == i0 ? i1 : i0;
    }
    topk_merge_kernel<<<dim3(static_cast<unsigned>(groups),
                             static_cast<unsigned>(B)),
                        sort_threads(P), static_cast<size_t>(P) * 8,
                        stream>>>(src_s, src_i, dst_s, dst_i,
                                  static_cast<int>(lists), group, k, P);
    err = repro_last_error();
    if (err) return err;
    lists = groups;
  }
  return 0;
}

bool bad_shape(long long N, int B, int D, int K) {
  return N < 0 || N >= kInvalidId || B <= 0 || B > 65535 || D <= 0 || K <= 0
         || static_cast<size_t>(D) * K * sizeof(float) > kLutBudget;
}

bool bad_topk(long long N, int B, int D, int K, int k, int tile) {
  return bad_shape(N, B, D, K) || k <= 0 || tile < k || tile > kMaxTile
         || (tile & (tile - 1)) != 0
         || static_cast<size_t>(tile) * 8
                + static_cast<size_t>(D) * K * sizeof(float) > kSmemMax;
}

}  // namespace

// luts: (B, D, K) f32 contiguous; codes: (N, D) uint8 (code_bytes 1) or
// int32 (4) contiguous; out: (B, N) f32.  block_n: candidates per block.
// N >= 1.  Returns a cudaError_t (0 on success).
extern "C" int pq_score_batched_launch(const void* luts, const void* codes,
                                       int code_bytes, void* out,
                                       long long N, int B, int D, int K,
                                       int block_n, void* stream) {
  if (bad_shape(N, B, D, K) || N == 0 || block_n <= 0
      || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec8 = use_vec8(codes, code_bytes, D);
  if (code_bytes == 1)
    return launch_scores(l, static_cast<const uint8_t*>(codes), o, N, B, D,
                         K, block_n, vec8, st);
  return launch_scores(l, static_cast<const int32_t*>(codes), o, N, B, D, K,
                       block_n, false, st);
}

// Pairs of scratch a pq_topk launch needs: rows[0] for s0/i0 (each
// (query, tile)'s top k) and rows[1] for s1/i1 (a merge round's output),
// both 0 when one tile covers N.  Returns cudaErrorInvalidValue for a
// shape pq_topk_launch refuses.
extern "C" int pq_topk_scratch(long long N, int B, int D, int K, int k,
                               int tile, long long* rows) {
  if (bad_topk(N, B, D, K, k, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = N > 0 ? (N + tile - 1) / tile : 1;
  const long long gmax = kMaxMerge / k;
  rows[0] = n_tiles > 1 ? static_cast<long long>(B) * n_tiles * k : 0;
  rows[1] = n_tiles > 1
                ? static_cast<long long>(B) * ((n_tiles + gmax - 1) / gmax) * k
                : 0;
  return 0;
}

// luts (B, D, K) f32, codes (N, D) uint8/int32, out_s (B, k) f32, out_i
// (B, k) int32; scratch s0/i0 and s1/i1 of the sizes pq_topk_scratch
// gives.  tile: a power of two in [k, kMaxTile].  Returns a cudaError_t
// (0 on success).
extern "C" int pq_topk_launch(const void* luts, const void* codes,
                              int code_bytes, void* out_s, void* out_i,
                              void* s0, void* i0, void* s1, void* i1,
                              long long N, int B, int D, int K, int k,
                              int tile, void* stream) {
  if (bad_topk(N, B, D, K, k, tile) || (code_bytes != 1 && code_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(luts);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  float* fs0 = static_cast<float*>(s0);
  float* fs1 = static_cast<float*>(s1);
  int* ii0 = static_cast<int*>(i0);
  int* ii1 = static_cast<int*>(i1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec8 = use_vec8(codes, code_bytes, D);
  if (code_bytes == 1)
    return launch_topk(l, static_cast<const uint8_t*>(codes), os, oi, fs0,
                       ii0, fs1, ii1, N, B, D, K, k, tile, vec8, st);
  return launch_topk(l, static_cast<const int32_t*>(codes), os, oi, fs0, ii0,
                     fs1, ii1, N, B, D, K, k, tile, false, st);
}
