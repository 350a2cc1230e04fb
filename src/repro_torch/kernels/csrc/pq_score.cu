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
//       1. selection.  Block (chunk c, query group g) scores candidates
//          [c * chunk, (c + 1) * chunk) for up to kMaxQ queries at once:
//          one pass over each code row, a round of kTopkThreads
//          candidates (one a thread), the group's LUTs in shared memory
//          with the queries innermost, read four at a time (see
//          lut_chunks; on an H100 the scoring kernel's query-major
//          layout made the selection markedly slower).  Each
//          query keeps a threshold, the k-th best (score, id) pair found
//          so far (its score in registers), and a buffer of `cap` > k
//          pairs in shared memory.  A candidate that does not come
//          before the threshold under (score desc, id asc) is dropped in
//          registers; the few that pass are appended to the buffer, a
//          warp at a time (one ballot and one shared atomic).  The warps
//          run their rounds independently and meet only when a buffer
//          overflows: every buffer past k pairs is then sorted (bitonic,
//          all at once) and cut to its first k, whose last pair is its
//          new threshold, and the pairs left over are filtered by it and
//          appended again.  At the end each buffer is sorted once more
//          and its first k pairs written out: one partial list per
//          (query, chunk).  The wrapper sizes the chunks so that one
//          wave of blocks (three an SM, 80 registers a thread) covers N;
//          with random LUTs only some k ln(chunk / k) candidates of a
//          chunk pass.  The worst case is scores that rise with the id:
//          every candidate passes and every round ends in sorts, about
//          as slow as sorting every tile (the design before this one);
//       2. one block per group of partial lists sorts their pairs the
//          same way and keeps the first k, repeated until one list is
//          left (at N = 1M, B = 464, k = 100: 13 lists, one round).
//     Thresholds are full (score, id) pairs, so among equal scores at
//     the k-th place the lowest ids stay, and the order is total (ids
//     are unique; padding pairs are equal; no score is -0.0, see below):
//     the result equals a stable descending sort of pq_score_batched's
//     scores, bit for bit.
//
// Every score is summed in the order d = 0..D-1 with __fadd_rn, starting
// from +0.0, as the plain version (ref.py) sums: the two are
// bit-identical.  +0.0 is where the JAX package's sum starts too, so a
// row of -0.0 terms scores +0.0 there and here.  Codes are widened in
// registers and clamped to [0, K), as mgqe_decode does (codes from a
// build always lie in range).  At D % 8 == 0 a thread loads its row's
// uint8 codes 8 bytes at a time.
//
// The shape limits below (queries per launch, LUT bytes, k, buffer and
// shared-memory sizes, scratch) are checked here: an entry point given
// a shape past them returns cudaErrorInvalidValue.  The wrapper plans a
// pq_topk launch (queries per block, buffer slots, chunk, scratch) from
// the same constants (pq_score.py::topk_plan), and this entry point
// re-checks the plan it is given.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;           // queries per block, batched kernel
constexpr int kScoreThreads = 256;  // threads per block, batched kernel
constexpr int kMaxSortThreads = 1024;
constexpr int kMaxMerge = 16384;    // pairs one merge block sorts (128 KB)
constexpr int kTopkThreads = 256;   // candidates per selection round
constexpr int kTopkBlocksPerSm = 3; // selection blocks an SM holds
constexpr int kMaxK = 8192;
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

// The selection state of one block: per query a buffer of `cap` pairs,
// its fill count and its threshold (the k-th best pair so far), and the
// list of buffers to reduce.
struct Select {
  float* s;            // (qb, cap)
  int* id;             // (qb, cap)
  int* cnt;            // (kMaxQ,)
  float* th_s;         // (kMaxQ,)
  int* th_i;           // (kMaxQ,)
  int* sel;            // (kMaxQ,) buffers to reduce: sel[0..*n_sel)
  int* n_sel;
  int cap;
};

// Sorts the buffers listed in sel (padded past their counts) and cuts
// each to its first k; a buffer of k pairs or more sets its threshold to
// its k-th pair.  Called by the whole block; starts and ends with a
// barrier.
__device__ void reduce_buffers(const Select& st, int k) {
  const int cap = st.cap;
  __syncthreads();
  const int m = *st.n_sel;
  for (int t = threadIdx.x; t < m * cap; t += blockDim.x) {
    const int q = st.sel[t / cap];
    const int j = t % cap;
    if (j >= st.cnt[q]) {
      st.s[q * cap + j] = -INFINITY;
      st.id[q * cap + j] = kInvalidId;
    }
  }
  __syncthreads();
  const int half = cap / 2;
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < m * half; t += blockDim.x) {
        const int seg = t / half;
        const int u = t - seg * half;
        const int i = 2 * u - (u & (stride - 1));
        const int base = st.sel[seg] * cap;
        float* s = st.s + base;
        int* id = st.id + base;
        const float si = s[i], sj = s[i + stride];
        const int ii = id[i], ij = id[i + stride];
        const bool up = (i & size) == 0;
        if (up ? first(sj, ij, si, ii) : first(si, ii, sj, ij)) {
          s[i] = sj;
          s[i + stride] = si;
          id[i] = ij;
          id[i + stride] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int q = st.sel[t];
    if (st.cnt[q] >= k) {
      st.cnt[q] = k;
      st.th_s[q] = st.s[q * cap + k - 1];
      st.th_i[q] = st.id[q * cap + k - 1];
    }
  }
  __syncthreads();
}

// The selection kernel's LUT layout: (D, K, width) with the block's
// queries innermost, so one code c of subspace d serves the queries from
// one row.  From 4 queries up, the row is `width` = 4 * chunks floats
// read as float4 (four queries a load); chunk j of row (d, c) is stored
// at slot j ^ (c & (chunks - 1)), so a quarter-warp's eight float4 loads
// of random codes spread over all eight 16-byte bank groups.  Below 4
// queries the row is `width` = qb floats read one at a time.
__device__ __forceinline__ int lut_chunks(int qb) {
  return qb < 4 ? 0 : (qb <= 4 ? 1 : (qb <= 8 ? 2 : 4));
}

__device__ __forceinline__ int lut_width(int qb) {
  const int j = lut_chunks(qb);
  return j ? 4 * j : qb;
}

// acc[q] += the (d, c) row's entry of query q, for every query of the
// block (q >= nq: padding, never read)
__device__ __forceinline__ void add_row(float (&acc)[kMaxQ],
                                        const float* lut_s, int d, int c,
                                        int K, int chunks, int width) {
  const int r = d * K + c;
  if (chunks) {
    const float4* row = reinterpret_cast<const float4*>(lut_s) + r * chunks;
#pragma unroll
    for (int j = 0; j < kMaxQ / 4; ++j) {
      if (j < chunks) {
        const float4 v = row[j ^ (c & (chunks - 1))];
        acc[4 * j] = __fadd_rn(acc[4 * j], v.x);
        acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], v.y);
        acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], v.z);
        acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], v.w);
      }
    }
  } else {
    const float* row = lut_s + r * width;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < width) acc[q] = __fadd_rn(acc[q], row[q]);
  }
}

// Appends the pairs (acc[q], id) of the queries set in `pend` to their
// buffers, a warp at a time (one ballot and one shared atomic a query);
// clears the bits it placed.  A pair past its buffer's end stays in
// `pend` and raises `flag`: the block must reduce that buffer.
__device__ __forceinline__ void append(unsigned& pend,
                                       const float (&acc)[kMaxQ], int id,
                                       int nq, const Select& st,
                                       int* flag) {
  if (!__any_sync(0xffffffffu, pend != 0)) return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    if (q < nq) {
      const bool want = (pend >> q) & 1u;
      const unsigned mask = __ballot_sync(0xffffffffu, want);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int pos = 0;
        if (lane == leader) pos = atomicAdd(&st.cnt[q], __popc(mask));
        pos = __shfl_sync(0xffffffffu, pos, leader)
              + __popc(mask & ((1u << lane) - 1u));
        if (want && pos < st.cap) {
          st.s[q * st.cap + pos] = acc[q];
          st.id[q * st.cap + pos] = id;
          pend &= ~(1u << q);
        }
      }
    }
  }
  if (pend) *flag = 1;
}

// The thresholds' scores in registers (ids are read from shared memory
// only on a tie), reloaded after every reduction.
__device__ __forceinline__ void load_thresholds(float (&ts)[kMaxQ],
                                                const Select& st) {
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) ts[q] = st.th_s[q];
}

__device__ __forceinline__ bool passes(float score, int id, float ts,
                                       const Select& st, int q) {
  return score > ts || (score == ts && id < st.th_i[q]);
}

// Pass 1. grid (chunks, ceil(B / qb)); block (chunk c, query group g)
// writes, for each query b of its group, the first k pairs of
// candidates [c * chunk, min((c + 1) * chunk, N)) to
// out[(b * chunks + c) * k ...], padded with (-inf, kInvalidId).
//
// The warps run their rounds independently; they meet only to reduce.
// A warp that leaves a pair unplaced raises `flag` and every warp joins
// the reduction at the end of its round.  A warp that has finished its
// rounds keeps joining reductions until every warp has finished.
template <typename CodeT>
__global__ void __launch_bounds__(kTopkThreads, kTopkBlocksPerSm)
    topk_select_kernel(const float* __restrict__ luts,
                       const CodeT* __restrict__ codes,
                       float* __restrict__ out_s, int* __restrict__ out_i,
                       long long N, int B, int D, int K, int k,
                       long long chunk, int qb, int cap, bool vec8) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int cnt[kMaxQ], th_i[kMaxQ], sel[kMaxQ];
  __shared__ float th_s[kMaxQ];
  __shared__ int n_sel, flag, finished;
  const int dk = D * K;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, B - q0);
  const int chunks = lut_chunks(qb);
  const int width = lut_width(qb);
  float* lut_s = smem;                                   // (D, K, width)
  float* buf_s = smem + static_cast<size_t>(width) * dk;     // (qb, cap)
  int* buf_i = reinterpret_cast<int*>(buf_s + static_cast<size_t>(qb) * cap);
  const Select st{buf_s, buf_i, cnt, th_s, th_i, sel, &n_sel, cap};
  const float* src = luts + static_cast<size_t>(q0) * dk;
  for (int i = threadIdx.x; i < nq * dk; i += blockDim.x) {
    const int q = i / dk;
    const int r = i - q * dk;                // d * K + c
    const int slot = chunks ? 4 * ((q / 4) ^ (r % K & (chunks - 1))) + q % 4
                            : q;
    lut_s[r * width + slot] = src[i];
  }
  if (threadIdx.x < kMaxQ) {
    cnt[threadIdx.x] = 0;
    th_s[threadIdx.x] = -INFINITY;        // (-inf, kInvalidId): all pass
    th_i[threadIdx.x] = kInvalidId;
  }
  if (threadIdx.x == 0) {
    flag = 0;
    finished = 0;
  }
  __syncthreads();
  float ts[kMaxQ];
  load_thresholds(ts, st);
  float acc[kMaxQ];
  unsigned pend = 0;                    // queries this lane's pair passes
  int id = 0;

  // every warp of the block: reduce the buffers that overflowed, then
  // place the pairs left over (those that still pass), until none is
  // left.  Returns whether every warp had finished its rounds (read while
  // every warp is inside, so all agree).
  auto reduce_overflow = [&]() {
    int done = 0;
    do {
      __syncthreads();                  // every warp's appends visible
      done = finished;
      if (threadIdx.x == 0) {
        // every buffer past k pairs, not only the full ones: their
        // thresholds rise together and the block meets less often
        int m = 0;
        for (int q = 0; q < nq; ++q) {
          if (cnt[q] > k) {
            cnt[q] = min(cnt[q], cap);
            sel[m++] = q;
          }
        }
        n_sel = m;
        flag = 0;
      }
      reduce_buffers(st, k);
      load_thresholds(ts, st);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (((pend >> q) & 1u) && !passes(acc[q], id, ts[q], st, q))
          pend &= ~(1u << q);
      append(pend, acc, id, nq, st, &flag);
    } while (__syncthreads_or(pend != 0));
    return done == kTopkThreads / 32;
  };

  const long long start = static_cast<long long>(blockIdx.x) * chunk;
  const long long stop = min(start + chunk, N);
  for (long long base = start; base < stop; base += kTopkThreads) {
    const long long n = base + threadIdx.x;
    id = static_cast<int>(n);
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.0f;
    pend = 0;
    if (n < stop) {
      const CodeT* row = codes + n * D;
      if (sizeof(CodeT) == 1 && vec8) {
        const unsigned long long* w =
            reinterpret_cast<const unsigned long long*>(row);
        for (int j = 0; j < D / 8; ++j) {
          const unsigned long long word = w[j];
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int c = static_cast<int>((word >> (8 * b)) & 0xffull);
            add_row(acc, lut_s, j * 8 + b, c < K ? c : K - 1, K, chunks,
                    width);
          }
        }
      } else {
        for (int d = 0; d < D; ++d)
          add_row(acc, lut_s, d, widen(row[d], K), K, chunks, width);
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q)
        if (q < nq && passes(acc[q], id, ts[q], st, q)) pend |= 1u << q;
    }
    append(pend, acc, id, nq, st, &flag);
    if (__any_sync(0xffffffffu, *static_cast<volatile int*>(&flag) != 0))
      reduce_overflow();
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(&finished, 1);
  while (!reduce_overflow()) {
  }

  if (threadIdx.x < nq) sel[threadIdx.x] = threadIdx.x;
  if (threadIdx.x == 0) n_sel = nq;
  reduce_buffers(st, k);
  for (int t = threadIdx.x; t < nq * k; t += blockDim.x) {
    const int q = t / k;
    const int j = t - q * k;
    const size_t dst =
        (static_cast<size_t>(q0 + q) * gridDim.x + blockIdx.x) * k + j;
    out_s[dst] = buf_s[q * cap + j];
    out_i[dst] = buf_i[q * cap + j];
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

// Shared memory of a selection block: the group's LUTs, interleaved
// (lut_width(qb) floats a row), and its buffers.
size_t select_smem(int qb, int D, int K, int cap) {
  const int width = qb < 4 ? qb : (qb <= 4 ? 4 : (qb <= 8 ? 8 : 16));
  return static_cast<size_t>(width) * D * K * sizeof(float)
         + static_cast<size_t>(qb) * cap * 8;
}

template <typename CodeT>
int launch_topk(const float* luts, const CodeT* codes, float* out_s,
                int* out_i, float* s0, int* i0, float* s1, int* i1,
                long long N, int B, int D, int K, int k, int qb, int cap,
                long long chunk, bool vec8, cudaStream_t stream) {
  const long long chunks = N > 0 ? (N + chunk - 1) / chunk : 1;
  const size_t smem1 = select_smem(qb, D, K, cap);
  auto kern1 = topk_select_kernel<CodeT>;
  int err = allow_smem(kern1, smem1);
  if (err) return err;
  float* dst_s = chunks == 1 ? out_s : s0;
  int* dst_i = chunks == 1 ? out_i : i0;
  kern1<<<dim3(static_cast<unsigned>(chunks),
               static_cast<unsigned>((B + qb - 1) / qb)),
          kTopkThreads, smem1, stream>>>(luts, codes, dst_s, dst_i, N, B, D,
                                         K, k, chunk, qb, cap, vec8);
  err = repro_last_error();
  if (err) return err;
  err = allow_smem(topk_merge_kernel, static_cast<size_t>(kMaxMerge) * 8);
  if (err) return err;
  long long lists = chunks;
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

// A pq_topk plan the kernels cannot run: k past kMaxK, more queries a
// block than kMaxQ, a buffer that is not a power of two or holds no more
// than k pairs, too much shared memory, or scratch smaller than
// the partial lists (rows0: B * chunks * k pairs) and the first merge
// round's output (rows1) need.
bool bad_topk(long long N, int B, int D, int K, int k, int qb, int cap,
              long long chunk, long long rows0, long long rows1) {
  if (bad_shape(N, B, D, K) || k <= 0 || k > kMaxK || qb <= 0 || qb > kMaxQ
      || cap <= k || cap > 4 * kMaxMerge
      || (cap & (cap - 1)) != 0 || chunk <= 0
      || select_smem(qb, D, K, cap) > kSmemMax)
    return true;
  const long long chunks = N > 0 ? (N + chunk - 1) / chunk : 1;
  if (chunks > 0x7fffffff / k) return true;
  const long long gmax = kMaxMerge / k;
  const long long need0 = chunks > 1 ? static_cast<long long>(B) * chunks * k
                                     : 0;
  const long long groups = (chunks + gmax - 1) / gmax;
  const long long need1 = groups > 1 ? static_cast<long long>(B) * groups * k
                                     : 0;
  return rows0 < need0 || rows1 < need1;
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

// luts (B, D, K) f32, codes (N, D) uint8/int32, out_s (B, k) f32, out_i
// (B, k) int32.  The plan (pq_score.py::topk_plan): qb queries a block,
// cap buffer slots a query (a power of two > k), chunk
// candidates a block; scratch s0/i0 of rows0 pairs (each (query,
// chunk)'s first k) and s1/i1 of rows1 (a merge round's output).
// Returns a cudaError_t (0 on success).
extern "C" int pq_topk_launch(const void* luts, const void* codes,
                              int code_bytes, void* out_s, void* out_i,
                              void* s0, void* i0, void* s1, void* i1,
                              long long N, int B, int D, int K, int k,
                              int qb, int cap, long long chunk,
                              long long rows0, long long rows1,
                              void* stream) {
  if (bad_topk(N, B, D, K, k, qb, cap, chunk, rows0, rows1)
      || (code_bytes != 1 && code_bytes != 4))
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
                       ii0, fs1, ii1, N, B, D, K, k, qb, cap, chunk, vec8,
                       st);
  return launch_topk(l, static_cast<const int32_t*>(codes), os, oi, fs0, ii0,
                     fs1, ii1, N, B, D, K, k, qb, cap, chunk, false, st);
}
