// ADC scoring of a PQ-coded candidate corpus on Hopper: three kernels
// that share one layout (codes (N, D) uint8 or int32, one LUT (D, K) f32
// per query) and one contract.
//
//   pq_score_batched  luts (B, D, K), codes (N, D) -> scores (B, N),
//                     scores[b, n] = sum over d = 0..D-1 of
//                     luts[b, d, codes[n, d]]
//   pq_score          the same kernels at B = 1
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
//     B*D*K*4 LUT bytes and write B*N*4 score bytes (1.86 GB at the
//     retrieval flush, B = 464, N = 1M).  Every (query, candidate,
//     subspace) term is one LUT read from shared memory, B*N*D*4 bytes
//     in all (14.8 GB at the flush): at 128 bytes a clock an SM about
//     as long as the score stores if the reads are free of bank
//     conflicts, and three times longer if a warp's 32 lanes gather
//     32 random codes' entries.  So from 9 queries the queries lie
//     across the lanes (the lanes route, below), and a quarter warp's
//     reads are one 128-byte row; small batches keep a thread a
//     candidate (the rows route).
//   * pq_topk: operations (the B*N*D adds; it writes only B*k pairs).
//     The TPU kernel carried a running top-k from one grid step to the
//     next; blocks here run in no order, so it takes two passes:
//       1. selection.  Block (chunk c, query group g) scores candidates
//          [c * chunk, (c + 1) * chunk) for up to kMaxQ queries at once:
//          one pass over each code row, a round of kTopkThreads
//          candidates (one a thread), the group's LUTs in shared memory
//          with the queries innermost, read four at a time (see
//          lut_chunks; on an H100 a query-major layout made the
//          selection markedly slower).  Each
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
// a shape past them returns cudaErrorInvalidValue.  The wrapper plans
// each scoring launch (route, query groups, spans, shared memory) and
// each pq_topk launch (queries per block, buffer slots, chunk, scratch)
// from the same constants (pq_score.py::score_plan, ::topk_plan), and
// the entry points re-check the plans they are given.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxQ = 16;           // queries per block, pq_topk
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

// ---------------------------------------------------------------------
// Scoring (pq_score, pq_score_batched).  Two routes; the wrapper plans
// each launch (pq_score.py::score_plan) and score_launch re-checks it.
//
// lanes route (queries across the lanes): a block holds the LUTs of a
// group of kLaneQ = 32 queries in shared memory laid out (D*K, 32), the
// query innermost, so the row of (subspace d, code c) is 128 contiguous
// bytes; its warps walk tiles of kLaneTile = 32 candidates.  Lane
// (g, i) = (lane / 8, lane % 8) scores queries 4i .. 4i+3 for the eight
// candidates 4g .. 4g+3 and 16+4g .. 16+4g+3 of the tile: one 16-byte
// read of a row serves four queries, and the eight lanes of a quarter
// warp read one whole row (one wavefront, no bank conflict).  Each
// candidate's codes are read once a lane group (a broadcast), so a
// tile's 32 x 32 x D terms take D * 8 reads a lane.  The sums stay in
// registers and go straight out: for each of its four queries a lane
// stores 4 + 4 consecutive scores, and the four lane groups together
// write 64 contiguous bytes of each of eight rows a store.  A tile's
// codes come in by cp.async into a per-warp double buffer while the
// previous tile is scored.  A warp checks once a tile whether any code
// is past K - 1 and only then takes the clamping loop.
//
// rows route (one thread a candidate): for small batches and for LUTs
// too large for 32 queries.  A block holds W <= 16 queries' LUTs laid
// out (D*K, W) with the queries innermost (float4 reads of four
// queries from W = 4; the 16-byte chunks of a row are XOR-swizzled by
// the row index so that random rows spread over the eight bank
// groups); each thread scores kRowsUnroll candidates at a time, its
// codes read from device memory, and stores are coalesced along n.
//
// Which route (score_plan): with 32 queries' LUTs within kLanesLutMax,
// B <= 8 takes the rows route (one group, W the next power of two
// >= B); a larger B takes the lanes route for its 32-query groups, and
// a remainder r = B mod 32 goes to the rows route when r <= 8 (a second
// launch), else to a masked lanes group.  With larger LUTs every query
// takes the rows route, W the largest power of two <= 16 whose LUTs fit
// kLutBudget.  Both routes' blocks are persistent over a span of
// candidates: grid (splits, query groups), about one wave.

constexpr int kLaneQ = 32;          // queries a lanes group
constexpr int kLaneTile = 32;       // candidates a warp scores at a time
constexpr int kPerLane = 8;         // candidates a lane scores in a tile
constexpr int kLanesThreads = 256;  // threads a lanes-route block
constexpr int kLanesBlocksPerSm = 2;  // its registers allow two an SM
constexpr int kRowsThreads = 256;   // threads a rows-route block
constexpr int kRowsUnroll = 2;      // candidates a thread scores at once
constexpr size_t kLanesLutMax = 128 * 1024;  // 32 queries' LUT bytes
constexpr int kRouteLanes = 0;
constexpr int kRouteRows = 1;

// Bytes of a lanes-route block's dynamic shared memory: the group's LUTs
// and, per warp, the double code buffer.
size_t lanes_buf_bytes(int D, int code_bytes) {
  return (static_cast<size_t>(kLaneTile) * D * code_bytes + 15) / 16 * 16;
}

size_t lanes_smem(int D, int K, int code_bytes, int warps) {
  return static_cast<size_t>(D) * K * kLaneQ * 4
         + static_cast<size_t>(warps) * 2 * lanes_buf_bytes(D, code_bytes);
}

size_t rows_smem(int D, int K, int W) {
  return static_cast<size_t>(W) * D * K * 4;
}

// The tile slot of a lane's candidate c (lane group g): 4g .. 4g+3 and
// 16+4g .. 16+4g+3.
__device__ __forceinline__ int lane_cand(int g, int c) {
  return (c < 4 ? 0 : 16 - 4) + 4 * g + c;
}

// One tile's sums for lane (g, i): acc[c].{x,y,z,w} = the scores of
// queries 4i .. 4i+3 for candidate lane_cand(g, c), summed over d =
// 0..D-1 in order from +0.0.  buf holds the tile's code rows (row t at
// t * D codes); lut_quad = the group's LUTs + 4i.  CPW codes are read at
// once (a uint2 of 8 uint8 codes, a word of 4, an int4 of 4 int32 codes,
// or one).
template <typename CodeT, int CPW, bool kClamp>
__device__ __forceinline__ void lanes_tile(float4 (&acc)[kPerLane],
                                           const unsigned char* buf,
                                           const float* lut_quad, int D,
                                           int K, int g) {
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const CodeT* rows = reinterpret_cast<const CodeT*>(buf);
  const int words = D / CPW;
  const int kq = K * kLaneQ;
  for (int j = 0; j < words; ++j) {
    const float* lj = lut_quad + static_cast<size_t>(j) * CPW * kq;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const CodeT* row = rows + lane_cand(g, c) * D + j * CPW;
      uint32_t code[CPW];
      if constexpr (sizeof(CodeT) == 1 && CPW == 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(row);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          code[b] = __byte_perm(b < 4 ? w.x : w.y, 0u, 0x4440u | (b & 3));
      } else if constexpr (sizeof(CodeT) == 1 && CPW == 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row);
#pragma unroll
        for (int b = 0; b < 4; ++b) code[b] = __byte_perm(w, 0u, 0x4440u | b);
      } else if constexpr (CPW == 4) {
        const int4 w = *reinterpret_cast<const int4*>(row);
        code[0] = static_cast<uint32_t>(widen(w.x, K));
        code[1] = static_cast<uint32_t>(widen(w.y, K));
        code[2] = static_cast<uint32_t>(widen(w.z, K));
        code[3] = static_cast<uint32_t>(widen(w.w, K));
      } else {
        code[0] = static_cast<uint32_t>(widen(row[0], K));
      }
#pragma unroll
      for (int b = 0; b < CPW; ++b) {
        uint32_t cb = code[b];
        if constexpr (kClamp && sizeof(CodeT) == 1)
          cb = min(cb, static_cast<uint32_t>(K - 1));
        const float4 v =
            *reinterpret_cast<const float4*>(lj + b * kq + cb * kLaneQ);
        acc[c].x = __fadd_rn(acc[c].x, v.x);
        acc[c].y = __fadd_rn(acc[c].y, v.y);
        acc[c].z = __fadd_rn(acc[c].z, v.z);
        acc[c].w = __fadd_rn(acc[c].w, v.w);
      }
    }
  }
}

__device__ __forceinline__ float quad_part(const float4& v, int qq) {
  return qq == 0 ? v.x : (qq == 1 ? v.y : (qq == 2 ? v.z : v.w));
}

// Whether a uint8 tile holds a code past K - 1 (the warp agrees).
__device__ __forceinline__ bool tile_needs_clamp(const unsigned char* buf,
                                                 int bytes, int K) {
  bool past = false;
  if (K < 256) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(buf);
    for (int i = threadIdx.x & 31; i < bytes / 4; i += 32) {
      const uint32_t v = w[i];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        past |= static_cast<int>((v >> (8 * b)) & 0xffu) >= K;
    }
  }
  return __any_sync(0xffffffffu, past);
}

// Lanes route.  grid (splits, groups): block (s, g) scores candidates
// [s * span, min((s + 1) * span, N)) for queries q0 + 32 g .. (nqg of
// them, the last group possibly fewer).  span is a multiple of
// kLaneTile; each warp takes every warps-th tile of the span.
template <typename CodeT, int CPW>
__global__ void __launch_bounds__(kLanesThreads, kLanesBlocksPerSm)
    lanes_kernel(const float* __restrict__ luts,
                 const CodeT* __restrict__ codes, float* __restrict__ out,
                 long long N, int D, int K, int q0, int nq, long long span,
                 int buf_bytes, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  const int dk = D * K;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* lut_s = reinterpret_cast<float*>(smem_b);          // (D*K, 32)
  unsigned char* wbuf = smem_b + static_cast<size_t>(dk) * kLaneQ * 4
                        + static_cast<size_t>(warp) * 2 * buf_bytes;
  const int g = lane >> 3;                 // candidate group
  const int quad = lane & 7;               // queries 4 quad .. + 3
  const int qg0 = q0 + static_cast<int>(blockIdx.y) * kLaneQ;
  const int nqg = min(kLaneQ, q0 + nq - qg0);

  // stage the group's LUTs: thread i takes query i % 32 and rows
  // 4 (i / 32) .. + 3 (one float4 where the rows allow), zeros past nqg
  const float* src = luts + static_cast<size_t>(qg0) * dk;
  const bool vec_lut = dk % 4 == 0
                       && (reinterpret_cast<uintptr_t>(luts) & 15u) == 0;
  for (int i = threadIdx.x; i < (dk + 3) / 4 * kLaneQ; i += blockDim.x) {
    const int q = i & (kLaneQ - 1);
    const int r = (i >> 5) * 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (q < nqg) {
      const float* s = src + static_cast<size_t>(q) * dk + r;
      if (vec_lut) {
        const float4 f = *reinterpret_cast<const float4*>(s);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (r + e < dk) v[e] = s[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r + e < dk) lut_s[(r + e) * kLaneQ + q] = v[e];
  }
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * span;
  const long long stop = min(start + span, N);
  const int row_bytes = D * static_cast<int>(sizeof(CodeT));
  const unsigned char* code_bytes =
      reinterpret_cast<const unsigned char*>(codes);
  // a tile's code rows into buffer `slot` (one commit group a call)
  auto load = [&](long long n0, int slot) {
    const int valid = static_cast<int>(
        min(static_cast<long long>(kLaneTile), N - n0)) * row_bytes;
    unsigned char* dst = wbuf + slot * buf_bytes;
    const unsigned char* s = code_bytes + n0 * row_bytes;
    if (aligned) {
      for (int i = lane; i * 16 < buf_bytes; i += 32) {
        const int left = valid - 16 * i;
        const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
        cp_async16(dst + 16 * i, bytes ? s + 16 * i : s, bytes);
      }
    } else {
      for (int i = lane; i < buf_bytes; i += 32) dst[i] = i < valid ? s[i] : 0;
    }
    cp_async_commit();
  };

  const long long step = static_cast<long long>(warps) * kLaneTile;
  long long n0 = start + static_cast<long long>(warp) * kLaneTile;
  if (n0 < stop) load(n0, 0);
  for (int it = 0; n0 < stop; ++it, n0 += step) {
    if (n0 + step < stop) {
      load(n0 + step, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned char* buf = wbuf + (it & 1) * buf_bytes;
    const int rows = static_cast<int>(min(static_cast<long long>(kLaneTile),
                                          N - n0));
    float4 acc[kPerLane];
    bool clamp = true;
    if constexpr (sizeof(CodeT) == 1)
      clamp = tile_needs_clamp(buf, buf_bytes, K);
    if (clamp)
      lanes_tile<CodeT, CPW, true>(acc, buf, lut_s + 4 * quad, D, K, g);
    else
      lanes_tile<CodeT, CPW, false>(acc, buf, lut_s + 4 * quad, D, K, g);
    __syncwarp();        // every lane is done with buf before it reloads
    // query 4 quad + qq: candidates 4g .. 4g+3, then 16+4g .. 16+4g+3
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int r = 4 * quad + qq;
      if (r >= nqg) continue;
      float* o = out + static_cast<size_t>(qg0 + r) * N + n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * h + 4 * g;
        const float4 v = make_float4(
            quad_part(acc[4 * h], qq), quad_part(acc[4 * h + 1], qq),
            quad_part(acc[4 * h + 2], qq), quad_part(acc[4 * h + 3], qq));
        if ((N & 3) == 0 && t + 4 <= rows) {
          *reinterpret_cast<float4*>(o + t) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
          for (int j = 0; j < 4 && t + j < rows; ++j) o[t + j] = e[j];
        }
      }
    }
  }
}

// The float index of query q's entry in row r of a rows-route LUT
// (W queries a row; from W = 4 in 16-byte chunks, chunk j stored at
// j ^ swz(r)).
template <int W>
__device__ __forceinline__ int rows_swz(int r) {
  constexpr int kCh = W / 4;
  return kCh > 1 ? (r / (8 / kCh)) & (kCh - 1) : 0;
}

template <int W>
__device__ __forceinline__ int rows_slot(int r, int q) {
  if constexpr (W < 4) {
    return r * W + q;
  } else {
    return r * W + 4 * ((q >> 2) ^ rows_swz<W>(r)) + (q & 3);
  }
}

// acc[q] += row r's entry of query q, for the W queries of the row
template <int W>
__device__ __forceinline__ void rows_add(float (&acc)[W],
                                         const float* lut_s, int r) {
  if constexpr (W == 1) {
    acc[0] = __fadd_rn(acc[0], lut_s[r]);
  } else if constexpr (W == 2) {
    const float2 v = reinterpret_cast<const float2*>(lut_s)[r];
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
  } else {
    constexpr int kCh = W / 4;
    const float4* row = reinterpret_cast<const float4*>(lut_s) + r * kCh;
    const int swz = rows_swz<W>(r);
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const float4 v = row[j ^ swz];
      acc[4 * j] = __fadd_rn(acc[4 * j], v.x);
      acc[4 * j + 1] = __fadd_rn(acc[4 * j + 1], v.y);
      acc[4 * j + 2] = __fadd_rn(acc[4 * j + 2], v.z);
      acc[4 * j + 3] = __fadd_rn(acc[4 * j + 3], v.w);
    }
  }
}

// Rows route.  grid (splits, groups): block (s, g) scores candidates
// [s * span, min((s + 1) * span, N)) for queries q0 + W g .. (nqg of
// them); thread t scores candidates t, t + 256, ... of each step of
// kRowsUnroll * 256.
template <typename CodeT, int W>
__global__ void __launch_bounds__(kRowsThreads)
    rows_kernel(const float* __restrict__ luts,
                const CodeT* __restrict__ codes, float* __restrict__ out,
                long long N, int D, int K, int q0, int nq, long long span,
                bool vec8) {
  extern __shared__ __align__(16) float lut_w[];          // (D*K, W)
  const int dk = D * K;
  const int qg0 = q0 + static_cast<int>(blockIdx.y) * W;
  const int nqg = min(W, q0 + nq - qg0);
  const float* src = luts + static_cast<size_t>(qg0) * dk;
  for (int i = threadIdx.x; i < dk * W; i += blockDim.x) {
    const int q = i % W;
    const int r = i / W;
    lut_w[rows_slot<W>(r, q)] = q < nqg ? src[static_cast<size_t>(q) * dk + r]
                                        : 0.0f;
  }
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * span;
  const long long stop = min(start + span, N);
  for (long long base = start; base < stop;
       base += static_cast<long long>(kRowsUnroll) * blockDim.x) {
    long long n[kRowsUnroll];
    bool ok[kRowsUnroll];
    float acc[kRowsUnroll][W];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      n[u] = base + threadIdx.x + static_cast<long long>(u) * blockDim.x;
      ok[u] = n[u] < stop;
      n[u] = ok[u] ? n[u] : start;     // a valid row, scored and dropped
#pragma unroll
      for (int q = 0; q < W; ++q) acc[u][q] = 0.0f;
    }
    if (sizeof(CodeT) == 1 && vec8) {
      for (int j = 0; j < D / 8; ++j) {
        unsigned long long w[kRowsUnroll];
#pragma unroll
        for (int u = 0; u < kRowsUnroll; ++u)
          w[u] = reinterpret_cast<const unsigned long long*>(
              codes + n[u] * D)[j];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
#pragma unroll
          for (int u = 0; u < kRowsUnroll; ++u) {
            const int c = static_cast<int>((w[u] >> (8 * b)) & 0xffull);
            rows_add<W>(acc[u], lut_w, (j * 8 + b) * K + (c < K ? c : K - 1));
          }
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        int c[kRowsUnroll];
#pragma unroll
        for (int u = 0; u < kRowsUnroll; ++u)
          c[u] = widen(codes[n[u] * D + d], K);
#pragma unroll
        for (int u = 0; u < kRowsUnroll; ++u)
          rows_add<W>(acc[u], lut_w, d * K + c[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int q = 0; q < W; ++q)
        if (q < nqg) out[static_cast<size_t>(qg0 + q) * N + n[u]] = acc[u][q];
    }
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

// One scoring launch of a checked plan (bad_score).
template <typename CodeT>
int launch_score(const float* luts, const CodeT* codes, float* out,
                 long long N, int D, int K, int route, int q0, int nq,
                 int width, int splits, long long span, int threads,
                 size_t smem, bool aligned, bool vec8,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(splits),
                  static_cast<unsigned>((nq + width - 1) / width));
  if (route == kRouteLanes) {
    const int buf = static_cast<int>(lanes_buf_bytes(D, sizeof(CodeT)));
    auto go = [&](auto kern) {
      const int err = allow_smem(kern, smem);
      if (err) return err;
      kern<<<grid, threads, smem, stream>>>(luts, codes, out, N, D, K, q0,
                                            nq, span, buf, aligned);
      return repro_last_error();
    };
    if constexpr (sizeof(CodeT) == 1) {
      if (D % 8 == 0) return go(lanes_kernel<CodeT, 8>);
      if (D % 4 == 0) return go(lanes_kernel<CodeT, 4>);
      return go(lanes_kernel<CodeT, 1>);
    } else {
      if (D % 4 == 0) return go(lanes_kernel<CodeT, 4>);
      return go(lanes_kernel<CodeT, 1>);
    }
  }
  auto go = [&](auto kern) {
    const int err = allow_smem(kern, smem);
    if (err) return err;
    kern<<<grid, kRowsThreads, smem, stream>>>(luts, codes, out, N, D, K,
                                               q0, nq, span, vec8);
    return repro_last_error();
  };
  switch (width) {
    case 1: return go(rows_kernel<CodeT, 1>);
    case 2: return go(rows_kernel<CodeT, 2>);
    case 4: return go(rows_kernel<CodeT, 4>);
    case 8: return go(rows_kernel<CodeT, 8>);
    default: return go(rows_kernel<CodeT, 16>);
  }
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

// A scoring launch the kernels cannot run: queries outside [0, B), a
// span that is not a multiple of the route's tile or leaves a block
// empty, a width or block size the route does not take, LUTs past the
// route's limit, or shared memory other than the route needs (the plan
// must agree with this file: pq_score.py::score_plan).
bool bad_score(long long N, int B, int D, int K, int code_bytes, int route,
               int q0, int nq, int width, int splits, long long span,
               int threads, long long smem) {
  if (bad_shape(N, B, D, K) || N == 0 || (code_bytes != 1 && code_bytes != 4)
      || q0 < 0 || nq <= 0 || q0 + nq > B || splits <= 0 || span <= 0
      || static_cast<long long>(splits) * span < N
      || static_cast<long long>(splits - 1) * span >= N || smem <= 0
      || static_cast<size_t>(smem) > kSmemMax)
    return true;
  if (route == kRouteLanes)
    return width != kLaneQ || span % kLaneTile != 0
           || threads != kLanesThreads
           || static_cast<size_t>(D) * K * kLaneQ * 4 > kLanesLutMax
           || static_cast<size_t>(smem)
                  != lanes_smem(D, K, code_bytes, threads / 32);
  if (route == kRouteRows)
    return (width != 1 && width != 2 && width != 4 && width != 8
            && width != 16)
           || threads != kRowsThreads
           || static_cast<size_t>(smem) != rows_smem(D, K, width)
           || static_cast<size_t>(smem) > kLutBudget;
  return true;
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
// int32 (4) contiguous; out: (B, N) f32.  One launch of a plan
// (pq_score.py::score_plan): route 0 (lanes) or 1 (rows), queries
// [q0, q0 + nq) in groups of `width`, `splits` blocks a group of `span`
// candidates each, `threads` a block, `smem` bytes of dynamic shared
// memory.  Returns a cudaError_t (0 on success).
extern "C" int pq_score_batched_launch(const void* luts, const void* codes,
                                       int code_bytes, void* out,
                                       long long N, int B, int D, int K,
                                       int route, int q0, int nq, int width,
                                       int splits, long long span,
                                       int threads, long long smem,
                                       void* stream) {
  if (bad_score(N, B, D, K, code_bytes, route, q0, nq, width, splits, span,
                threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  const bool vec8 = use_vec8(codes, code_bytes, D);
  const size_t sm = static_cast<size_t>(smem);
  if (code_bytes == 1)
    return launch_score(l, static_cast<const uint8_t*>(codes), o, N, D, K,
                        route, q0, nq, width, splits, span, threads, sm,
                        aligned, vec8, st);
  return launch_score(l, static_cast<const int32_t*>(codes), o, N, D, K,
                      route, q0, nq, width, splits, span, threads, sm,
                      aligned, false, st);
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
