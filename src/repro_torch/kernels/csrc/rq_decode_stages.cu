// Residual-quantization serving decode on Hopper: codes (B, M) + stacked
// full-width codebooks (M, K, d) -> rows (B, d),
//   out[b, j] = cb[0, c0, j] + cb[1, c1, j] + ... + cb[M-1, c(M-1), j],
// with c_m = min(codes[b, m], K-1), added one stage at a time from stage
// 0's row.
//
// Replaces the TPU kernel src/repro/kernels/mgqe_decode/mgqe_decode.py::
// rq_decode_stages (Pallas body _staged_kernel), which ran one one-hot
// matmul per stage on the MXU and accumulated the stages in a revisited
// VMEM output block, started from zeros.  Hopper gathers natively, so a
// thread gathers a vector's M codebook entries and sums them in
// registers, writing each output vector once: the (B, M*d) stage rows
// never exist.
//
// Order of the adds: the sum starts from stage 0's entry (not from +0.0,
// which would turn a -0.0 row into +0.0) and adds stages 1..M-1 in turn
// with __fadd_rn, so no add is contracted into an FMA.  With bfloat16
// codebooks each add is rounded to bfloat16, as PyTorch's bfloat16 add
// rounds.  That is the plain version's chain (ref.py, and the JAX
// reference's), so the two are bit-identical on both routes.
//
// Bound: bytes.  The call must read B*M code bytes (1 or 4 each) and the
// M*K*d codebooks once, and write B*d output elements (deepfm's
// serve_bulk: 10.5 of 11.8 MB); the B*(M-1)*d adds are a small fraction
// of the card's rate.  An output row is G = d / V vectors of V elements
// (the widest V that divides d, at most 16 bytes).  Two routes, chosen by
// mgqe_decode.py::rq_plan:
//
//   * smem (codebooks of at most kSmemTableMax bytes: deepfm's 51,200 B
//     in float32): the per-warp chunks of decode_chunks.cuh, a chunk's
//     input its 32 rows of M codes.  Lane r of a warp decodes row r of
//     each chunk: it clamps the row's M codes into codebook offsets and
//     sums each of the row's G vectors over the stages (unrolled for
//     M = 4 and 5, else kAhead stages' loads in flight at a time).
//     The route serves bulk decodes; an engine flush (a few thousand
//     rows) is below rq_plan's threshold and takes the l2 route.
//   * l2 (larger codebooks, such as the JAX bench's 256 KB at d = 64, and
//     any block that is not a whole number of warps): a thread per
//     (row, vector) slot over the whole output, consecutive threads on
//     consecutive slots, the codebooks read through the read-only cache
//     (__ldg); V also suits the codebooks' and the output's alignment
//     there (at most 4 elements).
//
// rq_plan takes the smem route from 65,536 rows: staging the codebooks
// costs a block about as long as the l2 route takes for a whole engine
// flush of a few thousand rows.
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md §6): at
// deepfm's serve_bulk (B = 262,144, M = 5, K = 256, d = 10) the smem
// route takes about 0.0110 ms in float32 (the l2 route about 0.0139) and
// 0.0078 ms in bfloat16, against a byte bound of 0.0035 and 0.0020; an
// engine flush (3,456 rows, the l2 route) about 0.0029 ms.  What holds
// the smem route back, from variants with one part removed at a time
// (float32): most of all the bank conflicts of the random 8-byte
// codebook reads (25 a row), then the staging and the stores.
//
// Codes are read at their stored width and widened and clamped to
// [0, K) in registers; a ragged B needs no padding.

#include <cstdint>

#include <cuda_bf16.h>

#include "decode_chunks.cuh"

namespace {

using chunks::align16;
using chunks::aligned16;
using chunks::kSmemTableMax;

constexpr int kMaxThreads = chunks::kMaxThreads;
// Stages whose loads a thread issues before it adds any of them.
constexpr int kAhead = 8;
// The smem route's sum is unrolled over exactly M stages for the M of
// the repo's configurations: EmbeddingConfig's default num_levels (4)
// and deepfm's rq fields (num_subspaces, 5; models/recsys/fields.py).
// Any other M walks its stages kAhead at a time, re-reading the codes
// for each vector: slower on the card at M = 5, in bfloat16 most.
constexpr int kRouteSmem = 0;
constexpr int kRouteL2 = 1;

// Element arithmetic by storage type: float32 as uint32_t bits, bfloat16
// as uint16_t bits.  The running sum is a float holding a value of the
// element type exactly, so the final store loses nothing.
template <typename Elem>
struct Num;

template <>
struct Num<uint32_t> {
  __device__ static float load(uint32_t x) { return __uint_as_float(x); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static uint32_t store(float a) { return __float_as_uint(a); }
};

template <>
struct Num<uint16_t> {
  __device__ static float load(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  __device__ static float add(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
  }
  __device__ static uint16_t store(float a) {
    return static_cast<uint16_t>(__float_as_uint(a) >> 16);  // exact
  }
};

template <typename Code>
__device__ __forceinline__ long long clamp_code(Code raw, int K) {
  long long c = static_cast<long long>(raw);        // widen in registers
  return c < 0 ? 0 : (c >= K ? K - 1 : c);
}

// V consecutive elements of one row, loaded and stored as one vector.
template <typename Elem, int V>
struct alignas(sizeof(Elem) * V) Vec {
  Elem e[V];
};

// A smem-route block's dynamic shared memory: the codebooks, then per
// warp two chunks of codes and one of output rows.
size_t smem_bytes(int M, int K, int d, int code_bytes, int elem_bytes,
                  int warps) {
  return align16(static_cast<size_t>(M) * K * d * elem_bytes)
         + static_cast<size_t>(warps)
               * chunks::warp_bytes(static_cast<size_t>(M) * code_bytes,
                                    static_cast<size_t>(d) * elem_bytes);
}

// One output vector of the smem route: vector v (of G a row) summed over
// the stages from the row's codebook offsets `at` (in vectors), stage 0's
// entry first, then one rounded add a stage.  kM stages, unrolled.
template <typename Elem, int V, int kM>
__device__ __forceinline__ Vec<Elem, V> sum_stages(
    const Vec<Elem, V>* table, const int (&at)[kM], int v) {
  Vec<Elem, V> x[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) x[m] = table[at[m] + v];
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = Num<Elem>::load(x[0].e[e]);
#pragma unroll
  for (int m = 1; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e)
      acc[e] = Num<Elem>::add(acc[e], Num<Elem>::load(x[m].e[e]));
  Vec<Elem, V> sum;
#pragma unroll
  for (int e = 0; e < V; ++e) sum.e[e] = Num<Elem>::store(acc[e]);
  return sum;
}

// smem route.  Code: uint8_t or int32_t.  Elem: uint32_t (float32) or
// uint16_t (bfloat16).  V: elements a vector (d % V == 0).  kM: the
// stages M where the sum is unrolled over them (4 or 5), with the row's
// codebook offsets held in registers, else 0 (M stages walked kAhead at
// a time).  Lane r of a warp decodes row r of each chunk: it
// reads the row's M codes from the staged chunk, clamps them, and sums
// each of the row's G vectors over the stages into the output chunk.
template <typename Code, typename Elem, int V, int kM>
__global__ void __launch_bounds__(kMaxThreads)
    smem_rq_kernel(const Code* __restrict__ codes,
                   const unsigned char* __restrict__ cbs,
                   unsigned char* __restrict__ out, long long B, int M,
                   int K, int d, bool codes_aligned, bool cbs_aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = d / V;
  const size_t table_bytes = static_cast<size_t>(M) * K * d * sizeof(Elem);
  const auto* table = reinterpret_cast<const Vec<Elem, V>*>(smem);
  const int lane = threadIdx.x & 31;
  chunks::walk(
      reinterpret_cast<const unsigned char*>(codes), M * sizeof(Code),
      codes_aligned, out, d * sizeof(Elem), B, smem + align16(table_bytes),
      [&] {
        chunks::copy_in(smem, cbs, table_bytes, cbs_aligned, threadIdx.x,
                        blockDim.x);
      },
      [&](const unsigned char* in, int n, unsigned char* obuf) {
        if (lane >= n) return;
        const Code* c = reinterpret_cast<const Code*>(in) + lane * M;
        auto* o = reinterpret_cast<Vec<Elem, V>*>(obuf) + lane * G;
        if constexpr (kM > 0) {
          int at[kM];                 // the row's codebook rows, in vectors
#pragma unroll
          for (int m = 0; m < kM; ++m)
            at[m] = (m * K + static_cast<int>(clamp_code(c[m], K))) * G;
          for (int v = 0; v < G; ++v)
            o[v] = sum_stages<Elem, V, kM>(table, at, v);
        } else {
          for (int v = 0; v < G; ++v) {
            float acc[V];
            for (int m0 = 0; m0 < M; m0 += kAhead) {
              Vec<Elem, V> x[kAhead];
#pragma unroll
              for (int i = 0; i < kAhead; ++i) {
                const int m = m0 + i;
                if (m < M)
                  x[i] = table[(m * K + static_cast<int>(clamp_code(c[m], K)))
                                   * G + v];
              }
#pragma unroll
              for (int i = 0; i < kAhead; ++i) {
                if (m0 + i < M) {
#pragma unroll
                  for (int e = 0; e < V; ++e) {
                    const float y = Num<Elem>::load(x[i].e[e]);
                    acc[e] = m0 + i == 0 ? y : Num<Elem>::add(acc[e], y);
                  }
                }
              }
            }
            Vec<Elem, V> sum;
#pragma unroll
            for (int e = 0; e < V; ++e) sum.e[e] = Num<Elem>::store(acc[e]);
            o[v] = sum;
          }
        }
      });
}

// l2 route.  Index: unsigned for up to 2^32 slots (a 32-bit division per
// slot, where a 64-bit one costs several times the instructions), else
// long long.  Slot j is out[j / G, (j % G) * V ...].
template <typename Code, typename Elem, typename Index, int V>
__global__ void l2_rq_kernel(const Code* __restrict__ codes,
                             const Vec<Elem, V>* __restrict__ cbs,
                             Vec<Elem, V>* __restrict__ out, Index n_slots,
                             int M, int K, int G) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index j = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n_slots; j += stride) {
    const Index r = j / static_cast<Index>(G);
    const Code* cr = codes + static_cast<long long>(r) * M;
    const Vec<Elem, V>* col = cbs + (j - r * G);  // this slot's columns
    float acc[V];
    for (int m0 = 0; m0 < M; m0 += kAhead) {
      Vec<Elem, V> v[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int m = m0 + i;
        if (m < M) {
          const long long k = static_cast<long long>(m) * K
                              + clamp_code(__ldg(cr + m), K);
          v[i] = col[k * G];
        }
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int m = m0 + i;
        if (m < M) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = Num<Elem>::load(v[i].e[e]);
            // stage 0's entry first, then one rounded add per stage
            acc[e] = m == 0 ? x : Num<Elem>::add(acc[e], x);
          }
        }
      }
    }
    Vec<Elem, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.e[e] = Num<Elem>::store(acc[e]);
    out[j] = o;
  }
}

template <typename Code, typename Elem, int V, int kM>
int smem_go(const void* codes, const void* cbs, void* out, long long B,
            int M, int K, int d, int grid, int threads, size_t smem,
            cudaStream_t stream) {
  return chunks::launch_smem(
      smem_rq_kernel<Code, Elem, V, kM>, grid, threads, smem, stream,
      static_cast<const Code*>(codes), static_cast<const unsigned char*>(cbs),
      static_cast<unsigned char*>(out), B, M, K, d, aligned16(codes),
      aligned16(cbs));
}

template <typename Code, typename Elem, int V>
int launch_v(const void* codes, const void* cbs, void* out, long long B,
             int M, int K, int d, int route, int grid, int threads,
             size_t smem, cudaStream_t stream) {
  if (route == kRouteSmem) {
    if (M == 4)
      return smem_go<Code, Elem, V, 4>(codes, cbs, out, B, M, K, d, grid,
                                       threads, smem, stream);
    if (M == 5)
      return smem_go<Code, Elem, V, 5>(codes, cbs, out, B, M, K, d, grid,
                                       threads, smem, stream);
    return smem_go<Code, Elem, V, 0>(codes, cbs, out, B, M, K, d, grid,
                                     threads, smem, stream);
  }
  const Code* c = static_cast<const Code*>(codes);
  const int G = d / V;
  const long long n_slots = B * G;
  const auto* t = static_cast<const Vec<Elem, V>*>(cbs);
  auto* o = static_cast<Vec<Elem, V>*>(out);
  // the grid-stride step must not wrap the 32-bit index either
  if (n_slots + static_cast<long long>(grid) * threads < (1LL << 32))
    l2_rq_kernel<Code, Elem, unsigned, V><<<grid, threads, 0, stream>>>(
        c, t, o, static_cast<unsigned>(n_slots), M, K, G);
  else
    l2_rq_kernel<Code, Elem, long long, V><<<grid, threads, 0, stream>>>(
        c, t, o, n_slots, M, K, G);
  return repro_last_error();
}

template <typename Code, typename Elem>
int launch(const void* codes, const void* cbs, void* out, long long B,
           int M, int K, int d, int route, int vec, int grid, int threads,
           size_t smem, cudaStream_t st) {
  if (vec == 1)
    return launch_v<Code, Elem, 1>(codes, cbs, out, B, M, K, d, route, grid,
                                   threads, smem, st);
  if (vec == 2)
    return launch_v<Code, Elem, 2>(codes, cbs, out, B, M, K, d, route, grid,
                                   threads, smem, st);
  if (vec == 4)
    return launch_v<Code, Elem, 4>(codes, cbs, out, B, M, K, d, route, grid,
                                   threads, smem, st);
  if constexpr (sizeof(Elem) == 2)
    return launch_v<Code, Elem, 8>(codes, cbs, out, B, M, K, d, route, grid,
                                   threads, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A plan the kernels cannot run (mgqe_decode.py::rq_plan must agree): a
// vector that does not divide d or is wider than 16 bytes; the smem route
// past its codebook limit, with blocks that are not whole warps or shared
// memory other than it needs; the l2 route with vectors wider than 4
// elements or than the codebooks' or the output's alignment, or shared
// memory.
bool bad_plan(const void* cbs, const void* out, long long B, int M, int K,
              int d, int code_bytes, int elem_bytes, int route, int vec,
              int grid, int threads, long long smem) {
  if (B <= 0 || M <= 0 || K <= 0 || d <= 0 || grid <= 0 || threads <= 0
      || threads > kMaxThreads || (vec != 1 && vec != 2 && vec != 4 && vec != 8)
      || d % vec != 0 || vec * elem_bytes > 16)
    return true;
  if (route == kRouteSmem)
    return static_cast<size_t>(M) * K * d * elem_bytes > kSmemTableMax
           || chunks::bad_walk(grid, threads, smem,
                               smem_bytes(M, K, d, code_bytes, elem_bytes,
                                          threads / 32));
  if (route == kRouteL2) {
    const uintptr_t bytes = static_cast<uintptr_t>(vec) * elem_bytes;
    return vec > 4 || smem != 0
           || reinterpret_cast<uintptr_t>(cbs) % bytes != 0
           || reinterpret_cast<uintptr_t>(out) % bytes != 0;
  }
  return true;
}

}  // namespace

// codes: (B, M) contiguous, code_bytes 1 (uint8) or 4 (int32);
// cbs: (M, K, d) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// out: (B, d) contiguous and 16-byte aligned, same element type as cbs.
// The plan (mgqe_decode.py::rq_plan): route 0 (smem) or 1 (l2), `vec`
// elements a vector, `grid` blocks of `threads`, `smem` bytes of dynamic
// shared memory.  Returns a cudaError_t (0 on success).
extern "C" int rq_decode_stages_launch(const void* codes, int code_bytes,
                                       const void* cbs, int elem_bytes,
                                       void* out, long long B, int M, int K,
                                       int d, int route, int vec, int grid,
                                       int threads, long long smem,
                                       void* stream) {
  if ((code_bytes != 1 && code_bytes != 4)
      || (elem_bytes != 2 && elem_bytes != 4) || !aligned16(out)
      || bad_plan(cbs, out, B, M, K, d, code_bytes, elem_bytes, route, vec,
                  grid, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (code_bytes == 1 && elem_bytes == 4)
    return launch<uint8_t, uint32_t>(codes, cbs, out, B, M, K, d, route, vec,
                                     grid, threads, sm, st);
  if (code_bytes == 1)
    return launch<uint8_t, uint16_t>(codes, cbs, out, B, M, K, d, route, vec,
                                     grid, threads, sm, st);
  if (elem_bytes == 4)
    return launch<int32_t, uint32_t>(codes, cbs, out, B, M, K, d, route, vec,
                                     grid, threads, sm, st);
  return launch<int32_t, uint16_t>(codes, cbs, out, B, M, K, d, route, vec,
                                   grid, threads, sm, st);
}
