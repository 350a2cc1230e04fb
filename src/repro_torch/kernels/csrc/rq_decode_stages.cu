// Residual-quantization serving decode on Hopper: codes (B, M) + stacked
// full-width codebooks (M, K, d) -> rows (B, d),
//   out[b, j] = cb[0, c0, j] + cb[1, c1, j] + ... + cb[M-1, c(M-1), j],
// with c_m = min(codes[b, m], K-1), added one stage at a time from stage
// 0's row.
//
// Replaces the TPU kernel src/repro/kernels/mgqe_decode/mgqe_decode.py::
// rq_decode_stages (Pallas body _staged_kernel), which ran one one-hot
// matmul per stage on the MXU and accumulated the stages in a revisited
// VMEM output block, started from zeros.  Hopper gathers natively, so
// each thread gathers its M codebook entries and sums them in a register,
// writing its output element once: the (B, M*d) stage rows never exist.
//
// Order of the adds: the sum starts from stage 0's entry (not from +0.0,
// which would turn a -0.0 row into +0.0) and adds stages 1..M-1 in turn
// with __fadd_rn, so no add is contracted into an FMA.  With bfloat16
// codebooks each add is rounded to bfloat16, as PyTorch's bfloat16 add
// rounds.  That is the plain version's chain (ref.py, and the JAX
// reference's), so the two are bit-identical.
//
// Bound: bytes.  The call must read B*M code bytes (1 or 4 each) and the
// M*K*d codebooks once, and write B*d output elements; the B*(M-1)*d
// adds are a small fraction of the card's rate.  What the design does:
//   * one thread per slot of V consecutive output elements of a row (V =
//     4, 2 or 1, the widest that divides d and suits the alignment: 2 at
//     deepfm's d=10, 4 at d=64), so each stage is one vector load from a
//     codebook row and each slot one vector store; consecutive threads
//     take consecutive slots of the row-major output, so a warp's stores
//     are coalesced and the threads of one row share its code loads
//     (broadcast); the grid covers every slot, so even one engine flush
//     of a few hundred rows spreads over many SMs;
//   * the codebooks are read through the read-only cache (__ldg): deepfm's
//     51 KB stay in L1 and L2 after the first touch, and the bench's
//     256 KB at d=64 in L2.  Staging them in shared memory, as a first
//     version did, cost more than it saved: a block spent ~16 us filling
//     51 KB before its first output (H100 measurement, PERF.md);
//   * the latency of the gathers is hidden by issuing them together: a
//     thread loads up to kChunk stages' codes, then their codebook
//     entries, and only then adds them, in order;
//   * codes are read at their stored width and widened and clamped to
//     [0, K) in registers; a ragged B needs no padding.

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// Stages whose loads a thread issues before it adds any of them.
constexpr int kChunk = 8;
constexpr long long kMaxGrid = 1LL << 20;

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

// Code: uint8_t or int32_t.  Elem: uint32_t (float32) or uint16_t
// (bfloat16).  V: output elements per thread (d % V == 0).  Index:
// unsigned for up to 2^32 slots (a 32-bit division per slot, where a
// 64-bit one costs several times the instructions), else long long.
// Slot j is out[j / G, (j % G) * V ...] with G = d / V vectors per row.
template <typename Code, typename Elem, typename Index, int V>
__global__ void rq_decode_kernel(const Code* __restrict__ codes,
                                 const Vec<Elem, V>* __restrict__ cbs,
                                 Vec<Elem, V>* __restrict__ out,
                                 Index n_slots, int M, int K, int G) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index j = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n_slots; j += stride) {
    const Index r = j / static_cast<Index>(G);
    const Code* cr = codes + static_cast<long long>(r) * M;
    const Vec<Elem, V>* col = cbs + (j - r * G);  // this slot's columns
    float acc[V];
    for (int m0 = 0; m0 < M; m0 += kChunk) {
      Vec<Elem, V> v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int m = m0 + i;
        if (m < M) {
          const long long k = static_cast<long long>(m) * K
                              + clamp_code(__ldg(cr + m), K);
          v[i] = col[k * G];
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
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

template <typename Code, typename Elem, int V>
int launch_v(const void* codes, const void* cbs, void* out, long long B,
             int M, int K, int d, int threads, cudaStream_t stream) {
  const int G = d / V;
  const long long n_slots = B * G;
  const long long blocks = (n_slots + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
  const Code* c = static_cast<const Code*>(codes);
  const auto* t = static_cast<const Vec<Elem, V>*>(cbs);
  auto* o = static_cast<Vec<Elem, V>*>(out);
  // the grid-stride step must not wrap the 32-bit index either
  if (n_slots + static_cast<long long>(grid) * threads < (1LL << 32))
    rq_decode_kernel<Code, Elem, unsigned, V><<<grid, threads, 0, stream>>>(
        c, t, o, static_cast<unsigned>(n_slots), M, K, G);
  else
    rq_decode_kernel<Code, Elem, long long, V><<<grid, threads, 0, stream>>>(
        c, t, o, n_slots, M, K, G);
  return repro_last_error();
}

// The widest vector of 4, 2 or 1 elements that divides d and to which
// both the codebooks and the output are aligned.
template <typename Code, typename Elem>
int launch(const void* codes, const void* cbs, void* out, long long B,
           int M, int K, int d, int threads, cudaStream_t stream) {
  const auto aligned = [&](int v) {
    const uintptr_t bytes = sizeof(Elem) * v;
    return d % v == 0 && reinterpret_cast<uintptr_t>(cbs) % bytes == 0
           && reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  if (aligned(4))
    return launch_v<Code, Elem, 4>(codes, cbs, out, B, M, K, d, threads,
                                   stream);
  if (aligned(2))
    return launch_v<Code, Elem, 2>(codes, cbs, out, B, M, K, d, threads,
                                   stream);
  return launch_v<Code, Elem, 1>(codes, cbs, out, B, M, K, d, threads,
                                 stream);
}

}  // namespace

// codes: (B, M) contiguous, code_bytes 1 (uint8) or 4 (int32);
// cbs: (M, K, d) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// out: (B, d) contiguous, same element type as cbs.  B > 0; threads per
// block in [1, 1024].  Returns a cudaError_t (0 on success).
extern "C" int rq_decode_stages_launch(const void* codes, int code_bytes,
                                       const void* cbs, int elem_bytes,
                                       void* out, long long B, int M, int K,
                                       int d, int threads, void* stream) {
  if (B <= 0 || M <= 0 || K <= 0 || d <= 0 || threads < 1 ||
      threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1 && elem_bytes == 4)
    return launch<uint8_t, uint32_t>(codes, cbs, out, B, M, K, d, threads,
                                     st);
  if (code_bytes == 1 && elem_bytes == 2)
    return launch<uint8_t, uint16_t>(codes, cbs, out, B, M, K, d, threads,
                                     st);
  if (code_bytes == 4 && elem_bytes == 4)
    return launch<int32_t, uint32_t>(codes, cbs, out, B, M, K, d, threads,
                                     st);
  if (code_bytes == 4 && elem_bytes == 2)
    return launch<int32_t, uint16_t>(codes, cbs, out, B, M, K, d, threads,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
