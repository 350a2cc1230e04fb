// MGQE/DPQ serving decode on Hopper: codes (B, D) + centroids (D, K, S)
// -> rows (B, D*S), out[b, d*S + s] = centroids[d, min(codes[b, d], K-1), s].
//
// Replaces the TPU kernel src/repro/kernels/mgqe_decode/mgqe_decode.py::
// mgqe_decode (Pallas body _decode_kernel), which built a one-hot
// (block, D, K) tensor and ran the gather as a matmul on the MXU because
// the TPU's vector unit gathers poorly.  Hopper gathers natively, so this
// is a real gather and a pure copy: the result is bit-identical to the
// plain PyTorch version for every element type.
//
// Bound: bytes.  The call must read B*D code bytes (1 or 4 each) and the
// D*K*S centroid table once, and write B*D*S output elements; it does no
// arithmetic.  The output is nearly all of it (deepfm's serve_bulk: 10.5
// of 11.8 MB; gemma3-4b's prefill: 84 MB from a 2.6 MB table), so the
// design keeps enough bytes in flight to cover HBM latency and writes in
// 16-byte vectors.  A (row, subspace) slot is S elements, `slot` bytes.
// Two routes, chosen by mgqe_decode.py::decode_plan:
//
//   * smem (a table of at most kSmemTableMax bytes and slots of at most
//     kSmemSlotMax bytes: deepfm's 10 KB table, 8-byte slots).  A block
//     stages the table with 16-byte cp.async loads, together with each
//     warp's first chunk of codes, and meets once.  From there each warp
//     runs on its own over chunks of kChunk = 32 rows: the next chunk's
//     codes come in by cp.async while a lane gathers its row's D slots
//     (no division by a runtime D) from the staged table into the warp's
//     output chunk in shared memory, in the widest vector the slot size
//     allows; the warp then writes the chunk, 32*D*slot contiguous bytes
//     (16-byte aligned at every chunk), in 16-byte vectors.  No block
//     barrier after the first, so a warp's stores start as soon as its
//     own rows are gathered.
//   * l2 (larger tables or slots: the LM token table, 2.6 MB, 1,280-byte
//     slots).  A group of `group` lanes (a power of two <= 32, about one
//     lane a 16-byte vector of a slot) copies one slot from the table
//     through L2, up to four vectors a lane in flight, so a warp's loads
//     and stores are contiguous 512-byte runs.
//
// Codes >= K are clamped to K-1 (and negative int32 codes to 0), the
// reference's mode="clip" gather: under mgqe private_k, rows of other
// tiers carry codes past this tier's K.  Every vector copy moves bits
// only, so one kernel serves float32 and bfloat16 exactly.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kChunk = 32;            // rows a warp gathers at a time
constexpr size_t kSmemTableMax = 96 * 1024;
constexpr int kSmemSlotMax = 64;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kRouteSmem = 0;
constexpr int kRouteL2 = 1;

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// A smem-route block's dynamic shared memory: the table and, per warp,
// two chunks of codes and one of output.
size_t smem_bytes(int D, int K, int slot, int code_bytes, int warps) {
  return align16(static_cast<size_t>(D) * K * slot)
         + static_cast<size_t>(warps)
               * (2 * align16(static_cast<size_t>(kChunk) * D * code_bytes)
                  + static_cast<size_t>(kChunk) * D * slot);
}

template <typename Code>
__device__ __forceinline__ int clamp_code(Code raw, int K) {
  int c = static_cast<int>(raw);
  c = c < 0 ? 0 : c;
  return c < K ? c : K - 1;
}

// `bytes` bytes global -> shared by `n` threads (`i` the caller's
// index among them): 16-byte cp.async loads when the source is 16-byte
// aligned (the caller commits), else byte copies.
__device__ __forceinline__ void copy_in(unsigned char* dst,
                                        const unsigned char* src,
                                        size_t bytes, bool aligned, int i,
                                        int n) {
  if (aligned) {
    for (size_t j = i; j * 16 < bytes; j += n) {
      const size_t left = bytes - 16 * j;
      cp_async16(dst + 16 * j, src + 16 * j,
                 static_cast<int>(left < 16 ? left : 16));
    }
  } else {
    for (size_t j = i; j < bytes; j += n) dst[j] = src[j];
  }
}

// smem route.  Warp w of the grid takes chunks w, w + (warps in the
// grid), ... of kChunk rows.  Vec: the widest of uint4/uint2/uint32/
// uint16 that divides `slot`.
template <typename Code, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    smem_decode_kernel(const Code* __restrict__ codes,
                       const unsigned char* __restrict__ cent,
                       unsigned char* __restrict__ out, long long B, int D,
                       int K, int slot, bool codes_aligned,
                       bool cent_aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t table_bytes = static_cast<size_t>(D) * K * slot;
  const size_t code_chunk =
      align16(static_cast<size_t>(kChunk) * D * sizeof(Code));
  const size_t row_bytes = static_cast<size_t>(D) * slot;
  const size_t out_chunk = kChunk * row_bytes;
  const unsigned char* table = smem;
  unsigned char* wsm =
      smem + align16(table_bytes)
      + static_cast<size_t>(warp) * (2 * code_chunk + out_chunk);
  unsigned char* cbuf[2] = {wsm, wsm + code_chunk};
  unsigned char* obuf = wsm + 2 * code_chunk;
  const long long chunks = (B + kChunk - 1) / kChunk;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const int vecs = slot / static_cast<int>(sizeof(Vec));

  auto load_codes = [&](long long chunk, int buf) {
    const long long r0 = chunk * kChunk;
    const long long n = B - r0 < kChunk ? B - r0 : kChunk;
    copy_in(cbuf[buf], reinterpret_cast<const unsigned char*>(codes + r0 * D),
            static_cast<size_t>(n) * D * sizeof(Code), codes_aligned, lane,
            32);
  };

  long long chunk =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  copy_in(smem, cent, table_bytes, cent_aligned, threadIdx.x, blockDim.x);
  if (chunk < chunks) load_codes(chunk, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();     // the table is in (and each warp's first chunk)
  for (int it = 0; chunk < chunks; ++it, chunk += step) {
    if (chunk + step < chunks) {
      load_codes(chunk + step, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const long long r0 = chunk * kChunk;
    const int n = static_cast<int>(B - r0 < kChunk ? B - r0 : kChunk);
    if (lane < n) {
      const Code* c = reinterpret_cast<const Code*>(cbuf[it & 1]) + lane * D;
      unsigned char* o = obuf + lane * row_bytes;
      for (int d = 0; d < D; ++d) {
        const int code = clamp_code(c[d], K);
        const Vec* src = reinterpret_cast<const Vec*>(
            table + (static_cast<size_t>(d) * K + code) * slot);
        Vec* dst = reinterpret_cast<Vec*>(o + static_cast<size_t>(d) * slot);
        if (vecs == 1) {
          dst[0] = src[0];
        } else {
          for (int v = 0; v < vecs; ++v) dst[v] = src[v];
        }
      }
    }
    __syncwarp();      // the chunk is complete
    // n * row_bytes is a multiple of 16 for every chunk but the last
    const size_t bytes = static_cast<size_t>(n) * row_bytes;
    unsigned char* g = out + static_cast<size_t>(r0) * row_bytes;
    for (size_t i = lane; 16 * i + 16 <= bytes; i += 32)
      reinterpret_cast<uint4*>(g)[i] = reinterpret_cast<const uint4*>(obuf)[i];
    for (size_t i = bytes / 16 * 8 + lane; 2 * i < bytes; i += 32)
      reinterpret_cast<uint16_t*>(g)[i] =
          reinterpret_cast<const uint16_t*>(obuf)[i];
    __syncwarp();      // read out before the next chunk overwrites it
  }
}

// l2 route.  A group of `group` lanes copies slot (b, d) = divmod(j, D)
// of every j = its group index + a multiple of the groups in the grid.
template <typename Code, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    l2_decode_kernel(const Code* __restrict__ codes,
                     const unsigned char* __restrict__ cent,
                     unsigned char* __restrict__ out, long long B, int D,
                     int K, int slot, int group) {
  constexpr int kAhead = 4;           // vectors a lane has in flight
  const long long slots = B * D;
  const long long gid =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / group;
  const long long groups =
      static_cast<long long>(gridDim.x) * blockDim.x / group;
  const int lane = threadIdx.x & (group - 1);
  const int vecs = slot / static_cast<int>(sizeof(Vec));
  for (long long j = gid; j < slots; j += groups) {
    const long long b = j / D;
    const int d = static_cast<int>(j - b * D);
    const int code = clamp_code(__ldg(codes + j), K);
    const Vec* src = reinterpret_cast<const Vec*>(
        cent + (static_cast<size_t>(d) * K + code) * slot);
    Vec* dst = reinterpret_cast<Vec*>(out + static_cast<size_t>(j) * slot);
    for (int v0 = lane; v0 < vecs; v0 += kAhead * group) {
      Vec x[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        if (v0 + a * group < vecs) x[a] = __ldg(src + v0 + a * group);
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        if (v0 + a * group < vecs) dst[v0 + a * group] = x[a];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The widest vector (bytes) that divides `slot` and the table's address.
int vec_bytes(int slot, const void* cent) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(cent);
  for (int v = 16; v > 2; v /= 2)
    if (slot % v == 0 && a % v == 0) return v;
  return 2;
}

template <typename Code>
int launch(const void* codes, const void* cent, void* out, long long B,
           int D, int K, int slot, int route, int group, int grid,
           int threads, size_t smem, cudaStream_t stream) {
  const Code* c = static_cast<const Code*>(codes);
  const unsigned char* t = static_cast<const unsigned char*>(cent);
  unsigned char* o = static_cast<unsigned char*>(out);
  const bool ca = aligned16(codes);
  const bool ta = aligned16(cent);
  auto smem_go = [&](auto kern) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, threads, smem, stream>>>(c, t, o, B, D, K, slot, ca, ta);
    return repro_last_error();
  };
  auto l2_go = [&](auto kern) {
    kern<<<grid, threads, 0, stream>>>(c, t, o, B, D, K, slot, group);
    return repro_last_error();
  };
  const int v = vec_bytes(slot, cent);
  if (route == kRouteSmem) {
    // the staged table is 16-byte aligned: the slot alone sets the vector
    if (slot % 16 == 0) return smem_go(smem_decode_kernel<Code, uint4>);
    if (slot % 8 == 0) return smem_go(smem_decode_kernel<Code, uint2>);
    if (slot % 4 == 0) return smem_go(smem_decode_kernel<Code, uint32_t>);
    return smem_go(smem_decode_kernel<Code, uint16_t>);
  }
  if (v == 16) return l2_go(l2_decode_kernel<Code, uint4>);
  if (v == 8) return l2_go(l2_decode_kernel<Code, uint2>);
  if (v == 4) return l2_go(l2_decode_kernel<Code, uint32_t>);
  return l2_go(l2_decode_kernel<Code, uint16_t>);
}

// A plan the kernels cannot run (mgqe_decode.py::decode_plan must agree):
// the smem route past its table or slot limit, or with shared memory
// other than it needs; the l2 route with a group that is not a power of
// two <= 32; no block, or blocks that are not whole warps.
bool bad_plan(long long B, int D, int K, int slot, int code_bytes, int route,
              int group, int grid, int threads, long long smem) {
  if (B <= 0 || D <= 0 || K <= 0 || slot <= 0 || slot % 2 != 0 || grid <= 0
      || threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return true;
  if (route == kRouteSmem)
    return static_cast<size_t>(D) * K * slot > kSmemTableMax
           || slot > kSmemSlotMax
           || static_cast<size_t>(smem)
                  != smem_bytes(D, K, slot, code_bytes, threads / 32)
           || static_cast<size_t>(smem) > kSmemMax;
  if (route == kRouteL2)
    return group <= 0 || group > 32 || (group & (group - 1)) != 0
           || smem != 0;
  return true;
}

}  // namespace

// codes: (B, D) contiguous, code_bytes 1 (uint8) or 4 (int32);
// cent: (D, K, S) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// out: (B, D*S) contiguous and 16-byte aligned, same element type as
// cent.  The plan (mgqe_decode.py::decode_plan): route 0 (smem) or 1
// (l2, `group` lanes a slot), `grid` blocks of `threads`, `smem` bytes
// of dynamic shared memory.  Returns a cudaError_t (0 on success).
extern "C" int mgqe_decode_launch(const void* codes, int code_bytes,
                                  const void* cent, int elem_bytes,
                                  void* out, long long B, int D, int K,
                                  int S, int route, int group, int grid,
                                  int threads, long long smem,
                                  void* stream) {
  if (S <= 0 || (elem_bytes != 2 && elem_bytes != 4)
      || (code_bytes != 1 && code_bytes != 4) || !aligned16(out)
      || bad_plan(B, D, K, S * elem_bytes, code_bytes, route, group, grid,
                  threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slot = S * elem_bytes;
  if (code_bytes == 1)
    return launch<uint8_t>(codes, cent, out, B, D, K, slot, route, group,
                           grid, threads, static_cast<size_t>(smem), st);
  return launch<int32_t>(codes, cent, out, B, D, K, slot, route, group, grid,
                         threads, static_cast<size_t>(smem), st);
}
