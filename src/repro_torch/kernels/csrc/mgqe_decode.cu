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
//     kSmemSlotMax bytes: deepfm's 10 KB table, 8-byte slots): the
//     per-warp chunks of decode_chunks.cuh.  A lane gathers its row's D
//     slots (no division by a runtime D) from the staged table into the
//     warp's output chunk, in the widest vector the slot size allows.
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

#include "decode_chunks.cuh"

namespace {

using chunks::align16;
using chunks::aligned16;

using chunks::kSmemSlotMax;
using chunks::kSmemTableMax;

constexpr int kMaxThreads = chunks::kMaxThreads;
constexpr int kRouteSmem = 0;
constexpr int kRouteL2 = 1;

// A smem-route block's dynamic shared memory: the table and, per warp,
// two chunks of codes and one of output.
size_t smem_bytes(int D, int K, int slot, int code_bytes, int warps) {
  return align16(static_cast<size_t>(D) * K * slot)
         + static_cast<size_t>(warps)
               * chunks::warp_bytes(static_cast<size_t>(D) * code_bytes,
                                    static_cast<size_t>(D) * slot);
}

template <typename Code>
__device__ __forceinline__ int clamp_code(Code raw, int K) {
  int c = static_cast<int>(raw);
  c = c < 0 ? 0 : c;
  return c < K ? c : K - 1;
}

// smem route (decode_chunks.cuh): lane r of a chunk gathers its row's D
// slots.  Vec: the widest of uint4/uint2/uint32/uint16 that divides
// `slot`.
template <typename Code, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    smem_decode_kernel(const Code* __restrict__ codes,
                       const unsigned char* __restrict__ cent,
                       unsigned char* __restrict__ out, long long B, int D,
                       int K, int slot, bool codes_aligned,
                       bool cent_aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t table_bytes = static_cast<size_t>(D) * K * slot;
  const size_t row_bytes = static_cast<size_t>(D) * slot;
  const int vecs = slot / static_cast<int>(sizeof(Vec));
  const unsigned char* table = smem;
  chunks::walk(
      reinterpret_cast<const unsigned char*>(codes), D * sizeof(Code),
      codes_aligned, out, row_bytes, B, smem + align16(table_bytes),
      [&] {
        chunks::copy_in(smem, cent, table_bytes, cent_aligned, threadIdx.x,
                        blockDim.x);
      },
      [&](const unsigned char* in, int n, unsigned char* obuf) {
        const int lane = threadIdx.x & 31;
        if (lane >= n) return;
        const Code* c = reinterpret_cast<const Code*>(in) + lane * D;
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
      });
}

// l2 route.  A group of `group` lanes copies slot (b, d) = divmod(j, D)
// of every j = its group index + a multiple of the groups in the grid.
template <typename Code, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    l2_decode_kernel(const Code* __restrict__ codes,
                     const unsigned char* __restrict__ cent,
                     unsigned char* __restrict__ out, long long B, int D,
                     int K, int slot, int group) {
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
    chunks::copy_slot(
        reinterpret_cast<const Vec*>(
            cent + (static_cast<size_t>(d) * K + code) * slot),
        reinterpret_cast<Vec*>(out + static_cast<size_t>(j) * slot), vecs,
        lane, group);
  }
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
    return chunks::launch_smem(kern, grid, threads, smem, stream, c, t, o, B,
                               D, K, slot, ca, ta);
  };
  auto l2_go = [&](auto kern) {
    kern<<<grid, threads, 0, stream>>>(c, t, o, B, D, K, slot, group);
    return repro_last_error();
  };
  const int v = chunks::vec_bytes(slot, cent);
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
           || chunks::bad_walk(grid, threads, smem,
                               smem_bytes(D, K, slot, code_bytes,
                                          threads / 32));
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
