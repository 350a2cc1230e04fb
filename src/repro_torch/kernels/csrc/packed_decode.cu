// Fused unpack-and-decode of bit-packed codes on Hopper:
// packed (B, W) uint8 holding P = 8 / bits codes per byte, little-endian
// within the byte, and centroids (D, K, S) -> rows (B, D*S),
//   out[b, d*S + s] = centroids[d, code(b, d), s],
//   code(b, d) = (packed[b, d / P] >> ((d % P) * bits)) & (2^bits - 1).
//
// Replaces the TPU kernel src/repro/kernels/packed_decode/packed_decode.py::
// packed_decode (Pallas body _packed_decode_kernel), which widened a VMEM
// block of packed words, split their byte lanes with shifts and masks and
// fed the codes to a one-hot matmul on the MXU, because the TPU's vector
// unit gathers poorly.  Hopper gathers natively, so after the shift and
// mask this is a real gather and a pure copy: bit-identical to the plain
// PyTorch version (unpack, then gather) for every element type.
//
// Bound: bytes.  The call must read B*W packed bytes and the table once,
// and write B*D*S output elements; the output is nearly all of it (an mpe
// tier at deepfm's serve_bulk: 10.5 of 11.0-11.8 MB).  A (row, subspace)
// slot is S elements, `slot` bytes.  Two routes, chosen by
// packed_decode.py::packed_plan:
//
//   * smem (the 2^bits rows a code can address, D * 2^bits slots, at most
//     kSmemTableMax bytes, and slots of at most kSmemSlotMax bytes: every
//     mpe tier): the per-warp chunks of decode_chunks.cuh.  A block stages
//     only the addressed rows of each subspace (a table with K > 2^bits
//     rows keeps its other rows in memory); a chunk's input is 32*W packed
//     bytes, and lane r unpacks its row's W bytes into D codes in
//     registers (bits a template parameter: no division by a runtime D or
//     P) and gathers its D slots into the warp's output chunk.  The
//     unpacked (B, D) codes never reach memory, which is the point of the
//     packed layout (a bits=2 tier reads 4x fewer code bytes).
//   * l2 (larger tables or slots): a group of `group` lanes copies one
//     slot through L2, its code unpacked from the one byte that holds it
//     (decode_chunks.cuh's copy_slot).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md §6): an
// mpe tier at deepfm's serve_bulk (B = 262,144, D = 5, S = 2, float32)
// takes about 0.0065 ms on the smem route, against a byte bound of
// 0.0033-0.0035 ms, as mgqe_decode does on the same skeleton.
//
// K >= 2^bits is checked here: every code a mask leaves addresses a row.
// Every copy moves bits only, so one kernel serves float32 and bfloat16.

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

// A subspace's staged rows (2^bits slots), padded to 16 bytes.
size_t staged_sub(int bits, int slot) {
  return align16(static_cast<size_t>(slot) << bits);
}

// A smem-route block's dynamic shared memory: the staged rows and, per
// warp, two chunks of packed bytes and one of output.
size_t smem_bytes(int W, int D, int slot, int bits, int warps) {
  return static_cast<size_t>(D) * staged_sub(bits, slot)
         + static_cast<size_t>(warps)
               * chunks::warp_bytes(W, static_cast<size_t>(D) * slot);
}

// smem route.  kBits: 2, 4 or 8.  Vec: the widest of uint4/uint2/uint32/
// uint16 that divides `slot`.  cent_aligned: the table's base is 16-byte
// aligned and so is each subspace (K * slot a multiple of 16).
template <int kBits, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    smem_packed_kernel(const uint8_t* __restrict__ packed,
                       const unsigned char* __restrict__ cent,
                       unsigned char* __restrict__ out, long long B, int W,
                       int D, int K, int slot, bool packed_aligned,
                       bool cent_aligned) {
  constexpr int kPer = 8 / kBits;
  constexpr int kMask = (1 << kBits) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int run = slot << kBits;                  // a subspace's bytes
  const int sub = static_cast<int>(align16(run));  // and its staged stride
  const size_t row_bytes = static_cast<size_t>(D) * slot;
  const int vecs = slot / static_cast<int>(sizeof(Vec));
  chunks::walk(
      packed, W, packed_aligned, out, row_bytes, B,
      smem + static_cast<size_t>(D) * sub,
      [&] {
        if (cent_aligned) {
          const int per = sub / 16;
          for (int j = threadIdx.x; j < D * per; j += blockDim.x) {
            const int d = j / per;
            const int off = 16 * (j - d * per);
            cp_async16(smem + d * sub + off,
                       cent + static_cast<size_t>(d) * K * slot + off,
                       run - off < 16 ? run - off : 16);
          }
        } else {
          for (int j = threadIdx.x; j < D * run; j += blockDim.x) {
            const int d = j / run;
            const int off = j - d * run;
            smem[d * sub + off] = cent[static_cast<size_t>(d) * K * slot + off];
          }
        }
      },
      [&](const unsigned char* in, int n, unsigned char* obuf) {
        const int lane = threadIdx.x & 31;
        if (lane >= n) return;
        const unsigned char* p = in + lane * W;
        unsigned char* o = obuf + lane * row_bytes;
        for (int w = 0; w < W; ++w) {
          const int byte = p[w];
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int d = w * kPer + j;
            if (d < D) {    // the last byte's pad codes are never read
              const int code = (byte >> (j * kBits)) & kMask;
              const Vec* src =
                  reinterpret_cast<const Vec*>(smem + d * sub + code * slot);
              Vec* dst = reinterpret_cast<Vec*>(o + d * slot);
              if (vecs == 1) {
                dst[0] = src[0];
              } else {
                for (int v = 0; v < vecs; ++v) dst[v] = src[v];
              }
            }
          }
        }
      });
}

// l2 route.  A group of `group` lanes copies slot (b, d) = divmod(j, D)
// of every j = its group index + a multiple of the groups in the grid.
template <int kBits, typename Vec>
__global__ void __launch_bounds__(kMaxThreads)
    l2_packed_kernel(const uint8_t* __restrict__ packed,
                     const unsigned char* __restrict__ cent,
                     unsigned char* __restrict__ out, long long B, int W,
                     int D, int K, int slot, int group) {
  constexpr int kPer = 8 / kBits;
  constexpr int kMask = (1 << kBits) - 1;
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
    const int byte = __ldg(packed + b * W + d / kPer);
    const int code = (byte >> ((d % kPer) * kBits)) & kMask;
    chunks::copy_slot(
        reinterpret_cast<const Vec*>(
            cent + (static_cast<size_t>(d) * K + code) * slot),
        reinterpret_cast<Vec*>(out + static_cast<size_t>(j) * slot), vecs,
        lane, group);
  }
}

template <int kBits>
int launch(const void* packed, const void* cent, void* out, long long B,
           int W, int D, int K, int slot, int route, int group, int grid,
           int threads, size_t smem, cudaStream_t stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const unsigned char* t = static_cast<const unsigned char*>(cent);
  unsigned char* o = static_cast<unsigned char*>(out);
  const bool pa = aligned16(packed);
  const bool ta = aligned16(cent) && static_cast<size_t>(K) * slot % 16 == 0;
  auto smem_go = [&](auto kern) {
    return chunks::launch_smem(kern, grid, threads, smem, stream, p, t, o, B,
                               W, D, K, slot, pa, ta);
  };
  auto l2_go = [&](auto kern) {
    kern<<<grid, threads, 0, stream>>>(p, t, o, B, W, D, K, slot, group);
    return repro_last_error();
  };
  if (route == kRouteSmem) {
    // the staged rows are 16-byte aligned: the slot alone sets the vector
    if (slot % 16 == 0) return smem_go(smem_packed_kernel<kBits, uint4>);
    if (slot % 8 == 0) return smem_go(smem_packed_kernel<kBits, uint2>);
    if (slot % 4 == 0) return smem_go(smem_packed_kernel<kBits, uint32_t>);
    return smem_go(smem_packed_kernel<kBits, uint16_t>);
  }
  const int v = chunks::vec_bytes(slot, cent);
  if (v == 16) return l2_go(l2_packed_kernel<kBits, uint4>);
  if (v == 8) return l2_go(l2_packed_kernel<kBits, uint2>);
  if (v == 4) return l2_go(l2_packed_kernel<kBits, uint32_t>);
  return l2_go(l2_packed_kernel<kBits, uint16_t>);
}

// A plan the kernels cannot run (packed_decode.py::packed_plan must
// agree): the smem route past its staged-table or slot limit, or with
// shared memory other than it needs; the l2 route with a group that is
// not a power of two <= 32; no block, or blocks that are not whole warps.
bool bad_plan(long long B, int W, int D, int slot, int bits, int route,
              int group, int grid, int threads, long long smem) {
  if (B <= 0 || D <= 0 || slot <= 0 || slot % 2 != 0 || grid <= 0
      || threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return true;
  if (route == kRouteSmem)
    return static_cast<size_t>(D) * staged_sub(bits, slot) > kSmemTableMax
           || slot > kSmemSlotMax
           || chunks::bad_walk(grid, threads, smem,
                               smem_bytes(W, D, slot, bits, threads / 32));
  if (route == kRouteL2)
    return group <= 0 || group > 32 || (group & (group - 1)) != 0
           || smem != 0;
  return true;
}

}  // namespace

// packed: (B, W) uint8 contiguous, W = ceil(D / (8 / bits));
// cent: (D, K, S) contiguous, elem_bytes 4 (float32) or 2 (bfloat16),
// K >= 2^bits; out: (B, D*S) contiguous and 16-byte aligned, same element
// type as cent.  bits in {2, 4, 8}.  The plan (packed_decode.py::
// packed_plan): route 0 (smem) or 1 (l2, `group` lanes a slot), `grid`
// blocks of `threads`, `smem` bytes of dynamic shared memory.  Returns a
// cudaError_t (0 on success).
extern "C" int packed_decode_launch(const void* packed, const void* cent,
                                    int elem_bytes, void* out, long long B,
                                    int W, int D, int K, int S, int bits,
                                    int route, int group, int grid,
                                    int threads, long long smem,
                                    void* stream) {
  if (bits != 2 && bits != 4 && bits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_byte = 8 / bits;
  const int slot = S * elem_bytes;
  if (S <= 0 || (elem_bytes != 2 && elem_bytes != 4) || K < (1 << bits)
      || W != (D + per_byte - 1) / per_byte || !aligned16(out)
      || bad_plan(B, W, D, slot, bits, route, group, grid, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (bits == 2)
    return launch<2>(packed, cent, out, B, W, D, K, slot, route, group, grid,
                     threads, sm, st);
  if (bits == 4)
    return launch<4>(packed, cent, out, B, W, D, K, slot, route, group, grid,
                     threads, sm, st);
  return launch<8>(packed, cent, out, B, W, D, K, slot, route, group, grid,
                   threads, sm, st);
}
