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
// Bound: bytes.  The call must read B*W packed bytes and the D*K*S table
// once, and write B*D*S output elements; it does no arithmetic beyond the
// shift and mask.  What the design does about it:
//   * one thread per (row, subspace) slot; consecutive threads take
//     consecutive slots, so the packed bytes they read and the rows they
//     write are contiguous, and a warp's stores are coalesced;
//   * each thread unpacks its own code in registers from the one byte that
//     holds it: the unpacked (B, D) codes never reach memory, which is the
//     point of the packed layout (a bits=2 tier reads 4x fewer code bytes);
//   * the centroid table (10 KB at deepfm, 64 KB at D=8, K=256, S=8) is
//     staged in shared memory once per block when it fits, and read
//     through L2 otherwise; blocks stride over row tiles, a few per SM;
//   * a ragged B needs no padding: the last tile is simply shorter, and the
//     pad codes in a row's last byte are never read.
// K >= 2^bits is checked here: every code a mask leaves addresses a row.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Tables up to this size are staged in shared memory; above 48 KB that
// takes the dynamic-shared-memory attribute.
constexpr size_t kMaxSmemTable = 160 * 1024;
// Blocks per SM for the shared-memory path (each stages the table once).
constexpr int kBlocksPerSm = 4;

// kBits: 2, 4 or 8.  Elem: the centroid element's storage type (uint32_t
// for float32, uint16_t for bfloat16); a copy needs only the bits.
template <int kBits, typename Elem, bool kSmem>
__global__ void __launch_bounds__(kThreads)
packed_decode_kernel(const uint8_t* __restrict__ packed,
                     const Elem* __restrict__ cent, Elem* __restrict__ out,
                     long long B, int W, int D, int K, int S, int block_b) {
  constexpr int kPerByte = 8 / kBits;
  constexpr int kMask = (1 << kBits) - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Elem* table = cent;
  if constexpr (kSmem) {
    Elem* staged = reinterpret_cast<Elem*>(smem_raw);
    const int n = D * K * S;
    for (int i = threadIdx.x; i < n; i += blockDim.x) staged[i] = cent[i];
    __syncthreads();
    table = staged;
  }
  const long long stride = static_cast<long long>(gridDim.x) * block_b;
  for (long long row0 = static_cast<long long>(blockIdx.x) * block_b;
       row0 < B; row0 += stride) {
    const int rows = static_cast<int>(
        B - row0 < block_b ? B - row0 : block_b);
    const int n_slots = rows * D;
    const uint8_t* p = packed + row0 * W;
    Elem* o = out + row0 * D * S;
    for (int j = threadIdx.x; j < n_slots; j += blockDim.x) {
      const int r = j / D;
      const int d = j - r * D;
      const int byte = p[static_cast<long long>(r) * W + d / kPerByte];
      const int code = (byte >> ((d % kPerByte) * kBits)) & kMask;
      const Elem* src = table + (static_cast<long long>(d) * K + code) * S;
      Elem* dst = o + static_cast<long long>(j) * S;
      for (int s = 0; s < S; ++s) dst[s] = src[s];
    }
  }
}

template <int kBits, typename Elem>
int launch(const void* packed, const void* cent, void* out, long long B,
           int W, int D, int K, int S, int block_b, cudaStream_t stream) {
  const size_t table = static_cast<size_t>(D) * K * S * sizeof(Elem);
  const long long tiles = (B + block_b - 1) / block_b;
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const Elem* t = static_cast<const Elem*>(cent);
  Elem* o = static_cast<Elem*>(out);
  if (table <= kMaxSmemTable) {
    int sms = 0;
    cudaError_t err = repro_sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
    const int grid = static_cast<int>(tiles < cap ? tiles : cap);
    auto kern = packed_decode_kernel<kBits, Elem, true>;
    if (table > 48 * 1024) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(table));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, kThreads, table, stream>>>(p, t, o, B, W, D, K, S, block_b);
  } else {
    const long long cap = 1LL << 20;
    const int grid = static_cast<int>(tiles < cap ? tiles : cap);
    packed_decode_kernel<kBits, Elem, false><<<grid, kThreads, 0, stream>>>(
        p, t, o, B, W, D, K, S, block_b);
  }
  return repro_last_error();
}

template <typename Elem>
int launch_bits(int bits, const void* packed, const void* cent, void* out,
                long long B, int W, int D, int K, int S, int block_b,
                cudaStream_t st) {
  if (bits == 2)
    return launch<2, Elem>(packed, cent, out, B, W, D, K, S, block_b, st);
  if (bits == 4)
    return launch<4, Elem>(packed, cent, out, B, W, D, K, S, block_b, st);
  return launch<8, Elem>(packed, cent, out, B, W, D, K, S, block_b, st);
}

}  // namespace

// packed: (B, W) uint8 contiguous, W = ceil(D / (8 / bits));
// cent: (D, K, S) contiguous, elem_bytes 4 (float32) or 2 (bfloat16),
// K >= 2^bits; out: (B, D*S) contiguous, same element type as cent.
// bits in {2, 4, 8}, B > 0.  Returns a cudaError_t (0 on success).
extern "C" int packed_decode_launch(const void* packed, const void* cent,
                                    int elem_bytes, void* out, long long B,
                                    int W, int D, int K, int S, int bits,
                                    int block_b, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_byte = 8 / bits;
  if (B <= 0 || D <= 0 || S <= 0 || block_b <= 0 || K < (1 << bits) ||
      W != (D + per_byte - 1) / per_byte)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_bits<uint32_t>(bits, packed, cent, out, B, W, D, K, S,
                                 block_b, st);
  if (elem_bytes == 2)
    return launch_bits<uint16_t>(bits, packed, cent, out, B, W, D, K, S,
                                 block_b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
