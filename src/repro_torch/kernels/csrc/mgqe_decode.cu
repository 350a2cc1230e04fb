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
// arithmetic.  What the design does about it:
//   * the whole centroid table (10 KB at deepfm, 64 KB at d=64, K=256)
//     is staged in shared memory once per block when it fits, so every
//     gather hits on-chip memory; larger tables are read through L2;
//   * blocks stride over row tiles (a grid of a few blocks per SM), so
//     the table is staged a few hundred times per call, not once per tile;
//   * consecutive threads take consecutive (row, subspace) slots: code
//     reads and output writes are coalesced, and codes are read at their
//     stored width and widened in registers;
//   * a ragged B needs no padding: the last tile is simply shorter.
// Codes >= K are clamped to K-1 (and negative int32 codes to 0), the
// reference's mode="clip" gather: under mgqe private_k, rows of other
// tiers carry codes past this tier's K.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Tables up to this size are staged in shared memory; above 48 KB that
// takes the dynamic-shared-memory attribute.
constexpr size_t kMaxSmemTable = 160 * 1024;
// Blocks per SM for the shared-memory path (each stages the table once).
constexpr int kBlocksPerSm = 4;

// Code: uint8_t or int32_t.  Elem: the centroid element's storage type
// (uint32_t for float32, uint16_t for bfloat16) — a copy needs only the
// bits, so one template serves both float types exactly.
template <typename Code, typename Elem, bool kSmem>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const Code* __restrict__ codes, const Elem* __restrict__ cent,
              Elem* __restrict__ out, long long B, int D, int K, int S,
              int block_b) {
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
    const Code* c = codes + row0 * D;
    Elem* o = out + row0 * D * S;
    for (int j = threadIdx.x; j < n_slots; j += blockDim.x) {
      const int d = j % D;
      long long code = static_cast<long long>(c[j]);  // widen in registers
      code = code < 0 ? 0 : (code >= K ? K - 1 : code);
      const Elem* src = table + (static_cast<long long>(d) * K + code) * S;
      Elem* dst = o + static_cast<long long>(j) * S;
      for (int s = 0; s < S; ++s) dst[s] = src[s];
    }
  }
}

template <typename Code, typename Elem>
int launch(const void* codes, const void* cent, void* out, long long B,
           int D, int K, int S, int block_b, cudaStream_t stream) {
  const size_t table = static_cast<size_t>(D) * K * S * sizeof(Elem);
  const long long tiles = (B + block_b - 1) / block_b;
  const Code* c = static_cast<const Code*>(codes);
  const Elem* t = static_cast<const Elem*>(cent);
  Elem* o = static_cast<Elem*>(out);
  if (table <= kMaxSmemTable) {
    int sms = 0;
    cudaError_t err = repro_sm_count(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
    const int grid = static_cast<int>(tiles < cap ? tiles : cap);
    auto kern = decode_kernel<Code, Elem, true>;
    if (table > 48 * 1024) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(table));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kern<<<grid, kThreads, table, stream>>>(c, t, o, B, D, K, S, block_b);
  } else {
    const long long cap = 1LL << 20;
    const int grid = static_cast<int>(tiles < cap ? tiles : cap);
    decode_kernel<Code, Elem, false><<<grid, kThreads, 0, stream>>>(
        c, t, o, B, D, K, S, block_b);
  }
  return repro_last_error();
}

}  // namespace

// codes: (B, D) contiguous, code_bytes 1 (uint8) or 4 (int32);
// cent: (D, K, S) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// out: (B, D*S) contiguous, same element type as cent.  B > 0.
// Returns a cudaError_t (0 on success).
extern "C" int mgqe_decode_launch(const void* codes, int code_bytes,
                                  const void* cent, int elem_bytes,
                                  void* out, long long B, int D, int K,
                                  int S, int block_b, void* stream) {
  if (B <= 0 || D <= 0 || K <= 0 || S <= 0 || block_b <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1 && elem_bytes == 4)
    return launch<uint8_t, uint32_t>(codes, cent, out, B, D, K, S, block_b, st);
  if (code_bytes == 1 && elem_bytes == 2)
    return launch<uint8_t, uint16_t>(codes, cent, out, B, D, K, S, block_b, st);
  if (code_bytes == 4 && elem_bytes == 4)
    return launch<int32_t, uint32_t>(codes, cent, out, B, D, K, S, block_b, st);
  if (code_bytes == 4 && elem_bytes == 2)
    return launch<int32_t, uint16_t>(codes, cent, out, B, D, K, S, block_b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
