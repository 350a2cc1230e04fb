// DPQ/MGQE nearest-centroid assignment on Hopper:
// e_sub (B, D, S) f32 + centroids (D, K, S) f32 + k_limit (B,) int32 or
// null -> codes (B, D) int32, codes[b, d] = argmin over k < k_limit[b] of
// ||c_dk||^2 - 2 e_bd . c_dk, ties to the first index.
//
// Replaces the TPU kernel src/repro/kernels/dpq_assign/dpq_assign.py::
// dpq_assign (Pallas body _assign_kernel), which fed the distances to the
// MXU as a (block, S) x (S, K) matmul.  With S = 2 (deepfm) a matmul has
// nothing to contract, so here each thread walks its row's K centroids in
// f32 registers.
//
// Bound: operations.  The call does 2*S FLOP for every centroid a row may
// use (sum over rows of k_limit * D * S multiply-adds) and reads only
// B*D*S floats and writes B*D codes.  What the design does about it:
//   * one block owns one subspace d and a tile of rows (grid: row tiles x
//     D); it stages centroids[d] (K*S floats) and ||c_dk||^2 (K floats) in
//     shared memory — 3 KB at S=2, K=256 — and every thread of a warp
//     reads the same centroid at the same time (a broadcast, no bank
//     conflicts);
//   * when one subspace's table does not fit a block's shared memory (an
//     LM token table: S = 2560 / 8 = 320, K = 256 is 321 KB), the block
//     walks K in chunks of kc centroids that do fit, staging one chunk at
//     a time; the running argmin stays in registers across chunks, and
//     the block stops once no row's budget reaches the next chunk;
//   * a row's S values live in registers (S a template constant for
//     S in {1, 2, 4, 8, 16}); the (B, D, K) distances never leave them;
//   * the k_limit mask is the loop bound: slots past a row's budget are
//     never evaluated, so tail-tier rows cost K_tail / K of a head row;
//   * the running argmin replaces only on a strictly smaller distance,
//     so ties keep the first index, as jnp.argmin and torch.argmin do.
// The dot product runs in order s = 0..S-1 with fused multiply-adds; the
// plain version's matmul may round differently in the last bit, so codes
// can differ from it only between near-equal distances.
// Only float32 is taken (the deepfm param_dtype); the wrapper raises on
// other types.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// kS > 0: S known at compile time (registers); kS == 0: any S.  The
// table is staged kc centroids at a time (kc == K: all of it at once).
template <int kS>
__global__ void assign_kernel(const float* __restrict__ e_sub,
                              const float* __restrict__ cent,
                              const int32_t* __restrict__ k_limit,
                              int32_t* __restrict__ codes, long long B,
                              int D, int K, int S, int kc) {
  extern __shared__ __align__(16) float smem[];
  const int d = blockIdx.y;
  float* c = smem;                                   // (kc, S)
  float* csq = smem + static_cast<size_t>(kc) * S;   // (kc,)
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const bool active = b < B;
  int lim = 0;                      // rows past B evaluate nothing
  if (active) {
    lim = K;
    if (k_limit != nullptr) {
      const int l = k_limit[b];
      lim = l < K ? l : K;
    }
  }
  const float* e = e_sub + (active ? (b * D + d) * S : 0);
  float ev[kS > 0 ? kS : 1];
  if constexpr (kS > 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) ev[s] = active ? e[s] : 0.0f;
  }
  float best = INFINITY;
  int idx = 0;
  for (int k0 = 0; k0 < K; k0 += kc) {
    // a later chunk: stop when no row's budget reaches it; the vote is
    // also the barrier before the shared memory is overwritten
    if (k0 > 0 && !__syncthreads_or(lim > k0)) break;
    const int n = K - k0 < kc ? K - k0 : kc;
    const float* cd = cent + (static_cast<size_t>(d) * K + k0) * S;
    for (int i = threadIdx.x; i < n * S; i += blockDim.x) c[i] = cd[i];
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      // square, then sum: rounded as the plain version's two ops round
      float acc = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float x = c[k * S + s];
        acc = __fadd_rn(acc, __fmul_rn(x, x));
      }
      csq[k] = acc;
    }
    __syncthreads();
    const int end = lim < k0 + n ? lim : k0 + n;
    for (int k = k0; k < end; ++k) {        // k: the centroid's index
      const int kk = k - k0;                // its slot in the chunk
      float dot = 0.0f;
      if constexpr (kS > 0) {
        const float* ck = c + kk * kS;
#pragma unroll
        for (int s = 0; s < kS; ++s) dot = fmaf(ev[s], ck[s], dot);
      } else {
        const float* ck = c + static_cast<size_t>(kk) * S;
        for (int s = 0; s < S; ++s) dot = fmaf(e[s], ck[s], dot);
      }
      const float dist = csq[kk] - 2.0f * dot;
      // strictly smaller: ties keep the first index, across chunks too
      if (dist < best) {
        best = dist;
        idx = k;
      }
    }
  }
  if (active) codes[b * D + d] = idx;
}

template <int kS>
int launch(const float* e_sub, const float* cent, const int32_t* k_limit,
           int32_t* codes, long long B, int D, int K, int S, int kc,
           int block_b, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kc) * (S + 1) * sizeof(float);
  auto kern = assign_kernel<kS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((B + block_b - 1) / block_b),
                  static_cast<unsigned>(D));
  kern<<<grid, block_b, smem, stream>>>(e_sub, cent, k_limit, codes, B, D,
                                        K, S, kc);
  return repro_last_error();
}

}  // namespace

// e_sub: (B, D, S) f32 contiguous; cent: (D, K, S) f32 contiguous;
// k_limit: (B,) int32 or null (every row may use all K); codes: (B, D)
// int32.  B > 0; kc in [1, K] centroids are staged at a time
// (kc * (S + 1) floats of shared memory); block_b is the block's thread
// count (rows per block).  Returns a cudaError_t (0 on success).
extern "C" int dpq_assign_launch(const void* e_sub, const void* cent,
                                 const void* k_limit, void* codes,
                                 long long B, int D, int K, int S, int kc,
                                 int block_b, void* stream) {
  if (B <= 0 || D <= 0 || D > 65535 || K <= 0 || S <= 0 || kc <= 0
      || kc > K || block_b <= 0 || block_b > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* e = static_cast<const float*>(e_sub);
  const float* c = static_cast<const float*>(cent);
  const int32_t* l = static_cast<const int32_t*>(k_limit);
  int32_t* o = static_cast<int32_t*>(codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch<1>(e, c, l, o, B, D, K, S, kc, block_b, st);
    case 2: return launch<2>(e, c, l, o, B, D, K, S, kc, block_b, st);
    case 4: return launch<4>(e, c, l, o, B, D, K, S, kc, block_b, st);
    case 8: return launch<8>(e, c, l, o, B, D, K, S, kc, block_b, st);
    case 16: return launch<16>(e, c, l, o, B, D, K, S, kc, block_b, st);
    default: return launch<0>(e, c, l, o, B, D, K, S, kc, block_b, st);
  }
}
