// Fused EmbeddingBag on Hopper: table (V, d) + ids (nnz,) + segment_ids
// (nnz,) sorted ascending + optional weights (nnz,) -> pooled
// (num_bags, d),
//   out[b] = sum over i with seg[i] == b of table[ids[i]] * w[i],
// summed from +0.0 in the order of i; a bag with no ids is zero.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/embedding_bag.py::
// embedding_bag (Pallas body _bag_kernel), which walked grid=(nnz,) in
// order, one id per step: scalar-prefetched index maps turned the gather
// into a block DMA and a revisited output block held each bag's running
// sum.  None of that carries to Hopper, where blocks run in no order:
// here each bag is owned by one group of lanes, which finds its ids
// itself and keeps its sum in registers.
//
// Order of the arithmetic: each product is __fmul_rn(row, w) and each
// add __fadd_rn(acc, product), never contracted into an FMA, so the sum
// is defined: acc = ((0 + t0) + t1) + ... in the bag's id order.  With
// no weights the product is skipped (a multiply by 1 is exact).  With a
// bfloat16 table the weights come as bfloat16 and every product and
// every add is rounded to bfloat16, as the TPU kernel's bfloat16
// `out_ref[...] += row * w` rounds.  ref.py's embedding_bag_inorder adds
// in the same order, one position of every bag per step, so the two agree
// bit for bit on the card and on the CPU; the op's plain version
// (embedding_bag_ref) is one float32 segment sum in the device's order.
//
// Bound: bytes.  The call must read nnz rows of d elements, the ids,
// segment ids and weights once, and write num_bags rows; it does one
// multiply and one add per element read.  What the design does:
//   * offsets: each lane group finds its bag's [start, end) by two binary
//     searches of the sorted segment ids, run in lockstep so their loads
//     overlap (no pre-pass kernel, no zero-fill pass, no atomics); an
//     empty bag finds start == end and stores zeros;
//   * work split: a group of G lanes per bag, each lane owning vectors of
//     V consecutive elements of the row (V = 4, 2 or 1 elements for
//     float32, up to 8 for bfloat16: the widest that divides d and suits
//     the alignment, at most 16 bytes), G = min(32, d / V).  At deepfm's
//     d = 10 that is 5 lanes of 2 elements, 6 bags to a warp (30 of 32
//     lanes busy); at d = 256 float32 one warp per bag, 8 elements per
//     lane in two passes of a float4;
//   * latency: a lane issues the loads of kChunk ids, then of their
//     weights and row vectors, and only then adds them, in order; the
//     lanes of a group read the same id and weight (one broadcast load);
//   * ids are widened and clamped to [0, V) in registers, so no id
//     outside the contract reads outside the table (the TPU kernel's
//     block index clamps the same way in interpret mode).

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// Ids whose loads a lane issues before it adds any of them.
constexpr int kChunk = 8;

// Element arithmetic by storage type: float32 as uint32_t bits, bfloat16
// as uint16_t bits.  Values are carried as floats that hold a value of
// the element type exactly.
template <typename Elem>
struct Num;

template <>
struct Num<uint32_t> {
  __device__ static float load(uint32_t x) { return __uint_as_float(x); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static uint32_t store(float a) { return __float_as_uint(a); }
};

template <>
struct Num<uint16_t> {
  __device__ static float load(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  __device__ static float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
  __device__ static float mul(float a, float b) {
    return round(__fmul_rn(a, b));
  }
  __device__ static float add(float a, float b) {
    return round(__fadd_rn(a, b));
  }
  __device__ static uint16_t store(float a) {
    return static_cast<uint16_t>(__float_as_uint(a) >> 16);  // exact
  }
};

// V consecutive elements of one row, loaded and stored as one vector.
template <typename Elem, int V>
struct alignas(sizeof(Elem) * V) Vec {
  Elem e[V];
};

// [lower_bound(key0), lower_bound(key1)) over the sorted seg[0, n), the
// two searches advanced together so their loads are in flight at once.
template <typename Idx>
__device__ __forceinline__ void bag_range(const Idx* __restrict__ seg,
                                          long long n, long long key0,
                                          long long key1, long long* start,
                                          long long* end) {
  long long lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;
  while (lo0 < hi0 || lo1 < hi1) {
    const long long m0 = lo0 + ((hi0 - lo0) >> 1);
    const long long m1 = lo1 + ((hi1 - lo1) >> 1);
    const bool a0 = lo0 < hi0, a1 = lo1 < hi1;
    const long long s0 = a0 ? static_cast<long long>(__ldg(seg + m0)) : 0;
    const long long s1 = a1 ? static_cast<long long>(__ldg(seg + m1)) : 0;
    if (a0) {
      if (s0 < key0) lo0 = m0 + 1; else hi0 = m0;
    }
    if (a1) {
      if (s1 < key1) lo1 = m1 + 1; else hi1 = m1;
    }
  }
  *start = lo0;
  *end = lo1;
}

// Idx: int32_t or int64_t (ids and segment ids alike).  Elem: uint32_t
// (float32) or uint16_t (bfloat16).  V: elements per vector (d % V == 0).
// G: vectors per row (d / V); lanes: lanes per bag, min(32, G); bags per
// warp: 32 / lanes.  w: weights in the table's element type, or null.
template <typename Idx, typename Elem, int V>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const Vec<Elem, V>* __restrict__ table,
           const Idx* __restrict__ ids, const Idx* __restrict__ seg,
           const Elem* __restrict__ w, Vec<Elem, V>* __restrict__ out,
           long long n_rows, long long nnz, long long num_bags, int G,
           int lanes) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lanes;
  const int group = lane / lanes;
  if (group >= per_warp) return;               // the warp's spare lanes
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long b = warp * per_warp + group;
  if (b >= num_bags) return;
  long long start, end;
  bag_range(seg, nnz, b, b + 1, &start, &end);
  for (int v = lane - group * lanes; v < G; v += lanes) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
    for (long long i0 = start; i0 < end; i0 += kChunk) {
      Vec<Elem, V> x[kChunk];
      float wt[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const long long i = i0 + k;
        if (i < end) {
          long long r = static_cast<long long>(__ldg(ids + i));
          r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
          x[k] = table[r * G + v];
          wt[k] = w != nullptr ? Num<Elem>::load(__ldg(w + i)) : 1.0f;
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (i0 + k < end) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float t = Num<Elem>::load(x[k].e[e]);
            if (w != nullptr) t = Num<Elem>::mul(t, wt[k]);
            acc[e] = Num<Elem>::add(acc[e], t);
          }
        }
      }
    }
    Vec<Elem, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.e[e] = Num<Elem>::store(acc[e]);
    out[b * G + v] = o;
  }
}

template <typename Idx, typename Elem, int V>
int launch_v(const void* table, long long n_rows, int d, const void* ids,
             const void* seg, const void* w, long long nnz, void* out,
             long long num_bags, cudaStream_t stream) {
  const int G = d / V;
  const int lanes = G < 32 ? G : 32;
  const long long per_block = static_cast<long long>(kThreads / 32)
                              * (32 / lanes);
  const long long grid = (num_bags + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bag_kernel<Idx, Elem, V><<<static_cast<unsigned>(grid), kThreads, 0,
                             stream>>>(
      static_cast<const Vec<Elem, V>*>(table), static_cast<const Idx*>(ids),
      static_cast<const Idx*>(seg), static_cast<const Elem*>(w),
      static_cast<Vec<Elem, V>*>(out), n_rows, nnz, num_bags, G, lanes);
  return repro_last_error();
}

// The widest vector of V elements (at most 16 bytes) that divides d and
// to which both the table and the output are aligned.
template <typename Idx, typename Elem>
int launch(const void* table, long long n_rows, int d, const void* ids,
           const void* seg, const void* w, long long nnz, void* out,
           long long num_bags, cudaStream_t stream) {
  const auto aligned = [&](int v) {
    const uintptr_t bytes = sizeof(Elem) * v;
    return bytes <= 16 && d % v == 0
           && reinterpret_cast<uintptr_t>(table) % bytes == 0
           && reinterpret_cast<uintptr_t>(out) % bytes == 0;
  };
  if constexpr (sizeof(Elem) * 8 <= 16) {
    if (aligned(8))
      return launch_v<Idx, Elem, 8>(table, n_rows, d, ids, seg, w, nnz, out,
                                    num_bags, stream);
  }
  if (aligned(4))
    return launch_v<Idx, Elem, 4>(table, n_rows, d, ids, seg, w, nnz, out,
                                  num_bags, stream);
  if (aligned(2))
    return launch_v<Idx, Elem, 2>(table, n_rows, d, ids, seg, w, nnz, out,
                                  num_bags, stream);
  return launch_v<Idx, Elem, 1>(table, n_rows, d, ids, seg, w, nnz, out,
                                num_bags, stream);
}

}  // namespace

// table: (n_rows, d) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// ids, seg: (nnz,) contiguous, idx_bytes 4 (int32) or 8 (int64), seg
// sorted ascending; w: (nnz,) in the table's element type, or null;
// out: (num_bags, d) contiguous, the table's element type.  num_bags > 0,
// d > 0, n_rows > 0 when nnz > 0.  Returns a cudaError_t (0 on success).
extern "C" int embedding_bag_launch(const void* table, int elem_bytes,
                                    long long n_rows, int d, const void* ids,
                                    const void* seg, int idx_bytes,
                                    const void* w, long long nnz, void* out,
                                    long long num_bags, void* stream) {
  if (num_bags <= 0 || d <= 0 || nnz < 0 || (nnz > 0 && n_rows <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4 && elem_bytes == 4)
    return launch<int32_t, uint32_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, st);
  if (idx_bytes == 4 && elem_bytes == 2)
    return launch<int32_t, uint16_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, st);
  if (idx_bytes == 8 && elem_bytes == 4)
    return launch<int64_t, uint32_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, st);
  if (idx_bytes == 8 && elem_bytes == 2)
    return launch<int64_t, uint16_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
