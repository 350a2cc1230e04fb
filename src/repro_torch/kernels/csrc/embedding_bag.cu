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
// sum.  None of that carries to Hopper, where blocks run in no order.
//
// Order of the arithmetic: each product is round(row * w) and each add
// round(acc + product), never contracted into an FMA, so the sum is
// defined: acc = ((0 + t0) + t1) + ... in the bag's id order.  With no
// weights the product is skipped (a multiply by 1 is exact).  float32
// uses __fmul_rn and __fadd_rn.  With a bfloat16 table the weights come
// as bfloat16 and every product and every add is rounded to bfloat16,
// as the TPU kernel's bfloat16 `out_ref[...] += row * w` rounds: pairs
// of elements as packed bfloat16 operations (Acc below: one rounding of
// the exact result, which equals the float32 operation rounded to
// bfloat16), a lone element by the float32 operation and a rounding.
// ref.py's embedding_bag_inorder adds in the same order, so the two
// agree bit for bit on the card and on the CPU; the op's plain version
// (embedding_bag_ref) is one float32 segment sum in the device's order.
//
// Bound: bytes.  The call must read nnz rows of d elements, the ids,
// segment ids and weights once, and write num_bags rows; it does one
// multiply and one add per element read.  Rows are random: a 40-byte
// float32 row (deepfm's d = 10) at an 8-byte-aligned offset always
// touches two 32-byte sectors, so the card moves 64 bytes for its 40,
// about 1.45x the bound's bytes at deepfm's shape (10.1 of 6.97 MB).
// At that width the call is short (a few microseconds) and its time is
// latency: chains of dependent loads and a launch's ramp.  The design:
//
//   * bag tiles: a block owns the bags [b0, b0 + T) (T from the launch
//     plan, kernels/embedding_bag/embedding_bag.py::bag_plan, sized so
//     that the grid fills the card) and, on a grid's second dimension, a
//     slab of up to 256 vectors of each row.  Warps 0 and 1 find the
//     tile's span [lo, hi) of ids by a 32-way warp search each: 32 lanes
//     load 32 segment ids and a ballot picks the interval, the first
//     step's pivots around where equal bags would put the answer, three
//     dependent loads at deepfm's 130,926 ids instead of the 17 of a
//     binary search;
//   * staged indices: the span is walked in chunks of C ids.  The block
//     loads a chunk's ids (clamped to [0, V)) and weights into shared
//     memory, coalesced, and the thread that reads segment id seg[i]
//     writes the start of every bag in (seg[i-1], seg[i]] (an adjacent
//     difference): a bag with no ids starts where the next one does, so
//     its range is empty.  A start not yet found is a sentinel past every
//     chunk, so a bag that straddles chunks is summed over each in turn.
//     No pre-pass kernel, no zero-fill pass, no atomics;
//   * a flat gather: all threads of the block take the chunk's (id,
//     vector) pairs in flat order, each a cp.async of 4, 8 or 16 bytes
//     into a shared buffer of C rows, so every row load of a chunk is in
//     flight at once whatever the bags' lengths, and no lane idles at d
//     = 10.  Two buffers: chunk c + 1's gather is issued before chunk c
//     is summed, and chunk c + 2's indices are staged while c + 1's rows
//     are in flight;
//   * an in-order sum: a thread per (bag, vector) adds its bag's staged
//     rows of the chunk in id order, kAhead rows' loads ahead of their
//     adds; its accumulators stay in registers across chunks, and it
//     stores once, one vector.  One bag is still summed by one thread
//     per vector in id order (the order is the function), so a very long
//     bag bounds the launch: that is the kernel's worst case;
//   * wide rows: a slab of 512 bytes or more (d = 256) takes tiles of one
//     bag and chunks of 16 KB of rows, so that several blocks share an SM
//     and one's sum overlaps the others' gathers; rows of more than 256
//     vectors are cut into slabs on the grid's second dimension, so a
//     chunk always holds at least one row;
//   * vectors: V consecutive elements (the widest of 8 (bfloat16), 4, 2
//     or 1 that divides d and the table's and output's alignment, at most
//     16 bytes), chosen by the planner and re-checked here; a 2-byte
//     vector (bfloat16, odd d) is copied by plain loads, cp.async taking
//     4 bytes at least.

#include <atomic>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cstring>

#include "common.cuh"

namespace {

// The planner's block size (bag_plan's BAG_THREADS): a thread per
// (bag, vector) of the tile in the sum, every thread in the gather.
constexpr int kThreads = 256;
constexpr int kSmemMax = 227 * 1024;
// Rows a thread's sum loads before it adds them.
constexpr int kAhead = 4;

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

// A thread's running sum of one vector: acc = round(acc + round(x * w))
// element by element, from +0.0.  float32 adds in float32.  bfloat16
// adds pairs of elements as packed bfloat16 (mul.rn.bf16x2,
// add.rn.bf16x2: one rounding to bfloat16 of the exact product or
// sum), which equals the float32 operation rounded to bfloat16, the
// plain version's arithmetic: a product of two bfloat16 values is exact
// in float32, and a sum rounded first to float32's 24 bits and then to
// bfloat16's 8 is rounded correctly, 24 >= 2 * 8 + 2 (Figueroa's
// double-rounding bound).  A vector of one bfloat16 (odd d) takes the
// float32 operations and rounds each.
template <typename Elem, int V>
struct Acc {
  float a[V];
  __device__ Acc() {
#pragma unroll
    for (int e = 0; e < V; ++e) a[e] = 0.0f;
  }
  __device__ void add(const Vec<Elem, V>& x, float w, bool weighted) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t = Num<Elem>::load(x.e[e]);
      if (weighted) t = Num<Elem>::mul(t, w);
      a[e] = Num<Elem>::add(a[e], t);
    }
  }
  __device__ Vec<Elem, V> vec() const {
    Vec<Elem, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.e[e] = Num<Elem>::store(a[e]);
    return o;
  }
};

template <int V>
struct Acc<uint16_t, V> {
  static_assert(V % 2 == 0, "pairs of bfloat16");
  __nv_bfloat162 a[V / 2];
  __device__ Acc() {
    const uint32_t zero = 0;                              // +0.0, +0.0
#pragma unroll
    for (int e = 0; e < V / 2; ++e) memcpy(&a[e], &zero, sizeof(zero));
  }
  __device__ void add(const Vec<uint16_t, V>& x, float w, bool weighted) {
    const __nv_bfloat162 w2 = __float2bfloat162_rn(w);   // exact
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      __nv_bfloat162 t;
      memcpy(&t, &x.e[2 * e], sizeof(t));
      if (weighted) t = __hmul2_rn(t, w2);
      a[e] = __hadd2_rn(a[e], t);
    }
  }
  __device__ Vec<uint16_t, V> vec() const {
    Vec<uint16_t, V> o;
    memcpy(o.e, a, sizeof(o));
    return o;
  }
};

template <>
struct Acc<uint16_t, 1> {
  float a = 0.0f;
  __device__ void add(const Vec<uint16_t, 1>& x, float w, bool weighted) {
    float t = Num<uint16_t>::load(x.e[0]);
    if (weighted) t = Num<uint16_t>::mul(t, w);
    a = Num<uint16_t>::add(a, t);
  }
  __device__ Vec<uint16_t, 1> vec() const {
    Vec<uint16_t, 1> o;
    o.e[0] = Num<uint16_t>::store(a);
    return o;
  }
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// A block's shared memory, in bytes from its start: the span (lo, hi),
// the tile's T + 1 bag starts, then two buffers, each a chunk's C ids,
// C weights (float) and C rows of `slab` vectors; buffer q's arrays lie
// q * buf bytes past buffer 0's.  bag_plan's bag_smem computes the same
// total.
struct Layout {
  size_t starts, ids, w, rows, buf, total;
};

__host__ __device__ inline Layout layout(int tile, int chunk, int slab,
                                         int vec_bytes, int idx_bytes) {
  Layout L;
  L.starts = 16;
  L.ids = L.starts + align16(8 * static_cast<size_t>(tile + 1));
  L.w = L.ids + align16(static_cast<size_t>(chunk) * idx_bytes);
  L.rows = L.w + align16(static_cast<size_t>(chunk) * 4);
  L.buf = L.rows + align16(static_cast<size_t>(chunk) * slab * vec_bytes)
          - L.ids;
  L.total = L.ids + 2 * L.buf;
  return L;
}

// lower_bound(key) over the sorted seg[0, n), by one warp: each step 32
// lanes load the segment ids at 32 pivots and a ballot picks the piece
// that holds the answer; the last <= 32 candidates are loaded at once.
// Where n > 32 * kHintStep the first step's pivots lie kHintStep apart
// around `hint` (the answer were the bags of equal length), so that at
// deepfm's 130,926 ids three dependent loads find it, not four; pivots
// that miss leave the rest of [0, n) to the even steps.  Every lane
// returns the answer.
constexpr long long kHintStep = 1024;

template <typename Idx>
__device__ long long warp_lower_bound(const Idx* __restrict__ seg,
                                      long long n, long long key,
                                      long long hint, int lane) {
  long long l = 0, h = n;
  if (n > 32 * kHintStep) {
    const long long base = hint - 16 * kHintStep - 1;
    const auto pivot = [&](long long j) {      // nondecreasing in j
      const long long p = base + (j + 1) * kHintStep;
      return p < 0 ? 0 : (p >= n ? n - 1 : p);
    };
    const unsigned ge = __ballot_sync(
        0xffffffffu,
        static_cast<long long>(__ldg(seg + pivot(lane))) >= key);
    if (ge == 0) {
      l = pivot(31) + 1;
    } else {
      const long long j = __ffs(ge) - 1;
      h = pivot(j);                         // seg[h] >= key
      if (j) l = pivot(j - 1) + 1;          // seg[l - 1] < key
    }
  }
  while (h - l > 32) {
    const long long len = h - l;
    const long long p = l + ((lane + 1LL) * len >> 5) - 1;
    const unsigned ge = __ballot_sync(
        0xffffffffu, static_cast<long long>(__ldg(seg + p)) >= key);
    if (ge == 0) return h;
    const long long j = __ffs(ge) - 1;
    h = l + ((j + 1) * len >> 5) - 1;   // seg[h] >= key
    l += j * len >> 5;                  // seg[l - 1] < key
  }
  const long long i = l + lane;
  const unsigned ge = __ballot_sync(
      0xffffffffu,
      i < h && static_cast<long long>(__ldg(seg + i)) >= key);
  return ge ? l + __ffs(ge) - 1 : h;
}

// One vector global -> shared: cp.async for 4, 8 or 16 bytes, a plain
// copy for 2 (cp.async copies 4 bytes at least).
template <int Bytes>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src) : "memory");
  } else if constexpr (Bytes == 8 || Bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(Bytes) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = __ldg(static_cast<const uint16_t*>(src));
  }
}

// Idx: int32_t or int64_t (ids and segment ids alike).  Elem: uint32_t
// (float32) or uint16_t (bfloat16).  V: elements a vector (d % V == 0).
// G: vectors a row (d / V); tile: bags a block; chunk: ids a chunk;
// slab: vectors of a row a block sums (blockIdx.y picks which).
// w: weights in the table's element type, or null.
template <typename Idx, typename Elem, int V>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const Vec<Elem, V>* __restrict__ table,
           const Idx* __restrict__ ids, const Idx* __restrict__ seg,
           const Elem* __restrict__ w, Vec<Elem, V>* __restrict__ out,
           long long n_rows, long long nnz, long long num_bags, int G,
           int tile, int chunk, int slab) {
  using VecT = Vec<Elem, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(tile, chunk, slab, sizeof(VecT), sizeof(Idx));
  long long* span = reinterpret_cast<long long*>(smem);
  long long* start = reinterpret_cast<long long*>(smem + L.starts);
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile;
  const int nb = static_cast<int>(
      num_bags - b0 < tile ? num_bags - b0 : tile);
  const int slab0 = blockIdx.y * slab;
  const int width = G - slab0 < slab ? G - slab0 : slab;

  for (int t = tid; t <= nb; t += kThreads) start[t] = LLONG_MAX;
  if (tid < 64) {
    const int wp = tid >> 5;
    const long long key = b0 + (wp ? nb : 0);
    const long long at = warp_lower_bound(
        seg, nnz, key,
        static_cast<long long>(static_cast<double>(key) / num_bags * nnz),
        tid & 31);
    if ((tid & 31) == 0) span[wp] = at;
  }
  __syncthreads();
  const long long lo = span[0], hi = span[1];

  // The chunk of span positions [c0, c0 + n) into buffer q: ids (clamped)
  // and weights, and the start of every bag of the tile whose first id,
  // or the first id after it if it has none, lies there.
  auto stage = [&](long long c0, int n, int q) {
    Idx* id_s = reinterpret_cast<Idx*>(smem + L.ids + q * L.buf);
    float* w_s = reinterpret_cast<float*>(smem + L.w + q * L.buf);
    for (int k = tid; k < n; k += kThreads) {
      const long long i = c0 + k;
      long long r = static_cast<long long>(__ldg(ids + i));
      r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
      id_s[k] = static_cast<Idx>(r);
      w_s[k] = w != nullptr ? Num<Elem>::load(__ldg(w + i)) : 1.0f;
      long long s = static_cast<long long>(__ldg(seg + i));
      long long b = i == lo ? b0 : static_cast<long long>(__ldg(seg + i - 1))
                                       + 1;
      if (b < b0) b = b0;
      if (s > b0 + nb - 1) s = b0 + nb - 1;
      for (; b <= s; ++b) start[b - b0] = i;
    }
  };
  // The chunk's n rows (this block's slab of each) into buffer q.
  auto gather = [&](int n, int q) {
    const Idx* id_s = reinterpret_cast<const Idx*>(smem + L.ids + q * L.buf);
    VecT* rows = reinterpret_cast<VecT*>(smem + L.rows + q * L.buf);
    const VecT* src = table + slab0;
    for (int p = tid; p < n * width; p += kThreads) {
      const int k = p / width, col = p - k * width;
      copy_vec<static_cast<int>(sizeof(VecT))>(
          rows + k * slab + col,
          src + static_cast<long long>(id_s[k]) * G + col);
    }
  };

  // The sum: a thread per (bag, vector) of the tile's rows.
  const int t = tid / slab, v = tid - t * slab;
  const bool active = t < nb && v < width;
  Acc<Elem, V> acc;
  // This thread's bag's ids in the chunk [c0, c0 + n) of buffer q, added
  // in order, the loads of kAhead rows issued before their adds.
  auto sum = [&](long long c0, int n, int q) {
    if (!active) return;
    const long long s0 = start[t] > c0 ? start[t] : c0;
    const long long s1 = start[t + 1] < c0 + n ? start[t + 1] : c0 + n;
    if (s1 <= s0) return;
    const VecT* rows =
        reinterpret_cast<const VecT*>(smem + L.rows + q * L.buf);
    const float* w_s =
        reinterpret_cast<const float*>(smem + L.w + q * L.buf);
    int k = static_cast<int>(s0 - c0);
    const int k1 = static_cast<int>(s1 - c0);
    for (; k + kAhead <= k1; k += kAhead) {
      VecT x[kAhead];
      float wt[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        x[j] = rows[(k + j) * slab + v];
        wt[j] = w_s[k + j];
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) acc.add(x[j], wt[j], w != nullptr);
    }
    for (; k < k1; ++k)
      acc.add(rows[k * slab + v], w_s[k], w != nullptr);
  };

  const long long n_ids = hi - lo;
  const long long n_chunks = (n_ids + chunk - 1) / chunk;
  auto size = [&](long long c) {
    const long long rest = n_ids - c * chunk;
    return static_cast<int>(rest < chunk ? rest : chunk);
  };
  if (n_chunks > 0) {
    stage(lo, size(0), 0);
    __syncthreads();
    gather(size(0), 0);
    cp_async_commit();
    if (n_chunks > 1) stage(lo + chunk, size(1), 1);
    for (long long c = 0; c < n_chunks; ++c) {
      const int q = static_cast<int>(c & 1);
      __syncthreads();                    // chunk c + 1's indices staged
      if (c + 1 < n_chunks) gather(size(c + 1), q ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                 // this thread's chunk c landed
      __syncthreads();                    // every thread's
      sum(lo + c * chunk, size(c), q);
      if (c + 2 < n_chunks) {
        __syncthreads();                  // buffer q read by every thread
        stage(lo + (c + 2) * chunk, size(c + 2), q);
      }
    }
  }
  if (active) out[(b0 + t) * G + slab0 + v] = acc.vec();
}

// Raises the kernel's dynamic shared memory limit to `smem` where it is
// past 48 KB, once per device and size (a launch of a few microseconds
// should not pay for the attribute call every time).
template <typename Kernel>
int allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  constexpr int kMaxDevices = 64;
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(smem);
  if (dev < kMaxDevices
      && allowed[dev].load(std::memory_order_relaxed) >= bytes)
    return 0;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(bytes, std::memory_order_relaxed);
  return static_cast<int>(err);
}

template <typename Idx, typename Elem, int V>
int launch_v(const void* table, long long n_rows, int d, const void* ids,
             const void* seg, const void* w, long long nnz, void* out,
             long long num_bags, int tile, int chunk, int slab, int grid_x,
             int grid_y, size_t smem, cudaStream_t stream) {
  auto kern = bag_kernel<Idx, Elem, V>;
  const int err = allow_smem(kern, smem);
  if (err) return err;
  kern<<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      static_cast<const Vec<Elem, V>*>(table), static_cast<const Idx*>(ids),
      static_cast<const Idx*>(seg), static_cast<const Elem*>(w),
      static_cast<Vec<Elem, V>*>(out), n_rows, nnz, num_bags, d / V, tile,
      chunk, slab);
  return repro_last_error();
}

template <typename Idx, typename Elem>
int launch(const void* table, long long n_rows, int d, const void* ids,
           const void* seg, const void* w, long long nnz, void* out,
           long long num_bags, int vec, int tile, int chunk, int slab,
           int grid_x, int grid_y, size_t smem, cudaStream_t stream) {
#define REPRO_BAG_LAUNCH(VV)                                                 \
  return launch_v<Idx, Elem, VV>(table, n_rows, d, ids, seg, w, nnz, out,    \
                                 num_bags, tile, chunk, slab, grid_x, grid_y, \
                                 smem, stream)
  if constexpr (sizeof(Elem) == 2) {
    if (vec == 8) REPRO_BAG_LAUNCH(8);
  }
  if (vec == 4) REPRO_BAG_LAUNCH(4);
  if (vec == 2) REPRO_BAG_LAUNCH(2);
  if (vec == 1) REPRO_BAG_LAUNCH(1);
#undef REPRO_BAG_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// A plan the kernel can run: a vector of at most 16 bytes that divides d
// and the table's and output's alignment, kThreads threads, a tile of
// bags whose (bag, vector) pairs the threads cover, slabs that cover a
// row, a grid of every tile and slab, and exactly the shared memory the
// layout needs, at most kSmemMax.
bool bad_plan(const void* table, const void* out, int elem_bytes,
              int idx_bytes, int d, long long num_bags, int vec, int tile,
              int chunk, int slab, int grid_x, int grid_y, int threads,
              long long smem) {
  const int vb = vec * elem_bytes;
  if (vec < 1 || vb > 16 || (vec & (vec - 1)) != 0 || d % vec != 0)
    return true;
  if (reinterpret_cast<uintptr_t>(table) % vb != 0
      || reinterpret_cast<uintptr_t>(out) % vb != 0)
    return true;
  const int G = d / vec;
  if (threads != kThreads || slab < 1 || slab > G || tile < 1
      || static_cast<long long>(tile) * slab > kThreads || chunk < 1)
    return true;
  if (grid_y != (G + slab - 1) / slab || grid_y > 65535
      || grid_x != (num_bags + tile - 1) / tile)
    return true;
  if (static_cast<long long>(chunk) * slab * vb > kSmemMax) return true;
  const size_t need = layout(tile, chunk, slab, vb, idx_bytes).total;
  return smem < 0 || static_cast<size_t>(smem) != need || need > kSmemMax;
}

}  // namespace

// table: (n_rows, d) contiguous, elem_bytes 4 (float32) or 2 (bfloat16);
// ids, seg: (nnz,) contiguous, idx_bytes 4 (int32) or 8 (int64), seg
// sorted ascending in [0, num_bags); w: (nnz,) in the table's element
// type, or null; out: (num_bags, d) contiguous, the table's element
// type.  num_bags > 0, d > 0, n_rows > 0 when nnz > 0.  The launch plan
// (vec, tile, chunk, slab, grid, threads, smem) is bag_plan's; one the
// kernel cannot run is refused.  Returns a cudaError_t (0 on success).
extern "C" int embedding_bag_launch(const void* table, int elem_bytes,
                                    long long n_rows, int d, const void* ids,
                                    const void* seg, int idx_bytes,
                                    const void* w, long long nnz, void* out,
                                    long long num_bags, int vec, int tile,
                                    int chunk, int slab, int grid_x,
                                    int grid_y, int threads, long long smem,
                                    void* stream) {
  if (num_bags <= 0 || d <= 0 || nnz < 0 || (nnz > 0 && n_rows <= 0)
      || (elem_bytes != 4 && elem_bytes != 2)
      || (idx_bytes != 4 && idx_bytes != 8)
      || bad_plan(table, out, elem_bytes, idx_bytes, d, num_bags, vec, tile,
                  chunk, slab, grid_x, grid_y, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (idx_bytes == 4 && elem_bytes == 4)
    return launch<int32_t, uint32_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, vec, tile, chunk, slab, grid_x,
                                     grid_y, sm, st);
  if (idx_bytes == 4)
    return launch<int32_t, uint16_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, vec, tile, chunk, slab, grid_x,
                                     grid_y, sm, st);
  if (elem_bytes == 4)
    return launch<int64_t, uint32_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                     num_bags, vec, tile, chunk, slab, grid_x,
                                     grid_y, sm, st);
  return launch<int64_t, uint16_t>(table, n_rows, d, ids, seg, w, nnz, out,
                                   num_bags, vec, tile, chunk, slab, grid_x,
                                   grid_y, sm, st);
}
