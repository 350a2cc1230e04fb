// The skeleton of the small-table decode kernels (mgqe_decode.cu,
// packed_decode.cu, rq_decode_stages.cu): per-warp chunks of kChunk rows
// gathered from a table staged in shared memory.
//
// A block stages its table with 16-byte cp.async loads, together with
// each warp's first chunk of input rows, and meets once.  From there each
// warp runs on its own over chunks w, w + (warps in the grid), ...: the
// next chunk's input comes in by cp.async into the other half of the
// warp's double buffer while the lanes turn the current one into output
// rows in the warp's output chunk in shared memory; the warp then writes
// the chunk, n * out_row contiguous bytes, in 16-byte vectors with a
// 2-byte tail.  No block barrier after the first, so a warp's stores
// start as soon as its own rows are gathered.
//
// Alignment.  kChunk * in_row and kChunk * out_row are multiples of 16
// for every row width the kernels take (in_row a whole number of bytes,
// out_row even), so chunk starts keep the alignment of the tensor's base:
// input chunks come in by cp.async when the base is 16-byte aligned (else
// byte by byte) and output chunks go out in uint4 (the wrappers allocate
// the output, 16-byte aligned).  The caller's plan sizes the dynamic
// shared memory as `table` bytes (16-byte aligned) plus warp_bytes() a
// warp.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace chunks {

constexpr int kChunk = 32;            // rows a warp gathers at a time
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemMax = 227 * 1024;
// The walk routes' largest staged table, and the gather kernels' largest
// slot (a row's S elements of one subspace) on them; past these the
// kernels read the table through L2.
constexpr size_t kSmemTableMax = 96 * 1024;
constexpr int kSmemSlotMax = 64;

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A warp's shared memory: two chunks of input rows and one of output.
__host__ __device__ __forceinline__ size_t warp_bytes(size_t in_row,
                                                      size_t out_row) {
  return 2 * align16(kChunk * in_row) + kChunk * out_row;
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

// The block's walk.  `in`: B rows of in_row bytes (16-byte aligned when
// in_aligned); `out`: B rows of out_row bytes, 16-byte aligned; `warps`:
// the shared memory past the staged table, warp_bytes() a warp.
// stage(): every thread of the block issues its share of the table's
// cp.async copies (or plain stores).  fill(in_chunk, n, out_chunk): the
// warp turns n <= kChunk input rows in shared memory into n output rows
// in shared memory (every lane calls it).
template <typename Stage, typename Fill>
__device__ __forceinline__ void walk(const unsigned char* __restrict__ in,
                                     size_t in_row, bool in_aligned,
                                     unsigned char* __restrict__ out,
                                     size_t out_row, long long B,
                                     unsigned char* warps, Stage stage,
                                     Fill fill) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t in_chunk = align16(kChunk * in_row);
  unsigned char* wsm = warps + warp * warp_bytes(in_row, out_row);
  unsigned char* ibuf[2] = {wsm, wsm + in_chunk};
  unsigned char* obuf = wsm + 2 * in_chunk;
  const long long n_chunks = (B + kChunk - 1) / kChunk;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);

  auto load = [&](long long chunk, int buf) {
    const long long r0 = chunk * kChunk;
    const long long n = B - r0 < kChunk ? B - r0 : kChunk;
    copy_in(ibuf[buf], in + r0 * in_row, static_cast<size_t>(n) * in_row,
            in_aligned, lane, 32);
  };

  long long chunk =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  stage();
  if (chunk < n_chunks) load(chunk, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();     // the table is in (and each warp's first chunk)
  for (int it = 0; chunk < n_chunks; ++it, chunk += step) {
    if (chunk + step < n_chunks) {
      load(chunk + step, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();      // this chunk's input (every lane's copies) is in
    const long long r0 = chunk * kChunk;
    const int n = static_cast<int>(B - r0 < kChunk ? B - r0 : kChunk);
    fill(ibuf[it & 1], n, obuf);
    __syncwarp();      // the output chunk is complete
    // n * out_row is a multiple of 16 for every chunk but the last
    const size_t bytes = static_cast<size_t>(n) * out_row;
    unsigned char* g = out + static_cast<size_t>(r0) * out_row;
    for (size_t i = lane; 16 * i + 16 <= bytes; i += 32)
      reinterpret_cast<uint4*>(g)[i] = reinterpret_cast<const uint4*>(obuf)[i];
    for (size_t i = bytes / 16 * 8 + lane; 2 * i < bytes; i += 32)
      reinterpret_cast<uint16_t*>(g)[i] =
          reinterpret_cast<const uint16_t*>(obuf)[i];
    __syncwarp();      // read out before the next chunk overwrites it
  }
}

// The l2 routes of the gather kernels: a group of `group` lanes (`lane`
// its index in the group) copies one slot of `vecs` vectors from the
// table through L2, up to kAhead vectors a lane in flight, so a warp's
// loads and stores are contiguous runs.
template <typename Vec>
__device__ __forceinline__ void copy_slot(const Vec* __restrict__ src,
                                          Vec* __restrict__ dst, int vecs,
                                          int lane, int group) {
  constexpr int kAhead = 4;
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

// The widest vector (bytes) that divides `slot` and the table's address
// (an l2 route's loads start at table + a multiple of slot).
inline int vec_bytes(int slot, const void* table) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table);
  for (int v = 16; v > 2; v /= 2)
    if (slot % v == 0 && a % v == 0) return v;
  return 2;
}

// Launches a walk kernel with `smem` bytes of dynamic shared memory,
// raising the kernel's limit first where it is past 48 KB.
template <typename Kernel, typename... Args>
int launch_smem(Kernel kern, int grid, int threads, size_t smem,
                cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return repro_last_error();
}

// A walk route's launch shape is sound: at least one block of whole
// warps, at most kMaxThreads, and exactly the shared memory it needs.
inline bool bad_walk(int grid, int threads, long long smem, size_t need) {
  return grid <= 0 || threads <= 0 || threads > kMaxThreads
         || threads % 32 != 0 || smem < 0
         || static_cast<size_t>(smem) != need || need > kSmemMax;
}

}  // namespace chunks
