// Kernel A — the stream engine's count, one launch over every bucket.
//
// Replaces graphminer_tpu/ops/stream.py::_bucket_counts_fused, which the
// JAX package runs over all buckets in one XLA dispatch (_stream_partials;
// an XLA broadcast-reduce, torch has no popcount). One bucket holds
//   dst[n, ws + wtv]          dst rows: ws bitmap words, wtv sorted tail slots
//   src[n, width, ws + wta]   task-aligned src rows: ws words, wta tail slots
// and its count is, over every task (row r, slot s),
//   popcount(dst[r, :ws] & src[r, s, :ws])
//   + #{non-SENTINEL x in src[r, s, ws:] : x in dst[r, ws:]}   (wtv > 0).
//
// Bound: device-memory bytes. Every src word is read exactly once (the
// stream engine materializes src rows so that the count is one sequential
// stream), 2.1 GB at rmat18: 0.63 ms at 3.35 TB/s.
// Design: one persistent grid (SMs x resident blocks) walks a tile table
// built once per layout (ops/_tiles.py, ops/cuda_stream.py::plan_stream):
// equal tiles of 16-byte src chunks, none across a bucket, so widths 2 and
// 2048 share one grid and the 40 rmat18 buckets cost one launch. Blocks take
// tiles in a fixed stride and write one int64 partial each (no atomics: the
// sum is deterministic). Within a tile, thread t takes chunks t, t + 256, ...
// (coalesced 16 B loads), U of them per step so that U loads are in flight
// per thread (a cp.async ring in shared memory measured slower at rmat18,
// PERF.md). The tile's dst rows are staged in shared memory when they fit
// DST_CAP chunks (every bucket of width >= 32 at rmat18), else read through
// L1. A bitmap
// chunk ANDs with the dst row's matching words; a tail chunk looks its four
// src tail ids up in the sorted dst tail by four binary searches in lockstep,
// unless all four are SENTINEL: the tail classes pad rows, and 82 % of the
// rmat18 tail chunks are padding alone, which then costs no search.
//
// Tail handling: a tile's first chunk may sit inside a row, and a bucket's
// last tile is short. Each tile record carries its first chunk and first row
// as 64-bit offsets; the kernel divides only the tile-relative index (offset
// within the first row + chunk index < row length + tile < 2^31, checked by
// the planner), so the multiply-high division stays exact for buckets of any
// size, and every chunk index past the tile's count is masked.
#include "common.cuh"

namespace {

constexpr int U = 4;                       // chunks per thread per step
constexpr int STEP = gm::BLOCK * U;        // chunks per block per step
constexpr int DST_CAP = 512;               // dst chunks staged per tile (8 KB)
constexpr int BREC = 11;                   // ops/cuda_stream.py::BREC
constexpr int TREC = 4;                    // ops/_tiles.py::TREC

struct Bucket {
  const uint4* dst;
  const uint4* src;
  gm::FastDiv per_row, q_src;
  uint32_t q_dst, q_ws;
  int32_t wtv;
};

__device__ __forceinline__ gm::FastDiv fastdiv_at(const long long* r) {
  return gm::FastDiv{uint32_t(__ldg(r)), uint32_t(__ldg(r + 1)),
                     uint32_t(__ldg(r + 2))};
}

__device__ __forceinline__ Bucket bucket_at(const long long* r) {
  Bucket b;
  b.dst = reinterpret_cast<const uint4*>(__ldg(r));
  b.src = reinterpret_cast<const uint4*>(__ldg(r + 1));
  b.per_row = fastdiv_at(r + 2);
  b.q_src = fastdiv_at(r + 5);
  b.q_dst = uint32_t(__ldg(r + 8));
  b.q_ws = uint32_t(__ldg(r + 9));
  b.wtv = int32_t(__ldg(r + 10));
  return b;
}

// Count of src chunk s, whose tile-relative index is c (the offset of the
// tile's first chunk within its row, plus the chunk's index in the tile);
// drows points at the tile's first dst row (shared or global memory).
__device__ __forceinline__ uint32_t count_chunk(const uint4 s, uint32_t c,
                                                const Bucket& b,
                                                const uint4* drows) {
  const uint32_t r = b.per_row.div(c);                 // row within the tile
  const uint32_t k = c - r * b.per_row.d;              // chunk within the row
  const uint32_t col = k - b.q_src.div(k) * b.q_src.d; // chunk within the task
  const uint4* drow = drows + r * b.q_dst;
  if (col < b.q_ws) {
    const uint4 d = drow[col];
    return __popc(s.x & d.x) + __popc(s.y & d.y) + __popc(s.z & d.z) +
           __popc(s.w & d.w);
  }
  if (b.wtv == 0) return 0;
  const int32_t* dt = reinterpret_cast<const int32_t*>(drow + b.q_ws);
  const int32_t x[4] = {int32_t(s.x), int32_t(s.y), int32_t(s.z),
                        int32_t(s.w)};
  if (x[0] == gm::SENTINEL && x[1] == gm::SENTINEL && x[2] == gm::SENTINEL &&
      x[3] == gm::SENTINEL)
    return 0;                         // tail-class padding: no search
  return gm::count_in_sorted<4>(dt, b.wtv, x);
}

__global__ void __launch_bounds__(gm::BLOCK)
stream_count_kernel(const long long* __restrict__ buckets,
                    const long long* __restrict__ tiles, long long n_tiles,
                    long long* __restrict__ partials) {
  __shared__ uint4 dst_s[DST_CAP];
  const uint32_t tid = threadIdx.x;
  unsigned long long acc = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long* tr = tiles + t * TREC;
    const Bucket b = bucket_at(buckets + __ldg(tr) * BREC);
    const long long chunk0 = __ldg(tr + 1);
    const uint32_t count = uint32_t(__ldg(tr + 2));
    const long long row0 = __ldg(tr + 3);
    const uint32_t off0 = uint32_t(chunk0 - row0 * b.per_row.d);
    const uint32_t n_dst = (b.per_row.div(off0 + count - 1) + 1) * b.q_dst;
    const uint4* dst = b.dst + row0 * b.q_dst;
    const uint4* src = b.src + chunk0;
    const bool staged = n_dst <= DST_CAP;             // uniform in the block
    __syncthreads();               // the last tile's readers of dst_s are done
    if (staged) {
      for (uint32_t i = tid; i < n_dst; i += gm::BLOCK)
        dst_s[i] = __ldg(dst + i);
      __syncthreads();
    }
    const uint4* drows = staged ? dst_s : dst;
    for (uint32_t base = 0; base < count; base += STEP) {
      uint4 s[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const uint32_t k = base + j * gm::BLOCK + tid;
        s[j] = k < count ? __ldg(src + k) : uint4{};
      }
      uint32_t n = 0;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const uint32_t k = base + j * gm::BLOCK + tid;
        if (k < count) n += count_chunk(s[j], off0 + k, b, drows);
      }
      acc += n;
    }
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// Blocks of one full wave of the persistent grid: SMs x resident blocks an
// SM holds; a negative CUDA error code on failure.
extern "C" int gm_stream_count_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_count_kernel, gm::BLOCK, 0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// buckets: int64 [n_buckets, BREC] records; tiles: int64 [n_tiles, TREC]
// (ops/cuda_stream.py::plan_stream). Every src and dst row is 16-byte
// aligned, with ws, wtv, wta multiples of 4. partials: int64 [n_blocks].
extern "C" int gm_stream_count(const void* buckets, const void* tiles,
                               int64_t n_tiles, void* partials,
                               int64_t n_blocks, void* stream) {
  stream_count_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(buckets),
      static_cast<const long long*>(tiles), n_tiles,
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
