// Kernel E — hub-core tail count, one launch over every tail group.
//
// Replaces the XLA code graphminer_tpu/ops/hubcore.py::_gather_rows,
// _chunk_counts and _tail_partials (gathers, AND + population_count and a
// broadcast compare; torch has no popcount). For one bucket group (wa, wb)
// of tail tasks it counts
//   sum_i popcount(src_rows[su[i], :words] & dst_rows[dv[i], :words])
//       + |{x in src_rows[su[i], words:words+wa] : x != SENTINEL}
//          ∩ dst_rows[dv[i], words:words+wb]|
// where the planner has already clamped wa and wb to the stored tail width
// (a class can be wider than wt_pad; the JAX slice table[:, :words+wa]
// clamps the same way). Tails are sorted ascending and SENTINEL padded with
// no repeated id. A task whose su or dv lies outside its table (the SENTINEL
// padding of pack_groups) gives 0.
//
// Bound: bytes — each table row that a real task names, read once as far as
// the widest prefix its groups read (words + clamped class width), and the
// real task ids: 118,750,280 B at rmat18, 0.035 ms at 3.35 TB/s
// (scripts/prof_breakdown.py::tail_bytes). The first design, one warp per
// task with one binary search per lane, was bound by latency: one task in
// flight a warp and dependent search chains.
// Design: one persistent grid walks a tile table built once per engine
// (ops/_tiles.py, ops/cuda_hubcore.py::plan_tail_count): tiles of 256
// tasks, none across a group, so the 5 rmat18 groups cost one launch. A
// group of G = 4 lanes takes one task, so a warp holds 8 tasks and a block
// 64 consecutive tasks a round (4 lanes beat 8 and 2 at rmat18). The bitmap
// part is read in 16-byte vectors, lane l of the group taking chunks l,
// l + G, ... (8 chunks a side for a 128-word row). Tasks are
// sorted by dst, so the tasks of a warp mostly name one dst row: their
// loads of it are one request, and the block's next rounds find it in L1.
// For the tail, each lane takes K of the task's src tail ids
// (K = ceil(wa / G), at most 8 a search) and searches them in the dst tail
// in lockstep (gm::count_in_sorted), skipping the search when all K are
// SENTINEL padding.
// What bounds it now: the src rows (95 MB at rmat18, more than L2 holds)
// are read once a task, about 5.8 times each, and the tail searches'
// dependent loads.
#include "common.cuh"

namespace {

constexpr int WARPS = gm::BLOCK / 32;
constexpr int G = 4;                       // lanes a task
constexpr int BREC = 4;                    // ops/cuda_hubcore.py::TAIL_BREC
constexpr int TREC = 4;                    // ops/_tiles.py::TREC

// The tail part of one task for the lane at gl of its group: K src tail ids
// a lane at a time, searched in the sorted dst tail tb[0:wb] in lockstep.
template <int K>
__device__ __forceinline__ uint32_t tail_hits(const int32_t* ta, int32_t wa,
                                              const int32_t* tb, int32_t wb,
                                              int gl) {
  uint32_t hits = 0;
  for (int j0 = 0; j0 < wa; j0 += K * G) {
    int32_t x[K];
    bool any = false;                  // ids other than SENTINEL padding
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int j = j0 + gl + u * G;
      x[u] = j < wa ? __ldg(ta + j) : gm::SENTINEL;
      any |= x[u] != gm::SENTINEL;
    }
    if (any) hits += gm::count_in_sorted<K>(tb, wb, x);
  }
  return hits;
}

__global__ void __launch_bounds__(gm::BLOCK)
hub_tail_count_kernel(const int32_t* __restrict__ src_rows, int32_t ns,
                      const int32_t* __restrict__ dst_rows, int32_t nd,
                      int32_t row_w, int32_t words,
                      const long long* __restrict__ buckets,
                      const long long* __restrict__ tiles, long long n_tiles,
                      long long* __restrict__ partials) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G;
  const int chunks = words >> 2;
  unsigned long long acc = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long* tr = tiles + t * TREC;
    const long long* br = buckets + __ldg(tr) * BREC;
    const long long first = __ldg(tr + 1);
    const int32_t count = int32_t(__ldg(tr + 2));
    const int32_t* su = reinterpret_cast<const int32_t*>(__ldg(br)) + first;
    const int32_t* dv = reinterpret_cast<const int32_t*>(__ldg(br + 1)) +
                        first;
    const int32_t wa = int32_t(__ldg(br + 2)), wb = int32_t(__ldg(br + 3));
    const int k = (wa + G - 1) / G;                  // src tail ids a lane
    for (int32_t i = warp * (32 / G) + grp; i - grp < count;
         i += WARPS * (32 / G)) {
      const int32_t a = i < count ? __ldg(su + i) : -1;
      const int32_t b = i < count ? __ldg(dv + i) : -1;
      if (a < 0 || a >= ns || b < 0 || b >= nd) continue;   // group-uniform
      const int32_t* ra = src_rows + int64_t(a) * row_w;
      const int32_t* rb = dst_rows + int64_t(b) * row_w;
      const uint4* va = reinterpret_cast<const uint4*>(ra);
      const uint4* vb = reinterpret_cast<const uint4*>(rb);
      uint32_t n = 0;
#pragma unroll 4
      for (int c = gl; c < chunks; c += G) {
        const uint4 x = __ldg(va + c), y = __ldg(vb + c);
        n += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
      }
      if (k == 0) {
      } else if (k == 1) {
        n += tail_hits<1>(ra + words, wa, rb + words, wb, gl);
      } else if (k == 2) {
        n += tail_hits<2>(ra + words, wa, rb + words, wb, gl);
      } else if (k <= 4) {
        n += tail_hits<4>(ra + words, wa, rb + words, wb, gl);
      } else if (k <= 6) {
        n += tail_hits<6>(ra + words, wa, rb + words, wb, gl);
      } else {
        n += tail_hits<8>(ra + words, wa, rb + words, wb, gl);
      }
      acc += n;
    }
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// Blocks of one full wave of the persistent grid: SMs x resident blocks;
// a negative CUDA error on failure.
extern "C" int gm_hub_tail_count_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hub_tail_count_kernel, gm::BLOCK, 0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// src_rows: int32 [ns, row_w]; dst_rows: int32 [nd, row_w]; words % 4 == 0
// and row_w % 4 == 0 (16-byte rows); buckets: int64 [n_groups, BREC] (su,
// dv, wa, wb with wa, wb <= row_w - words, both 0 when the group is
// popcount-only); tiles: int64 [n_tiles, TREC]
// (ops/cuda_hubcore.py::plan_tail_count); partials: int64 [n_blocks].
extern "C" int gm_hub_tail_count(const void* src_rows, int64_t ns,
                                 const void* dst_rows, int64_t nd,
                                 int64_t row_w, int64_t words,
                                 const void* buckets, const void* tiles,
                                 int64_t n_tiles, void* partials,
                                 int64_t n_blocks, void* stream) {
  hub_tail_count_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_rows), int32_t(ns),
      static_cast<const int32_t*>(dst_rows), int32_t(nd), int32_t(row_w),
      int32_t(words), static_cast<const long long*>(buckets),
      static_cast<const long long*>(tiles), n_tiles,
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
