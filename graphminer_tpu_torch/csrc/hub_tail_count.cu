// Kernel E — hub-core tail count (TriangleEngine's gather groups).
//
// Replaces the XLA code graphminer_tpu/ops/hubcore.py::_gather_rows,
// _chunk_counts and _tail_partials (gathers, AND + population_count and a
// broadcast compare; torch has no popcount). For one bucket group (wa, wb)
// of tail tasks it counts
//   sum_i popcount(src_rows[su[i], :words] & dst_rows[dv[i], :words])
//       + |{x in src_rows[su[i], words:words+wa] : x != SENTINEL}
//          ∩ dst_rows[dv[i], words:words+wb]|
// where the wrapper has already clamped wa and wb to the stored tail width
// (a class can be wider than wt_pad; the JAX slice table[:, :words+wa]
// clamps the same way). Tails are sorted ascending and SENTINEL padded with
// no repeated id. A task whose su or dv lies outside its table (the SENTINEL
// padding of pack_groups) gives 0.
//
// Bound: bytes — each table row that a real task names, read once as far as
// the widest prefix its groups read (words + clamped class width), and the
// real task ids: 118,750,280 B at rmat18, 0.035 ms at 3.35 TB/s
// (scripts/prof_breakdown.py::tail_bytes).
// Tasks are sorted by dst, so neighbouring tasks share dst rows in L1/L2.
// Design: one warp per task, grid-stride over the tasks. The bitmap part is
// read in 16-byte vectors, lane l taking words 4l..4l+3, so a 128-word row is
// one coalesced 512 B request per side. For the tail part lane j takes src
// tail slot j and binary-searches the sorted dst tail (gm::in_sorted) in
// place of the wa x wb broadcast compare.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(gm::BLOCK)
hub_tail_count_kernel(const int32_t* __restrict__ src_rows, int32_t ns,
                      const int32_t* __restrict__ dst_rows, int32_t nd,
                      int32_t row_w, int32_t words, int32_t wa, int32_t wb,
                      const int32_t* __restrict__ su,
                      const int32_t* __restrict__ dv, int64_t n,
                      long long* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  const int chunks = words >> 2;
  unsigned long long acc = 0;
  for (int64_t i = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       i < n; i += n_warps) {
    const int32_t a = __ldg(su + i), b = __ldg(dv + i);
    if (a < 0 || a >= ns || b < 0 || b >= nd) continue;      // warp-uniform
    const int32_t* ra = src_rows + int64_t(a) * row_w;
    const int32_t* rb = dst_rows + int64_t(b) * row_w;
    const uint4* va = reinterpret_cast<const uint4*>(ra);
    const uint4* vb = reinterpret_cast<const uint4*>(rb);
    for (int c = lane; c < chunks; c += 32) {
      const uint4 x = __ldg(va + c), y = __ldg(vb + c);
      acc += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
             __popc(x.w & y.w);
    }
    for (int j = lane; j < wa; j += 32) {
      const int32_t x = __ldg(ra + words + j);
      if (x != gm::SENTINEL) acc += gm::in_sorted(rb + words, wb, x);
    }
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// src_rows: int32 [ns, row_w]; dst_rows: int32 [nd, row_w]; su, dv: int32
// [n]; words % 4 == 0 and row_w % 4 == 0 (16-byte rows); wa, wb <= row_w -
// words, wa == 0 when the group is popcount-only; partials: int64 [n_blocks].
extern "C" int gm_hub_tail_count(const void* src_rows, int64_t ns,
                                 const void* dst_rows, int64_t nd,
                                 int64_t row_w, int64_t words, int64_t wa,
                                 int64_t wb, const void* su, const void* dv,
                                 int64_t n, void* partials, int64_t n_blocks,
                                 void* stream) {
  hub_tail_count_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_rows), int32_t(ns),
      static_cast<const int32_t*>(dst_rows), int32_t(nd), int32_t(row_w),
      int32_t(words), int32_t(wa), int32_t(wb),
      static_cast<const int32_t*>(su), static_cast<const int32_t*>(dv), n,
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
