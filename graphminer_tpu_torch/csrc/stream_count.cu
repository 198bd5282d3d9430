// Kernel A — stream bucket count.
//
// Replaces graphminer_tpu/ops/stream.py::_bucket_counts_fused (an XLA
// broadcast-reduce; torch has no popcount op). One bucket holds
//   dst[n, ws + wtv]          dst rows: ws bitmap words, wtv sorted tail slots
//   src[n, width, ws + wta]   task-aligned src rows: ws words, wta tail slots
// and its count is, over every task (row r, slot s),
//   popcount(dst[r, :ws] & src[r, s, :ws])
//   + #{non-SENTINEL x in src[r, s, ws:] : x in dst[r, ws:]}   (wtv > 0).
//
// Bound: device-memory bytes. Every src word is read exactly once, so the
// kernel is one sequential stream over the bucket (the stream engine
// materializes src rows precisely to make the count a pure stream).
// Design: the bucket is one flat array of 16-byte chunks; each thread takes
// chunks in a grid-stride loop (neighbouring threads, neighbouring chunks:
// coalesced 16 B loads). A bitmap chunk ANDs with the dst row's matching
// words, which all `width` tasks of a row share, so they hit L1/L2. A tail
// chunk looks each src tail id up in the sorted dst tail by binary search.
// Chunk -> (row, column) uses multiply-high division, not a hardware divide.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(gm::BLOCK)
stream_bucket_count_kernel(const uint4* __restrict__ dst,
                           const uint4* __restrict__ src,
                           uint32_t n_chunks, gm::FastDiv per_row,
                           gm::FastDiv per_task, uint32_t q_dst,
                           uint32_t q_ws, int32_t wtv,
                           long long* __restrict__ partials) {
  unsigned long long acc = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t c = blockIdx.x * blockDim.x + threadIdx.x; c < n_chunks;
       c += stride) {
    const uint32_t r = per_row.div(c);
    const uint32_t k = c - r * per_row.d;              // chunk within the row
    const uint32_t col = k - per_task.div(k) * per_task.d;
    const uint4 s = __ldg(src + c);
    const uint4* drow = dst + uint64_t(r) * q_dst;
    if (col < q_ws) {
      const uint4 d = __ldg(drow + col);
      acc += __popc(s.x & d.x) + __popc(s.y & d.y) + __popc(s.z & d.z) +
             __popc(s.w & d.w);
    } else if (wtv > 0) {
      const int32_t* dt = reinterpret_cast<const int32_t*>(drow + q_ws);
      const int32_t v[4] = {int32_t(s.x), int32_t(s.y), int32_t(s.z),
                            int32_t(s.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc += (v[j] != gm::SENTINEL && gm::in_sorted(dt, wtv, v[j]));
    }
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// dst: int32 [n_rows, ws + wtv]; src: int32 [n_rows, width, ws + wta]; both
// 16-byte aligned with ws, wtv, wta multiples of 4, and
// n_rows * width * (ws + wta) / 4 < 2^31. partials: int64 [n_blocks].
extern "C" int gm_stream_bucket_count(const void* dst, const void* src,
                                      int64_t n_rows, int64_t width,
                                      int64_t ws, int64_t wtv, int64_t wta,
                                      void* partials, int64_t n_blocks,
                                      void* stream) {
  const uint32_t q_src = uint32_t((ws + wta) / 4);
  const uint32_t n_chunks = uint32_t(n_rows * width * q_src);
  stream_bucket_count_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dst), static_cast<const uint4*>(src),
      n_chunks, gm::FastDiv::make(uint32_t(width) * q_src),
      gm::FastDiv::make(q_src), uint32_t((ws + wtv) / 4), uint32_t(ws / 4),
      int32_t(wtv), static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
