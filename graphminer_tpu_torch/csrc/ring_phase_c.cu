// Kernel B — ring phase C and the phase-T bitmap pass.
//
// Port of the Pallas kernel graphminer_tpu/ops/pallas_ring.py::_kernel
// (and of its XLA twin ops/ring.py::_cbucket_partials). Given a row table
// table[n_table, words], src bitmaps src[n, words] and slots dloc[n, wc],
// it counts
//   sum_r sum_s popcount(src[r] & table[dloc[r, s]])
// where a slot outside [0, n_table) (SENTINEL padding) gives 0. Phase C
// passes the 4096-row core table; the phase-T bitmap pass passes the dense
// bm_table, so the row id is bounds-checked against whichever table it is.
//
// Bound: reads of table rows, one 4*words-byte row per task, at random
// rows. The TPU kernel kept the 2 MB core table resident in VMEM; no SM
// holds 2 MB of shared memory, but the H100's 50 MB L2 does, so the table
// rows come from L2 after their first touch.
// Design: one warp per src row (grid-stride over rows). The src row lives in
// registers, K words per lane (words <= 32*K; K = 0 re-reads it through L1
// for wider cores). The lanes load 32 slot ids at once and broadcast them
// with shuffles; each valid slot's table row is read by the whole warp as
// one coalesced line. No index chunking: the TPU's SMEM limit on
// scalar-prefetched ids (pallas_ring.py:79-106) has no counterpart here.
#include "common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(gm::BLOCK)
ring_phase_c_kernel(const uint32_t* __restrict__ table, int32_t n_table,
                    const uint32_t* __restrict__ src,
                    const int32_t* __restrict__ dloc, int64_t n,
                    int32_t words, int32_t wc,
                    long long* __restrict__ partials) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  unsigned long long acc = 0;
  for (int64_t r = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       r < n; r += n_warps) {
    const uint32_t* srow = src + r * words;
    uint32_t sw[K > 0 ? K : 1];
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int w = lane + 32 * k;
        sw[k] = w < words ? __ldg(srow + w) : 0u;
      }
    }
    const int32_t* drow = dloc + r * wc;
    for (int32_t s0 = 0; s0 < wc; s0 += 32) {
      const int32_t mine = s0 + lane < wc ? __ldg(drow + s0 + lane) : -1;
      const int32_t cnt = min(32, wc - s0);
      for (int32_t j = 0; j < cnt; ++j) {
        const int32_t idx = __shfl_sync(gm::FULL_MASK, mine, j);
        if (idx < 0 || idx >= n_table) continue;          // warp-uniform
        const uint32_t* trow = table + int64_t(idx) * words;
        if constexpr (K > 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int w = lane + 32 * k;
            if (w < words) acc += __popc(sw[k] & __ldg(trow + w));
          }
        } else {
          for (int w = lane; w < words; w += 32)
            acc += __popc(__ldg(srow + w) & __ldg(trow + w));
        }
      }
    }
  }
  gm::block_sum_store(acc, partials);
}

template <int K>
void launch(const void* table, int64_t n_table, const void* src,
            const void* dloc, int64_t n, int64_t words, int64_t wc,
            void* partials, int64_t n_blocks, cudaStream_t stream) {
  ring_phase_c_kernel<K><<<unsigned(n_blocks), gm::BLOCK, 0, stream>>>(
      static_cast<const uint32_t*>(table), int32_t(n_table),
      static_cast<const uint32_t*>(src), static_cast<const int32_t*>(dloc),
      n, int32_t(words), int32_t(wc), static_cast<long long*>(partials));
}

}  // namespace

// table: int32 [n_table, words]; src: int32 [n, words]; dloc: int32 [n, wc];
// partials: int64 [n_blocks].
extern "C" int gm_ring_phase_c(const void* table, int64_t n_table,
                               const void* src, const void* dloc, int64_t n,
                               int64_t words, int64_t wc, void* partials,
                               int64_t n_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words <= 32)
    launch<1>(table, n_table, src, dloc, n, words, wc, partials, n_blocks, st);
  else if (words <= 64)
    launch<2>(table, n_table, src, dloc, n, words, wc, partials, n_blocks, st);
  else if (words <= 128)
    launch<4>(table, n_table, src, dloc, n, words, wc, partials, n_blocks, st);
  else
    launch<0>(table, n_table, src, dloc, n, words, wc, partials, n_blocks, st);
  return int(cudaGetLastError());
}
