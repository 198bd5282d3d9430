// Kernel C — ring tail pairs.
//
// Replaces graphminer_tpu/ops/ring.py::_tail_pairs_partials (an XLA
// gather + broadcast compare). For every task i it takes the rows
// ta[sa[i]] (width wa) and tb[sb[i]] (width wb) of two per-class tail
// tables — each sorted ascending, SENTINEL padded — and counts the
// non-SENTINEL ids they share. A slot outside its table's rows gives 0.
//
// Bound: the dependent loads of the binary searches into tb rows (L1/L2
// latency), then the ta row reads.
// Design: one thread per (task, ta slot), grid-stride over the flat index,
// so neighbouring threads read neighbouring ids of one ta row (coalesced).
// A thread whose id is SENTINEL stops there; the others binary-search the
// tb row. ring.py:364-368 found a search slower than the broadcast compare
// on the TPU (lane-dimension gathers serialize in Mosaic); on the GPU each
// thread searches its own row, so the compare work drops from wa*wb to
// wa*log2(wb) per task.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(gm::BLOCK)
ring_tail_pairs_kernel(const int32_t* __restrict__ ta, int32_t na,
                       const int32_t* __restrict__ tb, int32_t nb,
                       int32_t wb, const int32_t* __restrict__ sa,
                       const int32_t* __restrict__ sb, uint32_t n_elems,
                       gm::FastDiv wa, long long* __restrict__ partials) {
  unsigned long long acc = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < n_elems;
       e += stride) {
    const uint32_t i = wa.div(e);
    const uint32_t j = e - i * wa.d;
    const int32_t ia = __ldg(sa + i), ib = __ldg(sb + i);
    if (ia < 0 || ia >= na || ib < 0 || ib >= nb) continue;
    const int32_t x = __ldg(ta + int64_t(ia) * wa.d + j);
    if (x == gm::SENTINEL) continue;
    acc += gm::in_sorted(tb + int64_t(ib) * wb, wb, x);
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// ta: int32 [na, wa]; tb: int32 [nb, wb]; sa, sb: int32 [n];
// n * wa < 2^31; partials: int64 [n_blocks].
extern "C" int gm_ring_tail_pairs(const void* ta, int64_t na, int64_t wa,
                                  const void* tb, int64_t nb, int64_t wb,
                                  const void* sa, const void* sb, int64_t n,
                                  void* partials, int64_t n_blocks,
                                  void* stream) {
  ring_tail_pairs_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ta), int32_t(na),
      static_cast<const int32_t*>(tb), int32_t(nb), int32_t(wb),
      static_cast<const int32_t*>(sa), static_cast<const int32_t*>(sb),
      uint32_t(n * wa), gm::FastDiv::make(uint32_t(wa)),
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
