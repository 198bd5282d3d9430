// Kernel R — o = 2 * x on int32, the smallest build-and-launch check.
//
// Port of the Pallas kernel scripts/repro_mosaic_hang.py::kernel (one
// [8, 128] int32 block, o_ref[:] = x_ref[:] * 2). The product wraps modulo
// 2^32 as int32 arithmetic does in torch and JAX (computed unsigned here, so
// the overflow is defined).
//
// Bound: bytes — 4 read and 4 written per element; at [8, 128] the launch
// itself is the cost.
// Design: one thread per element, grid-stride.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(gm::BLOCK)
times_two_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                 int64_t n) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    o[i] = int32_t(uint32_t(__ldg(x + i)) * 2u);
}

}  // namespace

// x, o: int32 [n].
extern "C" int gm_times_two(const void* x, void* o, int64_t n,
                            int64_t n_blocks, void* stream) {
  times_two_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(o), n);
  return int(cudaGetLastError());
}
