// Kernel L — the k-clique engine's lo-task popcount, one launch a count.
//
// Replaces the XLA function graphminer_tpu/ops/cliquek.py::_lo_popcount
// (gathers, ANDs and population_count under lax.map; torch has no
// popcount). For tasks cols int32 [n, nrow] (2 <= nrow <= 8) it counts
//
//   sum_t popcount(bm[a_t] & bm[b_t] & core[c_t,2] & ... & core[c_t,nrow-1])
//
// over bm int32 [v, words] and core int32 [c, words], words read as uint32.
// A task adds 0 unless a and b lie in [0, v) and every core column in
// [0, c): that covers the SENTINEL padding (0x7FFFFFFF passes JAX's a >= 0
// test and is zeroed there by the core-column range checks). Where JAX
// clamps an out-of-range bm index, or reads bm[0] for a negative b, this
// kernel adds 0 (an intended divergence on inputs no engine makes).
//
// Bound: bytes — the task columns, and each table row that a valid task
// names read once, at 3.35 TB/s.
// Design: the idiom of kernels A, C and E. A persistent grid of one wave
// (gm_lo_popcount_blocks) grid-strides over the tasks; a group of G = 8
// lanes takes one task (a block holds 32 tasks a round), reads its ids
// (one broadcast load each) and checks them, then each lane ANDs 16-byte
// chunks q, q + G, ... of the nrow rows and counts them with __popc (4
// chunks a lane at 128 words). Each thread keeps a 64-bit sum and each
// block writes one int64 partial (gm::block_sum_store); the wrapper's int64
// sum of the partials is the lo total.
#include "common.cuh"

namespace {

constexpr int G = 8;                       // lanes a task
constexpr int MAX_ROWS = 8;

__device__ __forceinline__ void and4(uint4& y, const uint4 z) {
  y.x &= z.x;
  y.y &= z.y;
  y.z &= z.z;
  y.w &= z.w;
}

__global__ void __launch_bounds__(gm::BLOCK)
lo_popcount_kernel(const int32_t* __restrict__ bm, int32_t v,
                   const int32_t* __restrict__ core, int32_t c,
                   int32_t words, const int32_t* __restrict__ cols,
                   int64_t n, int32_t nrow, long long* __restrict__ partials) {
  const int gl = threadIdx.x % G;
  const int chunks = words >> 2;
  const int64_t step = int64_t(gridDim.x) * (gm::BLOCK / G);
  unsigned long long acc = 0;
  for (int64_t t = int64_t(blockIdx.x) * (gm::BLOCK / G) + threadIdx.x / G;
       t < n; t += step) {
    const int32_t* ct = cols + t * nrow;
    const int32_t a = __ldg(ct), b = __ldg(ct + 1);
    bool ok = a >= 0 && a < v && b >= 0 && b < v;
    const uint4* row[MAX_ROWS];
    row[0] = reinterpret_cast<const uint4*>(bm + int64_t(a) * words);
    row[1] = reinterpret_cast<const uint4*>(bm + int64_t(b) * words);
#pragma unroll
    for (int j = 2; j < MAX_ROWS; ++j) {
      if (j < nrow) {
        const int32_t x = __ldg(ct + j);
        ok = ok && x >= 0 && x < c;
        row[j] = reinterpret_cast<const uint4*>(core + int64_t(x) * words);
      }
    }
    if (!ok) continue;                   // the same for every lane of a task
    uint32_t cnt = 0;
    for (int q = gl; q < chunks; q += G) {
      uint4 y = __ldg(row[0] + q);
      and4(y, __ldg(row[1] + q));
#pragma unroll
      for (int j = 2; j < MAX_ROWS; ++j)
        if (j < nrow) and4(y, __ldg(row[j] + q));
      cnt += __popc(y.x) + __popc(y.y) + __popc(y.z) + __popc(y.w);
    }
    acc += cnt;
  }
  gm::block_sum_store(acc, partials);
}

}  // namespace

// Blocks of one full wave of the persistent grid: SMs x resident blocks;
// a negative CUDA error on failure.
extern "C" int gm_lo_popcount_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lo_popcount_kernel, gm::BLOCK, 0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// bm: int32 [v, words]; core: int32 [c, words]; words % 4 == 0 and both
// tables 16-byte aligned; cols: int32 [n, nrow], 2 <= nrow <= 8, n >= 1;
// partials: int64 [n_blocks]. Returns a cudaError_t.
extern "C" int gm_lo_popcount(const void* bm, int64_t v, const void* core,
                              int64_t c, int64_t words, const void* cols,
                              int64_t n, int64_t nrow, void* partials,
                              int64_t n_blocks, void* stream) {
  lo_popcount_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bm), int32_t(v),
      static_cast<const int32_t*>(core), int32_t(c), int32_t(words),
      static_cast<const int32_t*>(cols), n, int32_t(nrow),
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
