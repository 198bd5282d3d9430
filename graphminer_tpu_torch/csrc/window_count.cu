// Kernels m3 and m3b — windowed row reads with AND + popcount.
//
// Port of the two Pallas kernels of scripts/prof_window.py: _kernel (m3, one
// window row per step) and _kernel8 (m3b, 8 window rows per step). Per chunk
// c of cap dst-sorted tasks:
//   out[c] = sum_{t < cap} popcount(src[c, t, :] & table[s_c + lidx[c, t], :])
// with s_c = starts[c] clamped to [0, nd - span] (as jax.lax.dynamic_slice
// clamps it); a local index outside [0, span) adds nothing.
//
// Bound: bytes — the src stream (4*w bytes per task, 411 MB at the script's
// defaults), lidx and the table rows the windows cover, each read once.
// Design: the TPU kernel DMAs the chunk's span-row window into VMEM and reads
// task rows from there. At the defaults the window is span * w * 4 = 512 KB,
// more than a block's 227 KB of shared memory, so the window's COLUMNS are
// split across blocks: block (s, c) stages rows [s_c, s_c + span) x columns
// [s*wb, (s+1)*wb) in shared memory (wb = w when the whole window fits, as at
// w = 8; 16 at the defaults, 64 KB, so three blocks share an SM) and counts
// its column slice of every task of chunk c. Splitting keeps the design's
// point — random row reads hit on-chip memory, never device memory — where
// reading the rows through L2 would also have worked (the 29 MB table fits
// the 50 MB L2) but puts every random read on the L2 crossbar. Threads take
// (task, 16-byte chunk) pairs, so a task's slice of the src stream is read
// coalesced. ROWS is the rows read per step per thread: m3 issues one src
// load before its popcount, m3b eight, which puts 8x the bytes in flight.
// One int64 partial per block; the wrapper sums the column slices of a chunk.
#include "common.cuh"

namespace {

template <int ROWS>
__global__ void __launch_bounds__(gm::BLOCK)
window_count_kernel(const int32_t* __restrict__ src,
                    const int32_t* __restrict__ table, int32_t nd,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ lidx, int32_t cap, int32_t w,
                    int32_t span, int32_t wb, long long* __restrict__ partials) {
  extern __shared__ uint4 win[];                  // [span, wb / 4]
  const int64_t c = blockIdx.y;
  const int32_t col0 = int32_t(blockIdx.x) * wb;
  const int cpr = wb >> 2;                        // 16-byte chunks per row
  const int32_t st = min(max(__ldg(starts + c), 0), nd - span);
  const int64_t row_vecs = w >> 2;
  const uint4* tab = reinterpret_cast<const uint4*>(table) + (col0 >> 2);
  for (int e = threadIdx.x; e < span * cpr; e += blockDim.x) {
    const int r = e / cpr;
    win[e] = __ldg(tab + (int64_t(st) + r) * row_vecs + (e - r * cpr));
  }
  __syncthreads();

  const int per_pass = gm::BLOCK / cpr;           // tasks read side by side
  const int slot = threadIdx.x / cpr, q = threadIdx.x - slot * cpr;
  unsigned long long acc = 0;
  if (slot < per_pass) {
    const int32_t* li = lidx + c * cap;
    const uint4* sc = reinterpret_cast<const uint4*>(src + c * cap * w) +
                      (col0 >> 2) + q;
    for (int32_t t0 = slot; t0 < cap; t0 += per_pass * ROWS) {
      int32_t l[ROWS];
      uint4 s[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int32_t t = t0 + j * per_pass;
        const bool ok = t < cap;
        l[j] = ok ? __ldg(li + t) : -1;
        s[j] = ok ? __ldg(sc + int64_t(t) * row_vecs) : uint4{};
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (l[j] < 0 || l[j] >= span) continue;
        const uint4 r = win[l[j] * cpr + q];
        acc += __popc(s[j].x & r.x) + __popc(s[j].y & r.y) +
               __popc(s[j].z & r.z) + __popc(s[j].w & r.w);
      }
    }
  }
  gm::block_sum_store(acc, partials + c * gridDim.x);
}

template <int ROWS>
int launch(const void* src, const void* table, int64_t nd, const void* starts,
           const void* lidx, int64_t nck, int64_t cap, int64_t w, int64_t span,
           int64_t wb, void* partials, cudaStream_t st) {
  const size_t smem = size_t(span) * size_t(wb) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      window_count_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned(w / wb), unsigned(nck));
  window_count_kernel<ROWS><<<grid, gm::BLOCK, smem, st>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(table),
      int32_t(nd), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(lidx), int32_t(cap), int32_t(w),
      int32_t(span), int32_t(wb), static_cast<long long*>(partials));
  return int(cudaGetLastError());
}

}  // namespace

// src: int32 [nck, cap, w]; table: int32 [nd, w]; starts: int32 [nck];
// lidx: int32 [nck, cap]; span <= nd; wb divides w, wb % 4 == 0, and
// span * wb * 4 bytes fit a block's shared memory; rows_per_step in {1, 8};
// partials: int64 [nck, w / wb]. Returns cudaErrorInvalidValue for another
// rows_per_step.
extern "C" int gm_window_count(const void* src, const void* table, int64_t nd,
                               const void* starts, const void* lidx,
                               int64_t nck, int64_t cap, int64_t w,
                               int64_t span, int64_t wb, int64_t rows_per_step,
                               void* partials, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_step == 1)
    return launch<1>(src, table, nd, starts, lidx, nck, cap, w, span, wb,
                     partials, st);
  if (rows_per_step == 8)
    return launch<8>(src, table, nd, starts, lidx, nck, cap, w, span, wb,
                     partials, st);
  return int(cudaErrorInvalidValue);
}
