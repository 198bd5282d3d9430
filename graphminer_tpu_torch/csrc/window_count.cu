// Kernels m3 and m3b — windowed row reads with AND + popcount.
//
// Port of the two Pallas kernels of scripts/prof_window.py: _kernel (m3, one
// window row per step) and _kernel8 (m3b, 8 window rows per step). Per chunk
// c of cap dst-sorted tasks:
//   out[c] = sum_{t < cap} popcount(src[c, t, :] & table[s_c + lidx[c, t], :])
// with s_c = starts[c] clamped to [0, nd - span] (as jax.lax.dynamic_slice
// clamps it); a local index outside [0, span) adds nothing. ROWS is the task
// rows a thread takes per step (m3 1, m3b 8).
//
// Bound: bytes — the src stream (4*w bytes per task, 411 MB at the script's
// defaults), lidx and the table rows the windows cover, each read once.
//
// One launch a call that finishes its own int32 result: block sums are
// added into a per-stream workspace with atomics and the last block
// converts them (gm::finish_int32).
//
// The window's rows are read through L2 (the 29 MB table at the defaults
// fits the 50 MB L2). The TPU kernel DMAs the chunk's span-row window into
// VMEM and reads task rows from there; here the window stays in L2, and the
// tasks being dst-sorted, the tasks that share a window row meet in L1. A
// persistent grid of one wave: block b takes tasks [n*b/nb, n*(b+1)/nb) of
// the n = nck * cap tasks, chunk by chunk. A lane group of w / 4 lanes reads
// a task's whole src row (a warp a task at w = 128) with 16-byte streaming
// loads that do not stay in L2, and its window row through L1. A thread
// issues the src loads of its ROWS task rows a step before it reads their
// window rows; with 8 blocks an SM, 2048 threads keep 32 KB (ROWS 1) to
// 256 KB (ROWS 8) of src in flight an SM, above the ~18 KB that covers HBM
// latency.
//
// Shared memory: none for the window or the stream, only the block sum's
// eight int64 warp sums and the finish flag, so threads (8 blocks of 256
// an SM) and not shared memory set the blocks an SM holds.
//
// A design that staged both in shared memory was built and timed against
// this one on the H100 (PERF.md): column slices of the window in two
// buffers, the src stream through a three-stage TMA ring filled by a
// producer warp, one block an SM. On the device alone the two were tied
// within run-to-run noise: this kernel 0.8-5.5 % ahead in most readings,
// behind in one of m3b's. This one is kept as the simpler (no tensor maps,
// no mbarriers, no shared-memory budget).
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t and_popc(const uint4& a, const uint4& b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

__device__ __forceinline__ int32_t clamp_start(const int32_t* starts,
                                               int64_t c, int32_t nd,
                                               int32_t span) {
  return min(max(__ldg(starts + c), 0), nd - span);
}

template <int ROWS>
__global__ void __launch_bounds__(gm::BLOCK)
window_count_kernel(const int32_t* __restrict__ src,
                    const int32_t* __restrict__ table, int32_t nd,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ lidx, int64_t nck,
                    int32_t cap, int32_t w, int32_t span,
                    unsigned long long* __restrict__ ws,
                    int32_t* __restrict__ out) {
  const int cpr = w >> 2;                         // 16-byte chunks a row
  const int per_pass = gm::BLOCK / cpr;           // tasks read side by side
  const int slot = threadIdx.x / cpr, q = threadIdx.x - slot * cpr;
  const int64_t n = nck * cap;
  const int64_t lo = n * blockIdx.x / gridDim.x;
  const int64_t hi = n * (blockIdx.x + 1) / gridDim.x;
  for (int64_t c = lo / cap; c < nck && c * cap < hi; ++c) {
    const int64_t base = c * cap;
    const int32_t t_lo = int32_t(lo > base ? lo - base : 0);
    const int32_t t_hi = int32_t(hi < base + cap ? hi - base : cap);
    const uint4* wv = reinterpret_cast<const uint4*>(table) +
                      int64_t(clamp_start(starts, c, nd, span)) * cpr + q;
    const uint4* sv = reinterpret_cast<const uint4*>(src) + base * cpr + q;
    const int32_t* li = lidx + base;
    unsigned long long acc = 0;
    if (slot < per_pass) {
      for (int32_t t0 = t_lo + slot; t0 < t_hi; t0 += per_pass * ROWS) {
        int32_t l[ROWS];
        uint4 x[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const int32_t t = t0 + j * per_pass;
          const bool ok = t < t_hi;
          l[j] = ok ? __ldg(li + t) : -1;
          x[j] = ok ? __ldcs(sv + int64_t(t) * cpr) : uint4{};
        }
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          if (l[j] >= 0 && l[j] < span)
            acc += and_popc(x[j], __ldg(wv + int64_t(l[j]) * cpr));
      }
    }
    gm::block_sum_add(acc, ws + 1 + c);
  }
  gm::finish_int32(ws, nck, out);
}

template <int ROWS>
void* window_kernel() {
  return reinterpret_cast<void*>(window_count_kernel<ROWS>);
}

int occupancy(const void* k) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, gm::BLOCK,
                                                      0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

int launched(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();      // clear it: it is returned
  return int(e);
}

}  // namespace

// Blocks of one full wave of the kernel: SMs x resident blocks, or a
// negative CUDA error code.
extern "C" int gm_window_count_blocks(int64_t rows_per_step) {
  void* k = rows_per_step == 1 ? window_kernel<1>()
            : rows_per_step == 8 ? window_kernel<8>() : nullptr;
  if (k == nullptr) return -int(cudaErrorInvalidValue);
  return occupancy(k);
}

// src: int32 [nck, cap, w]; table: int32 [nd, w]; starts: int32 [nck];
// lidx: int32 [nck, cap]; span <= nd; w % 4 == 0 and w / 4 <= BLOCK;
// 0 < nck * cap < 2^31; rows_per_step in {1, 8}; workspace: int64
// [1 + nck], zero (and left zero); out: int32 [nck]. Returns
// cudaErrorInvalidValue for another rows_per_step.
extern "C" int gm_window_count(const void* src, const void* table, int64_t nd,
                               const void* starts, const void* lidx,
                               int64_t nck, int64_t cap, int64_t w,
                               int64_t span, int64_t rows_per_step,
                               void* workspace, void* out, int64_t n_blocks,
                               void* stream) {
  void* k = rows_per_step == 1 ? window_kernel<1>()
            : rows_per_step == 8 ? window_kernel<8>() : nullptr;
  if (k == nullptr) return int(cudaErrorInvalidValue);
  const int32_t* s = static_cast<const int32_t*>(src);
  const int32_t* tb = static_cast<const int32_t*>(table);
  const int32_t* sp = static_cast<const int32_t*>(starts);
  const int32_t* lp = static_cast<const int32_t*>(lidx);
  int32_t nd32 = int32_t(nd), cap32 = int32_t(cap), w32 = int32_t(w),
          span32 = int32_t(span);
  unsigned long long* wp = static_cast<unsigned long long*>(workspace);
  int32_t* op = static_cast<int32_t*>(out);
  void* args[] = {&s, &tb, &nd32, &sp, &lp, &nck, &cap32, &w32, &span32,
                  &wp, &op};
  return launched(cudaLaunchKernel(k, dim3(unsigned(n_blocks)),
                                   dim3(gm::BLOCK), args, 0,
                                   static_cast<cudaStream_t>(stream)));
}
