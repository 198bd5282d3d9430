// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel here writes ONE int64 partial per block (no atomics, so the
// sum is deterministic) and the Python wrapper sums the partials in int64.
// Words are read as uint32: bit 31 is set in real bitmap rows.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gm {

constexpr int32_t SENTINEL = 0x7FFFFFFF;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int BLOCK = 256;

// Division by a run-time constant with a multiply-high and a shift
// (Granlund-Montgomery, as in PyTorch's IntDivider). Exact for every
// dividend below 2^31; the wrappers keep each launch's index space there.
struct FastDiv {
  uint32_t d, m, s;

  static FastDiv make(uint32_t divisor) {
    FastDiv f;
    f.d = divisor;
    f.s = 0;
    while (f.s < 32 && (uint64_t(1) << f.s) < divisor) ++f.s;
    const uint64_t one = 1;
    f.m = uint32_t(((one << 32) * ((one << f.s) - divisor)) / divisor + 1);
    return f;
  }

  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// True iff x occurs in row[0:n], which is sorted ascending (SENTINEL pads
// sort last). Lower-bound binary search through the read-only cache.
__device__ __forceinline__ bool in_sorted(const int32_t* __restrict__ row,
                                          int32_t n, int32_t x) {
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo < n && __ldg(row + lo) == x;
}

// How many of the K ids x[0..K) occur in row[0:n] (sorted ascending, no
// repeated id, n >= 1); SENTINEL ids count 0. Each id takes a branchless
// lower-bound search whose step count depends on n alone, so the K
// searches run in lockstep and their loads overlap.
template <int K>
__device__ __forceinline__ uint32_t count_in_sorted(const int32_t* row,
                                                    int32_t n,
                                                    const int32_t (&x)[K]) {
  int32_t base[K];
#pragma unroll
  for (int u = 0; u < K; ++u) base[u] = 0;
  for (int32_t m = n; m > 1;) {
    const int32_t half = m >> 1;
#pragma unroll
    for (int u = 0; u < K; ++u)
      base[u] = row[base[u] + half] < x[u] ? base[u] + half : base[u];
    m -= half;
  }
  uint32_t hits = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int32_t lb = base[u] + (row[base[u]] < x[u]);
    hits += x[u] != SENTINEL && lb < n && row[lb] == x[u];
  }
  return hits;
}

// Block-wide sum of one value per thread of an NT-thread block (NT <= 1024);
// thread 0 writes it to out[blockIdx.x]. Every thread of the block must
// call it.
template <int NT = BLOCK>
__device__ __forceinline__ void block_sum_store(unsigned long long v,
                                                long long* __restrict__ out) {
  __shared__ unsigned long long warp_sums[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (NT / 32) ? warp_sums[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
    if (lane == 0) out[blockIdx.x] = static_cast<long long>(v);
  }
}

}  // namespace gm
