// Helpers shared by the port's hand-written Hopper kernels (sm_90a).
//
// The engine kernels (A, B, C, E) write ONE int64 partial per block (no
// atomics, so the sum is deterministic) and the Python wrapper sums the
// partials in int64. The probe kernels D, m3 and m3b finish their result in
// the launch itself (finish_int32). Words are read as uint32: bit 31 is set
// in real bitmap rows.
#pragma once

#include <cassert>
#include <climits>
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

// Column counts kept bit-sliced: plane p[i] holds bit i of the count of each
// of a word's 32 columns (kernels W's pairs mode and H). The caller keeps
// every count below 2^N.
//
// Adds one to the count of every column whose bit is set in carry, from
// plane `from` up.
template <int N>
__device__ __forceinline__ void add_word(uint32_t (&p)[N], uint32_t carry,
                                         int from = 0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < from) continue;
    if (!carry) break;
    const uint32_t t = p[i] & carry;
    p[i] ^= carry;
    carry = t;
  }
}

// h, l: the carry and sum bits of a + b + c, column by column.
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// Adds w[0] + ... + w[7], column by column, to the counts: a carry-save
// tree gives the 4-bit sum s0 + 2 s1 + 4 s2 + 8 s3, full adders add it to
// planes 0-3, and the carry out ripples on.
template <int N>
__device__ __forceinline__ void add_eight(uint32_t (&p)[N],
                                          const uint32_t (&w)[8]) {
  static_assert(N >= 4, "add_eight adds a 4-bit sum");
  uint32_t h1, l1, h2, l2, h3, l3, h5, l5;
  csa(h1, l1, w[0], w[1], w[2]);
  csa(h2, l2, w[3], w[4], w[5]);
  csa(h3, l3, l1, l2, w[6]);             // w[0..6] = l3 + 2 (h1 + h2 + h3)
  const uint32_t h4 = l3 & w[7];
  csa(h5, l5, h1, h2, h3);
  const uint32_t h6 = l5 & h4;
  const uint32_t s[4] = {l3 ^ w[7], l5 ^ h4, h5 ^ h6, h5 & h6};
  if (!(s[0] | s[1] | s[2] | s[3])) return;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = p[i], u = a ^ s[i];
    p[i] = u ^ c;
    c = (a & s[i]) | (u & c);
  }
  add_word(p, c, 4);
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

// Block-wide sum of one value per thread, added by thread 0 to *dst with an
// integer atomic (exact, so the order of the blocks' adds does not matter).
// Every thread of the NT-thread block must call it.
template <int NT = BLOCK>
__device__ __forceinline__ void block_sum_add(unsigned long long v,
                                              unsigned long long* dst) {
  __shared__ unsigned long long warp_sums[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (NT / 32) ? warp_sums[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
    if (lane == 0) atomicAdd(dst, v);
  }
  __syncthreads();                    // warp_sums is free for the next call
}

// The end of a kernel whose blocks add int64 sums into acc[0:n] with
// atomics: workspace ws = {finish counter, acc[0:n]}, all zero when the
// launch starts. The last block to arrive moves acc into out[0:n] as int32,
// asserting on the device that each sum fits (a sum outside int32 is a
// device-side assert, as torch._assert_async raises one), and leaves ws zero
// for the next launch on the stream. Every thread of the block must call it,
// after its own adds.
__device__ __forceinline__ void finish_int32(unsigned long long* ws,
                                             int64_t n, int32_t* out) {
  __shared__ bool last;
  __threadfence();                  // this thread's adds land before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ws, 1ull) == gridDim.x - 1ull;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const long long s = static_cast<long long>(atomicExch(ws + 1 + i, 0ull));
    assert(s >= INT_MIN && s <= INT_MAX);        // the int32 sum would wrap
    out[i] = static_cast<int32_t>(s);
  }
  if (threadIdx.x == 0) atomicExch(ws, 0ull);
}

}  // namespace gm
