// Kernel W — the bit column sums over a vertex's sub-core neighbours: the
// wsub term of the rectangle engine's case B (ops/rectangle.py), one launch
// a case-B chunk that has any sub neighbour.
//
// Replaces the XLA path of graphminer_tpu/ops/rectangle.py::_case_b
// (:149-158: gathered FT rows, int8 bit expansion, a sum over the list
// axis), which needed host-gathered, SENTINEL-padded lists in width
// classes; house's WS (graphminer_tpu/ops/house.py::_ws_bucket) is the same
// sum. For task i < n,
//
//   out[i, 32 j + b] = sum over x in FT(u_i) of bit b of tab[x, j]
//
// with tab the full-core bitmap table, int32 [v, words] read as uint32, and
// FT(x) the first min(ftw[x], deg x) ids of CSR row x (rowptr int64
// [v + 1], colidx int32): the sub-core neighbours, the prefix of the sorted
// row, read where they lie. An id outside [0, v) adds 0, and a u_i outside
// [0, v) has an empty list (a zero row of out). out is int32 [n, 32 words],
// every entry written.
//
// Bound: bytes — the ids, each distinct gathered row read once and the
// output written once; at rmat18 the output (4 B an entry, 32 words
// entries a task) is most of it. Design: one block a task (the blocks
// grid-stride over the tasks), one thread a word of the row: it keeps 32
// counters in registers, walks the list (each list id is one broadcast
// load; the row's words are one coalesced load across the block), adds the
// word's 32 bits into its counters, and stores its 32 entries with eight
// 16-byte stores.
#include "common.cuh"

namespace {

__global__ void bit_colsum_kernel(const int64_t* __restrict__ rowptr,
                                  const int32_t* __restrict__ colidx,
                                  const int32_t* __restrict__ ftw,
                                  const uint32_t* __restrict__ tab, int32_t v,
                                  int32_t words,
                                  const int32_t* __restrict__ u, int64_t n,
                                  int32_t* __restrict__ out) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const int32_t x0 = __ldg(u + i);
    int64_t st = 0;
    int32_t len = 0;
    if (x0 >= 0 && x0 < v) {
      st = __ldg(rowptr + x0);
      const int64_t deg = __ldg(rowptr + x0 + 1) - st;
      const int64_t f = __ldg(ftw + x0);
      len = int32_t(f < 0 ? 0 : (f < deg ? f : deg));
    }
    for (int32_t j = threadIdx.x; j < words; j += blockDim.x) {
      uint32_t cnt[32];
#pragma unroll
      for (int b = 0; b < 32; ++b) cnt[b] = 0;
      for (int32_t p = 0; p < len; ++p) {
        const int32_t x = __ldg(colidx + st + p);
        if (x < 0 || x >= v) continue;
        const uint32_t wd = __ldg(tab + int64_t(x) * words + j);
#pragma unroll
        for (int b = 0; b < 32; ++b) cnt[b] += (wd >> b) & 1u;
      }
      int4* o = reinterpret_cast<int4*>(out + (i * words + j) * 32);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = make_int4(int(cnt[4 * q]), int(cnt[4 * q + 1]),
                         int(cnt[4 * q + 2]), int(cnt[4 * q + 3]));
    }
  }
}

}  // namespace

// rowptr: int64 [v + 1]; colidx: int32 [nnz]; ftw: int32 [v]; tab: int32
// [v, words]; u: int32 [n], n >= 1; out: int32 [n, 32 words], 16-byte
// aligned; threads: a multiple of 32, at most 1024. Returns a cudaError_t.
extern "C" int gm_bit_colsum(const void* rowptr, const void* colidx,
                             const void* ftw, const void* tab, int64_t v,
                             int64_t words, const void* u, int64_t n,
                             void* out, int64_t n_blocks, int64_t threads,
                             void* stream) {
  bit_colsum_kernel<<<unsigned(n_blocks), unsigned(threads), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(colidx),
      static_cast<const int32_t*>(ftw), static_cast<const uint32_t*>(tab),
      int32_t(v), int32_t(words), static_cast<const int32_t*>(u), n,
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
