// Kernel W — bit column sums over CSR rows, in two modes.
//
// Write mode (gm_bit_colsum): the column sums over a vertex's sub-core
// neighbours, written out; house's WS (graphminer_tpu/ops/house.py::
// _ws_bucket) is this sum. It replaced the XLA path of
// graphminer_tpu/ops/rectangle.py::_case_b (:149-158: gathered FT rows, int8
// bit expansion, a sum over the list axis), which needed host-gathered,
// SENTINEL-padded lists in width classes. For task i < n,
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
//
// Pairs mode (gm_colsum_pairs, gm_colsum_finish): the rectangle engine's
// level 0 (cases A and B of graphminer_tpu/ops/rectangle.py::_case_a, :93,
// and ::_case_b, :119, with their products and lo/hi-16 sums) as one scalar.
// With the core ids [cs, cs + c) and, for a vertex x, T'[x] = tab[x] with
// the columns <= x - cs cleared when x is core,
//
//   w_u[col] = sum over x in N(u) (the whole CSR row) of bit col of T'[x]
//   total   += sum over col < c, and col > u - cs when u is core,
//              of C(w_u[col], 2)
//
// over the plan's rows u (ops/cuda_colsum.py::plan_pairs: the rows with at
// least two slots, heaviest first). A row longer than the plan's cut is cut
// into segments: each segment adds its column counts into its row of an
// int32 scratch (counts, [n_long, 32 words]), and the finish launch applies
// the masks and the sum to those rows. An id outside [0, v) adds 0.
//
// Bound: bytes — the task ids and row bounds, 4 B a list slot, and each
// distinct table row a slot names read once; nothing is written but the
// scalar (and the split rows' counts). Design: a group of lanes a segment
// (a power of two, up to 256: at 128 words two warps), each lane 8 bytes
// (2 words) of the row, the groups grid-striding over the segments, which
// come heaviest first. A lane keeps its 2 words' column counts bit-sliced
// in 16 planes of registers (a count stays below 2^16). It takes the slots
// 8 at a time: their 8 words (loads in flight together) are summed by a
// tree of carry-save adders into a 4-bit bit-sliced value, which full
// adders add into the low planes; the carry out ripples on through half
// adders and stops when it is zero. (One slot at a time through the ripple
// ran 2.5x slower at rmat18: the ripple's serial, divergent carries, not
// the loads, held it; 4 words a lane ran slower at 2 blocks an SM.) After
// the row the lane masks the planes and takes, for its word,
//
//   sum_b C(w_b, 2) = sum_{i<j} 2^(i+j) popc(p_i & p_j)
//                   + sum_i 2^(i-1) (2^i - 1) popc(p_i)
//
// over the planes the segment's length can reach; a word whose counts are
// all at most 1 is skipped. The block sums its lanes' int64 terms and adds
// them to the scalar with one 64-bit atomic.
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

constexpr int NP = 16;                 // bit planes: a column count < 2^16

// The bits of word j whose columns 32 j + b exceed t (all for t < 32 j).
// A shift by 32 is undefined, so k = 31 has its own case.
__device__ __forceinline__ uint32_t cols_above(int32_t j, int32_t t) {
  const int32_t k = t - 32 * j;
  if (k < 0) return 0xFFFFFFFFu;
  if (k >= 31) return 0u;
  return 0xFFFFFFFFu << (k + 1);
}

// The bits of word j whose columns 32 j + b lie below c.
__device__ __forceinline__ uint32_t cols_below(int32_t j, int32_t c) {
  const int32_t k = c - 32 * j;
  if (k >= 32) return 0xFFFFFFFFu;
  if (k <= 0) return 0u;
  return 0xFFFFFFFFu >> (32 - k);
}

// Adds one to the bit-sliced count of every column whose bit is set in
// carry, from plane `from` up.
__device__ __forceinline__ void add_word(uint32_t (&p)[NP], uint32_t carry,
                                         int from = 0) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
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
__device__ __forceinline__ void add_eight(uint32_t (&p)[NP],
                                          const uint32_t (&w)[8]) {
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

// Sum over the columns of om of C(w, 2), w the count in planes p[0:np].
__device__ __forceinline__ uint64_t word_pairs(const uint32_t (&p)[NP],
                                               uint32_t om, int np) {
  uint32_t hi = 0;
#pragma unroll
  for (int i = 1; i < NP; ++i)
    if (i < np) hi |= p[i];
  if (!(hi & om)) return 0;           // every count here is 0 or 1
  uint64_t s = 0;
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    if (i >= np) break;
    s += (uint64_t(__popc(p[i] & om)) * ((1u << i) - 1u)) << (i - 1);
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i >= np) break;
    const uint32_t a = p[i] & om;
#pragma unroll
    for (int j = i + 1; j < NP; ++j) {
      if (j >= np) break;
      s += uint64_t(__popc(a & p[j])) << (i + j);
    }
  }
  return s;
}

// 8 bytes (words 2k, 2k + 1) of T'[x]; zero for x outside [0, v).
__device__ __forceinline__ uint2 row_pair(const uint2* __restrict__ tab,
                                          int32_t v, int32_t pairs,
                                          int32_t cs, int32_t x, int32_t k) {
  if (x < 0 || x >= v) return make_uint2(0u, 0u);
  uint2 w = __ldg(tab + int64_t(x) * pairs + k);
  if (x >= cs) {
    w.x &= cols_above(2 * k, x - cs);
    w.y &= cols_above(2 * k + 1, x - cs);
  }
  return w;
}

// items: int32 [n, 4] (u, first slot of the segment in u's row, slots,
// split-row index or -1). Lanes a segment: 1 << lg.
__global__ void __launch_bounds__(gm::BLOCK, 3)
colsum_pairs_kernel(const int64_t* __restrict__ rowptr,
                    const int32_t* __restrict__ colidx,
                    const uint2* __restrict__ tab, int32_t v, int32_t words,
                    int32_t cs, int32_t c, const int4* __restrict__ items,
                    int64_t n, int32_t lg, int32_t* __restrict__ counts,
                    unsigned long long* __restrict__ total) {
  const int32_t pairs = words >> 1, lanes = 1 << lg;
  const int64_t gt = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int32_t lane = int32_t(gt & (lanes - 1));
  const int64_t groups = (int64_t(gridDim.x) * blockDim.x) >> lg;
  uint64_t acc = 0;
  for (int64_t i = gt >> lg; i < n; i += groups) {
    const int4 it = __ldg(items + i);
    const int32_t* ids = colidx + (__ldg(rowptr + it.x) + it.y);
    const int32_t len = it.z;
    for (int32_t k = lane; k < pairs; k += lanes) {
      uint32_t p[2][NP];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int b = 0; b < NP; ++b) p[e][b] = 0u;
      int32_t s = 0;
      for (; s + 8 <= len; s += 8) {          // eight slots' loads in flight
        int32_t x[8];
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) x[r] = __ldg(ids + s + r);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint2 w = row_pair(tab, v, pairs, cs, x[r], k);
          lo[r] = w.x;
          hi[r] = w.y;
        }
        add_eight(p[0], lo);
        add_eight(p[1], hi);
      }
      for (; s < len; ++s) {
        const uint2 w = row_pair(tab, v, pairs, cs, __ldg(ids + s), k);
        add_word(p[0], w.x);
        add_word(p[1], w.y);
      }
      if (it.w >= 0) {                        // a segment of a split row
        int32_t* row = counts + int64_t(it.w) * 32 * words;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          uint32_t any = 0;
#pragma unroll
          for (int i = 0; i < NP; ++i) any |= p[e][i];
          if (!any) continue;
          const int32_t j = 2 * k + e;
          for (int b = 0; b < 32; ++b) {
            uint32_t w = 0;
#pragma unroll
            for (int i = 0; i < NP; ++i) w |= ((p[e][i] >> b) & 1u) << i;
            if (w) atomicAdd(row + 32 * j + b, int32_t(w));
          }
        }
      } else {
        const int32_t t = it.x >= cs ? it.x - cs : -1;
        const int np = 32 - __clz(len);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int32_t j = 2 * k + e;
          acc += word_pairs(p[e], cols_above(j, t) & cols_below(j, c), np);
        }
      }
    }
  }
  gm::block_sum_add(acc, total);
}

__device__ __forceinline__ uint64_t pair_count(int32_t w, uint32_t on) {
  return on ? uint64_t(w) * uint64_t(w - 1) / 2 : 0ull;
}

// counts: int32 [n_long, 32 words], row r the column counts of split row
// long_u[r]; adds its masked sum of C(w, 2) to *total.
__global__ void __launch_bounds__(gm::BLOCK)
colsum_finish_kernel(const int4* __restrict__ counts,
                     const int32_t* __restrict__ long_u, int64_t n_long,
                     int32_t words, int32_t cs, int32_t c,
                     unsigned long long* __restrict__ total) {
  uint64_t acc = 0;
  for (int64_t r = blockIdx.x; r < n_long; r += gridDim.x) {
    const int32_t u = __ldg(long_u + r);
    const int32_t t = u >= cs ? u - cs : -1;
    const int4* row = counts + r * words * 8;
    for (int32_t q = threadIdx.x; q < words * 8; q += blockDim.x) {
      const int4 a = __ldg(row + q);
      const int32_t j = q >> 3;
      const uint32_t om = (cols_above(j, t) & cols_below(j, c)) >> ((q & 7) * 4);
      acc += pair_count(a.x, om & 1u) + pair_count(a.y, (om >> 1) & 1u) +
             pair_count(a.z, (om >> 2) & 1u) + pair_count(a.w, (om >> 3) & 1u);
    }
  }
  gm::block_sum_add(acc, total);
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

// Blocks of one full wave of the pairs kernel's persistent grid: SMs x
// resident blocks; a negative CUDA error on failure.
extern "C" int gm_colsum_pairs_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, colsum_pairs_kernel, gm::BLOCK, 0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// rowptr: int64 [v + 1]; colidx: int32 [nnz]; tab: int32 [v, words], words
// even, 8-byte aligned; 0 <= cs, 0 <= c <= 32 words; items: int32
// [n, 4], n >= 1, every u in [0, v) and every segment inside its row, with
// fewer than 2^16 slots; lg: log2 of the lanes a segment, 0..8; counts:
// int32 [split rows, 32 words], zero; total: int64 [1]. Returns a
// cudaError_t.
extern "C" int gm_colsum_pairs(const void* rowptr, const void* colidx,
                               const void* tab, int64_t v, int64_t words,
                               int64_t cs, int64_t c, const void* items,
                               int64_t n, int64_t lg, void* counts,
                               void* total, int64_t n_blocks, void* stream) {
  colsum_pairs_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(colidx),
      static_cast<const uint2*>(tab), int32_t(v), int32_t(words),
      int32_t(cs), int32_t(c), static_cast<const int4*>(items), n,
      int32_t(lg), static_cast<int32_t*>(counts),
      static_cast<unsigned long long*>(total));
  return int(cudaGetLastError());
}

// counts: int32 [n_long, 32 words], 16-byte aligned; long_u: int32
// [n_long], n_long >= 1; total: int64 [1]. Returns a cudaError_t.
extern "C" int gm_colsum_finish(const void* counts, const void* long_u,
                                int64_t n_long, int64_t words, int64_t cs,
                                int64_t c, void* total, int64_t n_blocks,
                                void* stream) {
  colsum_finish_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(counts), static_cast<const int32_t*>(long_u),
      n_long, int32_t(words), int32_t(cs), int32_t(c),
      static_cast<unsigned long long*>(total));
  return int(cudaGetLastError());
}
