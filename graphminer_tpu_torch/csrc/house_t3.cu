// Kernel H — per-edge 3-walk support over per-run column counts, for the
// fast house engine (ops/house.py), two launches a house count.
//
// It replaces both XLA passes of graphminer_tpu/ops/house.py: H1 _ws_bucket
// (:50, a WS table [V, cpad] int16 of per-vertex sub-core column sums) and
// H2 _t3_edges (:65, per edge the bilinear xu^T Acc xv plus the dots
// <xu, WS[v]> + <xv, WS[u]>, the core-mid share of T3 = (A^3)_uv). For task
// t < n,
//
//   out[t] += sum over x in L(a_t) of popcount(tab[x] & tab[b_t])
//           = sum over the set bits c of tab[b_t] of C_a[c],
//   C_a[c]  = sum over x in L(a_t) of bit c of tab[x],
//
// with tab the full-core bitmap table, int32 [v, words] read as uint32 (bit
// 31 is a real bit), and L(x) the first min(ftw[x], deg x) ids of CSR row x
// (rowptr int64 [v + 1], colidx int32). The house engine launches it twice:
// with L the whole row and the tasks (u, v) in CSR order (y core, x any),
// and with L = FT, the sub-core prefix, and the tasks (v, u) sorted by v (y
// sub, x core). An id outside [0, v) adds 0, as a or b or in a list. out is
// int32 [n], zero on entry.
//
// Bound: bytes — each task's ids and result, each distinct list and each
// distinct table row read once. What a plain walk costs instead: a list of
// rows a task (3.2 TB at rmat18), or in the JAX form a 1.3e14-operation
// bilinear and two WS rows a task. Design: the plan (ops/cuda_house.py::
// plan_house) cuts the tasks into pieces of at most PIECE consecutive tasks
// of one run of equal a, and each piece's list into segments of at most SEG
// slots, one item a (piece, segment), heaviest first. A warp takes an item
// at a time. Lane l holds the 16-byte chunk l of a 128-word stretch of the
// columns (a wider table takes its stretches in turn, a narrower one leaves
// lanes idle). Over the segment it builds its 4 words of C_a bit-sliced in
// NP planes of registers, 8 slots a turn through W's carry-save adders
// (gm::add_eight; the 8 ids and rows are loaded before they are added);
// then it streams the piece's tab[b] chunks, TURN tasks a turn, and takes
//
//   sum over c of bit c of w times C_a[c] = sum_i 2^i popc(p_i & w)
//
// for its words; the warp's sum (__reduce_add_sync) goes into out[t] with
// one atomic a task when it is not 0. So a run's list rows are read once a
// piece, not once a task, and a task costs one row read and 4 NP
// AND-popcounts a lane. No float anywhere: every sum is an integer.
#include "common.cuh"

namespace {

constexpr int SEG = 1024;        // slots a segment (ops/cuda_house.py::SEG)
constexpr int NP = 11;           // planes: a count is at most SEG < 2^NP
constexpr int TURN = 4;          // tasks whose rows are loaded together
static_assert(SEG < (1 << NP), "a segment's counts must fit the planes");

// Lane q's 16-byte chunk of row x; zero for x outside [0, v) or a lane past
// the row.
__device__ __forceinline__ uint4 chunk_of(const uint4* __restrict__ tab,
                                          int32_t v, int32_t quads,
                                          int32_t x, int32_t q, bool on) {
  if (!on || x < 0 || x >= v) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(tab + int64_t(x) * quads + q);
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int e) {
  return e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
}

// sum over the 128 columns of chunk r of bit c times C_a[c], C_a in the
// planes p[e][0:np] of word e.
__device__ __forceinline__ uint32_t chunk_dot(const uint32_t (&p)[4][NP],
                                              const uint4& r, int np) {
  uint32_t s = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t w = word_of(r, e);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < np) s += uint32_t(__popc(p[e][i] & w)) << i;
  }
  return s;
}

// items: int32 [m, 4] (first task, tasks, first slot of the segment in
// L(a), slots >= 1), every item's a in [0, v).
__global__ void __launch_bounds__(gm::BLOCK)
house_t3_kernel(const int64_t* __restrict__ rowptr,
                const int32_t* __restrict__ colidx,
                const uint4* __restrict__ tab, int32_t v, int32_t quads,
                const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int4* __restrict__ items, int64_t m,
                int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       i < m; i += warps) {
    const int4 it = __ldg(items + i);
    const int32_t* ids = colidx + (__ldg(rowptr + __ldg(a + it.x)) + it.z);
    const int32_t t_end = it.x + it.y;
    const int np = 32 - __clz(it.w);
    for (int32_t q0 = 0; q0 < quads; q0 += 32) {
      const int32_t q = q0 + lane;
      const bool on = q < quads;
      uint32_t p[4][NP];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int k = 0; k < NP; ++k) p[e][k] = 0u;
      int32_t s = 0;
      for (; s + 8 <= it.w; s += 8) {         // eight slots' loads in flight
        int32_t x[8];
        uint4 r[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = __ldg(ids + s + k);
#pragma unroll
        for (int k = 0; k < 8; ++k) r[k] = chunk_of(tab, v, quads, x[k], q, on);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) w[k] = word_of(r[k], e);
          gm::add_eight(p[e], w);
        }
      }
      for (; s < it.w; ++s) {
        const uint4 r = chunk_of(tab, v, quads, __ldg(ids + s), q, on);
#pragma unroll
        for (int e = 0; e < 4; ++e) gm::add_word(p[e], word_of(r, e));
      }
      for (int32_t t = it.x; t < t_end; t += TURN) {
        uint4 r[TURN];
#pragma unroll
        for (int k = 0; k < TURN; ++k)
          r[k] = t + k < t_end ? chunk_of(tab, v, quads, __ldg(b + t + k), q,
                                          on)
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int k = 0; k < TURN; ++k) {
          const uint32_t sum =
              __reduce_add_sync(gm::FULL_MASK, chunk_dot(p, r[k], np));
          if (lane == k && sum) atomicAdd(out + t + k, int32_t(sum));
        }
      }
    }
  }
}

}  // namespace

// rowptr: int64 [v + 1]; colidx: int32 [nnz]; tab: int32 [v, words], words
// a multiple of 4, 16-byte aligned; a, b: int32 [n]; items: int32 [m, 4],
// m >= 1, from plan_house (segments of at most SEG slots inside their
// lists, every task of a piece in [0, n)); out: int32 [n], zero. Returns a
// cudaError_t.
extern "C" int gm_house_t3(const void* rowptr, const void* colidx,
                           const void* tab, int64_t v, int64_t words,
                           const void* a, const void* b, const void* items,
                           int64_t m, void* out, int64_t n_blocks,
                           void* stream) {
  house_t3_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(colidx),
      static_cast<const uint4*>(tab), int32_t(v), int32_t(words / 4),
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int4*>(items), m, static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
