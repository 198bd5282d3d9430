// Kernels S, P and I — the per-edge triangle support of the diamond and
// rectangle engines (ops/tri_support.py), one launch each a tri_support call.
//
// They replace the XLA functions of graphminer_tpu/ops/tri_support.py (torch
// has no popcount, and the JAX package's list forms need host-gathered,
// SENTINEL-padded lists in width classes):
//
//   S  _bitmap_tri (:78-95):        out[t] = popcount(tab[s_t] & tab[d_t])
//   P  _subcore_bit_probe (:109-131): out[t] = sum over x in FT(u_t) of bit
//                                   vl_t of tab[x]
//   I  _list_intersect (:134-145):  out[t] = |FT(u_t) ∩ FT(w_t)|
//
// tab is the full-core bitmap table, int32 [v, words] read as uint32 (bit 31
// of a word is a real bit). FT(x) is the first min(ftw[x], deg x) ids of CSR
// row x (rowptr int64 [v + 1], colidx int32): the sub-core neighbours of x,
// which are the prefix of its row because rows are sorted ascending and the
// core ids are the largest. P and I read these lists where they lie, so the
// host builds no list and no width class. An id outside [0, v), and in P a
// bit vl_t outside [0, 32 words), adds 0 (a task whose u or w lies outside
// [0, v) has an empty list). I takes rows without a repeated id, as a CSR of
// a simple graph has them. Any task order gives the same result; the
// engine's order (DAG CSR order: runs of equal src, dst ascending within a
// run) is the fast one.
//
// Bound: bytes. Each task's ids and its int32 result, each distinct row a
// task names read once (S: two 16-byte-aligned bitmap rows; P: one 4-byte
// word a list slot; I: the two lists). What holds them back is what they
// move through L2 on top of that, or the loads a lane waits on in turn, so
// their designs cut it:
//
// S: the rows it streams. A warp takes a window of S_WINDOW = 128
// consecutive tasks, and each of its four groups of 8 lanes a quarter of
// it. A group keeps its current src row in registers (lane l
// holds the 16-byte chunks l, l + 8, l + 16, l + 24: a row of up to 128
// words) and reloads it only where a task's src differs from the last one
// it loaded, so a run of equal src reads its row once and streams the dst
// rows alone (AND, popcount, a width-8 shuffle sum): about one 16-byte-
// chunked row a task through L2 instead of two. A group's ids come 8 at a
// time, one coalesced load a lane and a shuffle, and its 8 results leave
// in one store. Wider rows take a loop that reads both rows a task.
//
// P: the requests of its probes. A warp takes 32 consecutive tasks, a lane
// each, and walks the lanes' lists FT(u) in step, slot by slot. In
// tri_support's order the lanes of a run of equal u load the same id at
// the same step, which the load serves as one request (the run's list is
// read once, not once a task), and then probe the same row at their own
// words, which the load serves one 32-byte sector at a time: the run's
// tasks whose bits lie in one sector of x's row share one request (their v
// ascend, so most share it). The ids of P_STEP = 8 slots are loaded before
// their words, so a lane has 8 probes in flight. No lane waits for
// another's sum: each keeps its own count.
//
// I: the instructions of its searches. A group of I_LANES = 4 lanes takes
// a task (8 a warp): the shorter list's ids, I_IDS = 3 a lane a round, are
// searched in the longer list, the 3 searches of a lane in lockstep
// (gm::count_in_sorted, a branchless lower bound, so 3 loads are in
// flight and no lane waits on one load at a time), and the task's ids are
// loaded a turn ahead. Four lanes leave fewer slots of a round empty on
// short lists than eight; a whole warp on a task (its FT(u) staged once a
// run in shared memory), hash tables of FT(u), a merge path, and the longer
// list copied to shared memory each ran slower (PERF.md).
#include "common.cuh"

namespace {

constexpr int TG = 8;                      // S: lanes a task
constexpr int TPW = 32 / TG;               // S: groups a warp
constexpr int S_CHUNKS = 4;                // S: 16-byte chunks a lane caches
constexpr int S_WINDOW = 128;              // S: tasks a warp, 32 a group
constexpr int P_STEP = 8;                  // P: list slots a lane a step
constexpr int I_LANES = 4;                 // I: lanes a task
constexpr int I_IDS = 3;                   // I: ids a lane searches at once

// The list FT(x): its first id's offset and its length (0 for x outside
// [0, v)).
__device__ __forceinline__ int32_t ft_list(const int64_t* __restrict__ rowptr,
                                           const int32_t* __restrict__ ftw,
                                           int32_t v, int32_t x,
                                           int64_t* start) {
  if (x < 0 || x >= v) return 0;
  const int64_t a = __ldg(rowptr + x), b = __ldg(rowptr + x + 1);
  *start = a;
  const int64_t f = __ldg(ftw + x);
  return int32_t(f < 0 ? 0 : (f < b - a ? f : b - a));
}

__device__ __forceinline__ uint32_t popc_and(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
         __popc(x.w & y.w);
}

// S. CACHED: rows of at most TG * S_CHUNKS chunks, the src row kept in
// registers a run; otherwise both rows are read a task.
template <bool CACHED>
__global__ void __launch_bounds__(gm::BLOCK)
tri_bitmap_kernel(const uint4* __restrict__ tab, int32_t v, int32_t chunks,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst, int64_t n,
                  int32_t* __restrict__ out) {
  constexpr int seg = S_WINDOW / TPW;      // a group's tasks
  const int lane = threadIdx.x & 31, gl = lane % TG;
  const unsigned gmask = 0xFFu << (lane & ~(TG - 1));
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t w0 = warp * S_WINDOW; w0 < n; w0 += warps * S_WINDOW) {
    const int64_t s0 = w0 + int64_t(lane / TG) * seg;
    const int64_t s1 = s0 + seg < n ? s0 + seg : n;
    int32_t cur = -1;                      // the src whose row ra holds
    uint4 ra[S_CHUNKS];
#pragma unroll
    for (int k = 0; k < S_CHUNKS; ++k) ra[k] = make_uint4(0, 0, 0, 0);
    for (int64_t sb = s0; sb < s1; sb += TG) {   // group-uniform bounds
      const int64_t ti = sb + gl;
      const int32_t ia = ti < s1 ? __ldg(src + ti) : -1;
      const int32_t ib = ti < s1 ? __ldg(dst + ti) : -1;
      const int m = int(s1 - sb < TG ? s1 - sb : TG);
      uint32_t res = 0;
      for (int j = 0; j < m; ++j) {
        const int32_t a = __shfl_sync(gmask, ia, j, TG);
        const int32_t b = __shfl_sync(gmask, ib, j, TG);
        uint32_t c = 0;
        if (a >= 0 && a < v && b >= 0 && b < v) {
          const uint4* rb = tab + int64_t(b) * chunks;
          if (CACHED) {
            uint4 y[S_CHUNKS];
#pragma unroll
            for (int k = 0; k < S_CHUNKS; ++k) {
              const int q = gl + TG * k;
              y[k] = q < chunks ? __ldg(rb + q) : make_uint4(0, 0, 0, 0);
            }
            if (a != cur) {                // a new run: its src row, once
              cur = a;
              const uint4* rs = tab + int64_t(a) * chunks;
#pragma unroll
              for (int k = 0; k < S_CHUNKS; ++k) {
                const int q = gl + TG * k;
                ra[k] = q < chunks ? __ldg(rs + q) : make_uint4(0, 0, 0, 0);
              }
            }
#pragma unroll
            for (int k = 0; k < S_CHUNKS; ++k) c += popc_and(ra[k], y[k]);
          } else {
            const uint4* rs = tab + int64_t(a) * chunks;
            for (int q = gl; q < chunks; q += TG)
              c += popc_and(__ldg(rs + q), __ldg(rb + q));
          }
        }
#pragma unroll
        for (int o = TG / 2; o > 0; o >>= 1)
          c += __shfl_xor_sync(gmask, c, o, TG);
        if (gl == j) res = c;
      }
      if (ti < s1) out[ti] = int32_t(res);
    }
  }
}

// P. A warp takes 32 consecutive tasks, a lane each, and walks its lanes'
// lists in step, P_STEP slots a step (the ids first, then the words).
__global__ void __launch_bounds__(gm::BLOCK)
tri_probe_kernel(const int64_t* __restrict__ rowptr,
                 const int32_t* __restrict__ colidx,
                 const int32_t* __restrict__ ftw,
                 const uint32_t* __restrict__ tab, int32_t v, int32_t words,
                 const int32_t* __restrict__ u,
                 const int32_t* __restrict__ vloc, int64_t n,
                 int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t base = warp * 32; base < n; base += warps * 32) {
    const int64_t t = base + lane;
    int32_t len = 0, wi = 0, sh = 0;
    int64_t st = 0;
    if (t < n) {
      const int32_t vl = __ldg(vloc + t);
      if (vl >= 0 && vl < 32 * words) {
        len = ft_list(rowptr, ftw, v, __ldg(u + t), &st);
        wi = vl >> 5;
        sh = vl & 31;
      }
    }
    const int32_t m = __reduce_max_sync(gm::FULL_MASK, len);
    uint32_t c = 0;
    for (int32_t i = 0; i < m; i += P_STEP) {
      int32_t x[P_STEP];
#pragma unroll
      for (int k = 0; k < P_STEP; ++k)
        x[k] = i + k < len ? __ldg(colidx + st + i + k) : -1;
#pragma unroll
      for (int k = 0; k < P_STEP; ++k)
        if (x[k] >= 0 && x[k] < v)
          c += (__ldg(tab + int64_t(x[k]) * words + wi) >> sh) & 1u;
    }
    if (t < n) out[t] = int32_t(c);
  }
}

// I. A group of I_LANES lanes a task, 32 / I_LANES tasks a warp, the warps
// grid-striding over the tasks. The group takes the shorter list's ids,
// I_IDS a lane a round, searches them in lockstep in the longer list and
// sums its hits by shuffle into its lane 0, which stores them. A task's two
// ids are loaded a turn ahead, so its first dependent load is its lists'
// bounds.
__global__ void __launch_bounds__(gm::BLOCK)
tri_lists_kernel(const int64_t* __restrict__ rowptr,
                 const int32_t* __restrict__ colidx,
                 const int32_t* __restrict__ ftw, int32_t v,
                 const int32_t* __restrict__ u,
                 const int32_t* __restrict__ w, int64_t n,
                 int32_t* __restrict__ out) {
  constexpr int GROUPS = 32 / I_LANES;     // tasks a warp
  constexpr int ROUND = I_LANES * I_IDS;   // shorter-list ids a group a round
  const int lane = threadIdx.x & 31, gl = lane % I_LANES;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  const int64_t step = warps * GROUPS;       // tasks the grid takes a turn
  const int64_t t0 = warp * GROUPS + lane / I_LANES;
  int32_t nu = t0 < n ? __ldg(u + t0) : -1, nw = t0 < n ? __ldg(w + t0) : -1;
  for (int64_t t = t0; t - lane / I_LANES < n; t += step) {
    const int32_t tu = nu, tw = nw;        // loaded a turn ago
    nu = t + step < n ? __ldg(u + t + step) : -1;
    nw = t + step < n ? __ldg(w + t + step) : -1;
    uint32_t c = 0;
    if (t < n) {
      int64_t sa = 0, sb = 0;
      int32_t la = ft_list(rowptr, ftw, v, tu, &sa);
      int32_t lb = ft_list(rowptr, ftw, v, tw, &sb);
      if (la > lb) {                      // search the longer list
        const int64_t s = sa; sa = sb; sb = s;
        const int32_t l = la; la = lb; lb = l;
      }
      for (int32_t i0 = 0; i0 < la; i0 += ROUND) {  // la >= 1: lb >= 1
        int32_t x[I_IDS];
#pragma unroll
        for (int k = 0; k < I_IDS; ++k) {
          const int32_t i = i0 + gl + I_LANES * k;
          const int32_t id = i < la ? __ldg(colidx + sa + i) : -1;
          x[k] = id >= 0 && id < v ? id : gm::SENTINEL;  // SENTINEL adds 0
        }
        c += gm::count_in_sorted<I_IDS>(colidx + sb, lb, x);
      }
    }
#pragma unroll
    for (int o = I_LANES / 2; o > 0; o >>= 1)
      c += __shfl_down_sync(gm::FULL_MASK, c, o, I_LANES);
    if (gl == 0 && t < n) out[t] = int32_t(c);
  }
}

}  // namespace

// tab: int32 [v, words], words % 4 == 0, 16-byte aligned; src, dst, out:
// int32 [n], n >= 1. Returns a cudaError_t.
extern "C" int gm_tri_bitmap(const void* tab, int64_t v, int64_t words,
                             const void* src, const void* dst, int64_t n,
                             void* out, int64_t n_blocks, void* stream) {
  const int32_t chunks = int32_t(words / 4);
  auto kernel = chunks <= TG * S_CHUNKS ? tri_bitmap_kernel<true>
                                        : tri_bitmap_kernel<false>;
  kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), int32_t(v), chunks,
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), n,
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}

// rowptr: int64 [v + 1]; colidx: int32 [nnz]; ftw: int32 [v]; tab: int32
// [v, words]; u, vloc, out: int32 [n], n >= 1. Returns a cudaError_t.
extern "C" int gm_tri_probe(const void* rowptr, const void* colidx,
                            const void* ftw, const void* tab, int64_t v,
                            int64_t words, const void* u, const void* vloc,
                            int64_t n, void* out, int64_t n_blocks,
                            void* stream) {
  tri_probe_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(colidx),
      static_cast<const int32_t*>(ftw), static_cast<const uint32_t*>(tab),
      int32_t(v), int32_t(words), static_cast<const int32_t*>(u),
      static_cast<const int32_t*>(vloc), n, static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}

// rowptr: int64 [v + 1]; colidx: int32 [nnz], rows sorted ascending without
// a repeated id; ftw: int32 [v]; u, w, out: int32 [n], n >= 1. Returns a
// cudaError_t.
extern "C" int gm_tri_lists(const void* rowptr, const void* colidx,
                            const void* ftw, int64_t v, const void* u,
                            const void* w, int64_t n, void* out,
                            int64_t n_blocks, void* stream) {
  tri_lists_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rowptr), static_cast<const int32_t*>(colidx),
      static_cast<const int32_t*>(ftw), int32_t(v),
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(w), n,
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
