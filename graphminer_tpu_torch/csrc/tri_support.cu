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
// a simple graph has them.
//
// Bound: bytes. Each task's ids and its int32 result, each distinct row a
// task names read once (S: two 16-byte-aligned bitmap rows; P: one 4-byte
// word a list slot; I: the two lists). Design: a group of 8 lanes a task
// (4 tasks a warp, the warps grid-striding over the tasks). S's lanes read
// 16-byte chunks of both rows (one pass of the group covers 128 words in 4
// loads a lane) and sum popcounts; P's lanes stride over the list, one word
// load a slot; I's lanes take the shorter list's ids and binary-search the
// longer list (gm::in_sorted). The group's sum is a width-8 shuffle
// reduction; lane 0 stores it. Nothing is summed across tasks.
#include "common.cuh"

namespace {

constexpr int TG = 8;                      // lanes a task
constexpr int TPW = 32 / TG;               // tasks a warp a round

__device__ __forceinline__ uint32_t group_sum(uint32_t c) {
#pragma unroll
  for (int o = TG / 2; o > 0; o >>= 1) c += __shfl_down_sync(gm::FULL_MASK, c, o, TG);
  return c;
}

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

__global__ void __launch_bounds__(gm::BLOCK)
tri_bitmap_kernel(const uint4* __restrict__ tab, int32_t v, int32_t chunks,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst, int64_t n,
                  int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, gl = lane % TG;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t base = warp * TPW; base < n; base += warps * TPW) {
    const int64_t t = base + lane / TG;       // the warp's rounds agree
    uint32_t c = 0;
    if (t < n) {
      const int32_t a = __ldg(src + t), b = __ldg(dst + t);
      if (a >= 0 && a < v && b >= 0 && b < v) {
        const uint4* ra = tab + int64_t(a) * chunks;
        const uint4* rb = tab + int64_t(b) * chunks;
        for (int q = gl; q < chunks; q += TG) {
          const uint4 x = __ldg(ra + q), y = __ldg(rb + q);
          c += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) +
               __popc(x.w & y.w);
        }
      }
    }
    c = group_sum(c);
    if (gl == 0 && t < n) out[t] = int32_t(c);
  }
}

__global__ void __launch_bounds__(gm::BLOCK)
tri_probe_kernel(const int64_t* __restrict__ rowptr,
                 const int32_t* __restrict__ colidx,
                 const int32_t* __restrict__ ftw,
                 const uint32_t* __restrict__ tab, int32_t v, int32_t words,
                 const int32_t* __restrict__ u,
                 const int32_t* __restrict__ vloc, int64_t n,
                 int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, gl = lane % TG;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t base = warp * TPW; base < n; base += warps * TPW) {
    const int64_t t = base + lane / TG;
    uint32_t c = 0;
    if (t < n) {
      const int32_t vl = __ldg(vloc + t);
      int64_t st = 0;
      const int32_t len = vl >= 0 && vl < 32 * words
                              ? ft_list(rowptr, ftw, v, __ldg(u + t), &st)
                              : 0;
      const int32_t wi = vl >> 5, sh = vl & 31;
      for (int32_t i = gl; i < len; i += TG) {
        const int32_t x = __ldg(colidx + st + i);
        if (x >= 0 && x < v)
          c += (__ldg(tab + int64_t(x) * words + wi) >> sh) & 1u;
      }
    }
    c = group_sum(c);
    if (gl == 0 && t < n) out[t] = int32_t(c);
  }
}

__global__ void __launch_bounds__(gm::BLOCK)
tri_lists_kernel(const int64_t* __restrict__ rowptr,
                 const int32_t* __restrict__ colidx,
                 const int32_t* __restrict__ ftw, int32_t v,
                 const int32_t* __restrict__ u,
                 const int32_t* __restrict__ w, int64_t n,
                 int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, gl = lane % TG;
  const int64_t warp = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (int64_t(gridDim.x) * blockDim.x) >> 5;
  for (int64_t base = warp * TPW; base < n; base += warps * TPW) {
    const int64_t t = base + lane / TG;
    uint32_t c = 0;
    if (t < n) {
      int64_t sa = 0, sb = 0;
      int32_t la = ft_list(rowptr, ftw, v, __ldg(u + t), &sa);
      int32_t lb = ft_list(rowptr, ftw, v, __ldg(w + t), &sb);
      if (la > lb) {                      // search the longer list
        const int64_t s = sa; sa = sb; sb = s;
        const int32_t l = la; la = lb; lb = l;
      }
      for (int32_t i = gl; i < la; i += TG) {
        const int32_t x = __ldg(colidx + sa + i);
        if (x >= 0 && x < v) c += gm::in_sorted(colidx + sb, lb, x);
      }
    }
    c = group_sum(c);
    if (gl == 0 && t < n) out[t] = int32_t(c);
  }
}

}  // namespace

// tab: int32 [v, words], words % 4 == 0, 16-byte aligned; src, dst, out:
// int32 [n], n >= 1. Returns a cudaError_t.
extern "C" int gm_tri_bitmap(const void* tab, int64_t v, int64_t words,
                             const void* src, const void* dst, int64_t n,
                             void* out, int64_t n_blocks, void* stream) {
  tri_bitmap_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), int32_t(v), int32_t(words / 4),
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
