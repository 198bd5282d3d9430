// Kernel Q — quad emission for the large-clique engine's k = 6 device path,
// one launch a chunk of triangle tasks.
//
// Replaces the compaction of the XLA function
// graphminer_tpu/ops/cliquebig.py::_tri_expand_bilinear (:156-169: the
// bits of y2full[r] & C[c1] expanded by _expand_bits, a cumsum and a
// scatter; torch has no unpackbits or popcount). For each triangle task t
// (edge row erow[t], core id c1[t]) it writes every set bit c2 < n_bits of
//
//   y = y2[erow[t]] & core[c1[t]]            (words read as uint32)
//
// in ascending order as one quad: r_out[o] = erow[t], cols_out[o] =
// (c1[t], c2), at o = off[t] - off[0] + j for the task's j-th bit. off
// (int64 [n + 1]) is the scan of the tasks' bit counts, as the engine gets
// them from the native count_multi prepass; a task whose erow or c1 lies
// outside its table emits nothing (and counts 0). The quads are kernel G's
// gathered arguments at depth 2 (r, cols), so no host round trip sits
// between the two launches.
//
// Bound: bytes — the tasks' ids and offsets (4 + 4 + 8 B a task), each
// distinct y2 and core row gathered read once and 12 B written a quad, at
// 3.35 TB/s.
// Design (simple first): one warp a task, lane l holding word w0 + l of a
// 32-word slab of the row; __popc per word, an inclusive warp scan
// (__shfl_up_sync) gives each lane its first output slot, and each lane
// walks its word's bits with __ffs and writes its quads (the cols pair as
// one 8-byte store). A persistent grid of warps strides over the chunk's
// tasks.
#include "common.cuh"

namespace {

constexpr int WARPS = gm::BLOCK / 32;

__global__ void __launch_bounds__(gm::BLOCK)
quad_emit_kernel(const uint32_t* __restrict__ y2, int64_t ldy, int32_t ny,
                 const uint32_t* __restrict__ core, int64_t ldc, int32_t nc,
                 int32_t nw, int32_t n_bits,
                 const int32_t* __restrict__ erow,
                 const int32_t* __restrict__ c1,
                 const long long* __restrict__ off, int64_t n_tasks,
                 int32_t* __restrict__ r_out, int2* __restrict__ cols_out) {
  const int lane = threadIdx.x & 31;
  const long long first = __ldg(off);
  for (int64_t t = int64_t(blockIdx.x) * WARPS + threadIdx.x / 32;
       t < n_tasks; t += int64_t(gridDim.x) * WARPS) {
    const int32_t r = __ldg(erow + t), c = __ldg(c1 + t);
    if (r < 0 || r >= ny || c < 0 || c >= nc) continue;   // warp-uniform
    const uint32_t* yr = y2 + int64_t(r) * ldy;
    const uint32_t* cr = core + int64_t(c) * ldc;
    long long o = __ldg(off + t) - first;
    for (int32_t w0 = 0; w0 < nw; w0 += 32) {
      const int32_t w = w0 + lane;
      uint32_t x = 0u;
      if (w < nw) {
        x = __ldg(yr + w) & __ldg(cr + w);
        const int32_t left = n_bits - 32 * w;   // >= 1, as 32 * w < n_bits
        if (left < 32) x &= (1u << left) - 1u;
      }
      const int cnt = __popc(x);
      int incl = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(gm::FULL_MASK, incl, d);
        if (lane >= d) incl += v;
      }
      long long p = o + (incl - cnt);
      while (x) {
        const int b = __ffs(x) - 1;
        r_out[p] = r;
        cols_out[p] = make_int2(c, 32 * w + b);
        ++p;
        x &= x - 1u;
      }
      o += __shfl_sync(gm::FULL_MASK, incl, 31);
    }
  }
}

}  // namespace

// y2: int32 [ny, *] rows at stride ldy; core: int32 [nc, *] at stride ldc;
// words read a row: nw (the wrapper's min(words, ceil(n_bits / 32)));
// erow, c1: int32 [n]; off: int64 [n + 1]; r_out: int32 [off[n] - off[0]];
// cols_out: int32 [off[n] - off[0], 2]; n >= 1. Returns a cudaError_t.
extern "C" int gm_quad_emit(const void* y2, int64_t ldy, int64_t ny,
                            const void* core, int64_t ldc, int64_t nc,
                            int64_t nw, int64_t n_bits, const void* erow,
                            const void* c1, const void* off, int64_t n,
                            void* r_out, void* cols_out, int64_t n_blocks,
                            void* stream) {
  quad_emit_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y2), ldy, int32_t(ny),
      static_cast<const uint32_t*>(core), ldc, int32_t(nc), int32_t(nw),
      int32_t(n_bits), static_cast<const int32_t*>(erow),
      static_cast<const int32_t*>(c1), static_cast<const long long*>(off), n,
      static_cast<int32_t*>(r_out), static_cast<int2*>(cols_out));
  return int(cudaGetLastError());
}
