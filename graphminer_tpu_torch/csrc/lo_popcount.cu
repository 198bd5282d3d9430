// Kernel L — the k-clique engine's lo-task popcount over shared runs, one
// launch a count.
//
// Replaces the XLA function graphminer_tpu/ops/cliquek.py::_lo_popcount
// (gathers, ANDs and population_count under lax.map; torch has no
// popcount). For tasks (x_0, ..., x_{nrow-1}), 2 <= nrow <= 8, it counts
//
//   sum_t popcount(bm[x_t,0] & bm[x_t,1] & core[x_t,2] & ... )
//
// over bm int32 [v, words] and core int32 [c, words], words read as uint32.
// A task adds 0 unless its bm ids lie in [0, v) and its core ids in
// [0, c): that covers the SENTINEL padding. Where JAX clamps an
// out-of-range bm index, or reads bm[0] for a negative b, this kernel adds
// 0 (an intended divergence on inputs no engine makes).
//
// The tasks come as a run table (ops/cuda_cliquek.py::lo_runs): a run is a
// maximal stretch of consecutive tasks that agree on every column but one,
// the varying column vc (k = 4: d; k = 5: c, the enumerator's innermost
// loop), cut at 256 tasks so that no run holds up the grid. The table
// holds each run's shared ids (int32 [runs, nrow - 1], the columns other
// than vc in order), its first task (starts, int32 [runs + 1]) and each
// task's varying id (int32 [n]).
//
// Bound: bytes — the task ids and each table row that a valid task names,
// read once, at 3.35 TB/s (also reported over the run table's bytes).
// The first design, 8 lanes a task reading all nrow rows, re-read 19.5 GB
// through L2 at rmat18 k = 5 (4 rows of 512 B for each of 9.5 M tasks).
// Design: a group of G = 8 lanes takes a run (the groups of the
// persistent grid, one wave, stride over the runs), lane l holding 16-byte
// chunks l, l + 8, l + 16 and l + 24 of a row (one pass at 128 words,
// more for wider rows). It loads the run's shared rows and the varying ids
// of its first UT = 2 tasks together, ANDs the shared rows into z, and
// reads of each task's varying row only the chunks where its z is
// nonzero; longer runs take UT tasks a round. So a task costs at most one
// row where the first design read nrow rows. The kernel is a template on
// the number of shared rows, so a run's row pointers and loads unroll
// without dead registers: runs are short at rmat18 (2.7 tasks at k = 5,
// 1.8 at k = 4), the loads are few levels deep, and resident warps are
// what hides them: designs that walked a block's runs in phases behind
// barriers, or held a group's run in 70-100 registers, ran slower on the
// H100 (PERF.md). Each thread keeps a 64-bit sum and each block writes one
// int64 partial (gm::block_sum_store).
#include "common.cuh"

namespace {

constexpr int G = 8;                       // lanes a run
constexpr int GROUPS = gm::BLOCK / G;      // groups a block
constexpr int QL = 4;                      // 16-byte chunks a lane a pass
constexpr int UT = 2;                      // tasks a round
constexpr int MAX_NS = 7;                  // shared columns: nrow - 1

__device__ __forceinline__ bool nz4(const uint4 a) {
  return (a.x | a.y | a.z | a.w) != 0u;
}

__device__ __forceinline__ uint32_t popc4(const uint4 a, const uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

struct Tables {
  const int32_t* bm;
  int32_t v;
  const int32_t* core;
  int32_t c;
  int32_t words;
};

// Row `id` of column `col`'s table (bm for columns 0 and 1, else core), or
// null when id lies outside it.
__device__ __forceinline__ const uint4* row_of(const Tables& tb, int col,
                                               int32_t id) {
  const bool is_bm = col < 2;
  const int32_t lim = is_bm ? tb.v : tb.c;
  if (id < 0 || id >= lim) return nullptr;
  return reinterpret_cast<const uint4*>((is_bm ? tb.bm : tb.core) +
                                        int64_t(id) * tb.words);
}

template <int NS>
__global__ void __launch_bounds__(gm::BLOCK)
lo_popcount_kernel(Tables tb, const int32_t* __restrict__ shared, int32_t vc,
                   const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ vary, int32_t n_runs,
                   long long* __restrict__ partials) {
  const int gl = threadIdx.x % G;
  const int chunks = tb.words >> 2;
  unsigned long long acc = 0;
  for (int32_t run = blockIdx.x * GROUPS + threadIdx.x / G; run < n_runs;
       run += gridDim.x * GROUPS) {
    const int32_t a = __ldg(starts + run), e = __ldg(starts + run + 1);
    int32_t x[UT];
#pragma unroll
    for (int k = 0; k < UT; ++k) x[k] = a + k < e ? __ldg(vary + a + k) : -1;
    const uint4* rows[NS];
    bool ok = true;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      rows[j] = row_of(tb, j < vc ? j : j + 1,
                       __ldg(shared + int64_t(run) * NS + j));
      ok = ok && rows[j] != nullptr;
    }
    if (!ok) continue;                   // the same for every lane of a run
    for (int q0 = 0; q0 < chunks; q0 += G * QL) {
      uint4 z[QL];
#pragma unroll
      for (int i = 0; i < QL; ++i) {
        const int q = q0 + gl + i * G;
        z[i] = make_uint4(0u, 0u, 0u, 0u);
        if (q < chunks) {
          z[i] = __ldg(rows[0] + q);
#pragma unroll
          for (int j = 1; j < NS; ++j) {
            const uint4 y = __ldg(rows[j] + q);
            z[i].x &= y.x;
            z[i].y &= y.y;
            z[i].z &= y.z;
            z[i].w &= y.w;
          }
        }
      }
      for (int32_t u0 = a; u0 < e; u0 += UT) {
        int32_t xs[UT];
#pragma unroll
        for (int k = 0; k < UT; ++k)
          xs[k] = u0 == a && q0 == 0 ? x[k]
                                     : (u0 + k < e ? __ldg(vary + u0 + k) : -1);
#pragma unroll
        for (int k = 0; k < UT; ++k) {
          const bool okx = (vc < 2 ? xs[k] < tb.v : xs[k] < tb.c) && xs[k] >= 0;
          if (!okx) continue;
          const uint4* vr = reinterpret_cast<const uint4*>(
              (vc < 2 ? tb.bm : tb.core) + int64_t(xs[k]) * tb.words);
#pragma unroll
          for (int i = 0; i < QL; ++i) {
            const int q = q0 + gl + i * G;
            if (q < chunks && nz4(z[i])) acc += popc4(z[i], __ldg(vr + q));
          }
        }
      }
    }
  }
  gm::block_sum_store(acc, partials);
}

template <int NS>
int blocks_of() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lo_popcount_kernel<NS>, gm::BLOCK, 0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

}  // namespace

// Blocks of one full wave of the persistent grid for ns shared columns:
// SMs x resident blocks; a negative CUDA error on failure.
extern "C" int gm_lo_popcount_blocks(int64_t ns) {
  switch (ns) {
    case 1: return blocks_of<1>();
    case 2: return blocks_of<2>();
    case 3: return blocks_of<3>();
    case 4: return blocks_of<4>();
    case 5: return blocks_of<5>();
    case 6: return blocks_of<6>();
    case MAX_NS: return blocks_of<MAX_NS>();
    default: return -int(cudaErrorInvalidValue);
  }
}

// bm: int32 [v, words]; core: int32 [c, words]; words % 4 == 0 and both
// tables 16-byte aligned; shared: int32 [runs, ns], ns = nrow - 1, 1 <= ns
// <= 7, the columns other than vc (0 <= vc <= ns); starts: int32 [runs + 1];
// vary: int32 [n]; runs >= 1; partials: int64 [n_blocks]. Returns a
// cudaError_t.
extern "C" int gm_lo_popcount(const void* bm, int64_t v, const void* core,
                              int64_t c, int64_t words, const void* shared,
                              int64_t ns, int64_t vc, const void* starts,
                              const void* vary, int64_t n_runs,
                              void* partials, int64_t n_blocks,
                              void* stream) {
  Tables tb;
  tb.bm = static_cast<const int32_t*>(bm);
  tb.v = int32_t(v);
  tb.core = static_cast<const int32_t*>(core);
  tb.c = int32_t(c);
  tb.words = int32_t(words);
  const auto sh = static_cast<const int32_t*>(shared);
  const auto st = static_cast<const int32_t*>(starts);
  const auto va = static_cast<const int32_t*>(vary);
  const auto out = static_cast<long long*>(partials);
  const auto grid = unsigned(n_blocks);
  const auto strm = static_cast<cudaStream_t>(stream);
  const int32_t vc_ = int32_t(vc), nr = int32_t(n_runs);
  switch (ns) {
#define GM_LO_CASE(NS)                                                      \
    case NS:                                                                \
      lo_popcount_kernel<NS><<<grid, gm::BLOCK, 0, strm>>>(tb, sh, vc_, st, \
                                                           va, nr, out);    \
      break;
    GM_LO_CASE(1)
    GM_LO_CASE(2)
    GM_LO_CASE(3)
    GM_LO_CASE(4)
    GM_LO_CASE(5)
    GM_LO_CASE(6)
    GM_LO_CASE(7)
#undef GM_LO_CASE
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
