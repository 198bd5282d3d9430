// Kernel B — ring phase C and the phase-T bitmap pass, one launch over
// every bucket of a layout.
//
// Port of the Pallas kernel graphminer_tpu/ops/pallas_ring.py::_kernel
// (and of its XLA twin ops/ring.py::_cbucket_partials). A bucket holds a
// row table table[n_table, words], src bitmaps src[n, words] and slots
// dloc[n, wc]; its count is
//   sum_r sum_s popcount(src[r] & table[dloc[r, s]])
// where a slot outside [0, n_table) (SENTINEL padding) gives 0. Phase C
// passes the 4096-row core table; the phase-T bitmap pass passes the dense
// bm_table, so each bucket record carries its own table and height.
//
// Bound: the bytes each input must move, each distinct table row once
// (199 MB at rmat18, 0.059 ms at 3.35 TB/s). The first design read one
// whole 512-byte table row per task (1.94 GB per count through L2), so it
// ran at the L2's rate, not HBM's: cutting the bytes per task is the lever.
// Design: the words are cut into slices of 8 (one 32-byte sector). The
// planner (ops/cuda_ring.py::plan_phase_c, once per layout) lists the work
// items, slice-major: a (src row, slice) pair whose src slice is non-zero,
// with a run of at most PIECE of the row's slots (up to the last valid
// slot). A task is then one sector of the src row ANDed with the same
// sector of the table row, for the sectors where the src row has bits:
//  * a table of at most STAGE_ROWS rows (the core) has its slice staged in
//    shared memory (4096 rows x 32 B = 128 KB), so table reads never reach
//    L2; the two 16-byte halves of a staged row are swizzled by bit 2 of
//    the row id, so a quarter warp's rows spread over all eight 16-byte
//    bank groups, not four;
//  * a larger table (bm_table, 80 MB at rmat18, larger than L2) is read one
//    sector a task; in slice-major order one slice of it (5 MB) is what is
//    hot, and that fits L2.
// The planner cuts the item list into one contiguous range of equal work
// per block of a persistent grid (SMs x resident blocks), split where the
// (bucket, slice) changes, a slot of an unstaged table weighing what it
// was measured to cost (DIRECT_COST); a block so stages a slice about
// twice, not once per tile. A warp takes 32 items at a time, scans their
// run lengths, and walks the concatenated slots 64 a step (two per lane),
// finding each slot's item with a ballot and a reduce-or, so rows with 1
// slot and rows with 64 share the lanes. Every block writes one int64
// partial.
// What bounds it now: phase C's bytes come from shared memory, so its
// arithmetic (8 popcounts a slot, at a quarter of the integer rate) and the
// staged reads' bank conflicts bound it, not L2; the bitmap pass waits on
// its table sectors from L2 and HBM (PERF.md, section 5).
#include "common.cuh"

namespace {

constexpr int NT = 1024;                   // threads a block
constexpr int SLICE = 8;                   // ops/cuda_ring.py::SLICE
constexpr int BREC = 7;                    // ops/cuda_ring.py::PHASE_C_BREC
constexpr int TREC = 4;                    // ops/cuda_ring.py::PHASE_C_TREC
constexpr int LEN_BITS = 8;                // ops/cuda_ring.py::LEN_BITS
constexpr int U = 2;                       // slots a lane per step

__device__ __forceinline__ uint32_t and_popc(const uint4 a0, const uint4 a1,
                                             const uint4 b0, const uint4 b1) {
  return __popc(a0.x & b0.x) + __popc(a0.y & b0.y) + __popc(a0.z & b0.z) +
         __popc(a0.w & b0.w) + __popc(a1.x & b1.x) + __popc(a1.y & b1.y) +
         __popc(a1.z & b1.z) + __popc(a1.w & b1.w);
}

__global__ void __launch_bounds__(NT, 1)
ring_phase_c_kernel(const long long* __restrict__ buckets,
                    const long long* __restrict__ tiles,
                    const long long* __restrict__ block_tiles,
                    const int2* __restrict__ items,
                    long long* __restrict__ partials) {
  extern __shared__ uint4 stage[];         // [rows][2] swizzled halves
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned upto = gm::FULL_MASK >> (31 - lane);     // lanes 0..lane
  unsigned long long acc = 0;
  const uint32_t* st_table = nullptr;
  int st_slice = -1;
  const long long t_end = __ldg(block_tiles + blockIdx.x + 1);
  for (long long t = __ldg(block_tiles + blockIdx.x); t < t_end; ++t) {
    const long long* tr = tiles + t * TREC;
    const long long* br = buckets + __ldg(tr) * BREC;
    const int slice = int(__ldg(tr + 1));
    const int2* it = items + __ldg(tr + 2);
    const int32_t count = int32_t(__ldg(tr + 3));
    const uint32_t* table = reinterpret_cast<const uint32_t*>(__ldg(br));
    const int32_t n_table = int32_t(__ldg(br + 1));
    const uint32_t* src = reinterpret_cast<const uint32_t*>(__ldg(br + 2));
    const int32_t* dloc = reinterpret_cast<const int32_t*>(__ldg(br + 3));
    const int32_t words = int32_t(__ldg(br + 4));
    const int32_t wc = int32_t(__ldg(br + 5));
    const bool staged = __ldg(br + 6) != 0;        // uniform in the block
    const int col = slice * SLICE;
    if (staged && (table != st_table || slice != st_slice)) {
      __syncthreads();                  // the last slice's readers are done
      for (int i = threadIdx.x; i < 2 * n_table; i += NT) {
        const int r = i >> 1, h = i & 1;
        stage[2 * r + (h ^ ((r >> 2) & 1))] = __ldg(
            reinterpret_cast<const uint4*>(table + int64_t(r) * words + col)
            + h);
      }
      __syncthreads();
      st_table = table;
      st_slice = slice;
    }
    for (int32_t i0 = warp * 32; i0 < count; i0 += NT) {
      int32_t row = 0, off = 0, len = 0;
      if (i0 + lane < count) {
        const int2 v = __ldg(it + i0 + lane);
        row = v.x;
        off = v.y >> LEN_BITS;
        len = v.y & ((1 << LEN_BITS) - 1);
      }
      int32_t inc = len;                            // inclusive scan of len
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(gm::FULL_MASK, inc, o);
        if (lane >= o) inc += y;
      }
      const int32_t total = __shfl_sync(gm::FULL_MASK, inc, 31);
      const int32_t start = inc - len;
      for (int32_t base = 0; base < total; base += 32 * U) {
        int32_t idx[U];
        uint4 a[U][2];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // the item holding slot w0 + lane: the items that start before
          // the window, plus those that start in it at or below the lane
          const int32_t w0 = base + 32 * u, d = start - w0;
          const unsigned before =
              __ballot_sync(gm::FULL_MASK, len > 0 && d < 0);
          const unsigned mark = __reduce_or_sync(
              gm::FULL_MASK, len > 0 && d >= 0 && d < 32 ? 1u << d : 0u);
          const int k = (__popc(before) + __popc(mark & upto) - 1) & 31;
          const int32_t kr = __shfl_sync(gm::FULL_MASK, row, k);
          const int32_t ko = __shfl_sync(gm::FULL_MASK, off, k);
          const int32_t ks = __shfl_sync(gm::FULL_MASK, start, k);
          const bool live = w0 + lane < total;
          idx[u] = live ? __ldg(dloc + int64_t(kr) * wc + ko + (w0 + lane - ks))
                        : -1;
          const uint4* sp =
              reinterpret_cast<const uint4*>(src + int64_t(kr) * words + col);
          a[u][0] = live ? __ldg(sp) : uint4{};
          a[u][1] = live ? __ldg(sp + 1) : uint4{};
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int32_t x = idx[u];
          if (x < 0 || x >= n_table) continue;
          uint4 b0, b1;
          if (staged) {
            const int sw = (x >> 2) & 1;
            b0 = stage[2 * x + sw];
            b1 = stage[2 * x + (sw ^ 1)];
          } else {
            const uint4* tp = reinterpret_cast<const uint4*>(
                table + int64_t(x) * words + col);
            b0 = __ldg(tp);
            b1 = __ldg(tp + 1);
          }
          acc += and_popc(a[u][0], a[u][1], b0, b1);
        }
      }
    }
  }
  gm::block_sum_store<NT>(acc, partials);
}

size_t smem_bytes(int64_t stage_rows) {
  return size_t(stage_rows) * 2 * sizeof(uint4);
}

int set_smem(int64_t stage_rows) {
  return int(cudaFuncSetAttribute(ring_phase_c_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem_bytes(stage_rows))));
}

}  // namespace

// Blocks of one full wave of the persistent grid when a block stages
// `stage_rows` table rows of one slice: SMs x resident blocks; a negative
// CUDA error on failure.
extern "C" int gm_ring_phase_c_blocks(int64_t stage_rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaError_t(set_smem(stage_rows));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_phase_c_kernel, NT, smem_bytes(stage_rows));
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// buckets: int64 [n_buckets, BREC]; tiles: int64 [n_tiles, TREC];
// block_tiles: int64 [n_blocks + 1], block b walks tiles [block_tiles[b],
// block_tiles[b + 1]); items: int32 [n_items, 2] (row, off << LEN_BITS |
// len) (ops/cuda_ring.py::plan_phase_c). Rows are 16-byte aligned, words a
// multiple of SLICE; stage_rows: the most rows of any staged table;
// partials: int64 [n_blocks].
extern "C" int gm_ring_phase_c(const void* buckets, const void* tiles,
                               const void* block_tiles, const void* items,
                               int64_t stage_rows, void* partials,
                               int64_t n_blocks, void* stream) {
  const int e = set_smem(stage_rows);
  if (e != 0) return e;
  ring_phase_c_kernel<<<unsigned(n_blocks), NT, smem_bytes(stage_rows),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(buckets),
      static_cast<const long long*>(tiles),
      static_cast<const long long*>(block_tiles),
      static_cast<const int2*>(items), static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
