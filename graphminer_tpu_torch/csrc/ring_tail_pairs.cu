// Kernel C — ring tail pairs, one launch over every tail-compare bucket.
//
// Replaces graphminer_tpu/ops/ring.py::_tail_pairs_partials (an XLA
// gather + broadcast compare, one per tbucket inside the one dispatch of
// _ring_partials). For every task i of a bucket it takes the rows ta[sa[i]]
// (width wa) and tb[sb[i]] (width wb) of two per-class tail tables — each
// sorted ascending, SENTINEL padded, with no repeated id — and counts the
// non-SENTINEL ids they share. A slot outside its table's rows gives 0.
//
// Bound: the bytes are small (the slots and each distinct tail row once,
// 12 MB at rmat18: 3.6 us at 3.35 TB/s); what bounds the kernel is latency,
// the dependent loads of the binary searches, and, before this design, the
// host dispatch of one launch per bucket.
// Design: one persistent grid walks a tile table built once per layout
// (ops/_tiles.py, ops/cuda_ring.py::plan_tail_pairs): equal tiles of 256
// tasks, none across a bucket, so the 16 rmat18 buckets cost one launch. A
// block first copies its tile's slot ids into shared memory (one latency a
// tile, not one a task). A group of g lanes (8 where the rows fit, 16 or 32
// for rows over 512 ids) then takes one task, so a warp takes 32 / g tasks
// a round: the group copies the task's tb row into the warp's slice of
// shared memory while each lane loads its ta ids (1, 2, 4 or 8 at a time,
// as wa / g asks), and each lane then searches its ids in the staged row in
// lockstep (gm::count_in_sorted), skipping the search when all its ids are
// SENTINEL padding; a round costs about one L2 latency and a few
// shared-memory reads.
//
// Tail handling: the planner picks g so that a warp's 32 / g rows fit its
// slice (rows up to 2048 wide); a bucket whose rows do not fit (a class
// ladder extended past 2048) is searched in place through L1, flagged per
// bucket. A tile's last round may hold fewer tasks than the warp has groups:
// those groups skip the task but still reach the warp's barriers. A bucket
// with no work (no task, wa or wb 0) has no tile.
#include "common.cuh"

namespace {

constexpr int WARPS = gm::BLOCK / 32;
constexpr int TILE = 256;                  // ops/cuda_ring.py::TAIL_TILE
constexpr int BREC = 10;                   // ops/cuda_ring.py::TAIL_BREC
constexpr int TREC = 4;                    // ops/_tiles.py::TREC

// One task's count for the lane at gl of its group of g: K ta ids a lane at
// a time (K = ceil(wa / g), at most 8), loaded before the group's tb row is
// staged in `mine` (when staged) so that both loads overlap, then searched
// in lockstep. Every lane of the warp calls it (it holds __syncwarp).
template <int K>
__device__ __forceinline__ uint32_t task_hits(
    bool ok, const int32_t* arow, int32_t wa, const int32_t* row, int32_t wb,
    int32_t* mine, bool staged, int gl, int g) {
  int32_t x[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int j = gl + u * g;
    x[u] = ok && j < wa ? __ldg(arow + j) : gm::SENTINEL;
  }
  if (staged) {
    if (ok) {
#pragma unroll 4
      for (int k = gl; k < wb; k += g) mine[k] = __ldg(row + k);
    }
    __syncwarp();
    row = mine;
  }
  uint32_t hits = 0;
  if (ok) {
    for (int j0 = 0;;) {
      bool any = false;                // ids other than SENTINEL padding
#pragma unroll
      for (int u = 0; u < K; ++u) any |= x[u] != gm::SENTINEL;
      if (any) hits += gm::count_in_sorted<K>(row, wb, x);
      j0 += K * g;
      if (j0 >= wa) break;             // wa > K g: the next K ids a lane
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int j = j0 + gl + u * g;
        x[u] = j < wa ? __ldg(arow + j) : gm::SENTINEL;
      }
    }
  }
  if (staged) __syncwarp();           // the row is read before it is replaced
  return hits;
}

__global__ void __launch_bounds__(gm::BLOCK)
ring_tail_pairs_kernel(const long long* __restrict__ buckets,
                       const long long* __restrict__ tiles, long long n_tiles,
                       int32_t region, long long* __restrict__ partials) {
  // [TILE] sa | [TILE] sb | [WARPS][region] staged tb rows
  extern __shared__ int32_t smem[];
  int32_t* sa_s = smem;
  int32_t* sb_s = smem + TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long acc = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long* tr = tiles + t * TREC;
    const long long* br = buckets + __ldg(tr) * BREC;
    const long long first = __ldg(tr + 1);
    const int32_t count = int32_t(__ldg(tr + 2));
    const int32_t* ta = reinterpret_cast<const int32_t*>(__ldg(br));
    const int32_t na = int32_t(__ldg(br + 1)), wa = int32_t(__ldg(br + 2));
    const int32_t* tb = reinterpret_cast<const int32_t*>(__ldg(br + 3));
    const int32_t nb = int32_t(__ldg(br + 4)), wb = int32_t(__ldg(br + 5));
    const int32_t* sa = reinterpret_cast<const int32_t*>(__ldg(br + 6));
    const int32_t* sb = reinterpret_cast<const int32_t*>(__ldg(br + 7));
    const int g = int(__ldg(br + 8));                    // 8, 16 or 32
    const bool staged = __ldg(br + 9) != 0;        // uniform in the block
    const int k = (wa + g - 1) / g;                      // ta ids a lane
    __syncthreads();             // the last tile's readers of sa_s are done
    for (int i = threadIdx.x; i < count; i += gm::BLOCK) {
      sa_s[i] = __ldg(sa + first + i);
      sb_s[i] = __ldg(sb + first + i);
    }
    __syncthreads();
    const int tpw = 32 / g, grp = lane / g, gl = lane - grp * g;
    int32_t* mine = smem + 2 * TILE + warp * region + grp * wb;
    for (int32_t i0 = warp * tpw; i0 < count; i0 += WARPS * tpw) {
      const int32_t i = i0 + grp;
      const int32_t ia = i < count ? sa_s[i] : -1;
      const int32_t ib = i < count ? sb_s[i] : -1;
      const bool ok = ia >= 0 && ia < na && ib >= 0 && ib < nb;
      const int32_t* arow = ta + int64_t(ia) * wa;
      const int32_t* row = tb + int64_t(ib) * wb;
      if (k <= 1)
        acc += task_hits<1>(ok, arow, wa, row, wb, mine, staged, gl, g);
      else if (k == 2)
        acc += task_hits<2>(ok, arow, wa, row, wb, mine, staged, gl, g);
      else if (k <= 4)
        acc += task_hits<4>(ok, arow, wa, row, wb, mine, staged, gl, g);
      else
        acc += task_hits<8>(ok, arow, wa, row, wb, mine, staged, gl, g);
    }
  }
  gm::block_sum_store(acc, partials);
}

size_t smem_bytes(int64_t region) {
  return (2 * size_t(TILE) + size_t(WARPS) * size_t(region)) *
         sizeof(int32_t);
}

int set_smem(int64_t region) {
  return int(cudaFuncSetAttribute(ring_tail_pairs_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(smem_bytes(region))));
}

}  // namespace

// Blocks of one full wave of the persistent grid when each warp stages
// `region` ints: SMs x resident blocks; a negative CUDA error on failure.
extern "C" int gm_ring_tail_pairs_blocks(int64_t region) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaError_t(set_smem(region));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_tail_pairs_kernel, gm::BLOCK, smem_bytes(region));
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// buckets: int64 [n_buckets, BREC] records; tiles: int64 [n_tiles, TREC]
// (ops/cuda_ring.py::plan_tail_pairs); region: ints of shared memory per
// warp, at least (32 / g) * wb for every staged bucket; partials: int64
// [n_blocks].
extern "C" int gm_ring_tail_pairs(const void* buckets, const void* tiles,
                                  int64_t n_tiles, int64_t region,
                                  void* partials, int64_t n_blocks,
                                  void* stream) {
  const int e = set_smem(region);
  if (e != 0) return e;
  ring_tail_pairs_kernel<<<unsigned(n_blocks), gm::BLOCK, smem_bytes(region),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(buckets),
      static_cast<const long long*>(tiles), n_tiles, int32_t(region),
      static_cast<long long*>(partials));
  return int(cudaGetLastError());
}
