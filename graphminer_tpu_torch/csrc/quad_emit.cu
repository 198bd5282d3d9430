// Kernel Q — quad counting and emission for the large-clique engine's k = 6
// device path: one count launch over all of a count's triangle tasks, then
// one emit launch a chunk.
//
// Replaces the compaction of the XLA function
// graphminer_tpu/ops/cliquebig.py::_tri_expand_bilinear (:156-169: the
// bits of y2full[r] & C[c1] expanded by _expand_bits, a cumsum for every
// quad's position and a scatter; torch has no unpackbits or popcount). For
// a triangle task t (edge row erow[t], core id c1[t]) let
//
//   y = y2[erow[t]] & core[c1[t]]            (words read as uint32)
//
// restricted to bits c2 < n_bits. gm_quad_count writes popcount(y) a task
// (0 for a task whose erow or c1 lies outside its table); the engine scans
// those counts into off on the card (int64). gm_quad_emit writes every set
// bit of y, ascending, as one quad: r_out[o] = erow[t], cols_out[o] = (c1[t],
// c2), at o = off[t] - off[0] + j for the task's j-th bit. The quads are
// kernel G's gathered arguments at depth 2 (r, cols), so nothing crosses to
// the host between the count, Q and G.
//
// Bounds: bytes. Count: 4 + 4 B of ids and 4 B of count a task, each
// distinct y2 and core row read once. Emit: 4 + 4 + 8 B of ids and offset a
// task, each distinct row read once and 12 B written a quad. At 3.35 TB/s.
//
// Design. A y2 row (CB[a] & CB[b]) has about a dozen set bits, in one or
// two 16-byte groups of its 128 words (the high, hub ids; 1.3 groups a task
// at rmat13), and the engine's expander emits tasks edge-major with c1
// ascending, so runs of consecutive tasks share erow (12.8 a run at
// rmat13). A task is one core load's worth of work,
// so latency bounds both kernels: the design keeps many tasks' loads in
// flight at once. A warp takes a window of 32 consecutive tasks, lane i
// holding task i's ids, and the window a run at a time (run_window): the
// warp loads the run's y2 row once, lane l holding words [4 l, 4 l + 4)
// (one 16-byte load a lane, so a warp covers a 128-word row in one load;
// the wrapper refuses tables that are not 16-byte aligned), and ballots its
// non-zero 4-word groups; then the run's tasks go P lanes each (P = the number of
// groups, rounded up to a power of two), one lane a
// group, so 32 / P tasks read their core words at once, and only the words
// under a non-zero y2 group. A task's set bits in its earlier groups come
// from a scan over its P lanes. This departs from one warp a task with its
// y2 words kept across a run (the direction this redesign started from):
// that design loaded a task's core words one task after another and ran
// no faster on the rmat14 chunk than the first design's warp a task.
// * Count: the grid strides over windows; lane i stores task i's count,
//   so a window's counts go out in one coalesced store.
// * Emit: a block takes a tile of TILE = 256 consecutive tasks, a window a
//   warp. Each quad goes into a shared-memory staging buffer as
//   (task-local index << 24 | c2) at its offset in the tile's output range
//   (from off, so a task needs no block scan, and a task with no quad loads
//   nothing). The tile's range is contiguous, since off is monotone; the
//   block then writes it with consecutive 16-byte stores (4 r values, 2
//   cols pairs a store; scalar stores at the unaligned head and tail). The
//   buffer is aligned so that its index is the output index mod 4. A tile
//   with more quads than STAGE (a single task may have up to n_bits) is
//   staged in rounds of STAGE output slots; a task is recomputed in each
//   round its range overlaps. A TMA bulk store of the aligned middle was
//   not tried: the 16-byte stores are coalesced already.
// Both are exact for any task order (unsorted erow makes runs of one
// task; ids outside their tables count 0) and fast for the expander's.
#include "common.cuh"

namespace {

constexpr int WARPS = gm::BLOCK / 32;
constexpr int V = 4;                     // words a lane loads (16 bytes)
constexpr int TILE = gm::BLOCK;          // tasks a tile (emit block): 32 a warp
constexpr int STAGE = 8192;              // quads staged a round
static_assert(TILE <= 256, "the task-local index takes 8 bits");

// The bits of word w below n_bits.
__device__ __forceinline__ uint32_t bits_below(int32_t w, int32_t n_bits) {
  const int32_t left = n_bits - 32 * w;
  return left >= 32 ? gm::FULL_MASK : left <= 0 ? 0u : (1u << left) - 1u;
}

// Words [w, w + 4) of a row into x; 0 from nw on (the row's width is a
// multiple of 4, so a load that starts below nw stays inside the row).
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ row,
                                           int32_t w, int32_t nw,
                                           uint32_t (&x)[V]) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (w < nw) v = __ldg(reinterpret_cast<const uint4*>(row + w));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

// The position of the n-th set bit (from 0) of mask; n < popc(mask).
__device__ __forceinline__ int nth_set(uint32_t mask, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc((mask >> pos) & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      pos += w;
    }
  }
  return pos;
}

// One warp over a window of 32 tasks, lane i holding task i's ids (my_r,
// my_c), `on` for a task to compute and acc, the task's accumulator. The
// tasks are taken a run at a time: a run is every pending task of one
// erow, in lane order. The warp loads the run's y2 slab (V words a lane,
// below n_bits) and ballots its non-zero V-word groups (G of them); then
// lanes work in segments of P (G rounded up to a power of two), one
// segment a member task and one lane a group, so that 32 / P of the run's
// tasks read their core words at once. A lane with set bits calls
// visit(task lane, x, first word of x, slot) with x = y & core on its
// group's words and slot = the task's acc + the task's set bits in its
// earlier groups of this slab (EMIT only); after each step every member
// task adds its set bits of the step to acc. So acc ends as acc + the
// task's set bits, and slots go task-major, bit-ascending. Every lane of
// the warp must call it.
template <bool EMIT, typename Visit>
__device__ __forceinline__ void run_window(
    const uint32_t* __restrict__ y2, int64_t ldy,
    const uint32_t* __restrict__ core, int64_t ldc, int32_t nw,
    int32_t n_bits, int32_t my_r, int32_t my_c, bool on, long long& acc,
    Visit visit) {
  constexpr int SW = 32 * V;
  const int lane = threadIdx.x & 31;
  const int nslab = (nw + SW - 1) / SW;
  const uint32_t below = (1u << lane) - 1u;
  uint32_t todo = __ballot_sync(gm::FULL_MASK, on);
  while (todo) {
    const int32_t r = __shfl_sync(gm::FULL_MASK, my_r, __ffs(todo) - 1);
    const uint32_t members = __ballot_sync(gm::FULL_MASK, on && my_r == r);
    todo &= ~members;
    const int nm = __popc(members);
    const bool member = (members >> lane) & 1u;
    const int my_rank = __popc(members & below);   // this lane's member index
    const uint32_t* yr = y2 + int64_t(r) * ldy;
    for (int s = 0; s < nslab; ++s) {
      uint32_t y[V];
      load_words(yr, s * SW + lane * V, nw, y);
      uint32_t any = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        y[j] &= bits_below(s * SW + lane * V + j, n_bits);
        any |= y[j];
      }
      const uint32_t nz = __ballot_sync(gm::FULL_MASK, any != 0u);
      const int G = __popc(nz);
      if (G == 0) continue;                          // warp-uniform
      const int P = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8
                  : G <= 16 ? 16 : 32;
      const int per = 32 / P;                        // member tasks a step
      const int gr = lane & (P - 1);                 // this lane's group
      const int src = gr < G ? nth_set(nz, gr) : 0;  // the lane holding it
      uint32_t yg[V];
#pragma unroll
      for (int j = 0; j < V; ++j) yg[j] = __shfl_sync(gm::FULL_MASK, y[j], src);
      const int32_t wg = s * SW + src * V;           // the group's first word
      for (int base = 0; base < nm; base += per) {
        const int m = base + lane / P;               // this lane's member
        const bool act = m < nm && gr < G;
        const int tl = act ? nth_set(members, m) : 0;
        const int32_t c = __shfl_sync(gm::FULL_MASK, my_c, tl);
        uint32_t x[V];
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = 0u;
        if (act) {
          load_words(core + int64_t(c) * ldc, wg, nw, x);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            x[j] &= yg[j];
            cnt += __popc(x[j]);
          }
        }
        int incl = cnt;                              // scan over the segment
        for (int d = 1; d < P; d <<= 1) {
          const int v = __shfl_up_sync(gm::FULL_MASK, incl, d, P);
          if (gr >= d) incl += v;
        }
        if constexpr (EMIT) {
          const long long slot = __shfl_sync(gm::FULL_MASK, acc, tl);
          if (cnt) visit(tl, x, wg, slot + (incl - cnt));
        }
        // each member task of this step adds its segment's total
        const bool mine = member && my_rank >= base && my_rank < base + per;
        const int seg = mine ? (my_rank - base) * P + P - 1 : 0;
        const int tot = __shfl_sync(gm::FULL_MASK, incl, seg);
        if (mine) acc += tot;
      }
    }
  }
}

__global__ void __launch_bounds__(gm::BLOCK)
quad_count_kernel(const uint32_t* __restrict__ y2, int64_t ldy, int32_t ny,
                  const uint32_t* __restrict__ core, int64_t ldc, int32_t nc,
                  int32_t nw, int32_t n_bits,
                  const int32_t* __restrict__ erow,
                  const int32_t* __restrict__ c1, int64_t n_tasks,
                  int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t n_windows = (n_tasks + 31) / 32;
  for (int64_t g = int64_t(blockIdx.x) * WARPS + threadIdx.x / 32;
       g < n_windows; g += int64_t(gridDim.x) * WARPS) {
    const int64_t t = 32 * g + lane;
    const bool in = t < n_tasks;
    const int32_t my_r = in ? __ldg(erow + t) : -1;
    const int32_t my_c = in ? __ldg(c1 + t) : -1;
    const bool on = in && my_r >= 0 && my_r < ny && my_c >= 0 && my_c < nc;
    long long mine = 0;
    run_window<false>(y2, ldy, core, ldc, nw, n_bits, my_r, my_c, on,
                         mine,
                         [](int, const uint32_t (&)[V], int32_t, long long) {});
    if (in) counts[t] = int32_t(mine);
  }
}

__global__ void __launch_bounds__(gm::BLOCK)
quad_emit_kernel(const uint32_t* __restrict__ y2, int64_t ldy, int32_t ny,
                 const uint32_t* __restrict__ core, int64_t ldc, int32_t nc,
                 int32_t nw, int32_t n_bits,
                 const int32_t* __restrict__ erow,
                 const int32_t* __restrict__ c1,
                 const long long* __restrict__ off, int64_t n_tasks,
                 int32_t* __restrict__ r_out, int32_t* __restrict__ cols_out) {
  __shared__ __align__(16) uint32_t s_q[STAGE];
  __shared__ long long s_off[TILE + 1];
  __shared__ int32_t s_r[TILE], s_c[TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = __ldg(off);
  const int64_t n_tiles = (n_tasks + TILE - 1) / TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t t0 = tile * TILE;
    const int nt = n_tasks - t0 < TILE ? int(n_tasks - t0) : TILE;
    __syncthreads();                 // the last tile's writes are done
    for (int i = threadIdx.x; i <= nt; i += blockDim.x) {
      s_off[i] = __ldg(off + t0 + i) - first;
      if (i < nt) {
        s_r[i] = __ldg(erow + t0 + i);
        s_c[i] = __ldg(c1 + t0 + i);
      }
    }
    __syncthreads();
    const long long lo = s_off[0], hi = s_off[nt];
    const int u = 32 * warp + lane;  // this lane's task in the tile
    const bool in = u < nt;
    const int32_t my_r = in ? s_r[u] : -1, my_c = in ? s_c[u] : -1;
    const long long a = in ? s_off[u] : 0, b = in ? s_off[u + 1] : 0;
    const bool ok = in && a < b && my_r >= 0 && my_r < ny && my_c >= 0 &&
                    my_c < nc;
    // rounds of STAGE output slots, the first aligned down to 4
    for (long long R0 = lo & ~3ll; R0 < hi; R0 += STAGE) {
      const long long R1 = R0 + STAGE;
      long long o = a;               // the lane's task's next slot
      run_window<true>(
          y2, ldy, core, ldc, nw, n_bits, my_r, my_c, ok && b > R0 && a < R1,
          o, [&](int tl, const uint32_t (&x)[V], int32_t wg, long long p) {
            const int tu = 32 * warp + tl;
            const long long tb = s_off[tu + 1];
#pragma unroll
            for (int j = 0; j < V; ++j) {
              uint32_t bits = x[j];
              while (bits) {
                const int bit = __ffs(bits) - 1;
                bits &= bits - 1u;
                if (p >= R0 && p < R1 && p < tb)
                  s_q[p - R0] = (uint32_t(tu) << 24) |
                                uint32_t(32 * (wg + j) + bit);
                ++p;
              }
            }
          });
      __syncthreads();
      // the round's slots [ia, ib) of the buffer, output index R0 + i
      const int ia = int(max(R0, lo) - R0), ib = int(min(R1, hi) - R0);
      for (int g = (ia >> 2) + threadIdx.x; 4 * g < ib; g += blockDim.x) {
        const int i0 = 4 * g;
        const long long o0 = R0 + i0;          // a multiple of 4
        if (i0 >= ia && i0 + 4 <= ib) {
          const uint4 q = *reinterpret_cast<const uint4*>(s_q + i0);
          const uint32_t qs[4] = {q.x, q.y, q.z, q.w};
          int32_t rv[4], cv[4], c2v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            rv[k] = s_r[qs[k] >> 24];
            cv[k] = s_c[qs[k] >> 24];
            c2v[k] = int32_t(qs[k] & 0xFFFFFFu);
          }
          reinterpret_cast<int4*>(r_out + o0)[0] =
              make_int4(rv[0], rv[1], rv[2], rv[3]);
          int4* cp = reinterpret_cast<int4*>(cols_out + 2 * o0);
          cp[0] = make_int4(cv[0], c2v[0], cv[1], c2v[1]);
          cp[1] = make_int4(cv[2], c2v[2], cv[3], c2v[3]);
        } else {
          for (int i = max(i0, ia); i < min(i0 + 4, ib); ++i) {
            const uint32_t q = s_q[i];
            const long long oi = R0 + i;
            r_out[oi] = s_r[q >> 24];
            cols_out[2 * oi] = s_c[q >> 24];
            cols_out[2 * oi + 1] = int32_t(q & 0xFFFFFFu);
          }
        }
      }
      __syncthreads();               // the buffer is free for the next round
    }
  }
}

}  // namespace

// y2: int32 [ny, *] rows at stride ldy; core: int32 [nc, *] at stride ldc;
// both tables 16-byte aligned, their strides and width multiples of 4
// words; words read a row: nw (the wrapper's min(width, ceil(n_bits /
// 32))); erow, c1: int32 [n]; counts: int32 [n]; n >= 1. Returns a
// cudaError_t.
extern "C" int gm_quad_count(const void* y2, int64_t ldy, int64_t ny,
                             const void* core, int64_t ldc, int64_t nc,
                             int64_t nw, int64_t n_bits, const void* erow,
                             const void* c1, int64_t n, void* counts,
                             int64_t n_blocks, void* stream) {
  quad_count_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y2), ldy, int32_t(ny),
      static_cast<const uint32_t*>(core), ldc, int32_t(nc), int32_t(nw),
      int32_t(n_bits), static_cast<const int32_t*>(erow),
      static_cast<const int32_t*>(c1), n, static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

// As gm_quad_count, with off: int64 [n + 1]; r_out: int32 [off[n] - off[0]];
// cols_out: int32 [off[n] - off[0], 2], both 16-byte aligned; n_bits <=
// 2^24. Returns a cudaError_t.
extern "C" int gm_quad_emit(const void* y2, int64_t ldy, int64_t ny,
                            const void* core, int64_t ldc, int64_t nc,
                            int64_t nw, int64_t n_bits, const void* erow,
                            const void* c1, const void* off, int64_t n,
                            void* r_out, void* cols_out,
                            int64_t n_blocks, void* stream) {
  quad_emit_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(y2), ldy, int32_t(ny),
      static_cast<const uint32_t*>(core), ldc, int32_t(nc), int32_t(nw),
      int32_t(n_bits), static_cast<const int32_t*>(erow),
      static_cast<const int32_t*>(c1), static_cast<const long long*>(off),
      n, static_cast<int32_t*>(r_out), static_cast<int32_t*>(cols_out));
  return int(cudaGetLastError());
}
