// Kernel H — per-edge 3-walk support over per-list column counts, for the
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
// with L the whole row and the tasks (u, v) in CSR order (list rows ~500
// and task rows ~850 set bits of 4,096 on average at rmat18), and with L =
// FT, the sub-core prefix, and the tasks (v, u) sorted by v (~56 and
// ~146). An id outside [0, v) adds 0, as a or b or in a list. out is
// int32 [n], zero on entry.
//
// Bound: bytes — each task's ids and result, each distinct list and each
// distinct table row read once. Design (ops/cuda_house.py::plan_house cuts
// the work into items: a piece of consecutive tasks of one run of equal a
// with its whole list, heaviest first):
//
// * A block item holds C_a as int32 counts in shared memory, one
//   4,096-column stretch at a time, so that every task of the piece is
//   dotted once, however long the list (the first design cut lists into
//   segments of 1,024 slots and dotted a piece once a segment). The eight
//   warps split the list evenly, at most 32 rows a warp a turn. With the
//   sparse view (nbc: the set bits of tab[x] are the last nbc[x] ids of
//   CSR row x, less cs) a row adds the columns of its ids, the batch's ids
//   walked flat across the warp, 4 B an id and no table row; without it a
//   row is read from the table, four rows' loads in flight, and each lane
//   adds the set bits of its 16-byte chunk by shared-memory atomics. Then
//   the warps split the tasks, four a turn: with the view a task sums the
//   counts at its ids, eight lanes a task; without it, at the set bits of
//   its row, read by the whole warp. No popcount and no bit plane: the
//   counts are read where a row has a bit. (Deriving planes from the
//   counts for dense rows, building them there, or reading the rows above
//   some set-bit count from the table lost on the card: PERF.md.)
// * A warp item (a list whose rows hold more than cuda_house.LIST_SPARSE
//   set bits on average) is the first design: one warp builds C_a
//   bit-sliced in planes of registers over a segment of fewer than 2^NP
//   slots, 8 rows a turn through W's carry-save adders (gm::add_eight),
//   and dots each task's chunks against the planes, reducing the four
//   words of a plane and the carries from the plane below to one word by
//   full adders (np + 3 popcounts a lane instead of 4 np).
//
// Two instantiations: a plan of block items alone (the house engine's
// second call) runs the kernel without warp items, whose fewer registers
// let more blocks share an SM; any other plan the kernel with them.
//
// Each task's sum goes into out[t] by one atomic when it is not 0. No
// float anywhere: every sum is an integer.
#include "common.cuh"

#ifndef H_MIN_BLOCKS_WARP
#define H_MIN_BLOCKS_WARP 3   // blocks an SM, the kernel with warp items
#endif
#ifndef H_MIN_BLOCKS_BLOCK
#define H_MIN_BLOCKS_BLOCK 3  // blocks an SM, the kernel without
#endif

namespace {

constexpr int TURN = 4;          // tasks a warp takes together
constexpr int WARPS = gm::BLOCK / 32;
constexpr int STRETCH = 4096;    // columns a block item counts at a time
constexpr int GROUP = 8;         // lanes of a task's id walk

struct Args {
  const int64_t* rowptr;
  const int32_t* colidx;
  const uint4* tab;
  int32_t v, quads;              // rows, 16-byte chunks a row
  const int32_t* a;
  const int32_t* b;
  const int4* items;             // (first task, tasks, first slot, slots)
  int32_t n_block, n_items, n_units;
  const int32_t* nbc;            // the sparse view, or null
  int32_t cs;
  int32_t* out;
};

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

// The set bits of lane l's chunk r (the stretch's columns 128 l ..
// 128 l + 127): f(column) for each. Each word is walked from bit l on, so
// the lanes of a warp touch 32 different banks at each step.
template <typename F>
__device__ __forceinline__ void for_bits(const uint4& r, int lane, F f) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t w = __funnelshift_r(word_of(r, e), word_of(r, e), lane);
    const int base = 32 * (4 * lane + e);
    while (w) {
      f(base + ((__ffs(w) - 1 + lane) & 31));
      w &= w - 1;
    }
  }
}

// Shared memory of a block: the stretch's counts and, per warp, the flat
// walk's row starts and offsets.
struct Shared {
  int32_t cnt[STRETCH];
  int64_t start[WARPS][32];
  int32_t first[WARPS][33];
};

// One warp's part of a block item's build over the stretch whose first
// column is col0: list slots [0, ns) of ids, batches of `per` slots (the
// list split evenly over the warps, at most 32 a batch) w, w + 8, ...
// With the view a row adds the columns of its ids, the batch's ids walked
// flat across the warp; without it a row, read from the table, adds its
// set bits, four rows' loads in flight.
__device__ void build_part(const Args& g, Shared& sh, const int32_t* ids,
                           int32_t ns, int32_t q0, int32_t col0, int warp,
                           int lane) {
  const int32_t q = q0 + lane;
  const bool on = q < g.quads;
  const int32_t cols = min(STRETCH, 32 * 4 * (g.quads - q0));
  const int32_t per = min(32, max(1, (ns + WARPS - 1) / WARPS));
  for (int32_t s = per * warp; s < ns; s += per * WARPS) {
    const int32_t x = lane < per && s + lane < ns ? __ldg(ids + s + lane)
                                                  : -1;
    const bool ok = x >= 0 && x < g.v;
    if (g.nbc) {
      // row l's ids are the flat positions [first[l], first[l + 1])
      const int32_t k = ok ? __ldg(g.nbc + x) : 0;
      int32_t incl = k;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(gm::FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      sh.first[warp][lane + 1] = incl;
      if (lane == 0) sh.first[warp][0] = 0;
      sh.start[warp][lane] = k ? __ldg(g.rowptr + x + 1) - k : 0;
      __syncwarp();
      const int32_t total = __shfl_sync(gm::FULL_MASK, incl, 31);
      int r = 0;
      for (int32_t j0 = 0; j0 < total; j0 += 32 * 4) {
        int64_t pos[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int32_t j = j0 + 32 * u + lane;
          pos[u] = -1;
          if (j < total) {
            while (sh.first[warp][r + 1] <= j) ++r;
            pos[u] = sh.start[warp][r] + (j - sh.first[warp][r]);
          }
        }
        int32_t c[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          c[u] = pos[u] >= 0 ? __ldg(g.colidx + pos[u]) - g.cs - col0 : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c[u] >= 0 && c[u] < cols) atomicAdd(sh.cnt + c[u], 1);
      }
      __syncwarp();
      continue;
    }
    uint32_t rows = __ballot_sync(gm::FULL_MASK, ok);
    while (rows) {
      uint4 r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = rows ? __ffs(rows) - 1 : 0;
        const int32_t xk = rows ? __shfl_sync(gm::FULL_MASK, x, l) : -1;
        rows &= rows - 1;
        r[k] = chunk_of(g.tab, g.v, g.quads, xk, q, on);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        for_bits(r[k], lane, [&](int c) { atomicAdd(sh.cnt + c, 1); });
    }
  }
}

// One warp's part of a block item's dot over the stretch: tasks t0 + 4w,
// + 4 + 32, ... four a turn. With the view a task sums the counts at its
// ids, eight lanes a task; without it, at the set bits of its row, read
// from the table by the whole warp, the turn's rows loaded together.
__device__ void dot_part(const Args& g, const Shared& sh, int32_t t0,
                         int32_t t_end, int32_t q0, int32_t col0, int warp,
                         int lane) {
  const int grp = lane / GROUP, sub = lane % GROUP;
  const int32_t cols = min(STRETCH, 32 * 4 * (g.quads - q0));
  for (int32_t t = t0 + TURN * warp; t < t_end; t += TURN * WARPS) {
    const int32_t tg = t + grp;
    const int32_t y = tg < t_end ? __ldg(g.b + tg) : -1;
    const bool ok = y >= 0 && y < g.v;
    if (g.nbc) {
      const int32_t k = ok ? __ldg(g.nbc + y) : 0;
      const int32_t* ids = g.colidx + (ok ? __ldg(g.rowptr + y + 1) - k : 0);
      uint32_t sum = 0;
      for (int32_t j = sub; j < k; j += GROUP * 4) {
        int32_t c[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          c[u] = j + GROUP * u < k
                     ? __ldg(ids + j + GROUP * u) - g.cs - col0 : -1;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c[u] >= 0 && c[u] < cols) sum += uint32_t(sh.cnt[c[u]]);
      }
#pragma unroll
      for (int o = GROUP / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(gm::FULL_MASK, sum, o);
      if (sub == 0 && sum) atomicAdd(g.out + tg, int32_t(sum));
      continue;
    }
    const uint32_t rows = __ballot_sync(gm::FULL_MASK, sub == 0 && ok);
    if (!rows) continue;
    uint4 r[TURN];
#pragma unroll
    for (int k = 0; k < TURN; ++k) {
      const int32_t yk = __shfl_sync(gm::FULL_MASK, y, GROUP * k);
      r[k] = chunk_of(g.tab, g.v, g.quads,
                      (rows >> (GROUP * k)) & 1u ? yk : -1, q0 + lane,
                      q0 + lane < g.quads);
    }
#pragma unroll
    for (int k = 0; k < TURN; ++k) {
      if (!((rows >> (GROUP * k)) & 1u)) continue;
      uint32_t s = 0;
      for_bits(r[k], lane, [&](int c) { s += uint32_t(sh.cnt[c]); });
      s = __reduce_add_sync(gm::FULL_MASK, s);
      if (lane == 0 && s) atomicAdd(g.out + t + k, int32_t(s));
    }
  }
}

__device__ void block_item(const Args& g, Shared& sh, const int4 it,
                           int warp, int lane) {
  const int32_t* ids = g.colidx + (__ldg(g.rowptr + __ldg(g.a + it.x)) + it.z);
  for (int32_t q0 = 0; q0 < g.quads; q0 += 32) {
    const int32_t col0 = 32 * 4 * q0;
    int4* c4 = reinterpret_cast<int4*>(sh.cnt);
    for (int i = threadIdx.x; i < STRETCH / 4; i += gm::BLOCK)
      c4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    build_part(g, sh, ids, it.w, q0, col0, warp, lane);
    __syncthreads();
    dot_part(g, sh, it.x, it.x + it.y, q0, col0, warp, lane);
    __syncthreads();
  }
}

constexpr int NP = 11;           // a warp item's planes: slots < 2^NP

// sum over the 128 columns of chunk r of bit c times C_a[c], C_a in the
// planes p[e][0:np] of word e: at weight 2^i the four words p[e][i] & w_e
// and three carry words from the plane below reduced by three full adders
// to one word of weight 2^i and three carries into the next.
__device__ __forceinline__ uint32_t chunk_dot(const uint32_t (&p)[4][NP],
                                              const uint4& r, int np) {
  uint32_t s = 0, c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i < np) {
      uint32_t h1, l1, h2, l2, h3, l3;
      gm::csa(h1, l1, p[0][i] & r.x, p[1][i] & r.y, p[2][i] & r.z);
      gm::csa(h2, l2, p[3][i] & r.w, c0, c1);
      gm::csa(h3, l3, l1, l2, c2);
      s += uint32_t(__popc(l3)) << i;
      c0 = h1;
      c1 = h2;
      c2 = h3;
    }
  }
  return s + ((uint32_t(__popc(c0)) + __popc(c1) + __popc(c2)) << np);
}

// A warp item: planes in registers over the item's slots (fewer than
// 2^NP), 8 rows a turn through W's carry-save adders, and each task
// dotted against them, TURN tasks a turn.
__device__ void warp_item(const Args& g, const int4 it, int lane) {
  const int32_t* ids = g.colidx + (__ldg(g.rowptr + __ldg(g.a + it.x)) + it.z);
  const int32_t t_end = it.x + it.y;
  const int np = 32 - __clz(it.w);
  for (int32_t q0 = 0; q0 < g.quads; q0 += 32) {
    const int32_t q = q0 + lane;
    const bool on = q < g.quads;
    uint32_t p[4][NP];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < NP; ++i) p[e][i] = 0u;
    int32_t s = 0;
    for (; s + 8 <= it.w; s += 8) {           // eight slots' loads in flight
      int32_t x[8];
      uint4 r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __ldg(ids + s + k);
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = chunk_of(g.tab, g.v, g.quads, x[k],
                                                   q, on);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = word_of(r[k], e);
        gm::add_eight(p[e], w);
      }
    }
    for (; s < it.w; ++s) {
      const uint4 r = chunk_of(g.tab, g.v, g.quads, __ldg(ids + s), q, on);
#pragma unroll
      for (int e = 0; e < 4; ++e) gm::add_word(p[e], word_of(r, e));
    }
    for (int32_t t = it.x; t < t_end; t += TURN) {
      uint4 r[TURN];
#pragma unroll
      for (int k = 0; k < TURN; ++k)
        r[k] = t + k < t_end ? chunk_of(g.tab, g.v, g.quads, __ldg(g.b + t + k),
                                        q, on)
                             : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < TURN; ++k) {
        const uint32_t sum =
            __reduce_add_sync(gm::FULL_MASK, chunk_dot(p, r[k], np));
        if (lane == k && sum) atomicAdd(g.out + t + k, int32_t(sum));
      }
    }
  }
}

// Units: unit u < n_block is block item u; unit n_block + i holds warp
// items n_block + 8 i .. + 7, one a warp. Two instantiations, each with
// the registers it needs: kWarp for a plan with warp items, and one
// without them (fewer registers, more blocks an SM) for a plan of block
// items alone.
template <bool kWarp>
__device__ __forceinline__ void run_units(const Args& g, Shared& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int32_t u = blockIdx.x; u < g.n_units; u += gridDim.x) {
    if (!kWarp || u < g.n_block) {
      block_item(g, sh, __ldg(g.items + u), warp, lane);
    } else {
      const int32_t i = g.n_block + (u - g.n_block) * WARPS + warp;
      if (i < g.n_items) warp_item(g, __ldg(g.items + i), lane);
    }
  }
}

__global__ void __launch_bounds__(gm::BLOCK, H_MIN_BLOCKS_WARP)
house_t3_kernel(Args g) {
  __shared__ __align__(16) Shared sh;
  run_units<true>(g, sh);
}

__global__ void __launch_bounds__(gm::BLOCK, H_MIN_BLOCKS_BLOCK)
house_t3_block_kernel(Args g) {
  __shared__ __align__(16) Shared sh;
  run_units<false>(g, sh);
}

}  // namespace

// rowptr: int64 [v + 1]; colidx: int32 [nnz]; tab: int32 [v, words], words
// a multiple of 4, 16-byte aligned; a, b: int32 [n]; items: int32 [m, 4]
// from plan_house, the n_block block items first (every item's a in [0,
// v), its slots inside L(a), its tasks in [0, n); a warp item's slots
// fewer than 2^NP); nbc: int32 [v] or null, the sparse view (the set bits
// of tab[x] are the last nbc[x] ids of CSR row x, less cs), which a block
// item walks instead of table rows; out: int32 [n], zero. A plan of block
// items alone launches the kernel without warp items. Returns a
// cudaError_t.
extern "C" int gm_house_t3(const void* rowptr, const void* colidx,
                           const void* tab, int64_t v, int64_t words,
                           const void* a, const void* b, const void* items,
                           int64_t n_block, int64_t m, const void* nbc,
                           int64_t cs, void* out, int64_t n_blocks,
                           void* stream) {
  Args g;
  g.rowptr = static_cast<const int64_t*>(rowptr);
  g.colidx = static_cast<const int32_t*>(colidx);
  g.tab = static_cast<const uint4*>(tab);
  g.v = int32_t(v);
  g.quads = int32_t(words / 4);
  g.a = static_cast<const int32_t*>(a);
  g.b = static_cast<const int32_t*>(b);
  g.items = static_cast<const int4*>(items);
  g.n_block = int32_t(n_block);
  g.n_items = int32_t(m);
  g.n_units = int32_t(n_block + (m - n_block + WARPS - 1) / WARPS);
  g.nbc = static_cast<const int32_t*>(nbc);
  g.cs = int32_t(cs);
  g.out = static_cast<int32_t*>(out);
  if (n_block == m)
    house_t3_block_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
  else
    house_t3_kernel<<<unsigned(n_blocks), gm::BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(g);
  return int(cudaGetLastError());
}
