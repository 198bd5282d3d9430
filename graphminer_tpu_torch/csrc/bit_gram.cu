// Kernel G — the bit Gram: sum_t y_t[i] * popcount(B[i] & y_t) a row i, on
// the int8 tensor cores, with no expanded row in device memory.
//
// Replaces the hi products of the JAX package, each an expansion by
// graphminer_tpu/ops/hubcore.py::_expand_bits and a dot_general:
// graphminer_tpu/ops/cliquek.py::_edge_hi_bilinear (:223, k = 4, plain
// rows), ::_tri_stream_bilinear (:243, k = 5, y2 & core_hi[c]),
// graphminer_tpu/ops/hubcore.py::_spoke_gemm_body (:263, the spoke) and
// later graphminer_tpu/ops/cliquebig.py::_chain_hi_bilinear (:106, depth
// 2+). For task t < n the packed row of hw words is kernel X's
//
//   y_t = base[row_t] & tab[c[t, 0]] & ... & tab[c[t, depth - 1]]
//
// (row_t = r[t], or t when r is null; an id outside its table, SENTINEL
// included, gives a zero row; words read as uint32). With Y the 0/1
// expansion of the rows [n, 32*hw] and B the 0/1 mask whose row i is bit i
// of the packed mask rows (rows i >= nm are zero), the result is
//
//   out[i] = sum_j B[i, j] (Y^T Y)[i, j]        (int64, i < 32*hw)
//
// Bound: the larger of the operations — 2 * nnz(B) * n int8 operations,
// the Gram entries the mask selects (utils/profiling.py::gram_bounds; the
// tiles walked give 2 * T^2 * n_tiles * n, the design's own work) — over
// the int8 peak, and the bytes — the task ids, each distinct packed row
// read once and the partials — over 3.35 TB/s.
// Design:
// - Only the tiles that matter. The wrapper's tile table lists the T x T
//   output tiles (T = 128) whose B tile has a set bit, built once per B
//   from its bits (ops/cuda_gram.py::plan_gram): the upper triangle of a
//   DAG mask, 10 of 16 tiles at k = 5.
// - K split across blocks. Work items are (tile, K-range) pairs, K-range
//   major, walked by a persistent grid of one wave; each block adds its
//   rows' int64 partials with atomics (exact for integers). An s32
//   accumulator entry counts tasks of one K-range, fewer than 2^31
//   (checked by the wrapper).
// - Stage the packed words, not bytes, ahead of use. Each of the four
//   warps stages 64 tasks of a 256-task step (2 blocks of 32, lane l
//   task l of each) through a cp.async pipeline in shared memory: the
//   ids of step s + 3, then the 16-byte words of step s + 2's rows (only
//   the tile's 4 + 4 words of the I and J ranges, base and tab rows alike;
//   an invalid task is zero-filled by the copy's source size), while the
//   ANDs and a five-step shuffle transpose turn step s + 1's rows into
//   words whose bit t is row bit i of task t, and the MMAs run on step s.
//   The copies and transposes sit between the k-blocks of the unrolled
//   MMA loop, so they issue while the MMAs run. Each lane reads back only
//   what it copied, so one barrier a step (for the staged operands) is all
//   the pipeline needs, and a step's loads have a step of MMAs to land in.
// - The tensor cores: int8 wgmma m64n128k32 with s32 accumulators, two a
//   k-block of 32 tasks (the tile's two 64-row halves), one group kept in
//   flight while the next k-block's A is built. A (side I) comes from
//   registers: each fragment register is one staged word shifted and
//   masked, byte e of (w >> q) & 0x01010101 being bit 8e + q, so K
//   position tig*4 + e maps to task 8e + tig and 16 + tig*4 + e to task
//   8e + tig + 4. B (side J) must come from shared memory, K-major for
//   8-bit types: the transpose's word of column c is expanded to its 32
//   bytes in that same task order, 16 bytes a K half, in 8-column x
//   16-byte core matrices without swizzle (a warp's stores fill 512
//   contiguous bytes). Expanded B costs 8x the shared bytes of the bits;
//   A from registers spares that on the other side.
// - Epilogue: each row's 32 accumulators a lane are ANDed with the B
//   tile's bits (four packed words), summed in int64 over the 4 lanes that
//   share the row, and added to out[row].
// What bounds it (PERF.md): with the MMAs alone G runs near the tile
// walk's operations bound; the staging (copies, transposes, expansion)
// costs as much again at k = 4 and most of the time at k = 5, and the two
// add up rather than overlap, as both are issued by the same warps. Two
// blocks an SM let one block's MMAs run under the other's staging: warps
// split into MMA warpgroups and staging warps (one block an SM, a barrier
// a step) ran slower, with 8 or 4 staging warps.
#include "common.cuh"

namespace {

constexpr int MAX_DEPTH = 6;
constexpr int T = 128;                    // output tile side, bits
constexpr int TW = T / 32;                // words a tile side
constexpr int NWARP = 4;                  // warps a block: one warpgroup
constexpr int NT = NWARP * 32;
constexpr int KBW = 2;                    // k-blocks of 32 tasks a warp stages
constexpr int KB = NWARP * KBW;           // k-blocks a step
constexpr int STEP = KB * 32;             // tasks a step (cuda_gram.STEP)
constexpr uint32_t ONES = 0x01010101u;

struct Src {
  const int32_t* base;
  int64_t ldb;
  int32_t nb;
  const int32_t* r;          // null: row = t
  const int32_t* tab;
  int64_t ldt;
  int32_t nt;
  const int32_t* c;          // int32 [n, DEPTH]
  int32_t hw;
};

struct Mask {
  const int32_t* m;
  int64_t ldm;
  int32_t nm;
};

// A block's dynamic shared memory, by step parity p:
//   bits[p] [KB][T] uint32           side I's transposed words (wg_a_pos)
//   bb[p]   [KB][2][T] uint4         side J expanded: K half, column
//   rows[p] [2][NR][STEP] uint4      copied words: side, base or tab j, task
//   ids[p]  [STEP][NR] int32         row id and c ids of each task
template <int DEPTH>
struct Smem {
  static constexpr int NR = DEPTH + 1;
  static constexpr int BITS = KB * T;               // uint32 a parity
  static constexpr int BB = KB * 2 * T;             // uint4 a parity
  static constexpr int ROWS = 2 * NR * STEP;        // uint4 a parity
  static constexpr int IDS = STEP * NR;             // int32 a parity
  static constexpr size_t BYTES =
      size_t(2) * (BITS * 4 + BB * 16 + ROWS * 16 + IDS * 4);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes, of which the first `n` are read from src and
// the rest zero-filled (n = 0: nothing is read)
__device__ __forceinline__ void copy16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void copy4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 32 x 32 bit transpose across the warp: lane l returns the word whose bit
// t is bit l of lane t's x. Five block swaps of 16, 8, 4, 2 and 1 bits
// with lane l ^ j (transpose_consts gives the lane's constants): the 16-
// and 8-bit swaps are a shuffle and a byte permute, the others a shuffle,
// a rotate and a bitwise select.
__device__ __forceinline__ uint32_t transpose32(uint32_t x,
                                                const uint32_t (&rot)[5],
                                                const uint32_t (&keep)[5]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    x = __byte_perm(x, __shfl_xor_sync(gm::FULL_MASK, x, 16 >> k), rot[k]);
#pragma unroll
  for (int k = 2; k < 5; ++k) {
    const uint32_t y = __shfl_xor_sync(gm::FULL_MASK, x, 16 >> k);
    const uint32_t z = __funnelshift_l(y, y, rot[k]);
    x = (x & keep[k]) | (z & ~keep[k]);
  }
  return x;
}

// Stage k swaps j = 16 >> k bits with lane l ^ j: a lane without bit j
// keeps the low j bits of each 2j-bit block (mask m) and takes its
// partner's low halves moved up by j; a lane with bit j keeps the high
// halves and takes its partner's high halves moved down by j. For j = 16
// and 8 the move is a byte permute (rot[k] is its selector: bytes 0-3 are
// the lane's, 4-7 its partner's); below, a rotate by j or 32 - j, whose
// wrapped bits land in kept positions (rot[k] the amount, keep[k] the
// kept bits).
__device__ __forceinline__ void transpose_consts(int lane, uint32_t (&rot)[5],
                                                 uint32_t (&keep)[5]) {
  rot[0] = (lane & 16) ? 0x3276u : 0x5410u;
  rot[1] = (lane & 8) ? 0x3715u : 0x6240u;
  keep[0] = keep[1] = 0u;
  uint32_t m = 0x0F0F0F0Fu;
#pragma unroll
  for (int k = 2; k < 5; ++k) {
    const int j = 16 >> k;
    const bool hi = lane & j;
    rot[k] = hi ? 32 - j : j;
    keep[k] = hi ? ~m : m;
    m ^= m << (j >> 1);
  }
}

// The tile and task range of one work item, and where this lane stages.
struct Item {
  int32_t k0, kend;
  int w0, w1;
  bool diag;
};

// Copies of the ids of step s0's tasks that this lane stages (tasks past
// kend, and the row ids of plain rows, copy zeros: validity comes from t).
template <int DEPTH>
__device__ __forceinline__ void stage_ids(const Src& s, const Item& it,
                                          int32_t s0, int q0, int32_t* ids) {
  constexpr int NR = DEPTH + 1;
#pragma unroll
  for (int u = 0; u < KBW; ++u) {
    const int q = q0 + u * 32;
    const int32_t t = s0 + q;
    const bool ok = t < it.kend;
    const bool okr = ok && s.r;
    copy4(ids + q * NR, okr ? s.r + t : s.base, okr ? 4 : 0);
#pragma unroll
    for (int j = 0; j < DEPTH; ++j)
      copy4(ids + q * NR + 1 + j, ok ? s.c + int64_t(t) * DEPTH + j : s.base,
            ok ? 4 : 0);
  }
}

// Copies of the tile's words of step s0's rows (base and each tab row, I
// side and, off the diagonal, J side); an invalid task, and side J of a
// diagonal tile, copy zeros. VEC: 16-byte copies, else 4-byte ones (the
// words past hw zero).
template <int DEPTH, bool VEC>
__device__ __forceinline__ void stage_rows(const Src& s, const Item& it,
                                           int32_t s0, int q0,
                                           const int32_t* ids, uint4* rows) {
  constexpr int NR = DEPTH + 1;
#pragma unroll
  for (int u = 0; u < KBW; ++u) {
    const int q = q0 + u * 32;
    const int32_t t = s0 + q;
    bool ok = t < it.kend;
    const int32_t row = s.r ? (ok ? ids[q * NR] : 0) : t;
    ok = ok && row >= 0 && row < s.nb;
    int32_t cj[NR];
#pragma unroll
    for (int j = 0; j < DEPTH; ++j) {
      cj[j] = ok ? ids[q * NR + 1 + j] : 0;
      ok = ok && cj[j] >= 0 && cj[j] < s.nt;
    }
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const bool oks = ok && !(side == 1 && it.diag);
      const int w = side ? it.w1 : it.w0;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int32_t* src = j == 0 ? s.base + int64_t(row) * s.ldb + w
                                    : s.tab + int64_t(cj[j - 1]) * s.ldt + w;
        uint4* dst = rows + (side * NR + j) * STEP + q;
        if (VEC) {
          copy16(dst, oks ? src : s.base, oks ? 16 : 0);
        } else {
#pragma unroll
          for (int i = 0; i < TW; ++i) {
            const bool oki = oks && w + i < s.hw;
            copy4(reinterpret_cast<int32_t*>(dst) + i, oki ? src + i : s.base,
                  oki ? 4 : 0);
          }
        }
      }
    }
  }
}

// wgmma's A fragments from registers: warp w of the warpgroup holds rows
// 16 w + g and 16 w + 8 + g of each 64-row half h, lane group g; so row r
// = 64 h + 16 w + 8 g8 + g sits at w*32 + g*4 + h*2 + g8, and a lane reads
// its four words with one 16-byte load.
__device__ __forceinline__ int wg_a_pos(int r) {
  return (((r >> 4) & 3) << 5) | ((r & 7) << 2) | ((r >> 6) << 1) |
         ((r >> 3) & 1);
}

// One piece of the transpose: the AND of this lane's copied rows of task
// block u, side `side`, transposed across the warp: side I's words into
// bits (wg_a_pos), side J's expanded to bytes into bb; on a diagonal tile
// side I's rows go to both.
template <int DEPTH>
__device__ __forceinline__ void stage_bits(const Item& it, int q0, int kb0,
                                           int u, int side, int lane,
                                           const uint4* rows,
                                           const uint32_t (&rot)[5],
                                           const uint32_t (&keep)[5],
                                           uint32_t* bits, uint4* bb) {
  constexpr int NR = DEPTH + 1;
  const int q = q0 + u * 32;
  const int from = it.diag ? 0 : side;
  uint4 v = rows[(from * NR) * STEP + q];
#pragma unroll
  for (int j = 1; j < NR; ++j) {
    const uint4 y = rows[(from * NR + j) * STEP + q];
    v.x &= y.x;
    v.y &= y.y;
    v.z &= y.z;
    v.w &= y.w;
  }
  const uint32_t x[TW] = {v.x, v.y, v.z, v.w};
  const int kb = kb0 + u;
#pragma unroll
  for (int i = 0; i < TW; ++i) {
    const int r = i * 32 + lane;
    const uint32_t w = transpose32(x[i], rot, keep);
    if (side == 0) {
      bits[kb * T + wg_a_pos(r)] = w;
    } else {
      uint4* o = bb + kb * 2 * T + r;
      o[0] = make_uint4(w & ONES, (w >> 1) & ONES, (w >> 2) & ONES,
                        (w >> 3) & ONES);
      o[T] = make_uint4((w >> 4) & ONES, (w >> 5) & ONES, (w >> 6) & ONES,
                        (w >> 7) & ONES);
    }
  }
}

// wgmma's B operand from shared memory: a k-block's expanded side J,
// K-major without swizzle, as 8-column x 16-byte core matrices: column c's
// bytes of K half kh at byte kh * 16 T + 16 c (bb[kb][kh][c]). The
// descriptor's fields are the start address, the leading byte offset (the
// K-direction core-matrix stride, 16 T) and the stride byte offset (the
// N-direction one, 128), each in 16-byte units; layout type 0 (no
// swizzle). (The two offsets the other way round gave wrong sums and an
// illegal address on the H100.)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t lbo = (16 * T) >> 4, sbo = 128 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32);
}

// D[64 x 128] += A[64 x 32] (registers) x B[32 x 128] (shared memory)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// Keeps the compiler from moving a register's reads or writes across this
// point (the wgmma in flight reads and writes them behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Issues the two wgmmas (the tile's row halves) of one k-block: A from
// this lane's staged words (wg_a_pos), B at shared address `bb`.
__device__ __forceinline__ void wg_issue(const uint32_t* bi, uint32_t bb,
                                         int warp, int gid, int tig,
                                         int (&acc)[2][64],
                                         uint32_t (&a)[2][4]) {
  const uint4 w = *reinterpret_cast<const uint4*>(bi + warp * 32 + gid * 4);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h][0] = (ws[2 * h] >> tig) & ONES;
    a[h][1] = (ws[2 * h + 1] >> tig) & ONES;
    a[h][2] = (ws[2 * h] >> (tig + 4)) & ONES;
    a[h][3] = (ws[2 * h + 1] >> (tig + 4)) & ONES;
  }
  const uint64_t desc = b_desc(bb);
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_s8(acc[0], a[0], desc);
  wgmma_s8(acc[1], a[1], desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N groups of wgmmas are in flight; `a` holds the A
// fragments of the newest group that has then completed.
template <int N>
__device__ __forceinline__ void wg_wait(int (&acc)[2][64],
                                        uint32_t (&a)[2][4]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  fence_regs(a[0]);
  fence_regs(a[1]);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int DEPTH, bool VEC>
__global__ void __launch_bounds__(NT)
bit_gram_kernel(Src s, Mask mk, const int32_t* __restrict__ tiles,
                int32_t n_tiles, int32_t n, int32_t kc, int64_t n_items,
                unsigned long long* __restrict__ out) {
  using SM = Smem<DEPTH>;
  extern __shared__ uint4 smem[];
  uint32_t* const bits0 = reinterpret_cast<uint32_t*>(smem);
  uint4* const bb0 = smem + 2 * SM::BITS / 4;
  uint4* const rows0 = bb0 + 2 * SM::BB;
  int32_t* const ids0 = reinterpret_cast<int32_t*>(rows0 + 2 * SM::ROWS);
  auto bits = [&](int p) { return bits0 + p * SM::BITS; };
  auto bbs = [&](int p) { return bb0 + p * SM::BB; };
  auto rows = [&](int p) { return rows0 + p * SM::ROWS; };
  auto ids = [&](int p) { return ids0 + p * SM::IDS; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kb0 = warp * KBW;               // this warp's k-blocks
  const int q0 = kb0 * 32 + lane;           // this lane's first task a step
  const int32_t dim = 32 * s.hw;
  uint32_t rot[5], keep[5];
  transpose_consts(lane, rot, keep);
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int32_t tile = int32_t(item % n_tiles);
    Item it;
    it.k0 = int32_t(item / n_tiles) * kc;
    it.kend = min(n, it.k0 + kc);
    const int32_t ti = __ldg(tiles + 2 * tile), tj = __ldg(tiles + 2 * tile + 1);
    it.diag = ti == tj;
    it.w0 = ti * TW;
    it.w1 = tj * TW;
    const int nsteps = (it.kend - it.k0 + STEP - 1) / STEP;

    int acc[2][64];                   // [row half][nb * 4 + g8 * 2 + e]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0;

    // Step st copies the ids of step st + 3 and the rows of st + 2,
    // transposes st + 1 and multiplies st; the copying and transposing
    // are spread over the k-blocks of the (unrolled) MMA loop, so their
    // instructions issue while the MMAs run. Past the item's last step
    // they copy zeros and transpose what no MMA reads.
    stage_ids<DEPTH>(s, it, it.k0, q0, ids(0));
    copy_commit();
    copy_wait();
    stage_rows<DEPTH, VEC>(s, it, it.k0, q0, ids(0), rows(0));
    stage_ids<DEPTH>(s, it, it.k0 + STEP, q0, ids(1));
    copy_commit();
    copy_wait();
    stage_rows<DEPTH, VEC>(s, it, it.k0 + STEP, q0, ids(1), rows(1));
    stage_ids<DEPTH>(s, it, it.k0 + 2 * STEP, q0, ids(0));
    copy_commit();
#pragma unroll
    for (int piece = 0; piece < 2 * KBW; ++piece)
      stage_bits<DEPTH>(it, q0, kb0, piece >> 1, piece & 1, lane, rows(0),
                        rot, keep, bits(0), bbs(0));
    fence_async_smem();               // B's bytes, for the wgmmas to read
    __syncthreads();
    for (int st = 0; st < nsteps; ++st) {
      const int p = st & 1;
      const int32_t s0 = it.k0 + st * STEP;
      copy_wait();                    // this lane's rows of st + 1, ids of st + 2
      uint32_t a[2][2][4];            // the A fragments of two k-blocks
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wg_issue(bits(p) + kb * T, smem_addr(bbs(p) + kb * 2 * T), warp, gid,
                 tig, acc, a[kb & 1]);
        if (kb == 0)
          stage_rows<DEPTH, VEC>(s, it, s0 + 2 * STEP, q0, ids(p), rows(p));
        if (kb == 2) {
          stage_ids<DEPTH>(s, it, s0 + 3 * STEP, q0, ids(p ^ 1));
          copy_commit();
        }
        if (kb & 1)                     // pieces (u, side) at k-blocks 1-7
          stage_bits<DEPTH>(it, q0, kb0, kb >> 2, (kb >> 1) & 1, lane,
                            rows(p ^ 1), rot, keep, bits(p ^ 1), bbs(p ^ 1));
        if (kb > 0) wg_wait<1>(acc, a[(kb - 1) & 1]);
      }
      wg_wait<0>(acc, a[(KB - 1) & 1]);   // step st's operands are free
      fence_async_smem();
      __syncthreads();
    }
    copy_wait();                      // the past-the-end copies, before reuse

    // epilogue: row sums of the accumulators under the mask's bits; lane
    // (gid, tig) of warp w holds rows 64 h + 16 w + 8 g8 + gid, columns
    // 8 nb + 2 tig + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int g8 = 0; g8 < 2; ++g8) {
        const int32_t row = ti * T + h * 64 + warp * 16 + g8 * 8 + gid;
        uint32_t m[TW] = {0u, 0u, 0u, 0u};
        if (row < dim && row < mk.nm) {
          const int32_t* mr = mk.m + int64_t(row) * mk.ldm;
#pragma unroll
          for (int q = 0; q < TW; ++q)
            if (it.w1 + q < s.hw) m[q] = uint32_t(__ldg(mr + it.w1 + q));
        }
        long long sum = 0;
#pragma unroll
        for (int nb = 0; nb < 16; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb * 8 + tig * 2 + e;
            if ((m[nb >> 2] >> (col & 31)) & 1u)
              sum += acc[h][nb * 4 + g8 * 2 + e];
          }
        sum += __shfl_xor_sync(gm::FULL_MASK, sum, 1);
        sum += __shfl_xor_sync(gm::FULL_MASK, sum, 2);
        if (tig == 0 && sum != 0)
          atomicAdd(out + row, static_cast<unsigned long long>(sum));
      }
    }
  }
}

// Lets the kernel take its dynamic shared memory (above the 48 KB default);
// a CUDA error on failure.
template <int DEPTH, bool VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(bit_gram_kernel<DEPTH, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(Smem<DEPTH>::BYTES));
}

template <int DEPTH>
int blocks_of() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem<DEPTH, true>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bit_gram_kernel<DEPTH, true>, NT, Smem<DEPTH>::BYTES);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

template <int DEPTH, bool VEC>
cudaError_t launch_as(const Src& s, const Mask& mk, const int32_t* tiles,
                      int32_t n_tiles, int32_t n, int32_t kc, int64_t n_items,
                      unsigned long long* out, int64_t n_blocks,
                      cudaStream_t stream) {
  const cudaError_t e = allow_smem<DEPTH, VEC>();
  if (e != cudaSuccess) return e;
  bit_gram_kernel<DEPTH, VEC><<<unsigned(n_blocks), NT, Smem<DEPTH>::BYTES,
                                stream>>>(s, mk, tiles, n_tiles, n, kc,
                                          n_items, out);
  return cudaGetLastError();
}

template <int DEPTH>
cudaError_t launch(const Src& s, bool vec, const Mask& mk,
                   const int32_t* tiles, int32_t n_tiles, int32_t n,
                   int32_t kc, int64_t n_items, unsigned long long* out,
                   int64_t n_blocks, cudaStream_t stream) {
  return vec ? launch_as<DEPTH, true>(s, mk, tiles, n_tiles, n, kc, n_items,
                                      out, n_blocks, stream)
             : launch_as<DEPTH, false>(s, mk, tiles, n_tiles, n, kc, n_items,
                                       out, n_blocks, stream);
}

}  // namespace

// Blocks of one full wave of the depth-`depth` kernel's persistent grid;
// a negative CUDA error on failure.
extern "C" int gm_bit_gram_blocks(int64_t depth) {
  switch (depth) {
    case 0: return blocks_of<0>();
    case 1: return blocks_of<1>();
    case 2: return blocks_of<2>();
    case 3: return blocks_of<3>();
    case 4: return blocks_of<4>();
    case 5: return blocks_of<5>();
    case MAX_DEPTH: return blocks_of<MAX_DEPTH>();
    default: return -int(cudaErrorInvalidValue);
  }
}

// base: int32 rows at stride ldb (words), nb rows, hw words read from each;
// r: int32 [n] or null (then row = t); tab: int32 rows at stride ldt, nt
// rows (read only when depth > 0); c: int32 [n, depth], 0 <= depth <= 6;
// mask: int32 rows at stride ldm, nm rows, hw words each; tiles: int32
// [n_tiles, 2] (I, J) tile ids; items: n_tiles tiles x K-ranges of kc tasks
// (kc % 256 == 0), n + kc < 2^31; out: int64 [32*hw], zeroed. The wrapper
// (ops/cuda_gram.py) checks all of this. Returns a cudaError_t.
extern "C" int gm_bit_gram(const void* base, int64_t ldb, int64_t nb,
                           const void* r, const void* tab, int64_t ldt,
                           int64_t nt, const void* c, int64_t depth,
                           int64_t n, int64_t hw, const void* mask,
                           int64_t ldm, int64_t nm, const void* tiles,
                           int64_t n_tiles, int64_t kc, int64_t n_items,
                           void* out, int64_t n_blocks, void* stream) {
  Src s;
  s.base = static_cast<const int32_t*>(base);
  s.ldb = ldb;
  s.nb = int32_t(nb);
  s.r = static_cast<const int32_t*>(r);
  s.tab = static_cast<const int32_t*>(tab);
  s.ldt = ldt;
  s.nt = int32_t(nt);
  s.c = static_cast<const int32_t*>(c);
  s.hw = int32_t(hw);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = hw % 4 == 0 && ldb % 4 == 0 && aligned(base) &&
                   (depth == 0 || (ldt % 4 == 0 && aligned(tab)));
  Mask mk;
  mk.m = static_cast<const int32_t*>(mask);
  mk.ldm = ldm;
  mk.nm = int32_t(nm);
  const auto tl = static_cast<const int32_t*>(tiles);
  const auto o = static_cast<unsigned long long*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int32_t n_ = int32_t(n), nt_ = int32_t(n_tiles), kc_ = int32_t(kc);
  switch (depth) {
    case 0: return int(launch<0>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case 1: return int(launch<1>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case 2: return int(launch<2>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case 3: return int(launch<3>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case 4: return int(launch<4>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case 5: return int(launch<5>(s, vec, mk, tl, nt_, n_, kc_, n_items, o, n_blocks, st));
    case MAX_DEPTH:
      return int(launch<MAX_DEPTH>(s, vec, mk, tl, nt_, n_, kc_, n_items, o,
                                   n_blocks, st));
    default: return int(cudaErrorInvalidValue);
  }
}
