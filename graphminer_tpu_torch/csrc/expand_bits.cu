// Kernel X — bit expansion: packed int32 words -> int8 0/1 operand rows.
//
// Replaces the XLA function graphminer_tpu/ops/hubcore.py::_expand_bits
// (shift_right_logical + & 1 + convert) and the gathers and ANDs in front of
// it in graphminer_tpu/ops/cliquek.py::_tri_stream_bilinear (y2 & core_hi[c])
// and graphminer_tpu/ops/cliquebig.py::_chain_hi_bilinear (the depth-chained
// ANDs); torch has no unpackbits. For task t < n the packed row is
//
//   y_t = base[row_t] & tab[c[t, 0]] & ... & tab[c[t, depth - 1]]
//
// over hw words, with row_t = r[t], or t when r is null (plain mode: no r
// and depth 0, so y_t = base[t]). A task whose row lies outside
// [0, nb) or any of whose c ids lies outside [0, nt), SENTINEL included,
// gives a zero row (the where(ok, ..., 0) of the JAX code), and so does
// every task t in [n, n_out), which pads the output for torch._int_mm.
// Output byte w*32 + b of task t is bit b of word w, the packing order of
// build_hub_layout; words are read as uint32, so bit 31 is bit 31.
//   row-major   out int8 [n_out, 32*hw]
//   transposed  out int8 [32*hw, n_out], n_out % 32 == 0
// base and tab are read at row strides ldb and ldt (in words), so a hi slice
// of a wider table is read in place.
//
// Bound: bytes — the int8 output is 8x the packed words: n_out*32*hw bytes
// written plus the packed rows read, at 3.35 TB/s.
// Design: row-major, one thread a (task, word), two 16-byte stores of the
// word's 32 bytes (a nibble spread to 4 bytes by one multiply); adjacent
// threads take adjacent words, so loads and stores are coalesced.
// Transposed, one block a tile of 512 tasks x 8 words staged in shared
// memory, each warp writing 128 contiguous bytes of one output row a store
// (a first design, one thread a (32 tasks, word) writing 32 rows' 32-byte
// pieces, ran at 5.7x the bound on a spoke slab). DEPTH is a template
// argument (0-6), so the gathers of a task are unrolled.
#include "common.cuh"

namespace {

constexpr int MAX_DEPTH = 6;

struct Src {
  const int32_t* base;
  int64_t ldb;
  int32_t nb;
  const int32_t* r;          // null: row = t
  const int32_t* tab;
  int64_t ldt;
  int32_t nt;
  const int32_t* c;          // int32 [n, DEPTH]
  int32_t n;
};

// The packed word w of task t (0 when the task is padding or invalid).
template <int DEPTH>
__device__ __forceinline__ uint32_t word_of(const Src& s, int32_t t, int w) {
  if (t >= s.n) return 0u;
  const int32_t row = s.r ? __ldg(s.r + t) : t;
  if (row < 0 || row >= s.nb) return 0u;
  uint32_t x = uint32_t(__ldg(s.base + row * s.ldb + w));
#pragma unroll
  for (int j = 0; j < DEPTH; ++j) {
    const int32_t cj = __ldg(s.c + int64_t(t) * DEPTH + j);
    if (cj < 0 || cj >= s.nt) return 0u;
    x &= uint32_t(__ldg(s.tab + cj * s.ldt + w));
  }
  return x;
}

// Bits 0-3 of n as bytes 0-3 of the result (each 0 or 1): the four shifted
// copies n, n << 7, n << 14, n << 21 do not overlap, so no carry crosses.
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

template <int DEPTH>
__global__ void __launch_bounds__(gm::BLOCK)
expand_rows_kernel(Src s, int32_t hw, gm::FastDiv div_hw, int32_t total,
                   uint4* __restrict__ out) {
  const int32_t i = int32_t(blockIdx.x) * gm::BLOCK + int32_t(threadIdx.x);
  if (i >= total) return;
  const int32_t t = int32_t(div_hw.div(uint32_t(i)));
  const uint32_t x = word_of<DEPTH>(s, t, i - t * hw);
  uint4 lo, hi;
  lo.x = spread4(x & 0xFu);
  lo.y = spread4((x >> 4) & 0xFu);
  lo.z = spread4((x >> 8) & 0xFu);
  lo.w = spread4((x >> 12) & 0xFu);
  hi.x = spread4((x >> 16) & 0xFu);
  hi.y = spread4((x >> 20) & 0xFu);
  hi.z = spread4((x >> 24) & 0xFu);
  hi.w = spread4(x >> 28);
  out[2 * int64_t(i)] = lo;
  out[2 * int64_t(i) + 1] = hi;
}

// Transposed: one block a tile of TT tasks x WT words. The block reads the
// tile's packed words into shared memory, word-major (lanes take
// consecutive tasks of one word, so the stores into shared memory do not
// conflict; the loads of a task's 8 words share 32-byte sectors through
// L1). Then warp i expands word w0 + i: lane l takes tasks 4l..4l+3 of each
// 128-task run (one 16-byte read of shared memory) and, for each bit b,
// writes their 4 bytes of output row (w0+i)*32 + b, so a warp's store is
// 128 contiguous bytes.
constexpr int TT = 512;                     // tasks a tile
constexpr int WT = gm::BLOCK / 32;          // words a tile, one a warp

template <int DEPTH>
__global__ void __launch_bounds__(gm::BLOCK)
expand_cols_kernel(Src s, int32_t hw, int64_t n_out,
                   uint8_t* __restrict__ out) {
  __shared__ uint4 tile[WT][TT / 4];
  const int32_t t0 = int32_t(blockIdx.x) * TT;
  const int32_t w0 = int32_t(blockIdx.y) * WT;
  uint32_t* flat = reinterpret_cast<uint32_t*>(&tile[0][0]);
#pragma unroll 4
  for (int i = threadIdx.x; i < WT * TT; i += gm::BLOCK) {
    const int w = i / TT, t = i % TT;
    flat[i] = w0 + w < hw ? word_of<DEPTH>(s, t0 + t, w0 + w) : 0u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (w0 + warp >= hw) return;
  uint8_t* rows = out + int64_t(w0 + warp) * 32 * n_out;
  for (int run = 0; run < TT / 128; ++run) {
    const int64_t t = int64_t(t0) + run * 128 + 4 * lane;
    if (t >= n_out) break;                 // n_out % 4 == 0: whole words
    const uint4 x = tile[warp][run * 32 + lane];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t q = ((x.x >> b) & 1u) | (((x.y >> b) & 1u) << 8) |
                         (((x.z >> b) & 1u) << 16) |
                         (((x.w >> b) & 1u) << 24);
      *reinterpret_cast<uint32_t*>(rows + int64_t(b) * n_out + t) = q;
    }
  }
}

template <int DEPTH>
cudaError_t launch(const Src& s, int32_t hw, int64_t n_out, bool transpose,
                   void* out, cudaStream_t stream) {
  if (n_out == 0 || hw == 0) return cudaSuccess;
  if (transpose) {
    const dim3 grid(unsigned((n_out + TT - 1) / TT),
                    unsigned((hw + WT - 1) / WT));
    expand_cols_kernel<DEPTH><<<grid, gm::BLOCK, 0, stream>>>(
        s, hw, n_out, static_cast<uint8_t*>(out));
  } else {
    const int32_t total = int32_t(n_out * hw);
    const unsigned blocks = unsigned((total + gm::BLOCK - 1) / gm::BLOCK);
    expand_rows_kernel<DEPTH><<<blocks, gm::BLOCK, 0, stream>>>(
        s, hw, gm::FastDiv::make(uint32_t(hw)), total,
        static_cast<uint4*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// base: int32 rows at stride ldb (words), nb rows, hw words read from each;
// r: int32 [n] or null (then row = t); tab: int32 rows at stride
// ldt, nt rows (read only when depth > 0); c: int32 [n, depth], 0 <= depth
// <= 6; out: int8 [n_out, 32*hw], or [32*hw, n_out] when transpose (then
// n_out % 32 == 0); n <= n_out; n_out*hw < 2^31. The wrapper
// (ops/cuda_expand.py) checks all of this. Returns a cudaError_t.
extern "C" int gm_expand_bits(const void* base, int64_t ldb, int64_t nb,
                              const void* r, const void* tab,
                              int64_t ldt, int64_t nt, const void* c,
                              int64_t depth, int64_t n, int64_t hw,
                              int64_t n_out, int64_t transpose, void* out,
                              void* stream) {
  Src s;
  s.base = static_cast<const int32_t*>(base);
  s.ldb = ldb;
  s.nb = int32_t(nb);
  s.r = static_cast<const int32_t*>(r);
  s.tab = static_cast<const int32_t*>(tab);
  s.ldt = ldt;
  s.nt = int32_t(nt);
  s.c = static_cast<const int32_t*>(c);
  s.n = int32_t(n);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool tr = transpose != 0;
  const int32_t w = int32_t(hw);
  switch (depth) {
    case 0: return int(launch<0>(s, w, n_out, tr, out, st));
    case 1: return int(launch<1>(s, w, n_out, tr, out, st));
    case 2: return int(launch<2>(s, w, n_out, tr, out, st));
    case 3: return int(launch<3>(s, w, n_out, tr, out, st));
    case 4: return int(launch<4>(s, w, n_out, tr, out, st));
    case 5: return int(launch<5>(s, w, n_out, tr, out, st));
    case MAX_DEPTH: return int(launch<MAX_DEPTH>(s, w, n_out, tr, out, st));
    default: return int(cudaErrorInvalidValue);
  }
}
