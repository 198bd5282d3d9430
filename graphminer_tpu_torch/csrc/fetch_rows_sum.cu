// Kernel D — fetch table rows by index and sum them.
//
// Port of the Pallas kernel graphminer_tpu/ops/pallas_fetch.py::
// _fetch_sum_kernel (entry fetch_rows_sum): out[c] = sum_i table[idx[i], c]
// over idx int32 [t] and table int32 [v, w]. Sums are taken in int64 (the
// TPU kernel's were int32; the wrapper checks that the int32 result cannot
// wrap). An index outside [0, v) adds nothing.
//
// Bound: bytes — idx and the distinct rows it names (4*w bytes each), each
// read once; a random row is one or a few 32-byte sectors.
// Design: the TPU kernel keeps n_buf row DMAs in flight on its one core.
// Here the blocks take interleaved slices of idx. Inside a block a row is
// split into 16-byte column chunks (4-byte chunks when w % 4 != 0), one per
// thread, so BLOCK / chunks-per-row rows are read side by side; and each
// thread issues NB = n_buf independent row loads before it adds any of them
// — the unrolled loads are the pipeline that the TPU's DMA ring was. Each
// thread keeps int64 column sums; the block reduces them through shared
// memory into one int64 partial row, and the wrapper sums those rows.
#include <type_traits>

#include "common.cuh"

namespace {

template <int VEC>
using vec_t = typename std::conditional<VEC == 4, int4, int32_t>::type;

template <int VEC>
__device__ __forceinline__ void add_to(long long* acc, const vec_t<VEC>& x) {
  if constexpr (VEC == 4) {
    acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
  } else {
    acc[0] += x;
  }
}

template <int NB, int VEC>
__global__ void __launch_bounds__(gm::BLOCK)
fetch_rows_sum_kernel(const int32_t* __restrict__ idx, int64_t t,
                      const int32_t* __restrict__ table, int32_t v, int32_t w,
                      int32_t cpr, long long* __restrict__ partials) {
  __shared__ long long red[gm::BLOCK * VEC];
  const int rows = gm::BLOCK / cpr;              // rows read side by side
  const int slot = threadIdx.x / cpr, c = threadIdx.x - slot * cpr;
  long long acc[VEC] = {};
  if (slot < rows) {
    const int64_t stride = int64_t(gridDim.x) * rows;
    const vec_t<VEC>* col = reinterpret_cast<const vec_t<VEC>*>(table) + c;
    const int64_t row_vecs = w / VEC;
    for (int64_t base = int64_t(blockIdx.x) * rows + slot; base < t;
         base += stride * NB) {
      int32_t r[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int64_t i = base + j * stride;
        r[j] = i < t ? __ldg(idx + i) : -1;
      }
      vec_t<VEC> x[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j)
        x[j] = (r[j] >= 0 && r[j] < v) ? __ldg(col + int64_t(r[j]) * row_vecs)
                                       : vec_t<VEC>{};
#pragma unroll
      for (int j = 0; j < NB; ++j) add_to<VEC>(acc, x[j]);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[threadIdx.x * VEC + k] = acc[k];
  __syncthreads();
  // thread slot*cpr + c holds columns c*VEC .. c*VEC+VEC-1 of its row slot
  for (int col = threadIdx.x; col < w; col += blockDim.x) {
    const int cc = col / VEC, k = col - cc * VEC;
    long long s = 0;
    for (int r = 0; r < rows; ++r) s += red[(r * cpr + cc) * VEC + k];
    partials[int64_t(blockIdx.x) * w + col] = s;
  }
}

template <int NB>
int launch(const void* idx, int64_t t, const void* table, int64_t v,
           int64_t w, void* partials, int64_t n_blocks, cudaStream_t st) {
  const int32_t* i = static_cast<const int32_t*>(idx);
  const int32_t* tb = static_cast<const int32_t*>(table);
  long long* p = static_cast<long long*>(partials);
  if (w % 4 == 0)
    fetch_rows_sum_kernel<NB, 4><<<unsigned(n_blocks), gm::BLOCK, 0, st>>>(
        i, t, tb, int32_t(v), int32_t(w), int32_t(w / 4), p);
  else
    fetch_rows_sum_kernel<NB, 1><<<unsigned(n_blocks), gm::BLOCK, 0, st>>>(
        i, t, tb, int32_t(v), int32_t(w), int32_t(w), p);
  return int(cudaGetLastError());
}

}  // namespace

// idx: int32 [t]; table: int32 [v, w] with w / 4 <= BLOCK (w % 4 == 0) or
// w <= BLOCK; n_buf in {1, 2, 4, 8, 16, 32}; partials: int64 [n_blocks, w].
// Returns cudaErrorInvalidValue for another n_buf.
extern "C" int gm_fetch_rows_sum(const void* idx, int64_t t, const void* table,
                                 int64_t v, int64_t w, int64_t n_buf,
                                 void* partials, int64_t n_blocks,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_buf) {
    case 1: return launch<1>(idx, t, table, v, w, partials, n_blocks, st);
    case 2: return launch<2>(idx, t, table, v, w, partials, n_blocks, st);
    case 4: return launch<4>(idx, t, table, v, w, partials, n_blocks, st);
    case 8: return launch<8>(idx, t, table, v, w, partials, n_blocks, st);
    case 16: return launch<16>(idx, t, table, v, w, partials, n_blocks, st);
    case 32: return launch<32>(idx, t, table, v, w, partials, n_blocks, st);
    default: return int(cudaErrorInvalidValue);
  }
}
