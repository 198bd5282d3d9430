// Kernel D — fetch table rows by index and sum them, one launch a call.
//
// Port of the Pallas kernel graphminer_tpu/ops/pallas_fetch.py::
// _fetch_sum_kernel (entry fetch_rows_sum): out[0, c] = sum_i table[idx[i], c]
// over idx int32 [t] and table int32 [v, w], an int32 [1, w] result. Sums are
// taken in int64 (the TPU kernel's were int32 and wrapped silently); a sum
// outside int32 is a device-side assert. An index outside [0, v) adds
// nothing.
//
// Bound: bytes — idx and the distinct rows it names (4*w bytes each), each
// read once. D is the gather-rate probe (prof_breakdown prints ns/row from
// it), so every index is one row fetch: no histogram of idx, no reuse.
// Design: the TPU kernel keeps n_buf row DMAs in flight on its one core.
// Here one persistent grid of one wave (gm_fetch_rows_sum_blocks) does the
// whole call:
// - a row is read by a lane group of cpr = w / 4 lanes with 16-byte loads
//   (w lanes of 4 bytes when w % 4 != 0), so a warp reads whole rows (32 / cpr
//   of them at w <= 128; two warps a row at w = 256); the groups take
//   interleaved indices, and each lane issues NB = n_buf independent row
//   loads before it adds any — NB is the depth of the load pipeline, as it
//   was the depth of the TPU kernel's DMA ring. At n_buf 16 a lane has 256 B
//   in flight, tens of KB an SM, above the ~18 KB that covers HBM latency;
// - a block reduces its lanes' int64 column sums in shared memory in two
//   parallel steps (threads split each column's rows, then one thread a
//   column adds the pieces) and adds its row into the workspace's int64 sums
//   with atomics;
// - the last block to finish converts the sums to the int32 result
//   (gm::finish_int32) and leaves the workspace zero. A call is this one
//   kernel: no partials tensor, no sum and no check run after it.
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
                      int32_t cpr, unsigned long long* __restrict__ ws,
                      int32_t* __restrict__ out) {
  __shared__ long long red[gm::BLOCK * VEC];
  __shared__ long long part[gm::BLOCK * VEC];
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
  // thread slot * cpr + c holds columns c*VEC .. c*VEC+VEC-1 of row slot,
  // so red is [rows, w] row-major: column col of row r is red[r * w + col]
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[threadIdx.x * VEC + k] = acc[k];
  __syncthreads();
  // step 1: p = BLOCK / w threads a column (1 when w > BLOCK), thread
  // (piece, col) summing rows piece, piece + p, ...
  const int p = w <= gm::BLOCK ? gm::BLOCK / w : 1;
  for (int e = threadIdx.x; e < p * w; e += gm::BLOCK) {
    const int piece = e / w, col = e - piece * w;
    long long s = 0;
    for (int r = piece; r < rows; r += p) s += red[r * w + col];
    part[e] = s;
  }
  __syncthreads();
  // step 2: one thread a column adds its p pieces
  for (int col = threadIdx.x; col < w; col += gm::BLOCK) {
    long long s = 0;
    for (int k = 0; k < p; ++k) s += part[k * w + col];
    if (s) atomicAdd(ws + 1 + col, static_cast<unsigned long long>(s));
  }
  gm::finish_int32(ws, w, out);
}

template <int NB, int VEC>
void* kernel_of() {
  return reinterpret_cast<void*>(fetch_rows_sum_kernel<NB, VEC>);
}

template <int VEC>
void* kernel_at_depth(int64_t n_buf) {
  switch (n_buf) {
    case 1: return kernel_of<1, VEC>();
    case 2: return kernel_of<2, VEC>();
    case 4: return kernel_of<4, VEC>();
    case 8: return kernel_of<8, VEC>();
    case 16: return kernel_of<16, VEC>();
    case 32: return kernel_of<32, VEC>();
    default: return nullptr;
  }
}

void* kernel_for(int64_t vec, int64_t n_buf) {
  return vec == 4 ? kernel_at_depth<4>(n_buf) : kernel_at_depth<1>(n_buf);
}

}  // namespace

// Blocks of one full wave of kernel D for 16-byte lanes (vec 4, w % 4 == 0)
// or 4-byte lanes (vec 1) at pipeline depth n_buf: SMs x resident blocks; a
// negative CUDA error code on failure.
extern "C" int gm_fetch_rows_sum_blocks(int64_t vec, int64_t n_buf) {
  const void* k = kernel_for(vec, n_buf);
  if (k == nullptr) return -int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, gm::BLOCK,
                                                      0);
  if (e != cudaSuccess) return -int(e);
  return sms * per_sm;
}

// idx: int32 [t]; table: int32 [v, w] with w / 4 <= BLOCK (w % 4 == 0) or
// w <= BLOCK; n_buf in {1, 2, 4, 8, 16, 32}; workspace: int64 [1 + w], zero
// (and left zero); out: int32 [w]. Returns cudaErrorInvalidValue for
// another n_buf.
extern "C" int gm_fetch_rows_sum(const void* idx, int64_t t, const void* table,
                                 int64_t v, int64_t w, int64_t n_buf,
                                 void* workspace, void* out, int64_t n_blocks,
                                 void* stream) {
  const int64_t vec = w % 4 == 0 ? 4 : 1;
  const void* k = kernel_for(vec, n_buf);
  if (k == nullptr) return int(cudaErrorInvalidValue);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const int32_t* tp = static_cast<const int32_t*>(table);
  int32_t v32 = int32_t(v), w32 = int32_t(w), cpr = int32_t(w / vec);
  unsigned long long* wp = static_cast<unsigned long long*>(workspace);
  int32_t* op = static_cast<int32_t*>(out);
  void* args[] = {&ip, &t, &tp, &v32, &w32, &cpr, &wp, &op};
  const cudaError_t e = cudaLaunchKernel(
      k, dim3(unsigned(n_blocks)), dim3(gm::BLOCK), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();      // clear it: it is returned
  return int(e);
}
