// Fused AES-SpMM for Hopper (paper Algorithm 1 in one kernel): sample each
// row into __shared__ sh_val/sh_col, then accumulate over the live slots.
// No ELL operand is written to device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_spmm.py:
// fused_aes_spmm (_fused_kernel).
//
// Bound: bytes.  The least traffic is the row pointers, one (col, val) read
// per live slot, one B row per live slot and the output:
// rows*4 + sum(live)*8 + sum(live)*F*4 + rows*F*4.
// Design: the paper's own.  One block per row; its threads fill sh_val[W]
// and sh_col[W] (dynamic shared memory, W a runtime argument) through the
// inverse slot map, synchronise, then run across features — each thread
// owns features f, f+blockDim, ... and sums the live slots in slot order, so
// a warp reads each B row coalesced.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
fused_aes_spmm_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col_ind,
                      const float* __restrict__ val,
                      const float* __restrict__ b, float* __restrict__ out,
                      int feat, int sh_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sh_val = reinterpret_cast<float*>(smem);
  int* sh_col = reinterpret_cast<int*>(sh_val + sh_width);

  const int row = blockIdx.x;
  const int start = row_ptr[row];
  const AesRow st = aes_row_strategy(row_ptr[row + 1] - start, sh_width);
  const int live = aes_live_width(st);
  for (int s = threadIdx.x; s < live; s += kThreads) {
    const int off = aes_slot_offset(st, s);
    sh_val[s] = off >= 0 ? val[start + off] : 0.f;
    sh_col[s] = off >= 0 ? col_ind[start + off] : 0;
  }
  __syncthreads();

  float* orow = out + static_cast<int64_t>(row) * feat;
  for (int f = threadIdx.x; f < feat; f += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < live; ++k)
      acc += sh_val[k] * b[static_cast<int64_t>(sh_col[k]) * feat + f];
    orow[f] = acc;
  }
}

}  // namespace

extern "C" int fused_aes_spmm(const int* row_ptr, const int* col_ind,
                              const float* val, const float* b, float* out,
                              int rows, int feat, int sh_width,
                              void* stream) {
  const int smem = 8 * sh_width;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_aes_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_aes_spmm_kernel<<<rows, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      row_ptr, col_ind, val, b, out, feat, sh_width);
  return static_cast<int>(cudaGetLastError());
}
