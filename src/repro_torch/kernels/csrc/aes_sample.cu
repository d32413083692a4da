// AES sampling pre-pass for Hopper: CSR -> ELL[rows, W] by Table 1 + Eq. 3,
// element j of sample i in slot i + j*cnt, dead slots (val 0, col 0).
//
// Replaces the Pallas TPU kernel src/repro/kernels/aes_sample.py:aes_sample
// (_sample_kernel).
//
// Bound: bytes.  The least traffic is the row pointers, one (col, val) read
// per live slot and the [rows, W] (val, col) write: rows*4 +
// sum(live)*8 + rows*W*8.  Design: one thread per (row, slot) through the
// inverse of the slot layout (common.cuh), so neighbouring threads write
// neighbouring slots of one row and the writes coalesce.  Reads are masked
// to the row; nothing past the CSR tail is touched (the TPU kernel's padded
// fixed-size run copy is not needed).  Integer arithmetic only: the output
// is bit-identical to the plain sampler.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
aes_sample_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col_ind,
                  const float* __restrict__ val, float* __restrict__ out_val,
                  int* __restrict__ out_col, int rows, int sh_width) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * sh_width) return;
  const int row = static_cast<int>(idx / sh_width);
  const int s = static_cast<int>(idx - static_cast<int64_t>(row) * sh_width);
  const int start = row_ptr[row];
  const AesRow st = aes_row_strategy(row_ptr[row + 1] - start, sh_width);
  const int off = aes_slot_offset(st, s);
  out_val[idx] = off >= 0 ? val[start + off] : 0.f;
  out_col[idx] = off >= 0 ? col_ind[start + off] : 0;
}

}  // namespace

extern "C" int aes_sample(const int* row_ptr, const int* col_ind,
                          const float* val, float* out_val, int* out_col,
                          int rows, int sh_width, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * sh_width;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  aes_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      row_ptr, col_ind, val, out_val, out_col, rows, sh_width);
  return static_cast<int>(cudaGetLastError());
}
