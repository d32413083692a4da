// Shared device code for the kernels: the Table 1 strategy of one row
// and the inverse slot map of Algorithm 1, plus the C entry point that turns
// a CUDA error code into text for the Python wrappers.
//
// The arithmetic is int32, as in the reference sampler
// (repro_torch/core/sampling.py), so the kernels reproduce it bit for bit.
#pragma once

#include <cuda_runtime.h>

#define AES_PRIME_NUM 1429  // paper §3.3

struct AesRow {
  int nnz;  // row non-zeros
  int n;    // consecutive elements per sample (N >= 1)
  int cnt;  // number of samples (1 <= cnt <= max(W, 1))
  int w;    // effective width min(nnz, sh_width)
};

// Alg. 1 line 6 + Table 1, as integer tests nnz <= t * W (no float R).
__device__ __forceinline__ AesRow aes_row_strategy(int nnz, int sh_width) {
  AesRow s;
  s.nnz = nnz;
  s.w = min(nnz, sh_width);
  const int w = s.w;
  if (nnz <= w) {
    s.n = nnz; s.cnt = 1;
  } else if (nnz <= 2 * w) {
    s.n = w / 4; s.cnt = 4;
  } else if (nnz <= 36 * w) {
    s.n = w / 8; s.cnt = 8;
  } else if (nnz <= 54 * w) {
    s.n = w / 16; s.cnt = 16;
  } else {
    s.n = w / 32; s.cnt = 32;
  }
  s.n = max(s.n, 1);
  s.cnt = min(s.cnt, max(w, 1));
  return s;
}

// Slot s of the row holds element j = s / cnt of sample i = s % cnt, taken
// from row offset (i * 1429) % max(nnz - N + 1, 1) + j (Eq. 3).  Returns
// that offset, or -1 for a dead slot.
__device__ __forceinline__ int aes_slot_offset(const AesRow& r, int s) {
  const int i = s % r.cnt;
  const int j = s / r.cnt;
  const int span = max(r.nnz - r.n + 1, 1);
  const int off = (i * AES_PRIME_NUM) % span + j;
  const bool live = s < r.n * r.cnt && off < r.nnz && r.nnz > 0;
  return live ? off : -1;
}

// Slots a row keeps live (the fused kernel's accumulation bound).
__device__ __forceinline__ int aes_live_width(const AesRow& r) {
  return r.nnz > 0 ? min(r.n * r.cnt, r.w) : 0;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
