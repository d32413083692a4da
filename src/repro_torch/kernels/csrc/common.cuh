// Shared device code for the kernels: the Table 1 strategy of one row
// and the inverse slot map of Algorithm 1; Eq. 2 and the warp-per-row
// live-prefix gather of the ELL SpMM, which the fused layer reuses; plus the
// C entry point that turns a CUDA error code into text for the Python
// wrappers.
//
// The sampler arithmetic is int32, as in the reference sampler
// (repro_torch/core/sampling.py), so the kernels reproduce it bit for bit.
#pragma once

#include <cstdint>

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

// Eq. 2, q * scale + x_min, rounded after the product and after the sum as
// the plain PyTorch version rounds (no FMA contraction): a dequantized value
// is bit-identical to it.
__device__ __forceinline__ float eq2(float q, float scale, float x_min) {
  return __fadd_rn(__fmul_rn(q, scale), x_min);
}

// One element of B as f32: float B as it is, uint8/uint16 B through Eq. 2.
__device__ __forceinline__ float load_feature(const float* b, int64_t i,
                                              float, float) {
  return b[i];
}
__device__ __forceinline__ float load_feature(const uint8_t* b, int64_t i,
                                              float scale, float x_min) {
  return eq2(static_cast<float>(b[i]), scale, x_min);
}
__device__ __forceinline__ float load_feature(const uint16_t* b, int64_t i,
                                              float scale, float x_min) {
  return eq2(static_cast<float>(b[i]), scale, x_min);
}

// Eq. 2's constants from device memory (a launch never waits for the host);
// float B passes null pointers and gets the identity.
__device__ __forceinline__ float2 eq2_constants(const float* scale_p,
                                                const float* x_min_p) {
  return make_float2(scale_p != nullptr ? *scale_p : 1.f,
                     x_min_p != nullptr ? *x_min_p : 0.f);
}

constexpr int kGatherFeatPerLane = 4;
constexpr int kGatherFeatPerPass = 32 * kGatherFeatPerLane;

// dst[f] = sum_{k < live} vrow[k] * B[crow[k], f] for f < feat, computed by
// the one warp that calls it (lane = its lane id).  Lanes run across
// features, so every B row is read coalesced; the warp loads 32 slots of
// (val, col) at once, one per lane, and broadcasts them with shuffles; each
// lane keeps kGatherFeatPerLane accumulators, so one pass covers 128
// features.  Slots are summed in slot order with an f32 accumulator, as the
// plain version does.  By default nvcc contracts a*b+c into FMA, so the sum
// agrees to float tolerance, not bit for bit; kRoundTwice rounds after the
// product and after the sum as the plain version does, which makes the sum
// bit-identical to it however long the row.  The blocked SpMM needs that:
// its "full" rows sum thousands of slots, where FMA drifts past 1e-5 of
// the plain version.  The others keep FMA: rounding twice made ell_spmm
// and the fused layer 4-10% slower on the reddit main path (PERF.md).  dst
// may be global or shared memory.
template <typename T, bool kRoundTwice = false>
__device__ __forceinline__ void warp_gather_row(
    const float* __restrict__ vrow, const int* __restrict__ crow, int live,
    const T* __restrict__ b, int feat, float scale, float x_min, float* dst,
    int lane) {
  for (int f0 = 0; f0 < feat; f0 += kGatherFeatPerPass) {
    float acc[kGatherFeatPerLane];
#pragma unroll
    for (int i = 0; i < kGatherFeatPerLane; ++i) acc[i] = 0.f;

    for (int k0 = 0; k0 < live; k0 += 32) {
      float my_v = 0.f;
      int my_c = 0;
      if (k0 + lane < live) {
        my_v = vrow[k0 + lane];
        my_c = crow[k0 + lane];
      }
      const int n = min(32, live - k0);
      for (int kk = 0; kk < n; ++kk) {
        const float v = __shfl_sync(0xffffffffu, my_v, kk);
        const int c = __shfl_sync(0xffffffffu, my_c, kk);
        const T* brow = b + static_cast<int64_t>(c) * feat;
#pragma unroll
        for (int i = 0; i < kGatherFeatPerLane; ++i) {
          const int f = f0 + i * 32 + lane;
          if (f < feat) {
            const float x = load_feature(brow, f, scale, x_min);
            if constexpr (kRoundTwice) {
              acc[i] = __fadd_rn(acc[i], __fmul_rn(v, x));
            } else {
              acc[i] += v * x;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGatherFeatPerLane; ++i) {
      const int f = f0 + i * 32 + lane;
      if (f < feat) dst[f] = acc[i];
    }
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
