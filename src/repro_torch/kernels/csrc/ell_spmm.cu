// ELL SpMM for Hopper: C[r, :] = sum_{k < live_w[r]} val[r, k] * B[col[r, k], :]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmm.py:ell_spmm
// (_ell_spmm_kernel).  The quantized variants read uint8/uint16 rows of B and
// apply Eq. 2, q * scale + x_min, in the gather; scale and x_min are read
// from device memory, so a launch never waits for the host.
//
// Bound: bytes.  The least traffic reads each input the run needs once and
// writes the output once: sum(live_w)*8 (the live val + col slots) + R*4
// (live_w) + U*F*sizeof(B) (the U distinct rows of B the live slots name)
// + R*F*4 (out).
// Design: one warp per output row (common.cuh:warp_gather_row, shared with
// the fused layer): lanes across features so every B row is read coalesced;
// the warp loads 32 slots of (val, col) at once, one per lane, and
// broadcasts them with shuffles; each lane keeps 4 accumulators, so one
// pass covers 128 features.  Slots are summed in slot order with an f32
// accumulator, as the plain version does; nvcc contracts a*b+c into FMA, so
// results agree to float tolerance, not bit for bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ell_spmm_kernel(const float* __restrict__ val, const int* __restrict__ col,
                const int* __restrict__ live_w, const T* __restrict__ b,
                float* __restrict__ out, int rows, int width, int feat,
                const float* __restrict__ scale_p,
                const float* __restrict__ x_min_p) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
  if (row >= rows) return;  // uniform across the warp
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  warp_gather_row(val + row * width, col + row * width,
                  min(live_w[row], width), b, feat, eq2c.x, eq2c.y,
                  out + row * feat, static_cast<int>(threadIdx.x));
}

template <typename T>
int launch(const float* val, const int* col, const int* live_w, const T* b,
           float* out, int rows, int width, int feat, const float* scale,
           const float* x_min, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ell_spmm_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      val, col, live_w, b, out, rows, width, feat, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ell_spmm_f32(const float* val, const int* col,
                            const int* live_w, const float* b, float* out,
                            int rows, int width, int feat, void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat,
                static_cast<const float*>(nullptr),
                static_cast<const float*>(nullptr), stream);
}

extern "C" int ell_spmm_u8(const float* val, const int* col,
                           const int* live_w, const uint8_t* b, float* out,
                           int rows, int width, int feat, const float* scale,
                           const float* x_min, void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat, scale, x_min,
                stream);
}

extern "C" int ell_spmm_u16(const float* val, const int* col,
                            const int* live_w, const uint16_t* b, float* out,
                            int rows, int width, int feat,
                            const float* scale, const float* x_min,
                            void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat, scale, x_min,
                stream);
}
