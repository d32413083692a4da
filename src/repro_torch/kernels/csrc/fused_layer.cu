// Fused GNN layer for Hopper:
//   out[r, :] = act(sum_{k < live_w[r]} val[r, k] * B[col[r, k], :] @ W
//                   + bias)
// with act = ReLU or identity, on float32 B or on uint8/uint16 B with Eq. 2
// applied in the gather.  The [rows, F] aggregation never reaches device
// memory: only the [rows, H] layer output is written.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_layer.py:
// fused_layer (_fused_layer_kernel).  What is kept from it is what it keeps
// off device memory (the aggregation tile); its sequential per-row B-row
// DMA loop is not carried over.
//
// Bound, at the GCN layers of the main path (reddit, W=128): the least
// traffic is sum(live_w)*8 (live val + col slots) + R*4 (live_w) +
// U*F*sizeof(B) (the U distinct B rows the live slots name) + F*H*4 (W) +
// H*4 (bias) + R*H*4 (out); the work is 2*R*F*H (the transform) +
// 2*sum(live_w)*F (the aggregation) float32 operations.  Layer 1 (F=128,
// H=64) is bound by operations on the float32 pipe, layer 2 (F=64, H=41)
// by bytes.
// Design: one block of 8 warps covers block_rows rows (a multiple of 4,
// up to 32, chosen at launch so the tile takes about 64 KiB at most).
// Phase 1: each warp gathers whole rows into the shared-memory tile
// agg[block_rows][ld] (ld = F rounded up to 4, zero padded) with the ELL
// SpMM's warp loop (common.cuh:warp_gather_row, Eq. 2 in the load).
// Phase 2, after one barrier: each thread owns one output column h for 4
// rows, reads agg as float4 broadcasts and W[f, h] coalesced across h (W is
// L1/L2 resident), and sums in ascending f with float32 FMA (no tensor
// cores and no TF32, so the result matches the plain version to float
// tolerance); then bias, ReLU, and one store per output.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerThread = 4;   // phase 2 register block
constexpr int kMaxRows = 32;
constexpr int kTargetSmem = 64 * 1024;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_layer_kernel(const float* __restrict__ val, const int* __restrict__ col,
                   const int* __restrict__ live_w, const T* __restrict__ b,
                   const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int rows, int width, int feat, int hidden, int ld,
                   int block_rows, int relu,
                   const float* __restrict__ scale_p,
                   const float* __restrict__ x_min_p) {
  extern __shared__ __align__(16) float agg[];  // [block_rows][ld]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float2 eq2c = eq2_constants(scale_p, x_min_p);

  // Phase 1: the aggregation tile, one warp per row.
  for (int r = warp; r < block_rows; r += kWarps) {
    const int64_t row = row0 + r;
    float* dst = agg + static_cast<int64_t>(r) * ld;
    if (row < rows) {
      warp_gather_row(val + row * width, col + row * width,
                      min(live_w[row], width), b, feat, eq2c.x, eq2c.y, dst,
                      lane);
      for (int f = feat + lane; f < ld; f += 32) dst[f] = 0.f;
    } else {
      for (int f = lane; f < ld; f += 32) dst[f] = 0.f;
    }
  }
  __syncthreads();

  // Phase 2: the dense transform on the tile, 4 rows x 1 column a thread.
  const int groups = block_rows / kRowsPerThread;
  for (int item = threadIdx.x; item < groups * hidden; item += kThreads) {
    const int g = item / hidden;
    const int h = item % hidden;
    const float* a = agg + static_cast<int64_t>(g) * kRowsPerThread * ld;
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    for (int f = 0; f < feat; f += 4) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = f + j < feat ? w[static_cast<int64_t>(f + j) * hidden + h]
                             : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a + i * ld + f);
        acc[i] = fmaf(av.x, wv[0], acc[i]);
        acc[i] = fmaf(av.y, wv[1], acc[i]);
        acc[i] = fmaf(av.z, wv[2], acc[i]);
        acc[i] = fmaf(av.w, wv[3], acc[i]);
      }
    }
    const float bh = bias[h];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int64_t row = row0 + g * kRowsPerThread + i;
      if (row < rows) {
        float v = acc[i] + bh;
        if (relu && v < 0.f) v = 0.f;  // NaN passes, as torch.relu's does
        out[row * hidden + h] = v;
      }
    }
  }
}

template <typename T>
int launch(const float* val, const int* col, const int* live_w, const T* b,
           const float* w, const float* bias, float* out, int rows, int width,
           int feat, int hidden, int relu, const float* scale,
           const float* x_min, void* stream) {
  const int ld = (feat + 3) / 4 * 4;
  int block_rows = ld > 0 ? kTargetSmem / (ld * 4) : kMaxRows;
  block_rows = max(kRowsPerThread, min(kMaxRows, block_rows));
  block_rows = block_rows / kRowsPerThread * kRowsPerThread;
  const size_t smem = static_cast<size_t>(block_rows) * ld * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (rows + block_rows - 1) / block_rows;
  fused_layer_kernel<T><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      val, col, live_w, b, w, bias, out, rows, width, feat, hidden, ld,
      block_rows, relu, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_layer_f32(const float* val, const int* col,
                               const int* live_w, const float* b,
                               const float* w, const float* bias, float* out,
                               int rows, int width, int feat, int hidden,
                               int relu, void* stream) {
  return launch(val, col, live_w, b, w, bias, out, rows, width, feat, hidden,
                relu, static_cast<const float*>(nullptr),
                static_cast<const float*>(nullptr), stream);
}

extern "C" int fused_layer_u8(const float* val, const int* col,
                              const int* live_w, const uint8_t* b,
                              const float* w, const float* bias, float* out,
                              int rows, int width, int feat, int hidden,
                              int relu, const float* scale,
                              const float* x_min, void* stream) {
  return launch(val, col, live_w, b, w, bias, out, rows, width, feat, hidden,
                relu, scale, x_min, stream);
}

extern "C" int fused_layer_u16(const float* val, const int* col,
                               const int* live_w, const uint16_t* b,
                               const float* w, const float* bias, float* out,
                               int rows, int width, int feat, int hidden,
                               int relu, const float* scale,
                               const float* x_min, void* stream) {
  return launch(val, col, live_w, b, w, bias, out, rows, width, feat, hidden,
                relu, scale, x_min, stream);
}
