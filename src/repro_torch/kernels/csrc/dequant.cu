// Feature dequantization for Hopper (paper Eq. 2): out = q * scale + x_min,
// uint8/uint16 [n, f] -> float32 [n, f], elementwise.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant.py:dequantize
// (_dequant_kernel).
//
// Bound: bytes.  Each element is read once (1 or 2 bytes) and written once
// (4 bytes); 2 operations per element are far below the float32 rate.
// Design: a grid-stride pass, one wave of blocks, in which each thread
// takes 4 consecutive elements per step (one 4-byte uint8 or 8-byte uint16
// load) and writes them as one float4, so a warp's loads and stores each
// cover one contiguous span; a scalar tail, and a scalar pass for a q or an
// out not aligned to the vector.  (A first version loaded 16 bytes of q a
// thread and wrote 64 contiguous bytes a thread: its warp-wide stores were
// strided and it reached 31% of the bound on uint8.)  scale and x_min are
// read from device memory, so no host read is needed; Eq. 2 is rounded
// after the product and after the sum (common.cuh:eq2), so the result is
// bit-identical to the plain PyTorch version.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // one wave: 2048 threads on each SM

template <typename T> struct Vec4;  // 4 elements of T, loaded at once
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const T* __restrict__ q, float* __restrict__ out, int64_t n,
               int64_t n_vec, const float* __restrict__ scale_p,
               const float* __restrict__ x_min_p) {
  using V = typename Vec4<T>::type;
  const float scale = *scale_p;
  const float x_min = *x_min_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  for (int64_t v = tid; v < n_vec; v += stride) {
    const V e = reinterpret_cast<const V*>(q)[v];
    reinterpret_cast<float4*>(out)[v] = make_float4(
        eq2(static_cast<float>(e.x), scale, x_min),
        eq2(static_cast<float>(e.y), scale, x_min),
        eq2(static_cast<float>(e.z), scale, x_min),
        eq2(static_cast<float>(e.w), scale, x_min));
  }
  for (int64_t i = n_vec * 4 + tid; i < n; i += stride)
    out[i] = eq2(static_cast<float>(q[i]), scale, x_min);
}

template <typename T>
int launch(const T* q, float* out, int64_t n, const float* scale,
           const float* x_min, void* stream) {
  // out comes from the caching allocator (aligned); q may be a view
  const bool aligned = reinterpret_cast<uintptr_t>(q) % (4 * sizeof(T)) == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_vec = aligned ? n / 4 : 0;
  const int64_t work = n_vec > 0 ? n_vec : n;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  dequant_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, out, n, n_vec, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dequant_u8(const uint8_t* q, float* out, int64_t n,
                          const float* scale, const float* x_min,
                          void* stream) {
  return launch(q, out, n, scale, x_min, stream);
}

extern "C" int dequant_u16(const uint16_t* q, float* out, int64_t n,
                           const float* scale, const float* x_min,
                           void* stream) {
  return launch(q, out, n, scale, x_min, stream);
}
