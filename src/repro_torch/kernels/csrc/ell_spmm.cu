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
// + R*F*4 (out).  Rows keep few live slots on power-law graphs (7.1 on
// reddit at W = 128) and name B rows at random, so a row is a chain of
// dependent loads (its live width and (val, col), then its B rows), and
// what the kernel reaches is set by how many B rows it keeps in flight.
// Design: common.cuh:group_gather_row, shared with the blocked SpMM.
// - Lane groups: a row gets G of a warp's lanes (4, 8, 16 or 32), each
//   lane K consecutive features in one vector load a slot: 16 bytes (4
//   f32, 8 uint16, 16 uint8) where rows hold at most 32 slots, else 4
//   features (16, 8 or 4 bytes).  G is the fewest lanes that cover F (up
//   to 128 features or 16 bytes x 32), so F = 64 puts 2 rows in a warp.
//   At W = 128 a uint8 row gets the whole warp: with 16 bytes a lane, 4
//   rows shared a warp, which ran until the longest ended (PERF.md).
// - Each lane issues the B loads of 4 slots before their FMAs (2 and 8
//   were slower); the row's first G (val, col) slots load beside its live
//   width, the next G while the current G's B rows load.
// - Rows run in row order over all of F.  L2-sized feature slices (every
//   row of one slice before the next) lost on reddit at F = 128, where a
//   slice narrower than F multiplies each row's chain, and paid only at
//   F = 512, wider than any dataset of the repo (PERF.md).
// - Slots are summed in slot order with an f32 accumulator, rounded after
//   the product and after the sum as the plain version does, so the
//   result is bit-identical to it at any row
//   length; with FMA a hub row of 2048 live slots drifted 2.1e-5 from it,
//   and FMA was barely faster (PERF.md).  Ragged F or an unaligned B take
//   masked scalar loads.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T, bool kVec, int G, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ell_spmm_kernel(const float* __restrict__ val, const int* __restrict__ col,
                const int* __restrict__ live_w, const T* __restrict__ b,
                float* __restrict__ out, int rows, int width, int feat,
                const float* __restrict__ scale_p,
                const float* __restrict__ x_min_p) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y) *
      kRowsPerWarp;
  if (first >= rows) return;  // uniform across the warp
  const int64_t row = first + lane / G;
  const bool in = row < rows;
  const int64_t r = in ? row : first;
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  group_gather_row<G, K, kVec>(
      val + r * width, col + r * width, in ? width : 0,
      in ? min(live_w[r], width) : 0, b, feat, eq2c.x, eq2c.y,
      in ? out + r * feat : nullptr, lane);
}

template <typename T>
int launch(const float* val, const int* col, const int* live_w, const T* b,
           float* out, int rows, int width, int feat, const float* scale,
           const float* x_min, void* stream) {
  return dispatch_gather(
      b, feat, width, [&](auto kvec, auto group, auto lanef) {
        constexpr int G = decltype(group)::value;
        constexpr int rows_per_block = kWarpsPerBlock * 32 / G;
        const dim3 block(32, kWarpsPerBlock);
        const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
        ell_spmm_kernel<T, decltype(kvec)::value, G, decltype(lanef)::value>
            <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
                val, col, live_w, b, out, rows, width, feat, scale, x_min);
        return static_cast<int>(cudaGetLastError());
      });
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
