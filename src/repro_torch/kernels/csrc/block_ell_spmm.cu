// Blocked ELL SpMM for Hopper, over a mixed-width BlockELL:
//   C[r, :] = sum_{k < min(live_w[r], width_b)} val[s + k] * B[col[s + k], :]
// with s = off_b + r_b * width_b,
// where b = r / block_rows is the row's block, r_b = r % block_rows its row
// inside the block, and (off_b, width_b) the block's slot offset and width.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ell_spmm.py:block_ell_spmm
// (_block_ell_spmm_kernel).  The quantized variants read uint8/uint16 rows of
// B and apply Eq. 2, q * scale + x_min, in the gather; scale and x_min are
// read from device memory, so a launch never waits for the host.
//
// Bound: bytes.  The least traffic reads each input the run needs once and
// writes the output once: sum(min(live_w, width))*8 (the live val + col
// slots) + rows*4 (live_w) + 24 bytes a block (its entry) + U*F*sizeof(B)
// (the U distinct rows of B the live slots name) + rows*F*4 (out).
// Design: the TPU kernel staged each row's max-width slots in VMEM with a
// fixed-size DMA, which is why the flat arrays are over-padded and why it
// needed one launch per width bucket.  Here a group of lanes computes one
// output row with common.cuh:group_gather_row, the gather of ell_spmm.cu
// (4-32 lanes a row, one vector load a lane a slot, 16 bytes where the
// launch's blocks hold at most 32 slots a row, 4 slots' B rows in flight a
// lane).  A group reads its block's (id, offset, width)
// entry through the read-only cache (__ldg): the rows of a CTA (4-32)
// share it almost always, so it comes from L2 once a CTA.  It then walks
// the row's live slots from global memory in chunks of one slot a lane,
// so a "full" block thousands of slots wide needs no staging buffer, and
// masks ragged F (no padding of F).  A launch covers the blocks of one
// width bucket (the bucket API the tuner times; the wrapper passes the
// widest of them, max_width, which picks the lanes), and every row is
// written straight to its natural position in the one [num_rows, F]
// output, so no reassembly pass follows; rows of blocks outside the
// launch are left as they are (the wrapper zeroes the output for a
// partial partition).  Padded rows of the last block are never written.
// The gather rounds after the product and after the sum, as the plain
// version does, so a "full" row thousands of slots long stays
// bit-identical to it (with FMA such a row drifted past 1e-5).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// blocks: int64 [n_blocks, 3], (block id, slot offset, width) of each block
// this launch covers, in launch order.
template <typename T, bool kVec, int G, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
block_ell_spmm_kernel(const int64_t* __restrict__ blocks, int n_blocks,
                      const int* __restrict__ live_w,
                      const float* __restrict__ val,
                      const int* __restrict__ col, const T* __restrict__ b,
                      float* __restrict__ out, int block_rows, int num_rows,
                      int feat, const float* __restrict__ scale_p,
                      const float* __restrict__ x_min_p) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = static_cast<int>(threadIdx.x);
  // n_blocks * block_rows < 2^31 (the wrapper checks it)
  const int total = n_blocks * block_rows;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.y) *
      kRowsPerWarp;
  if (first >= total) return;  // uniform across the warp
  const int g = static_cast<int>(first) + lane / G;
  int64_t row = num_rows, seg = 0;
  int width = 0;
  if (g < total) {
    const int e = g / block_rows;
    const int r = g - e * block_rows;
    const auto* entry = reinterpret_cast<const long long*>(blocks + 3 * e);
    width = static_cast<int>(__ldg(entry + 2));
    row = __ldg(entry) * block_rows + r;
    seg = __ldg(entry + 1) + static_cast<int64_t>(r) * width;
  }
  const bool in = row < num_rows;  // else past the launch or a padded row
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  group_gather_row<G, K, kVec>(
      val + seg, col + seg, in ? width : 0,
      in ? min(__ldg(live_w + row), width) : 0, b, feat, feat, eq2c.x,
      eq2c.y, in ? out + row * feat : nullptr, lane);
}

template <typename T>
int launch(const int64_t* blocks, int n_blocks, const int* live_w,
           const float* val, const int* col, const T* b, float* out,
           int block_rows, int num_rows, int feat, int max_width,
           const float* scale, const float* x_min, void* stream) {
  const int64_t rows = static_cast<int64_t>(n_blocks) * block_rows;
  return dispatch_gather(
      b, feat, max_width, [&](auto kvec, auto group, auto lanef) {
        constexpr int G = decltype(group)::value;
        constexpr int rows_per_block = kWarpsPerBlock * 32 / G;
        const dim3 block(32, kWarpsPerBlock);
        const dim3 grid(static_cast<unsigned>((rows + rows_per_block - 1) /
                                              rows_per_block));
        block_ell_spmm_kernel<T, decltype(kvec)::value, G,
                              decltype(lanef)::value>
            <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
                blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, scale, x_min);
        return static_cast<int>(cudaGetLastError());
      });
}

}  // namespace

extern "C" int block_ell_spmm_f32(const int64_t* blocks, int n_blocks,
                                  const int* live_w, const float* val,
                                  const int* col, const float* b, float* out,
                                  int block_rows, int num_rows, int feat,
                                  int max_width, void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, max_width,
                static_cast<const float*>(nullptr),
                static_cast<const float*>(nullptr), stream);
}

extern "C" int block_ell_spmm_u8(const int64_t* blocks, int n_blocks,
                                 const int* live_w, const float* val,
                                 const int* col, const uint8_t* b, float* out,
                                 int block_rows, int num_rows, int feat,
                                 int max_width, const float* scale,
                                 const float* x_min, void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, max_width, scale, x_min, stream);
}

extern "C" int block_ell_spmm_u16(const int64_t* blocks, int n_blocks,
                                  const int* live_w, const float* val,
                                  const int* col, const uint16_t* b,
                                  float* out, int block_rows, int num_rows,
                                  int feat, int max_width,
                                  const float* scale, const float* x_min,
                                  void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, max_width, scale, x_min, stream);
}
