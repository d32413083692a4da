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
// needed one launch per width bucket.  Here one warp computes one output
// row with common.cuh:warp_gather_row (shared with ell_spmm and the fused
// layer): it reads its block's (id, offset, width) entry, which the
// wrapper keeps on the card per operand and bucket partition, and walks the
// row's live slots from global memory in warp-wide chunks of 32, so a
// "full" block thousands of slots wide needs no staging buffer, and lanes
// run across features with masked tails (no padding of F).  A launch covers
// the blocks of one width bucket (the bucket API the tuner times), and every
// row is written straight to its natural position in the one [num_rows, F]
// output, so no reassembly pass follows; rows of blocks outside the launch
// are left as they are (the wrapper zeroes the output for a partial
// partition).  Padded rows of the last block are never written.  The
// gather rounds after the product and after the sum (kRoundTwice), as the
// plain version does, so a "full" row thousands of slots long stays
// bit-identical to it (with FMA such a row drifted past 1e-5).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// blocks: int64 [n_blocks, 3], (block id, slot offset, width) of each block
// this launch covers, in launch order: a warp reads its block's entry with
// one dependent load before it gathers.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
block_ell_spmm_kernel(const int64_t* __restrict__ blocks, int n_blocks,
                      const int* __restrict__ live_w,
                      const float* __restrict__ val,
                      const int* __restrict__ col, const T* __restrict__ b,
                      float* __restrict__ out, int block_rows, int num_rows,
                      int feat, const float* __restrict__ scale_p,
                      const float* __restrict__ x_min_p) {
  // n_blocks * block_rows < 2^31 (the wrapper checks it)
  const int g = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (g >= n_blocks * block_rows) return;  // uniform across the warp
  const int e = g / block_rows;
  const int r = g - e * block_rows;
  const int64_t* entry = blocks + 3 * e;
  const int64_t row = entry[0] * block_rows + r;
  if (row >= num_rows) return;  // padded row of the last block
  const int width = static_cast<int>(entry[2]);
  const int64_t seg = entry[1] + static_cast<int64_t>(r) * width;
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  warp_gather_row<T, true>(val + seg, col + seg, min(live_w[row], width), b,
                           feat, eq2c.x, eq2c.y, out + row * feat,
                           static_cast<int>(threadIdx.x));
}

template <typename T>
int launch(const int64_t* blocks, int n_blocks, const int* live_w,
           const float* val, const int* col, const T* b, float* out,
           int block_rows, int num_rows, int feat, const float* scale,
           const float* x_min, void* stream) {
  const int64_t warps = static_cast<int64_t>(n_blocks) * block_rows;
  const dim3 block(32, kWarpsPerBlock);
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  block_ell_spmm_kernel<T>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          blocks, n_blocks, live_w, val, col, b, out, block_rows, num_rows,
          feat, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_ell_spmm_f32(const int64_t* blocks, int n_blocks,
                                  const int* live_w, const float* val,
                                  const int* col, const float* b, float* out,
                                  int block_rows, int num_rows, int feat,
                                  void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, static_cast<const float*>(nullptr),
                static_cast<const float*>(nullptr), stream);
}

extern "C" int block_ell_spmm_u8(const int64_t* blocks, int n_blocks,
                                 const int* live_w, const float* val,
                                 const int* col, const uint8_t* b, float* out,
                                 int block_rows, int num_rows, int feat,
                                 const float* scale, const float* x_min,
                                 void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, scale, x_min, stream);
}

extern "C" int block_ell_spmm_u16(const int64_t* blocks, int n_blocks,
                                  const int* live_w, const float* val,
                                  const int* col, const uint16_t* b,
                                  float* out, int block_rows, int num_rows,
                                  int feat, const float* scale,
                                  const float* x_min, void* stream) {
  return launch(blocks, n_blocks, live_w, val, col, b, out, block_rows,
                num_rows, feat, scale, x_min, stream);
}
