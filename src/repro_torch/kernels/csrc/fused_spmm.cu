// Fused AES-SpMM for Hopper (paper Algorithm 1 in one kernel): sample each
// row into __shared__ sh_val/sh_col, then accumulate over the live slots.
// No ELL operand is written to device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_spmm.py:
// fused_aes_spmm (_fused_kernel).
//
// Bound: bytes.  The least traffic reads each input the run needs once and
// writes the output once: the row pointers, one (col, val) pair per live
// slot, the U distinct B rows the live slots name, and the output:
// (rows+1)*4 + sum(live)*8 + U*F*4 + rows*F*4.  (Charging one B row per
// live slot instead, sum(live)*F*4, gives the no-reuse gather bound.)
// Rows keep few live slots on power-law graphs (about 7 on reddit), so a
// row's time is its chain of dependent loads: its row_ptr pair, then its
// sampled (val, col), then the B rows they name.
// Design: one warp per row, a persistent grid of one 32-warp block an SM.
// Block b owns rows b, b + grid, ...; its warps take them one at a time
// from the block's queue (a shared-memory counter), so a warp that drew
// short rows takes more of them (a static split of reddit's rows left the
// slowest warp at 3.7x the mean; what is left is the spread between
// blocks).  Each warp owns a 128-slot chunk of the paper's sh_val/sh_col
// (1 KiB); a wider W loops over chunks, so no W needs opt-in shared
// memory.  The chain is pipelined across rows: while a row's B loads are
// in flight, the warp already holds the next row's row_ptr pair, computes
// its sample offsets (common.cuh:aes_slot_offset, the reference sampler's
// int32 arithmetic) and loads its first chunk of (val, col) into registers
// (4 slots a lane), and loads the row_ptr pair of the row after it.  The
// gather gives each lane 4 consecutive features (F = 128 is one float4 a
// lane a slot), issues up to 8 slots' B loads before their FMAs, and sums
// in slot order; F > 128 takes several passes; ragged F or an unaligned B
// takes the masked scalar path.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;                    // slots staged per warp
constexpr int kSlotsPerLane = kChunk / 32;
constexpr int kFeatPerPass = 128;              // 32 lanes x 4 features
constexpr int kUnroll = 8;                     // B rows in flight per lane

struct RowPlan {
  int start;  // the row's first CSR element
  AesRow st;
  int live;   // slots summed (aes_live_width)
};

__device__ __forceinline__ RowPlan plan_row(int start, int end,
                                            int sh_width) {
  RowPlan p;
  p.start = start;
  p.st = aes_row_strategy(end - start, sh_width);
  p.live = aes_live_width(p.st);
  return p;
}

// This lane's slots s0 + lane + 32 i of the row (Alg. 1's inverse slot
// map): (val, col) of the CSR element each names, 0 / 0 for a dead slot
// or one past the live width.
__device__ __forceinline__ void load_samples(
    const int* __restrict__ col_ind, const float* __restrict__ val,
    const RowPlan& p, int s0, int lane, float (&v)[kSlotsPerLane],
    int (&c)[kSlotsPerLane]) {
#pragma unroll
  for (int i = 0; i < kSlotsPerLane; ++i) {
    const int s = s0 + lane + 32 * i;
    const int off = s < p.live ? aes_slot_offset(p.st, s) : -1;
    v[i] = off >= 0 ? val[p.start + off] : 0.f;
    c[i] = off >= 0 ? col_ind[p.start + off] : 0;
  }
}

__device__ __forceinline__ void store_samples(
    float* sh_val, int* sh_col, const float (&v)[kSlotsPerLane],
    const int (&c)[kSlotsPerLane], int lane) {
#pragma unroll
  for (int i = 0; i < kSlotsPerLane; ++i) {
    sh_val[lane + 32 * i] = v[i];
    sh_col[lane + 32 * i] = c[i];
  }
}

// acc += sum_{k < n} sh_val[k] * B[sh_col[k], f..f+3], in slot order
// (nothing for a lane at or past F).
template <bool kVec>
__device__ __forceinline__ void gather_staged(const float* sh_val,
                                              const int* sh_col, int n,
                                              const float* __restrict__ b,
                                              int feat, int f,
                                              float (&acc)[4]) {
  if (f >= feat) return;
  for (int k0 = 0; k0 < n; k0 += kUnroll) {
    LaneLoad<kVec, float, 4> x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k0 + u < n)
        x[u] = lane_load<kVec, 4>(
            b, static_cast<int64_t>(sh_col[k0 + u]) * feat, f, feat, 1.f,
            0.f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k0 + u < n) lane_fma<false>(sh_val[k0 + u], x[u], 1.f, 0.f, acc);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
fused_aes_spmm_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ col_ind,
                      const float* __restrict__ val,
                      const float* __restrict__ b, float* __restrict__ out,
                      int rows, int feat, int sh_width) {
  __shared__ float sh_val_all[kWarps][kChunk];
  __shared__ int sh_col_all[kWarps][kChunk];
  __shared__ unsigned int block_next;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sh_val = sh_val_all[warp];
  int* sh_col = sh_col_all[warp];
  if (threadIdx.x == 0) block_next = 0;
  __syncthreads();  // the only block barrier
  // the warp's next row from the block's queue: block b owns rows b,
  // b + grid, ... (rows once they are all taken)
  auto take = [&]() {
    unsigned int j = 0;
    if (lane == 0) j = atomicAdd(&block_next, 1u);
    const unsigned int row =
        blockIdx.x + __shfl_sync(0xffffffffu, j, 0) * gridDim.x;
    return static_cast<int>(min(row, static_cast<unsigned int>(rows)));
  };

  // prologue: this row's plan and first chunk; the next row and its
  // row_ptr pair
  int row = take();
  RowPlan cur{};
  float v[kSlotsPerLane];
  int c[kSlotsPerLane];
  int next = rows, nstart = 0, nend = 0;
  if (row < rows) {
    cur = plan_row(row_ptr[row], row_ptr[row + 1], sh_width);
    load_samples(col_ind, val, cur, 0, lane, v, c);
    next = take();
    if (next < rows) {
      nstart = row_ptr[next];
      nend = row_ptr[next + 1];
    }
  }

  while (row < rows) {
    __syncwarp();  // the previous row is done with the staging chunk
    store_samples(sh_val, sh_col, v, c, lane);
    __syncwarp();
    // the next row: its plan and first chunk, and the row_ptr pair of the
    // row after it, all in flight while this row's B rows load
    RowPlan nxt = cur;
    int after = rows;
    if (next < rows) {
      nxt = plan_row(nstart, nend, sh_width);
      load_samples(col_ind, val, nxt, 0, lane, v, c);
      after = take();
      if (after < rows) {
        nstart = row_ptr[after];
        nend = row_ptr[after + 1];
      }
    }

    const int chunks = (cur.live + kChunk - 1) / kChunk;
    float* orow = out + static_cast<int64_t>(row) * feat;
    for (int f0 = 0; f0 < feat; f0 += kFeatPerPass) {
      const int f = f0 + 4 * lane;
      float acc[4] = {};
      for (int ch = 0; ch < chunks; ++ch) {
        // chunk 0 was staged above and stays while it is the only one
        if (ch > 0 || (f0 > 0 && chunks > 1)) {
          float tv[kSlotsPerLane];
          int tc[kSlotsPerLane];
          load_samples(col_ind, val, cur, ch * kChunk, lane, tv, tc);
          __syncwarp();
          store_samples(sh_val, sh_col, tv, tc, lane);
          __syncwarp();
        }
        gather_staged<kVec>(sh_val, sh_col,
                            min(kChunk, cur.live - ch * kChunk), b, feat, f,
                            acc);
      }
      if (f < feat) lane_store<kVec>(orow, f, feat, acc);
    }
    cur = nxt;
    row = next;
    next = after;
  }
}

template <bool kVec>
int launch(const int* row_ptr, const int* col_ind, const float* val,
           const float* b, float* out, int rows, int feat, int sh_width,
           cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_aes_spmm_kernel<kVec>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (rows + kWarps - 1) / kWarps;
  const int grid = max(1, min(needed, sms * max(per_sm, 1)));
  fused_aes_spmm_kernel<kVec><<<grid, kThreads, 0, stream>>>(
      row_ptr, col_ind, val, b, out, rows, feat, sh_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_aes_spmm(const int* row_ptr, const int* col_ind,
                              const float* val, const float* b, float* out,
                              int rows, int feat, int sh_width,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = feat % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % sizeof(float4) == 0;
  return vec ? launch<true>(row_ptr, col_ind, val, b, out, rows, feat,
                            sh_width, s)
             : launch<false>(row_ptr, col_ind, val, b, out, rows, feat,
                             sh_width, s);
}
