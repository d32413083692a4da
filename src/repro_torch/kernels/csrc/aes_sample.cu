// AES sampling pre-pass for Hopper: CSR -> ELL[rows, W] by Table 1 + Eq. 3,
// element j of sample i in slot i + j*cnt, dead slots (val 0, col 0), and
// each row's live width: 1 + its last slot holding anything but the
// sentinel (ell_live_widths of the output, bit for bit), 0 for none.
//
// Replaces the Pallas TPU kernel src/repro/kernels/aes_sample.py:aes_sample
// (_sample_kernel).
//
// Bound: bytes.  The least traffic is the row pointers, one (col, val) read
// per live slot, the [rows, W] (val, col) write and the live widths:
// (rows+1)*4 + sum(live)*8 + rows*W*8 + rows*4.  At W = 128 on a power-law
// graph nearly all of it is the write of dead slots (95% on reddit), so the
// kernel is a zero-fill that must not pay for arithmetic.
// Design: a warp samples kRows = 2 rows at once, a grid apart, rows from a
// grid-stride loop over a persistent grid; both rows' loads are issued
// before either row's stores, and the next rows' row_ptr pairs load while
// these are written (1 row at once measured slower, 4 slower still).  The
// Table 1 strategy is computed once a row; every slot below n*cnt is live
// (Eq. 3 keeps each sample inside the row), every slot at or past it dead.
// Lane i < cnt computes sample i's start (i*1429) % span once, and a slot
// takes its start from lane s % cnt by a shuffle: cnt is 1, 4, 8, 16 or 32
// (a mask and a shift), or, where it is not a power of two, the row keeps
// cnt = w < 32 slots, one a sample, so s is the sample.  No other division.
// A lane writes 4 consecutive slots of val and of col in one 16-byte store
// each where W % 4 == 0 (a warp writes 128 slots, a W = 128 row, in one
// store of each), one slot each otherwise; slots past the live prefix are
// zero stores with no load (streaming stores measured no faster at W =
// 128).  The live width is the warp's largest 1 + slot holding anything
// but the sentinel.  The output is bit-identical to the plain sampler.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 2;  // rows a warp samples at once, their loads in flight
constexpr unsigned kFullMask = 0xffffffffu;

// One row as the warp samples it: slot t < prefix holds element t >> shift
// of sample t & mask, which starts at the row offset lane (t & mask) holds
// in `first`; every slot at or past prefix is dead.  A count of samples
// that is not a power of two keeps one slot a sample (mask ~0, shift 31).
struct RowPlan {
  int start;   // the row's first CSR element
  int prefix;  // n * cnt sampled slots (0 for an empty row)
  int first;   // this lane's sample start, (lane * 1429) % span
  int mask;
  int shift;
};

__device__ __forceinline__ RowPlan plan_row(int lo, int hi, int sh_width,
                                            int lane) {
  const AesRow st = aes_row_strategy(hi - lo, sh_width);
  const bool pow2 = (st.cnt & (st.cnt - 1)) == 0;
  RowPlan p;
  p.start = lo;
  p.prefix = st.nnz > 0 ? st.n * st.cnt : 0;
  p.first = lane < st.cnt
                ? (lane * AES_PRIME_NUM) % max(st.nnz - st.n + 1, 1)
                : 0;
  p.mask = pow2 ? st.cnt - 1 : ~0;
  p.shift = pow2 ? __ffs(st.cnt) - 1 : 31;
  return p;
}

// This lane's K slots from s (of the warp's chunk from s0): the sampled
// (val, col) below the prefix, zeros past it, with no load there.
template <int K>
__device__ __forceinline__ void sample_slots(
    const RowPlan& p, int s0, int s, const int* __restrict__ col_ind,
    const float* __restrict__ val, float (&v)[K], int (&c)[K]) {
  if (s0 < p.prefix) {  // the same for the whole warp: shuffles are safe
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = s + k;
      const int off =
          __shfl_sync(kFullMask, p.first, t & p.mask) + (t >> p.shift);
      const bool live = t < p.prefix;
      v[k] = live ? val[p.start + off] : 0.f;
      c[k] = live ? col_ind[p.start + off] : 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0.f;
      c[k] = 0;
    }
  }
}

// A lane's slots from v / c: one of each, or four in one 16-byte store.
__device__ __forceinline__ void store_slots(float* v, int* c,
                                            const float (&x)[1],
                                            const int (&y)[1]) {
  *v = x[0];
  *c = y[0];
}
__device__ __forceinline__ void store_slots(float* v, int* c,
                                            const float (&x)[4],
                                            const int (&y)[4]) {
  *reinterpret_cast<float4*>(v) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<int4*>(c) = make_int4(y[0], y[1], y[2], y[3]);
}

// K consecutive slots a lane: 4 (16-byte stores; W % 4 == 0) or 1.  Warp w
// of the grid's G samples rows w + G i, kRows of them at once.
template <int K>
__global__ void __launch_bounds__(kThreads)
aes_sample_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col_ind,
                  const float* __restrict__ val, float* __restrict__ out_val,
                  int* __restrict__ out_col, int* __restrict__ out_live,
                  int rows, int sh_width) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int lo[kRows], hi[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = row + u * warps;
    lo[u] = r < rows ? row_ptr[r] : 0;
    hi[u] = r < rows ? row_ptr[r + 1] : 0;
  }
  for (; row < rows; row += kRows * warps) {
    RowPlan p[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      p[u] = plan_row(lo[u], hi[u], sh_width, lane);
      const int r = row + (kRows + u) * warps;  // the next rows' pointers
      lo[u] = r < rows ? row_ptr[r] : 0;
      hi[u] = r < rows ? row_ptr[r + 1] : 0;
    }
    int last[kRows];  // 1 + this lane's last slot that is not the sentinel
#pragma unroll
    for (int u = 0; u < kRows; ++u) last[u] = 0;
    for (int s0 = 0; s0 < sh_width; s0 += 32 * K) {
      const int s = s0 + lane * K;
      float v[kRows][K];
      int c[kRows][K];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        sample_slots<K>(p[u], s0, s, col_ind, val, v[u], c[u]);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (v[u][k] != 0.f || c[u][k] != 0) last[u] = s + k + 1;
        const int64_t r = row + u * warps;
        if (r < rows && s < sh_width)
          store_slots(out_val + r * sh_width + s, out_col + r * sh_width + s,
                      v[u], c[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = row + u * warps;
      const int live = __reduce_max_sync(kFullMask, last[u]);
      if (lane == 0 && r < rows) out_live[r] = live;
    }
  }
}

template <int K>
int launch(const int* row_ptr, const int* col_ind, const float* val,
           float* out_val, int* out_col, int* out_live, int rows,
           int sh_width, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, aes_sample_kernel<K>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (rows + kWarps - 1) / kWarps;
  const int grid = max(1, min(needed, sms * max(per_sm, 1)));
  aes_sample_kernel<K><<<grid, kThreads, 0, stream>>>(
      row_ptr, col_ind, val, out_val, out_col, out_live, rows, sh_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int aes_sample(const int* row_ptr, const int* col_ind,
                          const float* val, float* out_val, int* out_col,
                          int* out_live, int rows, int sh_width,
                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return sh_width % 4 == 0
             ? launch<4>(row_ptr, col_ind, val, out_val, out_col, out_live,
                         rows, sh_width, s)
             : launch<1>(row_ptr, col_ind, val, out_val, out_col, out_live,
                         rows, sh_width, s);
}
