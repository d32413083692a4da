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
// H*4 (bias) + R*H*4 (out); the work is 2*R*F*H transform operations in
// 3xTF32 (three TF32 products each, so at a third of the 495 TFLOP/s TF32
// rate) and 2*sum(live_w)*F aggregation operations on the float32 pipe.
// Both layers are bound by bytes; the gather of B rows is the time.
//
// Design: a persistent grid (#SMs x the blocks that fit, one block of 16
// warps an SM at the main path's widths).  Each warp owns a tile of 16
// rows (the MMA's M) at a time and takes its next one from the block's
// queue (a shared-memory counter; block b owns tiles b, b + grid, ...), so
// a warp that drew light rows takes more tiles (a static split left the
// slowest warp at 2.0x the mean on reddit).  There is no block barrier
// between gather and transform: at any time some warps of an SM gather
// while others run their tile on the tensor cores, so B-row loads stay in
// flight during the transform.  (Before, one barrier made the block wait
// for its slowest warp, and the tile left 3 blocks an SM.)  A warp also
// loads its next tile's live widths before its transform.
// - W and bias: W is pre-split once per block into TF32 hi/lo halves, in
//   the mma B-fragment order (one 16-byte shared load gives a lane its
//   hi and lo pair), padded with zeros to K and N multiples of 8 (H = 1, 5,
//   41 work).  W is cut into 128 x 64 (K x N) tiles; when all of them fit
//   beside the warps' aggregation tiles they are staged once, else they
//   are streamed through one tile of shared memory, with two block
//   barriers a tile (F = H = 2048 takes this path, in the same kernel).
// - Gather: the warp sums its 16 rows' live slots as one list (a scan of
//   the 16 live widths; lane j fetches slot t0 + j's (val, col, row), and
//   the next 32 slots' while the current ones are summed).  Each lane owns
//   4 consecutive features of a 128-feature chunk: one 16-byte (f32),
//   8-byte (u16) or 4-byte (u8) load a slot, 8 slots' loads issued before
//   their FMAs, slots summed in slot order per row; ragged F or an
//   unaligned B take the masked scalar path (common.cuh:lane_load);
//   Eq. 2 is common.cuh:eq2.  Rows land in the warp's shared-memory tile
//   [16][lda] (lda = 4 mod 32: conflict-free fragment reads), zero padded.
// - Transform: mma.sync m16n8k8 TF32 in 3xTF32 (a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi, f32 accumulate: float32-level error; plain TF32 is not
//   used), 8 n-tiles (64 columns) of accumulators a pass; F > 128 adds
//   its 128-feature chunks' sums in float32 (re-gathering per 64 output
//   columns), H > 64 takes more passes over the staged tile.
// - Epilogue: bias, then ReLU (NaN passes, as torch.relu's does), stores
//   masked to the rows and columns that exist.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16;                 // rows of a warp tile (M)
constexpr int kChunkK = 128;                  // features a gather pass
constexpr int kChunkN = 64;                   // output columns a pass
constexpr int kNTiles = kChunkN / 8;          // n8 accumulator tiles
// dynamic shared memory a block may take: the 232448-byte opt-in maximum
// less the static queue counter (and its alignment)
constexpr int kMaxSmem = 232448 - 128;
constexpr int kDefaultSmem = 48 * 1024;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// x = hi + lo with hi and lo TF32 values (f32 bit patterns whose low 13
// mantissa bits are 0), hi rounded to nearest: the 3xTF32 split.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// d += a (16x8, row major) * b (8x8, column major), TF32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [k0, k0 + 128) x columns [n0, n0 + 64) of W, split into TF32 hi/lo
// and laid out as mma B fragments: float4 i = (ks * ntl + t) * 32 + lane
// holds (hi(k, n), hi(k + 4, n), lo(k, n), lo(k + 4, n)) for
// k = k0 + 8 ks + lane % 4 and n = n0 + 8 t + lane / 4; zero outside W.
__device__ void stage_w_tile(const float* __restrict__ w, int feat,
                             int hidden, int kc, int nc, float* dst) {
  const int k0 = kc * kChunkK, n0 = nc * kChunkN;
  const int ksteps = cdiv(min(kChunkK, feat - k0), 8);
  const int ntl = cdiv(min(kChunkN, hidden - n0), 8);
#pragma unroll 4
  for (int i = threadIdx.x; i < ksteps * ntl * 32; i += kThreads) {
    const int lane = i % 32, t = (i / 32) % ntl, ks = i / 32 / ntl;
    const int k = k0 + 8 * ks + lane % 4, n = n0 + 8 * t + lane / 4;
    const bool col_in = n < hidden;
    const float w0 =
        col_in && k < feat ? w[static_cast<int64_t>(k) * hidden + n] : 0.f;
    const float w1 = col_in && k + 4 < feat
                         ? w[static_cast<int64_t>(k + 4) * hidden + n]
                         : 0.f;
    uint32_t h0, l0, h1, l1;
    split_tf32(w0, h0, l0);
    split_tf32(w1, h1, l1);
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(__uint_as_float(h0), __uint_as_float(h1),
                    __uint_as_float(l0), __uint_as_float(l1));
  }
}

// The live width of row row0 + lane for lanes 0-15 of a tile (0 past the
// last row and for lanes 16-31).
__device__ __forceinline__ int tile_count(const int* __restrict__ live_w,
                                          int rows, int width, int row0,
                                          int lane) {
  const int row = row0 + lane;
  return lane < kTileRows && row < rows ? max(min(live_w[row], width), 0)
                                        : 0;
}

// Features [f0, f0 + 128) of the warp's 16-row tile into agg[16][lda]:
// agg[r][j] = sum_{k < live(r)} val[r, k] * B[col[r, k], f0 + j], slots
// summed in slot order; columns past F (up to the chunk rounded to 8) and
// rows with no live slot are 0.  count = tile_count of this lane.
// B-row loads a lane keeps in flight: a power of two up to 32, so a
// 32-slot chunk is whole unroll steps (4 and 16 measured slower, PERF.md).
constexpr int kUnroll = 8;

template <typename T, bool kVec>
__device__ __forceinline__ void gather_tile(
    const float* __restrict__ val, const int* __restrict__ col, int width,
    const T* __restrict__ b, int feat, int f0, float scale, float x_min,
    int row0, int count, float* agg, int lda, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  int incl = count;  // inclusive scan of the 16 live widths
#pragma unroll
  for (int d = 1; d < kTileRows; d *= 2) {
    const int y = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(kAll, incl, kTileRows - 1);
  const int excl = incl - count;
  const int kpad = (min(kChunkK, feat - f0) + 7) & ~7;
  const bool writes = 4 * lane < kpad;
  const int f = f0 + 4 * lane;
  const bool has = f < feat;  // a lane past F sums nothing: its columns 0

  // slot t of the tile's list: its row (the last with excl <= t), value
  // and column; past the list, val 0
  auto fetch = [&](int t, float& v, int& c, int& r) {
    int lo = 0;
#pragma unroll
    for (int s = 8; s >= 1; s /= 2) {
      const int e = __shfl_sync(kAll, excl, lo + s);
      if (e <= t) lo += s;
    }
    const int start = __shfl_sync(kAll, excl, lo);
    r = lo;
    v = 0.f;
    c = 0;
    if (t < total) {
      const int64_t i = static_cast<int64_t>(row0 + lo) * width + t - start;
      v = val[i];
      c = col[i];
    }
  };
  auto flush = [&](int from, int to, const float (&acc)[4]) {
    // rows [from, to): the first gets acc, the rest nothing summed
    for (int r = from; r < to; ++r)
      if (writes)
        *reinterpret_cast<float4*>(agg + r * lda + 4 * lane) =
            r == from ? make_float4(acc[0], acc[1], acc[2], acc[3])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float acc[4] = {};
  int cur = 0;
  float v, nv = 0.f;
  int c, r, nc = 0, nr = 0;
  fetch(lane, v, c, r);
  for (int t0 = 0; t0 < total; t0 += 32) {
    if (t0 + 32 < total) fetch(t0 + 32 + lane, nv, nc, nr);
    const int n = min(32, total - t0);
    for (int k0 = 0; k0 < n; k0 += kUnroll) {
      LaneLoad<kVec, T, 4> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // k0 + u < 32
        const int ck = __shfl_sync(kAll, c, k0 + u);
        if (has && k0 + u < n)
          x[u] = lane_load<kVec, 4>(b, static_cast<int64_t>(ck) * feat, f,
                                    feat, scale, x_min);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float vk = __shfl_sync(kAll, v, k0 + u);
        const int rk = __shfl_sync(kAll, r, k0 + u);
        if (k0 + u < n) {
          if (rk != cur) {
            flush(cur, rk, acc);
            cur = rk;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = 0.f;
          }
          if (has) lane_fma<false>(vk, x[u], scale, x_min, acc);
        }
      }
    }
    v = nv;
    c = nc;
    r = nr;
  }
  flush(cur, kTileRows, acc);
}

// acc[t] += agg[16][0:8 ksteps] @ W tile[:, 8t:8t+8] in 3xTF32.
__device__ __forceinline__ void mma_tile(const float* agg, int lda,
                                         const float* wt, int ksteps,
                                         int ntl, float (&acc)[kNTiles][4],
                                         int lane) {
  const int g = lane / 4, q = lane % 4;
  const float4* wf = reinterpret_cast<const float4*>(wt) + lane;
  for (int ks = 0; ks < ksteps; ++ks) {
    const float* a = agg + 8 * ks + q;
    uint32_t ah[4], al[4];
    split_tf32(a[g * lda], ah[0], al[0]);
    split_tf32(a[(g + 8) * lda], ah[1], al[1]);
    split_tf32(a[g * lda + 4], ah[2], al[2]);
    split_tf32(a[(g + 8) * lda + 4], ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) {
      if (t < ntl) {
        const float4 bw = wf[(ks * ntl + t) * 32];
        const uint32_t bh0 = __float_as_uint(bw.x);
        const uint32_t bh1 = __float_as_uint(bw.y);
        const uint32_t bl0 = __float_as_uint(bw.z);
        const uint32_t bl1 = __float_as_uint(bw.w);
        mma_tf32(acc[t], al, bh0, bh1);  // the small terms first
        mma_tf32(acc[t], ah, bl0, bl1);
        mma_tf32(acc[t], ah, bh0, bh1);
      }
    }
  }
}

// One 16 x 64 output chunk at columns n0: bias, then ReLU (NaN passes, as
// torch.relu's does), stores masked to the rows and columns that exist.
// (Staging the chunk in shared memory for coalesced stores measured
// slower, PERF.md.)
__device__ __forceinline__ void epilogue(const float (&acc)[kNTiles][4],
                                         const float* __restrict__ bias,
                                         float* __restrict__ out, int rows,
                                         int hidden, int row0, int n0,
                                         int ntl, int relu, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int t = 0; t < kNTiles; ++t) {
    if (t >= ntl) continue;
    const int n = n0 + 8 * t + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row >= rows) continue;
      float* o = out + static_cast<int64_t>(row) * hidden;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (n + j < hidden) {
          float v = acc[t][2 * half + j] + __ldg(bias + n + j);
          if (relu && v < 0.f) v = 0.f;  // NaN passes, as torch.relu's does
          o[n + j] = v;
        }
      }
    }
  }
}

// kMultiK: F > 128, so a row tile is gathered one 128-feature chunk at a
// time.  Tensor-core accumulation does not round to nearest, so its error
// grows with the accumulator: all of F = 2048 in one accumulator passed
// 1e-4 of the plain version (PERF.md).  Each chunk therefore sums into
// fresh registers, added to the tile's sums on the float32 pipe.
template <typename T, bool kVec, bool kMultiK>
__global__ void __launch_bounds__(kThreads)
fused_layer_kernel(const float* __restrict__ val, const int* __restrict__ col,
                   const int* __restrict__ live_w, const T* __restrict__ b,
                   const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int rows, int width, int feat, int hidden, int lda,
                   int w_tile_floats, int resident, int relu,
                   const float* __restrict__ scale_p,
                   const float* __restrict__ x_min_p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned int block_next;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kt = cdiv(feat, kChunkK), nt = cdiv(hidden, kChunkN);
  float* wsm = smem;
  float* agg = smem + (resident ? kt * nt : 1) * w_tile_floats +
               warp * kTileRows * lda;
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  const int ksteps_last = cdiv(feat - (kt - 1) * kChunkK, 8);
  const int ntl_last = cdiv(hidden - (nt - 1) * kChunkN, 8);
  const int tiles = cdiv(rows, kTileRows);

  if (threadIdx.x == 0) block_next = 0;
  if (resident) {
    for (int nc = 0; nc < nt; ++nc)
      for (int kc = 0; kc < kt; ++kc)
        stage_w_tile(w, feat, hidden, kc, nc,
                     wsm + (nc * kt + kc) * w_tile_floats);
  }
  __syncthreads();
  // the tile of W for (kc, nc): staged, or streamed in now (then every
  // warp of the block comes here, with a row tile or not)
  auto w_tile = [&](int kc, int nc) -> const float* {
    if (resident) return wsm + (nc * kt + kc) * w_tile_floats;
    __syncthreads();  // every warp is done with the previous tile
    stage_w_tile(w, feat, hidden, kc, nc, wsm);
    __syncthreads();
    return wsm;
  };

  // One row tile: gather, transform, epilogue.  count: this lane's
  // tile_count; prefetch() is called once the tile's gather no longer
  // needs the next tile's live widths to wait.
  auto process = [&](int row0, bool active, int count, auto&& prefetch) {
    if constexpr (!kMultiK) {
      if (active)
        gather_tile<T, kVec>(val, col, width, b, feat, 0, eq2c.x, eq2c.y,
                             row0, count, agg, lda, lane);
      prefetch();  // the next tile's live widths load during the transform
      __syncwarp();
      for (int nc = 0; nc < nt; ++nc) {
        const float* wt = w_tile(0, nc);
        if (!active) continue;
        const int ntl = nc + 1 < nt ? kNTiles : ntl_last;
        float acc[kNTiles][4] = {};
        mma_tile(agg, lda, wt, ksteps_last, ntl, acc, lane);
        epilogue(acc, bias, out, rows, hidden, row0, nc * kChunkN, ntl,
                 relu, lane);
      }
      __syncwarp();  // the tile is read before the next gather writes it
    } else {
      prefetch();
      for (int nc = 0; nc < nt; ++nc) {
        const int ntl = nc + 1 < nt ? kNTiles : ntl_last;
        float acc[kNTiles][4] = {};
        for (int kc = 0; kc < kt; ++kc) {
          const float* wt = w_tile(kc, nc);
          if (!active) continue;
          gather_tile<T, kVec>(val, col, width, b, feat, kc * kChunkK,
                               eq2c.x, eq2c.y, row0, count, agg, lda, lane);
          __syncwarp();
          float part[kNTiles][4] = {};
          mma_tile(agg, lda, wt, kc + 1 < kt ? kChunkK / 8 : ksteps_last,
                   ntl, part, lane);
#pragma unroll
          for (int t = 0; t < kNTiles; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[t][i] += part[t][i];
          __syncwarp();
        }
        if (active)
          epilogue(acc, bias, out, rows, hidden, row0, nc * kChunkN, ntl,
                   relu, lane);
      }
    }
  };

  if (resident) {
    // No block barrier from here on: warps take tiles from the block's
    // queue (block b owns tiles b, b + grid, ...), so a warp that drew
    // light rows takes more of them; the queue runs one tile ahead.
    auto take = [&]() {
      unsigned int j = 0;
      if (lane == 0) j = atomicAdd(&block_next, 1u);
      const unsigned int t =
          blockIdx.x + __shfl_sync(0xffffffffu, j, 0) * gridDim.x;
      return static_cast<int>(min(t, static_cast<unsigned int>(tiles)));
    };
    int tile = take();
    int next = tile < tiles ? take() : tiles;
    int count = tile_count(live_w, rows, width, tile * kTileRows, lane);
    while (tile < tiles) {
      const int this_count = count;
      process(tile * kTileRows, true, this_count, [&]() {
        count = tile_count(live_w, rows, width, next * kTileRows, lane);
      });
      tile = next;
      if (next < tiles) next = take();
    }
  } else {
    // W streams through shared memory: the block's warps walk groups of
    // tiles in step, one barrier pair per W tile
    const int groups = cdiv(tiles, kWarps);
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const int row0 = (grp * kWarps + warp) * kTileRows;
      process(row0, row0 < rows,
              tile_count(live_w, rows, width, row0, lane), []() {});
    }
  }
}

template <typename T, bool kVec, bool kMultiK>
int launch_kernel(const float* val, const int* col, const int* live_w,
                  const T* b, const float* w, const float* bias, float* out,
                  int rows, int width, int feat, int hidden, int relu,
                  const float* scale, const float* x_min,
                  cudaStream_t stream) {
  auto kernel = fused_layer_kernel<T, kVec, kMultiK>;
  // lda = 4 (mod 32): the fragment reads of a tile hit 32 distinct banks
  const int lda = (min(feat, kChunkK) + 31) / 32 * 32 + 4;
  const size_t agg_bytes =
      static_cast<size_t>(kWarps) * kTileRows * lda * sizeof(float);
  const int w_tile_floats =
      cdiv(min(feat, kChunkK), 8) * cdiv(min(hidden, kChunkN), 8) * 32 * 4;
  const size_t tile_bytes = static_cast<size_t>(w_tile_floats) * sizeof(float);
  const size_t tiles = static_cast<size_t>(cdiv(feat, kChunkK)) *
                       cdiv(hidden, kChunkN);
  const int resident = agg_bytes + tiles * tile_bytes <= kMaxSmem;
  const size_t smem = agg_bytes + (resident ? tiles : 1) * tile_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (smem > kDefaultSmem)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = cdiv(rows, kTileRows * kWarps);
  const int grid = max(1, min(groups, sms * max(per_sm, 1)));
  kernel<<<grid, kThreads, smem, stream>>>(
      val, col, live_w, b, w, bias, out, rows, width, feat, hidden, lda,
      w_tile_floats, resident, relu, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* val, const int* col, const int* live_w, const T* b,
           const float* w, const float* bias, float* out, int rows, int width,
           int feat, int hidden, int relu, const float* scale,
           const float* x_min, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  // the vector loads read 4 features at once: 16 / 8 / 4 aligned bytes
  const bool vec = feat % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % (4 * sizeof(T)) == 0;
  const bool multi_k = feat > kChunkK;
#define REPRO_FUSED_LAYER_LAUNCH(V, M)                                      \
  return launch_kernel<T, V, M>(val, col, live_w, b, w, bias, out, rows,    \
                                width, feat, hidden, relu, scale, x_min, s)
  if (vec) {
    if (multi_k) REPRO_FUSED_LAYER_LAUNCH(true, true);
    REPRO_FUSED_LAYER_LAUNCH(true, false);
  }
  if (multi_k) REPRO_FUSED_LAYER_LAUNCH(false, true);
  REPRO_FUSED_LAYER_LAUNCH(false, false);
#undef REPRO_FUSED_LAYER_LAUNCH
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
