// Feature dequantization for Hopper (paper Eq. 2): out = q * scale + x_min,
// uint8/uint16 [n, f] -> float32 [n, f], elementwise, with one (scale,
// x_min) pair for the whole matrix or one pair for each of S equal segments
// of its rows (a stack of shards, each quantized with its own range).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant.py:dequantize
// (_dequant_kernel).
//
// Bound: bytes.  Each element is read once (1 or 2 bytes) and written once
// (4 bytes); 2 operations per element are far below the float32 rate.  At
// 3.35 TB/s the card wants megabytes of loads in flight, so a thread must
// not wait on one small load before its stores (an earlier version loaded 4
// bytes of q a thread and step, and one wave of blocks held about 8 KB of q
// in flight an SM: 77% of the bound on uint8, this one 80%).
//
// Design: the elements split into the S segments, each segment into tiles
// of kUnroll * 512 bytes of q.  A warp takes a tile at a time (grid-stride
// over all segments' tiles, so a tile never straddles two segments and
// reads its segment's constants once) and issues kUnroll 16-byte loads of
// q a lane, non-allocating (q is read once), each warp-wide load 512
// contiguous bytes, before its first store.  One 16-byte load holds 16
// (uint16: 8) consecutive elements, 64 (32) bytes of output; so that every
// warp-wide float4 store covers 512 contiguous bytes too, the warp passes
// its loads through shared memory: lane l writes its 16 bytes at 16 l,
// then reads the 4-element groups l, 32 + l, ... of the chunk.  A
// segment's vector body starts at its first element whose q and out are
// both 16-byte aligned; the elements before it (the head) and after its
// last whole vector (the tail), fewer than 16 each, are converted one a
// lane by the warp that takes the segment's first tile.  Where q and out
// cannot be aligned at one element together (a view of q that starts off
// its vector grid), every element takes the scalar path, 32 contiguous
// elements a warp step.  scale and x_min are read from device memory, so
// no host read is needed; Eq. 2 is rounded after the product and after
// the sum (common.cuh:eq2), so the result is bit-identical to the plain
// PyTorch version.  Measured against this (PERF.md): 8 loads a lane and
// streaming stores were no faster; 32 registers a thread (forced, it
// spilled) was 30% slower; a persistent grid whose blocks fill a 4- or
// 8-stage shared-memory ring of 4 or 8 KB q tiles by 1D TMA
// (cp.async.bulk on an mbarrier) and convert from it was slower too, 76-77%
// of the bound on uint8.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // 16-byte loads of q a lane issues at once
constexpr int kEdge = 16;    // lanes for a segment's head; the rest, its tail

template <typename T> struct Geo {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a load
  static constexpr int kGroups = kVec / 4;     // float4 stores a load feeds
  static constexpr int kTile = kUnroll * 32 * kVec;  // elements a tile
};

// 4 consecutive elements of T, one float4 of output: 4 bytes of uint8, 8
// of uint16.
template <typename T> struct Group;
template <> struct Group<uint8_t> { using type = uint32_t; };
template <> struct Group<uint16_t> { using type = uint2; };

__device__ __forceinline__ float4 group_values(uint32_t w, float scale,
                                               float x_min) {
  float v[4];
  word_values(w, scale, x_min, v);
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float4 group_values(uint2 w, float scale,
                                               float x_min) {
  float lo[2], hi[2];
  word_values(w.x, scale, x_min, lo);
  word_values(w.y, scale, x_min, hi);
  return make_float4(lo[0], lo[1], hi[0], hi[1]);
}

// 16 bytes of q, read once: kept out of L1.
__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// seg: elements a segment (n / S); per_seg: tiles a segment; tiles: S *
// per_seg; q_mis: q's element offset from its 16-byte grid (kAligned: out
// is 16-byte aligned at the same elements).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const T* __restrict__ q, float* __restrict__ out, int64_t seg,
               int64_t per_seg, int64_t tiles, int q_mis,
               const float* __restrict__ scale_p,
               const float* __restrict__ x_min_p) {
  using G = Geo<T>;
  using Grp = typename Group<T>::type;
  __shared__ uint4 stage[kWarps][kUnroll][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const Grp* groups = reinterpret_cast<const Grp*>(&stage[warp][0][0]);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
       t < tiles; t += warps) {
    const int64_t s = t / per_seg;
    const int64_t j = t - s * per_seg;
    const float scale = scale_p[s];
    const float x_min = x_min_p[s];
    const int64_t a = s * seg;
    const int64_t b = a + seg;
    if constexpr (kAligned) {
      const int64_t h0 = a + (G::kVec - (q_mis + a) % G::kVec) % G::kVec;
      const int64_t h = h0 < b ? h0 : b;            // the body's start
      const int64_t nv = (b - h) / G::kVec;         // its whole vectors
      const int64_t v0 = j * (kUnroll * 32);        // the tile's first
      // the tile's vectors in the body: all kUnroll * 32, or fewer
      const int live = static_cast<int>(
          nv - v0 < kUnroll * 32 ? nv - v0 : kUnroll * 32);
      const uint4* qv = reinterpret_cast<const uint4*>(q + h) + v0;
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = u * 32 + lane;
        raw[u] = v < live ? load_once(qv + v) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) stage[warp][u][lane] = raw[u];
      __syncwarp();
      float4* ov = reinterpret_cast<float4*>(out + h) + v0 * G::kGroups;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < G::kGroups; ++k) {
          const int g = u * 32 * G::kGroups + k * 32 + lane;  // tile group
          if (g / G::kGroups < live)
            ov[g] = group_values(groups[g], scale, x_min);
        }
      }
      __syncwarp();  // the stage is free for the next tile
      if (j == 0) {
        const int64_t i = lane < kEdge ? a + lane
                                       : h + nv * G::kVec + (lane - kEdge);
        if (i < (lane < kEdge ? h : b))
          out[i] = eq2(static_cast<float>(q[i]), scale, x_min);
      }
    } else {
      const int64_t lo = a + j * G::kTile;
      const int64_t hi = lo + G::kTile < b ? lo + G::kTile : b;
      for (int64_t i = lo + lane; i < hi; i += 32)
        out[i] = eq2(static_cast<float>(q[i]), scale, x_min);
    }
  }
}

template <typename T, bool kAligned>
int launch_as(const T* q, float* out, int64_t seg, int64_t per_seg,
              int64_t tiles, int q_mis, const float* scale,
              const float* x_min, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dequant_kernel<T, kAligned>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(needed < wave ? needed : wave);
  dequant_kernel<T, kAligned><<<grid > 0 ? grid : 1, kThreads, 0, stream>>>(
      q, out, seg, per_seg, tiles, q_mis, scale, x_min);
  return static_cast<int>(cudaGetLastError());
}

// n elements in segments of seg (n % seg == 0, seg > 0), segment s through
// (scale[s], x_min[s]).
template <typename T>
int launch(const T* q, float* out, int64_t n, int64_t seg,
           const float* scale, const float* x_min, void* stream) {
  using G = Geo<T>;
  const auto qa = reinterpret_cast<uintptr_t>(q);
  const auto oa = reinterpret_cast<uintptr_t>(out);
  const int q_mis = static_cast<int>((qa / sizeof(T)) % G::kVec);
  const int o_mis = static_cast<int>((oa / sizeof(float)) % 4);
  // an element where q sits on its 16-byte grid puts out on its own
  const bool aligned = qa % sizeof(T) == 0 && oa % sizeof(float) == 0 &&
                       (q_mis - o_mis) % 4 == 0;
  const int64_t per_seg = seg > G::kTile ? (seg + G::kTile - 1) / G::kTile
                                         : 1;
  const int64_t tiles = n / seg * per_seg;
  const auto s = static_cast<cudaStream_t>(stream);
  return aligned ? launch_as<T, true>(q, out, seg, per_seg, tiles, q_mis,
                                      scale, x_min, s)
                 : launch_as<T, false>(q, out, seg, per_seg, tiles, q_mis,
                                       scale, x_min, s);
}

}  // namespace

extern "C" int dequant_u8(const uint8_t* q, float* out, int64_t n,
                          int64_t seg, const float* scale,
                          const float* x_min, void* stream) {
  return launch(q, out, n, seg, scale, x_min, stream);
}

extern "C" int dequant_u16(const uint16_t* q, float* out, int64_t n,
                           int64_t seg, const float* scale,
                           const float* x_min, void* stream) {
  return launch(q, out, n, seg, scale, x_min, stream);
}
