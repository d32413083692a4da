// Shared device code for the kernels: the Table 1 strategy of one row
// and the inverse slot map of Algorithm 1; Eq. 2; the vector loads of B
// that every gather takes (a lane's K features of a B row in one 4- to
// 16-byte load, turned into f32 at its FMA); the group gather of the ELL
// SpMM and the blocked SpMM (4-32 lanes a row, several B rows in flight a
// lane); plus the C entry point that turns a CUDA error code into text for the
// Python wrappers.
//
// The sampler arithmetic is int32, as in the reference sampler
// (repro_torch/core/sampling.py), so the kernels reproduce it bit for bit.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#define AES_PRIME_NUM 1429  // paper §3.3

struct AesRow {
  int nnz;  // row non-zeros
  int n;    // consecutive elements per sample (N >= 1)
  int cnt;  // number of samples (1 <= cnt <= max(W, 1))
  int w;    // effective width min(nnz, sh_width)
};

// Alg. 1 line 6 + Table 1, as integer tests nnz <= t * W (no float R).
__device__ __forceinline__ AesRow aes_row_strategy(int nnz, int sh_width) {
  AesRow s;
  s.nnz = nnz;
  s.w = min(nnz, sh_width);
  const int w = s.w;
  if (nnz <= w) {
    s.n = nnz; s.cnt = 1;
  } else if (nnz <= 2 * w) {
    s.n = w / 4; s.cnt = 4;
  } else if (nnz <= 36 * w) {
    s.n = w / 8; s.cnt = 8;
  } else if (nnz <= 54 * w) {
    s.n = w / 16; s.cnt = 16;
  } else {
    s.n = w / 32; s.cnt = 32;
  }
  s.n = max(s.n, 1);
  s.cnt = min(s.cnt, max(w, 1));
  return s;
}

// Slot s of the row holds element j = s / cnt of sample i = s % cnt, taken
// from row offset (i * 1429) % max(nnz - N + 1, 1) + j (Eq. 3).  Returns
// that offset, or -1 for a dead slot.
__device__ __forceinline__ int aes_slot_offset(const AesRow& r, int s) {
  const int i = s % r.cnt;
  const int j = s / r.cnt;
  const int span = max(r.nnz - r.n + 1, 1);
  const int off = (i * AES_PRIME_NUM) % span + j;
  const bool live = s < r.n * r.cnt && off < r.nnz && r.nnz > 0;
  return live ? off : -1;
}

// Slots a row keeps live (the fused kernel's accumulation bound).
__device__ __forceinline__ int aes_live_width(const AesRow& r) {
  return r.nnz > 0 ? min(r.n * r.cnt, r.w) : 0;
}

// Eq. 2, q * scale + x_min, rounded after the product and after the sum as
// the plain PyTorch version rounds (no FMA contraction): a dequantized value
// is bit-identical to it.
__device__ __forceinline__ float eq2(float q, float scale, float x_min) {
  return __fadd_rn(__fmul_rn(q, scale), x_min);
}

// One element of B as f32: float B as it is, uint8/uint16 B through Eq. 2.
__device__ __forceinline__ float load_feature(const float* b, int64_t i,
                                              float, float) {
  return b[i];
}
__device__ __forceinline__ float load_feature(const uint8_t* b, int64_t i,
                                              float scale, float x_min) {
  return eq2(static_cast<float>(b[i]), scale, x_min);
}
__device__ __forceinline__ float load_feature(const uint16_t* b, int64_t i,
                                              float scale, float x_min) {
  return eq2(static_cast<float>(b[i]), scale, x_min);
}

// Eq. 2's constants from device memory (a launch never waits for the host);
// float B passes null pointers and gets the identity.
__device__ __forceinline__ float2 eq2_constants(const float* scale_p,
                                                const float* x_min_p) {
  return make_float2(scale_p != nullptr ? *scale_p : 1.f,
                     x_min_p != nullptr ? *x_min_p : 0.f);
}

// The f32 value of the integer in bytes [lo, hi] of w (selector picks
// them into the mantissa of 2^23, exact below 2^23): one byte permute and
// one add, where a conversion instruction runs at a quarter rate.
__device__ __forceinline__ float int_field(uint32_t w, uint32_t selector) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, selector)) - 8388608.f;
}

// A lane's share of a B row in every gather: K consecutive features of T
// from feature f.  kVec: K * sizeof(T) bytes in one 4-, 8- or 16-byte load
// (a float4, or a uint2 of uint16, or a uint32_t of uint8 at K = 4), kept
// as loaded so that a lane holds several slots' loads in few registers,
// and turned into f32 at its FMA (lane_fma); the caller guarantees F a
// multiple of K, a base aligned to the load, and f < F.  Otherwise the
// masked scalar path, converted at load: features at or past F read as 0.
// uint8/uint16 go through Eq. 2 (eq2, rounded twice) either way, on the
// integer's exact f32 value.
template <int kWords> struct RawWords;
template <> struct RawWords<1> { using type = uint32_t; };
template <> struct RawWords<2> { using type = uint2; };
template <> struct RawWords<4> { using type = uint4; };

template <bool kVec, typename T, int K> struct LaneLoad {
  static constexpr int kWords = K * static_cast<int>(sizeof(T)) / 4;
  typename RawWords<kWords>::type raw;
};
template <typename T, int K> struct LaneLoad<false, T, K> { float x[K]; };

__device__ __forceinline__ uint32_t raw_word(uint32_t r, int) { return r; }
__device__ __forceinline__ uint32_t raw_word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ uint32_t raw_word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

template <bool kVec, int K, typename T>
__device__ __forceinline__ LaneLoad<kVec, T, K> lane_load(
    const T* __restrict__ b, int64_t row_base, int f, int feat, float scale,
    float x_min) {
  LaneLoad<kVec, T, K> l;
  if constexpr (kVec) {
    using R = decltype(l.raw);
    l.raw = __ldg(reinterpret_cast<const R*>(b + row_base + f));
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      l.x[j] = f + j < feat ? load_feature(b, row_base + f + j, scale, x_min)
                            : 0.f;
  }
  return l;
}

// The f32 values of one 32-bit word of B: one float, or two uint16 or four
// uint8 through Eq. 2 (int_field: the integer's exact f32 value).
__device__ __forceinline__ void word_values(uint32_t w, float, float,
                                            float (&v)[1]) {
  v[0] = __uint_as_float(w);
}
__device__ __forceinline__ void word_values(uint32_t w, float scale,
                                            float x_min, float (&v)[2]) {
  v[0] = eq2(int_field(w, 0x7410u), scale, x_min);
  v[1] = eq2(int_field(w, 0x7432u), scale, x_min);
}
__device__ __forceinline__ void word_values(uint32_t w, float scale,
                                            float x_min, float (&v)[4]) {
  v[0] = eq2(int_field(w, 0x7540u), scale, x_min);
  v[1] = eq2(int_field(w, 0x7541u), scale, x_min);
  v[2] = eq2(int_field(w, 0x7542u), scale, x_min);
  v[3] = eq2(int_field(w, 0x7543u), scale, x_min);
}

// acc + v * x: one FMA, or, with kRoundTwice, rounded after the product
// and after the sum as the plain PyTorch version rounds.
template <bool kRoundTwice>
__device__ __forceinline__ float fma1(float v, float x, float acc) {
  if constexpr (kRoundTwice) return __fadd_rn(acc, __fmul_rn(v, x));
  return fmaf(v, x, acc);
}

// acc[j] += v * (feature j of the lane's load).
template <bool kRoundTwice, bool kVec, typename T, int K>
__device__ __forceinline__ void lane_fma(float v,
                                         const LaneLoad<kVec, T, K>& l,
                                         float scale, float x_min,
                                         float (&acc)[K]) {
  if constexpr (kVec) {
    constexpr int kWords = LaneLoad<kVec, T, K>::kWords;
    constexpr int kPerWord = K / kWords;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float x[kPerWord];
      word_values(raw_word(l.raw, i), scale, x_min, x);
#pragma unroll
      for (int j = 0; j < kPerWord; ++j)
        acc[i * kPerWord + j] = fma1<kRoundTwice>(v, x[j],
                                                  acc[i * kPerWord + j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = fma1<kRoundTwice>(v, l.x[j], acc[j]);
  }
}

// Stores a lane's K features f.. of an output row (none at or past F).
template <bool kVec, int K>
__device__ __forceinline__ void lane_store(float* orow, int f, int feat,
                                           const float (&acc)[K]) {
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(orow + f + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    } else {
#pragma unroll
      for (int i = j; i < j + 4; ++i)
        if (f + i < feat) orow[f + i] = acc[i];
    }
  }
}

// The group gather of the ELL SpMM and the blocked SpMM; each setting was
// measured against its alternatives on the reddit main path (PERF.md):
// - B-row loads a lane issues before their FMAs (2 and 8 were slower).
constexpr int kGatherUnroll = 4;
// - The fewest lanes a row gets (32, one row a warp, was slower wherever
//   a row needs fewer lanes).
constexpr int kGatherMinGroup = 4;
// - Rows of at most this many slots get 16-byte lanes (several rows a
//   warp), longer ones 4 features a lane.
constexpr int kGatherWideLanesMax = 32;

// dst[f] = sum_{k < live} vrow[k] * B[crow[k], f] for f < F, computed by
// the group of G lanes that holds one row; the 32 / G groups
// of a warp hold 32 / G rows, and every lane of the warp calls this
// together (the loops are bounded by the warp's longest row, so the
// shuffles see the whole warp).  Each lane owns K consecutive features of
// a B row: one K * sizeof(T)-byte load a slot when kVec (F a multiple of
// K and B aligned to that size), else masked scalar loads converted at
// load.  The group loads G slots of (val, col) at once, one per lane, and
// broadcasts them with shuffles; the next G slots load while this chunk's
// B rows do.  Each lane issues the B loads of up to kGatherUnroll slots
// before their FMAs, so a row's B rows are in flight together, not one
// after the other.  Sums run in slot order per feature with f32
// accumulators, rounded after the product and after the sum as the plain
// version rounds (lane_fma<true>; with FMA a row of 2048 live slots
// drifted 2.1e-5 from it, past the 1e-5 tolerance), so issuing loads
// early changes no result.  uint8/uint16 B go through
// Eq. 2 (eq2, rounded twice) on the integer's exact f32 value.  The first
// chunk of (val, col) loads up to avail (the row's slots in memory, >=
// live) before live is needed, so it overlaps the load of live.  A group
// past the last row passes avail = live = 0 and dst = nullptr.
template <int G, int K, bool kVec, typename T>
__device__ __forceinline__ void group_gather_row(
    const float* __restrict__ vrow, const int* __restrict__ crow, int avail,
    int live, const T* __restrict__ b, int feat, float scale, float x_min,
    float* __restrict__ dst, int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  // the scalar path holds converted features: at most 4 slots in flight
  constexpr int kU = kVec || kGatherUnroll < 4 ? kGatherUnroll : 4;
  constexpr int U = kU < G ? kU : G;
  static_assert(G % U == 0, "a chunk of G slots is whole unroll steps");
  const int gl = lane % G;
  float v0 = 0.f;
  int c0 = 0;
  if (gl < avail) {
    v0 = vrow[gl];
    c0 = crow[gl];
  }
  const int warp_live = __reduce_max_sync(kAll, live);
  for (int f0 = 0; f0 < feat; f0 += K * G) {
    const int f = f0 + K * gl;
    const bool has = f < feat;
    float acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = 0.f;
    float cv = v0;
    int cc = c0;
    for (int k0 = 0; k0 < warp_live; k0 += G) {
      float nv = 0.f;
      int nc = 0;
      if (k0 + G + gl < live) {
        nv = vrow[k0 + G + gl];
        nc = crow[k0 + G + gl];
      }
      const int n = min(G, warp_live - k0);
      for (int k1 = 0; k1 < n; k1 += U) {
        LaneLoad<kVec, T, K> x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = __shfl_sync(kAll, cc, k1 + u, G);
          if (has && k0 + k1 + u < live)
            x[u] = lane_load<kVec, K>(b, static_cast<int64_t>(c) * feat, f,
                                      feat, scale, x_min);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float v = __shfl_sync(kAll, cv, k1 + u, G);
          if (has && k0 + k1 + u < live)
            lane_fma<true>(v, x[u], scale, x_min, acc);
        }
      }
      cv = nv;
      cc = nc;
    }
    if (has && dst != nullptr) lane_store<kVec>(dst, f, feat, acc);
  }
}

// Calls fn(std::bool_constant<kVec>, std::integral_constant<int, G>,
// std::integral_constant<int, K>) for the gather variant a launch takes:
// - K, the features a lane holds: 16 bytes of B (4 f32, 8 uint16 or 16
//   uint8) where a row holds at most kGatherWideLanesMax slots
//   (max_width), else 4 (4, 8 or 16 bytes).  With K = 16 uint8 features a
//   row of 128 takes 8 lanes, so 4 rows share a warp, which runs until the
//   longest of them ends: on the reddit ELL at W = 128 (rows of 1 to 128
//   live slots) that lost to 4 features a lane, and on the tuned BlockELL
//   (16-32) it won (PERF.md).
// - kVec where F is a multiple of K and B's base is aligned to K *
//   sizeof(T) bytes (16-byte lanes that F or the base do not allow fall
//   back to K = 4; else the masked scalar path, K = 4, G = 32).
// - G, the lanes a row gets: the fewest of 4, 8, 16 and 32 whose K
//   features a lane cover F (32 for a wider F, which takes several
//   passes), and at least kGatherMinGroup.
// Returns fn's result.
template <typename T, typename Fn>
int dispatch_gather(const T* b, int feat, int max_width, Fn&& fn) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  using Kc4 = std::integral_constant<int, 4>;
  using KcWide = std::integral_constant<int, kWide>;
  auto fits = [&](int k) {  // whole K-feature lanes, aligned loads
    return feat % k == 0 &&
           reinterpret_cast<uintptr_t>(b) % (k * sizeof(T)) == 0;
  };
  const bool wide = max_width <= kGatherWideLanesMax && fits(kWide);
  if (!wide && !fits(4))
    return fn(std::false_type{}, std::integral_constant<int, 32>{}, Kc4{});
  const int k = wide ? kWide : 4;
  const int lanes = max((feat + k - 1) / k, kGatherMinGroup);
  auto by_group = [&](auto kc) {
    if (lanes <= 4) return fn(std::true_type{},
                              std::integral_constant<int, 4>{}, kc);
    if (lanes <= 8) return fn(std::true_type{},
                              std::integral_constant<int, 8>{}, kc);
    if (lanes <= 16) return fn(std::true_type{},
                               std::integral_constant<int, 16>{}, kc);
    return fn(std::true_type{}, std::integral_constant<int, 32>{}, kc);
  };
  return wide ? by_group(KcWide{}) : by_group(Kc4{});
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
