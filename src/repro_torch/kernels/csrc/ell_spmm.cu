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
// - Rows run in row order over all of F where B fits the L2 budget or F
//   fits one pass of a warp (F <= 128), else panel by panel: the launch's
//   blocks gather features [p * P, (p + 1) * P) of every row before any
//   of panel p + 1 (the panel index in the grid, panel-major), so that
//   the panel's column of B, rows_B * P * sizeof(T) bytes under the
//   budget, comes from HBM about once and its reuse (a B row named about
//   121 times on the benchmark's Reddit) hits L2.  The wrapper's rule
//   (ell_spmm.py:_panel_features) sets P from B's shape and the card's
//   L2.  The gather is then bytes-bound or chain-bound by the graph: on
//   make_dataset's Reddit (7.1 live slots a row, F = 128) each panel
//   walks every row's chain of loads again, and panels lost (P = 32 / 64
//   0.409 / 0.301 ms against 0.189 ms; feature slices before them: 0.2772
//   against 0.1854 ms);
//   on the benchmark's Reddit (121 live slots a row, F = 602, 561 MB of
//   B, 11x the L2) row order fetched every sampled row from HBM again and
//   ran at the HBM wall (22.4-23.6 ms), and P = 32 ran in 13.2-14.3 ms
//   (PERF.md).
//   Panels take the widest load their alignment allows: 8 bytes (K = 2)
//   on the 2,408-byte rows of F = 602, each lane kPanelUnroll slots' B
//   loads in flight, since with 8 bytes a load 4 in flight left the L2
//   idle (17.6 ms); (val, col) and live_w load, and C stores, evict-first
//   (__ldcs, __stcs), so that streams read once a panel keep out of the
//   L2 that holds the panel (without the hints: 20.9 against 18.7 ms at 8
//   in flight).  The ragged last panel (602 = 18 x 32 + 26) masks its
//   lanes.  uint8 B (140 MB at F = 602) takes panels too: P = 128 in 11.9
//   against 13.6 ms in row order, though its 2-byte aligned rows take
//   the masked scalar loads (10.3 without the register cap below); so
//   does uint16 B (280 MB, 4-byte aligned rows, the same scalar loads):
//   P = 64 in 14.9 against 16.3 ms.
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
// The panel-major walk's settings, measured at F = 602 (P = 32) on the
// benchmark's Reddit (PERF.md): the B loads a lane issues before their
// FMAs (4 and 8 were slower), and the blocks an SM must hold, which caps
// the registers at 64 a thread (6 blocks, at 84, were slower).
constexpr int kPanelUnroll = 16;
constexpr int kPanelBlocksPerSm = 8;

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
      in ? min(live_w[r], width) : 0, b, feat, feat, eq2c.x, eq2c.y,
      in ? out + r * feat : nullptr, lane);
}

// The panel-major walk: block i gathers features [p * panel, p * panel +
// panel) of the rows of tile t, with p = i / row_tiles and t = i %
// row_tiles, so every row of panel p is issued before any row of panel p
// + 1 and the panel's column of B stays in L2 while its rows name it.
// The last panel takes the F % panel features left (masked lanes).
template <typename T, bool kVec, int G, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kPanelBlocksPerSm)
ell_spmm_panel_kernel(const float* __restrict__ val,
                      const int* __restrict__ col,
                      const int* __restrict__ live_w,
                      const T* __restrict__ b, float* __restrict__ out,
                      int rows, int width, int feat, int panel,
                      int row_tiles, const float* __restrict__ scale_p,
                      const float* __restrict__ x_min_p) {
  constexpr int kRowsPerWarp = 32 / G;
  const int p = static_cast<int>(blockIdx.x) / row_tiles;
  const int tile = static_cast<int>(blockIdx.x) - p * row_tiles;
  const int f0 = p * panel;
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t first =
      (static_cast<int64_t>(tile) * kWarpsPerBlock + threadIdx.y) *
      kRowsPerWarp;
  if (first >= rows) return;  // uniform across the warp
  const int64_t row = first + lane / G;
  const bool in = row < rows;
  const int64_t r = in ? row : first;
  const float2 eq2c = eq2_constants(scale_p, x_min_p);
  group_gather_row<G, K, kVec, true, kPanelUnroll>(
      val + r * width, col + r * width, in ? width : 0,
      in ? min(__ldcs(live_w + r), width) : 0, b + f0, feat,
      min(panel, feat - f0), eq2c.x, eq2c.y,
      in ? out + r * feat + f0 : nullptr, lane);
}

// Calls fn(std::bool_constant<kVec>, std::integral_constant<int, G>,
// std::integral_constant<int, K>) for a gather of panels of `panel`
// features: K the features of the widest lane load, 16 or 8 bytes, that
// F, the panel and B's base are whole multiples of (8 bytes, K = 2, at F
// = 602 in f32, whose 2,408-byte rows are 8-byte aligned), else the
// masked scalar path with K = 4; G the fewest lanes, at least
// kGatherMinGroup, whose K features cover a panel.
template <typename T, typename Fn>
int dispatch_panel_gather(const T* b, int feat, int panel, Fn&& fn) {
  constexpr int kSize = static_cast<int>(sizeof(T));
  auto fits = [&](int bytes) {
    return (feat * kSize) % bytes == 0 && (panel * kSize) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(b) % bytes == 0;
  };
  auto by_group = [&](auto kvec, auto kc) {
    constexpr int K = decltype(kc)::value;
    const int lanes = max((panel + K - 1) / K, kGatherMinGroup);
    if (lanes <= 4) return fn(kvec, std::integral_constant<int, 4>{}, kc);
    if (lanes <= 8) return fn(kvec, std::integral_constant<int, 8>{}, kc);
    if (lanes <= 16) return fn(kvec, std::integral_constant<int, 16>{}, kc);
    return fn(kvec, std::integral_constant<int, 32>{}, kc);
  };
  if (fits(16))
    return by_group(std::true_type{},
                    std::integral_constant<int, 16 / kSize>{});
  if (fits(8))
    return by_group(std::true_type{}, std::integral_constant<int, 8 / kSize>{});
  return by_group(std::false_type{}, std::integral_constant<int, 4>{});
}

// One launch a call: rows in row order over all of F where panel >= F,
// else the panel-major walk.
template <typename T>
int launch(const float* val, const int* col, const int* live_w, const T* b,
           float* out, int rows, int width, int feat, int panel,
           const float* scale, const float* x_min, void* stream) {
  const dim3 block(32, kWarpsPerBlock);
  const auto s = static_cast<cudaStream_t>(stream);
  if (panel <= 0 || panel >= feat) {
    return dispatch_gather(
        b, feat, width, [&](auto kvec, auto group, auto lanef) {
          constexpr int G = decltype(group)::value;
          constexpr int rows_per_block = kWarpsPerBlock * 32 / G;
          const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
          ell_spmm_kernel<T, decltype(kvec)::value, G,
                          decltype(lanef)::value><<<grid, block, 0, s>>>(
              val, col, live_w, b, out, rows, width, feat, scale, x_min);
          return static_cast<int>(cudaGetLastError());
        });
  }
  return dispatch_panel_gather(
      b, feat, panel, [&](auto kvec, auto group, auto lanef) {
        constexpr int G = decltype(group)::value;
        constexpr int rows_per_block = kWarpsPerBlock * 32 / G;
        const int64_t row_tiles = (rows + rows_per_block - 1) / rows_per_block;
        const int64_t blocks = row_tiles * ((feat + panel - 1) / panel);
        if (blocks > 0x7fffffff)
          return static_cast<int>(cudaErrorInvalidConfiguration);
        ell_spmm_panel_kernel<T, decltype(kvec)::value, G,
                              decltype(lanef)::value>
            <<<dim3(static_cast<unsigned>(blocks)), block, 0, s>>>(
                val, col, live_w, b, out, rows, width, feat, panel,
                static_cast<int>(row_tiles), scale, x_min);
        return static_cast<int>(cudaGetLastError());
      });
}

}  // namespace

extern "C" int ell_spmm_f32(const float* val, const int* col,
                            const int* live_w, const float* b, float* out,
                            int rows, int width, int feat, int panel,
                            void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat, panel,
                static_cast<const float*>(nullptr),
                static_cast<const float*>(nullptr), stream);
}

extern "C" int ell_spmm_u8(const float* val, const int* col,
                           const int* live_w, const uint8_t* b, float* out,
                           int rows, int width, int feat, int panel,
                           const float* scale, const float* x_min,
                           void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat, panel, scale,
                x_min, stream);
}

extern "C" int ell_spmm_u16(const float* val, const int* col,
                            const int* live_w, const uint16_t* b, float* out,
                            int rows, int width, int feat, int panel,
                            const float* scale, const float* x_min,
                            void* stream) {
  return launch(val, col, live_w, b, out, rows, width, feat, panel, scale,
                x_min, stream);
}
