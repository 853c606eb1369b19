// The bins of the d = 3 binned-tile kernels (spread.cu spread_sm_3d,
// interp.cu interp_sm_3d).
//
// A bin is B x B x B grid cells; its padded tile, (B + w - 1)^3 cells,
// holds every tap of the sources (targets) whose first tap cell lies in the
// bin. The tile lives in registers, one (axis-1, axis-2) column a thread,
// so its bytes are the block's accumulator registers. kBinEdge (dtype, w)
// is the largest edge up to 8 whose tile of complex cells fits kTileBytes:
// two blocks an SM then hold their tiles in its 256 KB of registers. The
// host planner of the interpolation order (nufft/interp.py bin_edge_3d)
// reads kTileBytes, kMaxEdge and kBinEdge from this file, so keep their
// one-line forms; interp_sm_3d refuses another edge.

#pragma once

namespace fftvis_bins {

constexpr int kTileBytes = 112 * 1024;
constexpr int kMaxEdge = 8;
constexpr int kBinEdge[2][17] = {
    // complex64, w = 0..16
    {0, 0, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8},
    // complex128, w = 0..16
    {0, 0, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 7, 6, 5, 4},
};

template <typename T>
constexpr int bin_edge(int w) { return kBinEdge[sizeof(T) == 8][w]; }

constexpr int tile_bytes(int edge, int w, int real_bytes) {
  return (edge + w - 1) * (edge + w - 1) * (edge + w - 1) * 2 * real_bytes;
}

// Every entry's tile fits, and one more cell a side would not (or the
// edge is kMaxEdge).
template <typename T, int W = 2>
constexpr bool table_holds() {
  if constexpr (W > 16) {
    return true;
  } else {
    constexpr int B = bin_edge<T>(W);
    constexpr int rb = static_cast<int>(sizeof(T));
    return tile_bytes(B, W, rb) <= kTileBytes &&
           (B == kMaxEdge || tile_bytes(B + 1, W, rb) > kTileBytes) && table_holds<T, W + 1>();
  }
}
static_assert(table_holds<float>() && table_holds<double>(),
              "kBinEdge: an entry is not the largest edge whose tile fits kTileBytes");

}  // namespace fftvis_bins
