// 2D exponential-of-semicircle (ES) spreading onto a periodic fine grid.
//
// Replaces the Pallas band-accumulator spreader of the JAX package
// (fftvis_tpu/nufft/pallas_spread.py, _build_pallas_call): it computes
//
//     g[c, y, x] += sum_j psi(y - uy_j) psi(x - ux_j) w[c, j]
//
// with psi(t) = exp(beta (sqrt(1 - (2t/w)^2) - 1)) on |2t/w| < 1.
//
// Bound on the card, in bytes: every touched grid cell read and written
// once, plus the coordinates and weights. At the slice's 4096-source
// blocks on a (4320, 3072) grid, w = 14, C = 4, complex128, the sources'
// footprints barely overlap: 4096 x 196 cells x 4 channels x 16 B x 2 =
// 103 MB, 31 us at 3.35 TB/s; on the (4320, 3000) grid, w = 8, complex64,
// 16.8 MB, 5.0 us. Sources whose weights are all zero touch nothing.
//
// Design (cuFINUFFT's GM method for low density, arXiv 2102.08463): at the
// slice's 3e-4 sources per cell a shared-memory window costs more to zero,
// scan and flush than the taps it gathers, so there is none.
// - One warp per source. Lanes 0..w-1 evaluate the w y-values of the ES
//   kernel and lanes 16..16+w-1 the w x-values: 2w evaluations a source,
//   passed to the tap lanes by __shfl_sync.
// - The lanes then walk the w x w taps, for each of the C channels, and
//   add straight into the global grid at (y mod nfy, x mod nfx). A group
//   of lanes covers one tap row: for complex64 one lane a tap, with the
//   sm_90 float2 global atomic (one atomic per tap and channel); for
//   complex128 one lane a real (native fp64 atomics), so a row of w taps
//   is 2w neighbouring doubles. Each warp-wide atomic instruction thus
//   covers whole contiguous rows.
// - A source whose C weights are all exactly zero (the horizon mask
//   zeroes them) adds nothing, and its warp returns at once.
// - w is a template parameter (2..16), so the tap loops unroll.
//
// Tap math, as in the JAX scatter spreader (_spread_scatter):
//   cell = floor(u), frac = u - cell        (exact)
//   i0 = ceil(u - w/2)
//   t_k = (cell - (i0 + k)) + frac          (never u - idx at 10^3 cells)
//   tap index (i0 + k) mod nf
//
// Built without --use_fast_math: the ES exp and sqrt need full precision.
// The summation order of the atomics varies from run to run.
//
// spread_adjoint_gm is the adjoint of the spread with respect to the
// weights, what a gradient through the spread needs (the JAX package lets
// XLA differentiate its spreaders; no Pallas kernel has a backward):
//
//     out[c, j] = sum_a sum_b psi(y_a - uy_j) psi(x_b - ux_j) g[c, y_a, x_b]
//
// a gather of each source's w x w taps of the grid gradient g. One warp a
// source evaluates its 2w ES values once, as spread_gm does; the lanes then
// take the w^2 taps (lane t, t + 32, ...), read each tap's cell of every
// channel, and a __shfl_xor_sync reduction sums a channel. Outputs are
// disjoint: no atomics, every output written once, a fixed order of
// summation, so two runs agree bit for bit. Bound: the touched cells of the
// C planes read once, the coordinates, and the (C, n) output written once.
// What holds it to 39% of that at C = 40 in float32: on a 4.25 GB gradient
// every (channel, tap row) of a source is its own scattered device-memory
// segment of w cells, 7 in 8 of them across a 64-byte boundary at w = 8,
// and the time follows the count of those segments whatever the lanes do:
// rows aligned to 64 bytes take 28% less (tools/kernel_ab.py --spread).
// Other shapes of the lanes (a lane group over a tap row's columns, or a
// lane group a channel) were no faster at C = 40 and are not kept (PERF.md
// row 5). A layout with the channels last would make a source's channels
// of a row one segment.
//
// spread_gm_1d and spread_gm_3d are the GM method on a 1D (C, n0) and a 3D
// (C, n0, n1, n2) periodic grid, for the public type-1 and type-3
// transforms at d = 1 and d = 3 (the JAX package spreads those with XLA:
// _spread_scatter, and on the TPU _spread_3d_ztaps, a scan of 2D spreads
// over the planes of the last axis). Their ES values are evaluated once a
// source, every tap is added with an atomic, zero-weight sources are
// skipped, w is a template parameter (2..16):
// - D = 1: a block takes 128 sources. A thread a source evaluates its w ES
//   values into shared memory (unless its C weights are all zero), the
//   weights of 8 channels at a time follow, and the block's 256 threads
//   then take (source, tap[, re/im]) items in order: consecutive lanes add
//   a source's consecutive cells, so every lane carries work and a warp's
//   atomics cover whole tap rows (the first form, a warp a source, left 24
//   of 32 lanes idle at w = 8). What bounds it is the atomics' rate in L2
//   (PERF.md row 1b);
// - D = 3: the lanes cover the (axis-1, axis-2) taps exactly as spread_gm
//   covers (y, x) -- a group of lanes a contiguous tap row of the last
//   axis, so a warp's atomics hit whole rows -- and a loop over the w
//   axis-0 taps moves from one (n1, n2) slab to the next. The loop runs over
//   the first axis, not the last, so that the lanes stay on contiguous
//   cells.
// Bound, in bytes: as spread_gm, the touched cells read and written once,
// plus coordinates and weights.
//
// spread_sm_3d is the D = 3 spread redesigned for a dense grid, after
// cuFINUFFT's SM method (arXiv 2102.08463). What holds spread_gm_3d back
// there: at 10^5 sources on a (64, 64, 32) grid and w = 14 every cell takes
// ~2,000 taps, and each is a global atomic (two fp64 atomics at complex128)
// on a 2 MB grid that lives in L2, so they serialise on the same lines.
// Here:
// - the sources are sorted on the device by the 3D bin of their first tap
//   cell: bin_count, bin_scan and bin_scatter below, a counting sort giving
//   a permutation, CSR bin offsets and each bin's first subproblem, launched
//   by the same wrapper call (nufft/spread.py bin_sort_3d is its plain
//   version);
// - one block takes one subproblem -- up to K = 256 sources of one bin, so
//   that a crowded bin spreads over many blocks -- of one channel
//   (blockIdx.y) and owns the bin's padded tile, (B + w - 1)^3 cells, in registers: a thread a (axis-1,
//   axis-2) column, its B + w - 1 axis-0 cells unrolled. The block stages
//   a third as many sources as it has threads in shared memory at a time
//   (their 3w ES values, evaluated once, a thread a source's axis, local
//   first cells and weights); then every
//   thread whose column a staged source's footprint covers adds psi_1
//   psi_2 w times the source's axis-0 values into its cells. No two threads share a cell, so there
//   are no atomics until the flush (a first form that kept the tile in
//   shared memory and spread with shared-memory atomics ran only 1.4x
//   faster than spread_gm_3d at complex128 and 1.6x slower at complex64:
//   PERF.md row 1b);
// - the tile is then added to the global grid once, with global atomics
//   (neighbouring bins' halos overlap).
// B comes from the constexpr table fftvis_bins::kBinEdge (bins.cuh). Where
// a grid axis is shorter than the padded tile, or the sources are too few
// in all or a bin (kSmMinSources, kSmMinSourcesPerBin),
// fftvis_spread_nd_bin_edge picks spread_gm_3d. A source whose first tap cell lies outside its block's bin
// (a malformed permutation or offsets) adds nothing: a wrong sum, never an
// access out of bounds. Each thread adds a staged source to its column at
// the source's axis-0 offset through a switch over the B offsets, so the
// column's cells keep compile-time register indices. Bound: as
// spread_gm_3d's.

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
__device__ __forceinline__ T es_kernel(T t, int w, T beta) {
  T z = (T(2) * t) / T(w);
  if (fabs(z) < T(1)) {
    return exp(beta * (sqrt(T(1) - z * z) - T(1)));
  }
  return T(0);
}

__device__ __forceinline__ int wrap(long long i, int n) {
  long long r = i % n;
  return static_cast<int>(r < 0 ? r + n : r);
}

__device__ __forceinline__ void add_tap(float* cell, int /*part*/, float v,
                                        float wre, float wim) {
  atomicAdd(reinterpret_cast<float2*>(cell), make_float2(v * wre, v * wim));
}

__device__ __forceinline__ void add_tap(double* cell, int part, double v,
                                        double wre, double wim) {
  atomicAdd(cell + part, v * (part ? wim : wre));
}

template <typename T, int W>
__global__ void spread_gm(
    const T* __restrict__ uy, const T* __restrict__ ux,
    const T* __restrict__ wts,      // (C, n, 2) interleaved re/im
    T* __restrict__ grid,           // (C, nfy, nfx, 2) interleaved re/im
    int n, int C, int nfy, int nfx, T beta) {
  // Atomics a tap row takes: one a tap (float2) or one a real (double).
  constexpr int PER_TAP = sizeof(T) == 4 ? 1 : 2;
  constexpr int Q = pow2ceil(PER_TAP * W);  // lanes a tap row
  constexpr int R = 32 / Q;                 // tap rows a step
  constexpr int STEPS = (W + R - 1) / R;

  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n) return;  // whole warps only: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;

  bool nonzero = false;
  for (int c = lane; c < C; c += 32) {
    const T* wc = wts + (static_cast<long long>(c) * n + j) * 2;
    nonzero |= wc[0] != T(0) || wc[1] != T(0);
  }
  if (!__any_sync(kFull, nonzero)) return;

  // Kernel values: lane k < W holds psi_y(k), lane 16 + k psi_x(k).
  const bool xhalf = lane >= 16;
  const int kk = lane & 15;
  const T u = xhalf ? ux[j] : uy[j];
  const T cell = floor(u);
  const T frac = u - cell;
  const long long i0 = static_cast<long long>(ceil(u - T(W) / T(2)));
  const T psi = kk < W ? es_kernel((cell - T(i0 + kk)) + frac, W, beta) : T(0);
  const long long iy0 = __shfl_sync(kFull, i0, 0);
  const long long ix0 = __shfl_sync(kFull, i0, 16);

  const int s = lane % Q;
  const int b = s / PER_TAP;           // tap column
  const int part = s % PER_TAP;        // re (0) or im (1) for double
  const bool col_ok = s < PER_TAP * W;
  const T psix = __shfl_sync(kFull, psi, 16 + (b & 15));
  const int gx = wrap(ix0 + b, nfx);

  long long off[STEPS];
  T val[STEPS];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int a = st * R + lane / Q;
    const T psiy = __shfl_sync(kFull, psi, a & 15);
    const bool ok = col_ok && a < W;
    val[st] = ok ? psiy * psix : T(0);
    off[st] = (static_cast<long long>(wrap(iy0 + a, nfy)) * nfx + gx) * 2;
  }

  const long long plane = static_cast<long long>(nfy) * nfx * 2;
  for (int c = 0; c < C; ++c) {
    const T* wc = wts + (static_cast<long long>(c) * n + j) * 2;
    const T wre = wc[0];
    const T wim = wc[1];
    if (wre == T(0) && wim == T(0)) continue;
    T* gc = grid + c * plane;
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      if (val[st] != T(0)) add_tap(gc + off[st], part, val[st], wre, wim);
    }
  }
}

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T, int W>
__global__ void spread_adjoint_gm(
    const T* __restrict__ uy, const T* __restrict__ ux,
    const T* __restrict__ grid,     // (C, nfy, nfx, 2) gradient, re/im
    T* __restrict__ out,            // (C, n, 2) interleaved re/im
    int n, int C, int nfy, int nfx, T beta) {
  using V = typename Vec2<T>::type;
  constexpr int STEPS = (W * W + 31) / 32;  // taps a lane
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n) return;  // whole warps only: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;

  // Kernel values as in spread_gm: lane k < W holds psi_y(k), lane 16 + k
  // psi_x(k).
  const bool xhalf = lane >= 16;
  const int kk = lane & 15;
  const T u = xhalf ? ux[j] : uy[j];
  const T cell = floor(u);
  const T frac = u - cell;
  const long long i0 = static_cast<long long>(ceil(u - T(W) / T(2)));
  const T psi = kk < W ? es_kernel((cell - T(i0 + kk)) + frac, W, beta) : T(0);
  const long long iy0 = __shfl_sync(kFull, i0, 0);
  const long long ix0 = __shfl_sync(kFull, i0, 16);

  long long off[STEPS];
  T val[STEPS];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int t = st * 32 + lane;
    const int a = t / W;
    const int b = t % W;
    const T psiy = __shfl_sync(kFull, psi, a & 15);
    const T psix = __shfl_sync(kFull, psi, 16 + (b & 15));
    const bool ok = t < W * W;
    val[st] = ok ? psiy * psix : T(0);
    off[st] = ok ? static_cast<long long>(wrap(iy0 + a, nfy)) * nfx + wrap(ix0 + b, nfx) : 0;
  }

  const long long plane = static_cast<long long>(nfy) * nfx;
  const V* gv = reinterpret_cast<const V*>(grid);
  V* ov = reinterpret_cast<V*>(out);
  for (int c = 0; c < C; ++c) {
    const V* gc = gv + c * plane;
    T re = T(0);
    T im = T(0);
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      if (val[st] != T(0)) {
        const V g = gc[off[st]];
        re += val[st] * g.x;
        im += val[st] * g.y;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      re += __shfl_xor_sync(kFull, re, d);
      im += __shfl_xor_sync(kFull, im, d);
    }
    if (lane == 0) {
      V o;
      o.x = re;
      o.y = im;
      ov[static_cast<long long>(c) * n + j] = o;
    }
  }
}

__device__ __forceinline__ void add_complex(float* cell, float re, float im) {
  atomicAdd(reinterpret_cast<float2*>(cell), make_float2(re, im));
}

__device__ __forceinline__ void add_complex(double* cell, double re, double im) {
  atomicAdd(cell, re);
  atomicAdd(cell + 1, im);
}

// Whether any of source j's C weights is nonzero (every lane gets the
// answer).
template <typename T>
__device__ __forceinline__ bool any_weight(const T* __restrict__ wts, long long j,
                                           int n, int C, int lane) {
  bool nonzero = false;
  for (int c = lane; c < C; c += 32) {
    const T* wc = wts + (static_cast<long long>(c) * n + j) * 2;
    nonzero |= wc[0] != T(0) || wc[1] != T(0);
  }
  return __any_sync(kFull, nonzero);
}

// spread_gm_1d: a block of kD1Sources sources and kD1Threads threads.
constexpr int kD1Sources = 128;
constexpr int kD1Threads = 256;
constexpr int kD1Chunk = 8;  // channels' weights in shared memory at a time

template <typename T, int W>
__global__ void __launch_bounds__(kD1Threads) spread_gm_1d(
    const T* __restrict__ u0,
    const T* __restrict__ wts,      // (C, n, 2) interleaved re/im
    T* __restrict__ grid,           // (C, n0, 2) interleaved re/im
    int n, int C, int n0, T beta) {
  constexpr int PER_TAP = sizeof(T) == 4 ? 1 : 2;
  constexpr int L = W * PER_TAP;  // items a source: (tap[, re/im])
  using V = typename Vec2<T>::type;
  __shared__ T psi_s[kD1Sources][W];
  __shared__ int first_s[kD1Sources];  // first tap cell mod n0, or -1: skip
  __shared__ V w_s[kD1Chunk][kD1Sources];
  const long long j0 = static_cast<long long>(blockIdx.x) * kD1Sources;
  const int ns = static_cast<int>(min(static_cast<long long>(kD1Sources), n - j0));
  const V* wv = reinterpret_cast<const V*>(wts);
  // A thread a source: its W ES values, unless its C weights are all zero.
  if (threadIdx.x < kD1Sources) {
    const int s = threadIdx.x;
    bool nonzero = false;
    for (int c = 0; c < C && s < ns && !nonzero; ++c) {
      const V wc = wv[static_cast<long long>(c) * n + j0 + s];
      nonzero = wc.x != T(0) || wc.y != T(0);
    }
    first_s[s] = -1;
    if (nonzero) {
      const T u = u0[j0 + s];
      const T cell = floor(u);
      const T frac = u - cell;
      const long long i0 = static_cast<long long>(ceil(u - T(W) / T(2)));
#pragma unroll
      for (int k = 0; k < W; ++k) psi_s[s][k] = es_kernel((cell - T(i0 + k)) + frac, W, beta);
      first_s[s] = wrap(i0, n0);
    }
  }
  for (int c0 = 0; c0 < C; c0 += kD1Chunk) {
    const int cn = min(kD1Chunk, C - c0);
    __syncthreads();  // the ES values are in; the last chunk's weights read
    for (int t = threadIdx.x; t < cn * kD1Sources; t += kD1Threads) {
      const int s = t % kD1Sources;
      const int c = t / kD1Sources;
      if (s < ns) w_s[c][s] = wv[static_cast<long long>(c0 + c) * n + j0 + s];
    }
    __syncthreads();
    // Item t: source t / L, tap (t % L) / PER_TAP; consecutive lanes take a
    // source's consecutive cells, so a warp's atomics cover whole tap rows.
    for (int t = threadIdx.x; t < ns * L; t += kD1Threads) {
      const int s = t / L;
      const int g0 = first_s[s];
      if (g0 < 0) continue;
      const int r = t % L;
      const int k = r / PER_TAP;
      const T psi = psi_s[s][k];
      if (psi == T(0)) continue;
      int g = g0 + k;
      while (g >= n0) g -= n0;
      T* cell = grid + (static_cast<long long>(c0) * n0 + g) * 2 + r % PER_TAP;
      for (int c = 0; c < cn; ++c) {
        const V wc = w_s[c][s];
        if (wc.x == T(0) && wc.y == T(0)) continue;
        T* cc = cell + static_cast<long long>(c) * n0 * 2;
        if constexpr (PER_TAP == 1) {
          add_complex(cc, psi * wc.x, psi * wc.y);
        } else {
          atomicAdd(cc, psi * (r % PER_TAP ? wc.y : wc.x));
        }
      }
    }
  }
}

template <typename T, int W>
__global__ void spread_gm_3d(
    const T* __restrict__ u0, const T* __restrict__ u1, const T* __restrict__ u2,
    const T* __restrict__ wts,      // (C, n, 2) interleaved re/im
    T* __restrict__ grid,           // (C, n0, n1, n2, 2) interleaved re/im
    int n, int C, int n0, int n1, int n2, T beta) {
  // The (axis-1, axis-2) taps as spread_gm's (y, x) taps.
  constexpr int PER_TAP = sizeof(T) == 4 ? 1 : 2;
  constexpr int Q = pow2ceil(PER_TAP * W);  // lanes a tap row
  constexpr int R = 32 / Q;                 // tap rows a step
  constexpr int STEPS = (W + R - 1) / R;

  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n) return;  // whole warps only: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;
  if (!any_weight(wts, j, n, C, lane)) return;

  // Lane k < W holds psi_1(k) and psi_0(k), lane 16 + k psi_2(k).
  const bool xhalf = lane >= 16;
  const int kk = lane & 15;
  const T u = xhalf ? u2[j] : u1[j];
  const T cell = floor(u);
  const T frac = u - cell;
  const long long i0 = static_cast<long long>(ceil(u - T(W) / T(2)));
  const T psi = kk < W ? es_kernel((cell - T(i0 + kk)) + frac, W, beta) : T(0);
  const long long iy0 = __shfl_sync(kFull, i0, 0);
  const long long ix0 = __shfl_sync(kFull, i0, 16);
  const T uz = u0[j];
  const T zcell = floor(uz);
  const T zfrac = uz - zcell;
  const long long iz0 = static_cast<long long>(ceil(uz - T(W) / T(2)));
  const T psiz = lane < W ? es_kernel((zcell - T(iz0 + lane)) + zfrac, W, beta) : T(0);

  const int s = lane % Q;
  const int b = s / PER_TAP;           // tap column (axis 2)
  const int part = s % PER_TAP;        // re (0) or im (1) for double
  const bool col_ok = s < PER_TAP * W;
  const T psix = __shfl_sync(kFull, psi, 16 + (b & 15));
  const int gx = wrap(ix0 + b, n2);

  long long off[STEPS];
  T val[STEPS];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int a = st * R + lane / Q;     // tap row (axis 1)
    const T psiy = __shfl_sync(kFull, psi, a & 15);
    const bool ok = col_ok && a < W;
    val[st] = ok ? psiy * psix : T(0);
    off[st] = (static_cast<long long>(wrap(iy0 + a, n1)) * n2 + gx) * 2;
  }
  const long long slab = static_cast<long long>(n1) * n2 * 2;
  const long long plane = static_cast<long long>(n0) * slab;
  for (int c = 0; c < C; ++c) {
    const T* wc = wts + (static_cast<long long>(c) * n + j) * 2;
    const T wre = wc[0];
    const T wim = wc[1];
    if (wre == T(0) && wim == T(0)) continue;  // the same for every lane
    T* gc = grid + c * plane;
    // The axis-0 loop stays rolled: unrolled, its w x STEPS atomics'
    // addresses spill at float64 and w >= 9.
#pragma unroll 1
    for (int a = 0; a < W; ++a) {
      const T za = __shfl_sync(kFull, psiz, a);
      if (za == T(0)) continue;  // the same for every lane
      T* ga = gc + wrap(iz0 + a, n0) * slab;
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        if (val[st] != T(0)) add_tap(ga + off[st], part, za * val[st], wre, wim);
      }
    }
  }
}

using fftvis_bins::bin_edge;

// Where spread_gm_3d is the faster form, [0] complex64, [1] complex128:
// below kSmMinSources sources on any grid, where the SM form's sort and
// launches cost more than the GM form's atomics, and below
// kSmMinSourcesPerBin sources a bin of uniform density (n B^3 / cells),
// where the SM form flushes a padded tile of (B + w - 1)^3 cells for a
// source or two. Each is the crossover of the two wrappers' times on the
// card, interpolated between the two points of chip_smoke.py phase 3's
// sweep that straddle it (PERF.md row 1b).
constexpr int kSmMinSources[2] = {49000, 4200};
constexpr double kSmMinSourcesPerBin[2] = {2.5, 1.55};

template <int P>
__host__ __device__ constexpr int tile_threads() { return (P * P + 31) / 32 * 32; }

// Sources a block of spread_sm_3d stages a round: a (source, axis) pair a
// thread, within 40 KB of static shared memory.
template <typename T, int W, int P>
__host__ __device__ constexpr int stage_sources() {
  constexpr int by_threads = tile_threads<P>() / 3;
  constexpr int bytes = (3 * W + 2) * static_cast<int>(sizeof(T)) + 3 * static_cast<int>(sizeof(int));
  constexpr int by_bytes = 40 * 1024 / bytes;
  return by_threads < by_bytes ? by_threads : by_bytes;
}

// Adds z[a] (vre, vim) to the column's cells L + a, a < W: the source's
// first axis-0 cell L a compile-time offset, so the column stays in
// registers.
template <int L, int W, int P, typename T>
__device__ __forceinline__ void add_column(T (&cre)[P], T (&cim)[P], const T (&z)[W], T vre,
                                           T vim) {
#pragma unroll
  for (int a = 0; a < W; ++a) {
    cre[L + a] += z[a] * vre;
    cim[L + a] += z[a] * vim;
  }
}

// add_column at the runtime offset l0 in [0, B) (the same for every thread
// of the block: one source's).
template <int W, int B, int P, typename T>
__device__ __forceinline__ void add_column_at(int l0, T (&cre)[P], T (&cim)[P], const T (&z)[W],
                                              T vre, T vim) {
  switch (l0) {
#define FFTVIS_COLUMN_CASE(L)                                          \
  case L:                                                              \
    if constexpr (L < B) add_column<L, W, P>(cre, cim, z, vre, vim);   \
    break;
    FFTVIS_COLUMN_CASE(0) FFTVIS_COLUMN_CASE(1) FFTVIS_COLUMN_CASE(2) FFTVIS_COLUMN_CASE(3)
    FFTVIS_COLUMN_CASE(4) FFTVIS_COLUMN_CASE(5) FFTVIS_COLUMN_CASE(6) FFTVIS_COLUMN_CASE(7)
#undef FFTVIS_COLUMN_CASE
    default:
      break;
  }
}

// B: the bin edge, fftvis_bins::kBinEdge's entry (at most 8); P = B + W - 1.
template <typename T, int W, int B>
__global__ void __launch_bounds__(tile_threads<B + W - 1>()) spread_sm_3d(
    const T* __restrict__ u0, const T* __restrict__ u1, const T* __restrict__ u2,
    const T* __restrict__ wts,          // (C, n, 2) interleaved re/im
    const long long* __restrict__ perm, // (n,) sources in bin order
    const long long* __restrict__ off,  // (nbins + 1,) CSR bin offsets
    const long long* __restrict__ sub,  // (nbins + 1,) first subproblem of each bin
    T* __restrict__ grid,               // (C, n0, n1, n2, 2) interleaved re/im
    int n, int C, int n0, int n1, int n2, int nb1, int nb2, int nbins, int K, T beta) {
  static_assert(B >= 1 && B <= 8, "add_column_at covers edges up to 8");
  constexpr int P = B + W - 1;  // padded tile edge
  constexpr int kStage = stage_sources<T, W, P>();
  __shared__ T psi_s[kStage][3][W];
  __shared__ T w_s[kStage][2];
  __shared__ int l_s[kStage][3];  // local first tap cell; l_s[.][0] < 0: skip

  // Block b is subproblem b: up to K sources of one bin, the bin found by
  // a binary search of sub.
  const long long b = blockIdx.x;
  if (b >= sub[nbins]) return;
  int lo = 0;
  int hi = nbins;  // sub[lo] <= b < sub[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (sub[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int bin = lo;
  const int c = blockIdx.y;
  const long long k0 = max(off[bin] + (b - sub[bin]) * K, 0LL);
  const long long k1 = min(min(k0 + K, off[bin + 1]), static_cast<long long>(n));
  if (k0 >= k1) return;
  const int s0 = bin / (nb1 * nb2) * B;
  const int s1 = bin / nb2 % nb1 * B;
  const int s2 = bin % nb2 * B;
  const long long slab = static_cast<long long>(n1) * n2 * 2;
  T* gc = grid + c * (n0 * slab);

  // This thread's tile column (q1, q2) and its P cells along axis 0.
  const int q1 = threadIdx.x / P;
  const int q2 = threadIdx.x % P;
  const bool own = threadIdx.x < P * P;
  T cre[P], cim[P];
#pragma unroll
  for (int p = 0; p < P; ++p) cre[p] = cim[p] = T(0);

  for (long long base = k0; base < k1; base += kStage) {
    const int cnt = static_cast<int>(min(static_cast<long long>(kStage), k1 - base));
    // Stage: thread (j, axis) evaluates source j's W ES values on the axis
    // and its local first cell. A source with zero weights, or outside this
    // bin (a malformed permutation or offsets), is skipped.
    for (int t = threadIdx.x; t < cnt * 3; t += blockDim.x) {
      const int j = t / 3;
      const int ax = t % 3;
      const long long src = perm[base + j];
      const bool valid = src >= 0 && src < n;
      const long long sv = valid ? src : 0;
      const T* ua = ax == 0 ? u0 : ax == 1 ? u1 : u2;
      const int na = ax == 0 ? n0 : ax == 1 ? n1 : n2;
      const int sa = ax == 0 ? s0 : ax == 1 ? s1 : s2;
      const T uu = ua[sv];
      const T cell = floor(uu);
      const T frac = uu - cell;
      const long long i0 = static_cast<long long>(ceil(uu - T(W) / T(2)));
#pragma unroll
      for (int k = 0; k < W; ++k) psi_s[j][ax][k] = es_kernel((cell - T(i0 + k)) + frac, W, beta);
      const int l = wrap(i0, na) - sa;
      l_s[j][ax] = valid && l >= 0 && l < B ? l : -1;
      if (ax == 0) {
        const T* wc = wts + (static_cast<long long>(c) * n + sv) * 2;
        w_s[j][0] = wc[0];
        w_s[j][1] = wc[1];
      }
    }
    __syncthreads();
    // Accumulate: each staged source into the columns its footprint covers.
    for (int j = 0; j < cnt; ++j) {
      const int l0 = l_s[j][0];
      const int l1 = l_s[j][1];
      const int l2 = l_s[j][2];
      const int b1 = q1 - l1;
      const int b2 = q2 - l2;
      if (!own || l0 < 0 || l1 < 0 || l2 < 0 || b1 < 0 || b1 >= W || b2 < 0 || b2 >= W) continue;
      const T wre = w_s[j][0];
      const T wim = w_s[j][1];
      if (wre == T(0) && wim == T(0)) continue;
      const T v = psi_s[j][1][b1] * psi_s[j][2][b2];
      T z[W];
#pragma unroll
      for (int a = 0; a < W; ++a) z[a] = psi_s[j][0][a];
      add_column_at<W, B, P>(l0, cre, cim, z, v * wre, v * wim);
    }
    __syncthreads();
  }

  // The flush: the column's nonzero cells, wrapped onto the grid.
  if (!own) return;
  const long long col = static_cast<long long>(wrap(s1 + q1, n1)) * n2 + wrap(s2 + q2, n2);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (cre[p] == T(0) && cim[p] == T(0)) continue;
    add_complex(gc + (wrap(s0 + p, n0) * static_cast<long long>(n1) * n2 + col) * 2, cre[p],
                cim[p]);
  }
}

// The device bin sort of spread_sm_3d, a counting sort in three kernels
// (nufft/spread.py bin_sort_3d is its plain version): bin_count gives every
// source its bin key (the bin of its first tap cell ceil(u - w/2) mod n,
// edge cells a side, row-major) and counts the bins with integer atomics;
// bin_scan (one block) turns the counts into the CSR offsets and the first
// subproblem of every bin (K sources a subproblem); bin_scatter writes each
// source's index at its bin's next free slot. The order within a bin
// follows the atomics, so it varies from run to run, as the spread's
// summation order does.
template <typename T>
__global__ void bin_count(const T* __restrict__ u0, const T* __restrict__ u1,
                          const T* __restrict__ u2, int n, int n0, int n1, int n2, int nb1,
                          int nb2, int edge, T half_w, int* __restrict__ key,
                          int* __restrict__ count) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int b0 = wrap(static_cast<long long>(ceil(u0[j] - half_w)), n0) / edge;
  const int b1 = wrap(static_cast<long long>(ceil(u1[j] - half_w)), n1) / edge;
  const int b2 = wrap(static_cast<long long>(ceil(u2[j] - half_w)), n2) / edge;
  const int k = (b0 * nb1 + b1) * nb2 + b2;
  key[j] = k;
  atomicAdd(count + k, 1);
}

constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kScanThreads) bin_scan(
    int* __restrict__ count, int nbins, int K, long long* __restrict__ off,
    long long* __restrict__ sub) {
  __shared__ long long part[kScanThreads][2];
  const int t = threadIdx.x;
  const int chunk = (nbins + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * chunk, nbins);
  const int hi = min(lo + chunk, nbins);
  long long a = 0;
  long long s = 0;
  for (int i = lo; i < hi; ++i) {
    a += count[i];
    s += (count[i] + K - 1) / K;
  }
  part[t][0] = a;
  part[t][1] = s;
  __syncthreads();
  // Inclusive scan of the threads' sums (Hillis-Steele).
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const long long pa = t >= d ? part[t - d][0] : 0;
    const long long ps = t >= d ? part[t - d][1] : 0;
    __syncthreads();
    part[t][0] += pa;
    part[t][1] += ps;
    __syncthreads();
  }
  a = t ? part[t - 1][0] : 0;
  s = t ? part[t - 1][1] : 0;
  for (int i = lo; i < hi; ++i) {
    off[i] = a;
    sub[i] = s;
    a += count[i];
    s += (count[i] + K - 1) / K;
    count[i] = 0;  // the scatter's cursor
  }
  if (t == kScanThreads - 1) {
    off[nbins] = part[t][0];
    sub[nbins] = part[t][1];
  }
}

__global__ void bin_scatter(const int* __restrict__ key, int n, const long long* __restrict__ off,
                            int* __restrict__ cursor, long long* __restrict__ perm) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int k = key[j];
  perm[off[k] + atomicAdd(cursor + k, 1)] = j;
}

template <typename T>
int launch_bin_sort(const void* u0, const void* u1, const void* u2, int n, int n0, int n1,
                    int n2, int w, int edge, int K, void* key_count, void* perm, void* off,
                    void* sub, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || edge < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb0 = (n0 + edge - 1) / edge;
  const int nb1 = (n1 + edge - 1) / edge;
  const int nb2 = (n2 + edge - 1) / edge;
  const int nbins = nb0 * nb1 * nb2;
  int* key = static_cast<int*>(key_count);
  int* count = key + n;
  const cudaError_t set = cudaMemsetAsync(count, 0, sizeof(int) * nbins, stream);
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned int blocks = static_cast<unsigned int>((n + 255) / 256);
  bin_count<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1), static_cast<const T*>(u2), n, n0,
      n1, n2, nb1, nb2, edge, static_cast<T>(w) / T(2), key, count);
  bin_scan<<<1, kScanThreads, 0, stream>>>(count, nbins, K, static_cast<long long*>(off),
                                           static_cast<long long*>(sub));
  bin_scatter<<<blocks, 256, 0, stream>>>(key, n, static_cast<const long long*>(off), count,
                                          static_cast<long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}

// nsub: the grid's blocks, at least the subproblems (sub[nbins]); K the
// sources a subproblem.
template <typename T, int W>
int launch_sm_w(const void* u0, const void* u1, const void* u2, const void* wts,
                const void* perm, const void* off, const void* sub, void* grid, int n,
                int C, int n0, int n1, int n2, int nsub, int K, double beta,
                cudaStream_t stream) {
  constexpr int B = bin_edge<T>(W);
  const int nb0 = (n0 + B - 1) / B;
  const int nb1 = (n1 + B - 1) / B;
  const int nb2 = (n2 + B - 1) / B;
  if (nsub < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks(static_cast<unsigned int>(nsub), static_cast<unsigned int>(C));
  spread_sm_3d<T, W, B><<<blocks, tile_threads<B + W - 1>(), 0, stream>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1), static_cast<const T*>(u2),
      static_cast<const T*>(wts), static_cast<const long long*>(perm),
      static_cast<const long long*>(off), static_cast<const long long*>(sub),
      static_cast<T*>(grid), n, C, n0, n1, n2, nb1, nb2, nb0 * nb1 * nb2, K,
      static_cast<T>(beta));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_spread_sm(const void* u0, const void* u1, const void* u2, const void* wts,
                     const void* perm, const void* off, const void* sub, void* grid, int n,
                     int C, int n0, int n1, int n2, int nsub, int K, int w, double beta,
                     void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (w) {
#define FFTVIS_SPREAD_SM_CASE(W)                                                       \
  case W:                                                                              \
    return launch_sm_w<T, W>(u0, u1, u2, wts, perm, off, sub, grid, n, C, n0, n1, n2,  \
                             nsub, K, beta, stream);
    FFTVIS_SPREAD_SM_CASE(2) FFTVIS_SPREAD_SM_CASE(3) FFTVIS_SPREAD_SM_CASE(4)
    FFTVIS_SPREAD_SM_CASE(5) FFTVIS_SPREAD_SM_CASE(6) FFTVIS_SPREAD_SM_CASE(7)
    FFTVIS_SPREAD_SM_CASE(8) FFTVIS_SPREAD_SM_CASE(9) FFTVIS_SPREAD_SM_CASE(10)
    FFTVIS_SPREAD_SM_CASE(11) FFTVIS_SPREAD_SM_CASE(12) FFTVIS_SPREAD_SM_CASE(13)
    FFTVIS_SPREAD_SM_CASE(14) FFTVIS_SPREAD_SM_CASE(15) FFTVIS_SPREAD_SM_CASE(16)
#undef FFTVIS_SPREAD_SM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int W>
void launch_nd_w(int d, const void* u0, const void* u1, const void* u2,
                 const void* wts, void* grid, int n, int C, int n0, int n1,
                 int n2, double beta, cudaStream_t stream) {
  if (d == 1) {
    spread_gm_1d<T, W><<<static_cast<unsigned int>((n + kD1Sources - 1) / kD1Sources),
                         kD1Threads, 0, stream>>>(
        static_cast<const T*>(u0), static_cast<const T*>(wts), static_cast<T*>(grid),
        n, C, n0, static_cast<T>(beta));
    return;
  }
  const int threads = 256;  // 8 sources a block
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(n) * 32 + threads - 1) / threads);
  spread_gm_3d<T, W><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(u0), static_cast<const T*>(u1), static_cast<const T*>(u2),
      static_cast<const T*>(wts), static_cast<T*>(grid), n, C, n0, n1, n2,
      static_cast<T>(beta));
}

template <typename T>
int launch_spread_nd(int d, const void* u0, const void* u1, const void* u2,
                     const void* wts, void* grid, int n, int C, int n0, int n1,
                     int n2, int w, double beta, void* stream_ptr) {
  if (d != 1 && d != 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (w) {
#define FFTVIS_SPREAD_ND_CASE(W)                                                     \
  case W:                                                                            \
    launch_nd_w<T, W>(d, u0, u1, u2, wts, grid, n, C, n0, n1, n2, beta, stream);     \
    break;
    FFTVIS_SPREAD_ND_CASE(2) FFTVIS_SPREAD_ND_CASE(3) FFTVIS_SPREAD_ND_CASE(4)
    FFTVIS_SPREAD_ND_CASE(5) FFTVIS_SPREAD_ND_CASE(6) FFTVIS_SPREAD_ND_CASE(7)
    FFTVIS_SPREAD_ND_CASE(8) FFTVIS_SPREAD_ND_CASE(9) FFTVIS_SPREAD_ND_CASE(10)
    FFTVIS_SPREAD_ND_CASE(11) FFTVIS_SPREAD_ND_CASE(12) FFTVIS_SPREAD_ND_CASE(13)
    FFTVIS_SPREAD_ND_CASE(14) FFTVIS_SPREAD_ND_CASE(15) FFTVIS_SPREAD_ND_CASE(16)
#undef FFTVIS_SPREAD_ND_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// adjoint = false: wts -> grid (spread_gm); true: grid -> wts
// (spread_adjoint_gm), wts then the (C, n) output.
template <typename T, int W>
void launch_w(const void* uy, const void* ux, void* wts, void* grid,
              int n, int C, int nfy, int nfx, double beta, bool adjoint,
              cudaStream_t stream) {
  const int threads = 256;  // 8 sources a block
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(n) * 32 + threads - 1) / threads);
  if (adjoint) {
    spread_adjoint_gm<T, W><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(uy), static_cast<const T*>(ux),
        static_cast<const T*>(grid), static_cast<T*>(wts), n, C, nfy, nfx,
        static_cast<T>(beta));
    return;
  }
  spread_gm<T, W><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(uy), static_cast<const T*>(ux),
      static_cast<const T*>(wts), static_cast<T*>(grid), n, C, nfy, nfx,
      static_cast<T>(beta));
}

template <typename T>
int launch_spread(const void* uy, const void* ux, void* wts, void* grid,
                  int n, int C, int nfy, int nfx, int w, double beta,
                  bool adjoint, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (w) {
#define FFTVIS_SPREAD_CASE(W)                                                 \
  case W:                                                                     \
    launch_w<T, W>(uy, ux, wts, grid, n, C, nfy, nfx, beta, adjoint, stream); \
    break;
    FFTVIS_SPREAD_CASE(2) FFTVIS_SPREAD_CASE(3) FFTVIS_SPREAD_CASE(4)
    FFTVIS_SPREAD_CASE(5) FFTVIS_SPREAD_CASE(6) FFTVIS_SPREAD_CASE(7)
    FFTVIS_SPREAD_CASE(8) FFTVIS_SPREAD_CASE(9) FFTVIS_SPREAD_CASE(10)
    FFTVIS_SPREAD_CASE(11) FFTVIS_SPREAD_CASE(12) FFTVIS_SPREAD_CASE(13)
    FFTVIS_SPREAD_CASE(14) FFTVIS_SPREAD_CASE(15) FFTVIS_SPREAD_CASE(16)
#undef FFTVIS_SPREAD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_spread_f32(const void* uy, const void* ux,
                                 const void* wts, void* grid, int n, int C,
                                 int nfy, int nfx, int w, double beta,
                                 void* stream) {
  return launch_spread<float>(uy, ux, const_cast<void*>(wts), grid, n, C, nfy,
                              nfx, w, beta, false, stream);
}

extern "C" int fftvis_spread_f64(const void* uy, const void* ux,
                                 const void* wts, void* grid, int n, int C,
                                 int nfy, int nfx, int w, double beta,
                                 void* stream) {
  return launch_spread<double>(uy, ux, const_cast<void*>(wts), grid, n, C, nfy,
                               nfx, w, beta, false, stream);
}

// The adjoint: the (C, nfy, nfx) gradient ``grid`` -> the (C, n) ``out``.
extern "C" int fftvis_spread_adjoint_f32(const void* uy, const void* ux,
                                         const void* grid, void* out, int n,
                                         int C, int nfy, int nfx, int w,
                                         double beta, void* stream) {
  return launch_spread<float>(uy, ux, out, const_cast<void*>(grid), n, C, nfy,
                              nfx, w, beta, true, stream);
}

extern "C" int fftvis_spread_adjoint_f64(const void* uy, const void* ux,
                                         const void* grid, void* out, int n,
                                         int C, int nfy, int nfx, int w,
                                         double beta, void* stream) {
  return launch_spread<double>(uy, ux, out, const_cast<void*>(grid), n, C, nfy,
                               nfx, w, beta, true, stream);
}

// The form of a D = 3 spread of n sources onto the (n0, n1, n2) grid at
// width w (f64: complex128): the SM form's bin edge, or 0 for spread_gm_3d
// (an axis shorter than the padded tile, fewer than kSmMinSources[f64]
// sources, or fewer than kSmMinSourcesPerBin a bin).
extern "C" int fftvis_spread_nd_bin_edge(int f64, int w, int n, int n0, int n1, int n2) {
  if (w < 2 || w > 16) return 0;
  const int B = fftvis_bins::kBinEdge[f64 != 0][w];
  const int P = B + w - 1;
  if (n0 < P || n1 < P || n2 < P || n < kSmMinSources[f64 != 0]) return 0;
  const double cells = static_cast<double>(n0) * n1 * n2;
  return static_cast<double>(n) * B * B * B >= kSmMinSourcesPerBin[f64 != 0] * cells ? B : 0;
}

// The SM form onto the (C, n0, n1, n2) grid: perm (n,), off and sub
// (nbins + 1,) int64 from the wrapper's bin sort with
// fftvis_spread_nd_bin_edge's edge and subproblems of K sources; nsub
// blocks, at least sub[nbins].
extern "C" int fftvis_spread_sm_3d_f32(const void* u0, const void* u1, const void* u2,
                                       const void* wts, const void* perm, const void* off,
                                       const void* sub, void* grid, int n, int C, int n0,
                                       int n1, int n2, int nsub, int K, int w, double beta,
                                       void* stream) {
  return launch_spread_sm<float>(u0, u1, u2, wts, perm, off, sub, grid, n, C, n0, n1, n2,
                                 nsub, K, w, beta, stream);
}

extern "C" int fftvis_spread_sm_3d_f64(const void* u0, const void* u1, const void* u2,
                                       const void* wts, const void* perm, const void* off,
                                       const void* sub, void* grid, int n, int C, int n0,
                                       int n1, int n2, int nsub, int K, int w, double beta,
                                       void* stream) {
  return launch_spread_sm<double>(u0, u1, u2, wts, perm, off, sub, grid, n, C, n0, n1, n2,
                                  nsub, K, w, beta, stream);
}

// The device bin sort of n sources on the (n0, n1, n2) grid at width w and
// bin edge ``edge``: key_count int32 scratch of n + nbins, perm (n,) and
// off, sub (nbins + 1,) int64 outputs (subproblems of K sources).
extern "C" int fftvis_bin_sort_3d_f32(const void* u0, const void* u1, const void* u2, int n,
                                      int n0, int n1, int n2, int w, int edge, int K,
                                      void* key_count, void* perm, void* off, void* sub,
                                      void* stream) {
  return launch_bin_sort<float>(u0, u1, u2, n, n0, n1, n2, w, edge, K, key_count, perm, off,
                                sub, stream);
}

extern "C" int fftvis_bin_sort_3d_f64(const void* u0, const void* u1, const void* u2, int n,
                                      int n0, int n1, int n2, int w, int edge, int K,
                                      void* key_count, void* perm, void* off, void* sub,
                                      void* stream) {
  return launch_bin_sort<double>(u0, u1, u2, n, n0, n1, n2, w, edge, K, key_count, perm, off,
                                 sub, stream);
}

// D = 1 (u1, u2 unused, n1 = n2 = 1) or D = 3 spreading onto the (C, n0[,
// n1, n2]) grid.
extern "C" int fftvis_spread_nd_f32(int d, const void* u0, const void* u1,
                                    const void* u2, const void* wts, void* grid,
                                    int n, int C, int n0, int n1, int n2, int w,
                                    double beta, void* stream) {
  return launch_spread_nd<float>(d, u0, u1, u2, wts, grid, n, C, n0, n1, n2, w,
                                 beta, stream);
}

extern "C" int fftvis_spread_nd_f64(int d, const void* u0, const void* u1,
                                    const void* u2, const void* wts, void* grid,
                                    int n, int C, int n0, int n1, int n2, int w,
                                    double beta, void* stream) {
  return launch_spread_nd<double>(d, u0, u1, u2, wts, grid, n, C, n0, n1, n2, w,
                                  beta, stream);
}
