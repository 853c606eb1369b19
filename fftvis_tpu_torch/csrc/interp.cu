// Type-2 tap interpolation from the fine grid to nonuniform targets.
//
// Replaces the Pallas interpolation of the JAX package
// (fftvis_tpu/nufft/pallas_interp.py, _build_interp_call):
//
//     out[c, t] = sum_a sum_b G[c, iy[t, a], ix[t, b]] * vy[t, a] * vx[t, b]
//
// with the plan's host-computed taps (indices already mod nf). The TPU
// kernel bin-sorts targets and rebuilds the taps as one-hot matrices for
// its matrix unit; here a gather is the natural form.
//
// Bound on the card, in bytes: the distinct grid cells the taps touch, the
// tap tables and the output, each moved once. At the slice's 63,190
// baselines, C = 4: p=2 (grid (4320, 3072), w=14, complex128) 45.6 MB of
// touched cells (0.71M cells, 11.4 MB per channel) + 21.2 MB of taps +
// 4.0 MB out = 71 MB, 21 us at 3.35 TB/s; p=1 (grid (4320, 3000), w=8,
// complex64) 7.5 + 8.1 + 2.0 = 17.6 MB, 5.2 us. The flops are far below.
// A gather of every tap reads 17x more than that (12.4M reads of 0.71M
// cells at p=2): the redundant baselines of the slice's array share their
// footprints (3,716 distinct footprints for 63,190 targets), and that
// traffic, not device memory, bounded a gather of every tap.
//
// Design: the host sorts the targets so that identical footprints are
// neighbours and cuts the sorted tables into runs of rows with identical
// tap cells, at most 32 rows a run (nufft/interp.py footprint_runs). One
// warp takes one run, for all C channels, in one of two forms:
// - a run of LONG_RUN rows or more: the warp gathers the footprint's w x w
//   cells of one channel into shared memory once (a group of P lanes reads
//   one contiguous grid row, 224 B at complex128 and w = 14), then each
//   lane evaluates one target of the run from it, reading the cells as
//   broadcasts with its own taps in registers: no reduction across lanes;
// - a shorter run: row by row, lanes over the w x w taps. A lane owns tap
//   column b = lane % P (P = W rounded up to a power of two) and rows
//   a = lane / P + R * step (R = 32 / P rows a step), reads the taps once
//   for all C channels, and each channel's sums meet in a __shfl_xor_sync
//   reduction. That is the form for arrays without redundancy, where every
//   run is one row.
// Row k of the tables is target order[k] (a null order is the identity),
// and the result is written to out[c, order[k]]: outputs are disjoint, no
// atomics. w is a template parameter (2..16), so the tap loops unroll. The
// kernel clamps each run to rows [0, m) and writes no column outside
// [0, m), so a malformed runs or order tensor gives wrong values, never an
// access out of bounds.
//
// interp_adjoint_runs is the adjoint with respect to G, what a gradient
// through the interpolation needs (the JAX package lets XLA differentiate
// its gather; no Pallas kernel has a backward):
//
//     gG[c, iy[t, a], ix[t, b]] += vy[t, a] vx[t, b] g[c, t]
//
// a scatter of each target's w x w taps onto the (zeroed) grid gradient,
// on the same tables, runs and order. One warp a run, the lanes over the
// taps as in the short-run form above (tap column b = lane % P, rows a =
// lane / P + R * step): the rows of a run share their tap cells, so a lane
// sums its taps' weights times the gradient over the run's rows in
// registers and adds once a tap and channel, with the sm_90 float2 atomic
// at complex64 and two fp64 atomics at complex128. Runs of different
// footprints overlap on the grid, so the summation order of the atomics
// varies from run to run. Bound: the (C, nfy, nfx) output written once, the
// tap tables and the (C, m) gradient read once.
//
// interp_taps_nd is the interpolation of a 1D (C, n0) or 3D (C, n0, n1, n2)
// grid, for the public type-2 and type-3 transforms at d = 1 and d = 3
// (the JAX package's interpolation there is an XLA gather and einsum):
//
//     out[c, t] = sum over the w^D taps of G[c, taps] * prod_axis v[t, tap]
//
// from the per-axis (m, w) tap tables, rows in target order. The 2D form's
// footprint runs do not carry over (a target's w^3 taps rarely repeat), so
// there is one warp a target: at D = 1 the lanes take the w taps; at D = 3
// they take the w x w (axis-1, axis-2) taps, a group of w lanes a
// contiguous row of the last axis, and a loop runs over the w axis-0 taps.
// Each lane reads its taps for every channel, and a __shfl_xor_sync
// reduction sums a channel; outputs are disjoint, no atomics. Bound, in
// bytes: the distinct cells the taps touch of every channel, the tables and
// the output, each moved once.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int WARPS = 8;     // warps (runs) a block
constexpr int LONG_RUN = 4;  // rows from which a run takes the shared form

__host__ __device__ constexpr int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// One row (target) with the lanes over its taps, for all C channels.
template <typename T, int W>
__device__ __forceinline__ void interp_row(
    const typename Vec2<T>::type* __restrict__ Gv, const int* __restrict__ iy,
    const int* __restrict__ ix, const T* __restrict__ vy,
    const T* __restrict__ vx, long long k, long long t,
    typename Vec2<T>::type* __restrict__ outv, int C, int nfx,
    long long plane, int m, int lane) {
  using V = typename Vec2<T>::type;
  constexpr int P = pow2ceil(W);
  constexpr int R = 32 / P;
  constexpr int STEPS = (W + R - 1) / R;
  const int b = lane % P;
  const int r = lane / P;
  const long long row = k * W;

  int xcell = 0;
  T wx = T(0);
  if (b < W) {
    xcell = ix[row + b];
    wx = vx[row + b];
  }
  int off[STEPS];
  T wt[STEPS];
  bool ok[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int a = s * R + r;
    ok[s] = b < W && a < W;
    off[s] = ok[s] ? iy[row + a] * nfx + xcell : 0;
    wt[s] = ok[s] ? vy[row + a] * wx : T(0);
  }
  for (int c = 0; c < C; ++c) {
    const V* Gc = Gv + c * plane;
    T re = T(0);
    T im = T(0);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (ok[s]) {
        const V g = Gc[off[s]];
        re += g.x * wt[s];
        im += g.y * wt[s];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      re += __shfl_xor_sync(kFull, re, d);
      im += __shfl_xor_sync(kFull, im, d);
    }
    if (lane == 0 && t >= 0 && t < m) {
      V o;
      o.x = re;
      o.y = im;
      outv[c * static_cast<long long>(m) + t] = o;
    }
  }
}

// A long run (rows k0..k1 with the same tap cells) in the shared form.
template <typename T, int W>
__device__ __forceinline__ void interp_shared(
    const typename Vec2<T>::type* __restrict__ Gv, const int* __restrict__ iy,
    const int* __restrict__ ix, const T* __restrict__ vy,
    const T* __restrict__ vx, const int* __restrict__ order, int k0, int k1,
    typename Vec2<T>::type* __restrict__ outv, int C, int nfx,
    long long plane, int m, int lane) {
  using V = typename Vec2<T>::type;
  constexpr int P = pow2ceil(W);
  constexpr int R = 32 / P;
  constexpr int STEPS = (W + R - 1) / R;
  __shared__ V foot[WARPS][W * W];

  // The footprint: row k0's tap cells, which every row of the run shares.
  const int b = lane % P;
  const int r = lane / P;
  const long long row0 = static_cast<long long>(k0) * W;
  const int xcell = b < W ? ix[row0 + b] : 0;
  int off[STEPS];
  bool ok[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int a = s * R + r;
    ok[s] = b < W && a < W;
    off[s] = ok[s] ? iy[row0 + a] * nfx + xcell : 0;
  }
  V* f = foot[threadIdx.x >> 5];
  for (int base = k0; base < k1; base += 32) {
    const long long k = base + lane;  // this lane's target row
    const bool active = k < k1;
    T wx[W];  // vy is read per tap row, to keep registers for occupancy
#pragma unroll
    for (int bb = 0; bb < W; ++bb) wx[bb] = active ? vx[k * W + bb] : T(0);
    const long long t = active ? (order ? order[k] : k) : 0;
    const bool write = active && t >= 0 && t < m;
    for (int c = 0; c < C; ++c) {
      const V* Gc = Gv + c * plane;
      __syncwarp();  // the previous channel's reads of f are done
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (ok[s]) f[(s * R + r) * W + b] = Gc[off[s]];
      }
      __syncwarp();
      if (active) {
        T re = T(0);
        T im = T(0);
#pragma unroll
        for (int a = 0; a < W; ++a) {
          T tr = T(0);
          T ti = T(0);
#pragma unroll
          for (int bb = 0; bb < W; ++bb) {
            const V g = f[a * W + bb];
            tr += g.x * wx[bb];
            ti += g.y * wx[bb];
          }
          const T wy = vy[k * W + a];
          re += wy * tr;
          im += wy * ti;
        }
        V o;
        o.x = re;
        o.y = im;
        if (write) outv[c * static_cast<long long>(m) + t] = o;
      }
    }
  }
}

// One warp a run. The instance is held to 64 registers (4 blocks a SM):
// the shared form spills a little at complex128, w = 14, and still runs
// faster than at 96 registers and half the warps in flight.
template <typename T, int W>
__global__ void __launch_bounds__(WARPS * 32, 4) interp_runs(
    const T* __restrict__ G,          // (C, nfy, nfx, 2) interleaved re/im
    const int* __restrict__ iy,       // (m, W), row k in visiting order
    const int* __restrict__ ix,       // (m, W)
    const T* __restrict__ vy,         // (m, W)
    const T* __restrict__ vx,         // (m, W)
    const int* __restrict__ runs,     // (nruns + 1,) first row of each run
    const int* __restrict__ order,    // (m,) output column of row k, or null
    T* __restrict__ out,              // (C, m, 2) interleaved re/im
    int C, int nfy, int nfx, int m, int nruns) {
  using V = typename Vec2<T>::type;
  const int run = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (run >= nruns) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const int k0 = min(max(runs[run], 0), m);
  const int k1 = min(max(runs[run + 1], k0), m);
  const long long plane = static_cast<long long>(nfy) * nfx;
  const V* Gv = reinterpret_cast<const V*>(G);
  V* outv = reinterpret_cast<V*>(out);

  if (k1 - k0 >= LONG_RUN) {
    interp_shared<T, W>(Gv, iy, ix, vy, vx, order, k0, k1, outv, C, nfx,
                        plane, m, lane);
    return;
  }
  for (long long k = k0; k < k1; ++k) {
    interp_row<T, W>(Gv, iy, ix, vy, vx, k, order ? order[k] : k, outv, C,
                     nfx, plane, m, lane);
  }
}

__device__ __forceinline__ void add_cell(float2* cell, float re, float im) {
  atomicAdd(cell, make_float2(re, im));
}

__device__ __forceinline__ void add_cell(double2* cell, double re, double im) {
  atomicAdd(&cell->x, re);
  atomicAdd(&cell->y, im);
}

template <typename T, int W>
__global__ void __launch_bounds__(WARPS * 32) interp_adjoint_runs(
    const T* __restrict__ g,          // (C, m, 2) gradient, target order
    const int* __restrict__ iy,       // (m, W), row k in visiting order
    const int* __restrict__ ix,       // (m, W)
    const T* __restrict__ vy,         // (m, W)
    const T* __restrict__ vx,         // (m, W)
    const int* __restrict__ runs,     // (nruns + 1,) first row of each run
    const int* __restrict__ order,    // (m,) target of row k, or null
    T* __restrict__ grid,             // (C, nfy, nfx, 2) zeroed, accumulated
    int C, int nfy, int nfx, int m, int nruns) {
  using V = typename Vec2<T>::type;
  constexpr int P = pow2ceil(W);
  constexpr int R = 32 / P;
  constexpr int STEPS = (W + R - 1) / R;
  const int run = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (run >= nruns) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const int k0 = min(max(runs[run], 0), m);
  const int k1 = min(max(runs[run + 1], k0), m);
  if (k0 == k1) return;
  const long long plane = static_cast<long long>(nfy) * nfx;
  const V* gv = reinterpret_cast<const V*>(g);
  V* gridv = reinterpret_cast<V*>(grid);

  // The run's footprint: row k0's tap cells, which every row shares.
  const int b = lane % P;
  const int r = lane / P;
  const long long row0 = static_cast<long long>(k0) * W;
  const int xcell = b < W ? ix[row0 + b] : 0;
  int off[STEPS];
  bool ok[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int a = s * R + r;
    ok[s] = b < W && a < W;
    off[s] = ok[s] ? iy[row0 + a] * nfx + xcell : 0;
  }
  for (int c = 0; c < C; ++c) {
    T re[STEPS], im[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) re[s] = im[s] = T(0);
    for (int k = k0; k < k1; ++k) {
      const long long t = order ? order[k] : k;
      if (t < 0 || t >= m) continue;
      const V gk = gv[c * static_cast<long long>(m) + t];
      const long long row = static_cast<long long>(k) * W;
      const T wx = b < W ? vx[row + b] : T(0);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (ok[s]) {
          const T wt = vy[row + s * R + r] * wx;
          re[s] += wt * gk.x;
          im[s] += wt * gk.y;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (ok[s] && (re[s] != T(0) || im[s] != T(0))) {
        add_cell(gridv + c * plane + off[s], re[s], im[s]);
      }
    }
  }
}

template <typename T, int W, int D>
__global__ void __launch_bounds__(WARPS * 32) interp_taps_nd(
    const T* __restrict__ G,          // (C, n0[, n1, n2], 2) interleaved re/im
    const int* __restrict__ i0,       // (m, W) axis-0 taps
    const int* __restrict__ i1,       // (m, W) axis-1 taps (D = 3)
    const int* __restrict__ i2,       // (m, W) axis-2 taps (D = 3)
    const T* __restrict__ v0,         // (m, W)
    const T* __restrict__ v1,         // (m, W) (D = 3)
    const T* __restrict__ v2,         // (m, W) (D = 3)
    T* __restrict__ out,              // (C, m, 2) interleaved re/im
    int C, int n0, int n1, int n2, int m) {
  using V = typename Vec2<T>::type;
  constexpr int TAPS = D == 1 ? W : W * W;  // taps the lanes cover
  constexpr int STEPS = (TAPS + 31) / 32;
  const long long t = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (t >= m) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  const long long row = t * W;

  int off[STEPS];
  T wt[STEPS];
  bool ok[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int tap = s * 32 + lane;
    ok[s] = tap < TAPS;
    if (D == 1) {
      off[s] = ok[s] ? i0[row + tap] : 0;
      wt[s] = ok[s] ? v0[row + tap] : T(0);
    } else {
      const int b = tap / W;
      const int e = tap % W;
      off[s] = ok[s] ? i1[row + b] * n2 + i2[row + e] : 0;
      wt[s] = ok[s] ? v1[row + b] * v2[row + e] : T(0);
    }
  }
  const long long slab = static_cast<long long>(n1) * n2;
  const long long plane = static_cast<long long>(n0) * slab;
  const V* Gv = reinterpret_cast<const V*>(G);
  V* outv = reinterpret_cast<V*>(out);
  for (int c = 0; c < C; ++c) {
    const V* Gc = Gv + c * plane;
    T re = T(0);
    T im = T(0);
    for (int a = 0; a < (D == 1 ? 1 : W); ++a) {
      const V* Ga = Gc;
      T wa = T(1);
      if (D != 1) {
        Ga = Gc + static_cast<long long>(i0[row + a]) * slab;
        wa = v0[row + a];
      }
      T tr = T(0);
      T ti = T(0);
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        if (ok[s]) {
          const V g = Ga[off[s]];
          tr += g.x * wt[s];
          ti += g.y * wt[s];
        }
      }
      re += wa * tr;
      im += wa * ti;
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
      outv[c * static_cast<long long>(m) + t] = o;
    }
  }
}

template <typename T>
int launch_interp_nd(int d, const void* G, const void* i0, const void* i1,
                     const void* i2, const void* v0, const void* v1,
                     const void* v2, void* out, int C, int n0, int n1, int n2,
                     int m, int w, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(m) + WARPS - 1) / WARPS);
  if (d != 1 && d != 3) return static_cast<int>(cudaErrorInvalidValue);
  switch (w) {
#define FFTVIS_INTERP_ND_LAUNCH(W, D)                                         \
  interp_taps_nd<T, W, D><<<blocks, WARPS * 32, 0, stream>>>(                 \
      static_cast<const T*>(G), static_cast<const int*>(i0),                  \
      static_cast<const int*>(i1), static_cast<const int*>(i2),               \
      static_cast<const T*>(v0), static_cast<const T*>(v1),                   \
      static_cast<const T*>(v2), static_cast<T*>(out), C, n0, n1, n2, m)
#define FFTVIS_INTERP_ND_CASE(W)                                              \
  case W:                                                                     \
    if (d == 1) {                                                             \
      FFTVIS_INTERP_ND_LAUNCH(W, 1);                                          \
    } else {                                                                  \
      FFTVIS_INTERP_ND_LAUNCH(W, 3);                                          \
    }                                                                         \
    break;
    FFTVIS_INTERP_ND_CASE(2) FFTVIS_INTERP_ND_CASE(3) FFTVIS_INTERP_ND_CASE(4)
    FFTVIS_INTERP_ND_CASE(5) FFTVIS_INTERP_ND_CASE(6) FFTVIS_INTERP_ND_CASE(7)
    FFTVIS_INTERP_ND_CASE(8) FFTVIS_INTERP_ND_CASE(9) FFTVIS_INTERP_ND_CASE(10)
    FFTVIS_INTERP_ND_CASE(11) FFTVIS_INTERP_ND_CASE(12) FFTVIS_INTERP_ND_CASE(13)
    FFTVIS_INTERP_ND_CASE(14) FFTVIS_INTERP_ND_CASE(15) FFTVIS_INTERP_ND_CASE(16)
#undef FFTVIS_INTERP_ND_CASE
#undef FFTVIS_INTERP_ND_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp(const void* G, const void* iy, const void* ix,
                  const void* vy, const void* vx, const void* runs,
                  const void* order, void* out, int C, int nfy, int nfx, int m,
                  int nruns, int w, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int blocks = static_cast<unsigned int>((nruns + WARPS - 1) / WARPS);
  switch (w) {
#define FFTVIS_INTERP_CASE(W)                                                 \
  case W:                                                                     \
    interp_runs<T, W><<<blocks, WARPS * 32, 0, stream>>>(                     \
        static_cast<const T*>(G), static_cast<const int*>(iy),                \
        static_cast<const int*>(ix), static_cast<const T*>(vy),               \
        static_cast<const T*>(vx), static_cast<const int*>(runs),             \
        static_cast<const int*>(order), static_cast<T*>(out), C, nfy, nfx, m, \
        nruns);                                                               \
    break;
    FFTVIS_INTERP_CASE(2) FFTVIS_INTERP_CASE(3) FFTVIS_INTERP_CASE(4)
    FFTVIS_INTERP_CASE(5) FFTVIS_INTERP_CASE(6) FFTVIS_INTERP_CASE(7)
    FFTVIS_INTERP_CASE(8) FFTVIS_INTERP_CASE(9) FFTVIS_INTERP_CASE(10)
    FFTVIS_INTERP_CASE(11) FFTVIS_INTERP_CASE(12) FFTVIS_INTERP_CASE(13)
    FFTVIS_INTERP_CASE(14) FFTVIS_INTERP_CASE(15) FFTVIS_INTERP_CASE(16)
#undef FFTVIS_INTERP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_adjoint(const void* g, const void* iy, const void* ix,
                          const void* vy, const void* vx, const void* runs,
                          const void* order, void* grid, int C, int nfy,
                          int nfx, int m, int nruns, int w, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int blocks = static_cast<unsigned int>((nruns + WARPS - 1) / WARPS);
  switch (w) {
#define FFTVIS_INTERP_ADJ_CASE(W)                                             \
  case W:                                                                     \
    interp_adjoint_runs<T, W><<<blocks, WARPS * 32, 0, stream>>>(             \
        static_cast<const T*>(g), static_cast<const int*>(iy),                \
        static_cast<const int*>(ix), static_cast<const T*>(vy),               \
        static_cast<const T*>(vx), static_cast<const int*>(runs),             \
        static_cast<const int*>(order), static_cast<T*>(grid), C, nfy, nfx,   \
        m, nruns);                                                            \
    break;
    FFTVIS_INTERP_ADJ_CASE(2) FFTVIS_INTERP_ADJ_CASE(3) FFTVIS_INTERP_ADJ_CASE(4)
    FFTVIS_INTERP_ADJ_CASE(5) FFTVIS_INTERP_ADJ_CASE(6) FFTVIS_INTERP_ADJ_CASE(7)
    FFTVIS_INTERP_ADJ_CASE(8) FFTVIS_INTERP_ADJ_CASE(9) FFTVIS_INTERP_ADJ_CASE(10)
    FFTVIS_INTERP_ADJ_CASE(11) FFTVIS_INTERP_ADJ_CASE(12) FFTVIS_INTERP_ADJ_CASE(13)
    FFTVIS_INTERP_ADJ_CASE(14) FFTVIS_INTERP_ADJ_CASE(15) FFTVIS_INTERP_ADJ_CASE(16)
#undef FFTVIS_INTERP_ADJ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_interp_adjoint_f32(const void* g, const void* iy,
                                         const void* ix, const void* vy,
                                         const void* vx, const void* runs,
                                         const void* order, void* grid, int C,
                                         int nfy, int nfx, int m, int nruns,
                                         int w, void* stream) {
  return launch_interp_adjoint<float>(g, iy, ix, vy, vx, runs, order, grid, C,
                                      nfy, nfx, m, nruns, w, stream);
}

extern "C" int fftvis_interp_adjoint_f64(const void* g, const void* iy,
                                         const void* ix, const void* vy,
                                         const void* vx, const void* runs,
                                         const void* order, void* grid, int C,
                                         int nfy, int nfx, int m, int nruns,
                                         int w, void* stream) {
  return launch_interp_adjoint<double>(g, iy, ix, vy, vx, runs, order, grid, C,
                                       nfy, nfx, m, nruns, w, stream);
}

extern "C" int fftvis_interp_f32(const void* G, const void* iy, const void* ix,
                                 const void* vy, const void* vx,
                                 const void* runs, const void* order,
                                 void* out, int C, int nfy, int nfx, int m,
                                 int nruns, int w, void* stream) {
  return launch_interp<float>(G, iy, ix, vy, vx, runs, order, out, C, nfy, nfx,
                              m, nruns, w, stream);
}

extern "C" int fftvis_interp_f64(const void* G, const void* iy, const void* ix,
                                 const void* vy, const void* vx,
                                 const void* runs, const void* order,
                                 void* out, int C, int nfy, int nfx, int m,
                                 int nruns, int w, void* stream) {
  return launch_interp<double>(G, iy, ix, vy, vx, runs, order, out, C, nfy,
                               nfx, m, nruns, w, stream);
}

// D = 1 (i1, i2, v1, v2 unused, n1 = n2 = 1) or D = 3 interpolation of the
// (C, n0[, n1, n2]) grid at m targets.
extern "C" int fftvis_interp_nd_f32(int d, const void* G, const void* i0,
                                    const void* i1, const void* i2,
                                    const void* v0, const void* v1,
                                    const void* v2, void* out, int C, int n0,
                                    int n1, int n2, int m, int w, void* stream) {
  return launch_interp_nd<float>(d, G, i0, i1, i2, v0, v1, v2, out, C, n0, n1,
                                 n2, m, w, stream);
}

extern "C" int fftvis_interp_nd_f64(int d, const void* G, const void* i0,
                                    const void* i1, const void* i2,
                                    const void* v0, const void* v1,
                                    const void* v2, void* out, int C, int n0,
                                    int n1, int n2, int m, int w, void* stream) {
  return launch_interp_nd<double>(d, G, i0, i1, i2, v0, v1, v2, out, C, n0, n1,
                                  n2, m, w, stream);
}
