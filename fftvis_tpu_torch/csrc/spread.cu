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
// disjoint: no atomics, and the result does not depend on the run. Bound:
// the touched cells of the C planes read once, the coordinates, and the
// (C, n) output written once.
//
// spread_gm_1d and spread_gm_3d are the same GM method on a 1D (C, n0) and
// a 3D (C, n0, n1, n2) periodic grid, for the public type-1 and type-3
// transforms at d = 1 and d = 3 (the JAX package spreads those with XLA:
// _spread_scatter, and on the TPU _spread_3d_ztaps, a scan of 2D spreads
// over the planes of the last axis). One warp a source, its ES values
// evaluated once, every tap added with an atomic, zero-weight sources
// skipped, w a template parameter (2..16):
// - D = 1: lane k < w holds psi(k) and adds tap k of every channel;
// - D = 3: the lanes cover the (axis-1, axis-2) taps exactly as spread_gm
//   covers (y, x) -- a group of lanes a contiguous tap row of the last
//   axis, so a warp's atomics hit whole rows -- and a loop over the w
//   axis-0 taps moves from one (n1, n2) slab to the next. The loop runs over
//   the first axis, not the last, so that the lanes stay on contiguous
//   cells.
// Bound, in bytes: as spread_gm, the touched cells read and written once,
// plus coordinates and weights.

#include <cuda_runtime.h>

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

template <typename T, int W>
__global__ void spread_gm_1d(
    const T* __restrict__ u0,
    const T* __restrict__ wts,      // (C, n, 2) interleaved re/im
    T* __restrict__ grid,           // (C, n0, 2) interleaved re/im
    int n, int C, int n0, T beta) {
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (j >= n) return;  // whole warps only: blockDim.x is a multiple of 32
  const int lane = threadIdx.x & 31;
  if (!any_weight(wts, j, n, C, lane) || lane >= W) return;

  const T u = u0[j];
  const T cell = floor(u);
  const T frac = u - cell;
  const long long i0 = static_cast<long long>(ceil(u - T(W) / T(2)));
  const T psi = es_kernel((cell - T(i0 + lane)) + frac, W, beta);
  if (psi == T(0)) return;
  const long long off = static_cast<long long>(wrap(i0 + lane, n0)) * 2;
  for (int c = 0; c < C; ++c) {
    const T* wc = wts + (static_cast<long long>(c) * n + j) * 2;
    if (wc[0] == T(0) && wc[1] == T(0)) continue;
    add_complex(grid + static_cast<long long>(c) * n0 * 2 + off, psi * wc[0], psi * wc[1]);
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

template <typename T, int W>
void launch_nd_w(int d, const void* u0, const void* u1, const void* u2,
                 const void* wts, void* grid, int n, int C, int n0, int n1,
                 int n2, double beta, cudaStream_t stream) {
  const int threads = 256;  // 8 sources a block
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(n) * 32 + threads - 1) / threads);
  if (d == 1) {
    spread_gm_1d<T, W><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(u0), static_cast<const T*>(wts), static_cast<T*>(grid),
        n, C, n0, static_cast<T>(beta));
    return;
  }
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
