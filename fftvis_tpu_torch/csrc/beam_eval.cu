// Channels-last beam-table interpolation at per-source (za, az) cells, and
// the fused source-block kernel built on it.
//
// Replaces the Pallas beam evaluator of the JAX package
// (fftvis_tpu/beams/pallas_eval.py, _build_eval_call, driven by
// pallas_map_coordinates_cl), which computes map_coordinates_2d_cl
// (fftvis_tpu/beams/interp.py):
//
//     out[p, c] = sum_a sum_b wy[p, a] wx[p, b] data[iy[p, a], ix[p, b], c]
//
// - order 1: bilinear; y clamped to [0, ny-1] (y >= ny-1 reads row ny-1,
//   as the TPU kernel and scipy do); x clamped, or periodic with wrap;
// - order 3: cubic B-spline on a prefiltered table; y mirrored (scipy
//   'mirror', period 2n-2); x mirrored, or periodic with wrap.
//
// Two entries share the tap and cell code below:
//
// - beam_eval_points, the interpolation alone: one unit of work per
//   (point, chunk of 8 channels), chunk fastest, each tap's chunk read
//   with 16-byte vector loads (one 32-byte sector at float32) when the
//   channels come in whole chunks. A group of 4 threads takes a unit and
//   splits its taps; lane 0 writes the chunk.
// - beam_rows_points, what the JAX engine's source_block_weights
//   (fftvis_tpu/tpu/program.py) computes for one shared tabulated beam and
//   one source block: the cells from (az, za), the interpolation, the
//   apparent-coherency rows (power, Jones x Stokes I, Jones x IQUV) and
//   the horizon mask, in one launch. A group of 4 threads takes a point:
//   each gathers a quarter of its taps, shuffles add the partial channel
//   vectors so that every lane holds the whole vector in registers (8
//   values for a complex Jones table), and lane c writes row c. No
//   intermediate touches device memory; a masked point skips its gathers
//   and writes zeros.
//
// Why groups: a 4096-point block is 4096 threads at one a point, under
// one warp a SM, and each thread's 16 cubic taps are a chain of L2 loads;
// four lanes a point cut the chain to 4 taps and put four times the
// threads on the card. For the interpolation alone at the slice's (91,
// 360, 8) table, order 3, 4096 points, one thread a point took 3.86 us at
// float32 and 6.03 us at float64, four 2.61 and 3.07 us (tools/
// kernel_ab.py --beams, NVIDIA H100 80GB HBM3, 700 W).
//
// The TPU kernel bin-sorts points into tiles and rebuilds the taps as
// one-hot matrices for its matrix unit, because gathers are slow there. On
// the card a direct gather is the natural form: the table (1 MB at the
// slice's (91, 360, 8) float32) stays in L2, outputs are disjoint, so
// there are no atomics, no sort and no pads.
//
// Cells: an exact floor of the raw coordinate, then fold (wrap) or mirror
// in 32-bit integer arithmetic, with a shortcut for cells already in
// range; the fractional part is taken from the raw coordinate. So a
// coordinate that rounded to exactly nx wraps to column 0 with no float
// division (the TPU kernel's off-by-one at multiples of n). Coordinates
// beyond +-2^30 cells are clamped there first, so every index stays in
// bounds.
//
// Bound on the card: the table cells the points' taps touch, read once,
// plus the points and the output; well under a microsecond for a
// 4096-point block, so one launch's latency sets the floor and the fusion
// (one launch instead of the ~17 of the unfused source block) is the gain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CHUNK = 8;  // channels a unit of beam_eval_points takes
// Threads that share a unit of beam_eval_points or a point of
// beam_rows_points, and split its taps.
constexpr int LANES = 4;
// Threads a block, whole warps so that a group of lanes never spans two:
// 128 was the fastest of 64, 128 and 256, or within 5% of it, for both
// kernels at the slice's shapes.
constexpr int THREADS = 128;
static_assert(THREADS % 32 == 0, "blocks are whole warps");

// 16-byte vectors: 4 floats or 2 doubles.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ void unpack(float4 q, float* v) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void unpack(double2 q, double* v) {
  v[0] = q.x; v[1] = q.y;
}

template <typename T>
__device__ __forceinline__ int to_cell(T f) {
  return static_cast<int>(fmin(fmax(f, T(-1073741824)), T(1073741824)));
}

__device__ __forceinline__ int fold(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ int mirror(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const unsigned p = 2u * n - 2u;
  const unsigned j = (i < 0 ? 0u - static_cast<unsigned>(i) : static_cast<unsigned>(i)) % p;
  return static_cast<int>(j >= static_cast<unsigned>(n) ? p - j : j);
}

// Order-1 taps along one axis: (cell, cell + 1) with weights (1 - t, t).
template <typename T>
__device__ __forceinline__ void taps_linear(T u, int n, bool wrap, int* idx, T* w) {
  if (wrap) {
    const T f = floor(u);
    const T t = u - f;
    const int c = fold(to_cell(f), n);
    idx[0] = c;
    idx[1] = c + 1 == n ? 0 : c + 1;
    w[0] = T(1) - t;
    w[1] = t;
  } else {
    const T f = fmin(fmax(floor(u), T(0)), T(n - 1));
    const T t = fmin(fmax(u - f, T(0)), T(1));
    const int c = static_cast<int>(f);
    idx[0] = c;
    idx[1] = c + 1 < n ? c + 1 : n - 1;
    w[0] = T(1) - t;
    w[1] = t;
  }
}

// Order-3 taps along one axis: cells floor(u) - 1 .. floor(u) + 2 with the
// cubic B-spline weights of the fractional part.
template <typename T>
__device__ __forceinline__ void taps_cubic(T u, int n, bool wrap, int* idx, T* w) {
  const T f = floor(u);
  const T t = u - f;
  const T t2 = t * t;
  const T t3 = t2 * t;
  w[0] = (T(1) - T(3) * t + T(3) * t2 - t3) / T(6);
  w[1] = (T(4) - T(6) * t2 + T(3) * t3) / T(6);
  w[2] = (T(1) + T(3) * t + T(3) * t2 - T(3) * t3) / T(6);
  w[3] = t3 / T(6);
  const int c = to_cell(f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    idx[k] = wrap ? fold(c + k - 1, n) : mirror(c + k - 1, n);
  }
}

template <typename T, int ORDER>
__device__ __forceinline__ void taps(T y, T x, int ny, int nx, bool wrap,
                                     int* iy, int* ix, T* wy, T* wx) {
  if constexpr (ORDER == 1) {
    taps_linear(y, ny, false, iy, wy);
    taps_linear(x, nx, wrap, ix, wx);
  } else {
    taps_cubic(y, ny, false, iy, wy);
    taps_cubic(x, nx, wrap, ix, wx);
  }
}

// v[i] for a runtime i < K, by selects in registers (no local memory).
template <typename T, int K>
__device__ __forceinline__ T pick(const T* v, int i) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) r = i == k ? v[k] : r;
  return r;
}

// The lanes of this thread's group of LANES (blocks are whole warps, so a
// group never spans two).
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << LANES) - 1u) << (threadIdx.x % 32 / LANES * LANES);
}

// acc[k] = sum_a sum_b wy[a] wx[b] data[iy[a], ix[b], c0 + k], k < N, by a
// group of LANES neighbouring threads: each takes the taps t = s * LANES +
// lane (a = t / K, b = t % K), and the partial sums are added across the
// group, so every lane ends with the whole vector.
// VEC: the N channels of a tap are read as 16-byte vectors (c0 + N within
// the row, the tap's address 16-byte aligned). Otherwise scalar reads of
// the first nch channels only.
template <typename T, int K, int N, bool VEC>
__device__ __forceinline__ void gather(const T* __restrict__ data, int nx, int ch,
                                       int c0, int nch, const int* iy, const int* ix,
                                       const T* wy, const T* wx, int lane, T* acc) {
  static_assert((K * K) % LANES == 0, "the taps split evenly over the lanes");
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = T(0);
#pragma unroll
  for (int s = 0; s < K * K / LANES; ++s) {
    const int t = s * LANES + lane;
    const int a = t / K, b = t % K;
    const T w = pick<T, K>(wy, a) * pick<T, K>(wx, b);
    const T* p = data + (static_cast<long long>(pick<int, K>(iy, a)) * nx +
                         pick<int, K>(ix, b)) * ch + c0;
    if constexpr (VEC) {
      using V = typename Vec16<T>::type;
      constexpr int L = Vec16<T>::n;
      static_assert(N % L == 0, "VEC gathers whole 16-byte vectors");
#pragma unroll
      for (int v = 0; v < N / L; ++v) {
        T q[L];
        unpack(__ldg(reinterpret_cast<const V*>(p) + v), q);
#pragma unroll
        for (int l = 0; l < L; ++l) acc[v * L + l] += w * q[l];
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (k < nch) acc[k] += w * __ldg(p + k);
      }
    }
  }
  const unsigned gmask = group_mask();
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += __shfl_xor_sync(gmask, acc[k], off, LANES);
  }
}

// ------------------------------------------------ interpolation alone

template <typename T, int ORDER, bool VEC>
__global__ void beam_eval_points(
    const T* __restrict__ data,  // (ny, nx, ch)
    const T* __restrict__ y,     // (npts,) fractional za cells
    const T* __restrict__ x,     // (npts,) fractional az cells
    T* __restrict__ out,         // (npts, ch)
    int npts, int ny, int nx, int ch, int wrap) {
  // The launcher keeps npts * nchunk * LANES below 2^31.
  const unsigned nchunk = (ch + CHUNK - 1) / CHUNK;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned unit = tid / LANES;  // (point, chunk), chunk fastest
  if (unit >= static_cast<unsigned>(npts) * nchunk) return;
  const int lane = tid % LANES;
  const int p = static_cast<int>(unit / nchunk);
  const int c0 = static_cast<int>(unit % nchunk) * CHUNK;
  const int nch = min(CHUNK, ch - c0);
  constexpr int K = ORDER == 1 ? 2 : 4;
  int iy[K], ix[K];
  T wy[K], wx[K];
  taps<T, ORDER>(y[p], x[p], ny, nx, wrap != 0, iy, ix, wy, wx);
  T acc[CHUNK];
  gather<T, K, CHUNK, VEC>(data, nx, ch, c0, nch, iy, ix, wy, wx, lane, acc);
  if (lane != 0) return;
  T* o = out + static_cast<long long>(p) * ch + c0;
  if constexpr (VEC) {
    using V = typename Vec16<T>::type;
    constexpr int L = Vec16<T>::n;
#pragma unroll
    for (int v = 0; v < CHUNK / L; ++v) {
      V q;
      if constexpr (L == 4) {
        q = V{acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]};
      } else {
        q = V{acc[2 * v], acc[2 * v + 1]};
      }
      reinterpret_cast<V*>(o)[v] = q;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (k < nch) o[k] = acc[k];
    }
  }
}

// ------------------------------------------- fused source-block rows

enum Epilogue { POWER = 0, JONES_I = 1, JONES_IQUV = 2 };

// e[v][f] of the Jones table's channel vector, chflat = (2 re/im, 2 vec,
// 2 feed) for a complex table (N = 8), (2 vec, 2 feed) for a real one.
template <typename T, int N>
__device__ __forceinline__ void jones(const T* acc, int v, int f, T& re, T& im) {
  re = acc[v * 2 + f];
  im = N == 8 ? acc[4 + v * 2 + f] : T(0);
}

template <typename T, int ORDER, int EPI, int N>
__global__ void beam_rows_points(
    const T* __restrict__ data,  // (ny, nx, ch) table of one frequency
    const T* __restrict__ az,    // (n,)
    const T* __restrict__ za,    // (n,)
    const T* __restrict__ sky,   // real (n,) Stokes I, or complex (n, 2, 2) as reals
    const T* __restrict__ mask,  // (n,)
    T* __restrict__ out,         // complex (C, n) as reals
    int n, int ny, int nx, int ch, int c0, int wrap,
    long long sky_sp, long long sky_sa, long long sky_sb,  // strides in reals
    double za0, double dza, double az0, double daz) {
  using V2 = typename Vec2<T>::type;
  constexpr int C = EPI == POWER ? 1 : 4;
  // The launcher keeps n * LANES below 2^31. Lane c of a point's group
  // writes its row c.
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = static_cast<int>(tid / LANES);
  const int lane = tid % LANES;
  if (p >= n) return;
  V2* o = reinterpret_cast<V2*>(out) + p;
  const T m = mask[p];
  if (m == T(0)) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c % LANES == lane) o[static_cast<long long>(c) * n] = V2{T(0), T(0)};
    }
    return;
  }
  // The cells as the plain torch version forms them on the card: each
  // Python float taken into T, then (za - za0) * (1 / dza) (torch divides
  // a tensor by a scalar through the reciprocal) and, with wrap, fmod by
  // 2 pi, + 2 pi where negative, then * (1 / daz).
  const T yv = (za[p] - T(za0)) * (T(1) / T(dza));
  T xv = az[p] - T(az0);
  if (wrap) {
    const T two_pi = T(6.283185307179586);
    xv = fmod(xv, two_pi);
    xv = xv < T(0) ? xv + two_pi : xv;
  }
  xv = xv * (T(1) / T(daz));
  constexpr int K = ORDER == 1 ? 2 : 4;
  int iy[K], ix[K];
  T wy[K], wx[K];
  taps<T, ORDER>(yv, xv, ny, nx, wrap != 0, iy, ix, wy, wx);
  T acc[N];
  gather<T, K, N, (N > 1)>(data, nx, ch, c0, N, iy, ix, wy, wx, lane, acc);

  const T* s = sky + sky_sp * p;
  if constexpr (EPI == POWER) {
    // Cubic overshoot near nulls can go negative: clamp at the floor.
    const T amp = sqrt(fmax(acc[0] * acc[0], T(0))) * s[0];
    if (lane == 0) o[0] = V2{amp * m, T(0)};
  } else if constexpr (EPI == JONES_I) {
    // (conj(e[0, f]) e[0, g] + conj(e[1, f]) e[1, g]) * flux.
    const T flux = s[0];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c % LANES != lane) continue;
      const int f = c / 2, g = c % 2;
      T re = T(0), im = T(0);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        T ar, ai, br, bi;
        jones<T, N>(acc, v, f, ar, ai);
        jones<T, N>(acc, v, g, br, bi);
        re += ar * br + ai * bi;
        im += ar * bi - ai * br;
      }
      o[static_cast<long long>(c) * n] = V2{re * flux * m, im * flux * m};
    }
  } else {
    // A^H C A with the vector axis flipped: sum over (a, b) of
    // conj(e[1-a, f]) coh[a, b] e[1-b, g].
    T cr[2][2], ci[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const T* q = s + a * sky_sa + b * sky_sb;
        cr[a][b] = q[0];
        ci[a][b] = q[1];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c % LANES != lane) continue;
      const int f = c / 2, g = c % 2;
      T re = T(0), im = T(0);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        T ar, ai;
        jones<T, N>(acc, 1 - a, f, ar, ai);
        ai = -ai;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          T br, bi;
          jones<T, N>(acc, 1 - b, g, br, bi);
          const T tr = ar * cr[a][b] - ai * ci[a][b];
          const T ti = ar * ci[a][b] + ai * cr[a][b];
          re += tr * br - ti * bi;
          im += tr * bi + ti * br;
        }
      }
      o[static_cast<long long>(c) * n] = V2{re * m, im * m};
    }
  }
}

// ------------------------------------------------ per-antenna pair rows
//
// pair_rows_points: every beam pair's masked apparent-coherency rows of one
// source block from the K beams' evaluations, what the JAX engine forms
// with apparent_coherency_rows_batched and the mask (fftvis_tpu/tpu/
// program.py, source_block_weights; XLA there, no Pallas kernel). The
// evaluations are (n, K * chf) reals, beam k's channels from k * chf: for
// a Jones beam (2 re/im, 2 vec, 2 feed) or (2 vec, 2 feed), for a power
// beam its feed at offset c0. The output is (P * C, n) complex, C = 1
// (power) or 4 rows a pair ordered (00, 01, 10, 11), pair-major.
//
// A block takes a tile of TP points and stages their K * chf evaluations
// in shared memory once, channel-major with a pad column, so that
// neighbouring points sit in neighbouring banks; its TP x PY threads then
// loop over its share of the pairs, thread x taking point x, and each row
// is written with consecutive points at consecutive addresses. Reading the
// (n, K * chf) layout straight from global memory would stride by K * chf
// between neighbouring threads; that form (SMEM false) serves only a stack
// too wide for shared memory. The output, (P * C, n) complex, is the
// largest tensor of a source block and sets the bound.
constexpr int TP = 32;             // points a tile: a warp's row write
constexpr int PY = 8;              // pair lanes a block
constexpr int SMEM_MAX = 200 * 1024;  // dynamic shared memory a block at most

template <typename T, int EPI, bool CPLX, bool SMEM>
__global__ void __launch_bounds__(TP * PY) pair_rows_points(
    const T* __restrict__ ev,    // (n, kc) evaluations
    const int* __restrict__ pi,  // (P,) first beam of each pair
    const int* __restrict__ pj,  // (P,) second beam
    const T* __restrict__ sky,   // real (n,) Stokes I, or complex (n, 2, 2) as reals
    const T* __restrict__ mask,  // (n,)
    T* __restrict__ out,         // complex (P * C, n) as reals
    int n, int K, int chf, int c0, int P, int ppb,
    long long sky_sp, long long sky_sa, long long sky_sb) {
  using V2 = typename Vec2<T>::type;
  constexpr int C = EPI == POWER ? 1 : 4;
  extern __shared__ unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  const long long kc = static_cast<long long>(K) * chf;
  const int b0 = blockIdx.x * TP;
  const int npt = min(TP, n - b0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  if constexpr (SMEM) {
    const T* src = ev + static_cast<long long>(b0) * kc;
    const int total = npt * static_cast<int>(kc);
    for (int i = ty * TP + tx; i < total; i += TP * PY) {
      const int pt = i / static_cast<int>(kc);
      const int c = i - pt * static_cast<int>(kc);
      sh[c * (TP + 1) + pt] = src[i];
    }
    __syncthreads();
  }
  if (tx >= npt) return;
  const int b = b0 + tx;
  auto at = [&](long long c) -> T {
    if constexpr (SMEM) {
      return sh[c * (TP + 1) + tx];
    } else {
      return __ldg(ev + static_cast<long long>(b) * kc + c);
    }
  };
  const T m = mask[b];
  const T* s = sky + sky_sp * b;
  T flux = T(0), cr[2][2], ci[2][2];
  if constexpr (EPI == JONES_IQUV) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const T* q = s + a * sky_sa + bb * sky_sb;
        cr[a][bb] = q[0];
        ci[a][bb] = q[1];
      }
    }
  } else {
    flux = s[0];
  }
  V2* o = reinterpret_cast<V2*>(out) + b;
  const int p1 = min(P, (blockIdx.y + 1) * ppb);
  for (int p = blockIdx.y * ppb + ty; p < p1; p += PY) {
    V2* op = o + static_cast<long long>(p) * C * n;
    if (m == T(0)) {
#pragma unroll
      for (int c = 0; c < C; ++c) op[static_cast<long long>(c) * n] = V2{T(0), T(0)};
      continue;
    }
    // A malformed index reads a wrong beam, never out of bounds.
    const long long ei = static_cast<long long>(min(max(pi[p], 0), K - 1)) * chf;
    const long long ej = static_cast<long long>(min(max(pj[p], 0), K - 1)) * chf;
    if constexpr (EPI == POWER) {
      // Cubic overshoot near nulls can go negative: clamp at the floor.
      const T amp = sqrt(fmax(at(ei + c0) * at(ej + c0), T(0))) * flux;
      op[0] = V2{amp * m, T(0)};
    } else {
      // e[v][f] of beam i and beam j.
      T ar[2][2], ai[2][2], br[2][2], bi[2][2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          ar[v][f] = at(ei + v * 2 + f);
          br[v][f] = at(ej + v * 2 + f);
          ai[v][f] = CPLX ? at(ei + 4 + v * 2 + f) : T(0);
          bi[v][f] = CPLX ? at(ej + 4 + v * 2 + f) : T(0);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = c / 2, g = c % 2;
        T re = T(0), im = T(0);
        if constexpr (EPI == JONES_I) {
          // (conj(ei[0, f]) ej[0, g] + conj(ei[1, f]) ej[1, g]) * flux.
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            re += ar[v][f] * br[v][g] + ai[v][f] * bi[v][g];
            im += ar[v][f] * bi[v][g] - ai[v][f] * br[v][g];
          }
          re *= flux;
          im *= flux;
        } else {
          // A_i^H C A_j with the vector axis flipped: sum over (a, b) of
          // conj(ei[1-a, f]) coh[a, b] ej[1-b, g].
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const T xr = ar[1 - a][f], xi = -ai[1 - a][f];
#pragma unroll
            for (int bb = 0; bb < 2; ++bb) {
              const T tr = xr * cr[a][bb] - xi * ci[a][bb];
              const T ti = xr * ci[a][bb] + xi * cr[a][bb];
              re += tr * br[1 - bb][g] - ti * bi[1 - bb][g];
              im += tr * bi[1 - bb][g] + ti * br[1 - bb][g];
            }
          }
        }
        op[static_cast<long long>(c) * n] = V2{re * m, im * m};
      }
    }
  }
}

unsigned int blocks_for(long long work, int threads) {
  return static_cast<unsigned int>((work + threads - 1) / threads);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// A grid of at most 2^31 - 1 threads, so the kernels index in 32 bits.
bool too_many(long long threads_total) { return threads_total >= (1ll << 31); }

template <typename T>
int launch_beam_eval(const void* data, const void* y, const void* x, void* out,
                     int npts, int ny, int nx, int ch, int order, int wrap,
                     void* stream) {
  const long long work = static_cast<long long>(npts) * ((ch + CHUNK - 1) / CHUNK) * LANES;
  if (too_many(work) || (order != 1 && order != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (work == 0) return 0;
  const unsigned int blocks = blocks_for(work, THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const T* yy = static_cast<const T*>(y);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const bool vec = ch % CHUNK == 0 && aligned16(data) && aligned16(out);
#define FFTVIS_EVAL(ORD, V) \
  beam_eval_points<T, ORD, V><<<blocks, THREADS, 0, s>>>(d, yy, xx, o, npts, ny, nx, ch, wrap)
  if (order == 1) {
    if (vec) { FFTVIS_EVAL(1, true); } else { FFTVIS_EVAL(1, false); }
  } else {
    if (vec) { FFTVIS_EVAL(3, true); } else { FFTVIS_EVAL(3, false); }
  }
#undef FFTVIS_EVAL
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_beam_rows(const void* data, const void* az, const void* za,
                     const void* sky, const void* mask, void* out, int n, int ny,
                     int nx, int ch, int c0, int order, int wrap, int epi, int nch,
                     long long sky_sp, long long sky_sa, long long sky_sb,
                     double za0, double dza, double az0, double daz,
                     void* stream) {
  const long long work = static_cast<long long>(n) * LANES;
  if (too_many(work) || (order != 1 && order != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The vector gathers read whole channel vectors from 16-byte boundaries.
  if (nch > 1 && (c0 != 0 || ch != nch || !aligned16(data))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n == 0) return 0;
  const unsigned int blocks = blocks_for(work, THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const T* a = static_cast<const T*>(az);
  const T* z = static_cast<const T*>(za);
  const T* k = static_cast<const T*>(sky);
  const T* m = static_cast<const T*>(mask);
  T* o = static_cast<T*>(out);
#define FFTVIS_ROWS(ORD, EPI, N)                                                     \
  beam_rows_points<T, ORD, EPI, N><<<blocks, THREADS, 0, s>>>(                       \
      d, a, z, k, m, o, n, ny, nx, ch, c0, wrap, sky_sp, sky_sa, sky_sb, za0, dza, \
      az0, daz)
#define FFTVIS_ROWS_ORDER(EPI, N)          \
  if (order == 1) FFTVIS_ROWS(1, EPI, N); \
  else FFTVIS_ROWS(3, EPI, N)
  if (epi == POWER && nch == 1) {
    FFTVIS_ROWS_ORDER(POWER, 1);
  } else if (epi == JONES_I && nch == 8) {
    FFTVIS_ROWS_ORDER(JONES_I, 8);
  } else if (epi == JONES_I && nch == 4) {
    FFTVIS_ROWS_ORDER(JONES_I, 4);
  } else if (epi == JONES_IQUV && nch == 8) {
    FFTVIS_ROWS_ORDER(JONES_IQUV, 8);
  } else if (epi == JONES_IQUV && nch == 4) {
    FFTVIS_ROWS_ORDER(JONES_IQUV, 4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FFTVIS_ROWS_ORDER
#undef FFTVIS_ROWS
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count <= 0) {
      count = 132;
    }
  }
  return count;
}

template <typename T, int EPI, bool CPLX, bool SMEM>
void pair_rows_instance(dim3 grid, size_t smem, cudaStream_t s, const T* ev,
                        const int* pi, const int* pj, const T* sky, const T* mask,
                        T* out, int n, int K, int chf, int c0, int P, int ppb,
                        long long sp, long long sa, long long sb) {
  if constexpr (SMEM) {
    // Above 48 KB a kernel must opt in to its dynamic shared memory.
    static bool opted_in = false;
    if (!opted_in) {
      cudaFuncSetAttribute(pair_rows_points<T, EPI, CPLX, SMEM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      opted_in = true;
    }
  }
  pair_rows_points<T, EPI, CPLX, SMEM><<<grid, dim3(TP, PY), smem, s>>>(
      ev, pi, pj, sky, mask, out, n, K, chf, c0, P, ppb, sp, sa, sb);
}

template <typename T>
int launch_pair_rows(const void* ev, const void* pi, const void* pj, const void* sky,
                     const void* mask, void* out, int n, int K, int chf, int c0,
                     int P, int epi, int cplx, long long sp, long long sa,
                     long long sb, void* stream) {
  const bool power = epi == POWER;
  if (K < 1 || chf < 1 || P < 0 || n < 0 || (epi != POWER && epi != JONES_I &&
                                               epi != JONES_IQUV) ||
      (power && (c0 < 0 || c0 >= chf)) || (!power && chf != (cplx ? 8 : 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || P == 0) return 0;
  const int tiles = (n + TP - 1) / TP;
  // Enough blocks for two a SM: split the pairs of a tile over blocks.
  int groups = (2 * sm_count() + tiles - 1) / tiles;
  groups = max(1, min(groups, min((P + PY - 1) / PY, 65535)));
  const int ppb = (P + groups - 1) / groups;
  groups = (P + ppb - 1) / ppb;
  const dim3 grid(tiles, groups);
  const long long bytes = static_cast<long long>(K) * chf * (TP + 1) * sizeof(T);
  const bool smem = bytes <= SMEM_MAX;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* e = static_cast<const T*>(ev);
  const int* ii = static_cast<const int*>(pi);
  const int* jj = static_cast<const int*>(pj);
  const T* k = static_cast<const T*>(sky);
  const T* m = static_cast<const T*>(mask);
  T* o = static_cast<T*>(out);
#define FFTVIS_PAIRS(EPI, CPLX)                                                      \
  if (smem) {                                                                        \
    pair_rows_instance<T, EPI, CPLX, true>(grid, bytes, s, e, ii, jj, k, m, o, n, K, \
                                           chf, c0, P, ppb, sp, sa, sb);             \
  } else {                                                                           \
    pair_rows_instance<T, EPI, CPLX, false>(grid, 0, s, e, ii, jj, k, m, o, n, K,    \
                                            chf, c0, P, ppb, sp, sa, sb);            \
  }
  if (power) {
    FFTVIS_PAIRS(POWER, false);
  } else if (epi == JONES_I) {
    if (cplx) { FFTVIS_PAIRS(JONES_I, true); } else { FFTVIS_PAIRS(JONES_I, false); }
  } else {
    if (cplx) { FFTVIS_PAIRS(JONES_IQUV, true); } else { FFTVIS_PAIRS(JONES_IQUV, false); }
  }
#undef FFTVIS_PAIRS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_pair_rows_f32(const void* ev, const void* pi, const void* pj,
                                    const void* sky, const void* mask, void* out, int n,
                                    int K, int chf, int c0, int P, int epi, int cplx,
                                    long long sp, long long sa, long long sb,
                                    void* stream) {
  return launch_pair_rows<float>(ev, pi, pj, sky, mask, out, n, K, chf, c0, P, epi,
                                 cplx, sp, sa, sb, stream);
}

extern "C" int fftvis_pair_rows_f64(const void* ev, const void* pi, const void* pj,
                                    const void* sky, const void* mask, void* out, int n,
                                    int K, int chf, int c0, int P, int epi, int cplx,
                                    long long sp, long long sa, long long sb,
                                    void* stream) {
  return launch_pair_rows<double>(ev, pi, pj, sky, mask, out, n, K, chf, c0, P, epi,
                                  cplx, sp, sa, sb, stream);
}

extern "C" int fftvis_beam_eval_f32(const void* data, const void* y,
                                    const void* x, void* out, int npts, int ny,
                                    int nx, int ch, int order, int wrap,
                                    void* stream) {
  return launch_beam_eval<float>(data, y, x, out, npts, ny, nx, ch, order, wrap,
                                 stream);
}

extern "C" int fftvis_beam_eval_f64(const void* data, const void* y,
                                    const void* x, void* out, int npts, int ny,
                                    int nx, int ch, int order, int wrap,
                                    void* stream) {
  return launch_beam_eval<double>(data, y, x, out, npts, ny, nx, ch, order, wrap,
                                  stream);
}

extern "C" int fftvis_beam_rows_f32(
    const void* data, const void* az, const void* za, const void* sky,
    const void* mask, void* out, int n, int ny, int nx, int ch, int c0, int order,
    int wrap, int epi, int nch, long long sky_sp, long long sky_sa,
    long long sky_sb, double za0, double dza, double az0, double daz,
    void* stream) {
  return launch_beam_rows<float>(data, az, za, sky, mask, out, n, ny, nx, ch, c0,
                                 order, wrap, epi, nch, sky_sp, sky_sa, sky_sb, za0,
                                 dza, az0, daz, stream);
}

extern "C" int fftvis_beam_rows_f64(
    const void* data, const void* az, const void* za, const void* sky,
    const void* mask, void* out, int n, int ny, int nx, int ch, int c0, int order,
    int wrap, int epi, int nch, long long sky_sp, long long sky_sa,
    long long sky_sb, double za0, double dza, double az0, double daz,
    void* stream) {
  return launch_beam_rows<double>(data, az, za, sky, mask, out, n, ny, nx, ch, c0,
                                  order, wrap, epi, nch, sky_sp, sky_sa, sky_sb, za0,
                                  dza, az0, daz, stream);
}
