// Channels-last beam-table interpolation at per-source (za, az) cells.
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
// The TPU kernel bin-sorts points into tiles, materializes padded tile
// windows and rebuilds the taps as one-hot matrices for its matrix unit,
// because gathers are slow there. On the card a direct gather is the
// natural form: one thread per (point, channel), channel fastest, so each
// tap of a warp reads contiguous ch-vectors of the channels-last table.
// Every thread computes its point's taps in registers; outputs are
// disjoint, so there are no atomics, no sort, no pads and no inverse
// permutation. A table narrower than 8 columns needs no special case.
//
// Cells: an exact floor of the raw coordinate, then fold (wrap) or mirror
// in integer arithmetic; the fractional part is taken from the raw
// coordinate. So a coordinate that rounded to exactly nx wraps to column 0
// with no float division (the TPU kernel's off-by-one at multiples of n).
//
// Bound on the card: npts * taps * ch gathered reals from a table that
// fits in L2 (1 MB for the slice's (91, 360, 8) float32 table, 39 MB for a
// (91, 360, 296) stacked one); at 4096 points a call is launch-bound.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long fold(long long i, long long n) {
  const long long r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ long long mirror(long long i, long long n) {
  if (n == 1) return 0;
  const long long p = 2 * n - 2;
  const long long j = (i < 0 ? -i : i) % p;
  return j >= n ? p - j : j;
}

// Order-1 taps along one axis: (cell, cell + 1) with weights (1 - t, t).
template <typename T>
__device__ __forceinline__ void taps_linear(T u, int n, bool wrap,
                                            long long* idx, T* w) {
  if (wrap) {
    const T f = floor(u);
    const T t = u - f;
    const long long c = fold(static_cast<long long>(f), n);
    idx[0] = c;
    idx[1] = c + 1 == n ? 0 : c + 1;
    w[0] = T(1) - t;
    w[1] = t;
  } else {
    const T f = fmin(fmax(floor(u), T(0)), T(n - 1));
    const T t = fmin(fmax(u - f, T(0)), T(1));
    const long long c = static_cast<long long>(f);
    idx[0] = c;
    idx[1] = c + 1 < n ? c + 1 : n - 1;
    w[0] = T(1) - t;
    w[1] = t;
  }
}

// Order-3 taps along one axis: cells floor(u) - 1 .. floor(u) + 2 with the
// cubic B-spline weights of the fractional part.
template <typename T>
__device__ __forceinline__ void taps_cubic(T u, int n, bool wrap,
                                           long long* idx, T* w) {
  const T f = floor(u);
  const T t = u - f;
  const T t2 = t * t;
  const T t3 = t2 * t;
  w[0] = (T(1) - T(3) * t + T(3) * t2 - t3) / T(6);
  w[1] = (T(4) - T(6) * t2 + T(3) * t3) / T(6);
  w[2] = (T(1) + T(3) * t + T(3) * t2 - T(3) * t3) / T(6);
  w[3] = t3 / T(6);
  const long long c = static_cast<long long>(f);
  for (int k = 0; k < 4; ++k) {
    idx[k] = wrap ? fold(c + k - 1, n) : mirror(c + k - 1, n);
  }
}

template <typename T, int ORDER>
__global__ void beam_eval_points(
    const T* __restrict__ data,  // (ny, nx, ch)
    const T* __restrict__ y,     // (npts,) fractional za cells
    const T* __restrict__ x,     // (npts,) fractional az cells
    T* __restrict__ out,         // (npts, ch)
    int npts, int ny, int nx, int ch, int wrap) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(npts) * ch) return;
  const long long p = tid / ch;
  const int c = static_cast<int>(tid % ch);
  constexpr int K = ORDER == 1 ? 2 : 4;
  long long iy[K], ix[K];
  T wy[K], wx[K];
  if constexpr (ORDER == 1) {
    taps_linear(y[p], ny, false, iy, wy);
    taps_linear(x[p], nx, wrap != 0, ix, wx);
  } else {
    taps_cubic(y[p], ny, false, iy, wy);
    taps_cubic(x[p], nx, wrap != 0, ix, wx);
  }
  T acc = T(0);
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const T* row = data + iy[a] * nx * ch + c;
    T r = T(0);
#pragma unroll
    for (int b = 0; b < K; ++b) {
      r += wx[b] * row[ix[b] * ch];
    }
    acc += wy[a] * r;
  }
  out[tid] = acc;
}

template <typename T>
int launch_beam_eval(const void* data, const void* y, const void* x, void* out,
                     int npts, int ny, int nx, int ch, int order, int wrap,
                     void* stream) {
  const int threads = 256;
  const long long total = static_cast<long long>(npts) * ch;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* d = static_cast<const T*>(data);
  const T* yy = static_cast<const T*>(y);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (order == 1) {
    beam_eval_points<T, 1><<<blocks, threads, 0, s>>>(d, yy, xx, o, npts, ny, nx, ch, wrap);
  } else if (order == 3) {
    beam_eval_points<T, 3><<<blocks, threads, 0, s>>>(d, yy, xx, o, npts, ny, nx, ch, wrap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_beam_eval_f32(const void* data, const void* y,
                                    const void* x, void* out, int npts, int ny,
                                    int nx, int ch, int order, int wrap,
                                    void* stream) {
  return launch_beam_eval<float>(data, y, x, out, npts, ny, nx, ch, order, wrap, stream);
}

extern "C" int fftvis_beam_eval_f64(const void* data, const void* y,
                                    const void* x, void* out, int npts, int ny,
                                    int nx, int ch, int order, int wrap,
                                    void* stream) {
  return launch_beam_eval<double>(data, y, x, out, npts, ny, nx, ch, order, wrap, stream);
}
