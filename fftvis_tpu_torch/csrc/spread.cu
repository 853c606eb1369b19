// 2D exponential-of-semicircle (ES) spreading onto a periodic fine grid.
//
// Replaces the Pallas band-accumulator spreader of the JAX package
// (fftvis_tpu/nufft/pallas_spread.py, _build_pallas_call): it computes
//
//     g[c, y, x] += sum_j psi(y - uy_j) psi(x - ux_j) w[c, j]
//
// with psi(t) = exp(beta (sqrt(1 - (2t/w)^2) - 1)) on |2t/w| < 1.
//
// Design (cuFINUFFT's shared-memory method, arXiv 2102.08463): sources are
// bin-sorted into TILE x TILE cell tiles by a torch pre-pass (`order`,
// CSR offsets `starts`). One block owns one tile and accumulates the
// tile's window of (TILE + w + 1)^2 cells, for `group` channels at a time,
// in shared memory with shared atomics; then it adds the window's nonzero
// cells to the global grid with atomics at (y mod nfy, x mod nfx). Blocks
// run concurrently and neighbouring windows overlap in their halos, so the
// flush is atomic. A tap outside the window (not reachable for sources
// binned by their integer cell, kept as a guard) goes straight to the
// global grid, so no contribution is ever dropped.
//
// Bound on the card: n * w^2 * 2C shared atomics plus one global atomic
// per touched window cell and plane.
//
// Tap math, as in the JAX scatter spreader (_spread_scatter):
//   cell = floor(u), frac = u - cell        (exact)
//   i0 = ceil(u - w/2)
//   t_k = (cell - (i0 + k)) + frac          (never u - idx at 10^3 cells)
//   tap index (i0 + k) mod nf
//
// Built without --use_fast_math: the ES exp and sqrt need full precision.

#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void spread_tiles(
    const T* __restrict__ uy, const T* __restrict__ ux,
    const T* __restrict__ wts,      // (C, n, 2) interleaved re/im
    const int* __restrict__ order,  // (n,) sources sorted by tile
    const int* __restrict__ starts, // (ntiles + 1,) CSR offsets into order
    T* __restrict__ grid,           // (C, nfy, nfx, 2) interleaved re/im
    int n, int C, int nfy, int nfx, int tile, int ntx, int w, T beta,
    int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);

  const int t = blockIdx.x;
  const int s0 = starts[t];
  const int s1 = starts[t + 1];
  if (s1 == s0) return;

  const int ty = t / ntx;
  const int tx = t % ntx;
  const int half = w / 2;
  const int wy0 = ty * tile - half;  // window origin (may be negative)
  const int wx0 = tx * tile - half;
  const int wside = tile + w + 1;
  const int wcells = wside * wside;
  const int ww = w * w;
  const long long items = static_cast<long long>(s1 - s0) * ww;
  const long long plane = static_cast<long long>(nfy) * nfx;

  for (int c0 = 0; c0 < C; c0 += group) {
    const int gc = min(group, C - c0);
    for (int i = threadIdx.x; i < gc * wcells * 2; i += blockDim.x) {
      win[i] = T(0);
    }
    __syncthreads();

    for (long long it = threadIdx.x; it < items; it += blockDim.x) {
      const int s = s0 + static_cast<int>(it / ww);
      const int r = static_cast<int>(it % ww);
      const int ky = r / w;
      const int kx = r % w;
      const int j = order[s];
      const T u_y = uy[j];
      const T u_x = ux[j];
      const T cy = floor(u_y);
      const T cx = floor(u_x);
      const T fy = u_y - cy;
      const T fx = u_x - cx;
      const long long iy = static_cast<long long>(ceil(u_y - T(w) / T(2))) + ky;
      const long long ix = static_cast<long long>(ceil(u_x - T(w) / T(2))) + kx;
      const T ky_val = es_kernel((cy - T(iy)) + fy, w, beta);
      const T kx_val = es_kernel((cx - T(ix)) + fx, w, beta);
      const T kv = ky_val * kx_val;
      if (kv == T(0)) continue;
      const long long ly = iy - wy0;
      const long long lx = ix - wx0;
      const bool inside = ly >= 0 && ly < wside && lx >= 0 && lx < wside;
      for (int c = 0; c < gc; ++c) {
        const T* wc = wts + (static_cast<long long>(c0 + c) * n + j) * 2;
        const T vre = wc[0] * kv;
        const T vim = wc[1] * kv;
        if (inside) {
          T* cellp = win + (static_cast<long long>(c) * wcells + ly * wside + lx) * 2;
          atomicAdd(cellp, vre);
          atomicAdd(cellp + 1, vim);
        } else {
          T* g = grid + ((c0 + c) * plane +
                         static_cast<long long>(wrap(iy, nfy)) * nfx +
                         wrap(ix, nfx)) * 2;
          atomicAdd(g, vre);
          atomicAdd(g + 1, vim);
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < gc * wcells; i += blockDim.x) {
      const int c = i / wcells;
      const int cell = i % wcells;
      const T vre = win[2 * i];
      const T vim = win[2 * i + 1];
      if (vre == T(0) && vim == T(0)) continue;
      const int gy = wrap(wy0 + cell / wside, nfy);
      const int gx = wrap(wx0 + cell % wside, nfx);
      T* g = grid + ((c0 + c) * plane + static_cast<long long>(gy) * nfx + gx) * 2;
      if (vre != T(0)) atomicAdd(g, vre);
      if (vim != T(0)) atomicAdd(g + 1, vim);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_spread(const void* uy, const void* ux, const void* wts,
                  const void* order, const void* starts, void* grid, int n,
                  int C, int nfy, int nfx, int tile, int nty, int ntx, int w,
                  double beta, int group, void* stream) {
  const int wside = tile + w + 1;
  const size_t smem = static_cast<size_t>(group) * wside * wside * 2 * sizeof(T);
  const int threads = 256;
  const int blocks = nty * ntx;
  spread_tiles<T><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(uy), static_cast<const T*>(ux),
      static_cast<const T*>(wts), static_cast<const int*>(order),
      static_cast<const int*>(starts), static_cast<T*>(grid), n, C, nfy, nfx,
      tile, ntx, w, static_cast<T>(beta), group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_spread_f32(const void* uy, const void* ux,
                                 const void* wts, const void* order,
                                 const void* starts, void* grid, int n, int C,
                                 int nfy, int nfx, int tile, int nty, int ntx,
                                 int w, double beta, int group, void* stream) {
  return launch_spread<float>(uy, ux, wts, order, starts, grid, n, C, nfy, nfx,
                              tile, nty, ntx, w, beta, group, stream);
}

extern "C" int fftvis_spread_f64(const void* uy, const void* ux,
                                 const void* wts, const void* order,
                                 const void* starts, void* grid, int n, int C,
                                 int nfy, int nfx, int tile, int nty, int ntx,
                                 int w, double beta, int group, void* stream) {
  return launch_spread<double>(uy, ux, wts, order, starts, grid, n, C, nfy, nfx,
                               tile, nty, ntx, w, beta, group, stream);
}
