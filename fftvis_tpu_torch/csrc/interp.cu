// Type-2 tap interpolation from the fine grid to nonuniform targets.
//
// Replaces the Pallas interpolation of the JAX package
// (fftvis_tpu/nufft/pallas_interp.py, _build_interp_call):
//
//     out[c, t] = sum_a vy[t, a] * sum_b G[c, iy[t, a], ix[t, b]] * vx[t, b]
//
// with the plan's host-computed taps (indices already mod nf). The TPU
// kernel bin-sorts targets and rebuilds the taps as one-hot matrices for
// its matrix unit; here a gather is the natural form. One thread owns one
// (target, channel) output, so outputs are disjoint: no atomics, no sort,
// no inverse permutation, no wrap-pad. Output is written in target order.
//
// Bound on the card: m * w^2 * 2C gathered reals (8 or 16 bytes per tap
// for complex64 / complex128) from a grid larger than L2.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void interp_taps(
    const T* __restrict__ G,        // (C, nfy, nfx, 2) interleaved re/im
    const int* __restrict__ iy,     // (m, w)
    const int* __restrict__ ix,     // (m, w)
    const T* __restrict__ vy,       // (m, w)
    const T* __restrict__ vx,       // (m, w)
    T* __restrict__ out,            // (C, m, 2) interleaved re/im
    int C, int nfy, int nfx, int m, int w) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= static_cast<long long>(m) * C) return;
  const int t = static_cast<int>(tid % m);
  const int c = static_cast<int>(tid / m);
  const T* Gc = G + static_cast<long long>(c) * nfy * nfx * 2;
  const int* iyt = iy + static_cast<long long>(t) * w;
  const int* ixt = ix + static_cast<long long>(t) * w;
  const T* vyt = vy + static_cast<long long>(t) * w;
  const T* vxt = vx + static_cast<long long>(t) * w;

  T acc_re = T(0);
  T acc_im = T(0);
  for (int a = 0; a < w; ++a) {
    const T* row = Gc + static_cast<long long>(iyt[a]) * nfx * 2;
    T row_re = T(0);
    T row_im = T(0);
    for (int b = 0; b < w; ++b) {
      const int x = ixt[b];
      const T v = vxt[b];
      row_re += row[2 * x] * v;
      row_im += row[2 * x + 1] * v;
    }
    acc_re += row_re * vyt[a];
    acc_im += row_im * vyt[a];
  }
  T* o = out + (static_cast<long long>(c) * m + t) * 2;
  o[0] = acc_re;
  o[1] = acc_im;
}

template <typename T>
int launch_interp(const void* G, const void* iy, const void* ix,
                  const void* vy, const void* vx, void* out, int C, int nfy,
                  int nfx, int m, int w, void* stream) {
  const int threads = 256;
  const long long total = static_cast<long long>(m) * C;
  const unsigned int blocks = static_cast<unsigned int>((total + threads - 1) / threads);
  interp_taps<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(G), static_cast<const int*>(iy),
      static_cast<const int*>(ix), static_cast<const T*>(vy),
      static_cast<const T*>(vx), static_cast<T*>(out), C, nfy, nfx, m, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fftvis_interp_f32(const void* G, const void* iy, const void* ix,
                                 const void* vy, const void* vx, void* out,
                                 int C, int nfy, int nfx, int m, int w,
                                 void* stream) {
  return launch_interp<float>(G, iy, ix, vy, vx, out, C, nfy, nfx, m, w, stream);
}

extern "C" int fftvis_interp_f64(const void* G, const void* iy, const void* ix,
                                 const void* vy, const void* vx, void* out,
                                 int C, int nfy, int nfx, int m, int w,
                                 void* stream) {
  return launch_interp<double>(G, iy, ix, vy, vx, out, C, nfy, nfx, m, w, stream);
}
