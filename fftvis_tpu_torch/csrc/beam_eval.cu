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
//
// The adjoint of the interpolation alone, what a gradient through it needs
// (the JAX package lets XLA differentiate its gather; no Pallas kernel has
// a backward): with respect to the table,
//
//     gdata[iy[p, a], ix[p, b], c] = sum_p sum_ab wy[p, a] wx[p, b] g[p, c]
//
// and on request with respect to the coordinates, gy[p] = sum_c g[p, c]
// sum_ab wy'[p, a] wx[p, b] data[iy, ix, c] (gx likewise), from the
// derivative of the tap weights. Its taps, fold, mirror and clamps are
// those of the forward kernel; a coordinate the order-1 clamp holds
// contributes no derivative, as torch's clamp does not.
//
// The table gradient is owned, not scattered: beam_eval_adjoint_points
// gives one block a tile of ADJ_TY x ADJ_TX cells, all channels, and the
// block writes every cell of it once, zeros included, so the wrapper
// allocates the gradient with torch.empty (no zero pass over the table,
// 77.6 MB at the north star's (91, 360, 296) in float64) and no atomic
// touches it. The points reach their tiles through a counting sort on the
// card (adjoint_tile_count / _scan / _scatter, integer atomics on the
// per-tile counts only): a point joins the list of every tile its folded
// or mirrored taps land in (the fold seam in x puts a point on the last
// and the first tile columns; at most K x K tiles), unless its gradient
// row is all zeros -- the masked half of a source block, which the za
// clamp piles onto the last row. A tile's block sorts its list by point
// index in shared memory (at most ADJ_SORT points), stages each round's
// taps relative to the tile and lists, for each row, the points with a tap
// on it; for each chunk of 32 channels thread (channel, row) adds its
// row's points into its ADJ_TX cells in registers.
// So the sum runs in point order and the table gradient is bitwise
// repeatable whenever no tile lists more than ADJ_SORT points (always for
// the engine's source blocks of at most 4096). The coordinates' gradient
// (beam_eval_adjoint_coords) takes one warp a point, its lanes over the
// channels, reduced by a fixed shuffle tree and written once: repeatable
// too. Bound: the (ny, nx, ch) table gradient written once, the points
// and their gradient (and for gy, gx the touched cells) read once.

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

// ------------------------------------------------ adjoint

// The tap weights' derivatives with respect to the coordinate, as torch's
// autograd takes them through the plain version's ops: order 1 wrapped
// (-1, 1); clamped (-1, 1) where the clamped fraction lies in [0, 1], else
// 0; order 3 the cubic B-spline weights' derivatives in t.
template <typename T>
__device__ __forceinline__ void dtaps_linear(T u, int n, bool wrap, T* dw) {
  T d = T(1);
  if (!wrap) {
    const T f = fmin(fmax(floor(u), T(0)), T(n - 1));
    const T t = u - f;
    d = t >= T(0) && t <= T(1) ? T(1) : T(0);
  }
  dw[0] = -d;
  dw[1] = d;
}

template <typename T>
__device__ __forceinline__ void dtaps_cubic(T u, T* dw) {
  const T t = u - floor(u);
  const T t2 = t * t;
  dw[0] = (T(-3) + T(6) * t - T(3) * t2) / T(6);
  dw[1] = (T(-12) * t + T(9) * t2) / T(6);
  dw[2] = (T(3) + T(6) * t - T(9) * t2) / T(6);
  dw[3] = T(3) * t2 / T(6);
}

// The table gradient's tiles: ADJ_TY rows x ADJ_TX columns of cells,
// walked 32 channels at a time; thread (channel, row), so a warp writes 32
// consecutive channels of a cell at once. Edges of at least 4 cells keep a
// point's four cubic taps on at most two tiles an axis, except beside a
// narrow last tile. Small tiles spread a crowded source block over many
// blocks: the north star's first block puts ~4,000 points on a few dozen
// 8 x 16 tiles, which then ran one block an SM (chip_smoke.py's
// "north-star block" line times this case).
constexpr int ADJ_TY = 4;
constexpr int ADJ_TX = 8;
constexpr int ADJ_THREADS = 32 * ADJ_TY;
// Points a block sorts in shared memory (16 KB): longer lists run in the
// counting sort's order.
constexpr int ADJ_SORT = 4096;
// Points whose taps and gradient rows a block stages at once.
constexpr int ADJ_ROUND = 64;
// Chunks of 32 channels a block of beam_eval_adjoint_points takes: one
// sort and staging of the tile's points serves them all, while enough
// blocks stay in flight to hide each block's chain of dependent loads.
constexpr int ADJ_CHUNKS = 2;
static_assert(32 * ADJ_TY >= ADJ_ROUND, "a round's points are staged a thread each");

// The distinct tiles of a point's taps along each axis: tiles t*[k] and
// whether tap k is the first on its tile (first*[k]).
template <typename T, int ORDER>
__device__ __forceinline__ void point_tiles(T yv, T xv, int ny, int nx, bool wrap, int* ty,
                                            bool* fy, int* tx, bool* fx) {
  constexpr int K = ORDER == 1 ? 2 : 4;
  int iy[K], ix[K];
  T wy[K], wx[K];
  taps<T, ORDER>(yv, xv, ny, nx, wrap, iy, ix, wy, wx);
#pragma unroll
  for (int a = 0; a < K; ++a) {
    ty[a] = iy[a] / ADJ_TY;
    tx[a] = ix[a] / ADJ_TX;
    fy[a] = fx[a] = true;
#pragma unroll
    for (int s = 0; s < a; ++s) {
      fy[a] = fy[a] && ty[s] != ty[a];
      fx[a] = fx[a] && tx[s] != tx[a];
    }
  }
}

// Counting sort of the points into their tiles' lists: count, an exclusive
// scan (one block; the counts become the scatter's cursors), scatter. A
// point whose gradient row is all zeros (a source below the horizon, whose
// rows the mask zeroed) adds nothing and joins no list: the count takes a
// warp a point to read its row, and marks the live points for the scatter.
template <typename T, int ORDER>
__global__ void adjoint_tile_count(const T* __restrict__ y, const T* __restrict__ x,
                                   const T* __restrict__ g, int npts, int ch, int ny, int nx,
                                   int wrap, int ntx, int* __restrict__ count,
                                   int* __restrict__ live) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int p = static_cast<int>(tid / 32);
  const int lane = threadIdx.x % 32;
  if (p >= npts) return;  // whole warps
  bool nonzero = false;
  const T* gp = g + static_cast<long long>(p) * ch;
  for (int c = lane; c < ch; c += 32) nonzero = nonzero || gp[c] != T(0);
  nonzero = __any_sync(0xffffffffu, nonzero);
  if (lane != 0) return;
  live[p] = nonzero;
  if (!nonzero) return;
  constexpr int K = ORDER == 1 ? 2 : 4;
  int ty[K], tx[K];
  bool fy[K], fx[K];
  point_tiles<T, ORDER>(y[p], x[p], ny, nx, wrap != 0, ty, fy, tx, fx);
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) {
      if (fy[a] && fx[b]) atomicAdd(count + ty[a] * ntx + tx[b], 1);
    }
  }
}

constexpr int kAdjScanThreads = 1024;

__global__ void __launch_bounds__(kAdjScanThreads) adjoint_tile_scan(
    int* __restrict__ count, int ntiles, int* __restrict__ off) {
  __shared__ int part[kAdjScanThreads];
  const int t = threadIdx.x;
  const int chunk = (ntiles + kAdjScanThreads - 1) / kAdjScanThreads;
  const int lo = min(t * chunk, ntiles);
  const int hi = min(lo + chunk, ntiles);
  int a = 0;
  for (int i = lo; i < hi; ++i) a += count[i];
  part[t] = a;
  __syncthreads();
  // Inclusive scan of the threads' sums (Hillis-Steele).
  for (int d = 1; d < kAdjScanThreads; d <<= 1) {
    const int pa = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += pa;
    __syncthreads();
  }
  a = t ? part[t - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    off[i] = a;
    a += count[i];
    count[i] = 0;  // the scatter's cursor
  }
  if (t == kAdjScanThreads - 1) off[ntiles] = part[t];
}

template <typename T, int ORDER>
__global__ void adjoint_tile_scatter(const T* __restrict__ y, const T* __restrict__ x,
                                     int npts, int ny, int nx, int wrap, int ntx,
                                     const int* __restrict__ live,
                                     const int* __restrict__ off, int* __restrict__ cursor,
                                     int* __restrict__ list) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npts || !live[p]) return;
  constexpr int K = ORDER == 1 ? 2 : 4;
  int ty[K], tx[K];
  bool fy[K], fx[K];
  point_tiles<T, ORDER>(y[p], x[p], ny, nx, wrap != 0, ty, fy, tx, fx);
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) {
      if (fy[a] && fx[b]) {
        const int t = ty[a] * ntx + tx[b];
        list[off[t] + atomicAdd(cursor + t, 1)] = p;
      }
    }
  }
}

// One block a tile and ADJ_CHUNKS chunks of 32 channels: the tile's points
// in index order, their taps staged relative to the tile a round at a
// time, and for each chunk the round's gradient rows staged too; thread
// (channel c, row r) adds sum_{a on row r} wy[a] * wx[b] * g[p, c] into the
// cell of tap b when that tap lies on the tile, then writes its row's
// ADJ_TX cells of channel c, zeros included. A list of at most ADJ_ROUND
// points is sorted and its taps staged once for all the block's chunks.
template <typename T, int ORDER>
__global__ void __launch_bounds__(ADJ_THREADS) beam_eval_adjoint_points(
    const T* __restrict__ y,      // (npts,)
    const T* __restrict__ x,      // (npts,)
    const T* __restrict__ g,      // (npts, ch) gradient of the output
    const int* __restrict__ off,  // (ntiles + 1,) the lists' offsets
    const int* __restrict__ list,  // the points of every tile
    T* __restrict__ gdata,        // (ny, nx, ch), every entry written
    int ny, int nx, int ch, int wrap, int ntx) {
  constexpr int K = ORDER == 1 ? 2 : 4;
  __shared__ int ids[ADJ_SORT];
  __shared__ int spt[ADJ_ROUND];
  __shared__ signed char srow[ADJ_ROUND][K], scol[ADJ_ROUND][K];
  __shared__ T swy[ADJ_ROUND][K], swx[ADJ_ROUND][K];
  __shared__ T sg[ADJ_ROUND][32];
  // Each row's (warp's) staged points, in order.
  __shared__ unsigned char rowq[ADJ_TY][ADJ_ROUND];
  static_assert(ADJ_ROUND <= 256, "rowq holds a round's indices in bytes");
  const int tile = blockIdx.x;
  const int y0 = tile / ntx * ADJ_TY, x0 = tile % ntx * ADJ_TX;
  const int r = threadIdx.y;
  const int t = r * 32 + threadIdx.x;
  const int lo = off[tile];
  const int L = off[tile + 1] - lo;
  const bool sorted = L > 1 && L <= ADJ_SORT;
  if (sorted) {
    // Bitonic sort of the list, padded to a power of two.
    int S = 1;
    while (S < L) S <<= 1;
    for (int i = t; i < S; i += ADJ_THREADS) ids[i] = i < L ? list[lo + i] : 0x7fffffff;
    __syncthreads();
    for (int k = 2; k <= S; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < S; i += ADJ_THREADS) {
          const int l = i ^ j;
          if (l > i) {
            const int a = ids[i], b = ids[l];
            if ((a > b) == ((i & k) == 0)) {
              ids[i] = b;
              ids[l] = a;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  const int iy = y0 + r;
  const int lane = threadIdx.x;
  const int c_begin = static_cast<int>(blockIdx.y) * ADJ_CHUNKS * 32;
  const int c_end = min(ch, c_begin + ADJ_CHUNKS * 32);
  int nrow = 0;  // this row's staged points
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    const int c = c0 + lane;
    T acc[ADJ_TX];
#pragma unroll
    for (int k = 0; k < ADJ_TX; ++k) acc[k] = T(0);
    for (int s0 = 0; s0 < L; s0 += ADJ_ROUND) {
      const int nr = min(ADJ_ROUND, L - s0);
      const bool restage = c0 == c_begin || L > ADJ_ROUND;  // uniform
      __syncthreads();  // the last round's staging is read; ids are sorted
      if (t < nr && restage) {
        const int p = sorted ? ids[s0 + t] : list[lo + s0 + t];
        int ty[K], tx[K];
        T wy[K], wx[K];
        taps<T, ORDER>(y[p], x[p], ny, nx, wrap != 0, ty, tx, wy, wx);
        spt[t] = p;
#pragma unroll
        for (int a = 0; a < K; ++a) {
          const int ry = ty[a] - y0, rx = tx[a] - x0;
          srow[t][a] = static_cast<signed char>(ry >= 0 && ry < ADJ_TY ? ry : -1);
          scol[t][a] = static_cast<signed char>(rx >= 0 && rx < ADJ_TX ? rx : -1);
          swy[t][a] = wy[a];
          swx[t][a] = wx[a];
        }
      }
      __syncthreads();
      if (restage) {
        // The warp lists the staged points with a tap on its row, in order.
        nrow = 0;
        for (int base = 0; base < nr; base += 32) {
          const int q = base + lane;
          bool hit = false;
#pragma unroll
          for (int a = 0; a < K; ++a) hit = hit || (q < nr && srow[q][a] == r);
          const unsigned m = __ballot_sync(0xffffffffu, hit);
          if (hit) {
            rowq[r][nrow + __popc(m & ((1u << lane) - 1u))] = static_cast<unsigned char>(q);
          }
          nrow += __popc(m);
        }
      }
      // The round's gradient rows of this chunk, all loads in flight at once.
      for (int i = t; i < nr * 32; i += ADJ_THREADS) {
        const int q = i / 32, cc = c0 + i % 32;
        sg[q][i % 32] = cc < ch ? g[static_cast<long long>(spt[q]) * ch + cc] : T(0);
      }
      __syncthreads();
      for (int j = 0; j < nrow; ++j) {
        const int q = rowq[r][j];
        T wr = T(0);
#pragma unroll
        for (int a = 0; a < K; ++a) {
          if (srow[q][a] == r) wr += swy[q][a];
        }
        const T gv = wr * sg[q][lane];
#pragma unroll
        for (int b = 0; b < K; ++b) {
          const int xl = scol[q][b];
          if (xl < 0) continue;
          const T v = swx[q][b] * gv;
#pragma unroll
          for (int k = 0; k < ADJ_TX; ++k) {
            if (k == xl) acc[k] += v;
          }
        }
      }
    }
    if (iy >= ny || c >= ch) continue;
    T* o = gdata + (static_cast<long long>(iy) * nx + x0) * ch + c;
#pragma unroll
    for (int k = 0; k < ADJ_TX; ++k) {
      if (x0 + k < nx) o[static_cast<long long>(k) * ch] = acc[k];
    }
  }
}

// The coordinates' gradient: one warp a point, lanes over the channels,
// a fixed shuffle tree, lane 0 writes gy[p] and gx[p].
template <typename T, int ORDER>
__global__ void beam_eval_adjoint_coords(
    const T* __restrict__ data,  // (ny, nx, ch)
    const T* __restrict__ y, const T* __restrict__ x,
    const T* __restrict__ g,     // (npts, ch)
    T* __restrict__ gy, T* __restrict__ gx,
    int npts, int ny, int nx, int ch, int wrap) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int p = static_cast<int>(tid / 32);
  const int lane = threadIdx.x % 32;
  if (p >= npts) return;  // whole warps
  constexpr int K = ORDER == 1 ? 2 : 4;
  int iy[K], ix[K];
  T wy[K], wx[K], dwy[K], dwx[K];
  const T yv = y[p], xv = x[p];
  taps<T, ORDER>(yv, xv, ny, nx, wrap != 0, iy, ix, wy, wx);
  if constexpr (ORDER == 1) {
    dtaps_linear(yv, ny, false, dwy);
    dtaps_linear(xv, nx, wrap != 0, dwx);
  } else {
    dtaps_cubic(yv, dwy);
    dtaps_cubic(xv, dwx);
  }
  const T* gp = g + static_cast<long long>(p) * ch;
  T sy = T(0), sx = T(0);
  for (int c = lane; c < ch; c += 32) {
    const T gv = gp[c];
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const T d = __ldg(data + (static_cast<long long>(iy[a]) * nx + ix[b]) * ch + c) * gv;
        sy += dwy[a] * wx[b] * d;
        sx += wy[a] * dwx[b] * d;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  if (lane == 0) {
    gy[p] = sy;
    gx[p] = sx;
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

__device__ __forceinline__ unsigned int smem_addr(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// One complex element, 8 or 16 bytes, from device to shared memory.
__device__ __forceinline__ void cp_async(float2* dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async(double2* dst, const double2* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// One real, 4 or 8 bytes.
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// is written with consecutive points at consecutive addresses. The output,
// (P * C, n) complex, is the largest tensor of a source block and sets the
// bound. A stack whose tile does not fit shared memory (K = 331 with one
// beam an antenna) takes pair_rows_wide below.
constexpr int TP = 32;             // points a tile: a warp's row write
constexpr int PY = 8;              // pair lanes a block
constexpr int SMEM_MAX = 200 * 1024;  // dynamic shared memory a block at most

// Row c = (f, g) of a Jones pair at one point from beam i's and beam j's
// e[v][f] (a the first beam, b the second): Stokes I (conj(ei[0, f]) ej[0,
// g] + conj(ei[1, f]) ej[1, g]) * flux, or IQUV A_i^H C A_j with the vector
// axis flipped, the sum over (a, b) of conj(ei[1-a, f]) coh[a, b] ej[1-b, g].
template <typename T, int EPI>
__device__ __forceinline__ void pair_jones_row(int c, const T (&ar)[2][2], const T (&ai)[2][2],
                                               const T (&br)[2][2], const T (&bi)[2][2],
                                               T flux, const T (&cr)[2][2],
                                               const T (&ci)[2][2], T& re, T& im) {
  const int f = c / 2, g = c % 2;
  re = T(0);
  im = T(0);
  if constexpr (EPI == JONES_I) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      re += ar[v][f] * br[v][g] + ai[v][f] * bi[v][g];
      im += ar[v][f] * bi[v][g] - ai[v][f] * br[v][g];
    }
    re *= flux;
    im *= flux;
  } else {
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
}

// A point's sky: the (2, 2) complex coherency for IQUV, else the flux.
template <typename T, int EPI>
__device__ __forceinline__ void point_sky(const T* s, long long sa, long long sb, T& flux,
                                          T (&cr)[2][2], T (&ci)[2][2]) {
  flux = T(0);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      cr[a][bb] = T(0);
      ci[a][bb] = T(0);
    }
  }
  if constexpr (EPI == JONES_IQUV) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const T* q = s + a * sa + bb * sb;
        cr[a][bb] = q[0];
        ci[a][bb] = q[1];
      }
    }
  } else {
    flux = s[0];
  }
}

template <typename T, int EPI, bool CPLX>
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
  const T* src = ev + static_cast<long long>(b0) * kc;
  const int total = npt * static_cast<int>(kc);
  for (int i = ty * TP + tx; i < total; i += TP * PY) {
    const int pt = i / static_cast<int>(kc);
    const int c = i - pt * static_cast<int>(kc);
    sh[c * (TP + 1) + pt] = src[i];
  }
  __syncthreads();
  if (tx >= npt) return;
  const int b = b0 + tx;
  auto at = [&](long long c) -> T { return sh[c * (TP + 1) + tx]; };
  const T m = mask[b];
  T flux, cr[2][2], ci[2][2];
  point_sky<T, EPI>(sky + sky_sp * b, sky_sa, sky_sb, flux, cr, ci);
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
        T re, im;
        pair_jones_row<T, EPI>(c, ar, ai, br, bi, flux, cr, ci, re, im);
        op[static_cast<long long>(c) * n] = V2{re * m, im * m};
      }
    }
  }
}

// ------------------------------------------------------------ wide stacks
//
// pair_rows_wide and pair_rows_adjoint_wide (below): the pair rows and their
// adjoint for a stack whose tile does not fit the forms above -- K = 331
// with one beam an antenna, (n, 2648) evaluations, 10.6 KB a point in
// float32. The global forms they replace gave a thread one point, lanes
// over 32 points, and read each evaluation at the point's row from device
// memory: neighbouring lanes K * chf reals apart, and each point's row read
// again for every (pair, role) entry (2P = 1262 against K = 331, 3.8 times
// the stack, which at 87 MB in float64 does not stay in L2); the adjoint
// wrote its gradient with the same stride. Both ran at 8-50% of their
// bounds.
//
// Here a block takes a tile of WP points, lanes over them fastest, and
// the rest of its WIDE_THREADS threads over the tile's pairs (forward) or
// (pair, role) entries (adjoint); a tile whose points are all masked
// writes zeros and reads nothing.
//
// - pair_rows_wide: WP points make one 128-byte line of a complex row (16
//   in float32, 8 in float64), so that every output line is written whole
//   by one store of one warp, masked points' zeros included. With a tile
//   of one 32-byte sector, a half-masked block ran 2.5 times slower than
//   an unmasked one: sectors and lines left device memory part-written,
//   in pieces. The staged form (WIDE) copies the tile's rows into shared
//   memory, one contiguous 170 KB copy by 16-byte cp.async at K = 331,
//   each row padded by 16 bytes: 98 against 114 us from device memory in
//   float64; in float32, whose 16 points' rows cost as many bytes to stage
//   and half the reads to fetch again, 56-60 against 54-56 us (PERF.md
//   section 6, row 4), and the host's one rule keeps it all the same.
//   Each thread reads the two beams' 2 x 2 Jones at its point in 16-byte
//   vectors.
// - pair_rows_adjoint_wide: WP points make one 32-byte sector of a row (4
//   in float32, 2 in float64). The index's entries in rounds of
//   WIDE_CHUNK: first every (entry, point)'s contribution side by side --
//   the pair's 4 gradient rows at the point (the WP lanes of an entry on
//   one sector) and the other beam's Jones through L1 -- into shared
//   memory; then each beam's owner adds its entries of the round in index
//   order, carrying its sum across rounds. The per-beam walk of the global
//   form put the hub of a redundant array's representatives (antenna 0 of
//   HERA-331, in 332 of the 631 pairs) on one thread a point, 332
//   dependent loads of device memory long; here that thread adds 332
//   values from shared memory. Staging the rows in shared memory too was
//   slower (163 against 131 us in float32, 285 against 211 in float64),
//   and so was a tile of a 128-byte line in float64.
//
// Past WIDE_SMEM_MAX (the forward's rows past ~450 complex Jones beams)
// the forward reads the rows from device memory (WIDE_GLOBAL); the host
// takes the first form that fits (beams/eval.py pair_rows_form, from
// fftvis_pair_rows_smem).
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_SMEM_MAX = 227 * 1024;  // the most dynamic shared memory a block may take

// Points a tile of the wide forms: pair_rows_wide's one 128-byte line of
// a complex row (16 in float32, 8 in float64), pair_rows_adjoint_wide's
// one 32-byte sector (4, 2). The reals of a staged row: K * chf and a
// 16-byte pad.
__host__ __device__ constexpr int wide_points(bool adjoint, int tsize) {
  return (adjoint ? 16 : 64) / tsize;
}

__host__ __device__ inline long long wide_row(long long kc, int tsize) {
  return kc + 16 / tsize;
}

__host__ __device__ inline long long wide_smem(long long kc, int tsize, int points) {
  return points * wide_row(kc, tsize) * tsize;
}

// A piece of ``bytes`` bytes at offset ``at`` of a block's shared memory,
// from a 16-byte boundary; ``at`` moves past it.
__host__ __device__ inline long long smem_take(long long& at, long long bytes) {
  const long long here = at;
  at += (bytes + 15) / 16 * 16;
  return here;
}

// The tile's rows, npt x kc reals from src, into sh with wide_row strides,
// by cp.async: 16-byte copies where vec (src 16-byte aligned, kc *
// sizeof(T) a multiple of 16). Every thread of the block calls it; it ends
// with a barrier.
template <typename T>
__device__ __forceinline__ void wide_stage(T* sh, const T* __restrict__ src, long long kc,
                                           int npt, bool vec) {
  const long long row = wide_row(kc, sizeof(T));
  if (vec) {
    const int per = static_cast<int>(kc * static_cast<long long>(sizeof(T)) / 16);
    for (int i = threadIdx.x; i < npt * per; i += blockDim.x) {
      const int pt = i / per;
      const int u = i - pt * per;
      cp_async(reinterpret_cast<double2*>(sh + pt * row) + u,
               reinterpret_cast<const double2*>(src + pt * kc) + u);
    }
  } else {
    const int total = npt * static_cast<int>(kc);
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int pt = i / static_cast<int>(kc);
      cp_async(sh + pt * row + (i - pt * kc), src + i);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// N reals at p into v, by 16-byte vectors where vec (p 16-byte aligned).
template <typename T, int N>
__device__ __forceinline__ void load_reals(const T* p, T (&v)[N], bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int L = Vec16<T>::n;
  if (N % L == 0 && vec) {
#pragma unroll
    for (int i = 0; i < N / L; ++i) unpack(reinterpret_cast<const V*>(p)[i], v + i * L);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// N reals v to p, by 16-byte vectors where vec.
template <typename T, int N>
__device__ __forceinline__ void store_reals(T* p, const T (&v)[N], bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int L = Vec16<T>::n;
  if (N % L == 0 && vec) {
#pragma unroll
    for (int i = 0; i < N / L; ++i) {
      V q;
      T* qv = reinterpret_cast<T*>(&q);
#pragma unroll
      for (int j = 0; j < L; ++j) qv[j] = v[i * L + j];
      reinterpret_cast<V*>(p)[i] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// One beam's 2 x 2 Jones e[v][f] (re, im) from its NJ channels at p.
template <typename T, bool CPLX>
__device__ __forceinline__ void read_jones(const T* p, bool vec, T (&er)[2][2],
                                           T (&ei)[2][2]) {
  constexpr int NJ = CPLX ? 8 : 4;
  T e[NJ];
  load_reals<T, NJ>(p, e, vec);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      er[v][f] = e[v * 2 + f];
      ei[v][f] = CPLX ? e[(4 + v * 2 + f) % NJ] : T(0);
    }
  }
}

template <typename T, int EPI, bool CPLX, bool STAGE>
__global__ void __launch_bounds__(WIDE_THREADS) pair_rows_wide(
    const T* __restrict__ ev,    // (n, kc) evaluations
    const int* __restrict__ pi,  // (P,) first beam of each pair
    const int* __restrict__ pj,  // (P,) second beam
    const T* __restrict__ sky,   // real (n,) Stokes I, or complex (n, 2, 2) as reals
    const T* __restrict__ mask,  // (n,)
    T* __restrict__ out,         // complex (P * C, n) as reals
    int n, int K, int chf, int c0, int P, int ppb, int vec,
    long long sky_sp, long long sky_sa, long long sky_sb) {
  using V2 = typename Vec2<T>::type;
  constexpr int C = EPI == POWER ? 1 : 4;
  constexpr int WP = wide_points(false, sizeof(T));
  constexpr int LY = WIDE_THREADS / WP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long kc = static_cast<long long>(K) * chf;
  const int b0 = blockIdx.x * WP;
  const int npt = min(WP, n - b0);
  const int pt = threadIdx.x % WP, py = threadIdx.x / WP;
  const bool act = pt < npt;
  // A ragged tile's spare lanes read the last point and store nothing.
  const int pr = min(pt, npt - 1);
  const T m = act ? mask[b0 + pt] : T(0);
  const bool live = __syncthreads_or(m != T(0));
  const int pend = min(P, (blockIdx.y + 1) * ppb);
  V2* o = reinterpret_cast<V2*>(out) + b0 + pt;
  if (!live) {
    // Every point of the tile masked: zero rows, nothing staged or read.
    for (int p = blockIdx.y * ppb + py; p < pend; p += LY) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (act) o[(static_cast<long long>(p) * C + c) * n] = V2{T(0), T(0)};
      }
    }
    return;
  }
  const T* er;
  if constexpr (STAGE) {
    T* sh = reinterpret_cast<T*>(smem_raw);
    wide_stage(sh, ev + static_cast<long long>(b0) * kc, kc, npt, vec != 0);
    er = sh + pr * wide_row(kc, sizeof(T));
  } else {
    er = ev + static_cast<long long>(b0 + pr) * kc;
  }
  T flux, cr[2][2], ci[2][2];
  point_sky<T, EPI>(sky + sky_sp * (b0 + pr), sky_sa, sky_sb, flux, cr, ci);
  // A masked point's lanes compute on its (finite) evaluations too and
  // store zeros: the WP lanes of a pair then write their 32-byte sector in
  // one store. Apart, a sector's halves left device memory at different
  // times and each took a read-modify-write (a half-masked block ran 2.5
  // times slower than an unmasked one).
#pragma unroll 2
  for (int p = blockIdx.y * ppb + py; p < pend; p += LY) {
    // A malformed index reads a wrong beam, never out of bounds.
    const long long ei = static_cast<long long>(min(max(pi[p], 0), K - 1)) * chf;
    const long long ej = static_cast<long long>(min(max(pj[p], 0), K - 1)) * chf;
    T re[C], im[C];
    if constexpr (EPI == POWER) {
      // Cubic overshoot near nulls can go negative: clamp at the floor.
      re[0] = sqrt(fmax(er[ei + c0] * er[ej + c0], T(0))) * flux * m;
      im[0] = T(0);
    } else {
      T ar[2][2], ai[2][2], br[2][2], bi[2][2];
      read_jones<T, CPLX>(er + ei, vec != 0, ar, ai);
      read_jones<T, CPLX>(er + ej, vec != 0, br, bi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pair_jones_row<T, EPI>(c, ar, ai, br, bi, flux, cr, ci, re[c], im[c]);
        re[c] *= m;
        im[c] *= m;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool zero = m == T(0);
      if (act) {
        o[(static_cast<long long>(p) * C + c) * n] =
            V2{zero ? T(0) : re[c], zero ? T(0) : im[c]};
      }
    }
  }
}

// One (pair, role) entry of a Jones beam's gradient at one point: the other
// beam's Jones (xr, xi) and the pair's gradient rows G_fg (Gr, Gi) added
// into the beam's complex gradient (gr, gi); cr, ci the IQUV coherency
// (read for JONES_IQUV only). first: the beam is the pair's first (i).
template <typename T, int EPI>
__device__ __forceinline__ void pair_adjoint_jones(
    bool first, const T (&xr)[2][2], const T (&xi)[2][2], const T (&Gr)[2][2],
    const T (&Gi)[2][2], const T (&cr)[2][2], const T (&ci)[2][2], T (&gr)[2][2],
    T (&gi)[2][2]) {
  if constexpr (EPI == JONES_I) {
    if (first) {
      // gA[v][f] += sum_g conj(G_fg) e_j[v][g]
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            gr[v][f] += Gr[f][h] * xr[v][h] + Gi[f][h] * xi[v][h];
            gi[v][f] += Gr[f][h] * xi[v][h] - Gi[f][h] * xr[v][h];
          }
        }
      }
    } else {
      // gB[v][h] += sum_f G_fh e_i[v][f]
#pragma unroll
      for (int v = 0; v < 2; ++v) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            gr[v][h] += Gr[f][h] * xr[v][f] - Gi[f][h] * xi[v][f];
            gi[v][h] += Gr[f][h] * xi[v][f] + Gi[f][h] * xr[v][f];
          }
        }
      }
    }
  } else if (first) {
    // cb[a][h] = sum_b coh[a][b] e_j[1-b][h]; gA[1-a][f] += sum_h
    // conj(G_fh) cb[a][h].
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T br = T(0), bi = T(0);
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          br += cr[a][bb] * xr[1 - bb][h] - ci[a][bb] * xi[1 - bb][h];
          bi += cr[a][bb] * xi[1 - bb][h] + ci[a][bb] * xr[1 - bb][h];
        }
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          gr[1 - a][f] += Gr[f][h] * br + Gi[f][h] * bi;
          gi[1 - a][f] += Gr[f][h] * bi - Gi[f][h] * br;
        }
      }
    }
  } else {
    // ca[bb][f] = sum_a e_i[1-a][f] conj(coh[a][bb]); gB[1-bb][h] +=
    // sum_f G_fh ca[bb][f].
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        T ar = T(0), ai = T(0);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          ar += xr[1 - a][f] * cr[a][bb] + xi[1 - a][f] * ci[a][bb];
          ai += xi[1 - a][f] * cr[a][bb] - xr[1 - a][f] * ci[a][bb];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          gr[1 - bb][h] += Gr[f][h] * ar - Gi[f][h] * ai;
          gi[1 - bb][h] += Gr[f][h] * ai + Gi[f][h] * ar;
        }
      }
    }
  }
}

// The gradient of the pair rows' output with respect to the (n, K * chf)
// real evaluations, given the (P * C, n)
// complex gradient G of the rows (PyTorch's convention: dL/dRe + i dL/dIm
// of a real loss), what the JAX package leaves to XLA's autodiff. The rows
// are bilinear in the two beams of a pair, so the gradient of beam k's
// complex Jones e_k[v][f] gathers, over the pairs where k is the first
// beam (i), m * sum_g conj(G_fg) c_g[v] with c the row's coefficient of
// conj(e_i[v][f]) -- flux * e_j[v][g] for Stokes I, sum_b coh[1-v][b]
// e_j[1-b][g] for IQUV -- and over the pairs where k is the second beam
// (j), m * sum_f G_fg conj(c_f[v]) with c_f[v] the coefficient of
// e_j[v][g] -- flux * conj(e_i[v][f]), or sum_a conj(e_i[1-a][f])
// coh[a][1-v]. Re and Im of that sum are the gradients of the table's
// re/im channels (Re alone for a real Jones table). A power row m * flux *
// sqrt(e_i e_j) gives m * flux * Re(G) e_other / (2 sqrt(e_i e_j)), zero
// where e_i e_j <= 0 (the forward's floor has no slope there).
//
// Two forms, each writing every gradient entry once, by one thread, in a
// fixed order (no atomics, bitwise repeatable), and each walking the
// per-beam index of the pairs (a CSR of the 2P (pair, role) entries by
// beam, each beam's first-role entries then its second-role ones, each in
// the tile form's chunk order; built once with the routing):
//
// - pair_rows_adjoint_tile, wherever a point tile fits shared memory and
//   the beams fit PA_UNITS thread rows (every stack of the engine's
//   paths but one beam an antenna). What held the first form back (68.5
//   us against a 19.9 us
//   bound at the north star's block in float64, 29%): each of a tile's 3
//   blocks (groups of 13 beams) staged the tile's whole K x chf
//   evaluations, 78 KB at f64, which held residency to 2 blocks an SM;
//   each pair's 4 gradient rows were read twice, once a role, by threads
//   of different blocks; a thread walked its entries in a chain of
//   dependent loads (entry -> pair -> 4 strided G loads) with few warps to
//   hide it; and 13 beams over 8 thread rows left a tail. Here one block
//   owns a tile of PA_POINTS points and every beam: the lanes of a warp
//   are the tile's points and a thread row a beam (up to PA_UNITS beams a
//   row), so a warp's lanes walk one beam's entries together, without
//   divergence.
//   The block stages the evaluations once and streams the pairs' gradient
//   rows G[(p * C + c), tile] through shared memory in chunks of PA_PAIRS
//   pairs, three chunks in flight by cp.async (the evaluations with the
//   first) while one is summed, so each row leaves device memory once and
//   serves both roles from shared memory. Chunk c holds the pairs p = c +
//   nch * slot (nch chunks): a pair list in (i, j) order puts a run of
//   pairs on one first beam, and a chunk of consecutive pairs would leave
//   that beam's owner with the whole chunk while the others wait at the
//   barrier. Each owner takes its entries of a chunk in list order and
//   sums them in registers, one barrier a chunk; at the end the sums pass
//   through shared memory and the tile is written out once, coalesced. The
//   tile's PA_POINTS = 32 points were measured against 16, not guessed
//   (PERF.md row 4b).
// - pair_rows_adjoint_wide, for a stack past that (K = 331 with one beam
//   an antenna; the design note of the wide forms above): entries in
//   rounds, each entry's contribution at each point computed side by side
//   into shared memory, then summed by each beam's owner in index order.
//   At 32 points a chunk of 16 pairs left most of the 331 beams' owners
//   idle at each of 40 barriers, and 32 points' rows do not fit shared
//   memory.
//
// Bound: G at the unmasked points read once, the evaluations read once and
// their gradient written once.

// Entries of the index that a round of pair_rows_adjoint_wide takes.
constexpr int WIDE_CHUNK = 256;

// Byte offsets of pair_rows_adjoint_wide's shared memory, on the host and
// the card alike: the group's beam offsets (K + 1 ints), a round's
// contributions (WIDE_CHUNK entries x WP points x NV reals) and two
// carried sums (WP x NV reals each).
struct WideAdjLayout {
  long long off, contrib, carry, total;
};

__host__ __device__ inline WideAdjLayout wide_adj_layout(int K, int NV, int tsize) {
  const int wp = wide_points(true, tsize);
  WideAdjLayout L;
  long long at = 0;
  L.off = smem_take(at, (static_cast<long long>(K) + 1) * 4);
  L.contrib = smem_take(at, static_cast<long long>(WIDE_CHUNK) * wp * NV * tsize);
  L.carry = smem_take(at, 2ll * wp * NV * tsize);
  L.total = at;
  return L;
}

template <typename T, int EPI, bool CPLX>
__global__ void __launch_bounds__(WIDE_THREADS) pair_rows_adjoint_wide(
    const T* __restrict__ ev,      // (n, kc) evaluations
    const int* __restrict__ pi,    // (P,) first beam of each pair
    const int* __restrict__ pj,    // (P,) second beam
    const int* __restrict__ index,  // (nidx + 1,) offsets by beam, then (2P,) entries
    const T* __restrict__ sky,     // real (n,) Stokes I, or complex (n, 2, 2) as reals
    const T* __restrict__ mask,    // (n,)
    const T* __restrict__ g,       // complex (P * C, n) as reals
    T* __restrict__ gev,           // (n, kc), every entry written
    int n, int K, int chf, int c0, int P, int nidx, int kpb, int vec,
    long long sky_sp, long long sky_sa, long long sky_sb) {
  using V2 = typename Vec2<T>::type;
  constexpr int WP = wide_points(true, sizeof(T));
  constexpr int LY = WIDE_THREADS / WP;
  constexpr int NJ = CPLX ? 8 : 4;
  constexpr int NV = EPI == POWER ? 1 : NJ;  // reals a contribution keeps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long kc = static_cast<long long>(K) * chf;
  const WideAdjLayout L = wide_adj_layout(K, NV, sizeof(T));
  int* off_s = reinterpret_cast<int*>(smem_raw + L.off);  // the group's beams' entries
  T* contrib = reinterpret_cast<T*>(smem_raw + L.contrib);
  T* carry = reinterpret_cast<T*>(smem_raw + L.carry);
  const int k0 = blockIdx.y * kpb;
  const int nk = min(K, k0 + kpb) - k0;
  const int b0 = blockIdx.x * WP;
  const int npt = min(WP, n - b0);
  const int tid = threadIdx.x;
  const int pt = tid % WP, py = tid / WP;
  const bool act = pt < npt;
  // A ragged tile's spare lanes read the last point and store nothing.
  const int pr = min(pt, npt - 1);
  const T m = act ? mask[b0 + pt] : T(0);
  if (!__syncthreads_or(m != T(0))) {
    // Every point of the tile masked: zero gradients, nothing read.
    const int len = nk * chf;
    for (int i = tid; i < npt * len; i += WIDE_THREADS) {
      const int q = i / len;
      gev[static_cast<long long>(b0 + q) * kc + static_cast<long long>(k0) * chf + (i - q * len)] =
          T(0);
    }
    return;
  }
  // The group's beams' entries: beams at or past nidx have none.
  for (int k = tid; k <= nk; k += WIDE_THREADS) {
    off_s[k] = min(max(index[min(k0 + k, nidx)], 0), 2 * P);
  }
  __syncthreads();
  // The point's row, read through L1: staging the tile's rows in shared
  // memory cost more than it saved (the wide forms' note).
  const T* er = ev + static_cast<long long>(b0 + pr) * kc;
  T flux, cr[2][2], ci[2][2];
  point_sky<T, EPI>(sky + sky_sp * (b0 + pr), sky_sa, sky_sb, flux, cr, ci);
  const T scale = EPI == JONES_IQUV ? m : flux * m;
  const V2* gb = reinterpret_cast<const V2*>(g) + b0 + pr;
  const int* ent = index + nidx + 1;
  T* out = gev + static_cast<long long>(b0 + pt) * kc;
  // Beam k's gradient at the point: the sums v scaled, into its chf reals.
  auto put = [&](int k, const T (&v)[NV]) {
    T* o = out + static_cast<long long>(k) * chf;
    if constexpr (EPI == POWER) {
      for (int c = 0; c < chf; ++c) o[c] = c == c0 ? v[0] * scale : T(0);
    } else {
      T r[NJ];
#pragma unroll
      for (int c = 0; c < NJ; ++c) r[c] = v[c] * scale;
      store_reals<T, NJ>(o, r, vec != 0);
    }
  };
  // A beam without entries: zeros.
  for (int kk = py; kk < nk; kk += LY) {
    if (act && off_s[kk + 1] <= off_s[kk]) {
      T z[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) z[c] = T(0);
      put(k0 + kk, z);
    }
  }
  // The group's entries [off_s[0], off_s[nk]) in rounds of WIDE_CHUNK, in
  // index order (by beam).
  const int qbeg = off_s[0], qend = max(off_s[nk], qbeg);
  for (int q0 = qbeg, round = 0; q0 < qend; q0 += WIDE_CHUNK, ++round) {
    const int q1 = min(qend, q0 + WIDE_CHUNK);
    // Each entry's contribution at each point, side by side: the pair's C
    // gradient rows at the point (the WP lanes of an entry on one 32-byte
    // sector) and the other beam's Jones. A masked point reads nothing.
    // Entry q's contribution at the point into the round's shared memory:
    // NV reals from a 16-byte boundary where NV > 1.
    auto contribute = [&](int q) {
      const int en = min(max(ent[q], 0), 2 * P - 1);
      const bool first = en < P;
      const int p = first ? en : en - P;
      // A malformed index reads a wrong beam, never out of bounds.
      const int other = min(max(first ? pj[p] : pi[p], 0), K - 1);
      T v[NV];
      if constexpr (EPI == POWER) {
        const int own = min(max(first ? pi[p] : pj[p], 0), K - 1);
        const T e = er[static_cast<long long>(own) * chf + c0];
        const T f = er[static_cast<long long>(other) * chf + c0];
        const T prod = e * f;
        v[0] = prod > T(0) ? gb[static_cast<long long>(p) * n].x * f / (T(2) * sqrt(prod))
                           : T(0);
      } else {
        T xr[2][2], xi[2][2], Gr[2][2], Gi[2][2];
        T gr[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
        T gi[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll
        for (int vv = 0; vv < 2; ++vv) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const V2 gg = gb[(static_cast<long long>(p) * 4 + vv * 2 + f) * n];
            Gr[vv][f] = gg.x;
            Gi[vv][f] = gg.y;
          }
        }
        read_jones<T, CPLX>(er + static_cast<long long>(other) * chf, vec != 0, xr, xi);
        pair_adjoint_jones<T, EPI>(first, xr, xi, Gr, Gi, cr, ci, gr, gi);
#pragma unroll
        for (int vv = 0; vv < 2; ++vv) {
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            v[vv * 2 + f] = gr[vv][f];
            if constexpr (CPLX) v[(4 + vv * 2 + f) % NJ] = gi[vv][f];
          }
        }
      }
      store_reals<T, NV>(contrib + (static_cast<long long>(q - q0) * WP + pt) * NV, v, true);
    };
    if (m != T(0)) {
      // A lane's entries are independent: unrolled, their loads overlap
      // four at a time, which paid at K = 331 in float32 and not in
      // float64.
      if constexpr (sizeof(T) == 4) {
#pragma unroll 4
        for (int q = q0 + py; q < q1; q += LY) contribute(q);
      } else {
        for (int q = q0 + py; q < q1; q += LY) contribute(q);
      }
    }
    __syncthreads();
    // The round's beams: each owner adds its entries of the round in index
    // order, after the sum carried from the round before where its entries
    // began there, and carries its sum on where they go past the round.
    int lo = 0, hi = nk - 1;  // the last beam whose entries start at or before q0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off_s[mid] <= q0) lo = mid; else hi = mid - 1;
    }
    const int ka = lo;
    const T* cin = carry + ((round + 1) & 1) * WP * NV + pt * NV;
    T* cout = carry + (round & 1) * WP * NV + pt * NV;
    for (int kk = ka + py; kk < nk && off_s[kk] < q1; kk += LY) {
      const int a = max(off_s[kk], q0), b = min(off_s[kk + 1], q1);
      if (a >= b) continue;
      T v[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) v[c] = off_s[kk] < q0 ? cin[c] : T(0);
      if (m != T(0)) {
        for (int q = a; q < b; ++q) {
          T u[NV];
          load_reals<T, NV>(contrib + (static_cast<long long>(q - q0) * WP + pt) * NV, u, true);
#pragma unroll
          for (int c = 0; c < NV; ++c) v[c] += u[c];
        }
      }
      if (off_s[kk + 1] > q1) {
#pragma unroll
        for (int c = 0; c < NV; ++c) cout[c] = v[c];
      } else if (act) {
        put(k0 + kk, v);
      }
    }
    __syncthreads();
  }
}

constexpr int PA_THREADS = 512;  // threads a block of pair_rows_adjoint_tile at most
constexpr int PA_POINTS = 32;    // points a tile: a warp's lanes
constexpr int PA_UNITS = 3;      // (point, beam) owners a thread at most, sums in registers
constexpr int PA_PAIRS = 16;     // pairs a chunk of the gradient rows
constexpr int PA_STAGES = 4;     // chunks in shared memory: one summed, three in flight
constexpr int PA_SMEM_MAX = 224 * 1024;  // of the 227 KB a block may take
constexpr int PA_MAX_CHUNKS = 1 << 12;  // the packed entry's 13 bits of chunk, sign bit clear
static_assert(PA_UNITS * PA_THREADS < (1 << 14), "the packed entry's 14 bits of beam");

// Byte offsets of pair_rows_adjoint_tile's shared memory, on the host and
// the card alike: the tile's evaluations (kc x (PA_POINTS + 1) reals; its
// gradient at the end), PA_STAGES chunks of gradient rows, the beam
// offsets and packed entries of the index, and the points' scales.
struct PaLayout {
  long long ev, g, idx, scale, total;
};

__host__ __device__ inline PaLayout pa_layout(long long kc, int P, int nidx, int C, int tsize) {
  PaLayout L;
  long long at = 0;
  L.ev = smem_take(at, kc * (PA_POINTS + 1) * tsize);
  L.g = smem_take(at, static_cast<long long>(PA_STAGES) * PA_PAIRS * C * PA_POINTS * 2 * tsize);
  L.idx = smem_take(at, (static_cast<long long>(nidx) + 1 + 2LL * P) * 4);
  L.scale = smem_take(at, static_cast<long long>(PA_POINTS) * tsize);
  L.total = at;
  return L;
}

// Chunk ``chunk``'s gradient rows into ``dst``, (PA_PAIRS * C, PA_POINTS)
// complex, by cp.async: the C rows at the tile's npt points of its pairs p
// = chunk + nch * slot, slot < PA_PAIRS.
template <typename V2, int C>
__device__ __forceinline__ void pa_load_chunk(V2* dst, const V2* __restrict__ g, int chunk,
                                              int nch, int P, int n, int b0, int npt,
                                              int tid, int nthreads) {
  const int slots = (P - chunk + nch - 1) / nch;
  for (int e = tid; e < slots * C * PA_POINTS; e += nthreads) {
    const int r = e / PA_POINTS;  // slot * C + row
    const int x = e - r * PA_POINTS;
    const int slot = r / C;
    const long long row = static_cast<long long>(chunk + nch * slot) * C + (r - slot * C);
    if (x < npt) cp_async(dst + e, g + row * n + b0 + x);
  }
}

template <typename T, int EPI, bool CPLX>
__global__ void __launch_bounds__(PA_THREADS) pair_rows_adjoint_tile(
    const T* __restrict__ ev,      // (n, kc) evaluations
    const int* __restrict__ pi,    // (P,) first beam of each pair
    const int* __restrict__ pj,    // (P,) second beam
    const int* __restrict__ index,  // (nidx + 1,) offsets by beam, then (2P,) entries
    const T* __restrict__ sky,     // real (n,) Stokes I, or complex (n, 2, 2) as reals
    const T* __restrict__ mask,    // (n,)
    const T* __restrict__ g,       // complex (P * C, n) as reals
    T* __restrict__ gev,           // (n, kc), every entry written
    int n, int K, int chf, int c0, int P, int nidx,
    long long sky_sp, long long sky_sa, long long sky_sb) {
  using V2 = typename Vec2<T>::type;
  constexpr int C = EPI == POWER ? 1 : 4;
  constexpr int NS = EPI == POWER ? 1 : 8;  // sums an owner keeps
  constexpr int PAD = PA_POINTS + 1;
  constexpr int SLAB = PA_PAIRS * C * PA_POINTS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = K * chf;  // the launcher keeps the tile within shared memory
  const int nch = (P + PA_PAIRS - 1) / PA_PAIRS;
  const PaLayout L = pa_layout(kc, P, nidx, C, sizeof(T));
  T* ev_s = reinterpret_cast<T*>(smem_raw + L.ev);
  V2* g_s = reinterpret_cast<V2*>(smem_raw + L.g);
  int* off_s = reinterpret_cast<int*>(smem_raw + L.idx);  // (nidx + 1), then the entries
  int* ent_s = off_s + nidx + 1;
  T* scale_s = reinterpret_cast<T*>(smem_raw + L.scale);
  const int b0 = blockIdx.x * PA_POINTS;
  const int npt = min(PA_POINTS, n - b0);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int by = blockDim.y;  // owner rows: beam ty + by * u, u < PA_UNITS
  const int nthreads = PA_POINTS * by;
  const int tid = ty * PA_POINTS + tx;
  const V2* gv = reinterpret_cast<const V2*>(g);

  T m = T(0), flux = T(0), cr[2][2], ci[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) cr[a][bb] = ci[a][bb] = T(0);
  }
  if (tx < npt) {
    const int b = b0 + tx;
    m = mask[b];
    const T* sk = sky + sky_sp * b;
    if constexpr (EPI == JONES_IQUV) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const T* q = sk + a * sky_sa + bb * sky_sb;
          cr[a][bb] = q[0];
          ci[a][bb] = q[1];
        }
      }
    } else {
      flux = sk[0];
    }
  }
  const bool own = tx < npt && m != T(0);
  // A tile with every point masked reads no gradient row.
  const bool live = __syncthreads_or(own);
  // The tile's evaluations, channel-major with a pad column, and the first
  // chunks' rows: all in flight at once by cp.async (the evaluations in the
  // first group), while the index stages.
  const T* src = ev + static_cast<long long>(b0) * kc;
  for (int i = tid; i < npt * kc; i += nthreads) {
    const int pt = i / kc;
    const int c = i - pt * kc;
    cp_async(ev_s + c * PAD + pt, src + i);
  }
#pragma unroll
  for (int st = 0; st < PA_STAGES - 1; ++st) {
    if (live && st < nch) {
      pa_load_chunk<V2, C>(g_s + st * SLAB, gv, st, nch, P, n, b0, npt, tid, nthreads);
    }
    cp_async_commit();
  }
  // The index, each entry packed as (other beam, slot in its chunk, role,
  // chunk): pair p sits in chunk p % nch, slot p / nch, so a chunk's pairs
  // spread over the list and over the beams.
  for (int i = tid; i <= nidx; i += nthreads) off_s[i] = min(max(index[i], 0), 2 * P);
  for (int q = tid; q < 2 * P; q += nthreads) {
    const int en = min(max(index[nidx + 1 + q], 0), 2 * P - 1);
    const int role = en >= P;
    const int p = en - role * P;
    // A malformed index reads a wrong beam, never out of bounds.
    const int other = min(max(role ? pi[p] : pj[p], 0), K - 1);
    ent_s[q] = other | (p / nch) << 14 | role << 18 | (p % nch) << 19;
  }
  if (ty == 0) scale_s[tx] = EPI == JONES_IQUV ? m : flux * m;
  __syncthreads();
  // Each owner's sums in registers, and its cursors: its beam's
  // first-role entries [qi, si), then its second-role ones [qj, sj), each
  // in chunk order (pair_index).
  T sr[PA_UNITS][NS];
  int qi[PA_UNITS], si[PA_UNITS], qj[PA_UNITS], sj[PA_UNITS];
#pragma unroll
  for (int u = 0; u < PA_UNITS; ++u) {
#pragma unroll
    for (int c = 0; c < NS; ++c) sr[u][c] = T(0);
    const int k = ty + by * u;
    const int q0 = k < K && k < nidx ? off_s[k] : 0;
    const int q1 = k < K && k < nidx ? max(off_s[k + 1], q0) : q0;
    int lo = q0, hi = q1;  // the first second-role entry
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((ent_s[mid] >> 18) & 1) hi = mid; else lo = mid + 1;
    }
    qi[u] = q0;
    si[u] = lo;
    qj[u] = lo;
    sj[u] = q1;
  }
  if (live) {
    for (int chunk = 0; chunk < nch; ++chunk) {
      cp_async_wait<PA_STAGES - 2>();
      // The chunk's rows are visible, and every thread is done with the
      // previous chunk, whose buffer the next load takes.
      __syncthreads();
      const int ahead = chunk + PA_STAGES - 1;
      if (ahead < nch) {
        pa_load_chunk<V2, C>(g_s + (ahead % PA_STAGES) * SLAB, gv, ahead, nch, P, n, b0,
                                  npt, tid, nthreads);
      }
      cp_async_commit();
      if (!own) continue;
      const V2* gs = g_s + (chunk % PA_STAGES) * SLAB + tx;
#pragma unroll
      for (int u = 0; u < PA_UNITS; ++u) {
        const int k = ty + by * u;
        if (k >= K) break;
        // The owner's entries of this chunk, first role then second.
#pragma unroll
        for (int role = 0; role < 2; ++role) {
          int q = role ? qj[u] : qi[u];
          const int q1 = role ? sj[u] : si[u];
          for (; q < q1; ++q) {
            const int v = ent_s[q];
            if ((v >> 19) != chunk) break;
            const int eo = (v & 0x3fff) * chf;
            if constexpr (EPI == POWER) {
              const T e = ev_s[(k * chf + c0) * PAD + tx];
              const T f = ev_s[(eo + c0) * PAD + tx];
              const T prod = e * f;
              if (prod > T(0)) {
                sr[u][0] += gs[((v >> 14) & 15) * PA_POINTS].x * f / (T(2) * sqrt(prod));
              }
            } else {
              const V2* gp = gs + ((v >> 14) & 15) * C * PA_POINTS;
              T xr[2][2], xi[2][2], Gr[2][2], Gi[2][2], gr[2][2], gi[2][2];
#pragma unroll
              for (int vv = 0; vv < 2; ++vv) {
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  xr[vv][f] = ev_s[(eo + vv * 2 + f) * PAD + tx];
                  xi[vv][f] = CPLX ? ev_s[(eo + 4 + vv * 2 + f) * PAD + tx] : T(0);
                  const V2 gg = gp[(vv * 2 + f) * PA_POINTS];
                  Gr[vv][f] = gg.x;
                  Gi[vv][f] = gg.y;
                  gr[vv][f] = sr[u][vv * 2 + f];
                  gi[vv][f] = sr[u][4 + vv * 2 + f];
                }
              }
              pair_adjoint_jones<T, EPI>(role == 0, xr, xi, Gr, Gi, cr, ci, gr, gi);
#pragma unroll
              for (int vv = 0; vv < 2; ++vv) {
#pragma unroll
                for (int f = 0; f < 2; ++f) {
                  sr[u][vv * 2 + f] = gr[vv][f];
                  sr[u][4 + vv * 2 + f] = gi[vv][f];
                }
              }
            }
          }
          if (role) qj[u] = q; else qi[u] = q;
        }
      }
    }
  }
  // The owners' sums into the evaluations' place, then the tile's gradient
  // out, every entry once, consecutive threads on consecutive addresses.
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kc * PAD; i += nthreads) ev_s[i] = T(0);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < PA_UNITS; ++u) {
    const int k = ty + by * u;
    if (k >= K || tx >= npt) break;
    if constexpr (EPI == POWER) {
      ev_s[(k * chf + c0) * PAD + tx] = sr[u][0];
    } else {
#pragma unroll
      for (int c = 0; c < (CPLX ? 8 : 4); ++c) ev_s[(k * chf + c) * PAD + tx] = sr[u][c];
    }
  }
  __syncthreads();
  T* out = gev + static_cast<long long>(b0) * kc;
  for (int i = tid; i < npt * kc; i += nthreads) {
    const int pt = i / kc;
    const int c = i - pt * kc;
    out[i] = ev_s[c * PAD + pt] * scale_s[pt];
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

int adjoint_tiles_x(int nx) { return (nx + ADJ_TX - 1) / ADJ_TX; }

long long adjoint_tiles(int ny, int nx) {
  return static_cast<long long>((ny + ADJ_TY - 1) / ADJ_TY) * adjoint_tiles_x(nx);
}

// Ints of the table gradient's sort scratch: the tiles' cursors, their
// offsets, the points' live flags and the lists (at most K x K tiles a
// point).
long long adjoint_scratch(int npts, int ny, int nx, int order) {
  const long long k = order == 1 ? 2 : 4;
  return 2 * adjoint_tiles(ny, nx) + 1 + static_cast<long long>(npts) * (k * k + 1);
}

template <typename T, int ORDER>
int launch_beam_eval_adjoint_order(const T* data, const T* y, const T* x, const T* g,
                                   T* gdata, T* gy, T* gx, int* scratch, int npts, int ny,
                                   int nx, int ch, int wrap, cudaStream_t s) {
  if (gdata != nullptr) {
    const int ntx = adjoint_tiles_x(nx);
    const int ntiles = static_cast<int>(adjoint_tiles(ny, nx));
    int* count = scratch;
    int* off = count + ntiles;
    int* live = off + ntiles + 1;
    int* list = live + npts;
    const cudaError_t set = cudaMemsetAsync(count, 0, sizeof(int) * ntiles, s);
    if (set != cudaSuccess) return static_cast<int>(set);
    if (npts > 0) {
      adjoint_tile_count<T, ORDER><<<blocks_for(32ll * npts, 256), 256, 0, s>>>(
          y, x, g, npts, ch, ny, nx, wrap, ntx, count, live);
    }
    adjoint_tile_scan<<<1, kAdjScanThreads, 0, s>>>(count, ntiles, off);
    if (npts > 0) {
      adjoint_tile_scatter<T, ORDER><<<blocks_for(npts, 256), 256, 0, s>>>(
          y, x, npts, ny, nx, wrap, ntx, live, off, count, list);
    }
    const dim3 grid(static_cast<unsigned int>(ntiles),
                    static_cast<unsigned int>((ch + 32 * ADJ_CHUNKS - 1) / (32 * ADJ_CHUNKS)));
    beam_eval_adjoint_points<T, ORDER><<<grid, dim3(32, ADJ_TY), 0, s>>>(
        y, x, g, off, list, gdata, ny, nx, ch, wrap, ntx);
  }
  if (gy != nullptr && npts > 0) {
    beam_eval_adjoint_coords<T, ORDER><<<blocks_for(32ll * npts, THREADS), THREADS, 0, s>>>(
        data, y, x, g, gy, gx, npts, ny, nx, ch, wrap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_beam_eval_adjoint(const void* data, const void* y, const void* x,
                             const void* g, void* gdata, void* gy, void* gx, void* scratch,
                             int npts, int ny, int nx, int ch, int order, int wrap,
                             void* stream) {
  const long long k = order == 1 ? 2 : 4;
  if ((order != 1 && order != 3) || (gy != nullptr) != (gx != nullptr) ||
      (gy != nullptr && data == nullptr) || (gdata != nullptr && scratch == nullptr) ||
      npts < 0 || ny < 1 || nx < 1 || ch < 1 || too_many(32ll * npts) ||
      too_many(adjoint_scratch(npts, ny, nx, order)) ||
      (ch + 32 * ADJ_CHUNKS - 1) / (32 * ADJ_CHUNKS) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FFTVIS_EVAL_ADJ(ORD)                                                              \
  launch_beam_eval_adjoint_order<T, ORD>(                                                 \
      static_cast<const T*>(data), static_cast<const T*>(y), static_cast<const T*>(x),     \
      static_cast<const T*>(g), static_cast<T*>(gdata), static_cast<T*>(gy),              \
      static_cast<T*>(gx), static_cast<int*>(scratch), npts, ny, nx, ch, wrap, s)
  return order == 1 ? FFTVIS_EVAL_ADJ(1) : FFTVIS_EVAL_ADJ(3);
#undef FFTVIS_EVAL_ADJ
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

// The forms of pair_rows and of its adjoint, as the host picks them
// (beams/eval.py pair_rows_form): the tile forms (pair_rows_points,
// pair_rows_adjoint_tile) and the wide forms with their rows staged in
// shared memory (WIDE) or read from device memory (WIDE_GLOBAL).
enum PairForm { FORM_TILE = 0, FORM_WIDE = 1, FORM_WIDE_GLOBAL = 2 };

// Whether pair_rows_adjoint_tile takes these shapes: its shared memory
// fits, a thread row a beam needs at most PA_UNITS beams a row, and the
// packed entries hold the chunks.
bool pa_tile_form(long long bytes, int K, int P) {
  return bytes <= PA_SMEM_MAX && K <= PA_UNITS * (PA_THREADS / PA_POINTS) &&
         (P + PA_PAIRS - 1) / PA_PAIRS <= PA_MAX_CHUNKS;
}

// Dynamic shared memory a form of pair_rows (adjoint false) or of its
// adjoint takes for these shapes (C rows a pair: 1 power, 4 Jones), or -1
// where the form cannot take them.
long long pair_form_smem(bool adjoint, int form, int K, int chf, int P, int nidx, int C,
                         int tsize) {
  const long long kc = static_cast<long long>(K) * chf;
  long long bytes = -1;
  if (form == FORM_TILE && !adjoint) {
    bytes = kc * (TP + 1) * tsize;
    if (bytes > SMEM_MAX) bytes = -1;
  } else if (form == FORM_TILE) {
    bytes = pa_layout(kc, P, nidx, C, tsize).total;
    if (!pa_tile_form(bytes, K, P)) bytes = -1;
  } else if (form == FORM_WIDE && !adjoint) {
    bytes = wide_smem(kc, tsize, wide_points(false, tsize));
    if (bytes > WIDE_SMEM_MAX) bytes = -1;
  } else if (form == FORM_WIDE_GLOBAL && !adjoint) {
    bytes = 0;
  } else if (form == FORM_WIDE) {
    bytes = wide_adj_layout(K, C == 1 ? 1 : chf, tsize).total;
    if (bytes > WIDE_SMEM_MAX) bytes = -1;
  }
  return bytes;
}

// Above 48 KB a kernel must opt in to its dynamic shared memory, once: a
// flag of the launching template's own for each kernel it launches.
template <typename F>
void opt_in(bool& done, F* kernel, int bytes) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done = true;
  }
}

// Blocks of a launch: ``tiles`` tiles of points, and enough groups of a
// tile's ``items`` (pairs or beams) over ``lanes`` thread rows for
// ``per_sm`` blocks a SM. Returns the items a group takes.
int pair_groups(long long tiles, int items, int lanes, int per_sm, unsigned int& groups_out) {
  const long long most = (static_cast<long long>(items) + lanes - 1) / lanes;
  long long groups = (static_cast<long long>(per_sm) * sm_count() + tiles - 1) / tiles;
  groups = groups < most ? groups : most;
  groups = groups < 65535 ? groups : 65535;
  groups = groups > 1 ? groups : 1;
  const int per = static_cast<int>((items + groups - 1) / groups);
  groups_out = static_cast<unsigned int>((items + per - 1) / per);
  return per;
}

template <typename T, int EPI, bool CPLX>
void pair_rows_launch(int form, long long smem, cudaStream_t s, const T* ev, const int* pi,
                      const int* pj, const T* sky, const T* mask, T* out, int n, int K,
                      int chf, int c0, int P, int vec, long long sp, long long sa,
                      long long sb) {
  if (form == FORM_TILE) {
    static bool opted = false;
    opt_in(opted, pair_rows_points<T, EPI, CPLX>, SMEM_MAX);
    const long long tiles = (n + TP - 1) / TP;
    unsigned int groups;
    const int ppb = pair_groups(tiles, P, PY, 2, groups);
    const dim3 grid(static_cast<unsigned int>(tiles), groups);
    pair_rows_points<T, EPI, CPLX><<<grid, dim3(TP, PY), smem, s>>>(
        ev, pi, pj, sky, mask, out, n, K, chf, c0, P, ppb, sp, sa, sb);
    return;
  }
  constexpr int WP = wide_points(false, sizeof(T));
  const long long tiles = (n + WP - 1) / WP;
  unsigned int groups;
  // The staged form's rows hold one block an SM: a second group of a tile
  // would stage them again.
  const int ppb = pair_groups(tiles, P, WIDE_THREADS / WP, form == FORM_WIDE ? 1 : 2, groups);
  const dim3 grid(static_cast<unsigned int>(tiles), groups);
  if (form == FORM_WIDE) {
    static bool opted = false;
    opt_in(opted, pair_rows_wide<T, EPI, CPLX, true>, WIDE_SMEM_MAX);
    pair_rows_wide<T, EPI, CPLX, true><<<grid, WIDE_THREADS, smem, s>>>(
        ev, pi, pj, sky, mask, out, n, K, chf, c0, P, ppb, vec, sp, sa, sb);
  } else {
    pair_rows_wide<T, EPI, CPLX, false><<<grid, WIDE_THREADS, 0, s>>>(
        ev, pi, pj, sky, mask, out, n, K, chf, c0, P, ppb, vec, sp, sa, sb);
  }
}

template <typename T>
int launch_pair_rows(const void* ev, const void* pi, const void* pj, const void* sky,
                     const void* mask, void* out, int n, int K, int chf, int c0,
                     int P, int epi, int cplx, int form, long long sp, long long sa,
                     long long sb, void* stream) {
  const bool power = epi == POWER;
  if (K < 1 || chf < 1 || P < 0 || n < 0 || (epi != POWER && epi != JONES_I &&
                                               epi != JONES_IQUV) ||
      (power && (c0 < 0 || c0 >= chf)) || (!power && chf != (cplx ? 8 : 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      pair_form_smem(false, form, K, chf, P, K, power ? 1 : 4, static_cast<int>(sizeof(T)));
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* e = static_cast<const T*>(ev);
  const int* ii = static_cast<const int*>(pi);
  const int* jj = static_cast<const int*>(pj);
  const T* k = static_cast<const T*>(sky);
  const T* m = static_cast<const T*>(mask);
  T* o = static_cast<T*>(out);
  // The wide forms' 16-byte copies and loads: aligned rows.
  const int vec = static_cast<long long>(K) * chf * sizeof(T) % 16 == 0 && aligned16(ev);
#define FFTVIS_PAIRS(EPI, CPLX) \
  pair_rows_launch<T, EPI, CPLX>(form, smem, s, e, ii, jj, k, m, o, n, K, chf, c0, P, vec, sp, \
                                 sa, sb)
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

template <typename T, int EPI, bool CPLX>
void pair_rows_adjoint_launch(int form, long long smem, cudaStream_t s, const T* ev,
                              const int* pi, const int* pj, const int* index, const T* sky,
                              const T* mask, const T* g, T* gev, int n, int K, int chf,
                              int c0, int P, int nidx, int vec, long long sp, long long sa,
                              long long sb) {
  if (form == FORM_TILE) {
    static bool opted = false;
    opt_in(opted, pair_rows_adjoint_tile<T, EPI, CPLX>, PA_SMEM_MAX);
    // A thread row a beam, up to PA_UNITS beams a row.
    const int by = min(K, PA_THREADS / PA_POINTS);
    pair_rows_adjoint_tile<T, EPI, CPLX>
        <<<(n + PA_POINTS - 1) / PA_POINTS, dim3(PA_POINTS, by), smem, s>>>(
            ev, pi, pj, index, sky, mask, g, gev, n, K, chf, c0, P, nidx, sp, sa, sb);
    return;
  }
  constexpr int WP = wide_points(true, sizeof(T));
  const long long tiles = (n + WP - 1) / WP;
  unsigned int groups;
  const int kpb = pair_groups(tiles, K, WIDE_THREADS / WP, 2, groups);
  const dim3 grid(static_cast<unsigned int>(tiles), groups);
  static bool opted = false;
  opt_in(opted, pair_rows_adjoint_wide<T, EPI, CPLX>, WIDE_SMEM_MAX);
  pair_rows_adjoint_wide<T, EPI, CPLX><<<grid, WIDE_THREADS, smem, s>>>(
      ev, pi, pj, index, sky, mask, g, gev, n, K, chf, c0, P, nidx, kpb, vec, sp, sa, sb);
}

template <typename T>
int launch_pair_rows_adjoint(const void* ev, const void* pi, const void* pj,
                             const void* index, const void* sky, const void* mask,
                             const void* g, void* gev, int n, int K, int chf, int c0, int P,
                             int nidx, int epi, int cplx, int chunk, int form, long long sp,
                             long long sa, long long sb, void* stream) {
  const bool power = epi == POWER;
  if (K < 1 || chf < 1 || P < 0 || n < 0 || nidx < 0 || nidx > K ||
      (epi != POWER && epi != JONES_I && epi != JONES_IQUV) ||
      (power && (c0 < 0 || c0 >= chf)) || (!power && chf != (cplx ? 8 : 4)) ||
      chunk != PA_PAIRS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem =
      pair_form_smem(true, form, K, chf, P, nidx, power ? 1 : 4, static_cast<int>(sizeof(T)));
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* e = static_cast<const T*>(ev);
  const int* ii = static_cast<const int*>(pi);
  const int* jj = static_cast<const int*>(pj);
  const int* ix = static_cast<const int*>(index);
  const T* k = static_cast<const T*>(sky);
  const T* m = static_cast<const T*>(mask);
  const T* gg = static_cast<const T*>(g);
  T* o = static_cast<T*>(gev);
  // The wide form's 16-byte copies, loads and stores: aligned rows.
  const int vec = static_cast<long long>(K) * chf * sizeof(T) % 16 == 0 && aligned16(ev) &&
                  aligned16(gev);
#define FFTVIS_PA(EPI, CPLX)                                                                \
  pair_rows_adjoint_launch<T, EPI, CPLX>(form, smem, s, e, ii, jj, ix, k, m, gg, o, n, K, chf, \
                                         c0, P, nidx, vec, sp, sa, sb)
  if (power) {
    FFTVIS_PA(POWER, false);
  } else if (epi == JONES_I) {
    if (cplx) { FFTVIS_PA(JONES_I, true); } else { FFTVIS_PA(JONES_I, false); }
  } else {
    if (cplx) { FFTVIS_PA(JONES_IQUV, true); } else { FFTVIS_PA(JONES_IQUV, false); }
  }
#undef FFTVIS_PA
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The adjoint of pair_rows in its evaluations: g (P * C, n) complex ->
// gev (n, K * chf); index the per-beam entries (nidx + 1 offsets, 2P
// entries, each beam's in chunk order); chunk the pairs a chunk that
// pair_index ordered by (PA_PAIRS); form a PairForm.
extern "C" int fftvis_pair_rows_adjoint_f32(
    const void* ev, const void* pi, const void* pj, const void* index, const void* sky,
    const void* mask, const void* g, void* gev, int n, int K, int chf, int c0, int P,
    int nidx, int epi, int cplx, int chunk, int form, long long sp, long long sa,
    long long sb, void* stream) {
  return launch_pair_rows_adjoint<float>(ev, pi, pj, index, sky, mask, g, gev, n, K, chf, c0,
                                         P, nidx, epi, cplx, chunk, form, sp, sa, sb, stream);
}

extern "C" int fftvis_pair_rows_adjoint_f64(
    const void* ev, const void* pi, const void* pj, const void* index, const void* sky,
    const void* mask, const void* g, void* gev, int n, int K, int chf, int c0, int P,
    int nidx, int epi, int cplx, int chunk, int form, long long sp, long long sa,
    long long sb, void* stream) {
  return launch_pair_rows_adjoint<double>(ev, pi, pj, index, sky, mask, g, gev, n, K, chf,
                                          c0, P, nidx, epi, cplx, chunk, form, sp, sa, sb,
                                          stream);
}

// Dynamic shared memory a form (a PairForm) of pair_rows (adjoint 0) or of
// its adjoint (1) takes for these shapes (C rows a pair: 1 power, 4 Jones),
// or -1 where that form cannot take them: what the host's pair_rows_form
// picks from.
extern "C" long long fftvis_pair_rows_smem(int adjoint, int form, int K, int chf, int P,
                                           int nidx, int C, int f64) {
  return pair_form_smem(adjoint != 0, form, K, chf, P, nidx, C, f64 ? 8 : 4);
}

// Ints of scratch beam_eval_adjoint's table gradient needs.
extern "C" long long fftvis_beam_eval_adjoint_scratch(int npts, int ny, int nx, int order) {
  return adjoint_scratch(npts, ny, nx, order);
}

extern "C" int fftvis_pair_rows_f32(const void* ev, const void* pi, const void* pj,
                                    const void* sky, const void* mask, void* out, int n,
                                    int K, int chf, int c0, int P, int epi, int cplx,
                                    int form, long long sp, long long sa, long long sb,
                                    void* stream) {
  return launch_pair_rows<float>(ev, pi, pj, sky, mask, out, n, K, chf, c0, P, epi,
                                 cplx, form, sp, sa, sb, stream);
}

extern "C" int fftvis_pair_rows_f64(const void* ev, const void* pi, const void* pj,
                                    const void* sky, const void* mask, void* out, int n,
                                    int K, int chf, int c0, int P, int epi, int cplx,
                                    int form, long long sp, long long sa, long long sb,
                                    void* stream) {
  return launch_pair_rows<double>(ev, pi, pj, sky, mask, out, n, K, chf, c0, P, epi,
                                  cplx, form, sp, sa, sb, stream);
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

// The adjoint: g (npts, ch) -> gdata (ny, nx, ch), unless null (every
// entry written; scratch the sort's fftvis_beam_eval_adjoint_scratch
// ints), and unless gy and gx are null, gy, gx (npts,); data is read only
// for gy, gx.
extern "C" int fftvis_beam_eval_adjoint_f32(const void* data, const void* y,
                                            const void* x, const void* g,
                                            void* gdata, void* gy, void* gx, void* scratch,
                                            int npts, int ny, int nx, int ch,
                                            int order, int wrap, void* stream) {
  return launch_beam_eval_adjoint<float>(data, y, x, g, gdata, gy, gx, scratch, npts, ny,
                                         nx, ch, order, wrap, stream);
}

extern "C" int fftvis_beam_eval_adjoint_f64(const void* data, const void* y,
                                            const void* x, const void* g,
                                            void* gdata, void* gy, void* gx, void* scratch,
                                            int npts, int ny, int nx, int ch,
                                            int order, int wrap, void* stream) {
  return launch_beam_eval_adjoint<double>(data, y, x, g, gdata, gy, gx, scratch, npts, ny,
                                          nx, ch, order, wrap, stream);
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
