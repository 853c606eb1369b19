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
// interp_adjoint_tiles is the adjoint with respect to G, what a gradient
// through the interpolation needs (the JAX package lets XLA differentiate
// its gather; no Pallas kernel has a backward):
//
//     gG[c, iy[t, a], ix[t, b]] = sum over t of vy[t, a] vx[t, b] g[c, t]
//
// What held its first form (interp_adjoint_runs, a warp a run scattering
// with atomics) back: the wrapper zero-filled the whole (C, nfy, nfx) grid
// first, which at the slice took longer than the kernel (0.12 / 0.25 ms
// of a 0.18 / 0.45 ms call, f32 / f64, C = 4); the channel loop sat outside
// the row loop, so a run's taps and order were read C times in a chain of
// dependent loads; and the fp64 atomics added in an order that changed
// from run to run, so the gradient was not repeatable. Here the grid
// gradient is owned, not scattered. The host lists, once a set of tables
// (nufft/interp.py grid_tiles), for every 32 x 32 tile of the grid the
// runs whose w x w footprint touches it, periodic wrap included, each as
// a rectangle of the footprint within the tile, in run order. One block
// owns a tile and adj_cg channels and:
// - takes its list in chunks whose rectangles fit ADJ_CAP staged cells;
// - stages each rectangle's cells, for all its channels: a thread a 2 x 2
//   patch of cells (its entry from a byte map that the entries' warps mark
//   first) sums the run's rows, vy vx g, with the channel loop inside the
//   row loop: a row's order and gradient are read once for 4 cells and
//   every channel, into shared memory;
// - then each thread adds the staged cells that land on its own 4 cells,
//   in list order: a fixed order, no atomic, a bitwise repeatable gradient;
// - writes every cell of its tile once, zeros included, a warp a tile row
//   (coalesced 8- or 16-byte stores). An empty tile (most of a redundant
//   array's grid) takes only the stores.
// So the wrapper allocates with torch.empty and launches no fill, and a
// caller can hand it a channel slice of a larger gradient to write. Bound:
// the (C, nfy, nfx) grid written once, the tables, order and the (C, m)
// gradient read once: the grid's write dominates (0.127 ms at the slice's
// p=1 grid in complex64, 0.261 ms at p=2 in complex128, C = 4).
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
//
// interp_sm_3d is the D = 3 interpolation redesigned for Hopper. What holds
// interp_taps_nd back: its warps take the targets in input order, so each
// of a target's w^3 (~2,700 at w = 14) taps is a read from L2, and
// neighbouring warps hit unrelated cells (4.4 GB of L2 traffic at 10^5
// targets in complex128). Here the host orders the targets once, at plan
// time, by the 3D bin of their first tap cell (nufft/interp.py
// bin_order_3d: a permutation, kept with the plan's tap tables, and CSR
// offsets of the nonempty bins cut into pieces of at most 64 targets), and:
// - one block takes one piece of one channel (blockIdx.y). It loads the
//   bin's padded tile, (B + w - 1)^3 cells wrapped periodically, into
//   dynamic shared memory with coalesced 8- or 16-byte loads, once;
// - it stages the piece's tap values, first cells and order in shared
//   memory too (its rows are contiguous in the tables: coalesced loads);
// - its warps take the piece's targets, one a warp, the lanes over the
//   w x w (axis-1, axis-2) taps and a loop over axis 0, as interp_taps_nd
//   does, but every tap and weight reads shared memory; a __shfl_xor_sync
//   reduction sums the target, and lane 0 writes out[c, order[k]], so the
//   caller sees target order.
// A plan's taps are w consecutive cells (mod n) from the first, so a target
// reads tile cells l + k. B is bins.cuh's edge (the host's order must use
// it). Where an axis is shorter than the tile, or where the host's
// measured choice (nufft/interp.py _sm_pays) finds interp_taps_nd faster,
// the host plans no order and interp_taps_nd stays. A target whose
// first cell lies outside its block's bin (malformed offsets) reads its
// taps from the grid through its tables: wrong order, never an access out
// of bounds. Bound: as interp_taps_nd's.

#include <cuda_runtime.h>

#include "bins.cuh"

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

// The owned-tile form of the adjoint (interp_adjoint_tiles): a block owns
// a TILE x TILE tile of the grid and adj_cg channels of it.
constexpr int ADJ_TILE = 32;                 // tile edge (nufft/interp.py TILE)
constexpr int ADJ_THREADS = 256;             // a warp a tile row, 4 rows a thread
constexpr int ADJ_ROWS = ADJ_TILE * ADJ_TILE / ADJ_THREADS;
// Channels a block: 4 at complex64, 2 at complex128 (whose staged sums
// hold twice the registers; the faster of 2 and 4 on the card, PERF.md
// row 6).
template <typename T>
__host__ __device__ constexpr int adj_cg() { return sizeof(T) == 8 ? 2 : 4; }
constexpr int ADJ_CAP = 2048;                // staged footprint cells a chunk (>= 16 x 16)
// Blocks an SM the registers must allow: 2 at complex64; 1 at complex128,
// whose accumulators then stay in registers (faster on the card than 2
// blocks with spills).
template <typename T>
constexpr int adj_min_blocks() { return sizeof(T) == 8 ? 1 : 2; }
static_assert(ADJ_THREADS <= 256, "an entry's index in a chunk is one byte");

template <typename T>
constexpr int adj_smem_bytes() {
  constexpr int CG = adj_cg<T>();
  return CG * ADJ_CAP * 2 * static_cast<int>(sizeof(T)) + ADJ_THREADS * 20 +
         ADJ_THREADS / 32 * 4 + ADJ_CAP;
}

template <typename T>
__global__ void __launch_bounds__(ADJ_THREADS, adj_min_blocks<T>()) interp_adjoint_tiles(
    const T* __restrict__ g,          // (C, m, 2) gradient, target order
    const T* __restrict__ vy,         // (m, w), row k in visiting order
    const T* __restrict__ vx,         // (m, w)
    const int* __restrict__ order,    // (m,) target of row k, or null
    const int* __restrict__ toff,     // (ntiles + 1,) each tile's first entry
    const int4* __restrict__ tent,    // (nent,) {k0, k1, geometry, staged before}
    T* __restrict__ grid,             // (C, nfy, nfx, 2), every cell written
    int C, int nfy, int nfx, int m, int w, int ntx, int nent) {
  using V = typename Vec2<T>::type;
  constexpr int CG = adj_cg<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* staged = reinterpret_cast<V*>(smem_raw);                        // (CG, ADJ_CAP)
  int4* ents = reinterpret_cast<int4*>(staged + CG * ADJ_CAP);   // (ADJ_THREADS,)
  int* patch0 = reinterpret_cast<int*>(ents + ADJ_THREADS);          // (ADJ_THREADS,)
  int* warp_sum = patch0 + ADJ_THREADS;                              // (ADJ_THREADS / 32,)
  unsigned char* cell_ent = reinterpret_cast<unsigned char*>(warp_sum + ADJ_THREADS / 32);  // (ADJ_CAP,)
  const int tile = blockIdx.x;
  const int y0 = tile / ntx * ADJ_TILE;
  const int x0 = tile % ntx * ADJ_TILE;
  const int c0 = blockIdx.y * CG;
  const int ncg = min(CG, C - c0);
  const int lx = threadIdx.x % ADJ_TILE;
  const int ly = threadIdx.x / ADJ_TILE;  // rows ly + i * ADJ_TILE / ADJ_ROWS
  const V* gv = reinterpret_cast<const V*>(g) + static_cast<long long>(c0) * m;
  T accr[ADJ_ROWS][CG], acci[ADJ_ROWS][CG];
#pragma unroll
  for (int i = 0; i < ADJ_ROWS; ++i) {
#pragma unroll
    for (int c = 0; c < CG; ++c) accr[i][c] = acci[i][c] = T(0);
  }
  const int e0 = min(max(toff[tile], 0), nent);
  const int e1 = min(max(toff[tile + 1], e0), nent);
  for (int eb = e0; eb < e1;) {
    // A chunk: the list's next entries whose staged cells fit ADJ_CAP.
    const int base = tent[eb].w;
    const int q = eb + threadIdx.x;
    bool fits = false;
    if (q < e1) {
      const int4 e = tent[q];
      const int size = (((e.z >> 14) & 15) + 1) * (((e.z >> 22) & 15) + 1);
      fits = e.w - base >= 0 && e.w - base + size <= ADJ_CAP;
      ents[threadIdx.x] = e;
    }
    const int n = __syncthreads_count(fits);
    if (n == 0) break;  // a malformed list: stop, the tile keeps what it has
    const int4 last = ents[n - 1];
    const int total = min(last.w - base + (((last.z >> 14) & 15) + 1) *
                                              (((last.z >> 22) & 15) + 1), ADJ_CAP);
    // The entries' 2 x 2 patches of cells: each entry's count and first
    // patch (a block scan), then each patch's entry (a byte map that a warp
    // an entry marks).
    int pcount = 0;
    if (threadIdx.x < n) {
      const int4 e = ents[threadIdx.x];
      pcount = ((((e.z >> 14) & 15) + 2) >> 1) * ((((e.z >> 22) & 15) + 2) >> 1);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int incl = pcount;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = lane < ADJ_THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += y;
      }
      if (lane < ADJ_THREADS / 32) warp_sum[lane] = v;
    }
    __syncthreads();
    patch0[threadIdx.x] = incl - pcount + (warp > 0 ? warp_sum[warp - 1] : 0);
    const int npatch = min(warp_sum[ADJ_THREADS / 32 - 1], ADJ_CAP);
    __syncthreads();
    for (int j = warp; j < n; j += ADJ_THREADS / 32) {
      const int first = patch0[j];
      const int4 e = ents[j];
      const int cnt = ((((e.z >> 14) & 15) + 2) >> 1) * ((((e.z >> 22) & 15) + 2) >> 1);
      for (int l = lane; l < cnt; l += 32) {
        if (first + l < ADJ_CAP) cell_ent[first + l] = static_cast<unsigned char>(j);
      }
    }
    __syncthreads();
    // Stage: a thread a 2 x 2 patch of an entry's rectangle sums the run's
    // rows, vy vx g, for all the block's channels: a row's order and
    // gradient read once for 4 cells, the taps once for 2, four independent
    // sums a channel.
    for (int pt = threadIdx.x; pt < npatch; pt += ADJ_THREADS) {
      const int j = cell_ent[pt];
      const int4 e = ents[j];
      const int na = ((e.z >> 14) & 15) + 1;
      const int nb = ((e.z >> 22) & 15) + 1;
      const int lp = pt - patch0[j];
      const int npb = (nb + 1) >> 1;
      const int la = 2 * (lp / npb);  // the patch's first cell in the rectangle
      const int lb = 2 * (lp % npb);
      const int a = ((e.z >> 10) & 15) + la;
      const int b = ((e.z >> 18) & 15) + lb;
      const bool a1 = la + 1 < na && a + 1 < w;  // the patch's second row and column
      const bool b1 = lb + 1 < nb && b + 1 < w;
      T re[4][CG], im[4][CG];
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
#pragma unroll
        for (int c = 0; c < CG; ++c) re[q4][c] = im[q4][c] = T(0);
      }
      if (lp >= 0 && a < w && b < w) {
        const int k1 = min(e.y, m);
        for (int k = max(e.x, 0); k < k1; ++k) {
          const long long row = static_cast<long long>(k) * w;
          const int t0 = order ? order[k] : k;
          const bool ok = t0 >= 0 && t0 < m;
          const int t = ok ? t0 : 0;
          const T y0v = ok ? vy[row + a] : T(0);
          const T y1v = ok && a1 ? vy[row + a + 1] : T(0);
          const T x0v = vx[row + b];
          const T x1v = b1 ? vx[row + b + 1] : T(0);
          const T wt[4] = {y0v * x0v, y0v * x1v, y1v * x0v, y1v * x1v};
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            if (c < ncg) {
              const V gk = gv[static_cast<long long>(c) * m + t];
#pragma unroll
              for (int q4 = 0; q4 < 4; ++q4) {
                re[q4][c] += wt[q4] * gk.x;
                im[q4][c] += wt[q4] * gk.y;
              }
            }
          }
        }
      }
      const int off = e.w - base;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int da = q4 >> 1;
        const int db = q4 & 1;
        const int sc = off + (la + da) * nb + lb + db;  // the cell's staged slot
        if (la + da < na && lb + db < nb && sc >= 0 && sc < total) {
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            V o;
            o.x = re[q4][c];
            o.y = im[q4][c];
            staged[c * ADJ_CAP + sc] = o;
          }
        }
      }
    }
    __syncthreads();
    // Owners: each thread adds the staged cells on its own cells, in list
    // order.
    for (int j = 0; j < n; ++j) {
      const int4 e = ents[j];
      const int dj = lx - ((e.z >> 5) & 31);
      const int nb = ((e.z >> 22) & 15) + 1;
      if (dj < 0 || dj >= nb) continue;
      const int na = ((e.z >> 14) & 15) + 1;
      const int ly0 = e.z & 31;
      const int off = e.w - base;
#pragma unroll
      for (int i = 0; i < ADJ_ROWS; ++i) {
        const int di = ly + i * (ADJ_TILE / ADJ_ROWS) - ly0;
        const int idx = off + di * nb + dj;
        if (di >= 0 && di < na && idx >= 0 && idx < total) {
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            const V v = staged[c * ADJ_CAP + idx];
            accr[i][c] += v.x;
            acci[i][c] += v.y;
          }
        }
      }
    }
    __syncthreads();
    eb += n;
  }
  // Every cell of the tile, zeros included: a warp writes a tile row.
  const long long plane = static_cast<long long>(nfy) * nfx;
  V* gridv = reinterpret_cast<V*>(grid) + c0 * plane;
  const int x = x0 + lx;
#pragma unroll
  for (int i = 0; i < ADJ_ROWS; ++i) {
    const int y = y0 + ly + i * (ADJ_TILE / ADJ_ROWS);
    if (y < nfy && x < nfx) {
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        if (c < ncg) {
          V o;
          o.x = accr[i][c];
          o.y = acci[i][c];
          gridv[c * plane + static_cast<long long>(y) * nfx + x] = o;
        }
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

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The shared memory of interp_sm_3d: the (P, P, P) tile, then a piece's
// tables (sub targets a round).
template <typename T>
constexpr long long sm_bytes(int P, int W, int sub) {
  return static_cast<long long>(P) * P * P * 2 * sizeof(T) +
         static_cast<long long>(sub) * (3 * W * sizeof(T) + 4 * sizeof(int));
}

template <typename T, int W>
__global__ void __launch_bounds__(WARPS * 32) interp_sm_3d(
    const T* __restrict__ G,          // (C, n0, n1, n2, 2) interleaved re/im
    const int* __restrict__ i0,       // (m, W) axis-0 taps, rows in bin order
    const int* __restrict__ i1,       // (m, W)
    const int* __restrict__ i2,       // (m, W)
    const T* __restrict__ v0,         // (m, W)
    const T* __restrict__ v1,         // (m, W)
    const T* __restrict__ v2,         // (m, W)
    const int* __restrict__ order,    // (m,) row k is target order[k]
    const int* __restrict__ off,      // (npieces + 1,) CSR offsets of the pieces
    T* __restrict__ out,              // (C, m, 2) interleaved re/im
    int C, int n0, int n1, int n2, int m, int B, int sub) {
  using V = typename Vec2<T>::type;
  constexpr int STEPS = (W * W + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = B + W - 1;
  const int PP = P * P;
  V* tile = reinterpret_cast<V*>(smem_raw);                // (P, P, P)
  T* val_s = reinterpret_cast<T*>(tile + PP * P);          // (sub, 3, W)
  int* first_s = reinterpret_cast<int*>(val_s + sub * 3 * W);  // (sub, 3)
  int* order_s = first_s + sub * 3;                        // (sub,)
  const int k0 = max(off[blockIdx.x], 0);
  const int k1 = min(off[blockIdx.x + 1], m);
  if (k0 >= k1) return;
  const int c = blockIdx.y;
  const long long row0 = static_cast<long long>(k0) * W;
  const int s0 = i0[row0] / B * B;
  const int s1 = i1[row0] / B * B;
  const int s2 = i2[row0] / B * B;
  const long long slab = static_cast<long long>(n1) * n2;
  const V* Gc = reinterpret_cast<const V*>(G) + c * (n0 * slab);
  for (int i = threadIdx.x; i < PP * P; i += blockDim.x) {
    const int q0 = i / PP;
    const int q1 = i / P % P;
    const int q2 = i % P;
    tile[i] = Gc[wrap(s0 + q0, n0) * slab + static_cast<long long>(wrap(s1 + q1, n1)) * n2 +
                 wrap(s2 + q2, n2)];
  }

  const int lane = threadIdx.x & 31;
  V* outv = reinterpret_cast<V*>(out);
  for (int base = k0; base < k1; base += sub) {
    const int cnt = min(sub, k1 - base);
    // Stage the round's tables: its rows are contiguous in every table.
    const long long r0 = static_cast<long long>(base) * W;
    for (int t = threadIdx.x; t < cnt * W; t += blockDim.x) {
      val_s[(t / W * 3 + 0) * W + t % W] = v0[r0 + t];
      val_s[(t / W * 3 + 1) * W + t % W] = v1[r0 + t];
      val_s[(t / W * 3 + 2) * W + t % W] = v2[r0 + t];
    }
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const long long row = r0 + static_cast<long long>(t) * W;
      first_s[t * 3 + 0] = i0[row] - s0;
      first_s[t * 3 + 1] = i1[row] - s1;
      first_s[t * 3 + 2] = i2[row] - s2;
      order_s[t] = order[base + t];
    }
    __syncthreads();
    for (int j = threadIdx.x >> 5; j < cnt; j += blockDim.x >> 5) {
      const int l0 = first_s[j * 3 + 0];
      const int l1 = first_s[j * 3 + 1];
      const int l2 = first_s[j * 3 + 2];
      const bool inside = l0 >= 0 && l0 < B && l1 >= 0 && l1 < B && l2 >= 0 && l2 < B;
      const T* vj = val_s + j * 3 * W;
      const long long row = r0 + static_cast<long long>(j) * W;
      long long offs[STEPS];
      T wt[STEPS];
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int tap = s * 32 + lane;
        const bool ok = tap < W * W;
        const int b = ok ? tap / W : 0;
        const int e = ok ? tap % W : 0;
        wt[s] = ok ? vj[W + b] * vj[2 * W + e] : T(0);
        offs[s] = inside ? (l1 + b) * P + (l2 + e)
                         : static_cast<long long>(i1[row + b]) * n2 + i2[row + e];
      }
      T re = T(0);
      T im = T(0);
      for (int a = 0; a < W; ++a) {
        const T wa = vj[a];
        T tr = T(0);
        T ti = T(0);
        if (inside) {
          const V* ta = tile + (l0 + a) * PP;
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            const V g = ta[offs[s]];
            tr += g.x * wt[s];
            ti += g.y * wt[s];
          }
        } else {
          const V* ga = Gc + i0[row + a] * slab;
#pragma unroll
          for (int s = 0; s < STEPS; ++s) {
            const V g = ga[offs[s]];
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
      const int t = order_s[j];
      if (lane == 0 && t >= 0 && t < m) {
        V o;
        o.x = re;
        o.y = im;
        outv[c * static_cast<long long>(m) + t] = o;
      }
    }
    __syncthreads();
  }
}

template <typename T, int W>
int launch_sm_w(const void* G, const void* i0, const void* i1, const void* i2,
                const void* v0, const void* v1, const void* v2, const void* order,
                const void* off, void* out, int C, int n0, int n1, int n2, int m,
                int nbins, int B, cudaStream_t stream) {
  if (B != fftvis_bins::bin_edge<T>(W) || C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Targets staged a round: up to 64, as many as keep the tile and the
  // round within kTileBytes, so that two blocks share an SM (at least 8).
  int sub = 64;
  while (sub > 8 && sm_bytes<T>(B + W - 1, W, sub) > fftvis_bins::kTileBytes) sub /= 2;
  const long long smem = sm_bytes<T>(B + W - 1, W, sub);
  const cudaError_t attr = cudaFuncSetAttribute(
      interp_sm_3d<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 blocks(static_cast<unsigned int>(nbins), static_cast<unsigned int>(C));
  interp_sm_3d<T, W><<<blocks, WARPS * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(G), static_cast<const int*>(i0), static_cast<const int*>(i1),
      static_cast<const int*>(i2), static_cast<const T*>(v0), static_cast<const T*>(v1),
      static_cast<const T*>(v2), static_cast<const int*>(order), static_cast<const int*>(off),
      static_cast<T*>(out), C, n0, n1, n2, m, B, sub);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_sm(const void* G, const void* i0, const void* i1, const void* i2,
                     const void* v0, const void* v1, const void* v2, const void* order,
                     const void* off, void* out, int C, int n0, int n1, int n2, int m,
                     int nbins, int w, int B, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (w) {
#define FFTVIS_INTERP_SM_CASE(W)                                                    \
  case W:                                                                           \
    return launch_sm_w<T, W>(G, i0, i1, i2, v0, v1, v2, order, off, out, C, n0, n1, \
                             n2, m, nbins, B, stream);
    FFTVIS_INTERP_SM_CASE(2) FFTVIS_INTERP_SM_CASE(3) FFTVIS_INTERP_SM_CASE(4)
    FFTVIS_INTERP_SM_CASE(5) FFTVIS_INTERP_SM_CASE(6) FFTVIS_INTERP_SM_CASE(7)
    FFTVIS_INTERP_SM_CASE(8) FFTVIS_INTERP_SM_CASE(9) FFTVIS_INTERP_SM_CASE(10)
    FFTVIS_INTERP_SM_CASE(11) FFTVIS_INTERP_SM_CASE(12) FFTVIS_INTERP_SM_CASE(13)
    FFTVIS_INTERP_SM_CASE(14) FFTVIS_INTERP_SM_CASE(15) FFTVIS_INTERP_SM_CASE(16)
#undef FFTVIS_INTERP_SM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
int launch_interp_adjoint(const void* g, const void* vy, const void* vx, const void* order,
                          const void* toff, const void* tent, void* grid, int C, int nfy,
                          int nfx, int m, int w, int ntiles, int nent, void* stream_ptr) {
  const int nty = (nfy + ADJ_TILE - 1) / ADJ_TILE;
  const int ntx = (nfx + ADJ_TILE - 1) / ADJ_TILE;
  const int groups = (C + adj_cg<T>() - 1) / adj_cg<T>();
  if (C < 1 || nfy < 1 || nfx < 1 || m < 0 || w < 2 || w > 16 || nent < 0 ||
      static_cast<long long>(nty) * ntx != ntiles || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Above 48 KB a kernel must opt in to its dynamic shared memory.
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t attr = cudaFuncSetAttribute(
        interp_adjoint_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        adj_smem_bytes<T>());
    if (attr != cudaSuccess) return static_cast<int>(attr);
    opted_in = true;
  }
  interp_adjoint_tiles<T><<<dim3(static_cast<unsigned int>(ntiles), groups), ADJ_THREADS,
                            adj_smem_bytes<T>(), static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const T*>(g), static_cast<const T*>(vy), static_cast<const T*>(vx),
      static_cast<const int*>(order), static_cast<const int*>(toff),
      static_cast<const int4*>(tent), static_cast<T*>(grid), C, nfy, nfx, m, w, ntx, nent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The adjoint with respect to the grid: every cell of the (C, nfy, nfx)
// grid written once from the owned-tile lists (toff (ntiles + 1,), tent
// (nent, 4) int32: nufft/interp.py grid_tiles of the tables, TILE 32).
extern "C" int fftvis_interp_adjoint_f32(const void* g, const void* vy, const void* vx,
                                         const void* order, const void* toff,
                                         const void* tent, void* grid, int C, int nfy,
                                         int nfx, int m, int w, int ntiles, int nent,
                                         void* stream) {
  return launch_interp_adjoint<float>(g, vy, vx, order, toff, tent, grid, C, nfy, nfx, m, w,
                                      ntiles, nent, stream);
}

extern "C" int fftvis_interp_adjoint_f64(const void* g, const void* vy, const void* vx,
                                         const void* order, const void* toff,
                                         const void* tent, void* grid, int C, int nfy,
                                         int nfx, int m, int w, int ntiles, int nent,
                                         void* stream) {
  return launch_interp_adjoint<double>(g, vy, vx, order, toff, tent, grid, C, nfy, nfx, m,
                                       w, ntiles, nent, stream);
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

// D = 3 interpolation through the bin-ordered tables: order (m,) and off
// (nbins + 1,) int32 from nufft/interp.py bin_order_3d at bin edge B.
extern "C" int fftvis_interp_sm_3d_f32(const void* G, const void* i0, const void* i1,
                                       const void* i2, const void* v0, const void* v1,
                                       const void* v2, const void* order, const void* off,
                                       void* out, int C, int n0, int n1, int n2, int m,
                                       int nbins, int w, int B, void* stream) {
  return launch_interp_sm<float>(G, i0, i1, i2, v0, v1, v2, order, off, out, C, n0, n1, n2,
                                 m, nbins, w, B, stream);
}

extern "C" int fftvis_interp_sm_3d_f64(const void* G, const void* i0, const void* i1,
                                       const void* i2, const void* v0, const void* v1,
                                       const void* v2, const void* order, const void* off,
                                       void* out, int C, int n0, int n1, int n2, int m,
                                       int nbins, int w, int B, void* stream) {
  return launch_interp_sm<double>(G, i0, i1, i2, v0, v1, v2, order, off, out, C, n0, n1, n2,
                                  m, nbins, w, B, stream);
}
