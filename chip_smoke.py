#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py              (from the repository root, one CUDA card)
    python3 chip_smoke.py --profile    (also phase 6: profile warm slice runs)

Phases, one printed line each (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``fftvis_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and time the build;
3. check each kernel against its plain torch version at the shapes the
   runs give it, and time both with CUDA events (the wrapper included);
   beside them the kernel's bound (bytes over 3.35 TB/s or operations over
   the peak rate, the larger) and, where one PyTorch call computes the
   same function, that call's time (a yardstick the port never calls):
   - spread (float32: grid (4320, 3000), w=8; float64: grid (4320, 3072),
     w=14; 4096 sources; C = 1 and 4 channels) on three source sets:
     uniform over the grid, dense (all in one 128 x 128-cell patch) and
     half-zero (half the sources with all-zero weights); yardstick
     ``torch.sparse.addmm`` with the (cells, n) CSR of the ES weights;
   - interp (the same grids, 63,190 targets, C = 1 and 4), with the tap
     tables in the executor's target order and footprint runs; yardstick
     ``torch.sparse.mm`` with the (m, cells) CSR tap matrix;
   - at the per-antenna type-3 run's shapes (its precision-1 fine grid,
     float32): spread at C = 40 channels, uniform and with half the
     sources nonzero only in channels 32 and up, and interp on every
     pair's target subset with the executor's own subset tables;
   - gates 1e-5 / 1e-12 of max|plain|;
   - beam_eval (the interpolation alone) on the tabulated beam's tables,
     (91, 360, 8) polarized and (91, 360, 2) power, 4096 points with seam
     and edge-row points, orders 1 and 3, float32 and float64, wrapped
     azimuth; and the (91, 360, 296) stacked shape at order 3 in float32;
     gate 2e-6 / 1e-12 of max|plain|; beside the wrapper, the kernel alone
     (torch.profiler); yardstick at order 1 ``grid_sample`` (bilinear,
     align_corners) on the table with its seam column appended, wrapper and
     kernel alone; order 3 has none (``bicubic`` is Keys' convolution, not
     the B-spline);
   - beam_rows (the fused source block) on the committed beam's prepared
     tables: power (order 1, table (91, 360, 2)), Jones x Stokes I and
     Jones x IQUV (order 3, (91, 360, 8)), float32 and float64, at a
     4096-point block and the slice's ragged last block (471 points), about
     half of the points masked, the sky taken with its stride; gate 2e-6 /
     1e-12 of max|plain|; no yardstick (no one PyTorch call interpolates
     and forms coherency rows);
   - beam_eval on the north-star stack, (91, 360, 296) at order 1 (the
     north star's spline) in float32 and float64, beside the order-3
     float32 line above;
   - pair_rows (per-antenna pair rows) at the north star's K = 37 beams and
     P = 180 pairs, on its stacked tables' evaluations: power (37 x 2
     channels), Jones x Stokes I and Jones x IQUV (37 x 8), float32 and
     float64, at 4096 points with every point unmasked (the north star's
     own block) and with about half masked, and at the north star's ragged
     last block, half masked; gate 2e-6 / 1e-12 of max|plain|; the kernel
     alone and its share of the bound; no yardstick (no one PyTorch call
     forms them); and with one beam per antenna of the north star's array
     (K = 331, random evaluations at 4096 points), where the Jones stacks
     take the kernel's global-memory form, alone and against its bound;
   - pair_rows at the eigenbeam basis path's shapes, on stacked eigenbeam
     evaluations at 4096 unmasked points: the eigen row's K = 6 complex
     eigenbeams (P = 21, the k <= l list), auto-rank's K = 7 complex
     eigenbeams of the north star at precision 1 (P = 49, the ordered
     list) and their real parts (a real-Jones stack, P = 28); and K = 8, P
     = 36 on random evaluations (the eigen row's basis where its beams are
     evaluated in float32, as the JAX package does on a TPU); float32 and
     float64, alone and against the bound; and beam_eval on the eigen row's
     (91, 180, 48) and (91, 180, 64) stacks;
   - the exact type-1 product (cuBLAS, not a hand-written kernel) at the
     north star's C = 720 channels, 4096 sources and (42, 42) mode grid,
     float32 and float64, and at auto-rank's channels in float32 (one call
     by CUDA events and its device time alone), beside its operations
     bound and the factored form the port does not take;
   - spread and interp at the JAX bench's 3D row's own shapes, taken from
     the port's planner: C*K channels (K Chebyshev z modes of one channel)
     on its 2D fine grid, float32 at precision 1 (low-rank-z in auto mode)
     and float64 at precision 2 with type-3 forced, 4096 sources and its
     14,365 targets; gates 1e-5 / 1e-12 of max|plain|, the kernel alone,
     the bound and the sparse yardsticks beside each;
   - the adjoint kernels at their forward kernels' shapes, float32 and
     float64: spread_adjoint (the slice grids, C = 1 and 4, uniform and
     dense; the per-antenna run's C = 40), interp_adjoint (the slice
     executor's tables, C = 1 and 4; every pair's target subset of the
     per-antenna executor) and beam_eval_adjoint ((91, 360, 296) order 1,
     (91, 360, 8) order 3, the table's and the coordinates' gradients);
     each against its plain adjoint and the dot-product identity <A c, g>
     = <c, A^H g> with its forward kernel, gates 1e-5 / 1e-12 of
     max|plain| (the atomics add in an order that changes from run to
     run), the kernel alone, the bound (the output written once, what is
     gathered read once) and the yardstick: ``sparse.mm`` with the
     transposed ES or tap CSR, ``grid_sample``'s input backward at order 1;
   - the backward of ``pair_rows`` at the north star's shapes: the
     evaluations' gradient (torch ops, no kernel) and the sky's (one rerun
     of the kernel), timed;
   - ES type-1's shapes: spread on the ES fine grids of (b) below ((1728,
     864), w = 8 float32 and w = 14 float64) and of (a) ((192, 360), w =
     8), 4096 uniform sources, C = 1, the kernel alone too; interp on a
     type-2 plan of 100,000 non-redundant points on (a)'s grid (one-row
     footprint runs); and the d = 1 / d = 3 entries (``spread_gm_1d``,
     ``spread_gm_3d``, ``interp_taps_nd``) at 100,000 uniform points on a
     10^6-cell line and a (64, 64, 32) grid, C = 1, float32 (w = 8) and
     float64 (w = 14): gates 1e-5 / 1e-12 of max|plain|, the kernel alone,
     the bound and ``sparse.addmm`` / ``sparse.mm`` of the CSRs;
   - ``nufft public``: ``make_type{1,2,3}_fn`` at d = 1, 2, 3 on the card,
     100,000 sources or points and 10,000 modes or targets, in float64
     (eps 1e-9) and float32 (eps 1e-6), against the torch direct oracles in
     float64 on the card within the JAX tests' tolerances; each dtype's
     pass is the d = 1 / 3 kernels' path, its launches counted;
4. run ``simulate_vis`` on the slice configuration -- hex_array(11,
   outriggers=2) with all 63,190 i<=j baselines, the nside=64 HEALPix sky,
   2 frequencies x 3 times, forced type-3 -- with
   - GaussianBeam(14), unpolarized, at precision 1 and 2;
   - the committed ``tests/data/structured_dipole_100MHz.beamfits`` read by
     ``read_beamfits``: polarized with the order-3 spline at precision 1
     and 2, and unpolarized at order 1, precision 1;
   each run with the launch counts set to 0 just before it and read just
   after, and each of its kernels launched at least once: a tabulated run
   launches the fused beam_rows kernel once a source block (as often as
   the spread) and the interpolation alone never; an analytic run
   neither; then
   - the north star: HERA-331 (hex_array(11), 331 antennas) with its 631
     redundant-group representatives, 37 per-antenna perturbed variants of
     the committed beamfits asset (``beam_idx = arange(331) % 37``),
     polarized, the nside=64 sky, 1 frequency x 2 times, ``auto`` mode --
     a lattice, so the exact type-1 path -- at precision 2 and 1: beam_eval
     (the stacked table) and pair_rows once a source block, spread, interp
     and beam_rows never; at precision 1 auto-rank swaps the 37 beams for K
     eigenbeams (its K, channels, list kind and residual printed), and the
     run is repeated under ``FFTVIS_AUTO_RANK=0``: both configurations'
     warm walls and device busy (torch.profiler) go on record;
   - the JAX bench's eigenbeam row (``bench.py:545-598``) at its full size:
     hex_array(4) (37 antennas), 37 GaussianBeam(13 + 0.05 i) decomposed by
     ``compute_beam_basis`` in float64 (threshold 1e-8, a (91, 181) grid:
     K = 6 eigenbeams, 21 pairs, 84 channels), ``beam_coefs``, polarized, the
     nside=64 sky, 1 frequency x 4 times, precision 2, the exact type-1
     path: beam_eval and pair_rows once a source block, spread, interp and
     beam_rows never;
   - per-antenna type-3 at reduced depth: the slice array, 4 variants
     (``beam_idx = arange(355) % 4``, 10 pairs, 40 channels), polarized,
     precision 1, 1 frequency x 1 time, type-3 forced through
     ``CUDASimulationEngine(nufft_mode="type3")``: spread, beam_eval and
     pair_rows once a source block, interp once a pair;
   - the JAX bench's 3D row (``bench.py:494-543``) at its full size:
     hex_array(8) with seed-23 uniform(-2, 2) m of z scatter, all 14,365
     i<=j baselines, the nside=64 sky, 2 frequencies x 3 times,
     GaussianBeam(14), unpolarized; at precision 1 in auto mode (low-rank-z
     type-3: spread once a source block, interp once a (time, freq)), at
     precision 2 in auto mode (the direct path: neither) and at precision
     2 with type-3 forced; its path, K, fine grid and width printed;
   - the JAX bench's 24h row (``bench.py:731-771``) at its full size:
     hex_array(8) with its redundant representatives, the nside=128 sky, 24
     times over one day, 2 frequencies, GaussianBeam(14), precision 2, the
     exact type-1 path, banded and under ``FFTVIS_BAND=0``: the band plan,
     and the type-1 products of each run (banded 2 x the active blocks
     summed over the times, unbanded 2 x 24 x the blocks);
   - ES type-1 (``Type1Executor``): (a) the JAX bench's gridded row
     under ``FFTVIS_TYPE1=es`` (the slice array's 63,190 baselines, nside
     64, GaussianBeam(14), 2 f x 2 t, ES fine grid (192, 360)) and (b) the
     outrigger lattice in ``auto`` mode (hex_array(11, outriggers=10), 771
     antennas, 297,606 baselines, exact mode grid (812, 420) past 512^2
     cells, ES fine grid (1728, 864); nside 64, GaussianBeam(14), 1 f x 1
     t), each at precision 1 and 2: spread once a source block, no interp
     and no exact type-1 product; (c) the north star under
     ``FFTVIS_TYPE1=es`` at precision 2 (C = 720, the padded pair
     routing): spread, beam_eval and pair_rows once a source block, held
     to its exact type-1 run (ES_VS_EXACT);
   phase 4 starts from empty caches and ends with the bytes they hold on
   the card;
5. hold every output against the port's float64 direct path on the CPU,
   where every kernel takes its plain version, on every 32nd baseline
   (the eigen row on all of them, through the same basis contraction;
   the 24h row on every 128th, unbanded; gates 1e-4 at precision 1, 1e-5
   at precision 2, relative to max|V|), and the banded 24h run against its
   unbanded run on the card (1e-11 of max|V|); the ES runs (a)-(c) on
   every 32nd baseline too;
6. with ``--profile`` only: torch.profiler over one warm call of the
   analytic p=1, polarized p=1 and p=2, unpolarized tabulated, north
   star p=2 and p=1, 3D row p=1, 24h row banded and unbanded, and ES
   (a) and (b) at p=1 and p=2 runs
   (after five timed warm calls each): device busy time, idle share, the
   count of device kernel launches, and the hand-written kernels' device
   time, launches and share of busy; the top device ops of each run go to
   ``build/profile/profile_<i>.txt``;
7. the host layer:
   - warm calls: the north star at precision 2 and 1 and the polarized
     tabulated slice at precision 1, from empty caches one cold call and
     five warm ones: each wall, the caches' hits and misses, the host
     seconds of prepare_beams, stack_prepared and plan_transform, and of
     the cache keys (hash_parts), in a warm call (cProfile); every warm
     result within WARM_TOL of the cold one, every call's launches those
     of phase 4;
   - async_fetch: the north star at precision 1, the JAX bench's gridded
     row (``bench.py:340-415``: the slice array and sky, GaussianBeam(14),
     unpolarized, precision 2, the exact type-1 path) and its eigen row:
     8 futures dispatched with 2 in flight, then resolved; the time a
     dispatch takes to return, the time to ``result()`` and the pipelined
     wall a simulation; each result within WARM_TOL of the synchronous
     one, ``done()`` true;
   - chunking: the north star at precision 1 with a ``max_memory`` that
     the memory model splits into 3 chunks or more: the chunks, the source
     blocks (pair_rows launches), the wall, and the result within the
     precision-1 gate of phase 4's;
   - syncs: the synchronizing CUDA calls of one warm north-star call
     (``torch.cuda.set_sync_debug_mode("warn")``), between dispatch and
     ``result()`` and in ``result()``;
   - banding: warm walls of the 24h row, banded and unbanded in turns;
8. gradients: ``build_differentiable_sim`` and
   ``build_differentiable_direct_sim`` on the card, loss sum |sim -
   data|^2 with data the forward at seeded perturbed parameters:
   (a) the north star's beam calibration (fluxes, the stacked 37-beam
   table, gains; precision 2, exact type-1); (b) the polarized tabulated
   slice with type-3 forced, fluxes and gains, at precision 1 (2 f x 3 t)
   and 2 (1 f x 1 t); (c) per-antenna type-3 at phase 4's reduced depth
   with the table differentiated; (d) the direct front-end on hex_array(4)
   (703 baselines), the nside=32 sky after the cull, GaussianBeam(14),
   precision 2, in ra, dec, antpos, fluxes and gains; (e) ES type-1 on the
   gridded row (a) at precision 2, in fluxes and gains, card against CPU
   on every 8th baseline. Each: the forward
   against ``simulate_vis`` (1e-12 / 1e-6 of max|V|), the derivative along
   a seeded direction in each parameter against extrapolated central
   differences (1e-6 / 1e-3), for (a) on every 8th baseline and (d) the
   card's gradients against the port's on the CPU (1e-9), the adjoint
   kernels' launches, forward and backward walls and one backward's
   device busy;
9. print the kernels' JSON line (the adjoints' launches those of one
   gradient step of (b), (c) and (a); the d = 1 / 3 entries' those of
   their dtype's public NUFFT pass), then the result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

LAT, LON, ALT = -30.72, 21.43, 1000.0
FREQS = (1.0e8, 1.1e8)
SPREAD_SOURCES = 4096
TOL = {"float32": 1e-5, "float64": 1e-12}
BEAM_TOL = {"float32": 2e-6, "float64": 1e-12}
ORACLE_GATE = {1: 1e-4, 2: 1e-5}
DENSE_PATCH = 128
# H100 SXM data sheet: HBM3 rate, and the peak rates outside the tensor
# cores (float32 67 TFLOP/s; float64 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
# Peak of a matrix product: float32 outside the tensor cores (TF32 is off)
# and float64 on the tensor cores, both 67 TFLOP/s.
MATMUL_OPS_PER_S = 67e12
ASSET = Path(__file__).resolve().parent / "tests" / "data" / "structured_dipole_100MHz.beamfits"
# (name, beam, polarized, beam_spline_opts, precision) of the phase-4 runs.
RUNS = (
    ("analytic", "gaussian", False, None, 1),
    ("analytic", "gaussian", False, None, 2),
    ("polarized", "tabulated", True, {"order": 3}, 1),
    ("polarized", "tabulated", True, {"order": 3}, 2),
    ("unpolarized", "tabulated", False, {"order": 1}, 1),
)
# The north star (bench.py:600-672): HERA-331, 37 per-antenna beams.
NS_BEAMS = 37
NS_FREQS = (1.0e8,)
NS_TIMES = 2459863.2 + np.linspace(0, 4 / 60 / 24, 2)
NS_PRECISIONS = (2, 1)
# Per-antenna type-3 at reduced depth: variants of the slice's runs.
PA_BEAMS = 4
# The JAX bench's eigenbeam row (bench.py:545-598): hex_array(4), 37
# GaussianBeam(13 + 0.05 i) decomposed on a (91, 181) grid, 1 freq x 4 times.
EIGEN_HEX = 4
EIGEN_TIMES = 2459863.2 + np.linspace(0, 4 / 60 / 24, 4)
# The JAX bench's 3D row (bench.py:494-543): (mode, precision) of its runs.
Z3D_RUNS = (("auto", 1), ("auto", 2), ("type3", 2))
# The engine's eps at each precision (cuda/engine.py: float32 floored).
EPS = {1: 5e-7, 2: 1e-13}
# The JAX bench's 24h row (bench.py:731-771): 24 times over one day.
OBS24_TIMES = 2459863.2 + np.linspace(0, 1.0, 24)
# The banded 24h run against its FFTVIS_BAND=0 run, relative to max|V|.
BAND_TOL = 1e-11


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def slice_config():
    from fftvis_tpu_torch import TelescopeLocation
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(11, sep=14.6, outriggers=2)
    keys = list(ants)
    baselines = [(keys[i], keys[j]) for i in range(len(keys)) for j in range(i, len(keys))]
    ra, dec = healpix_radec(64)
    rng = np.random.default_rng(0)
    return dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (ra.size, len(FREQS))),
        ra=ra,
        dec=dec,
        freqs=np.array(FREQS),
        times=2459863.2 + np.linspace(0, 0.01, 3),
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        baselines=baselines,
        force_use_type3=True,
    )


def kernel_us(fn, symbol: str, reps: int = 20, tries: int = 3) -> float:
    """Mean device time in us of the kernels whose name holds ``symbol``
    over ``reps`` calls of ``fn`` (torch.profiler). The profiler now and
    then reports no device events for a session: it tries again, up to
    ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                total += ev.self_cuda_time_total if us is None else us
                count += ev.count
        if count:
            return total / count
    raise AssertionError(f"the profiler saw no kernel named like {symbol!r} in {tries} sessions")


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time in ms of one call of ``fn``: every device-side
    event (kernels, copies, fills) over ``reps`` calls (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if us is None else us
    return total / reps / 1e3


def device_launches(fn, reps: int = 5) -> tuple[float, float]:
    """(device kernels, their device us) of one call of ``fn``: the
    device-side profiler events, copies and fills left out, over ``reps``
    calls after one warm-up (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    count = us = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.key.startswith(
                ("Memcpy", "Memset")):
            t = getattr(ev, "self_device_time_total", None)
            us += ev.self_cuda_time_total if t is None else t
            count += ev.count
    return count / reps, us / reps


def bound(nbytes: float, ops: float, name: str) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library(label: str, make):
    """Build a yardstick call outside the timed window and call it once;
    None, with the reason printed, if the library refuses it."""
    try:
        call = make()
        call()
        return call
    except Exception as exc:  # the yardstick is optional: say why it is missing
        print(f"[3] {label}: library call refused: {type(exc).__name__}: {exc}", flush=True)
        return None


def interp_bound(iy, ix, C: int, nfx: int, name: str):
    """Distinct touched cells of all C planes, the tap tables and the
    output, each moved once; 1 + 4C operations a tap."""
    m, w = iy.shape
    rb = 4 if name == "float32" else 8
    cells = np.unique((iy.astype(np.int64)[:, :, None] * nfx + ix[:, None, :]).ravel()).size
    nbytes = cells * C * 2 * rb + m * w * 2 * (4 + rb) + C * m * 2 * rb
    return bound(nbytes, m * w * w * (1 + 4 * C), name), cells


def spread_bound(flat_idx, wts, w: int, name: str):
    """Touched cells of the sources with a nonzero weight, read and written
    once, plus coordinates and weights; per active source 2w kernel values
    (8 operations each), w^2 products and 2C w^2 weight products."""
    C, n = wts.shape
    rb = 4 if name == "float32" else 8
    active = (wts != 0).any(dim=0).cpu().numpy()
    cells = np.unique(flat_idx.reshape(n, w * w)[active]).size
    nbytes = 2 * cells * C * 2 * rb + 2 * n * rb + C * n * 2 * rb
    ops = int(active.sum()) * (16 * w + w * w + 2 * C * w * w)
    return bound(nbytes, ops, name), cells


def spread_library(uy, ux, wts, nfy: int, nfx: int, w: int, beta: float):
    """``torch.sparse.addmm(Gt, S, Wt)``: S the (nfy*nfx, n) CSR of the ES
    weights, Wt the (n, C) weights, Gt the (nfy*nfx, C) grid."""
    import torch

    from fftvis_tpu_torch.nufft.spread import spread_taps

    C, n = wts.shape
    flat_idx, vals = spread_taps(uy, ux, nfy, nfx, w, beta)
    src = torch.arange(n, device=uy.device).repeat_interleave(w * w)
    S = torch.sparse_coo_tensor(torch.stack([flat_idx, src]), vals.reshape(-1).to(wts.dtype),
                                (nfy * nfx, n)).coalesce().to_sparse_csr()
    Wt = wts.T.contiguous()
    Gt = torch.zeros((nfy * nfx, C), dtype=wts.dtype, device=wts.device)
    return lambda: torch.sparse.addmm(Gt, S, Wt)


def interp_library(G, iy, ix, vy, vx):
    """``torch.sparse.mm(T, Gt)``: T the (m, nfy*nfx) CSR tap matrix
    (vy[t, a] vx[t, b] at iy nfx + ix), Gt = G.reshape(C, -1).T."""
    import torch

    C, nfy, nfx = G.shape
    m, w = iy.shape
    cols = (iy.long()[:, :, None] * nfx + ix.long()[:, None, :]).reshape(m, w * w)
    vals = (vy[:, :, None] * vx[:, None, :]).reshape(m, w * w).to(G.dtype)
    cols, perm = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, perm)
    crow = torch.arange(0, m * w * w + 1, w * w, device=G.device)
    T = torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1), (m, nfy * nfx))
    Gt = G.reshape(C, -1).T.contiguous()
    return lambda: torch.sparse.mm(T, Gt)


def spread_sources(case: str, nfy: int, nfx: int, C: int, rng):
    """(uy, ux, weights) of one phase-3 source set, as numpy arrays."""
    n = SPREAD_SOURCES
    if case == "dense":
        y0, x0 = rng.uniform(0, nfy), rng.uniform(0, nfx)
        uy = np.mod(y0 + rng.uniform(0, DENSE_PATCH, n), nfy)
        ux = np.mod(x0 + rng.uniform(0, DENSE_PATCH, n), nfx)
    else:
        uy, ux = rng.uniform(0, nfy, n), rng.uniform(0, nfx, n)
    wts = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    if case == "half-zero":
        wts[:, ::2] = 0
    if case == "tail-only":
        # Half the sources nonzero only in channels 32 and up: the second
        # channel a lane tests for the zero skip.
        wts[:32, ::2] = 0
    return uy, ux, wts


def check_spread(name, rdt, cdt, grid, w: int, beta: float, C: int, case: str, rng,
                 label: str = "", alone: bool = False):
    """One phase-3 spread case through the wrapper against its plain
    version on the same card tensors; ``sparse.addmm`` beside the uniform
    case, and with ``alone`` the kernel's own device time. Returns (err, ms,
    plain_ms, (bound_ms, bound_by), library_ms)."""
    import torch

    from fftvis_tpu_torch.nufft import spread as spread_mod

    nfy, nfx = grid
    uy_np, ux_np, w_np = spread_sources(case, nfy, nfx, C, rng)
    uy, ux = (torch.tensor(a, dtype=rdt, device="cuda") for a in (uy_np, ux_np))
    wts = torch.tensor(w_np, dtype=cdt, device="cuda")
    got = spread_mod.spread(uy, ux, wts, torch.zeros((C, nfy, nfx), dtype=cdt, device="cuda"),
                            w, beta)
    want = spread_mod.spread_plain(uy, ux, wts, torch.zeros_like(got), w, beta)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    acc = torch.zeros_like(got)
    ms = cuda_ms(lambda: spread_mod.spread(uy, ux, wts, acc, w, beta), 20)
    plain = cuda_ms(lambda: spread_mod.spread_plain(uy, ux, wts, acc, w, beta), 5)
    alone_txt = ""
    if alone:
        us = kernel_us(lambda: spread_mod.spread(uy, ux, wts, acc, w, beta), "spread_gm")
        alone_txt = f" (alone {us:.2f} us)"
    del got, acc
    flat_idx = spread_mod.spread_taps(uy, ux, nfy, nfx, w, beta)[0].cpu().numpy()
    (b_ms, b_by), cells = spread_bound(flat_idx, wts, w, name)
    lib_ms = lib_txt = None
    if case == "uniform":
        lib = library(f"spread {name} C={C}",
                      lambda: spread_library(uy, ux, wts, nfy, nfx, w, beta))
        if lib is not None:
            lib_err = (lib().T.reshape(C, nfy, nfx) - want).abs().max().item()
            lib_ms = cuda_ms(lib, 5)
            lib_txt = f"; sparse.addmm {lib_ms:.4f} ms (err {lib_err / scale:.1e})"
    print(f"[3] spread {name} {case}{label}: grid ({nfy}, {nfx}) w={w} n={SPREAD_SOURCES} "
          f"C={C}: max err {err:.3e} = {err / scale:.3e} of max|plain|; "
          f"kernel {ms:.4f} ms{alone_txt}, plain {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}, {cells} cells){lib_txt or ''}", flush=True)
    if not err <= TOL[name] * scale:
        raise AssertionError(f"spread {name} {case} C={C} disagrees with its plain version")
    del want
    torch.cuda.empty_cache()
    return err, ms, plain, (b_ms, b_by), lib_ms


def check_interp(name, rdt, cdt, plan, C: int, rng, label: str = "", alone: bool = False):
    """One phase-3 interp case: the wrapper on the executor's tables (rows
    in target order, the order and the footprint runs) against its plain
    version on the plan's tables, for a random (C, nfy, nfx) grid;
    ``sparse.mm`` beside it, and with ``alone`` the kernel's own device
    time. Returns (err, ms, plain_ms, (bound_ms, bound_by), library_ms)."""
    import torch

    from fftvis_tpu_torch.nufft import interp as interp_mod

    w, (nfy, nfx) = plan.kernel.w, plan.nf

    def dev(a, dtype):
        return torch.tensor(a, dtype=dtype, device="cuda")

    iy, ix = (dev(a, torch.int32) for a in plan.tap_idx)
    vy, vx = (dev(a, rdt) for a in plan.tap_val)
    order_np = interp_mod.target_order(plan.tap_idx[0][:, 0], plan.tap_idx[1][:, 0])
    order = dev(order_np, torch.int32)
    runs = dev(interp_mod.footprint_runs(*(a[order_np] for a in plan.tap_idx)), torch.int32)
    tabs = [dev(a[order_np], torch.int32) for a in plan.tap_idx]
    tabs += [dev(a[order_np], rdt) for a in plan.tap_val]
    G = dev(rng.normal(size=(C, nfy, nfx)) + 1j * rng.normal(size=(C, nfy, nfx)), cdt)
    got = interp_mod.interp(G, *tabs, order=order, runs=runs)
    want = interp_mod.interp_plain(G, iy, ix, vy, vx)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    i_err = (got - want).abs().max().item()
    i_ms = cuda_ms(lambda: interp_mod.interp(G, *tabs, order=order, runs=runs), 20)
    i_plain = cuda_ms(lambda: interp_mod.interp_plain(G, iy, ix, vy, vx), 5)
    alone_txt = ""
    if alone:
        us = kernel_us(lambda: interp_mod.interp(G, *tabs, order=order, runs=runs),
                       "interp_runs")
        alone_txt = f" (alone {us:.2f} us)"
    (b_ms, b_by), cells = interp_bound(plan.tap_idx[0], plan.tap_idx[1], C, nfx, name)
    lib_ms, lib_txt = None, ""
    lib = library(f"interp {name} C={C}", lambda: interp_library(G, iy, ix, vy, vx))
    if lib is not None:
        lib_err = (lib().T - want).abs().max().item()
        lib_ms = cuda_ms(lib, 10)
        lib_txt = f"; sparse.mm {lib_ms:.4f} ms (err {lib_err / scale:.1e})"
    print(f"[3] interp {name}{label}: grid ({nfy}, {nfx}) w={w} m={iy.shape[0]} C={C}: "
          f"max err {i_err:.3e} = {i_err / scale:.3e} of max|plain|; "
          f"kernel {i_ms:.4f} ms{alone_txt}, plain {i_plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}, {cells} cells){lib_txt}", flush=True)
    if not i_err <= TOL[name] * scale:
        raise AssertionError(f"interp {name}{label} C={C} disagrees with its plain version")
    del G, got, want, lib
    torch.cuda.empty_cache()
    return i_err, i_ms, i_plain, (b_ms, b_by), lib_ms


def check_nufft_kernels(cfg) -> dict:
    """Phase 3: spread and interp against their plain versions at the
    slice's grids, with C = 1 (unpolarized) and C = 4 (polarized)
    channels. Returns {dtype: {kernel: row}} for the uniform C = 4 case,
    row = (err, ms, plain_ms, (bound_ms, bound_by), library_ms)."""
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.nufft.transform import plan_type3

    ants, bls = cfg["ants"], cfg["baselines"]
    targets = np.array([ants[j][:2] - ants[i][:2] for i, j in bls]).T
    x_ext = 2 * np.pi * max(FREQS) / speed_of_light
    rng = np.random.default_rng(1)
    results = {}
    for rdt, cdt, eps in (
        (torch.float32, torch.complex64, 5e-7),
        (torch.float64, torch.complex128, 1e-13),
    ):
        name = str(rdt).split(".")[-1]
        plan = plan_type3(targets, x_extent=x_ext, eps=eps)
        w, beta, (nfy, nfx) = plan.kernel.w, plan.kernel.beta, plan.nf
        results[name] = {}
        for C in (1, 4):
            for case in ("uniform", "dense", "half-zero"):
                row = check_spread(name, rdt, cdt, (nfy, nfx), w, beta, C, case, rng)
                if case == "uniform" and C == 4:
                    results[name]["spread"] = row
            row = check_interp(name, rdt, cdt, plan, C, rng)
            if C == 4:
                results[name]["interp"] = row
    return results


def check_per_antenna_nufft(pa) -> None:
    """Phase 3: spread and interp at the shapes the per-antenna type-3 run
    gives them (precision 1, float32): spread at C = 4 P channels on its
    fine grid, uniform and with half the sources nonzero only in channels
    32 and up; interp on every pair's target subset, with the executor's
    own subset tables (target order and footprint runs), C = 4."""
    import torch

    from fftvis_tpu_torch.cuda.planning import plan_transform
    from fftvis_tpu_torch.nufft import interp as interp_mod

    _, _, pp = pair_arrays(pa)
    flipped = np.zeros(len(pa["baselines"]), dtype=bool)
    for sel, fl in zip(pp.bls_idxs, pp.flipped):
        flipped[sel] = fl
    ex = plan_transform("type3", pa["ants"], pa["baselines"], pa["freqs"], 5e-7, 2, 1e-6,
                        False, flipped, len(pa["baselines"]), SPREAD_SOURCES, 2, pp.npairs,
                        device="cuda").executor
    p, name, rdt, cdt = ex.plan, "float32", torch.float32, torch.complex64
    w, beta, (nfy, nfx) = p.kernel.w, p.kernel.beta, p.nf
    C = 4 * pp.npairs
    rng = np.random.default_rng(6)
    for case in ("uniform", "tail-only"):
        check_spread(name, rdt, cdt, (nfy, nfx), w, beta, C, case, rng,
                     label=f" per-antenna ({pp.npairs} pairs)")

    G = torch.tensor(rng.normal(size=(4, nfy, nfx)) + 1j * rng.normal(size=(4, nfy, nfx)),
                     dtype=cdt, device="cuda")

    def plain_taps(sel):
        # The subset's tap tables in target order, as interp_plain takes them.
        return [torch.tensor(a[sel], dtype=dt, device="cuda")
                for a, dt in ((p.tap_idx[0], torch.int32), (p.tap_idx[1], torch.int32),
                              (p.tap_val[0], rdt), (p.tap_val[1], rdt))]

    errs, sizes = [], []
    for sel in pp.bls_idxs:
        got = ex.interpolate(G, sel)
        want = interp_mod.interp_plain(G, *plain_taps(sel))
        errs.append((got - want).abs().max().item() / want.abs().max().item())
        sizes.append(len(sel))
    big = pp.bls_idxs[int(np.argmax(sizes))]
    taps = plain_taps(big)
    ms = cuda_ms(lambda: ex.interpolate(G, big), 20)
    alone = kernel_us(lambda: ex.interpolate(G, big), "interp_runs")
    plain = cuda_ms(lambda: interp_mod.interp_plain(G, *taps), 5)
    (b_ms, b_by), cells = interp_bound(p.tap_idx[0][big], p.tap_idx[1][big], 4, nfx, name)
    print(f"[3] interp {name} subset: grid ({nfy}, {nfx}) w={w} C=4, the {pp.npairs} pairs' "
          f"target subsets (m {min(sizes)}..{max(sizes)}) with their own tables: max err "
          f"{max(errs):.3e} of max|plain|; the largest (m={max(sizes)}) kernel {ms:.4f} ms "
          f"(alone {alone:.2f} us), plain {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {cells} cells)", flush=True)
    if not max(errs) <= TOL[name]:
        raise AssertionError(f"interp {name} on a pair's subset disagrees with its plain version")
    del G
    torch.cuda.empty_cache()


def beam_points(ny: int, nx: int, n: int, rng):
    """(y, x) cell coordinates as the beam interface forms them -- za cells
    in [0, ny-1], azimuth cells in [0, nx] -- with the seam and the edge
    rows among them."""
    y = rng.uniform(0, ny - 1, n)
    x = rng.uniform(0, nx, n)
    edge_y = [0.0, 1e-4, ny - 1.5, ny - 1 - 1e-4, ny - 1.0]
    edge_x = [0.0, 1e-4, nx / 2, nx - 1e-4, float(nx)]
    grid = np.array([(a, b) for a in edge_y for b in edge_x]).T
    y[: grid.shape[1]], x[: grid.shape[1]] = grid
    return y, x


def beam_bound(data, y, x, order: int, name: str):
    """The table cells the points' taps touch, the points and the output,
    each moved once; 2 K^2 operations a point and channel (K = 2 or 4)."""
    from fftvis_tpu_torch.beams import eval as eval_mod

    ny, nx, ch = data.shape
    taps = eval_mod._linear_taps if order == 1 else eval_mod._cubic_taps
    iy, _ = taps(y, ny, False)
    ix, _ = taps(x, nx, True)
    cells = torch_unique_count(iy[:, :, None] * nx + ix[:, None, :])
    rb = data.element_size()
    npts, k = y.shape[0], iy.shape[1]
    nbytes = cells * ch * rb + 2 * npts * rb + npts * ch * rb
    return bound(nbytes, 2 * npts * ch * k * k, name), cells


def torch_unique_count(t) -> int:
    import torch

    return int(torch.unique(t.reshape(-1)).numel())


def beam_grid_sample(data, y, x):
    """``grid_sample`` (bilinear, align_corners) on the table with its seam
    column appended: order 1 with a wrapped azimuth, as one library call."""
    import torch

    ny, nx, ch = data.shape
    table = torch.cat([data, data[:, :1]], dim=1).permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([2 * x / nx - 1, 2 * y / (ny - 1) - 1], dim=-1).view(1, 1, -1, 2)

    def call():
        return torch.nn.functional.grid_sample(table, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)
    return call


def check_beam_eval() -> dict:
    """Phase 3: beam_eval against its plain version at the tabulated
    beam's tables and the north star's stack. Returns {dtype: (max err, ms,
    plain_ms, bound, library_ms)}, the times those of the north star's
    stacked table, (91, 360, 296) at order 1, with ``grid_sample`` its
    yardstick."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod

    rng = np.random.default_rng(2)
    cases = [(ch, order, dt, 360) for ch in (8, 2) for order in (3, 1)
             for dt in (torch.float32, torch.float64)]
    cases += [(8 * NS_BEAMS, 3, torch.float32, 360), (8 * NS_BEAMS, 1, torch.float32, 360),
              (8 * NS_BEAMS, 1, torch.float64, 360)]
    # The eigen row's stack on its (91, 180) grid: its K = 6 complex
    # eigenbeams, and the K = 8 a float32 evaluation of its beams keeps.
    cases += [(8 * K, 1, dt, 180) for K in (6, 8) for dt in (torch.float64, torch.float32)]
    results = {}
    for ch, order, dt, nx in cases:
        name = str(dt).split(".")[-1]
        ny = 91
        data = torch.tensor(rng.normal(size=(ny, nx, ch)), dtype=dt, device="cuda")
        y, x = (torch.tensor(a, dtype=dt, device="cuda") for a in beam_points(ny, nx, 4096, rng))
        got = eval_mod.beam_eval(data, y, x, order=order, wrap_x=True)
        want = eval_mod.beam_eval_plain(data, y, x, order=order, wrap_x=True)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        def call():
            return eval_mod.beam_eval(data, y, x, order=order, wrap_x=True)

        ms = cuda_ms(call, 50)
        alone = kernel_us(call, "beam_eval_points")
        plain = cuda_ms(lambda: eval_mod.beam_eval_plain(data, y, x, order=order, wrap_x=True), 20)
        (b_ms, b_by), cells = beam_bound(data, y, x, order, name)
        lib_ms = None
        if order == 1:
            lib = beam_grid_sample(data, y, x)
            lib_err = (lib()[0, :, 0, :].T - want).abs().max().item()
            lib_ms = cuda_ms(lib, 50)
            lib_txt = (f"grid_sample {lib_ms:.4f} ms, alone "
                       f"{kernel_us(lib, 'grid_sampler'):.2f} us (err {lib_err / scale:.1e})")
        else:
            lib_txt = "library call: none (bicubic is Keys' convolution, not the B-spline)"
        print(f"[3] beam_eval {name}: table ({ny}, {nx}, {ch}) order {order} n=4096: "
              f"max err {err:.3e} = {err / scale:.3e} of max|plain|; "
              f"kernel {ms:.4f} ms (alone {alone:.2f} us), plain {plain:.4f} ms; "
              f"bound {b_ms:.5f} ms ({b_by}, {cells} cells); {lib_txt}", flush=True)
        if not err <= BEAM_TOL[name] * scale:
            raise AssertionError(f"beam_eval {name} {(ch, order)} disagrees with its plain version")
        prev = results.get(name, (0.0, None, None, None, None))
        main = (ch, order, nx) == (8 * NS_BEAMS, 1, 360)
        timed = (ms, plain, (b_ms, b_by), lib_ms) if main else prev[1:]
        results[name] = (max(prev[0], err), *timed)
    return results


# (epilogue, order) of the phase-3 beam_rows cases: the slice's power beam
# is order 1, its Jones beam order 3.
ROWS_CASES = (("power", 1), ("jones-I", 3), ("jones-iquv", 3))
ROWS_BLOCKS = (4096, 471)  # a full source block and the slice's ragged last one
# Operations a point beyond the 2 K^2 nch of the interpolation: the cells,
# and the coherency rows times the flux and the mask.
ROWS_EPILOGUE_OPS = {"power": 16, "jones-I": 84, "jones-iquv": 244}


def rows_bound(table, az, za, mask, grid, epilogue: str, name: str):
    """The table cells the unmasked points' taps touch (the channels the
    epilogue reads), their az, za and sky, the whole mask, read once, and
    the rows written once; 2 K^2 nch + the epilogue's operations an
    unmasked point."""
    from fftvis_tpu_torch.beams import eval as eval_mod

    ny, nx, ch = table.shape
    on = mask != 0
    yy, xx = eval_mod.grid_cells(az[on], za[on], grid)
    taps = eval_mod._linear_taps if grid.order == 1 else eval_mod._cubic_taps
    iy, _ = taps(yy, ny, False)
    ix, _ = taps(xx, nx, grid.wrap)
    cells = torch_unique_count(iy[:, :, None] * nx + ix[:, None, :])
    rb = table.element_size()
    n, active, k = az.shape[0], int(on.sum().item()), iy.shape[1]
    nch, C = (1, 1) if epilogue == "power" else (ch, 4)
    sky_reals = 8 if epilogue == "jones-iquv" else 1
    nbytes = cells * nch * rb + active * (2 + sky_reals) * rb + n * rb + C * n * 2 * rb
    ops = active * (2 * k * k * nch + ROWS_EPILOGUE_OPS[epilogue])
    return bound(nbytes, ops, name), cells, active


def check_beam_rows() -> dict:
    """Phase 3: the fused beam_rows against beam_rows_plain on the committed
    beam's prepared tables. Returns {dtype: (max err, ms, plain_ms, bound,
    None)}, the times those of Jones x Stokes I at 4096 points (the slice's
    polarized source block)."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.beams import prepare_beam, read_beamfits
    from fftvis_tpu_torch.core.coherency import build_coherency

    rng = np.random.default_rng(3)
    beam = read_beamfits(str(ASSET))
    results = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for epilogue, order in ROWS_CASES:
            iquv = epilogue == "jones-iquv"
            pb = prepare_beam(beam, np.array(FREQS), epilogue != "power",
                              spline_opts={"order": order}, dtype=dt, device="cuda")
            table, grid = pb.table[0], pb.grid
            ny, nx, ch = table.shape
            for n in ROWS_BLOCKS:
                y, x = beam_points(ny, nx, n, rng)
                az = torch.tensor(grid.az0 + x * grid.daz, dtype=dt, device="cuda")
                za = torch.tensor(grid.za0 + y * grid.dza, dtype=dt, device="cuda")
                mask = torch.tensor(rng.uniform(size=n) < 0.5, dtype=dt, device="cuda")
                stokes = rng.uniform(0.1, 1.0, (n, len(FREQS)))
                if iquv:
                    pol = rng.uniform(-0.05, 0.05, (3, n, len(FREQS)))
                    coh = build_coherency(np.stack([stokes, *pol], axis=-1), True)
                    sky = torch.tensor(coh, dtype=eval_mod.COMPLEX[dt], device="cuda")[:, 0]
                else:
                    sky = torch.tensor(stokes, dtype=dt, device="cuda")[:, 0]

                def call():
                    return eval_mod.beam_rows(table, az, za, sky, mask, grid, iquv)

                def plain_call():
                    return eval_mod.beam_rows_plain(table, az, za, sky, mask, grid, iquv)

                got, want = call(), plain_call()
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                ms = cuda_ms(call, 50)
                alone = kernel_us(call, "beam_rows_points")
                plain = cuda_ms(plain_call, 20)
                (b_ms, b_by), cells, active = rows_bound(table, az, za, mask, grid,
                                                         epilogue, name)
                print(f"[3] beam_rows {name} {epilogue}: table ({ny}, {nx}, {ch}) order "
                      f"{order} n={n} ({active} unmasked): max err {err:.3e} = "
                      f"{err / scale:.3e} of max|plain|; kernel {ms:.4f} ms (alone "
                      f"{alone:.2f} us), plain {plain:.4f} ms; bound {b_ms:.5f} ms "
                      f"({b_by}, {cells} cells); library call: none (no one PyTorch "
                      f"call interpolates and forms coherency rows)", flush=True)
                if not err <= BEAM_TOL[name] * scale:
                    raise AssertionError(f"beam_rows {name} {epilogue} n={n} disagrees "
                                         "with its plain version")
                prev = results.get(name, (0.0, None, None, None, None))
                main = (epilogue, n) == ("jones-I", ROWS_BLOCKS[0])
                timed = (ms, plain, (b_ms, b_by), None) if main else prev[1:]
                results[name] = (max(prev[0], err), *timed)
    return results


def north_star_config():
    """The north star's inputs (bench.py:600-672): HERA-331, its redundant
    representatives, 37 per-antenna variants of the committed beamfits
    asset, polarized, the nside=64 sky, 1 frequency x 2 times."""
    from fftvis_tpu_torch import TelescopeLocation
    from fftvis_tpu_torch.beams import perturbed_variants, read_beamfits
    from fftvis_tpu_torch.core.utils import get_pos_reds
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(11, sep=14.6)
    ra, dec = healpix_radec(64)
    rng = np.random.default_rng(0)
    return dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (ra.size, len(NS_FREQS))),
        ra=ra,
        dec=dec,
        freqs=np.array(NS_FREQS),
        times=NS_TIMES,
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        baselines=[red[0] for red in get_pos_reds(ants, include_autos=True)],
        beam=perturbed_variants(read_beamfits(str(ASSET)), NS_BEAMS),
        beam_idx=np.arange(len(ants)) % NS_BEAMS,
        polarized=True,
    )


def eigen_row_config():
    """The JAX bench's eigenbeam row (bench.py:545-598) at its full size:
    hex_array(4) (37 antennas) with its redundant representatives, one
    GaussianBeam(13 + 0.05 i) an antenna, decomposed by compute_beam_basis
    (polarized, threshold 1e-8, a (91, 181) grid), the eigenbeams with
    ``beam_coefs``, the nside=64 sky, 1 frequency x 4 times, precision 2."""
    from fftvis_tpu_torch import TelescopeLocation, compute_beam_basis
    from fftvis_tpu_torch.beams import GaussianBeam
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(EIGEN_HEX, sep=14.6)
    eig, coefs = compute_beam_basis([GaussianBeam(diameter=13.0 + 0.05 * i)
                                     for i in range(len(ants))], NS_FREQS[0], polarized=True,
                                    threshold=1e-8, n_axis1=181, n_axis2=91)
    ra, dec = healpix_radec(64)
    rng = np.random.default_rng(0)
    return dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (ra.size, 1)),
        ra=ra,
        dec=dec,
        freqs=np.array(NS_FREQS),
        times=EIGEN_TIMES,
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        beam=eig,
        beam_coefs=coefs[:, :, None],
        polarized=True,
        precision=2,
    )


def per_antenna_config(cfg):
    """Per-antenna type-3 at reduced depth: the slice array and sky, 4
    variants, polarized, precision 1, 1 frequency x 1 time."""
    from fftvis_tpu_torch.beams import perturbed_variants, read_beamfits

    kw = {k: v for k, v in cfg.items() if k != "force_use_type3"}
    return dict(kw, fluxes=cfg["fluxes"][:, :1], freqs=np.array(FREQS[:1]),
                times=cfg["times"][:1],
                beam=perturbed_variants(read_beamfits(str(ASSET)), PA_BEAMS),
                beam_idx=np.arange(len(cfg["ants"])) % PA_BEAMS, polarized=True, precision=1)


def source_blocks(kw) -> tuple[int, int]:
    """(source blocks a run's loop takes, its last block's sources)."""
    from fftvis_tpu_torch.coords.rotation import SourceRotation
    from fftvis_tpu_torch.cuda.engine import SOURCE_BLOCK

    rot = SourceRotation(kw["ra"], kw["dec"], kw["times"], kw["telescope_loc"])
    rot.cull_never_visible()
    per = -(-rot.nsrc // SOURCE_BLOCK)
    return len(kw["times"]) * len(kw["freqs"]) * per, rot.nsrc - (per - 1) * SOURCE_BLOCK


def pair_arrays(kw):
    """The (P,) beam indices of a per-antenna run's pairs, as int32 on the
    card, and the pair plan."""
    import torch

    from fftvis_tpu_torch.core.beams import plan_beam_pairs

    pp = plan_beam_pairs(list(kw["ants"]), kw["baselines"], kw["beam_idx"])
    return [torch.tensor([p[k] for p in pp.pairs], dtype=torch.int32, device="cuda")
            for k in (0, 1)] + [pp]


# Operations a pair and unmasked point of pair_rows.
PAIR_OPS = {"power": 5, "jones-I": 80, "jones-iquv": 232}


def pair_bound(evals, mask, npairs: int, C: int, epilogue: str, name: str):
    """The unmasked points' evaluations and sky, the whole mask and the pair
    indices read once, the rows written once; PAIR_OPS a pair and unmasked
    point. Returns ((bound_ms, bound_by), bytes, unmasked points)."""
    n, kc = evals.shape
    rb = evals.element_size()
    active = int(mask.sum().item())
    nbytes = (active * kc * rb + active * (8 if epilogue == "jones-iquv" else 1) * rb + n * rb
              + 2 * npairs * 4 + C * n * 2 * rb)
    return bound(nbytes, active * npairs * PAIR_OPS[epilogue], name), nbytes, active


def check_pair_rows(ns) -> dict:
    """Phase 3: pair_rows against pair_rows_plain at the north star's K = 37
    beams and P = 180 pairs, on its stacked tables' evaluations: at 4096
    points with every point unmasked (the north star's own source block:
    its horizon cull has dropped the sources that never rise) and with
    about half masked, and at its ragged last block. Returns {dtype: (max
    err, ms, plain_ms, bound, None)}, the times those of Jones x Stokes I
    at 4096 unmasked points."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.beams.interface import prepare_beams, stack_prepared
    from fftvis_tpu_torch.core.coherency import build_coherency
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    pi, pj, pp = pair_arrays(ns)
    npairs = pp.npairs
    ragged = source_blocks(ns)[1]
    rng = np.random.default_rng(4)
    results = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for epilogue in ("power", "jones-I", "jones-iquv"):
            polarized, iquv = epilogue != "power", epilogue == "jones-iquv"
            beams, _ = prepare_beam_list(ns["beam"], ns["freqs"], polarized, None, "x",
                                         len(ns["ants"]), ns["beam_idx"])
            stacked = stack_prepared(prepare_beams(beams, ns["freqs"], polarized, dtype=dt,
                                                   device="cuda"))
            g = stacked.grid
            for n, masked in ((4096, False), (4096, True), (ragged, True)):
                az = torch.tensor(rng.uniform(0, 2 * np.pi, n), dtype=dt, device="cuda")
                za = torch.tensor(rng.uniform(0, np.pi / 2, n), dtype=dt, device="cuda")
                evals = stacked.channels(az, za, 0)
                keep = rng.uniform(size=n) < 0.5 if masked else np.ones(n, dtype=bool)
                mask = torch.tensor(keep, dtype=dt, device="cuda")
                stokes = rng.uniform(0.1, 1.0, (n, 1))
                if iquv:
                    pol = rng.uniform(-0.05, 0.05, (3, n, 1))
                    coh = build_coherency(np.stack([stokes, *pol], axis=-1), True)
                    sky = torch.tensor(coh, dtype=eval_mod.COMPLEX[dt], device="cuda")[:, 0]
                else:
                    sky = torch.tensor(stokes, dtype=dt, device="cuda")[:, 0]
                args = (evals, pi, pj, sky, mask, g.ch_shape, g.is_power, iquv, g.feed)

                def call():
                    return eval_mod.pair_rows(*args)

                def plain_call():
                    return eval_mod.pair_rows_plain(*args)

                got, want = call(), plain_call()
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                ms = cuda_ms(call, 50)
                alone = kernel_us(call, "pair_rows_points")
                plain = cuda_ms(plain_call, 10)
                C = got.shape[0]
                (b_ms, b_by), nbytes, active = pair_bound(evals, mask, npairs, C, epilogue,
                                                          name)
                print(f"[3] pair_rows {name} {epilogue}: K={stacked.nbeams} ({evals.shape[1]} "
                      f"channels) P={npairs} n={n} ({active} unmasked"
                      f"{'' if masked else ', the north star case'}), rows ({C}, {n}): max err "
                      f"{err:.3e} = {err / scale:.3e} of max|plain|; kernel {ms:.4f} ms "
                      f"(alone {alone:.2f} us, {b_ms * 1e3 / alone:.0%} of the bound), plain "
                      f"{plain:.4f} ms; bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.1f} MB); "
                      f"library call: none (no one PyTorch call forms pair coherency rows)",
                      flush=True)
                if not err <= BEAM_TOL[name] * scale:
                    raise AssertionError(f"pair_rows {name} {epilogue} n={n} disagrees with "
                                         "its plain version")
                prev = results.get(name, (0.0, None, None, None, None))
                main = (epilogue, n, masked) == ("jones-I", 4096, False)
                timed = (ms, plain, (b_ms, b_by), None) if main else prev[1:]
                results[name] = (max(prev[0], err), *timed)
                del got, want, evals
            del stacked
            torch.cuda.empty_cache()
    return results


# pair_rows stages a tile of PAIR_TILE points' K * chf evaluations in shared
# memory up to PAIR_SMEM_MAX bytes and reads a wider stack from global
# memory (csrc/beam_eval.cu TP and SMEM_MAX).
PAIR_TILE, PAIR_SMEM_MAX = 32, 200 * 1024
# One beam per antenna on HERA-331: a stack that takes the global form.
WIDE_BEAMS = 331


def check_pair_rows_wide(ns) -> dict:
    """Phase 3: pair_rows against pair_rows_plain with one beam per antenna
    of the north star's array (K = 331, its pairs over the 631 baselines),
    4096 points about half masked, on random evaluations: the Jones stacks
    take the global-memory form, power the shared one. Returns {dtype: max
    err}."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.core.coherency import build_coherency

    pi, pj, pp = pair_arrays(dict(ns, beam_idx=np.arange(len(ns["ants"])) % WIDE_BEAMS))
    K, n, npairs = WIDE_BEAMS, 4096, pp.npairs
    rng = np.random.default_rng(7)
    errs = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for epilogue in ("power", "jones-I", "jones-iquv"):
            power, iquv = epilogue == "power", epilogue == "jones-iquv"
            ch_shape = (1, 2) if power else (2, 2, 2)
            chf = int(np.prod(ch_shape))
            ev = rng.normal(size=(n, K * chf))
            evals = torch.tensor(np.abs(ev) if power else ev, dtype=dt, device="cuda")
            mask = torch.tensor(rng.uniform(size=n) < 0.5, dtype=dt, device="cuda")
            stokes = rng.uniform(0.1, 1.0, (n, 1))
            if iquv:
                coh = build_coherency(np.stack([stokes, *rng.uniform(-0.05, 0.05, (3, n, 1))],
                                               axis=-1), True)
                sky = torch.tensor(coh, dtype=eval_mod.COMPLEX[dt], device="cuda")[:, 0]
            else:
                sky = torch.tensor(stokes, dtype=dt, device="cuda")[:, 0]
            args = (evals, pi, pj, sky, mask, ch_shape, power, iquv, 1)
            got = eval_mod.pair_rows(*args)
            want = eval_mod.pair_rows_plain(*args)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            ms = cuda_ms(lambda: eval_mod.pair_rows(*args), 20)
            alone = kernel_us(lambda: eval_mod.pair_rows(*args), "pair_rows_points")
            (b_ms, b_by), nbytes, active = pair_bound(evals, mask, npairs, got.shape[0],
                                                      epilogue, name)
            staged = K * chf * (PAIR_TILE + 1) * evals.element_size()
            form = "shared" if staged <= PAIR_SMEM_MAX else "global"
            print(f"[3] pair_rows {name} {epilogue} wide: K={K} ({K * chf} channels) "
                  f"P={npairs} n={n} ({active} unmasked), {form}-memory form "
                  f"({staged / 1024:.0f} KiB a tile): max err {err:.3e} = {err / scale:.3e} "
                  f"of max|plain|; kernel {ms:.4f} ms (alone {alone:.2f} us, "
                  f"{b_ms * 1e3 / alone:.0%} of the bound); bound {b_ms:.5f} ms ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB)", flush=True)
            if not err <= BEAM_TOL[name] * scale:
                raise AssertionError(f"pair_rows {name} {epilogue} K={K} disagrees with its "
                                     "plain version")
            errs[name] = max(errs.get(name, 0.0), err)
            del got, want, evals
            torch.cuda.empty_cache()
    return errs


# The north star's eps at precision 1: the default 6e-8 floored at float32's
# 5e-7 (cuda/engine.py), auto-rank's tolerance an eighth of it.
NS_P1_EPS = 5e-7


def north_star_auto_rank(ns):
    """Auto-rank's plan of the north star at precision 1, as the engine asks
    for it (the port's planner; a cache hit after the run)."""
    from fftvis_tpu_torch.core.auto_rank import plan_auto_rank
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, _ = prepare_beam_list(ns["beam"], ns["freqs"], True, None, "x", len(ns["ants"]),
                                 ns["beam_idx"])
    plan = plan_auto_rank(beams, tol=NS_P1_EPS / 8, npairs=pair_arrays(ns)[2].npairs,
                          allow_sym=True)
    if plan is None:
        raise AssertionError("auto-rank declines the north star at precision 1")
    return plan


def check_pair_rows_basis(eig, ns) -> dict:
    """Phase 3: pair_rows against pair_rows_plain at the shapes the basis
    path gives it, at 4096 unmasked points (a source block), Stokes-I sky,
    on stacked eigenbeam evaluations: the eigen row's K complex eigenbeams
    and k <= l list; auto-rank's K = 7 complex eigenbeams of the north star
    at precision 1 and their ordered list (P = 49); and real Jones tables
    (the real parts of those 7) with the k <= l list (P = 28), the kernel's
    real-table form. And on random evaluations, K = 8 complex and P = 36:
    the eigen row's basis where the beams are evaluated in float32, as the
    JAX package does on a TPU. Returns {dtype: max err}."""
    import torch

    from fftvis_tpu_torch.beams import GriddedBeam
    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.beams.interface import BeamInterface, prepare_beams, stack_prepared

    arp = north_star_auto_rank(ns)
    real = [GriddedBeam(np.ascontiguousarray(e.data_array.real), e.axis1_array, e.axis2_array,
                        e.freq_array, feeds=e.feeds) for e in arp.eigenbeams]

    def half(K):
        return [(k, l) for k in range(K) for l in range(k, K)]

    shapes = (("eigen row", eig["beam"], half(len(eig["beam"]))),
              ("north-star auto-rank", list(arp.eigenbeams), list(arp.kl_pairs)),
              ("real-Jones", real, half(len(real))),
              ("float32-rank eigen row", 8, half(8)))
    rng = np.random.default_rng(8)
    n = SPREAD_SOURCES
    errs = {}
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        for label, beams, pairs in shapes:
            if isinstance(beams, int):  # random evaluations of K complex tables
                nbeams, ch_shape = beams, (2, 2, 2)
                evals = torch.tensor(rng.normal(size=(n, 8 * beams)), dtype=dt, device="cuda")
            else:
                stacked = stack_prepared(prepare_beams([BeamInterface(b) for b in beams],
                                                       np.array(NS_FREQS), True, dtype=dt,
                                                       device="cuda"))
                nbeams, ch_shape = stacked.nbeams, stacked.grid.ch_shape
                az = torch.tensor(rng.uniform(0, 2 * np.pi, n), dtype=dt, device="cuda")
                za = torch.tensor(rng.uniform(0, np.pi / 2, n), dtype=dt, device="cuda")
                evals = stacked.channels(az, za, 0)
                del stacked
            mask = torch.ones(n, dtype=dt, device="cuda")
            sky = torch.tensor(rng.uniform(0.1, 1.0, n), dtype=dt, device="cuda")
            pi, pj = (torch.tensor([p[k] for p in pairs], dtype=torch.int32, device="cuda")
                      for k in (0, 1))
            args = (evals, pi, pj, sky, mask, ch_shape, False, False, 0)

            def call():
                return eval_mod.pair_rows(*args)

            def plain_call():
                return eval_mod.pair_rows_plain(*args)

            got, want = call(), plain_call()
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            ms = cuda_ms(call, 50)
            alone = kernel_us(call, "pair_rows_points")
            plain = cuda_ms(plain_call, 10)
            (b_ms, b_by), nbytes, _ = pair_bound(evals, mask, len(pairs), got.shape[0],
                                                 "jones-I", name)
            kind = "real" if len(ch_shape) == 2 else "complex"
            print(f"[3] pair_rows {name} jones-I {label}: K={nbeams} {kind} "
                  f"({evals.shape[1]} channels) P={len(pairs)} n={n} (all unmasked), rows "
                  f"({got.shape[0]}, {n}): max err {err:.3e} = {err / scale:.3e} of "
                  f"max|plain|; kernel {ms:.4f} ms (alone {alone:.2f} us, "
                  f"{b_ms * 1e3 / alone:.0%} of the bound), plain {plain:.4f} ms; bound "
                  f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB)", flush=True)
            if not err <= BEAM_TOL[name] * scale:
                raise AssertionError(f"pair_rows {name} {label} disagrees with its plain version")
            errs[name] = max(errs.get(name, 0.0), err)
            del got, want, evals
    torch.cuda.empty_cache()
    return errs


def factored_product(ex, x, c, grid):
    """The exact type-1 product's factored form, which the JAX package also
    has and the port does not: c times the y factor, (C, n, nmy), contracted
    against the x factor. Timed beside the executor's outer form as the
    record of that choice."""
    import torch

    from fftvis_tpu_torch.nufft.transform import _fmod_positive

    nf = ex.plan.nf
    u = [_fmod_positive(x[axis] / (2.0 * np.pi) * nf[axis], nf[axis]) for axis in range(2)]
    ey, exf = ex._factor(u[0], 0), ex._factor(u[1], 1)
    grid += torch.matmul((c[:, :, None] * ey[None, :, :]).transpose(1, 2), exf)
    return grid


def check_type1_exact(ns) -> None:
    """Phase 3: the exact type-1 product at the north star's shapes against
    its operations bound (8 C n nmy nmx real operations at 67 TFLOP/s): one
    ``spread`` call by CUDA events (the host's launches included) and its
    device time alone, beside the factored form. C = 720 (the pair
    routing) in both dtypes, and auto-rank's channels at precision 1
    (float32; no flipped baselines). cuBLAS, not a hand-written kernel: no
    kernels entry."""
    import torch

    from fftvis_tpu_torch.cuda.engine import full_precision_matmuls

    full_precision_matmuls()
    _, _, pp = pair_arrays(ns)
    flipped = np.zeros(len(ns["baselines"]), dtype=bool)
    for sel, fl in zip(pp.bls_idxs, pp.flipped):
        flipped[sel] = fl
    arp = north_star_auto_rank(ns)
    cases = [(torch.float32, torch.complex64, pp.npairs, flipped),
             (torch.float64, torch.complex128, pp.npairs, flipped),
             (torch.float32, torch.complex64, len(arp.kl_pairs), np.zeros_like(flipped))]
    for rdt, cdt, npairs, flips in cases:
        type1_product(ns, rdt, cdt, npairs, flips)


def type1_product(ns, rdt, cdt, npairs: int, flipped) -> None:
    """One ``[3] type1_exact`` line: C = 4 npairs channels, 4096 sources, on
    the north star's mode grid planned with ``flipped``."""
    import torch

    from fftvis_tpu_torch.cuda.planning import plan_transform

    plan = plan_transform("auto", ns["ants"], ns["baselines"], ns["freqs"], 1e-13, 2, 1e-6,
                          False, flipped, len(ns["baselines"]), 4096, 2, npairs,
                          device="cuda")
    ex = plan.executor
    nf, C, n = ex.plan.nf, 4 * npairs, 4096
    rng = np.random.default_rng(5)
    name = str(rdt).split(".")[-1]
    x = torch.tensor(rng.uniform(-60, 60, (2, n)), dtype=rdt, device="cuda")
    c = torch.tensor(rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n)), dtype=cdt,
                     device="cuda")
    grids, times, alone = {}, {}, {}
    for form, fn in (("outer", ex.spread), ("factored", lambda x, c, grid:
                                             factored_product(ex, x, c, grid))):
        grid = torch.zeros((C,) + tuple(nf), dtype=cdt, device="cuda")
        grids[form] = fn(x, c, grid=grid).clone()
        times[form] = cuda_ms(lambda: fn(x, c, grid=grid), 10)
        alone[form] = device_ms(lambda: fn(x, c, grid=grid))
    scale = grids["outer"].abs().max().item()
    err = (grids["outer"] - grids["factored"]).abs().max().item() / scale
    ops = 8.0 * C * n * nf[0] * nf[1]
    b_ms = ops / MATMUL_OPS_PER_S * 1e3
    print(f"[3] type1_exact {name}: C={C} n={n} mode grid {tuple(nf)}: outer "
          f"{times['outer']:.4f} ms (device {alone['outer']:.4f} ms); factored form "
          f"(not in the port) {times['factored']:.4f} ms (device {alone['factored']:.4f} "
          f"ms); the forms agree to {err:.1e} of max; bound {b_ms:.4f} ms (operations, "
          f"{ops:.3e} at 67 TFLOP/s); cuBLAS, not a hand-written kernel", flush=True)
    if not err <= TOL[name]:
        raise AssertionError(f"type1_exact {name}: the two forms disagree")
    del grids, grid, x, c
    torch.cuda.empty_cache()


def north_star_auto_rank_runs(ns, counters, want_launches, auto_vis) -> None:
    """Phase 4: the north star at precision 1 auto-ranks, as the JAX engine
    does: its plan (K, channels before and after, list kind, residual);
    then the same run under ``FFTVIS_AUTO_RANK=0`` (the pair routing, 720
    channels), with the same launches. Both configurations' warm walls (5
    calls) and device busy (torch.profiler, 5 warm calls) go on record: a
    record, not a claim."""
    import os

    import torch

    from fftvis_tpu_torch import simulate_vis

    arp = north_star_auto_rank(ns)
    npairs = pair_arrays(ns)[2].npairs
    print(f"[4] north-star precision=1 auto-rank: K={arp.K} eigenbeams, {4 * npairs} -> "
          f"{4 * len(arp.kl_pairs)} channels ({len(arp.kl_pairs)} pairs), "
          f"{'symmetric' if arp.kl_sym else 'ordered'} channel list, residual "
          f"{arp.residual:.3e} (tol {arp.tol:.3e})", flush=True)
    kw = dict(ns, precision=1)

    def run():
        out = simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        return out

    def walls():
        out = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            out.append(time.perf_counter() - t0)
        return out

    record = {"on": (walls(), device_ms(run, 5))}
    before = os.environ.get("FFTVIS_AUTO_RANK")
    os.environ["FFTVIS_AUTO_RANK"] = "0"
    try:
        reset(counters)
        pair_vis = run()
        got = read(counters)
        if got != want_launches:
            raise AssertionError(f"north star FFTVIS_AUTO_RANK=0: launches {got}, auto-ranked "
                                 f"{want_launches}")
        record["off"] = (walls(), device_ms(run, 5))
    finally:
        if before is None:
            os.environ.pop("FFTVIS_AUTO_RANK")
        else:
            os.environ["FFTVIS_AUTO_RANK"] = before
    for key, label in (("on", f"auto-rank ({4 * len(arp.kl_pairs)} channels)"),
                       ("off", f"FFTVIS_AUTO_RANK=0 ({4 * npairs} channels)")):
        w, busy = record[key]
        print(f"[4] north-star precision=1 {label}: warm walls "
              f"{', '.join(f'{t:.4f}' for t in w)} s (median {np.median(w):.4f}), device busy "
              f"{busy:.3f} ms a call", flush=True)
    print(f"[4] north-star precision=1 auto-rank vs FFTVIS_AUTO_RANK=0: max diff "
          f"{max_rel(auto_vis, pair_vis):.3e} of max|V|", flush=True)


def run_kwargs(cfg, run):
    from fftvis_tpu_torch.beams import GaussianBeam, read_beamfits

    _, beam, polarized, opts, precision = run
    beam = GaussianBeam(diameter=14.0) if beam == "gaussian" else read_beamfits(str(ASSET))
    return dict(cfg, beam=beam, polarized=polarized, beam_spline_opts=opts,
                precision=precision)


def direct_oracle(kw):
    """The port's float64 direct path on the CPU for one run's inputs."""
    from fftvis_tpu_torch import CUDASimulationEngine
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, beam_idx = prepare_beam_list(kw["beam"], np.atleast_1d(kw["freqs"]),
                                        kw["polarized"], kw.get("beam_coefs"), "x",
                                        len(kw["ants"]), kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx", "force_use_type3")}
    return CUDASimulationEngine(nufft_mode="direct", device="cpu").simulate(
        beam_list=beams, beam_idx=beam_idx, **ekw)


PROFILE_RUNS = (0, 2, 3, 4)  # RUNS indices: analytic p=1 and the tabulated runs
KERNEL_NAMES = {"spread": "spread_gm", "interp": "interp_runs", "beam_eval": "beam_eval_points",
                "beam_rows": "beam_rows_points", "pair_rows": "pair_rows_points"}


def profile_runs(cfg, ns, z3d, obs, es) -> None:
    """Phase 6: five timed warm calls, then one profiled call, of each of
    PROFILE_RUNS, the north-star runs, the 3D row at precision 1 (low-rank
    z), the 24h row banded and unbanded, and the ES type-1 runs (a) and (b)
    at both precisions (``es``: {label: (kw, vis, precision)}); device
    time from the profiler's CUDA kernel events, and the hand-written
    kernels' share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fftvis_tpu_torch import simulate_vis

    out_dir = Path(__file__).resolve().parent / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    calls = []
    for i in PROFILE_RUNS:
        kind, beam, _, _, precision = RUNS[i]
        calls.append((i, f"{kind} {beam} precision={precision}", run_kwargs(cfg, RUNS[i])))
    for k, precision in enumerate(NS_PRECISIONS):
        calls.append((len(RUNS) + k, f"north-star precision={precision}",
                      dict(ns, precision=precision)))
    n = len(RUNS) + len(NS_PRECISIONS)
    calls.append((n, "3D row precision=1 (low-rank-z)", dict(z3d, precision=1)))
    calls.append((n + 1, "24h row banded", obs))
    calls.append((n + 2, "24h row FFTVIS_BAND=0", obs))
    for k, (label, (kw, _, precision)) in enumerate(
            (k, v) for k, v in es.items() if k.startswith(("(a)", "(b)"))):
        calls.append((n + 3 + k, label, dict(kw, precision=precision)))
    for i, label, kw in calls:
        walls = []
        with band_env("FFTVIS_BAND=0" in label), type1_env(
                "es" if "FFTVIS_TYPE1=es" in label else None):
            for _ in range(5):
                t0 = time.perf_counter()
                simulate_vis(device="cuda", **kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                simulate_vis(device="cuda", **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        # Device-side events only (kernels, copies, fills): an aten op's
        # row repeats the time of the kernels it launched.
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                rows.append((us, ev.count, ev.key))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        nkernels = sum(c for _, c, key in rows if not key.startswith(("Memcpy", "Memset")))
        mine, mine_us = [], 0.0
        for kname, sym in KERNEL_NAMES.items():
            hits = [r for r in rows if sym in r[2]]
            if hits:
                us, count = sum(r[0] for r in hits), sum(r[1] for r in hits)
                mine_us += us
                mine.append(f"{kname} {us / 1e3:.4f} ms / {count} = {us / count:.2f} us")
        mine.append(f"their share of busy {mine_us / 1e3 / busy_ms:.4f}")
        (out_dir / f"profile_{i}.txt").write_text("".join(
            f"{us / 1e3:10.4f} ms {count:6d}  {key[:160]}\n" for us, count, key in rows[:40]))
        print(f"[6] profile {label}: warm walls "
              f"{', '.join(f'{t:.4f}' for t in walls)} s; profiled wall {wall:.4f} s, "
              f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / 1e3 / wall:.4f}, "
              f"{nkernels} device kernel launches; {'; '.join(mine)}", flush=True)


def cache_device_bytes() -> dict:
    """{cache: bytes of the distinct CUDA tensors its entries reach}."""
    import torch

    from fftvis_tpu_torch.cuda import engine as engine_mod

    def walk(obj, seen, found):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda:
                found[obj.untyped_storage().data_ptr()] = obj.untyped_storage().nbytes()
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v, seen, found)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v, seen, found)
        elif hasattr(obj, "__dict__") and not isinstance(obj, type):
            walk(vars(obj), seen, found)

    out = {}
    for name, cache in engine_mod._caches().items():
        found = {}
        walk(cache.entries, set(), found)
        out[name] = sum(found.values())
    return out


def stage_seconds(fn) -> dict:
    """Cumulative host seconds of the PROFILED_STAGES functions in one call
    of ``fn`` under cProfile (0.0 where a stage did not run)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(fn)
    cum = dict.fromkeys(PROFILED_STAGES, 0.0)
    for (_, _, func), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
        if func in cum:
            cum[func] += ct
    return cum


PROFILED_STAGES = ("prepare_beams", "stack_prepared", "plan_transform", "hash_parts")
# A warm or asynchronous result against the cold or synchronous one,
# relative to max|V|: two summation orders (the type-3 spread's atomics).
WARM_TOL = {1: 1e-5, 2: 1e-12}
ASYNC_SIMS, ASYNC_DEPTH = 8, 2


def max_rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def warm_calls(label: str, kw, counters, want_launches) -> None:
    """Phase 7: one cold call from empty caches and five warm ones."""
    import torch

    from fftvis_tpu_torch import cache_stats, clear_caches, simulate_vis

    def call():
        reset(counters)
        t0 = time.perf_counter()
        out = simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if read(counters) != want_launches:
            raise AssertionError(f"{label}: launches {read(counters)}, phase 4 had "
                                 f"{want_launches}")
        return out, wall

    clear_caches()
    cold, cold_wall = call()
    errs, walls = [], []
    for _ in range(5):
        out, wall = call()
        errs.append(max_rel(out, cold))
        walls.append(wall)
    stats = cache_stats()
    stages = stage_seconds(lambda: simulate_vis(device="cuda", **kw))
    precision = kw["precision"]
    print(f"[7] warm {label}: cold wall {cold_wall:.4f} s, warm walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (median {np.median(walls):.4f}); warm vs "
          f"cold max err {max(errs):.3e} of max|V| (gate {WARM_TOL[precision]:.0e}, "
          f"bitwise {max(errs) == 0}); launches a call {want_launches}; cache hits/misses "
          + ", ".join(f"{k} {h}/{m}" for k, (h, m) in stats.items())
          + "; host s in a warm call: "
          + ", ".join(f"{k} {v:.5f}" for k, v in stages.items()), flush=True)
    if not max(errs) <= WARM_TOL[precision]:
        raise AssertionError(f"{label}: a warm result differs from the cold one")
    if any(stats[k][0] == 0 for k in ("plan", "input", "prepared")):
        raise AssertionError(f"{label}: a cache never hit: {stats}")


def pipelined(label: str, kw) -> None:
    """Phase 7: ASYNC_SIMS futures with ASYNC_DEPTH in flight, then resolved,
    against the synchronous result."""
    import collections

    import torch

    from fftvis_tpu_torch import VisibilityFuture, simulate_vis

    want = simulate_vis(device="cuda", **kw)
    dispatch, collect, errs = [], [], []
    pending = collections.deque()

    def resolve():
        fut = pending.popleft()
        t0 = time.perf_counter()
        got = fut.result()
        collect.append(time.perf_counter() - t0)
        if not fut.done():
            raise AssertionError(f"{label}: done() is false after result()")
        errs.append(max_rel(got, want))

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(ASYNC_SIMS):
        t0 = time.perf_counter()
        fut = simulate_vis(device="cuda", async_fetch=True, **kw)
        dispatch.append(time.perf_counter() - t0)
        if not isinstance(fut, VisibilityFuture) or fut._event is None:
            raise AssertionError(f"{label}: async_fetch returned {type(fut).__name__}, not a "
                                 "pending future")
        pending.append(fut)
        if len(pending) == ASYNC_DEPTH:
            resolve()
    while pending:
        resolve()
    per_sim = (time.perf_counter() - t_start) / ASYNC_SIMS
    precision = kw["precision"]
    print(f"[7] async_fetch {label}: {ASYNC_SIMS} futures, {ASYNC_DEPTH} in flight: dispatch "
          f"returns in {np.median(dispatch) * 1e3:.3f} ms (median; max "
          f"{max(dispatch) * 1e3:.3f}), result() {np.median(collect) * 1e3:.3f} ms (median; "
          f"max {max(collect) * 1e3:.3f}), pipelined wall {per_sim:.4f} s a simulation; vs "
          f"the synchronous call max err {max(errs):.3e} of max|V| (gate "
          f"{WARM_TOL[precision]:.0e})", flush=True)
    if not max(errs) <= WARM_TOL[precision]:
        raise AssertionError(f"{label}: an async result differs from the synchronous one")


def gridded_row_config(cfg):
    """The JAX bench's gridded row (bench.py:340-415) at its full size: the
    slice array and sky, GaussianBeam(14), unpolarized, precision 2, the
    exact type-1 path."""
    from fftvis_tpu_torch.beams import GaussianBeam

    kw = {k: v for k, v in cfg.items() if k != "force_use_type3"}
    return dict(kw, beam=GaussianBeam(diameter=14.0), polarized=False, precision=2)


def chunked(ns, counters, unchunked) -> None:
    """Phase 7: the north star at precision 1 under a max_memory that the
    memory model splits into 3 chunks or more."""
    import torch

    from fftvis_tpu_torch import simulate_vis
    from fftvis_tpu_torch.core.utils import get_desired_chunks
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, _ = prepare_beam_list(ns["beam"], ns["freqs"], True, None, "x", len(ns["ants"]),
                                 ns["beam_idx"])
    max_memory = 32 * 2**20
    nchunks, _ = get_desired_chunks(max_memory, 1, [b.beam for b in beams], 2, 2,
                                    len(ns["ants"]), len(ns["fluxes"]), 1)
    if nchunks < 3:
        raise AssertionError(f"max_memory {max_memory} gives {nchunks} chunks")
    kw = dict(ns, precision=1, max_memory=max_memory)
    simulate_vis(device="cuda", **kw)
    reset(counters)
    t0 = time.perf_counter()
    out = simulate_vis(device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    blocks = read(counters)["pair_rows"]
    err = max_rel(out, unchunked)
    print(f"[7] chunking north-star precision=1, max_memory {max_memory / 2**20:.0f} MiB: "
          f"{nchunks} chunks, {blocks} source blocks (unchunked "
          f"{source_blocks(ns)[0]}), warm wall {wall:.4f} s; vs unchunked max err {err:.3e} "
          f"of max|V| (gate {ORACLE_GATE[1]:.0e})", flush=True)
    if not (err <= ORACLE_GATE[1] and blocks > source_blocks(ns)[0]):
        raise AssertionError("the chunked north star differs from the unchunked one")


def sync_count(ns) -> None:
    """Phase 7: the synchronizing CUDA calls of one warm north-star call."""
    import warnings

    import torch

    from fftvis_tpu_torch import simulate_vis

    kw = dict(ns, precision=1)
    simulate_vis(device="cuda", **kw)
    torch.cuda.synchronize()
    counts = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fut = simulate_vis(device="cuda", async_fetch=True, **kw)
            n_dispatch = len(caught)
            fut.result()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = ["synchroniz" in str(w.message) for w in caught]
    counts["dispatch"] = sum(syncs[:n_dispatch])
    counts["result"] = sum(syncs[n_dispatch:])
    where = sorted({str(w.message).splitlines()[0][:80] for w, s in zip(caught, syncs) if s})
    print(f"[7] syncs of one warm north-star precision=1 call "
          f"(set_sync_debug_mode warn): {counts['dispatch']} between dispatch and result(), "
          f"{counts['result']} in result(){'; ' + ' | '.join(where) if where else ''}",
          flush=True)


def z3d_config():
    """The JAX bench's 3D row (bench.py:494-506) at its full size:
    hex_array(8) with seed-23 uniform(-2, 2) m of z scatter (169 antennas,
    all 14,365 i <= j baselines), the nside=64 sky, 2 frequencies x 3
    times, GaussianBeam(14), unpolarized."""
    from fftvis_tpu_torch import TelescopeLocation
    from fftvis_tpu_torch.beams import GaussianBeam
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    rng_z = np.random.default_rng(23)
    ants = {k: np.array([p[0], p[1], rng_z.uniform(-2.0, 2.0)])
            for k, p in hex_array(8, sep=14.6).items()}
    keys = list(ants)
    ra, dec = healpix_radec(64)
    rng = np.random.default_rng(0)
    return dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (ra.size, len(FREQS))),
        ra=ra,
        dec=dec,
        freqs=np.array(FREQS),
        times=2459863.2 + np.linspace(0, 0.01, 3),
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        baselines=[(keys[i], keys[j]) for i in range(len(keys)) for j in range(i, len(keys))],
        beam=GaussianBeam(diameter=14.0),
        polarized=False,
    )


def obs24_config():
    """The JAX bench's 24h row (bench.py:738-751) at its full size:
    hex_array(8) with its redundant representatives, the nside=128 sky
    (196,608 sources), 24 times over one day, 2 frequencies,
    GaussianBeam(14), unpolarized, precision 2: the exact type-1 path."""
    from fftvis_tpu_torch import TelescopeLocation
    from fftvis_tpu_torch.beams import GaussianBeam
    from fftvis_tpu_torch.core.utils import get_pos_reds
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(8, sep=14.6)
    ra, dec = healpix_radec(128)
    rng = np.random.default_rng(0)
    return dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (ra.size, len(FREQS))),
        ra=ra,
        dec=dec,
        freqs=np.array(FREQS),
        times=OBS24_TIMES,
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        baselines=[red[0] for red in get_pos_reds(ants, include_autos=True)],
        beam=GaussianBeam(diameter=14.0),
        polarized=False,
        precision=2,
    )


def culled_rotation(kw):
    from fftvis_tpu_torch.coords.rotation import SourceRotation

    rot = SourceRotation(kw["ra"], kw["dec"], kw["times"], kw["telescope_loc"])
    rot.cull_never_visible()
    return rot


def engine_plan(kw, mode: str, precision: int):
    """The transform plan the engine makes for an unpolarized shared-beam
    run of ``kw`` (cuda/planning.py plan_transform on the culled sky)."""
    from fftvis_tpu_torch.cuda.planning import plan_transform

    bls = kw["baselines"]
    return plan_transform(mode, kw["ants"], bls, kw["freqs"], EPS[precision], 2, 1e-6, False,
                          np.zeros(len(bls), dtype=bool), len(bls),
                          culled_rotation(kw).nsrc, 1, 1, device="cuda")


def run_mode(kw, mode: str):
    """One run through simulate_vis (``auto``) or, for a forced mode, the
    engine with that mode."""
    from fftvis_tpu_torch import CUDASimulationEngine, simulate_vis
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    if mode == "auto":
        return simulate_vis(device="cuda", **kw)
    beams, beam_idx = prepare_beam_list(kw["beam"], kw["freqs"], kw["polarized"], None, "x",
                                        len(kw["ants"]), kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx")}
    return CUDASimulationEngine(nufft_mode=mode, device="cuda").simulate(
        beam_list=beams, beam_idx=beam_idx, **ekw)


def check_noncoplanar_nufft(z3d) -> None:
    """Phase 3: spread and interp at the 3D row's own shapes, from the
    port's planner: C*K channels (unpolarized, C = 1: K Chebyshev z modes)
    on its 2D fine grid, float32 at precision 1 (auto: low-rank-z) and
    float64 at precision 2 (type-3 forced), 4096 sources and its 14,365
    targets; kernel alone, bound and the sparse yardsticks beside each;
    then the device kernels and time of one low-rank-z spread and
    interpolate call (the Chebyshev weights and the K-mode contraction
    around the kernels) against the 2D executor's."""
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.nufft.transform import Type3Executor

    rng = np.random.default_rng(8)
    for mode, precision, rdt, cdt in (("auto", 1, torch.float32, torch.complex64),
                                      ("type3", 2, torch.float64, torch.complex128)):
        name = str(rdt).split(".")[-1]
        ex = engine_plan(z3d, mode, precision).executor
        K, p = ex.channel_multiplier, ex.plan
        label = f" 3D row p={precision} (C*K = 1*{K})"
        check_spread(name, rdt, cdt, p.nf, p.kernel.w, p.kernel.beta, K, "uniform", rng,
                     label=label, alone=True)
        check_interp(name, rdt, cdt, p, K, rng, label=label, alone=True)
        # The torch ops around the kernels: one executor call on a 4096-source
        # block (in the sky's range) and one interpolation, against the 2D
        # executor's on the same 2D plan.
        zp, n = ex.zplan, SPREAD_SOURCES
        x_ext = 2 * np.pi * max(FREQS) / speed_of_light  # the planner's source extent
        lo, hi = zp.x_center_z - zp.x_half_z, zp.x_center_z + zp.x_half_z
        x = torch.tensor(np.stack([rng.uniform(-x_ext, x_ext, n), rng.uniform(-x_ext, x_ext, n),
                                   rng.uniform(lo, hi, n)]), dtype=rdt, device="cuda")
        c = torch.ones((1, n), dtype=cdt, device="cuda")
        ex2 = Type3Executor(p, device="cuda")
        grid = torch.zeros((K,) + tuple(p.nf), dtype=cdt, device="cuda")
        G = ex.transform(ex.spread(x, c))
        rows = []
        for what, fn3, fn2 in (
            ("spread", lambda: ex.spread(x, c, grid=grid),
             lambda: ex2.spread(x[:2], c, grid=grid[:1])),
            ("interpolate", lambda: ex.interpolate(G), lambda: ex2.interpolate(G[:1])),
        ):
            (n3, us3), (n2, us2) = device_launches(fn3), device_launches(fn2)
            rows.append(f"{what} {n3:.0f} kernels / {us3:.1f} us (2D executor {n2:.0f} / "
                        f"{us2:.1f} us)")
        print(f"[3] low-rank-z executor {name} p={precision} K={K}, one call on the card: "
              + "; ".join(rows), flush=True)
        del x, c, grid, G
        torch.cuda.empty_cache()


def run_z3d(z3d, counters) -> dict:
    """Phase 4: the 3D row at precision 1 (auto: low-rank-z), 2 (auto: the
    direct path) and 2 with type-3 forced. A low-rank-z run launches the
    spread once a source block (every K modes in one launch) and interp
    once a (time, freq); the direct path neither. Returns {run: vis}."""
    import torch

    blocks = source_blocks(z3d)[0]
    tf = len(z3d["times"]) * len(z3d["freqs"])
    out = {}
    for mode, precision in Z3D_RUNS:
        plan = engine_plan(z3d, mode, precision)
        ex = plan.executor
        reset(counters)
        t0 = time.perf_counter()
        vis = run_mode(dict(z3d, precision=precision), mode)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got = read(counters)
        want_shape = (len(FREQS), len(z3d["times"]), len(z3d["baselines"]))
        if vis.shape != want_shape or not np.all(np.isfinite(vis)):
            raise AssertionError(f"3D row {mode} p={precision}: shape {vis.shape}, finite="
                                 f"{bool(np.all(np.isfinite(vis)))}")
        want = ({"spread": blocks, "interp": tf} if plan.mode == "type3"
                else {"spread": 0, "interp": 0})
        want = {k: want.get(k, 0) for k in got}  # every other kernel: no launch
        if got != want:
            raise AssertionError(f"3D row {mode} p={precision} ({plan.mode}): launches {got}, "
                                 f"want {want}")
        t0 = time.perf_counter()
        run_mode(dict(z3d, precision=precision), mode)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        shape = ("" if ex is None else f", K={ex.channel_multiplier}, nf={ex.plan.nf}, "
                 f"w={ex.plan.kernel.w}")
        print(f"[4] simulate_vis 3D row hex-{len(z3d['ants'])} +-2 m z, {mode} precision="
              f"{precision}: path {plan.mode}{' low-rank-z' if ex is not None else ''}{shape}; "
              f"{vis.shape} {vis.dtype}, finite; launches {got}; wall first {first:.3f} s, "
              f"second {second:.3f} s", flush=True)
        out[(mode, precision)] = vis
    return out


def obs24_band(obs):
    """The band plan the engine makes for the 24h row: (perm, active_idx,
    active_val), the banded block and the unbanded blocks a time."""
    import torch

    from fftvis_tpu_torch.cuda.engine import band_plan, source_block

    rot = culled_rotation(obs)
    plan = engine_plan(obs, "auto", 2)
    block = source_block(plan, 1, len(obs["baselines"]), 1, False, 0, torch.complex128)
    hit = band_plan(rot, rot.nsrc, block)
    if hit is None:
        raise AssertionError("the 24h row plans no horizon banding")
    band, _, blk = hit
    return band, blk, -(-rot.nsrc // block), rot.nsrc


@contextlib.contextmanager
def env_var(name: str, value):
    """The environment variable ``name`` set to ``value`` inside the block
    (unset with None)."""
    before = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def band_env(off: bool):
    """``FFTVIS_BAND=0`` inside the block when ``off``."""
    return env_var("FFTVIS_BAND", "0" if off else None)


def type1_env(value):
    """``FFTVIS_TYPE1=value`` inside the block (unset with None)."""
    return env_var("FFTVIS_TYPE1", value)


def run_obs24(obs, counters) -> dict:
    """Phase 4: the 24h row banded and under FFTVIS_BAND=0; the type-1
    products each run adds: 2 freqs x the active blocks of each time,
    banded, and 2 x 24 x the blocks, unbanded. Returns {banded: vis}."""
    import torch

    from fftvis_tpu_torch import simulate_vis
    from fftvis_tpu_torch.nufft import type1

    (_, idx, val), blk, nblocks, nsrc = obs24_band(obs)
    active = (val > 0).sum(axis=1)
    nt, nf = len(obs["times"]), len(obs["freqs"])
    print(f"[4] 24h row band plan: {nsrc} sources after the cull, {idx.shape[1]} of "
          f"{-(-nsrc // blk)} blocks of {blk} at the worst time, {active.mean():.2f} active on "
          f"average ({active.sum()} of {nt * (-(-nsrc // blk))} block-times); unbanded "
          f"{nblocks} blocks a time", flush=True)
    out = {}
    for banded in (True, False):
        with band_env(not banded):
            reset(counters)
            type1.products = 0
            t0 = time.perf_counter()
            vis = simulate_vis(device="cuda", **obs)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            products, got = type1.products, read(counters)
            t0 = time.perf_counter()
            simulate_vis(device="cuda", **obs)
            torch.cuda.synchronize()
            second = time.perf_counter() - t0
        want = nf * int(active.sum()) if banded else nf * nt * nblocks
        label = "banded" if banded else "FFTVIS_BAND=0"
        if vis.shape != (nf, nt, len(obs["baselines"])) or not np.all(np.isfinite(vis)):
            raise AssertionError(f"24h row {label}: shape {vis.shape}")
        if products != want or any(got.values()):
            raise AssertionError(f"24h row {label}: {products} type-1 products (want {want}), "
                                 f"kernel launches {got}")
        print(f"[4] simulate_vis 24h row hex-{len(obs['ants'])} nside 128 {label}: {vis.shape} "
              f"{vis.dtype}, finite; {products} type-1 products (want {want}); launches {got}; "
              f"wall first {first:.3f} s, second {second:.3f} s", flush=True)
        out[banded] = vis
    return out


def banding_walls(obs, rounds: int = 8) -> None:
    """Phase 7: warm walls of the 24h row, banded and unbanded in turns (the
    order flipped each round, after one warm-up call of each: the caches
    keep both configurations' entries), and the rounds the banded call
    won."""
    import torch

    from fftvis_tpu_torch import simulate_vis

    def wall(banded: bool) -> float:
        with band_env(not banded):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            simulate_vis(device="cuda", **obs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    wall(True), wall(False)
    walls = {True: [], False: []}
    for r in range(rounds):
        for banded in ((True, False) if r % 2 == 0 else (False, True)):
            walls[banded].append(wall(banded))
    b, u = (np.percentile(walls[k], (25, 50, 75)) for k in (True, False))
    wins = sum(x < y for x, y in zip(walls[True], walls[False]))
    print(f"[7] 24h row warm walls, interleaved ({rounds} rounds): banded "
          f"{', '.join(f'{w:.4f}' for w in walls[True])} s (median {b[1]:.4f}, quartiles "
          f"{b[0]:.4f}-{b[2]:.4f}), FFTVIS_BAND=0 {', '.join(f'{w:.4f}' for w in walls[False])} "
          f"s (median {u[1]:.4f}, quartiles {u[0]:.4f}-{u[2]:.4f}); unbanded / banded medians "
          f"{u[1] / b[1]:.3f}; banded faster in {wins} of {rounds} rounds", flush=True)


def check_new_rows(z3d, z_vis, obs, obs_vis) -> None:
    """Phase 5 for the 3D and 24h rows: the 3D runs against the port's
    float64 direct path on the CPU on every 32nd baseline; the banded 24h
    run against its FFTVIS_BAND=0 run on the card, and against the CPU
    float64 direct path (unbanded) on every 128th baseline."""
    sub = z3d["baselines"][::32]
    t0 = time.perf_counter()
    oracle = direct_oracle(dict(z3d, baselines=sub, precision=2))
    took = time.perf_counter() - t0
    for (mode, precision), vis in z_vis.items():
        err = max_rel(vis[..., ::32], oracle)
        print(f"[5] 3D row {mode} precision={precision} vs fp64 direct ({len(sub)} baselines, "
              f"{took:.3f} s on the CPU): max err {err:.3e} of max|V| (gate "
              f"{ORACLE_GATE[precision]:.0e})", flush=True)
        if not err <= ORACLE_GATE[precision]:
            raise AssertionError(f"the 3D row {mode} p={precision} misses its accuracy gate")
    err = max_rel(obs_vis[True], obs_vis[False])
    print(f"[5] 24h row banded vs FFTVIS_BAND=0 on the card: max diff {err:.3e} of max|V| "
          f"(gate {BAND_TOL:.0e})", flush=True)
    if not err <= BAND_TOL:
        raise AssertionError("the banded 24h row differs from its unbanded run")
    sub = obs["baselines"][::128]
    t0 = time.perf_counter()
    with band_env(True):
        oracle = direct_oracle(dict(obs, baselines=sub))
    err = max_rel(obs_vis[True][..., ::128], oracle)
    print(f"[5] 24h row banded precision=2 vs fp64 direct ({len(sub)} baselines, "
          f"{time.perf_counter() - t0:.3f} s on the CPU): max err {err:.3e} of max|V| (gate "
          f"{ORACLE_GATE[2]:.0e})", flush=True)
    if not err <= ORACLE_GATE[2]:
        raise AssertionError("the banded 24h row misses its accuracy gate")


# ------------------------------------------- ES type-1 and the public NUFFT

# (b): the HERA-style core with 10 rings of lattice outriggers.
OUTRIGGERS = 10
# The d = 1 / d = 3 kernel checks: points, grids, and C = 1 channel.
ND_POINTS = 100_000
ND_GRIDS = {1: (1_000_000,), 3: (64, 64, 32)}
# The ES run (c) against its exact type-1 run, relative to max|V|: the ES
# kernel's eps = 1e-13 truncation and the FFT's rounding, in float64.
ES_VS_EXACT = 1e-11
# The public transforms on the card: (eps, tolerance factor of the JAX
# tests a kind and d), and the float32 floor (JAX's complex64 type-2 test).
PUBLIC_EPS = {"float64": 1e-9, "float32": 1e-6}
PUBLIC_FACTOR = {"type1": {1: 20, 2: 20, 3: 20}, "type2": {1: 10, 2: 10, 3: 10},
                 "type3": {1: 30, 2: 30, 3: 300}}
PUBLIC_FLOOR = {"float64": 3e-11, "float32": 1e-4}
# Sizes of the public runs: sources (type-1, type-3) and points (type-2),
# modes (targets), and the largest |mode| an axis.
PUBLIC_N, PUBLIC_M = 100_000, 10_000
PUBLIC_KMAX = {1: (250,), 2: (60, 60), 3: (14, 14, 7)}


def es_row_config(cfg):
    """(a) The JAX bench's gridded row (bench.py:340-415) at its full size,
    run under FFTVIS_TYPE1=es: the slice array with all 63,190 i <= j
    baselines, the nside=64 sky, GaussianBeam(14), unpolarized, 2
    frequencies x 2 times."""
    kw = gridded_row_config(cfg)
    return dict(kw, times=cfg["times"][:2])


def outrigger_config(cfg):
    """(b) hex_array(11, outriggers=10): 771 antennas, all 297,606 i <= j
    baselines (autos included), the nside=64 sky, GaussianBeam(14),
    unpolarized, 1 frequency x 1 time; its exact mode grid passes 512^2
    cells, so auto mode takes ES type-1."""
    from fftvis_tpu_torch.beams import GaussianBeam
    from fftvis_tpu_torch.geometry import hex_array

    ants = hex_array(11, sep=14.6, outriggers=OUTRIGGERS)
    keys = list(ants)
    rng = np.random.default_rng(5)
    return dict(ants=ants, ra=cfg["ra"], dec=cfg["dec"],
                fluxes=rng.uniform(0.1, 1.0, (cfg["ra"].size, 1)), freqs=np.array(FREQS[:1]),
                times=cfg["times"][:1], telescope_loc=cfg["telescope_loc"],
                baselines=[(keys[i], keys[j]) for i in range(len(keys))
                           for j in range(i, len(keys))],
                beam=GaussianBeam(diameter=14.0), polarized=False)


def es_plan(kw, precision: int):
    """The port's planner's ES type-1 plan of a lattice run (host), the
    exact type-1 mode grid beside it."""
    from fftvis_tpu_torch.cuda.planning import plan_transform
    from fftvis_tpu_torch.nufft.transform import Type1Executor

    nbl = len(kw["baselines"])
    with type1_env("es"):
        plan = plan_transform("auto", kw["ants"], kw["baselines"], kw["freqs"],
                              EPS[precision], 2, 1e-6, False, np.zeros(nbl, dtype=bool),
                              nbl, 1, 1, 1, device="cpu")
    assert isinstance(plan.executor, Type1Executor)
    return plan.executor.plan


def nd_taps(u, nf, w: int, beta: float):
    """Per-axis (m, w) tap tables of targets at grid coordinates u (the
    plans' formula: first cell ceil(u - w/2), taken mod nf), as numpy."""
    from fftvis_tpu_torch.nufft.kernels import es_kernel_grid

    idx, val = [], []
    for ua, n in zip(u, nf):
        cells = np.ceil(ua - w / 2.0).astype(np.int64)[:, None] + np.arange(w)[None, :]
        idx.append(np.mod(cells, n).astype(np.int32))
        val.append(es_kernel_grid(ua[:, None] - cells, w, beta))
    return idx, val


def check_spread_nd(d: int, rdt, cdt, rng) -> tuple:
    """A d = 1 / d = 3 spread entry against its plain version on ND_POINTS
    uniform sources on ND_GRIDS[d], C = 1: the wrapper, the kernel alone,
    the plain version, the bound and ``sparse.addmm`` with the (cells, n)
    CSR of the ES weights. Returns the kernels-line row."""
    import torch

    from fftvis_tpu_torch.nufft import spread as spread_mod
    from fftvis_tpu_torch.nufft.kernels import ESKernel

    name = str(rdt).split(".")[-1]
    k = ESKernel.from_eps(EPS[1 if name == "float32" else 2])
    w, beta, nf, n = k.w, k.beta, ND_GRIDS[d], ND_POINTS
    u = [torch.tensor(rng.uniform(0, m, n), dtype=rdt, device="cuda") for m in nf]
    wts = torch.tensor(rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n)), dtype=cdt,
                       device="cuda")
    got = spread_mod.spread_nd(u, wts, torch.zeros((1,) + nf, dtype=cdt, device="cuda"), w,
                               beta)
    want = spread_mod.spread_nd_plain(u, wts, torch.zeros_like(got), w, beta)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    acc = torch.zeros_like(got)
    ms = cuda_ms(lambda: spread_mod.spread_nd(u, wts, acc, w, beta), 20)
    plain = cuda_ms(lambda: spread_mod.spread_nd_plain(u, wts, acc, w, beta), 3)
    alone = kernel_us(lambda: spread_mod.spread_nd(u, wts, acc, w, beta), f"spread_gm_{d}d")
    del got, acc, want
    flat_idx, vals = spread_mod.spread_taps_nd(u, nf, w, beta)
    rb = 4 if name == "float32" else 8
    cells = torch.unique(flat_idx).numel()
    nbytes = 2 * cells * 2 * rb + d * n * rb + n * 2 * rb
    (b_ms, b_by) = bound(nbytes, n * (8 * d * w + 3 * w**d), name)
    lib_ms, lib_txt = None, ""
    src = torch.arange(n, device="cuda").repeat_interleave(w**d)

    def make():
        S = torch.sparse_coo_tensor(torch.stack([flat_idx, src]), vals.reshape(-1).to(cdt),
                                    (int(np.prod(nf)), n)).coalesce().to_sparse_csr()
        Wt, Gt = wts.T.contiguous(), torch.zeros((int(np.prod(nf)), 1), dtype=cdt,
                                                 device="cuda")
        return lambda: torch.sparse.addmm(Gt, S, Wt)

    lib = library(f"spread_d{d} {name}", make)
    if lib is not None:
        lib_ms = cuda_ms(lib, 3)
        lib_txt = f"; sparse.addmm {lib_ms:.4f} ms"
    print(f"[3] spread_d{d} {name}: grid {nf} w={w} n={n} C=1: max err {err:.3e} = "
          f"{err / scale:.3e} of max|plain|; kernel {ms:.4f} ms (alone {alone:.2f} us), plain "
          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {cells} cells){lib_txt}", flush=True)
    if not err <= TOL[name] * scale:
        raise AssertionError(f"spread_d{d} {name} disagrees with its plain version")
    del flat_idx, vals, src, lib
    torch.cuda.empty_cache()
    return err, ms, plain, (b_ms, b_by), lib_ms


def check_interp_nd(d: int, rdt, cdt, rng) -> tuple:
    """A d = 1 / d = 3 interpolation entry against its plain version at
    ND_POINTS uniform targets on ND_GRIDS[d], C = 1, with ``sparse.mm`` of
    the (m, cells) CSR tap matrix beside it. Returns the kernels-line
    row."""
    import torch

    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft.kernels import ESKernel

    name = str(rdt).split(".")[-1]
    k = ESKernel.from_eps(EPS[1 if name == "float32" else 2])
    w, nf, m = k.w, ND_GRIDS[d], ND_POINTS
    idx_np, val_np = nd_taps([rng.uniform(0, n, m) for n in nf], nf, w, k.beta)
    idx = [torch.tensor(a, device="cuda") for a in idx_np]
    val = [torch.tensor(a, dtype=rdt, device="cuda") for a in val_np]
    G = torch.tensor(rng.normal(size=(1,) + nf) + 1j * rng.normal(size=(1,) + nf), dtype=cdt,
                     device="cuda")
    got = interp_mod.interp_nd(G, idx, val)
    want = interp_mod.interp_nd_plain(G, idx, val)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: interp_mod.interp_nd(G, idx, val), 20)
    plain = cuda_ms(lambda: interp_mod.interp_nd_plain(G, idx, val), 3)
    alone = kernel_us(lambda: interp_mod.interp_nd(G, idx, val), "interp_taps_nd")
    del got, want
    # Every target's w^d flat cells, on the card.
    flat = idx[0].long()
    for a in range(1, d):
        flat = (flat[:, :, None] * nf[a] + idx[a].long()[:, None, :]).reshape(m, -1)
    wt = val[0]
    for a in range(1, d):
        wt = (wt[:, :, None] * val[a][:, None, :]).reshape(m, -1)
    rb = 4 if name == "float32" else 8
    cells = torch.unique(flat).numel()
    nbytes = cells * 2 * rb + m * w * d * (4 + rb) + m * 2 * rb
    (b_ms, b_by) = bound(nbytes, m * w**d * 5, name)
    lib_ms, lib_txt = None, ""

    def make():
        cols, perm = torch.sort(flat, dim=1)
        T = torch.sparse_csr_tensor(torch.arange(0, m * w**d + 1, w**d, device="cuda"),
                                    cols.reshape(-1), torch.gather(wt, 1, perm).reshape(-1)
                                    .to(cdt), (m, int(np.prod(nf))))
        Gt = G.reshape(1, -1).T.contiguous()
        return lambda: torch.sparse.mm(T, Gt)

    lib = library(f"interp_d{d} {name}", make)
    if lib is not None:
        lib_ms = cuda_ms(lib, 5)
        lib_txt = f"; sparse.mm {lib_ms:.4f} ms"
    print(f"[3] interp_d{d} {name}: grid {nf} w={w} m={m} C=1: max err {err:.3e} = "
          f"{err / scale:.3e} of max|plain|; kernel {ms:.4f} ms (alone {alone:.2f} us), plain "
          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {cells} cells){lib_txt}", flush=True)
    if not err <= TOL[name] * scale:
        raise AssertionError(f"interp_d{d} {name} disagrees with its plain version")
    del G, flat, wt, lib
    torch.cuda.empty_cache()
    return err, ms, plain, (b_ms, b_by), lib_ms


def check_es_kernels(es_a, es_b) -> dict:
    """Phase 3 for this slice: spread on the ES fine grids of (b) (4096
    uniform sources, C = 1, both precisions) and of (a) at precision 1;
    interp on a type-2 plan of 100,000 non-redundant points (one-row
    footprint runs) on (a)'s grid; and the d = 1 / d = 3 entries. Returns
    {kernel_dtype: row} of the d = 1 / 3 entries."""
    import torch

    from fftvis_tpu_torch.nufft.transform import plan_type2

    rng = np.random.default_rng(8)
    for label, kw, precision, (rdt, cdt) in (
        ("outrigger", es_b, 1, (torch.float32, torch.complex64)),
        ("outrigger", es_b, 2, (torch.float64, torch.complex128)),
        ("gridded row", es_a, 1, (torch.float32, torch.complex64)),
    ):
        p = es_plan(kw, precision)
        check_spread(str(rdt).split(".")[-1], rdt, cdt, p.nf, p.kernel.w, p.kernel.beta, 1,
                     "uniform", rng, label=f" {label} ES grid", alone=True)
    p = es_plan(es_a, 1)
    kmax = [(n - p.kernel.w) // 4 for n in p.nf]
    modes = np.stack([rng.integers(-k, k + 1, 2000) for k in kmax])
    t2 = plan_type2(rng.uniform(-np.pi, np.pi, (2, ND_POINTS)), modes, EPS[1])
    check_interp("float32", torch.float32, torch.complex64, t2, 1, rng,
                 label=" type-2 non-redundant points", alone=True)
    rows = {}
    for d in (1, 3):
        for rdt, cdt in ((torch.float32, torch.complex64), (torch.float64, torch.complex128)):
            name = str(rdt).split(".")[-1]
            rows[f"spread_d{d}_{name}"] = check_spread_nd(d, rdt, cdt, rng)
            rows[f"interp_d{d}_{name}"] = check_interp_nd(d, rdt, cdt, rng)
    return rows


def public_problem(kind: str, d: int, rng):
    """One public transform's inputs (numpy): sources or points x (d, n) in
    [-pi, pi), weights (1, n) or mode coefficients (1, m), and integer modes
    (d, m) (type-1, type-2) or real targets (d, m) (type-3)."""
    kmax = PUBLIC_KMAX[d]
    x = rng.uniform(-np.pi, np.pi, (d, PUBLIC_N))
    modes = np.stack([rng.integers(-k, k + 1, PUBLIC_M) for k in kmax])
    if kind == "type3":
        modes = modes + rng.uniform(-0.5, 0.5, modes.shape)
    n = PUBLIC_M if kind == "type2" else PUBLIC_N
    c = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    return x, c, modes


def public_nufft(counters) -> dict:
    """Phase 3 ``nufft public``: make_type{1,2,3}_fn at d = 1, 2, 3 on the
    card, in float64 and in float32, against the torch direct oracles on the
    card in float64 (on the float32-rounded inputs for a float32 run), each
    within the JAX tests' tolerance (PUBLIC_FACTOR x eps, PUBLIC_FLOOR).
    Each dtype's pass is the d = 1 / 3 kernels' path: the launch counts set
    to 0 just before it and read just after. Returns {dtype: counts}."""
    import torch

    from fftvis_tpu_torch.nufft import (
        direct_type1,
        direct_type2,
        direct_type3,
        make_type1_fn,
        make_type2_fn,
        make_type3_fn,
        plan_type1,
        plan_type2,
        plan_type3,
    )

    out = {}
    for name, rdt, cdt in (("float64", torch.float64, torch.complex128),
                           ("float32", torch.float32, torch.complex64)):
        rng = np.random.default_rng(9)
        eps = PUBLIC_EPS[name]
        errs = []
        reset(counters)
        t0 = time.perf_counter()
        for d in (1, 2, 3):
            for kind in ("type1", "type2", "type3"):
                x, c, modes = public_problem(kind, d, rng)
                xt = torch.tensor(x, dtype=rdt, device="cuda")
                ct = torch.tensor(c, dtype=cdt, device="cuda")
                x64, c64 = xt.double(), ct.to(torch.complex128)
                if kind == "type1":
                    got = make_type1_fn(plan_type1(modes, eps))(xt, ct)
                    want = direct_type1(x64, c64, modes)
                elif kind == "type2":
                    got = make_type2_fn(plan_type2(x64.cpu().numpy(), modes, eps))(ct)
                    want = direct_type2(x64, c64, modes)
                else:
                    got = make_type3_fn(plan_type3(modes, np.pi, eps))(xt, ct)
                    want = direct_type3(x64, c64, modes)
                err = ((got.to(torch.complex128) - want).abs().max()
                       / want.abs().max()).item()
                tol = max(PUBLIC_FACTOR[kind][d] * eps, PUBLIC_FLOOR[name])
                errs.append(f"{kind} d={d} {err:.2e}")
                if not err <= tol:
                    raise AssertionError(f"public {kind} d={d} {name}: {err:.3e} > {tol:.0e}")
        torch.cuda.synchronize()
        got = out[name] = read(counters)
        for key in ("spread_d1", "spread_d3", "interp_d1", "interp_d3", "spread", "interp"):
            if got[key] <= 0:
                raise AssertionError(f"public NUFFT run {name}: {key} never launched ({got})")
        print(f"[3] nufft public {name} (eps {eps:.0e}): make_type{{1,2,3}}_fn at d = 1, 2, 3, "
              f"n = {PUBLIC_N} sources or points, m = {PUBLIC_M} modes or targets, |k| <= "
              f"{PUBLIC_KMAX}, against the float64 direct oracles on the card: "
              f"{', '.join(errs)}; launches {got}; {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def run_es(label: str, kw, precision: int, env, counters) -> tuple:
    """Phase 4, one ES type-1 run: the launch counts set to 0 just before
    and read after, the spread once a source block, no interp and no exact
    type-1 product; a second call's wall. Returns (vis, launches)."""
    import torch

    from fftvis_tpu_torch import simulate_vis
    from fftvis_tpu_torch.nufft import type1

    blocks = source_blocks(kw)[0]
    with type1_env(env):
        reset(counters)
        type1.products = 0
        t0 = time.perf_counter()
        out = simulate_vis(device="cuda", **dict(kw, precision=precision))
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got, products = read(counters), type1.products
        t0 = time.perf_counter()
        simulate_vis(device="cuda", **dict(kw, precision=precision))
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
    if not np.all(np.isfinite(out)) or out.shape[-1] != len(kw["baselines"]):
        raise AssertionError(f"{label}: shape {out.shape}, finite "
                             f"{bool(np.all(np.isfinite(out)))}")
    if got["spread"] != blocks or got["interp"] or products:
        raise AssertionError(f"{label}: launches {got}, type-1 products {products} "
                             f"({blocks} source blocks)")
    print(f"[4] simulate_vis {label} precision={precision}: {out.shape} {out.dtype}, finite; "
          f"{len(kw['baselines'])} baselines, {blocks} source blocks; launches {got}, exact "
          f"type-1 products {products}; wall first {first:.3f} s, second {second:.3f} s",
          flush=True)
    return out, got


def es_runs(cfg, ns, ns_exact, counters) -> dict:
    """Phase 4 for ES type-1: (a) the gridded row under FFTVIS_TYPE1=es and
    (b) the outrigger lattice in auto mode, each at precision 1 and 2; (c)
    the north star under FFTVIS_TYPE1=es at precision 2, against its exact
    type-1 run ``ns_exact``. Returns {label: (kw, vis, precision)}."""
    es_a, es_b = es_row_config(cfg), outrigger_config(cfg)
    out = {}
    for label, kw, env in ((f"(a) gridded row hex-{len(cfg['ants'])} FFTVIS_TYPE1=es", es_a,
                            "es"),
                           (f"(b) outrigger lattice hex-11+{OUTRIGGERS} rings "
                            f"({len(es_b['ants'])} antennas) auto", es_b, None)):
        for precision in (1, 2):
            p = es_plan(kw, precision)
            vis, _ = run_es(f"{label} ES grid {p.nf} w={p.kernel.w}", kw, precision, env,
                            counters)
            out[f"{label} precision={precision}"] = (kw, vis, precision)
    label = f"(c) north-star hera-{len(ns['ants'])} FFTVIS_TYPE1=es"
    vis, got = run_es(label, dict(ns, precision=2), 2, "es", counters)
    blocks = source_blocks(ns)[0]
    if got["beam_eval"] != blocks or got["pair_rows"] != blocks:
        raise AssertionError(f"{label}: launches {got} ({blocks} source blocks)")
    err = max_rel(vis, ns_exact)
    print(f"[5] {label} precision=2 vs its exact type-1 run: max diff {err:.3e} of max|V| "
          f"(gate {ES_VS_EXACT:.0e})", flush=True)
    if not err <= ES_VS_EXACT:
        raise AssertionError(f"{label} differs from its exact type-1 run")
    out[f"{label} precision=2"] = (ns, vis, 2)
    return out


def check_es_runs(es) -> None:
    """Phase 5 for ES type-1: each run against the port's float64 direct
    path on the CPU on every 32nd baseline."""
    for label, (kw, vis, precision) in es.items():
        sub = kw["baselines"][::32]
        t0 = time.perf_counter()
        oracle = direct_oracle(dict(kw, baselines=sub, precision=2))
        err = max_rel(vis[..., ::32], oracle)
        print(f"[5] {label} vs fp64 direct ({len(sub)} baselines, "
              f"{time.perf_counter() - t0:.3f} s on the CPU): max err {err:.3e} of max|V| "
              f"(gate {ORACLE_GATE[precision]:.0e})", flush=True)
        if not err <= ORACLE_GATE[precision]:
            raise AssertionError(f"{label} misses its accuracy gate")


# --------------------------------------------------------- adjoint kernels

def vdot(a, b) -> complex:
    """<a, b> = sum conj(a) b over every entry."""
    import torch

    return complex(torch.vdot(a.reshape(-1), b.reshape(-1)).item())


def identity_err(lhs: complex, rhs: complex) -> float:
    return abs(lhs - rhs) / abs(lhs)


def adjoint_row(name, kernel, err, scale, ident, ms, plain, bnd, lib_ms) -> tuple:
    """Gate one phase-3 adjoint case: its max abs error against the plain
    adjoint, relative to max|plain| ``scale``, and the dot-product identity
    with the forward kernel, both within TOL (the atomics add in an order
    that changes from run to run). Returns the row with the abs error."""
    if not (err <= TOL[name] * scale and ident <= TOL[name]):
        raise AssertionError(f"{kernel} {name}: err {err / scale:.3e} of max|plain|, "
                             f"identity {ident:.3e}")
    return err, ms, plain, bnd, lib_ms


def csr(rows, cols, vals, shape):
    """A torch CSR matrix from COO triplets (summing duplicates)."""
    import torch

    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce() \
        .to_sparse_csr()


def check_spread_adjoint(name, rdt, cdt, grid, w: int, beta: float, C: int, case: str, rng,
                         label: str = "") -> tuple:
    """One phase-3 spread_adjoint case: the wrapper against its plain
    version for a random (C, nfy, nfx) grid gradient, the identity <spread
    c, g> = <c, spread_adjoint g> with the forward kernel, the kernel alone,
    the bound (the touched cells of the C planes read once, coordinates,
    the (C, n) output written once) and ``sparse.mm`` of the transposed ES
    CSR."""
    import torch

    from fftvis_tpu_torch.nufft import spread as spread_mod

    nfy, nfx = grid
    uy_np, ux_np, c_np = spread_sources(case, nfy, nfx, C, rng)
    uy, ux = (torch.tensor(a, dtype=rdt, device="cuda") for a in (uy_np, ux_np))
    c = torch.tensor(c_np, dtype=cdt, device="cuda")
    g = torch.complex(torch.randn((C, nfy, nfx), dtype=rdt, device="cuda"),
                      torch.randn((C, nfy, nfx), dtype=rdt, device="cuda"))
    got = spread_mod.spread_adjoint(uy, ux, g, w, beta)
    want = spread_mod.spread_adjoint_plain(uy, ux, g, w, beta)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    Ac = spread_mod.spread(uy, ux, c, torch.zeros_like(g), w, beta)
    ident = identity_err(vdot(Ac, g), vdot(c, got))
    del Ac, want
    ms = cuda_ms(lambda: spread_mod.spread_adjoint(uy, ux, g, w, beta), 20)
    plain = cuda_ms(lambda: spread_mod.spread_adjoint_plain(uy, ux, g, w, beta), 5)
    alone = kernel_us(lambda: spread_mod.spread_adjoint(uy, ux, g, w, beta), "spread_adjoint_gm")
    flat_idx, vals = spread_mod.spread_taps(uy, ux, nfy, nfx, w, beta)
    n = uy.shape[0]
    rb = 4 if name == "float32" else 8
    cells = torch_unique_count(flat_idx)
    bnd = bound(cells * C * 2 * rb + 2 * n * rb + C * n * 2 * rb,
                n * (16 * w + w * w + 4 * C * w * w), name)
    lib_ms, lib_txt = None, ""
    if case == "uniform":
        def make():
            src = torch.arange(n, device="cuda").repeat_interleave(w * w)
            St = csr(src, flat_idx, vals.reshape(-1).to(cdt), (n, nfy * nfx))
            G2 = g.reshape(C, -1).T.contiguous()
            return lambda: torch.sparse.mm(St, G2)
        lib = library(f"spread_adjoint {name} C={C}", make)
        if lib is not None:
            lib_ms = cuda_ms(lib, 5)
            lib_txt = f"; sparse.mm {lib_ms:.4f} ms"
    print(f"[3] spread_adjoint {name} {case}{label}: grid ({nfy}, {nfx}) w={w} n={n} C={C}: "
          f"max err {err:.3e} = {err / scale:.3e} of max|plain|, identity {ident:.3e}; "
          f"kernel {ms:.4f} ms "
          f"(alone {alone:.2f} us), plain {plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, "
          f"{cells} cells){lib_txt}", flush=True)
    del g, got
    torch.cuda.empty_cache()
    return adjoint_row(name, "spread_adjoint", err, scale, ident, ms, plain, bnd, lib_ms)


def check_interp_adjoint(name, rdt, cdt, nf, tabs, order, runs, plain_tabs, C: int, rng,
                         label: str = "") -> tuple:
    """One phase-3 interp_adjoint case on one set of the executor's tables
    (rows in target order, the order and the runs; ``plain_tabs`` the same
    taps in target order): the wrapper against its plain version for a
    random (C, m) gradient, the identity <interp G, g> = <G, interp_adjoint
    g> with the forward kernel, the kernel alone, the bound (the (C, nfy,
    nfx) output written once, the tap tables and the gradient read once)
    and ``sparse.mm`` of the transposed tap CSR."""
    import torch

    from fftvis_tpu_torch.nufft import interp as interp_mod

    nfy, nfx = nf
    m, w = plain_tabs[0].shape
    g = torch.complex(torch.randn((C, m), dtype=rdt, device="cuda"),
                      torch.randn((C, m), dtype=rdt, device="cuda"))

    def call():
        return interp_mod.interp_adjoint(g, *tabs, nf, order=order, runs=runs)

    got = call()
    want = interp_mod.interp_adjoint_plain(g, *plain_tabs, nfy, nfx)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    del want
    G = torch.complex(torch.randn((C, nfy, nfx), dtype=rdt, device="cuda"),
                      torch.randn((C, nfy, nfx), dtype=rdt, device="cuda"))
    ident = identity_err(vdot(interp_mod.interp(G, *tabs, order=order, runs=runs), g),
                         vdot(G, got))
    del G, got
    ms = cuda_ms(call, 20)
    plain = cuda_ms(lambda: interp_mod.interp_adjoint_plain(g, *plain_tabs, nfy, nfx), 5)
    alone = kernel_us(call, "interp_adjoint_runs")
    rb = 4 if name == "float32" else 8
    bnd = bound(C * nfy * nfx * 2 * rb + m * w * 2 * (4 + rb) + C * m * 2 * rb,
                m * w * w * (1 + 4 * C), name)
    lib_ms, lib_txt = None, ""

    def make():
        iy, ix, vy, vx = plain_tabs
        cols = (iy.long()[:, :, None] * nfx + ix.long()[:, None, :]).reshape(-1)
        rows = torch.arange(m, device="cuda").repeat_interleave(w * w)
        vals = (vy[:, :, None] * vx[:, None, :]).reshape(-1).to(cdt)
        Tt = csr(cols, rows, vals, (nfy * nfx, m))
        gt = g.T.contiguous()
        return lambda: torch.sparse.mm(Tt, gt)
    lib = library(f"interp_adjoint {name}{label} C={C}", make)
    if lib is not None:
        lib_ms = cuda_ms(lib, 5)
        lib_txt = f"; sparse.mm {lib_ms:.4f} ms"
    print(f"[3] interp_adjoint {name}{label}: grid ({nfy}, {nfx}) w={w} m={m} C={C}: "
          f"max err {err:.3e} = {err / scale:.3e} of max|plain|, identity {ident:.3e}; "
          f"kernel {ms:.4f} ms "
          f"(alone {alone:.2f} us), plain {plain:.4f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}){lib_txt}", flush=True)
    del g, lib
    torch.cuda.empty_cache()
    return adjoint_row(name, "interp_adjoint", err, scale, ident, ms, plain, bnd, lib_ms)


def check_beam_eval_adjoint(ch: int, order: int, dt, rng) -> tuple:
    """One phase-3 beam_eval_adjoint case on a (91, 360, ch) table, 4096
    points with seam and edge rows, wrapped azimuth: the table and
    coordinate gradients against the plain adjoint in the same dtype (and,
    for float32, the table gradient against the float64 plain adjoint),
    the identity <beam_eval(data), g> = <data, gdata> with the forward
    kernel; times of the table gradient alone (the stacked table's path),
    the kernel alone, the bound (the (ny, nx, ch) table gradient written
    once, the points and the gradient read once) and, at order 1, the
    backward of ``grid_sample`` with respect to its input."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod

    name = str(dt).split(".")[-1]
    ny, nx = 91, 360
    data = torch.tensor(rng.normal(size=(ny, nx, ch)), dtype=dt, device="cuda")
    y, x = (torch.tensor(a, dtype=dt, device="cuda") for a in beam_points(ny, nx, 4096, rng))
    g = torch.tensor(rng.normal(size=(4096, ch)), dtype=dt, device="cuda")
    got = eval_mod.beam_eval_adjoint(data, y, x, g, order, True, table=True, coords=True)
    want = eval_mod.beam_eval_adjoint_plain(data, y, x, g, order, True, table=True, coords=True)
    # The table's gradient sets the row; the coordinates' share its gate.
    err, scale = (got[0] - want[0]).abs().max().item(), want[0].abs().max().item()
    err_xy = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got[1:], want[1:]))
    if not err_xy <= TOL[name]:
        raise AssertionError(f"beam_eval_adjoint {name}: coordinate gradients {err_xy:.3e}")
    want64 = eval_mod.beam_eval_adjoint_plain(data.double(), y.double(), x.double(), g.double(),
                                              order, True)[0]
    err64 = ((got[0].double() - want64).abs().max() / want64.abs().max()).item()
    lhs = float((eval_mod.beam_eval(data, y, x, order=order, wrap_x=True).double()
                 * g.double()).sum())
    ident = identity_err(lhs, float((data.double() * got[0].double()).sum()))
    del want, want64

    def call():
        return eval_mod.beam_eval_adjoint(data, y, x, g, order, True)

    ms = cuda_ms(call, 50)
    alone = kernel_us(call, "beam_eval_adjoint_points")
    ms_xy = cuda_ms(lambda: eval_mod.beam_eval_adjoint(data, y, x, g, order, True, coords=True),
                    50)
    plain = cuda_ms(lambda: eval_mod.beam_eval_adjoint_plain(data, y, x, g, order, True), 20)
    rb = data.element_size()
    k = 2 if order == 1 else 4
    bnd = bound(ny * nx * ch * rb + 2 * 4096 * rb + 4096 * ch * rb, 2 * 4096 * ch * k * k, name)
    lib_ms, lib_txt = None, "library call: none (bicubic is Keys' convolution, not the B-spline)"
    if order == 1:
        table = torch.cat([data, data[:, :1]], dim=1).permute(2, 0, 1)[None].contiguous()
        table.requires_grad_()
        grid = torch.stack([2 * x / nx - 1, 2 * y / (ny - 1) - 1], dim=-1).view(1, 1, -1, 2)
        out = torch.nn.functional.grid_sample(table, grid, mode="bilinear",
                                              padding_mode="border", align_corners=True)
        gout = g.T.reshape(out.shape).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out, table, gout, retain_graph=True), 20)
        lib_txt = f"grid_sample backward (input) {lib_ms:.4f} ms"
    print(f"[3] beam_eval_adjoint {name}: table ({ny}, {nx}, {ch}) order {order} n=4096: max err "
          f"{err:.3e} = {err / scale:.3e} of max|plain| (vs float64 plain {err64:.3e}; the "
          f"coordinates {err_xy:.3e}), identity {ident:.3e}; "
          f"kernel {ms:.4f} ms (alone {alone:.2f} us; with the coordinates {ms_xy:.4f} ms), "
          f"plain {plain:.4f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}); {lib_txt}", flush=True)
    return adjoint_row(name, "beam_eval_adjoint", err, scale, ident, ms, plain, bnd, lib_ms)


def check_pair_rows_backward(ns) -> None:
    """Phase 3: the backward of ``PairRowsFunction`` at the north star's K =
    37 Jones beams, P = 180 pairs and a 4096-point block, all unmasked,
    Stokes-I sky, float32 and float64: the evaluations' gradient (the torch
    ops of pair_rows_plain's derivative; no kernel) and the sky's (one
    rerun of the kernel at the unit sky), each by CUDA events and its
    device time (torch.profiler), beside the forward kernel; the sky's
    gradient against the plain rows' autograd."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod

    pair_i, pair_j, pp = pair_arrays(ns)
    rng = np.random.default_rng(12)
    n, K, ch_shape = 4096, NS_BEAMS, (2, 2, 2)
    for dt in (torch.float32, torch.float64):
        name = str(dt).split(".")[-1]
        evals = torch.tensor(rng.normal(size=(n, K * 8)), dtype=dt, device="cuda")
        sky = torch.tensor(rng.uniform(0.1, 1, n), dtype=dt, device="cuda")
        mask = torch.ones(n, dtype=dt, device="cuda")
        # One graph a gradient: a Function's backward computes what its
        # graph's inputs require, whichever one is asked for.
        ev, sk = evals.clone().requires_grad_(), sky.clone().requires_grad_()
        rows_ev = eval_mod.pair_rows(ev, pair_i, pair_j, sky, mask, ch_shape, False)
        rows_sk = eval_mod.pair_rows(evals, pair_i, pair_j, sk, mask, ch_shape, False)
        g = torch.complex(torch.randn(rows_ev.shape, dtype=dt, device="cuda"),
                          torch.randn(rows_ev.shape, dtype=dt, device="cuda"))

        def grad_of(rows, x):
            return lambda: torch.autograd.grad(rows, x, g, retain_graph=True)

        ms_ev, ms_sky = cuda_ms(grad_of(rows_ev, ev), 5), cuda_ms(grad_of(rows_sk, sk), 10)
        dev_ev, dev_sky = device_ms(grad_of(rows_ev, ev), 3), device_ms(grad_of(rows_sk, sk), 5)
        fwd = cuda_ms(lambda: eval_mod.pair_rows(evals, pair_i, pair_j, sky, mask, ch_shape,
                                                 False), 20)
        sk2 = sky.clone().requires_grad_()
        want = torch.autograd.grad(eval_mod.pair_rows_plain(evals, pair_i, pair_j, sk2, mask,
                                                            ch_shape, False), sk2, g)[0]
        got = grad_of(rows_sk, sk)()[0]
        err = ((got - want).abs().max() / want.abs().max()).item()
        print(f"[3] pair_rows backward {name}: K={K} P={pp.npairs} n={n} Jones x I: "
              f"evaluations (torch ops) {ms_ev:.4f} ms, device {dev_ev:.4f} ms; sky (unit-sky "
              f"rerun) {ms_sky:.4f} ms, device {dev_sky:.4f} ms, err {err:.3e} of the plain "
              f"rows' autograd; forward kernel {fwd:.4f} ms", flush=True)
        if not err <= TOL[name]:
            raise AssertionError(f"pair_rows sky gradient {name} disagrees: {err:.3e}")
        del rows_ev, rows_sk, g, ev, sk
        torch.cuda.empty_cache()


def check_adjoints(cfg, pa) -> dict:
    """Phase 3: the three adjoint kernels at the shapes their forward
    kernels are checked at, float32 and float64: spread_adjoint on the
    slice grids (C = 1 and 4, uniform and dense) and at the per-antenna
    run's C = 40; interp_adjoint on the slice executor's tables (C = 1 and
    4) and on every pair's target subset of the per-antenna executor (C =
    4); beam_eval_adjoint on (91, 360, 296) at order 1 and (91, 360, 8) at
    order 3. Returns {kernel: {dtype: row}} of the main shapes (C = 4
    uniform; C = 4 all targets; (91, 360, 296) order 1)."""
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.cuda.planning import plan_transform
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft.transform import Type3Executor, plan_type3

    ants, bls = cfg["ants"], cfg["baselines"]
    targets = np.array([ants[j][:2] - ants[i][:2] for i, j in bls]).T
    x_ext = 2 * np.pi * max(FREQS) / speed_of_light
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    out = {"spread_adjoint": {}, "interp_adjoint": {}, "beam_eval_adjoint": {}}
    _, _, pp = pair_arrays(pa)
    flipped = np.zeros(len(pa["baselines"]), dtype=bool)
    for sel, fl in zip(pp.bls_idxs, pp.flipped):
        flipped[sel] = fl
    pa_ex = plan_transform("type3", pa["ants"], pa["baselines"], pa["freqs"], 5e-7, 2, 1e-6,
                           False, flipped, len(pa["baselines"]), SPREAD_SOURCES, 2, pp.npairs,
                           device="cuda").executor
    for rdt, cdt, eps in ((torch.float32, torch.complex64, 5e-7),
                          (torch.float64, torch.complex128, 1e-13)):
        name = str(rdt).split(".")[-1]
        plan = plan_type3(targets, x_extent=x_ext, eps=eps)
        w, beta, nf = plan.kernel.w, plan.kernel.beta, plan.nf
        for C in (1, 4):
            for case in ("uniform", "dense"):
                row = check_spread_adjoint(name, rdt, cdt, nf, w, beta, C, case, rng)
                if (C, case) == (4, "uniform"):
                    out["spread_adjoint"][name] = row
        p = pa_ex.plan
        check_spread_adjoint(name, rdt, cdt, p.nf, p.kernel.w, p.kernel.beta, 4 * pp.npairs,
                             "uniform", rng, label=f" per-antenna ({pp.npairs} pairs)")
        ex = Type3Executor(plan, device="cuda")
        ti, tv, order, runs = ex._taps(rdt)
        plain = [torch.tensor(a, dtype=dt, device="cuda") for a, dt in
                 ((plan.tap_idx[0], torch.int32), (plan.tap_idx[1], torch.int32),
                  (plan.tap_val[0], rdt), (plan.tap_val[1], rdt))]
        for C in (1, 4):
            row = check_interp_adjoint(name, rdt, cdt, nf, (*ti, *tv), order, runs, plain, C,
                                       rng)
            if C == 4:
                out["interp_adjoint"][name] = row
        del ex, plain
        def subset(sel):
            ti, tv, order, runs = pa_ex._taps(rdt, sel)
            plain = [torch.tensor(a[sel], dtype=dt, device="cuda") for a, dt in
                     ((p.tap_idx[0], torch.int32), (p.tap_idx[1], torch.int32),
                      (p.tap_val[0], rdt), (p.tap_val[1], rdt))]
            return (*ti, *tv), order, runs, plain

        errs = []
        for sel in pp.bls_idxs:
            tabs, order, runs, plain = subset(sel)
            g = torch.complex(torch.randn((4, len(sel)), dtype=rdt, device="cuda"),
                              torch.randn((4, len(sel)), dtype=rdt, device="cuda"))
            got = interp_mod.interp_adjoint(g, *tabs, p.nf, order=order, runs=runs)
            want = interp_mod.interp_adjoint_plain(g, *plain, *p.nf)
            errs.append(((got - want).abs().max() / want.abs().max()).item())
            del got, want
        if not max(errs) <= TOL[name]:
            raise AssertionError(f"interp_adjoint {name} on a pair's subset: {max(errs):.3e}")
        big = max(pp.bls_idxs, key=len)
        check_interp_adjoint(name, rdt, cdt, p.nf, *subset(big), 4, rng,
                             label=f" subset (the largest, m={len(big)}; all {len(errs)} "
                             f"pairs' subsets max err {max(errs):.3e})")
        for ch, order in ((8 * NS_BEAMS, 1), (8, 3)):
            row = check_beam_eval_adjoint(ch, order, rdt, rng)
            if order == 1:
                out["beam_eval_adjoint"][name] = row
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- gradients

# Forward against simulate_vis on the card, relative to max|V|.
GRAD_FWD_TOL = {1: 1e-6, 2: 1e-12}
# Directional derivative against central differences of the float64 loss,
# Richardson-extrapolated from steps h and 2h: (8 D(h) - D(2h)) / 6 is
# exact for a loss of degree 4 or less along the line, which the engine's
# losses are in each parameter (linear in fluxes, bilinear in gains and in
# a polarized beam table), so only rounding is left: far below 1e-6 at
# precision 2; at precision 1 the forward rounds in float32, ~1e-5 of the
# derivative at a step of 1e-2.
GRAD_FD_TOL = {1: 1e-3, 2: 1e-6}
# The step: a fraction of the largest entry (fluxes, beam tables) or of 1
# (gains); positions take an absolute angle or length (the fringes make the
# direct front-end's loss no polynomial in them).
GRAD_FD_STEP = {1: 1e-2, 2: 1e-4}
GRAD_FD_ABS = {"ra": 1e-6, "dec": 1e-6, "antpos": 1e-5}
# Card against CPU gradients, relative to the largest entry: float64 sums
# in other orders (and atomics) at precision 2; float32 at precision 1.
GRAD_CPU_TOL = {1: 1e-4, 2: 1e-9}


def perturbed(params, rng, scale: float = 0.05) -> dict:
    """A seeded multiplicative perturbation of every parameter (gains: of
    their real and imaginary parts around 1 + 0j)."""
    import torch

    out = {}
    for k, p in params.items():
        a = p.detach().cpu().numpy()
        noise = rng.standard_normal(a.shape)
        a = a + scale * noise if k == "gains" else a * (1 + scale * noise)
        out[k] = torch.tensor(a, dtype=p.dtype, device=p.device)
    return out


def backward_busy_ms(loss, params) -> float:
    """Device time of one backward (every device-side event;
    torch.profiler), its forward outside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    value = loss(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(value, list(params.values()))
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if us is None else us
    return total / 1e3


def grad_setup(sim, params, seed: int):
    """The loss sum |sim - data|^2 in float64, data the forward at the
    seeded perturbation of the parameters."""
    import torch

    with torch.no_grad():
        data = sim(perturbed(params, np.random.default_rng(seed))).to(torch.complex128)

    def loss(p):
        return (sim(p).to(torch.complex128) - data).abs().pow(2).sum()
    return loss


def directional_checks(label, loss, params, grads, precision, seed: int) -> list:
    """The loss's derivative along a seeded random direction d in each
    parameter, <grad, d>, against the Richardson-extrapolated central
    difference (GRAD_FD_TOL); raises past it."""
    import torch

    rng = np.random.default_rng(seed + 1)
    step = GRAD_FD_STEP[precision]
    errs = []
    for (k, p), g in zip(params.items(), grads):
        base = p.detach()
        d = torch.tensor(rng.standard_normal(tuple(base.shape)), dtype=base.dtype,
                         device=base.device)
        if k in GRAD_FD_ABS:
            d = d * GRAD_FD_ABS[k]
        else:
            d = d * step * (1.0 if k == "gains" else base.abs().max())
        dl = float((g.double() * d.double()).sum())
        with torch.no_grad():
            def central(m):
                return (float(loss({**params, k: base + m * d}))
                        - float(loss({**params, k: base - m * d}))) / 2
            fd = (8 * central(1) - central(2)) / 6
        err = abs(dl - fd) / max(abs(dl), abs(fd))
        errs.append(f"{k} {err:.2e}")
        if not err <= GRAD_FD_TOL[precision]:
            raise AssertionError(f"{label}: {k} directional derivative {dl!r} against the "
                                 f"central difference {fd!r} ({err:.3e})")
    return errs


def grad_step(label, sim, params, loss, counters, want_adjoints) -> tuple:
    """One forward and backward on the card, timed, with the launch counts
    of both: every adjoint kernel of ``want_adjoints`` launched, none
    other. Returns (grads, launches, forward s, backward s)."""
    import torch

    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = loss(params)
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(value, list(params.values()))
    torch.cuda.synchronize()
    bwd = time.perf_counter() - t0
    got = read(counters)
    adjoints = [k for k in got if k.endswith("_adjoint")]
    if any((got[k] > 0) != (k in want_adjoints) for k in adjoints):
        raise AssertionError(f"{label}: launches {got}, want adjoints {want_adjoints}")
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError(f"{label}: a gradient is not finite")
    return grads, got, fwd, bwd


def gradient_run(label, build, kw, want_vis, precision, counters, want_adjoints, seed,
                 cpu_kw=None) -> dict:
    """Phase 8, one configuration: the forward against simulate_vis, one
    timed gradient step with its launches, the directional derivatives,
    the device busy of one backward and, with ``cpu_kw``, the card's
    gradients on that configuration against the port's on the CPU.
    Returns the step's launches."""
    import torch

    t0 = time.perf_counter()
    sim, params = build(device="cuda", **kw)
    built = time.perf_counter() - t0
    if want_vis is not None:
        with torch.no_grad():
            v = sim(params).cpu().numpy()
        fwd_err = max_rel(v, want_vis)
        if not fwd_err <= GRAD_FWD_TOL[precision]:
            raise AssertionError(f"{label}: sim_fn against simulate_vis {fwd_err:.3e}")
        fwd_txt = f"sim_fn vs simulate_vis {fwd_err:.3e} of max|V| (gate {GRAD_FWD_TOL[precision]:.0e})"
    else:
        fwd_txt = "sim_fn vs simulate_vis: none (the direct front-end)"
    loss = grad_setup(sim, params, seed)
    grads, got, fwd, bwd = grad_step(label, sim, params, loss, counters, want_adjoints)
    fd = directional_checks(label, loss, params, grads, precision, seed)
    busy = backward_busy_ms(loss, params)
    cpu_txt = ""
    if cpu_kw is not None:
        sim_c, params_c = build(device="cuda", **cpu_kw)
        loss_c = grad_setup(sim_c, params_c, seed)
        g_card = torch.autograd.grad(loss_c(params_c), list(params_c.values()))
        t0 = time.perf_counter()
        sim_h, params_h = build(device="cpu", **cpu_kw)
        loss_h = grad_setup(sim_h, params_h, seed)
        g_cpu = torch.autograd.grad(loss_h(params_h), list(params_h.values()))
        errs = {k: max_rel(a.cpu().numpy(), b.numpy())
                for k, a, b in zip(params_h, g_card, g_cpu)}
        cpu_txt = (f"; card vs CPU gradients ({len(cpu_kw['baselines'])} baselines, "
                   f"{time.perf_counter() - t0:.1f} s on the CPU): "
                   + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
                   + f" (gate {GRAD_CPU_TOL[precision]:.0e})")
        if not max(errs.values()) <= GRAD_CPU_TOL[precision]:
            raise AssertionError(f"{label}: card against CPU gradients {errs}")
        del sim_c, params_c, g_card
    shapes = ", ".join(f"{k} {tuple(p.shape)}" for k, p in params.items())
    print(f"[8] gradients {label}: params {shapes}; {fwd_txt}; directional derivative vs "
          f"central difference (gate {GRAD_FD_TOL[precision]:.0e}): {', '.join(fd)}{cpu_txt}; "
          f"launches of one step {got}; build {built:.3f} s, forward {fwd:.3f} s, backward "
          f"{bwd:.3f} s, backward device busy {busy:.3f} ms", flush=True)
    del sim, params, grads
    torch.cuda.empty_cache()
    return got


def direct_config():
    """Run (d): hex_array(4) (37 antennas, all 703 i <= j baselines), the
    nside=32 sky after the cull, GaussianBeam(14), 1 frequency x 2 times,
    precision 2."""
    from fftvis_tpu_torch import TelescopeLocation
    from fftvis_tpu_torch.beams import GaussianBeam
    from fftvis_tpu_torch.coords.rotation import SourceRotation
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(4, sep=14.6)
    keys = list(ants)
    ra, dec = healpix_radec(32)
    kw = dict(ants=ants, freqs=np.array(NS_FREQS), times=NS_TIMES,
              telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT))
    keep = SourceRotation(ra, dec, kw["times"], kw["telescope_loc"]).cull_never_visible()
    if keep is not None:
        ra, dec = ra[keep], dec[keep]
    rng = np.random.default_rng(4)
    return dict(kw, ra=ra, dec=dec, fluxes=rng.uniform(0.1, 1.0, (ra.size, 1)),
                beam=GaussianBeam(diameter=14.0), polarized=False, precision=2,
                baselines=[(keys[i], keys[j]) for i in range(len(keys))
                           for j in range(i, len(keys))])


def gradient_runs(cfg, ns, pa, counters) -> dict:
    """Phase 8: the differentiable front-ends on the card, (a)-(e), at the
    sizes the module docstring gives. Returns {run: launches of its
    gradient step}."""
    import functools

    from fftvis_tpu_torch import (build_differentiable_direct_sim, build_differentiable_sim,
                                  simulate_vis)

    launches = {}
    # (a) The north star's beam calibration: fluxes, the stacked table of
    # its 37 beams and gains, exact type-1, precision 2; card against CPU
    # on every 8th representative baseline.
    kw = dict(ns, precision=2)
    want = simulate_vis(device="cuda", **kw)
    launches["a"] = gradient_run(
        f"(a) north-star hera-{len(ns['ants'])} {NS_BEAMS} beams precision=2 exact type-1",
        functools.partial(build_differentiable_sim, differentiate_beam=True,
                          differentiate_gains=True),
        kw, want, 2, counters, ("beam_eval_adjoint",), seed=31,
        cpu_kw=dict(kw, baselines=ns["baselines"][::8]))
    # (b) Forced type-3 on the slice, the committed beam polarized at order
    # 3: fluxes and gains (spread, interp and beam_rows backward).
    for precision, nfreq, ntimes in ((1, 2, 3), (2, 1, 1)):
        kw = dict(run_kwargs(cfg, RUNS[2]), precision=precision,
                  fluxes=cfg["fluxes"][:, :nfreq], freqs=cfg["freqs"][:nfreq],
                  times=cfg["times"][:ntimes])
        want = simulate_vis(device="cuda", **kw)
        launches[f"b{precision}"] = gradient_run(
            f"(b) slice hex-{len(cfg['ants'])} polarized tabulated type-3 precision={precision} "
            f"{nfreq} f x {ntimes} t",
            functools.partial(build_differentiable_sim, differentiate_gains=True),
            kw, want, precision, counters, ("spread_adjoint", "interp_adjoint"), seed=32)
    # (c) Per-antenna type-3 with the stacked table differentiated (beam_eval
    # and pair_rows backward with spread and interp).
    want = run_mode(pa, "type3")
    launches["c"] = gradient_run(
        f"(c) per-antenna type-3 {PA_BEAMS} beams precision=1",
        functools.partial(build_differentiable_sim, differentiate_beam=True,
                          differentiate_gains=True, nufft_mode="type3"),
        pa, want, 1, counters, ("spread_adjoint", "interp_adjoint", "beam_eval_adjoint"),
        seed=33)
    # (d) The direct front-end in the geometry; card against CPU.
    dkw = direct_config()
    launches["d"] = gradient_run(
        f"(d) direct front-end hex-{len(dkw['ants'])} nside 32 ({dkw['ra'].size} sources) "
        "precision=2",
        functools.partial(build_differentiable_direct_sim, differentiate_positions=True,
                          differentiate_antpos=True, differentiate_gains=True),
        dkw, None, 2, counters, (), seed=34, cpu_kw=dkw)
    # (e) ES type-1 on the gridded row (this slice's (a)), precision 2,
    # fluxes and gains through the spread's adjoint, the FFT and the
    # deconvolved gather; card against CPU on every 8th baseline.
    kw = dict(es_row_config(cfg), precision=2)
    with type1_env("es"):
        want = simulate_vis(device="cuda", **kw)
        launches["e"] = gradient_run(
            f"(e) gridded row hex-{len(cfg['ants'])} FFTVIS_TYPE1=es precision=2",
            functools.partial(build_differentiable_sim, differentiate_gains=True),
            kw, want, 2, counters, ("spread_adjoint",), seed=35,
            cpu_kw=dict(kw, baselines=kw["baselines"][::8]))
    return launches


def reset(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read(counters) -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print("[1] card (nvidia-smi name, power.limit):", flush=True)
    print(card_line(), flush=True)

    from fftvis_tpu_torch import clear_caches, simulate_vis
    from fftvis_tpu_torch._build import load_kernels
    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod

    t0 = time.perf_counter()
    load_kernels()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = slice_config()
    ns = north_star_config()
    checks = check_nufft_kernels(cfg)
    pa = per_antenna_config(cfg)
    check_per_antenna_nufft(pa)
    beam_checks = {"beam_eval": check_beam_eval(), "beam_rows": check_beam_rows(),
                   "pair_rows": check_pair_rows(ns)}
    eig = eigen_row_config()
    for extra in (check_pair_rows_wide(ns), check_pair_rows_basis(eig, ns)):
        for name, err in extra.items():
            row = beam_checks["pair_rows"][name]
            beam_checks["pair_rows"][name] = (max(row[0], err), *row[1:])
    check_type1_exact(ns)
    z3d = z3d_config()
    check_noncoplanar_nufft(z3d)
    adj_checks = check_adjoints(cfg, pa)
    check_pair_rows_backward(ns)
    nd_checks = check_es_kernels(es_row_config(cfg), outrigger_config(cfg))

    # Each kernel's launch counter: (module, attribute).
    counters = {"spread": (spread_mod, "launches"), "interp": (interp_mod, "launches"),
                "beam_eval": (eval_mod, "launches"), "beam_rows": (eval_mod, "rows_launches"),
                "pair_rows": (eval_mod, "pair_launches"),
                "spread_d1": (spread_mod, "launches_d1"), "spread_d3": (spread_mod, "launches_d3"),
                "interp_d1": (interp_mod, "launches_d1"), "interp_d3": (interp_mod, "launches_d3")}
    public_launches = public_nufft(counters)
    nbl = len(cfg["baselines"])
    vis, launches = {}, {}
    clear_caches()
    for i, run in enumerate(RUNS):
        kind, beam, polarized, _, precision = run
        kw = run_kwargs(cfg, run)
        reset(counters)
        t0 = time.perf_counter()
        out = simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches[i] = read(counters)
        want_shape = (len(FREQS), 3) + ((2, 2) if polarized else ()) + (nbl,)
        if out.shape != want_shape or not np.all(np.isfinite(out)):
            raise AssertionError(
                f"{kind} precision={precision}: shape {out.shape} (want {want_shape}), "
                f"finite={bool(np.all(np.isfinite(out)))}"
            )
        path = ("spread", "interp") + (("beam_rows",) if beam == "tabulated" else ())
        # One fused beam_rows a source block of a tabulated run (as many as
        # spreads), and no interpolation alone on the main path.
        rows_want = launches[i]["spread"] if beam == "tabulated" else 0
        if (min(launches[i][k] for k in path) <= 0 or launches[i]["beam_eval"] != 0
                or launches[i]["beam_rows"] != rows_want or launches[i]["pair_rows"] != 0):
            raise AssertionError(f"{kind} precision={precision}: kernel launches {launches[i]}")
        t0 = time.perf_counter()
        simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        vis[i] = out
        print(f"[4] simulate_vis {kind} {beam} precision={precision}: {out.shape} {out.dtype}, "
              f"finite; launches {launches[i]}; wall first {first:.3f} s, "
              f"second {second:.3f} s", flush=True)

    # The north star: the stacked beam_eval and pair_rows once a source
    # block, and no spread, interp or fused single-beam rows (exact type-1).
    ns_blocks = source_blocks(ns)[0]
    ns_nbl = len(ns["baselines"])
    ns_vis, ns_launches = {}, {}
    for precision in NS_PRECISIONS:
        reset(counters)
        t0 = time.perf_counter()
        out = simulate_vis(device="cuda", precision=precision, **ns)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        got = ns_launches[precision] = read(counters)
        want_shape = (1, 2, 2, 2, ns_nbl)
        if out.shape != want_shape or not np.all(np.isfinite(out)):
            raise AssertionError(f"north star precision={precision}: shape {out.shape} (want "
                                 f"{want_shape}), finite={bool(np.all(np.isfinite(out)))}")
        if (got["beam_eval"] != ns_blocks or got["pair_rows"] != ns_blocks
                or got["spread"] or got["interp"] or got["beam_rows"]):
            raise AssertionError(f"north star precision={precision}: kernel launches {got} "
                                 f"({ns_blocks} source blocks)")
        t0 = time.perf_counter()
        simulate_vis(device="cuda", precision=precision, **ns)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        ns_vis[precision] = out
        print(f"[4] simulate_vis north-star hera-{len(ns['ants'])} {NS_BEAMS} beams "
              f"precision={precision}: {out.shape} {out.dtype}, finite; {ns_nbl} baselines, "
              f"{ns_blocks} source blocks; launches {got}; wall first {first:.3f} s, second "
              f"{second:.3f} s", flush=True)
    north_star_auto_rank_runs(ns, counters, ns_launches[1], ns_vis[1])

    # The eigen row: eigenbeams with beam_coefs on the exact type-1 path,
    # the stacked beam_eval and pair_rows once a source block.
    eig_blocks = source_blocks(eig)[0]
    reset(counters)
    t0 = time.perf_counter()
    eig_vis = simulate_vis(device="cuda", **eig)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    got = read(counters)
    K = len(eig["beam"])
    want_shape = (1, len(EIGEN_TIMES), 2, 2)
    if eig_vis.shape[:4] != want_shape or not np.all(np.isfinite(eig_vis)):
        raise AssertionError(f"eigen row: shape {eig_vis.shape}, finite="
                             f"{bool(np.all(np.isfinite(eig_vis)))}")
    if (got["beam_eval"] != eig_blocks or got["pair_rows"] != eig_blocks
            or got["spread"] or got["interp"] or got["beam_rows"]):
        raise AssertionError(f"eigen row: kernel launches {got} ({eig_blocks} source blocks)")
    t0 = time.perf_counter()
    simulate_vis(device="cuda", **eig)
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    print(f"[4] simulate_vis eigen row hex-{len(eig['ants'])} K={K} eigenbeams (table "
          f"{eig['beam'][0].data_array.shape}, {K * (K + 1) // 2} pairs, "
          f"{2 * K * (K + 1)} channels) precision=2: {eig_vis.shape} {eig_vis.dtype}, finite; "
          f"{eig_blocks} source blocks; launches {got}; wall first {first:.3f} s, second "
          f"{second:.3f} s", flush=True)

    # Per-antenna type-3 at reduced depth: one spread a block for all the
    # pairs' channels, one interpolation a pair.
    pa_blocks = source_blocks(pa)[0]
    npairs = pair_arrays(pa)[2].npairs
    reset(counters)
    t0 = time.perf_counter()
    pa_vis = run_mode(pa, "type3")
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    got = read(counters)
    want_shape = (1, 1, 2, 2, nbl)
    if pa_vis.shape != want_shape or not np.all(np.isfinite(pa_vis)):
        raise AssertionError(f"per-antenna type-3: shape {pa_vis.shape} (want {want_shape}), "
                             f"finite={bool(np.all(np.isfinite(pa_vis)))}")
    if (got["spread"] != pa_blocks or got["beam_eval"] != pa_blocks
            or got["pair_rows"] != pa_blocks or got["interp"] != npairs or got["beam_rows"]):
        raise AssertionError(f"per-antenna type-3: kernel launches {got} ({pa_blocks} source "
                             f"blocks, {npairs} pairs)")
    print(f"[4] per-antenna type-3, {PA_BEAMS} beams ({npairs} pairs, {4 * npairs} channels) "
          f"precision=1: {pa_vis.shape} {pa_vis.dtype}, finite; launches {got}; wall "
          f"{first:.3f} s", flush=True)

    # The JAX bench's 3D and 24h rows at their full size.
    z_vis = run_z3d(z3d, counters)
    obs = obs24_config()
    obs_vis = run_obs24(obs, counters)
    # ES type-1: (a), (b) and (c).
    es = es_runs(cfg, ns, ns_vis[2], counters)

    held = cache_device_bytes()
    print(f"[4] after phase 4 the caches hold {sum(held.values()) / 1e6:.1f} MB on the card: "
          + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in held.items()), flush=True)

    # The oracle: the port's float64 direct path on the CPU, where every
    # kernel takes its plain version, on every 32nd baseline.
    sub = cfg["baselines"][::32]
    oracles = {}
    for i, run in enumerate(RUNS):
        key = repr(run[1:4])
        if key not in oracles:
            kw = dict(run_kwargs(cfg, run), baselines=sub, precision=2)
            t0 = time.perf_counter()
            oracles[key] = direct_oracle(kw)
            print(f"[5] fp64 direct path on the CPU, {run[0]} {run[1]}: {len(sub)} baselines "
                  f"in {time.perf_counter() - t0:.3f} s", flush=True)
        oracle = oracles[key]
        scale = np.abs(oracle).max()
        err = np.abs(vis[i][..., ::32] - oracle).max() / scale
        print(f"[5] {run[0]} {run[1]} precision={run[4]} vs fp64 direct: max err {err:.3e} "
              f"of max|V| (gate {ORACLE_GATE[run[4]]:.0e})", flush=True)
        if not err <= ORACLE_GATE[run[4]]:
            raise AssertionError(f"{run[0]} precision={run[4]} misses its accuracy gate")
    new_runs = [(f"north-star precision={p}", ns, ns_vis[p], p) for p in NS_PRECISIONS]
    new_runs.append(("per-antenna type-3 precision=1", pa, pa_vis, 1))
    for label, kw, got_vis, precision in new_runs:
        sub = kw["baselines"][::32]
        okw = dict(kw, baselines=sub, precision=2)
        t0 = time.perf_counter()
        oracle = direct_oracle(okw)
        scale = np.abs(oracle).max()
        err = np.abs(got_vis[..., ::32] - oracle).max() / scale
        print(f"[5] {label} vs fp64 direct ({len(sub)} baselines, {time.perf_counter() - t0:.3f}"
              f" s on the CPU): max err {err:.3e} of max|V| (gate "
              f"{ORACLE_GATE[precision]:.0e})", flush=True)
        if not err <= ORACLE_GATE[precision]:
            raise AssertionError(f"{label} misses its accuracy gate")
    # The eigen row on every baseline: the direct path runs the same basis
    # semantics (the k <= l list with transpose reuse) on the CPU.
    t0 = time.perf_counter()
    oracle = direct_oracle(eig)
    err = max_rel(eig_vis, oracle)
    print(f"[5] eigen row precision=2 vs fp64 direct ({oracle.shape[-1]} baselines, "
          f"{time.perf_counter() - t0:.3f} s on the CPU): max err {err:.3e} of max|V| (gate "
          f"{ORACLE_GATE[2]:.0e})", flush=True)
    if not err <= ORACLE_GATE[2]:
        raise AssertionError("the eigen row misses its accuracy gate")
    check_new_rows(z3d, z_vis, obs, obs_vis)
    check_es_runs(es)

    if "--profile" in sys.argv[1:]:
        profile_runs(cfg, ns, z3d, obs, es)

    # The host layer: warm calls, pipelined futures, chunking, syncs.
    for precision in NS_PRECISIONS:
        warm_calls(f"north-star precision={precision}", dict(ns, precision=precision), counters,
                   ns_launches[precision])
    warm_calls("polarized tabulated slice precision=1", run_kwargs(cfg, RUNS[2]), counters,
               launches[2])
    pipelined("north-star precision=1", dict(ns, precision=1))
    pipelined(f"gridded row hex-{len(cfg['ants'])} unpolarized precision=2",
              gridded_row_config(cfg))
    pipelined(f"eigen row hex-{len(eig['ants'])} K={len(eig['beam'])} precision=2", eig)
    chunked(ns, counters, ns_vis[1])
    sync_count(ns)
    banding_walls(obs)

    # The gradients: every adjoint kernel's launches counted with the rest.
    grad_counters = dict(counters, spread_adjoint=(spread_mod, "adjoint_launches"),
                         interp_adjoint=(interp_mod, "adjoint_launches"),
                         beam_eval_adjoint=(eval_mod, "adjoint_launches"))
    grad_launches = gradient_runs(cfg, ns, pa, grad_counters)

    main_run = {1: 2, 2: 3}  # RUNS index of the polarized tabulated slice
    kernels = []
    for kname, source, replaces in (
        ("spread", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("interp", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
        ("beam_eval", "fftvis_tpu_torch/csrc/beam_eval.cu", "fftvis_tpu/beams/pallas_eval.py:287"),
        ("beam_rows", "fftvis_tpu_torch/csrc/beam_eval.cu", "fftvis_tpu/beams/pallas_eval.py:287"),
        # No Pallas kernel: the XLA ops of the batched pair rows.
        ("pair_rows", "fftvis_tpu_torch/csrc/beam_eval.cu", "fftvis_tpu/tpu/program.py:340"),
    ):
        for precision, dname in ((1, "float32"), (2, "float64")):
            if kname in beam_checks:
                err, ms, plain_ms, (b_ms, b_by), lib_ms = beam_checks[kname][dname]
            else:
                err, ms, plain_ms, (b_ms, b_by), lib_ms = checks[dname][kname]
            # The per-antenna kernels' launches are the north star's.
            if kname in ("beam_eval", "pair_rows"):
                count = ns_launches[precision][kname]
            else:
                count = launches[main_run[precision]][kname]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": count,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": lib_ms,
            })
    # The adjoints' launches: one gradient step of the runs that take their
    # path, (b) at precision 1 and 2 for spread and interp, (c) (float32)
    # and (a) (float64) for the table's interpolation.
    for kname, source, replaces, run_of in (
        ("spread_adjoint", "fftvis_tpu_torch/csrc/spread.cu",
         "fftvis_tpu/nufft/pallas_spread.py:219", {1: "b1", 2: "b2"}),
        ("interp_adjoint", "fftvis_tpu_torch/csrc/interp.cu",
         "fftvis_tpu/nufft/pallas_interp.py:162", {1: "b1", 2: "b2"}),
        ("beam_eval_adjoint", "fftvis_tpu_torch/csrc/beam_eval.cu",
         "fftvis_tpu/beams/pallas_eval.py:287", {1: "c", 2: "a"}),
    ):
        for precision, dname in ((1, "float32"), (2, "float64")):
            err, ms, plain_ms, (b_ms, b_by), lib_ms = adj_checks[kname][dname]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": grad_launches[run_of[precision]][kname],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": lib_ms,
            })
    # The d = 1 / 3 entries: their launches are the public NUFFT run's.
    for kname, source, replaces in (
        ("spread_d1", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("spread_d3", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("interp_d1", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
        ("interp_d3", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
    ):
        for dname in ("float32", "float64"):
            err, ms, plain_ms, (b_ms, b_by), lib_ms = nd_checks[f"{kname}_{dname}"]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": public_launches[dname][kname],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": lib_ms,
            })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
