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
   - the exact type-1 product (cuBLAS, not a hand-written kernel) at the
     north star's C = 720 channels, 4096 sources and (42, 42) mode grid,
     float32 and float64 (one call by CUDA events and its device time
     alone), beside its operations bound and the factored form the port
     does not take;
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
     and beam_rows never;
   - per-antenna type-3 at reduced depth: the slice array, 4 variants
     (``beam_idx = arange(355) % 4``, 10 pairs, 40 channels), polarized,
     precision 1, 1 frequency x 1 time, type-3 forced through
     ``CUDASimulationEngine(nufft_mode="type3")``: spread, beam_eval and
     pair_rows once a source block, interp once a pair;
   phase 4 starts from empty caches and ends with the bytes they hold on
   the card;
5. hold every output against the port's float64 direct path on the CPU,
   where every kernel takes its plain version, on every 32nd baseline
   (gates 1e-4 at precision 1, 1e-5 at precision 2, relative to max|V|);
6. with ``--profile`` only: torch.profiler over one warm call of the
   analytic p=1, polarized p=1 and p=2, unpolarized tabulated and north
   star p=2 and p=1 runs (after five timed warm calls each): device busy
   time, idle share, the count of device kernel launches, and the
   hand-written kernels' device time and launches; the top device ops of
   each run go to ``build/profile/profile_<i>.txt``;
7. the host layer:
   - warm calls: the north star at precision 2 and 1 and the polarized
     tabulated slice at precision 1, from empty caches one cold call and
     five warm ones: each wall, the caches' hits and misses, the host
     seconds of prepare_beams, stack_prepared and plan_transform, and of
     the cache keys (hash_parts), in a warm call (cProfile); every warm
     result within WARM_TOL of the cold one, every call's launches those
     of phase 4;
   - async_fetch: the north star at precision 1 and the JAX bench's
     gridded row (``bench.py:340-415``: the slice array and sky,
     GaussianBeam(14), unpolarized, precision 2, the exact type-1 path):
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
8. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
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
                 label: str = ""):
    """One phase-3 spread case through the wrapper against its plain
    version on the same card tensors; ``sparse.addmm`` beside the uniform
    case. Returns (err, ms, plain_ms, (bound_ms, bound_by), library_ms)."""
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
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms; bound {b_ms:.4f} ms "
          f"({b_by}, {cells} cells){lib_txt or ''}", flush=True)
    if not err <= TOL[name] * scale:
        raise AssertionError(f"spread {name} {case} C={C} disagrees with its plain version")
    del want
    torch.cuda.empty_cache()
    return err, ms, plain, (b_ms, b_by), lib_ms


def check_nufft_kernels(cfg) -> dict:
    """Phase 3: spread and interp against their plain versions at the
    slice's grids, with C = 1 (unpolarized) and C = 4 (polarized)
    channels. Returns {dtype: {kernel: row}} for the uniform C = 4 case,
    row = (err, ms, plain_ms, (bound_ms, bound_by), library_ms)."""
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.nufft import interp as interp_mod
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

        def dev(a, dtype):
            return torch.tensor(a, dtype=dtype, device="cuda")

        iy, ix = (dev(a, torch.int32) for a in plan.tap_idx)
        vy, vx = (dev(a, rdt) for a in plan.tap_val)
        # The executor's tables: rows in target order, the order and the runs.
        order_np = interp_mod.target_order(plan.tap_idx[0][:, 0], plan.tap_idx[1][:, 0])
        order = dev(order_np, torch.int32)
        runs = dev(interp_mod.footprint_runs(*(a[order_np] for a in plan.tap_idx)), torch.int32)
        tabs = [dev(a[order_np], torch.int32) for a in plan.tap_idx]
        tabs += [dev(a[order_np], rdt) for a in plan.tap_val]
        results[name] = {}
        for C in (1, 4):
            for case in ("uniform", "dense", "half-zero"):
                row = check_spread(name, rdt, cdt, (nfy, nfx), w, beta, C, case, rng)
                if case == "uniform" and C == 4:
                    results[name]["spread"] = row

            G = dev(rng.normal(size=(C, nfy, nfx)) + 1j * rng.normal(size=(C, nfy, nfx)), cdt)
            got = interp_mod.interp(G, *tabs, order=order, runs=runs)
            want = interp_mod.interp_plain(G, iy, ix, vy, vx)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            i_err = (got - want).abs().max().item()
            i_ms = cuda_ms(lambda: interp_mod.interp(G, *tabs, order=order, runs=runs), 20)
            i_plain = cuda_ms(lambda: interp_mod.interp_plain(G, iy, ix, vy, vx), 5)
            (b_ms, b_by), cells = interp_bound(plan.tap_idx[0], plan.tap_idx[1], C, nfx, name)
            lib_ms, lib_txt = None, ""
            lib = library(f"interp {name} C={C}", lambda: interp_library(G, iy, ix, vy, vx))
            if lib is not None:
                lib_err = (lib().T - want).abs().max().item()
                lib_ms = cuda_ms(lib, 10)
                lib_txt = f"; sparse.mm {lib_ms:.4f} ms (err {lib_err / scale:.1e})"
            print(f"[3] interp {name}: grid ({nfy}, {nfx}) w={w} m={iy.shape[0]} C={C}: "
                  f"max err {i_err:.3e} = {i_err / scale:.3e} of max|plain|; "
                  f"kernel {i_ms:.4f} ms, plain {i_plain:.4f} ms; bound {b_ms:.4f} ms "
                  f"({b_by}, {cells} cells){lib_txt}", flush=True)
            if not i_err <= TOL[name] * scale:
                raise AssertionError(f"interp {name} C={C} disagrees with its plain version")
            if C == 4:
                results[name]["interp"] = (i_err, i_ms, i_plain, (b_ms, b_by), lib_ms)
            del G, got, want, lib
            torch.cuda.empty_cache()
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
    cases = [(ch, order, dt) for ch in (8, 2) for order in (3, 1)
             for dt in (torch.float32, torch.float64)]
    cases += [(8 * NS_BEAMS, 3, torch.float32), (8 * NS_BEAMS, 1, torch.float32),
              (8 * NS_BEAMS, 1, torch.float64)]
    results = {}
    for ch, order, dt in cases:
        name = str(dt).split(".")[-1]
        ny, nx = 91, 360
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
        main = (ch, order) == (8 * NS_BEAMS, 1)
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
    device time alone, beside the factored form. cuBLAS, not a hand-written
    kernel: no kernels entry."""
    import torch

    from fftvis_tpu_torch.cuda.engine import full_precision_matmuls
    from fftvis_tpu_torch.cuda.planning import plan_transform

    full_precision_matmuls()
    _, _, pp = pair_arrays(ns)
    flipped = np.zeros(len(ns["baselines"]), dtype=bool)
    for sel, fl in zip(pp.bls_idxs, pp.flipped):
        flipped[sel] = fl
    plan = plan_transform("auto", ns["ants"], ns["baselines"], ns["freqs"], 1e-13, 2, 1e-6,
                          False, flipped, len(ns["baselines"]), 4096, 2, pp.npairs,
                          device="cuda")
    ex = plan.executor
    nf, C, n = ex.plan.nf, 4 * pp.npairs, 4096
    rng = np.random.default_rng(5)
    for rdt, cdt in ((torch.float32, torch.complex64), (torch.float64, torch.complex128)):
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
                                        kw["polarized"], None, "x", len(kw["ants"]),
                                        kw.get("beam_idx"))
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx", "force_use_type3")}
    return CUDASimulationEngine(nufft_mode="direct", device="cpu").simulate(
        beam_list=beams, beam_idx=beam_idx, **ekw)


def run_per_antenna_type3(kw):
    """A per-antenna run with type-3 forced, through the engine."""
    from fftvis_tpu_torch import CUDASimulationEngine
    from fftvis_tpu_torch.wrapper import prepare_beam_list

    beams, beam_idx = prepare_beam_list(kw["beam"], kw["freqs"], True, None, "x",
                                        len(kw["ants"]), kw["beam_idx"])
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "beam_idx")}
    return CUDASimulationEngine(nufft_mode="type3", device="cuda").simulate(
        beam_list=beams, beam_idx=beam_idx, **ekw)


PROFILE_RUNS = (0, 2, 3, 4)  # RUNS indices: analytic p=1 and the tabulated runs
KERNEL_NAMES = {"spread": "spread_gm", "interp": "interp_runs", "beam_eval": "beam_eval_points",
                "beam_rows": "beam_rows_points", "pair_rows": "pair_rows_points"}


def profile_runs(cfg, ns) -> None:
    """Phase 6: five timed warm calls, then one profiled call, of each of
    PROFILE_RUNS and the north-star runs; device time from the profiler's
    CUDA kernel events."""
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
    for i, label, kw in calls:
        walls = []
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
        mine = []
        for kname, sym in KERNEL_NAMES.items():
            hits = [r for r in rows if sym in r[2]]
            if hits:
                us, count = sum(r[0] for r in hits), sum(r[1] for r in hits)
                mine.append(f"{kname} {us / 1e3:.4f} ms / {count} = {us / count:.2f} us")
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
    for name, err in check_pair_rows_wide(ns).items():
        row = beam_checks["pair_rows"][name]
        beam_checks["pair_rows"][name] = (max(row[0], err), *row[1:])
    check_type1_exact(ns)

    # Each kernel's launch counter: (module, attribute).
    counters = {"spread": (spread_mod, "launches"), "interp": (interp_mod, "launches"),
                "beam_eval": (eval_mod, "launches"), "beam_rows": (eval_mod, "rows_launches"),
                "pair_rows": (eval_mod, "pair_launches")}
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

    # Per-antenna type-3 at reduced depth: one spread a block for all the
    # pairs' channels, one interpolation a pair.
    pa_blocks = source_blocks(pa)[0]
    npairs = pair_arrays(pa)[2].npairs
    reset(counters)
    t0 = time.perf_counter()
    pa_vis = run_per_antenna_type3(pa)
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

    if "--profile" in sys.argv[1:]:
        profile_runs(cfg, ns)

    # The host layer: warm calls, pipelined futures, chunking, syncs.
    for precision in NS_PRECISIONS:
        warm_calls(f"north-star precision={precision}", dict(ns, precision=precision), counters,
                   ns_launches[precision])
    warm_calls("polarized tabulated slice precision=1", run_kwargs(cfg, RUNS[2]), counters,
               launches[2])
    pipelined("north-star precision=1", dict(ns, precision=1))
    pipelined(f"gridded row hex-{len(cfg['ants'])} unpolarized precision=2",
              gridded_row_config(cfg))
    chunked(ns, counters, ns_vis[1])
    sync_count(ns)

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
