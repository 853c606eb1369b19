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
   - gates 1e-5 / 1e-12 of max|plain|;
   - beam_eval on the tabulated beam's tables, (91, 360, 8) polarized and
     (91, 360, 2) power, 4096 points with seam and edge-row points, orders
     1 and 3, float32 and float64, wrapped azimuth; and the (91, 360, 296)
     stacked shape at order 3 in float32; gate 2e-6 / 1e-12 of max|plain|;
     yardstick at order 1 ``grid_sample`` (bilinear, align_corners) on the
     table with its seam column appended; order 3 has none (``bicubic`` is
     Keys' convolution, not the B-spline);
4. run ``simulate_vis`` on the slice configuration -- hex_array(11,
   outriggers=2) with all 63,190 i<=j baselines, the nside=64 HEALPix sky,
   2 frequencies x 3 times, forced type-3 -- with
   - GaussianBeam(14), unpolarized, at precision 1 and 2;
   - the committed ``tests/data/structured_dipole_100MHz.beamfits`` read by
     ``read_beamfits``: polarized with the order-3 spline at precision 1
     and 2, and unpolarized at order 1, precision 1;
   each run with the launch counts set to 0 just before it and read just
   after, and each of its kernels launched at least once;
5. hold every output against the port's float64 direct path on the CPU,
   where every kernel takes its plain version, on every 32nd baseline
   (gates 1e-4 at precision 1, 1e-5 at precision 2, relative to max|V|);
6. with ``--profile`` only: torch.profiler over one warm call of the
   analytic p=1, polarized p=1 and p=2 and unpolarized tabulated runs
   (after five timed warm calls each): device busy time, idle share, and
   the hand-written kernels' device time and launches; the top device ops
   of each run go to ``build/profile/profile_<i>.txt``;
7. print the kernels' JSON line, then the result line.
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
ASSET = Path(__file__).resolve().parent / "tests" / "data" / "structured_dipole_100MHz.beamfits"
# (name, beam, polarized, beam_spline_opts, precision) of the phase-4 runs.
RUNS = (
    ("analytic", "gaussian", False, None, 1),
    ("analytic", "gaussian", False, None, 2),
    ("polarized", "tabulated", True, {"order": 3}, 1),
    ("polarized", "tabulated", True, {"order": 3}, 2),
    ("unpolarized", "tabulated", False, {"order": 1}, 1),
)


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
    return uy, ux, wts


def check_nufft_kernels(cfg) -> dict:
    """Phase 3: spread and interp against their plain versions at the
    slice's grids, with C = 1 (unpolarized) and C = 4 (polarized)
    channels. Returns {dtype: {kernel: row}} for the uniform C = 4 case,
    row = (err, ms, plain_ms, (bound_ms, bound_by), library_ms)."""
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod
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
                uy_np, ux_np, w_np = spread_sources(case, nfy, nfx, C, rng)
                uy, ux, wts = dev(uy_np, rdt), dev(ux_np, rdt), dev(w_np, cdt)
                got = spread_mod.spread(uy, ux, wts, torch.zeros((C, nfy, nfx), dtype=cdt, device="cuda"), w, beta)
                want = spread_mod.spread_plain(uy, ux, wts, torch.zeros_like(got), w, beta)
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                s_err = (got - want).abs().max().item()
                acc = torch.zeros_like(got)
                s_ms = cuda_ms(lambda: spread_mod.spread(uy, ux, wts, acc, w, beta), 20)
                s_plain = cuda_ms(lambda: spread_mod.spread_plain(uy, ux, wts, acc, w, beta), 5)
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
                print(f"[3] spread {name} {case}: grid ({nfy}, {nfx}) w={w} n={SPREAD_SOURCES} "
                      f"C={C}: max err {s_err:.3e} = {s_err / scale:.3e} of max|plain|; "
                      f"kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms; bound {b_ms:.4f} ms "
                      f"({b_by}, {cells} cells){lib_txt or ''}", flush=True)
                if not s_err <= TOL[name] * scale:
                    raise AssertionError(f"spread {name} {case} C={C} disagrees with its plain version")
                if case == "uniform" and C == 4:
                    results[name]["spread"] = (s_err, s_ms, s_plain, (b_ms, b_by), lib_ms)
                del want
                torch.cuda.empty_cache()

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
    beam's tables. Returns {dtype: (max err, ms, plain_ms, bound, None)},
    the times those of the polarized order-3 table (no library call
    computes the cubic B-spline)."""
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod

    rng = np.random.default_rng(2)
    cases = [(ch, order, dt) for ch in (8, 2) for order in (3, 1)
             for dt in (torch.float32, torch.float64)]
    cases.append((296, 3, torch.float32))
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
        ms = cuda_ms(lambda: eval_mod.beam_eval(data, y, x, order=order, wrap_x=True), 50)
        plain = cuda_ms(lambda: eval_mod.beam_eval_plain(data, y, x, order=order, wrap_x=True), 20)
        (b_ms, b_by), cells = beam_bound(data, y, x, order, name)
        if order == 1:
            lib = beam_grid_sample(data, y, x)
            lib_err = (lib()[0, :, 0, :].T - want).abs().max().item()
            lib_txt = (f"grid_sample {cuda_ms(lib, 50):.4f} ms "
                       f"(err {lib_err / scale:.1e})")
        else:
            lib_txt = "library call: none (bicubic is Keys' convolution, not the B-spline)"
        print(f"[3] beam_eval {name}: table ({ny}, {nx}, {ch}) order {order} n=4096: "
              f"max err {err:.3e} = {err / scale:.3e} of max|plain|; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms; bound {b_ms:.5f} ms "
              f"({b_by}, {cells} cells); {lib_txt}", flush=True)
        if not err <= BEAM_TOL[name] * scale:
            raise AssertionError(f"beam_eval {name} {(ch, order)} disagrees with its plain version")
        prev = results.get(name, (0.0, None, None, None, None))
        timed = (ms, plain, (b_ms, b_by), None) if (ch, order) == (8, 3) else prev[1:]
        results[name] = (max(prev[0], err), *timed)
    return results


def run_kwargs(cfg, run):
    from fftvis_tpu_torch.beams import GaussianBeam, read_beamfits

    _, beam, polarized, opts, precision = run
    beam = GaussianBeam(diameter=14.0) if beam == "gaussian" else read_beamfits(str(ASSET))
    return dict(cfg, beam=beam, polarized=polarized, beam_spline_opts=opts,
                precision=precision)


def direct_oracle(kw):
    """The port's float64 direct path on the CPU for one run's inputs."""
    from fftvis_tpu_torch import CUDASimulationEngine
    from fftvis_tpu_torch.beams import BeamInterface, prepare_beam_unpolarized

    beam = BeamInterface(kw["beam"])
    if not kw["polarized"]:
        beam = prepare_beam_unpolarized(beam)
    ekw = {k: v for k, v in kw.items() if k not in ("beam", "force_use_type3")}
    return CUDASimulationEngine(nufft_mode="direct", device="cpu").simulate(
        beam_list=[beam], **ekw)


PROFILE_RUNS = (0, 2, 3, 4)  # RUNS indices: analytic p=1 and the tabulated runs
KERNEL_NAMES = {"spread": "spread_gm", "interp": "interp_runs", "beam_eval": "beam_eval_points"}


def profile_runs(cfg) -> None:
    """Phase 6: five timed warm calls, then one profiled call, of each of
    PROFILE_RUNS; device time from the profiler's CUDA kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fftvis_tpu_torch import simulate_vis

    out_dir = Path(__file__).resolve().parent / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in PROFILE_RUNS:
        kind, beam, _, _, precision = RUNS[i]
        kw = run_kwargs(cfg, RUNS[i])
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
        mine = []
        for kname, sym in KERNEL_NAMES.items():
            hits = [r for r in rows if sym in r[2]]
            if hits:
                us, count = sum(r[0] for r in hits), sum(r[1] for r in hits)
                mine.append(f"{kname} {us / 1e3:.4f} ms / {count} = {us / count:.2f} us")
        (out_dir / f"profile_{i}.txt").write_text("".join(
            f"{us / 1e3:10.4f} ms {count:6d}  {key[:160]}\n" for us, count, key in rows[:40]))
        print(f"[6] profile {kind} {beam} precision={precision}: warm walls "
              f"{', '.join(f'{t:.4f}' for t in walls)} s; profiled wall {wall:.4f} s, "
              f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / 1e3 / wall:.4f}; "
              f"{'; '.join(mine)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print("[1] card (nvidia-smi name, power.limit):", flush=True)
    print(card_line(), flush=True)

    from fftvis_tpu_torch import simulate_vis
    from fftvis_tpu_torch._build import load_kernels
    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod

    t0 = time.perf_counter()
    load_kernels()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = slice_config()
    checks = check_nufft_kernels(cfg)
    beam_checks = check_beam_eval()

    counters = {"spread": spread_mod, "interp": interp_mod, "beam_eval": eval_mod}
    nbl = len(cfg["baselines"])
    vis, launches = {}, {}
    for i, run in enumerate(RUNS):
        kind, beam, polarized, _, precision = run
        kw = run_kwargs(cfg, run)
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        out = simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches[i] = {k: mod.launches for k, mod in counters.items()}
        want_shape = (len(FREQS), 3) + ((2, 2) if polarized else ()) + (nbl,)
        if out.shape != want_shape or not np.all(np.isfinite(out)):
            raise AssertionError(
                f"{kind} precision={precision}: shape {out.shape} (want {want_shape}), "
                f"finite={bool(np.all(np.isfinite(out)))}"
            )
        path = ("spread", "interp") + (("beam_eval",) if beam == "tabulated" else ())
        if min(launches[i][k] for k in path) <= 0:
            raise AssertionError(f"{kind} precision={precision}: kernel launches {launches[i]}")
        t0 = time.perf_counter()
        simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        vis[i] = out
        print(f"[4] simulate_vis {kind} {beam} precision={precision}: {out.shape} {out.dtype}, "
              f"finite; launches {launches[i]}; wall first {first:.3f} s, "
              f"second {second:.3f} s", flush=True)

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

    if "--profile" in sys.argv[1:]:
        profile_runs(cfg)

    main_run = {1: 2, 2: 3}  # RUNS index of the polarized tabulated slice
    kernels = []
    for kname, source, replaces in (
        ("spread", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("interp", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
        ("beam_eval", "fftvis_tpu_torch/csrc/beam_eval.cu", "fftvis_tpu/beams/pallas_eval.py:287"),
    ):
        for precision, dname in ((1, "float32"), (2, "float64")):
            if kname == "beam_eval":
                err, ms, plain_ms, (b_ms, b_by), lib_ms = beam_checks[dname]
            else:
                err, ms, plain_ms, (b_ms, b_by), lib_ms = checks[dname][kname]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[main_run[precision]][kname],
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
