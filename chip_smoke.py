#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py        (from the repository root, one CUDA card)

Phases, one printed line each (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``fftvis_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and time the build;
3. check each kernel against its plain torch version at the shapes the
   runs give it, and time both with CUDA events:
   - spread and interp (float32: grid (4320, 3000), w=8; float64: grid
     (4320, 3072), w=14; 4096 sources, 63,190 targets; C = 1 and 4
     channels), gate 1e-5 / 1e-12 of max|plain|;
   - beam_eval on the tabulated beam's tables, (91, 360, 8) polarized and
     (91, 360, 2) power, 4096 points with seam and edge-row points, orders
     1 and 3, float32 and float64, wrapped azimuth; and the (91, 360, 296)
     stacked shape at order 3 in float32; gate 2e-6 / 1e-12 of max|plain|;
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
6. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

LAT, LON, ALT = -30.72, 21.43, 1000.0
FREQS = (1.0e8, 1.1e8)
SPREAD_SOURCES = 4096
TOL = {"float32": 1e-5, "float64": 1e-12}
BEAM_TOL = {"float32": 2e-6, "float64": 1e-12}
ORACLE_GATE = {1: 1e-4, 2: 1e-5}
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
    import numpy as np

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


def check_nufft_kernels(cfg) -> dict:
    """Phase 3: spread and interp against their plain versions at the
    slice's grids, with C = 1 (unpolarized) and C = 4 (polarized)
    channels. Returns {dtype: {kernel: (err, ms, plain_ms)}} at C = 4."""
    import numpy as np
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

        uy = dev(rng.uniform(0, nfy, SPREAD_SOURCES), rdt)
        ux = dev(rng.uniform(0, nfx, SPREAD_SOURCES), rdt)
        iy, ix = (dev(a, torch.int32) for a in plan.tap_idx)
        vy, vx = (dev(a, rdt) for a in plan.tap_val)
        for C in (1, 4):
            wts = dev(rng.normal(size=(C, SPREAD_SOURCES))
                      + 1j * rng.normal(size=(C, SPREAD_SOURCES)), cdt)
            got = spread_mod.spread(uy, ux, wts, torch.zeros((C, nfy, nfx), dtype=cdt, device="cuda"), w, beta)
            want = spread_mod.spread_plain(uy, ux, wts, torch.zeros_like(got), w, beta)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            s_err = (got - want).abs().max().item()
            acc = torch.zeros_like(got)
            s_ms = cuda_ms(lambda: spread_mod.spread(uy, ux, wts, acc, w, beta), 20)
            s_plain = cuda_ms(lambda: spread_mod.spread_plain(uy, ux, wts, acc, w, beta), 5)
            print(f"[3] spread {name}: grid ({nfy}, {nfx}) w={w} n={SPREAD_SOURCES} C={C}: "
                  f"max err {s_err:.3e} = {s_err / scale:.3e} of max|plain|; "
                  f"kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms", flush=True)
            if not s_err <= TOL[name] * scale:
                raise AssertionError(f"spread {name} C={C} disagrees with its plain version")
            del acc, got, want

            G = dev(rng.normal(size=(C, nfy, nfx)) + 1j * rng.normal(size=(C, nfy, nfx)), cdt)
            got = interp_mod.interp(G, iy, ix, vy, vx)
            want = interp_mod.interp_plain(G, iy, ix, vy, vx)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            i_err = (got - want).abs().max().item()
            i_ms = cuda_ms(lambda: interp_mod.interp(G, iy, ix, vy, vx), 20)
            i_plain = cuda_ms(lambda: interp_mod.interp_plain(G, iy, ix, vy, vx), 5)
            print(f"[3] interp {name}: grid ({nfy}, {nfx}) w={w} m={iy.shape[0]} C={C}: "
                  f"max err {i_err:.3e} = {i_err / scale:.3e} of max|plain|; "
                  f"kernel {i_ms:.4f} ms, plain {i_plain:.4f} ms", flush=True)
            if not i_err <= TOL[name] * scale:
                raise AssertionError(f"interp {name} C={C} disagrees with its plain version")
            del G, got, want
            torch.cuda.empty_cache()
        results[name] = {
            "spread": (s_err, s_ms, s_plain),
            "interp": (i_err, i_ms, i_plain),
        }
    return results


def beam_points(ny: int, nx: int, n: int, rng):
    """(y, x) cell coordinates as the beam interface forms them -- za cells
    in [0, ny-1], azimuth cells in [0, nx] -- with the seam and the edge
    rows among them."""
    import numpy as np

    y = rng.uniform(0, ny - 1, n)
    x = rng.uniform(0, nx, n)
    edge_y = [0.0, 1e-4, ny - 1.5, ny - 1 - 1e-4, ny - 1.0]
    edge_x = [0.0, 1e-4, nx / 2, nx - 1e-4, float(nx)]
    grid = np.array([(a, b) for a in edge_y for b in edge_x]).T
    y[: grid.shape[1]], x[: grid.shape[1]] = grid
    return y, x


def check_beam_eval() -> dict:
    """Phase 3: beam_eval against its plain version at the tabulated
    beam's tables. Returns {dtype: (max err, ms, plain_ms)}, the times
    those of the polarized order-3 table."""
    import numpy as np
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
        print(f"[3] beam_eval {name}: table ({ny}, {nx}, {ch}) order {order} n=4096: "
              f"max err {err:.3e} = {err / scale:.3e} of max|plain|; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms", flush=True)
        if not err <= BEAM_TOL[name] * scale:
            raise AssertionError(f"beam_eval {name} {(ch, order)} disagrees with its plain version")
        prev = results.get(name, (0.0, None, None))
        timed = (ms, plain) if (ch, order) == (8, 3) else prev[1:]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print("[1] card (nvidia-smi name, power.limit):", flush=True)
    print(card_line(), flush=True)

    import numpy as np

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

    main_run = {1: 2, 2: 3}  # RUNS index of the polarized tabulated slice
    kernels = []
    for kname, source, replaces in (
        ("spread", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("interp", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
        ("beam_eval", "fftvis_tpu_torch/csrc/beam_eval.cu", "fftvis_tpu/beams/pallas_eval.py:287"),
    ):
        for precision, dname in ((1, "float32"), (2, "float64")):
            if kname == "beam_eval":
                err, ms, plain_ms = beam_checks[dname]
            else:
                err, ms, plain_ms = checks[dname][kname]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[main_run[precision]][kname],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
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
