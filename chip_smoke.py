#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py        (from the repository root, one CUDA card)

Phases, one printed line each (any failure raises and exits non-zero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``fftvis_tpu_torch/csrc`` and time the build;
3. check each kernel against its plain torch version at the slice's shapes
   (float32: grid (4320, 3000), w=8; float64: grid (4320, 3072), w=14;
   4096 sources, 63,190 targets, one channel) and time both with CUDA
   events;
4. run ``simulate_vis`` on the slice configuration -- hex_array(11,
   outriggers=2) with all 63,190 i<=j baselines, the nside=64 HEALPix sky,
   2 frequencies x 3 times, GaussianBeam(14), forced type-3 -- at
   precision 1 and 2, showing that each run launched both kernels;
5. hold both outputs against the port's float64 direct path on every 32nd
   baseline (gates 1e-4 at precision 1, 1e-5 at precision 2, relative to
   max|V|);
6. print the kernels' JSON line, then the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

LAT, LON, ALT = -30.72, 21.43, 1000.0
FREQS = (1.0e8, 1.1e8)
SPREAD_SOURCES = 4096
TOL = {"float32": 1e-5, "float64": 1e-12}
ORACLE_GATE = {1: 1e-4, 2: 1e-5}


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
    from fftvis_tpu_torch.beams import GaussianBeam
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
        beam=GaussianBeam(diameter=14.0),
        telescope_loc=TelescopeLocation(np.deg2rad(LAT), np.deg2rad(LON), ALT),
        baselines=baselines,
        polarized=False,
        force_use_type3=True,
    )


def check_kernels(cfg) -> dict:
    """Phase 3: each kernel against its plain version at the slice shapes."""
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
        wts = dev(rng.normal(size=(1, SPREAD_SOURCES))
                  + 1j * rng.normal(size=(1, SPREAD_SOURCES)), cdt)
        got = spread_mod.spread(uy, ux, wts, torch.zeros((1, nfy, nfx), dtype=cdt, device="cuda"), w, beta)
        want = spread_mod.spread_plain(uy, ux, wts, torch.zeros_like(got), w, beta)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        s_err = (got - want).abs().max().item()
        acc = torch.zeros_like(got)
        s_ms = cuda_ms(lambda: spread_mod.spread(uy, ux, wts, acc, w, beta), 20)
        s_plain = cuda_ms(lambda: spread_mod.spread_plain(uy, ux, wts, acc, w, beta), 5)
        print(f"[3] spread {name}: grid ({nfy}, {nfx}) w={w} n={SPREAD_SOURCES}: "
              f"max err {s_err:.3e} = {s_err / scale:.3e} of max|plain|; "
              f"kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms", flush=True)
        if not s_err <= TOL[name] * scale:
            raise AssertionError(f"spread {name} disagrees with its plain version")

        G = dev(rng.normal(size=(1, nfy, nfx)) + 1j * rng.normal(size=(1, nfy, nfx)), cdt)
        iy, ix = (dev(a, torch.int32) for a in plan.tap_idx)
        vy, vx = (dev(a, rdt) for a in plan.tap_val)
        got = interp_mod.interp(G, iy, ix, vy, vx)
        want = interp_mod.interp_plain(G, iy, ix, vy, vx)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        i_err = (got - want).abs().max().item()
        i_ms = cuda_ms(lambda: interp_mod.interp(G, iy, ix, vy, vx), 20)
        i_plain = cuda_ms(lambda: interp_mod.interp_plain(G, iy, ix, vy, vx), 5)
        print(f"[3] interp {name}: grid ({nfy}, {nfx}) w={w} m={iy.shape[0]}: "
              f"max err {i_err:.3e} = {i_err / scale:.3e} of max|plain|; "
              f"kernel {i_ms:.4f} ms, plain {i_plain:.4f} ms", flush=True)
        if not i_err <= TOL[name] * scale:
            raise AssertionError(f"interp {name} disagrees with its plain version")
        results[name] = {
            "spread": (s_err, s_ms, s_plain),
            "interp": (i_err, i_ms, i_plain),
        }
        del G, acc, got, want
        torch.cuda.empty_cache()
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print("[1] card (nvidia-smi name, power.limit):", flush=True)
    print(card_line(), flush=True)

    import numpy as np

    from fftvis_tpu_torch import CUDASimulationEngine, simulate_vis
    from fftvis_tpu_torch._build import load_kernels
    from fftvis_tpu_torch.beams import BeamInterface, prepare_beam_unpolarized
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod

    t0 = time.perf_counter()
    load_kernels()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = slice_config()
    checks = check_kernels(cfg)

    nbl = len(cfg["baselines"])
    want_shape = (len(FREQS), 3, nbl)
    vis, launches = {}, {}
    for precision in (1, 2):
        spread_mod.launches = 0
        interp_mod.launches = 0
        t0 = time.perf_counter()
        out = simulate_vis(precision=precision, device="cuda", **cfg)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        launches[precision] = (spread_mod.launches, interp_mod.launches)
        if out.shape != want_shape or not np.all(np.isfinite(out)):
            raise AssertionError(
                f"precision={precision}: shape {out.shape} (want {want_shape}), "
                f"finite={bool(np.all(np.isfinite(out)))}"
            )
        if min(launches[precision]) <= 0:
            raise AssertionError(f"precision={precision}: kernel launches {launches[precision]}")
        t0 = time.perf_counter()
        simulate_vis(precision=precision, device="cuda", **cfg)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        vis[precision] = out
        print(f"[4] simulate_vis precision={precision}: {out.shape} {out.dtype}, finite; "
              f"spread launches {launches[precision][0]}, interp launches "
              f"{launches[precision][1]}; wall first {first:.3f} s, second {second:.3f} s",
              flush=True)

    sub = cfg["baselines"][::32]
    ekw = {k: v for k, v in cfg.items() if k not in ("beam", "baselines")}
    t0 = time.perf_counter()
    oracle = CUDASimulationEngine(nufft_mode="direct", device="cuda").simulate(
        beam_list=[prepare_beam_unpolarized(BeamInterface(cfg["beam"]))],
        baselines=sub, precision=2, **ekw,
    )
    scale = np.abs(oracle).max()
    print(f"[5] fp64 direct path on {len(sub)} baselines in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for precision in (1, 2):
        err = np.abs(vis[precision][..., ::32] - oracle).max() / scale
        print(f"[5] precision={precision} vs fp64 direct: max err {err:.3e} of max|V| "
              f"(gate {ORACLE_GATE[precision]:.0e})", flush=True)
        if not err <= ORACLE_GATE[precision]:
            raise AssertionError(f"precision={precision} misses its accuracy gate")

    kernels = []
    for kname, source, replaces in (
        ("spread", "fftvis_tpu_torch/csrc/spread.cu", "fftvis_tpu/nufft/pallas_spread.py:219"),
        ("interp", "fftvis_tpu_torch/csrc/interp.cu", "fftvis_tpu/nufft/pallas_interp.py:162"),
    ):
        for precision, dname in ((1, "float32"), (2, "float64")):
            err, ms, plain_ms = checks[dname][kname]
            kernels.append({
                "name": f"{kname}_{dname}",
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[precision][0 if kname == "spread" else 1],
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
