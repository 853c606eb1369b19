"""Time the kernel wrappers of several checkouts, in turns.

    python3 tools/kernel_ab.py [--beams] ROOT [ROOT ...]

Each ROOT is a checkout of this repository. Each runs in a process of its
own, in the order given (for an A/B, parent, change, change, parent), on
inputs made on the card from one seed, at the slice's shapes (the grids
of ``chip_smoke.py`` phase 3, 4096 sources, 63,190 targets). Every line is
one JSON object: the root, the case and the CUDA-event time of one call
of the wrapper (mean of 20 after a warm-up), and ``kernel_us``, the mean
device time of the hand-written kernel alone over 20 launches under
torch.profiler. Besides the wrappers, each root times the spread pre-pass
in two forms (the bin sort by 32 x 32 tile with CSR offsets by
``searchsorted``, and a bare sort by tile) and the spread wrapper on
sources already in tile order, so one call shows what a sort costs and
what it buys. The interp runs on the tap tables in baseline order and in
the executor's tile order; where the root's wrapper takes footprint runs,
baseline order also runs with one run a row, the form an array without
redundant baselines takes.

The beam cases time the interpolation alone (``beam_eval``) on random
tables of the slice's shapes ((91, 360, 8) and (91, 360, 2) at orders 3
and 1, float32 and float64, and the stacked (91, 360, 296) at order 3 in
float32) at 4096 points, and one source block of the slice (4096 points,
about half below the horizon) of the committed beam as the root's device
loop forms it: ``PreparedBeam.rows`` where the root has it, else
``evaluate``, ``apparent_coherency_rows``, the complex cast and the mask.
A source block's line also gives ``kernels``, the device kernels one call
launches, and ``device_us``, their device time a call. With ``--beams``
first, only the beam cases run.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

from device_profile import device_kernels

FREQS = (1.0e8, 1.1e8)
SOURCES = 4096
TILE = 32
REPS = 20


def cuda_ms(fn, reps: int = REPS) -> float:
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


def kernel_us(fn, symbol: str, reps: int = REPS) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``symbol``."""
    d = device_kernels(fn, reps, symbol)
    return d["device_us"] / d["kernels"] if d["kernels"] else 0.0


def timed(fn, symbol: str) -> dict:
    return {"ms": cuda_ms(fn), "kernel_us": kernel_us(fn, symbol)}


def beam_cases(root: str, emit) -> None:
    import numpy as np
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.beams import prepare_beam, prepare_beam_unpolarized, read_beamfits
    from fftvis_tpu_torch.core.coherency import apparent_coherency_rows

    n = SOURCES
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    beam = read_beamfits(str(Path(root) / "tests/data/structured_dipole_100MHz.beamfits"))
    for rdt, cdt in ((torch.float32, torch.complex64), (torch.float64, torch.complex128)):
        name = str(rdt).split(".")[-1]
        shapes = ((8, 3), (8, 1), (2, 3), (2, 1)) + (((296, 3),) if name == "float32" else ())
        y = 90 * torch.rand(n, generator=gen, dtype=rdt, device="cuda")
        x = 360 * torch.rand(n, generator=gen, dtype=rdt, device="cuda")
        for ch, order in shapes:
            data = torch.randn((91, 360, ch), generator=gen, dtype=rdt, device="cuda")
            emit(kernel="beam_eval", dtype=name, table=[91, 360, ch], order=order,
                 **timed(lambda: eval_mod.beam_eval(data, y, x, order=order, wrap_x=True),
                         "beam_eval_points"))
        az = 2 * np.pi * torch.rand(n, generator=gen, dtype=rdt, device="cuda")
        za = np.pi / 2 * torch.rand(n, generator=gen, dtype=rdt, device="cuda")
        mask = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(rdt)
        flux = torch.rand(n, generator=gen, dtype=rdt, device="cuda") + 0.1
        for polarized, order in ((True, 3), (False, 1)):
            src = beam if polarized else prepare_beam_unpolarized(beam)
            pb = prepare_beam(src, np.array(FREQS), polarized, spline_opts={"order": order},
                              dtype=rdt, device="cuda")
            if hasattr(pb, "rows"):
                def block():
                    return pb.rows(az, za, FREQS[0], 0, flux, mask, False, cdt)
            else:
                def block():
                    resp = pb.evaluate(az, za, FREQS[0], 0)
                    rows = apparent_coherency_rows(resp, resp, flux, polarized, False)
                    return rows.to(cdt) * mask[None, :]
            emit(kernel="source block", dtype=name, polarized=polarized, order=order,
                 ms=cuda_ms(block), **device_kernels(block, REPS))


def prepass_sort_searchsorted(uy, ux, nfy: int, nfx: int):
    import torch

    nty, ntx = -(-nfy // TILE), -(-nfx // TILE)
    tiy = torch.clamp(torch.floor(uy).to(torch.int64) // TILE, 0, nty - 1)
    tix = torch.clamp(torch.floor(ux).to(torch.int64) // TILE, 0, ntx - 1)
    tid_sorted, order = torch.sort(tiy * ntx + tix, stable=True)
    bounds = torch.arange(nty * ntx + 1, device=uy.device)
    return order.to(torch.int32), torch.searchsorted(tid_sorted, bounds, out_int32=True)


def prepass_bare_sort(uy, ux, nfx: int):
    import torch

    ntx = -(-nfx // TILE)
    tid = (torch.floor(uy).to(torch.int64) // TILE) * ntx + torch.floor(ux).to(torch.int64) // TILE
    return torch.sort(tid)[1].to(torch.int32)


def child(root: str, beams_only: bool) -> None:
    # The root's package, and not this file's directory, comes first.
    sys.path[0] = root
    import numpy as np
    import torch

    from fftvis_tpu_torch.core.utils import speed_of_light
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod
    from fftvis_tpu_torch.nufft.transform import plan_type3

    def emit(**kw):
        print(json.dumps({"root": root, **kw}), flush=True)

    beam_cases(root, emit)
    if beams_only:
        return

    ants = hex_array(11, sep=14.6, outriggers=2)
    keys = list(ants)
    targets = np.array([ants[keys[j]][:2] - ants[keys[i]][:2]
                        for i in range(len(keys)) for j in range(i, len(keys))]).T
    x_ext = 2 * np.pi * max(FREQS) / speed_of_light
    has_order = "order" in inspect.signature(interp_mod.interp).parameters
    has_runs = "runs" in inspect.signature(interp_mod.interp).parameters
    gen = torch.Generator(device="cuda")
    for rdt, cdt, eps in ((torch.float32, torch.complex64, 5e-7),
                          (torch.float64, torch.complex128, 1e-13)):
        name = str(rdt).split(".")[-1]
        plan = plan_type3(targets, x_extent=x_ext, eps=eps)
        w, beta, (nfy, nfx) = plan.kernel.w, plan.kernel.beta, plan.nf
        gen.manual_seed(0)
        for C in (1, 4):
            for case in ("uniform", "dense", "half-zero"):
                u = torch.rand((2, SOURCES), generator=gen, dtype=rdt, device="cuda")
                if case == "dense":
                    uy, ux = nfy / 2 + 128 * u[0], nfx / 2 + 128 * u[1]
                else:
                    uy, ux = nfy * u[0], nfx * u[1]
                wts = torch.randn((C, SOURCES), generator=gen, dtype=cdt, device="cuda")
                if case == "half-zero":
                    wts[:, ::2] = 0
                grid = torch.zeros((C, nfy, nfx), dtype=cdt, device="cuda")
                emit(kernel="spread", dtype=name, C=C, case=case,
                     **timed(lambda: spread_mod.spread(uy, ux, wts, grid, w, beta), "spread_"))
                if case == "uniform":
                    order = prepass_bare_sort(uy, ux, nfx).long()
                    suy, sux, swts = uy[order], ux[order], wts[:, order].contiguous()
                    emit(kernel="spread", dtype=name, C=C, case="uniform, tile-sorted",
                         **timed(lambda: spread_mod.spread(suy, sux, swts, grid, w, beta),
                                 "spread_"))
                    emit(kernel="prepass", dtype=name, case="sort + searchsorted",
                         ms=cuda_ms(lambda: prepass_sort_searchsorted(uy, ux, nfy, nfx)))
                    emit(kernel="prepass", dtype=name, case="bare sort",
                         ms=cuda_ms(lambda: prepass_bare_sort(uy, ux, nfx)))
                del grid
            G = torch.randn((C, nfy, nfx), generator=gen, dtype=cdt, device="cuda")
            iy, ix = (torch.tensor(a, dtype=torch.int32, device="cuda") for a in plan.tap_idx)
            vy, vx = (torch.tensor(a, dtype=rdt, device="cuda") for a in plan.tap_val)
            runs = {}
            if has_runs:
                # Runs of the tables as given, and one run a row: the form an
                # array without redundant baselines takes.
                runs["runs as they fall"] = torch.tensor(
                    interp_mod.footprint_runs(*plan.tap_idx), device="cuda")
                runs["one run a row"] = torch.arange(iy.shape[0] + 1, dtype=torch.int32,
                                                     device="cuda")
            for label, r in runs.items() or [("", None)]:
                kw = {} if r is None else {"runs": r}
                emit(kernel="interp", dtype=name, C=C, case=f"target order as given {label}",
                     **timed(lambda: interp_mod.interp(G, iy, ix, vy, vx, **kw), "interp_"))
            if has_order:
                perm = interp_mod.target_order(plan.tap_idx[0][:, 0], plan.tap_idx[1][:, 0])
                tabs = [torch.tensor(a[perm], dtype=torch.int32, device="cuda") for a in plan.tap_idx]
                tabs += [torch.tensor(a[perm], dtype=rdt, device="cuda") for a in plan.tap_val]
                order = torch.tensor(perm, dtype=torch.int32, device="cuda")
                kw = {}
                if has_runs:
                    kw["runs"] = torch.tensor(
                        interp_mod.footprint_runs(*(a[perm] for a in plan.tap_idx)), device="cuda")
                emit(kernel="interp", dtype=name, C=C, case="tile order",
                     **timed(lambda: interp_mod.interp(G, *tabs, order=order, **kw), "interp_"))
            del G
            torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2:] == ["--beams"])
        return 0
    beams = argv[:1] == ["--beams"]
    roots = argv[1:] if beams else argv
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())]
                       + ["--beams"] * beams, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
