"""Time the spread and interp wrappers of several checkouts, in turns.

    python3 tools/kernel_ab.py ROOT [ROOT ...]

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
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

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
    """Mean device time of the kernels whose name holds ``symbol``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    return total / max(count, 1)


def timed(fn, symbol: str) -> dict:
    return {"ms": cuda_ms(fn), "kernel_us": kernel_us(fn, symbol)}


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


def child(root: str) -> None:
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
        child(argv[1])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
