"""Time the kernel wrappers of several checkouts, in turns.

    python3 tools/kernel_ab.py [--beams | --p1 | --spread | --wide] ROOT [ROOT ...]

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

With ``--p1`` first, each ROOT runs instead the precision-1
``simulate_vis`` configurations of ``chip_smoke.py`` (this checkout's, for
the inputs; the ROOT's package computes): the analytic slice, the north
star, the ES gridded row under ``FFTVIS_TYPE1=es`` and the outrigger
lattice. Each line gives one cold call's wall, ``P1_CALLS`` warm walls in
seconds (each call returns host arrays, so it ends with the card idle),
and ``kernels`` and ``device_us`` of one more warm call.

With ``--spread`` first, each ROOT times instead the spread's adjoint and
its d = 1 entry, the wrapper and ``kernel_us`` (every kernel named
``spread_adjoint`` or ``spread_gm_1d``, whatever the root's form): the
adjoint at 4096 uniform sources on the slice's grids (w = 8 float32, w =
14 float64) at C = 1, 3 and 4 and on the per-antenna run's (4608, 2880)
grid (w = 8, both dtypes) at C = 33 and 40, and there at C = 40 once
more with every source's first tap column a multiple of 8 cells (each
float32 tap row one aligned 64-byte segment: what the rows cost when no
row straddles a 64-byte boundary); ``spread_gm_1d`` at 100,000 uniform
points on a 10^6-cell line, C = 1 and 4; and, once a root, the device
time of ``sum`` over 1 GiB of float32 (the card's streaming rate in the
same process).

With ``--wide`` first, each ROOT times instead the pair rows and their
adjoint in the evaluations for one beam an antenna of HERA-331 (K = 331
beams, the 631 redundant representatives' P = 631 pairs, ``beam_idx =
arange(331)``), at 4096 points on random evaluations (positive for
power), about half masked and all unmasked, Stokes-I Jones, IQUV Jones
and power, float32 and float64: the wrapper, ``kernel_us`` (every kernel
named ``pair_rows``), the max error against the plain version relative to
its largest entry and, for the adjoint, whether a second call is bitwise
equal. Where the ROOT's package picks among forms (``PAIR_FORMS``), its
forms that take the shapes are each timed too (``form``). The Stokes-I
cases run once more (``pairs``: "no hub") on 631 pairs drawn at random
from the 331 beams' i <= j pairs, where no beam is in more than a dozen:
HERA's representatives put antenna 0 in 332 of theirs.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

from device_profile import device_kernels

FREQS = (1.0e8, 1.1e8)
SOURCES = 4096
TILE = 32
REPS = 20
P1_CALLS = 5
# The slice's fine grids (float32 w = 8, float64 w = 14) and the
# per-antenna type-3 run's (chip_smoke.py phase 3); the d = 1 case.
SLICE_GRIDS = ((4320, 3000), (4320, 3072))
PA_GRID = (4608, 2880)
D1_POINTS = 100_000
D1_CELLS = 1_000_000


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


def spread_cases(root: str) -> None:
    """The ``--spread`` mode of one ROOT."""
    sys.path[0] = root
    import numpy as np
    import torch

    from fftvis_tpu_torch.nufft import spread as spread_mod
    from fftvis_tpu_torch.nufft.kernels import ESKernel

    def emit(**kw):
        print(json.dumps({"root": root, **kw}), flush=True)

    x = torch.ones(2**28, device="cuda")
    d = device_kernels(lambda: x.sum(), REPS)
    emit(kernel="sum 1 GiB float32", device_us=d["device_us"] / d["kernels"])
    del x
    gen = torch.Generator(device="cuda")
    k8, k14 = ESKernel.from_eps(5e-7), ESKernel.from_eps(1e-13)
    cases = [(torch.float32, torch.complex64, SLICE_GRIDS[0], k8, C, False) for C in (1, 3, 4)]
    cases += [(torch.float64, torch.complex128, SLICE_GRIDS[1], k14, C, False) for C in (1, 3, 4)]
    cases += [(rdt, cdt, PA_GRID, k8, C, False) for rdt, cdt in (
        (torch.float32, torch.complex64), (torch.float64, torch.complex128)) for C in (33, 40)]
    cases += [(rdt, cdt, PA_GRID, k8, 40, True) for rdt, cdt in (
        (torch.float32, torch.complex64), (torch.float64, torch.complex128))]
    for rdt, cdt, (nfy, nfx), k, C, aligned in cases:
        gen.manual_seed(0)
        w, beta = k.w, k.beta
        u = torch.rand((2, SOURCES), generator=gen, dtype=rdt, device="cuda")
        uy, ux = nfy * u[0], nfx * u[1]
        if aligned:
            # ceil(ux - w/2) = 8 m: ux in (8 m + w/2 - 1, 8 m + w/2).
            ux = 8 * torch.floor(ux / 8) + (w / 2 - 1) + 0.5
        g = torch.randn((C, nfy, nfx), generator=gen, dtype=cdt, device="cuda")
        emit(kernel="spread_adjoint", dtype=str(rdt).split(".")[-1], grid=[nfy, nfx], w=w, C=C,
             case="aligned rows" if aligned else "uniform",
             **timed(lambda: spread_mod.spread_adjoint(uy, ux, g, w, beta), "spread_adjoint"))
        del g
        torch.cuda.empty_cache()
    for rdt, cdt, k in ((torch.float32, torch.complex64, k8),
                        (torch.float64, torch.complex128, k14)):
        gen.manual_seed(0)
        w, beta = k.w, k.beta
        u = [D1_CELLS * torch.rand(D1_POINTS, generator=gen, dtype=rdt, device="cuda")]
        for C in (1, 4):
            wts = torch.randn((C, D1_POINTS), generator=gen, dtype=cdt, device="cuda")
            grid = torch.zeros((C, D1_CELLS), dtype=cdt, device="cuda")
            emit(kernel="spread_d1", dtype=str(rdt).split(".")[-1], w=w, C=C, n=D1_POINTS,
                 **timed(lambda: spread_mod.spread_nd(u, wts, grid, w, beta), "spread_gm_1d"))


def p1_cases(root: str) -> None:
    """The ``--p1`` mode of one ROOT."""
    import importlib.util

    sys.path[0] = root
    import torch

    from fftvis_tpu_torch import simulate_vis

    # This checkout's chip_smoke.py (not the ROOT's) makes the inputs.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    cfg = cs.slice_config()
    cases = (("analytic slice", cs.run_kwargs(cfg, cs.RUNS[0]), None),
             ("north star", cs.north_star_config(), None),
             ("ES (a) gridded row", cs.es_row_config(cfg), "es"),
             ("ES (b) outrigger lattice", cs.outrigger_config(cfg), None))
    for label, kw, type1 in cases:
        kw = dict(kw, precision=1)

        def call():
            simulate_vis(device="cuda", **kw)
            torch.cuda.synchronize()

        with cs.type1_env(type1):
            walls = []
            for _ in range(1 + P1_CALLS):
                t0 = time.perf_counter()
                call()
                walls.append(time.perf_counter() - t0)
            dev = device_kernels(call)
        print(json.dumps({"root": root, "case": f"{label} precision=1", "cold_s": walls[0],
                          "warm_s": walls[1:], **dev}), flush=True)


WIDE_BEAMS = 331


def wide_cases(root: str) -> None:
    """The ``--wide`` mode of one ROOT."""
    import importlib.util

    sys.path[0] = root
    import numpy as np
    import torch

    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.core.beams import plan_beam_pairs
    from fftvis_tpu_torch.core.coherency import build_coherency

    # This checkout's chip_smoke.py (not the ROOT's) gives the array.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ns = cs.north_star_config()
    pp = plan_beam_pairs(list(ns["ants"]), ns["baselines"], np.arange(WIDE_BEAMS))
    K, n, npairs = WIDE_BEAMS, SOURCES, pp.npairs
    tri = [(i, j) for i in range(K) for j in range(i, K)]
    pick = np.sort(np.random.default_rng(3).choice(len(tri), size=npairs, replace=False))
    lists = {"hera": np.array(pp.pairs), "no hub": np.array(tri)[pick]}
    forms = getattr(eval_mod, "PAIR_FORMS", None)

    def emit(**kw):
        print(json.dumps({"root": root, "K": K, "P": npairs, "n": n, **kw}), flush=True)

    rng = np.random.default_rng(7)
    cases = [(dt, e, "hera") for dt in (torch.float32, torch.float64)
             for e in ("jones-I", "jones-iquv", "power")]
    cases += [(dt, "jones-I", "no hub") for dt in (torch.float32, torch.float64)]
    for dt, epilogue, pairs in cases:
        name = str(dt).split(".")[-1]
        pi, pj = (torch.tensor(lists[pairs][:, k], dtype=torch.int32, device="cuda")
                  for k in (0, 1))
        index = eval_mod.pair_index(pi, pj, K)
        power, iquv = epilogue == "power", epilogue == "jones-iquv"
        ch_shape = (1, 2) if power else (2, 2, 2)
        chf, C = int(np.prod(ch_shape)), 1 if power else 4
        for masked in (True, False):
            ev = rng.normal(size=(n, K * chf))
            evals = torch.tensor(np.abs(ev) + 0.05 if power else ev, dtype=dt,
                                 device="cuda")
            keep = rng.uniform(size=n) < 0.5 if masked else np.ones(n, dtype=bool)
            mask = torch.tensor(keep, dtype=dt, device="cuda")
            stokes = rng.uniform(0.1, 1.0, (n, 1))
            if iquv:
                coh = build_coherency(np.stack(
                    [stokes, *rng.uniform(-0.05, 0.05, (3, n, 1))], axis=-1), True)
                sky = torch.tensor(coh, dtype=eval_mod.COMPLEX[dt], device="cuda")[:, 0]
            else:
                sky = torch.tensor(stokes, dtype=dt, device="cuda")[:, 0]
            g = torch.complex(*(torch.tensor(rng.normal(size=(npairs * C, n)), dtype=dt,
                                             device="cuda") for _ in range(2)))
            args = (evals, pi, pj, sky, mask, ch_shape, power, iquv, 1)
            want = eval_mod.pair_rows_plain(*args)
            want_adj = eval_mod.pair_rows_adjoint_plain(*args[:5], g, *args[5:])
            case = dict(dtype=name, epilogue=epilogue, pairs=pairs,
                        case="half masked" if masked else "unmasked")
            todo = [None]
            if forms is not None:
                todo += [f for f in forms if f != "tile"]
            epi = eval_mod.POWER if power else (eval_mod.JONES_IQUV if iquv
                                                else eval_mod.JONES_I)
            for form in todo:
                for adjoint in (False, True):
                    # A form asked for goes through the private launches,
                    # which take it; the public wrappers take the rule's.
                    if adjoint and form is None:
                        def call():
                            return eval_mod.pair_rows_adjoint(*args[:5], g, *args[5:],
                                                              index=index)
                    elif adjoint:
                        def call():
                            return eval_mod._pair_rows_adjoint_cuda(
                                evals, pi, pj, index, sky, mask, g, ch_shape, epi, 1, K, form)
                    elif form is None:
                        def call():
                            return eval_mod.pair_rows(*args)
                    else:
                        def call():
                            return eval_mod._pair_rows_cuda(evals, pi, pj, sky, mask, ch_shape,
                                                            epi, 1, form)
                    ref = want_adj if adjoint else want
                    try:
                        got = call()
                    except ValueError:
                        continue  # a form that cannot take these shapes
                    err = ((got - ref).abs().max() / ref.abs().max()).item()
                    extra = {"bitwise_repeat": torch.equal(got, call())} if adjoint else {}
                    emit(kernel="pair_rows_adjoint" if adjoint else "pair_rows",
                         form=form or "picked", **case, max_rel_err=err, **extra,
                         **timed(call, "pair_rows"))
                    del got
            del evals, want, want_adj, g
            torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        if argv[2:] == ["--p1"]:
            p1_cases(argv[1])
        elif argv[2:] == ["--wide"]:
            wide_cases(argv[1])
        elif argv[2:] == ["--spread"]:
            spread_cases(argv[1])
        else:
            child(argv[1], argv[2:] == ["--beams"])
        return 0
    flag = argv[:1] if argv[:1] in (["--beams"], ["--p1"], ["--spread"], ["--wide"]) else []
    roots = argv[len(flag):]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())] + flag,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
