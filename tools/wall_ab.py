"""Time warm ``simulate_vis`` calls of several checkouts, in turns.

    python3 tools/wall_ab.py [--north-star | --grad[=RUNS]] ROOT [ROOT ...]

Each ROOT is a checkout of this repository. Each runs in a process of its
own, in the order given (for an A/B, parent, change, change, parent), the
polarized tabulated slice of ``chip_smoke.py`` at precision 1 and 2:
hex_array(11, outriggers=2) with all 63,190 i<=j baselines, the nside=64
HEALPix sky, 2 frequencies x 3 times, forced type-3, the committed
``structured_dipole_100MHz.beamfits`` with the order-3 spline, on one CUDA
card. With ``--north-star`` first, the north star of ``chip_smoke.py``
instead (HERA-331, 631 baselines, 37 per-antenna variants of that beam,
polarized, 1 frequency x 2 times, ``auto`` mode: the exact type-1 path),
for roots that have per-antenna beams. After one cold call, ``CALLS`` warm calls are timed on the host clock
(the call returns host arrays, so each ends with the card idle), one
more warm call runs under cProfile, and then one under torch.profiler
(``device_profile.device_kernels``). Every line is one JSON object: the
root, the precision, the warm walls in seconds, the cumulative host
seconds of the cProfiled call in the functions of ``PROFILED`` that the
root has, the device kernels the torch.profiler call launched and their
device time (device-side events only, copies and fills left out), and the
synchronizing CUDA calls of one more warm call (``sync_count``).

With ``--grad`` first, each ROOT runs instead ``chip_smoke.py``'s gradient
steps (a), (b) and (c) (the root's), a line each, or with ``--grad=RUNS``
the steps named by the letters of RUNS (``--grad=e``, ``--grad=abce``): (a)
the north star at precision 2 with its fluxes, stacked beam table and gains
as parameters; (b) the polarized slice, forced type-3, at precision 1, 2
frequencies x 3 times (one beam pair), with its fluxes and gains; (c)
per-antenna type-3 on the slice at precision 1 (4 beams, 10 pairs) with
(a)'s parameters; (e) the gridded row under ``FFTVIS_TYPE1=es`` at
precision 2 with its fluxes and gains; (f) (a) with one perturbed variant
of the beam for every antenna (331 beams, a (91, 360, 2648) table, the
pair rows' wide forms; ``--grad=f``; as this checkout's
``chip_smoke.py`` defines it, for roots older than run (f)); the loss sum |sim - data|^2
against the forward at a seeded perturbation. After one warm step,
``GRAD_STEPS`` steps are timed on the host clock, forward and backward
each ending in a synchronize; then one backward of a recorded forward runs
under torch.profiler (``device_kernels``: its device kernels, busy, host
op time and largest entries). After (a), the table adjoint alone, on random
(91, 360, ch) tables at 4096 points, order 1, float32 and float64, at
(a)'s ch = 296 and (c)'s 32: ``beam_eval_adjoint_points`` alone and every
device event of a call. Each line also gives the adjoint launches a step
that the root counts.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

from device_profile import device_kernels

FREQS = (1.0e8, 1.1e8)
CALLS = 10
GRAD_STEPS = 8
TOP = 16
PROFILED = ("simulate_vis", "plan_transform", "prepare_beam", "run_program",
            "_device_tables", "_taps", "target_order", "footprint_runs", "beam_rows", "eval_grid",
            "apparent_coherency_rows", "prepare_beam_list", "prepare_beams", "stack_prepared",
            "plan_beam_pairs", "check_antpos_griddability", "cull_never_visible", "pair_rows",
            "spread", "hash_parts")


def child(root: str, north_star: bool) -> None:
    # The root's package, and not this file's directory, comes first.
    sys.path[0] = root
    import numpy as np
    import torch

    from fftvis_tpu_torch import TelescopeLocation, simulate_vis
    from fftvis_tpu_torch.beams import read_beamfits
    from fftvis_tpu_torch.geometry import hex_array
    from fftvis_tpu_torch.utils import healpix_radec

    ants = hex_array(11, sep=14.6, outriggers=2)
    keys = list(ants)
    ra, dec = healpix_radec(64)
    kw = dict(
        ants=ants,
        fluxes=np.random.default_rng(0).uniform(0.1, 1.0, (ra.size, len(FREQS))),
        ra=ra, dec=dec, freqs=np.array(FREQS),
        times=2459863.2 + np.linspace(0, 0.01, 3),
        telescope_loc=TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0),
        baselines=[(keys[i], keys[j]) for i in range(len(keys)) for j in range(i, len(keys))],
        force_use_type3=True,
        beam=read_beamfits(str(Path(root) / "tests/data/structured_dipole_100MHz.beamfits")),
        polarized=True, beam_spline_opts={"order": 3}, device="cuda",
    )
    if north_star:
        from fftvis_tpu_torch.beams import perturbed_variants
        from fftvis_tpu_torch.core.utils import get_pos_reds

        ants = hex_array(11, sep=14.6)
        kw = dict(kw, ants=ants, fluxes=kw["fluxes"][:, :1], freqs=np.array(FREQS[:1]),
                  times=2459863.2 + np.linspace(0, 4 / 60 / 24, 2),
                  baselines=[r[0] for r in get_pos_reds(ants, include_autos=True)],
                  force_use_type3=False, beam=perturbed_variants(kw["beam"], 37),
                  beam_idx=np.arange(len(ants)) % 37, beam_spline_opts=None)
    for precision in (1, 2):
        simulate_vis(precision=precision, **kw)
        walls = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            simulate_vis(precision=precision, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof = cProfile.Profile()
        prof.runcall(simulate_vis, precision=precision, **kw)
        cum = {}
        for (_, _, func), (_, _, _, ct, _) in pstats.Stats(prof).stats.items():
            if func in PROFILED:
                cum[func] = cum.get(func, 0.0) + ct
        dev = device_kernels(lambda: simulate_vis(precision=precision, **kw))
        print(json.dumps({"root": root, "north_star": north_star, "precision": precision,
                          "walls_s": walls,
                          "profiled_s": cum, "device_kernels": dev["kernels"],
                          "device_kernel_ms": dev["device_us"] / 1e3,
                          "syncs": sync_count(lambda: simulate_vis(precision=precision, **kw))}),
              flush=True)


def grad_child(root: str, which: str) -> None:
    # The root's package and chip_smoke.py, not this file's directory, first.
    sys.path[0] = root
    import chip_smoke as cs
    from fftvis_tpu_torch.beams import eval as eval_mod
    from fftvis_tpu_torch.nufft import interp as interp_mod
    from fftvis_tpu_torch.nufft import spread as spread_mod

    counted = [(eval_mod, k) for k in ("pair_adjoint_launches", "pair_adjoint_wide_launches",
                                       "adjoint_launches", "pair_plain_cuda_calls")]
    counted += [(interp_mod, "adjoint_launches"), (spread_mod, "adjoint_launches")]
    counted = [(mod, k) for mod, k in counted if hasattr(mod, k)]
    cfg = cs.slice_config()
    table = {"differentiate_beam": True}
    runs = (("a", dict(cs.north_star_config(), precision=2), table, 31),
            ("f", lambda: dict(wide_config(), precision=2), table, 36),
            ("b", dict(cs.run_kwargs(cfg, cs.RUNS[2]), precision=1, fluxes=cfg["fluxes"][:, :2],
                       freqs=cfg["freqs"][:2], times=cfg["times"][:3]), {}, 32),
            ("c", cs.per_antenna_config(cfg), dict(table, nufft_mode="type3"), 33),
            ("e", dict(cs.es_row_config(cfg), precision=2), {}, 35))
    for run, kw, extra, seed in runs:
        if run not in which:
            continue
        if callable(kw):
            kw = kw()
        with cs.type1_env("es" if run == "e" else None):
            grad_run(cs, run, kw, extra, seed, root, counted, eval_mod)


def wide_config() -> dict:
    """Run (f) as this checkout's ``chip_smoke.py`` defines it (the ROOT's
    may predate it), built with the ROOT's package: one perturbed variant
    of the committed beam for every antenna of the north star."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here.wide_config(here.north_star_config())


def grad_run(cs, run, kw, extra, seed, root, counted, eval_mod) -> None:
    """One gradient step's line: warm steps timed, one backward profiled."""
    import torch

    from fftvis_tpu_torch import build_differentiable_sim

    sim, params = build_differentiable_sim(differentiate_gains=True, device="cuda", **extra,
                                           **kw)
    loss = cs.grad_setup(sim, params, seed)
    plist = list(params.values())

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = loss(params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(value, plist)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    step()
    before = {(mod.__name__, k): getattr(mod, k) for mod, k in counted}
    fwd, bwd = zip(*(step() for _ in range(GRAD_STEPS)))
    counts = {f"{name.rsplit('.', 1)[-1]}.{k}": (getattr(mod, k) - before[(name, k)])
              / GRAD_STEPS for mod, k in counted for name in [mod.__name__]}
    value = loss(params)
    dev = device_kernels(lambda: torch.autograd.grad(value, plist, retain_graph=True),
                         top=TOP)
    line = {"root": root, "run": run, "forward_s": list(fwd), "backward_s": list(bwd),
            "backward_busy_ms": dev["busy_us"] / 1e3,
            "backward_device_kernels": dev["kernels"],
            "backward_host_op_ms": dev["host_us"] / 1e3,
            "host_top": dev["host_top"], "device_top": dev["device_top"],
            "launches_a_step": counts, "card": cs.card_line()}
    del sim, params, loss, plist, value
    torch.cuda.empty_cache()
    if run == "a":
        line["table_adjoint"] = table_adjoint(cs, eval_mod)
    print(json.dumps(line), flush=True)


def table_adjoint(cs, eval_mod) -> dict:
    """``beam_eval_adjoint_points`` alone and every device event of a call,
    on random (91, 360, ch) tables at 4096 points, order 1, at (a)'s ch =
    296 and (c)'s 32, float32 and float64."""
    import numpy as np
    import torch

    table = {}
    rng = np.random.default_rng(7)
    for dt in (torch.float32, torch.float64):
        for ch in (296, 32):
            data = torch.tensor(rng.normal(size=(91, 360, ch)), dtype=dt, device="cuda")
            y, x = (torch.tensor(a, dtype=dt, device="cuda") for a in cs.beam_points(91, 360,
                                                                                     4096, rng))
            g = torch.tensor(rng.normal(size=(4096, ch)), dtype=dt, device="cuda")
            d = device_kernels(lambda: eval_mod.beam_eval_adjoint(data, y, x, g, 1, True), 20,
                               "beam_eval_adjoint_points")
            table[f"{str(dt)[6:]} ({ch})"] = {"kernel_us": d["device_us"],
                                               "call_busy_us": d["busy_us"]}
    return table


def sync_count(fn) -> int:
    """The synchronizing CUDA calls of one call of ``fn`` (a warm call, that
    returns host arrays), as ``torch.cuda.set_sync_debug_mode("warn")``
    reports them."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        if argv[2:3] and argv[2].startswith("--grad"):
            grad_child(argv[1], argv[2].partition("=")[2] or "abc")
        else:
            child(argv[1], argv[2:] == ["--north-star"])
        return 0
    flags = [a for a in argv if a == "--north-star" or a.split("=")[0] == "--grad"]
    roots = [a for a in argv if a not in flags]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve()), *flags],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
