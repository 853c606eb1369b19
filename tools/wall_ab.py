"""Time warm ``simulate_vis`` calls of several checkouts, in turns.

    python3 tools/wall_ab.py [--north-star] ROOT [ROOT ...]

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
        child(argv[1], argv[2:] == ["--north-star"])
        return 0
    flags = [a for a in argv if a == "--north-star"]
    roots = [a for a in argv if a != "--north-star"]
    if not roots:
        raise SystemExit(__doc__)
    for root in roots:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve()), *flags],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
