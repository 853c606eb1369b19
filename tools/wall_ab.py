"""Time warm ``simulate_vis`` calls of several checkouts, in turns.

    python3 tools/wall_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository. Each runs in a process of its
own, in the order given (for an A/B, parent, change, change, parent), the
polarized tabulated slice of ``chip_smoke.py`` at precision 1 and 2:
hex_array(11, outriggers=2) with all 63,190 i<=j baselines, the nside=64
HEALPix sky, 2 frequencies x 3 times, forced type-3, the committed
``structured_dipole_100MHz.beamfits`` with the order-3 spline, on one CUDA
card. After one cold call, ``CALLS`` warm calls are timed on the host clock
(the call returns host arrays, so each ends with the card idle), and one
more warm call runs under cProfile. Every line is one JSON object: the
root, the precision, the warm walls in seconds, and the cumulative host
seconds of the profiled call in the functions of ``PROFILED`` that the
root has.
"""

from __future__ import annotations

import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

FREQS = (1.0e8, 1.1e8)
CALLS = 10
PROFILED = ("simulate_vis", "plan_transform", "prepare_beam", "run_program",
            "_device_tables", "target_order", "footprint_runs")


def child(root: str) -> None:
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
        print(json.dumps({"root": root, "precision": precision, "walls_s": walls,
                          "profiled_s": cum}), flush=True)


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
