"""Auto-rank on against off on the north star at precision 1, in turns.

    python3 tools/auto_rank_ab.py [ROUNDS]

The north star of ``chip_smoke.py`` (HERA-331, 631 baselines, 37
per-antenna variants of the committed beam, polarized, 1 frequency x 2
times, the exact type-1 path) at precision 1 on one CUDA card, in one
process: after one cold call each way, ROUNDS rounds (default 6) of one
warm call with auto-rank (K = 7 eigenbeams, 196 channels) and one under
``FFTVIS_AUTO_RANK=0`` (the pair routing, 720 channels), the order turned
every round. Then, each way: five warm calls under cProfile (the functions
with the most host seconds, their own and cumulative), and one under
torch.profiler (device kernels, their device time, and the device ops with
the most time). Every line is one JSON object.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from device_profile import device_kernels  # noqa: E402


def setting(on: bool) -> None:
    if on:
        os.environ.pop("FFTVIS_AUTO_RANK", None)
    else:
        os.environ["FFTVIS_AUTO_RANK"] = "0"


def top_device_ops(fn, n: int = 12) -> list:
    """The n device ops with the most device time in one call of ``fn``
    (warm), as [microseconds, count, name]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(ev, "self_device_time_total", None)
            rows.append([round(ev.self_cuda_time_total if t is None else t, 2), ev.count,
                         ev.key[:90]])
    return sorted(rows, reverse=True)[:n]


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke
    from fftvis_tpu_torch import simulate_vis

    rounds = int(argv[0]) if argv else 6
    kw = dict(chip_smoke.north_star_config(), precision=1)

    def call():
        simulate_vis(device="cuda", **kw)
        torch.cuda.synchronize()

    for on in (True, False):
        setting(on)
        call()
    walls = {True: [], False: []}
    for r in range(rounds):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            setting(on)
            t0 = time.perf_counter()
            call()
            walls[on].append(time.perf_counter() - t0)
    for on in (True, False):
        setting(on)
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(5):
            call()
        prof.disable()
        stats = pstats.Stats(prof).stats
        by_own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
        by_cum = sorted(stats.items(), key=lambda kv: -kv[1][3])[:25]
        dev = device_kernels(call)
        print(json.dumps({
            "auto_rank": on, "walls_s": walls[on], "median_s": float(np.median(walls[on])),
            "host_own_s_5_calls": [[f"{Path(k[0]).name}:{k[2]}", round(v[2], 5)]
                                   for k, v in by_own],
            "host_cum_s_5_calls": [[f"{Path(k[0]).name}:{k[2]}", round(v[3], 5)]
                                   for k, v in by_cum],
            "device_kernels": dev["kernels"], "device_kernel_ms": dev["device_us"] / 1e3,
            "top_device_ops_us": top_device_ops(call),
        }), flush=True)
    setting(True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
