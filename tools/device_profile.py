"""The device kernels of a call, from torch.profiler.

``kernel_ab.py`` and ``wall_ab.py`` both count with :func:`device_kernels`,
so one rule decides what a device kernel is: a device-side profiler event
(an aten op's host-side event carries its kernels' time again), copies and
fills left out.
"""

from __future__ import annotations


def device_kernels(fn, reps: int = 1, symbol: str | None = None) -> dict:
    """Call ``fn`` once to warm up, then ``reps`` times under torch.profiler.

    Returns ``kernels``, the device kernels a call launches, and
    ``device_us``, their device time a call in microseconds; with
    ``symbol``, only the kernels whose name holds it.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    count = us = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key.startswith(
                ("Memcpy", "Memset")):
            continue
        if symbol is not None and symbol not in ev.key:
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
        count += ev.count
    return {"kernels": count / reps, "device_us": us / reps}
