"""Type-2 tap interpolation: the hand-written CUDA kernel and its plain
torch version.

Replaces the Pallas occupancy-proportional interpolation of the JAX package
(``fftvis_tpu/nufft/pallas_interp.py``, ``_build_interp_call``, driven by
``PallasInterp.__call__``), which computes

    out[c, t] = sum_a sum_b G[c, iy[t, a], ix[t, b]] * vy[t, a] * vx[t, b]

from the plan's host-computed taps (``Type3Plan.tap_idx`` / ``tap_val``,
already taken ``mod nf``). The TPU kernel bin-sorts targets into tiles and
rebuilds the taps as one-hot matrices for its matrix unit, because gathers
are slow there. On the card a gather is the natural form: the CUDA kernel
(``csrc/interp.cu``) runs one thread per (target, channel), reads the w x w
taps straight from G (interleaved re/im) and writes ``out[c, t]`` in target
order. Outputs are disjoint, so there is no race, no sort, no inverse
permutation and no wrap-pad.

What bounds it on the card: m * w^2 * 2C gathered reals from a grid far
larger than L2 (104 MB per channel at the slice's float32 size); targets
arrive in baseline order, so neighbouring threads gather from scattered
rows. The design takes that as it is for now: one pass, no staging.
"""

from __future__ import annotations

import ctypes

import torch

launches = 0


def interp_plain(G, iy, ix, vy, vx) -> torch.Tensor:
    """Plain torch interpolation: the gather + einsum of the JAX
    package's ``Type3Executor.interpolate``. Returns (C, m) complex."""
    sub = G[:, iy.long()[:, :, None], ix.long()[:, None, :]]  # (C, m, w, w)
    return torch.einsum("cmab,ma,mb->cm", sub, vy.to(G.dtype), vx.to(G.dtype))


def _check(G, iy, ix, vy, vx) -> None:
    if not (G.device == iy.device == ix.device == vy.device == vx.device):
        raise ValueError("interp: all tensors must be on one device")
    if G.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"interp: grid must be complex64/complex128, got {G.dtype}")
    rdt = G.real.dtype
    if iy.dtype != torch.int32 or ix.dtype != torch.int32:
        raise TypeError("interp: tap indices must be int32")
    if vy.dtype != rdt or vx.dtype != rdt:
        raise TypeError(f"interp: tap values must be {rdt}, got {vy.dtype}, {vx.dtype}")
    if G.dim() != 3:
        raise ValueError(f"interp: grid must be (C, nfy, nfx), got {tuple(G.shape)}")
    if iy.dim() != 2 or iy.shape != ix.shape or iy.shape != vy.shape or vy.shape != vx.shape:
        raise ValueError("interp: tap tables must all be (m, w)")
    for name, t in (("G", G), ("iy", iy), ("ix", ix), ("vy", vy), ("vx", vx)):
        if not t.is_contiguous():
            raise ValueError(f"interp: {name} must be contiguous")


def interp(G, iy, ix, vy, vx) -> torch.Tensor:
    """Interpolate G (C, nfy, nfx) complex at m targets with (m, w) taps.

    A CPU tensor takes :func:`interp_plain`; a CUDA tensor launches the
    CUDA kernel; any other device raises.
    """
    _check(G, iy, ix, vy, vx)
    if G.device.type == "cpu":
        return interp_plain(G, iy, ix, vy, vx)
    if G.device.type != "cuda":
        raise ValueError(f"interp: unsupported device {G.device}")
    return _interp_cuda(G, iy, ix, vy, vx)


def _interp_cuda(G, iy, ix, vy, vx) -> torch.Tensor:
    global launches
    from .._build import load_kernels

    lib = load_kernels()
    C, nfy, nfx = G.shape
    m, w = iy.shape
    out = torch.empty((C, m), dtype=G.dtype, device=G.device)
    if m == 0:
        return out
    fn = lib.fftvis_interp_f32 if G.dtype == torch.complex64 else lib.fftvis_interp_f64
    err = fn(
        ctypes.c_void_p(G.data_ptr()),
        ctypes.c_void_p(iy.data_ptr()),
        ctypes.c_void_p(ix.data_ptr()),
        ctypes.c_void_p(vy.data_ptr()),
        ctypes.c_void_p(vx.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        C, nfy, nfx, m, w,
        ctypes.c_void_p(torch.cuda.current_stream(G.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"interp kernel launch failed: CUDA error {err}")
    launches += 1
    return out
