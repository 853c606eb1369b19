"""Exact (direct-DFT) nonuniform transforms.

Two roles, as in ``fftvis_tpu/nufft/direct.py``:

- the NumPy float64 oracles :func:`direct_type1_np`, :func:`direct_type2_np`
  and :func:`direct_type3_np`, copies of the JAX package's, which the
  port's NUFFT namespace carries under the same names;
- the tensor transforms :func:`direct_type3` (the port of
  ``direct_type3_jax``: for small (n_src x n_targets) problems one dense
  complex matmul per source block, exact to working precision; the
  engine's planner picks it below the NUFFT crossover), :func:`direct_type1`
  and :func:`direct_type2`, on any device: the on-card oracles of the
  public transforms.
"""

from __future__ import annotations

import numpy as np
import torch


def direct_type3_np(x: np.ndarray, c: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Exact f[.,k] = sum_j c[.,j] exp(+i s_k . x_j). NumPy, float64.

    x: (d, n), c: (..., n), s: (d, m) -> (..., m)
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    s = np.atleast_2d(np.asarray(s, dtype=np.float64))
    phase = np.einsum("dj,dk->jk", x, s)  # (n, m)
    return np.asarray(c) @ np.exp(1j * phase)


def direct_type1_np(x: np.ndarray, c: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Exact type-1 gathered at integer modes. NumPy, float64.

    x: (d, n) radians, c: (..., n), modes: (d, m) ints -> (..., m)
    """
    return direct_type3_np(x, c, np.asarray(modes, dtype=np.float64))


def direct_type2_np(x: np.ndarray, f: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Exact type-2: c[., j] = sum_k f[., k] exp(+i modes_k . x_j).

    x: (d, n) radians, f: (..., m), modes: (d, m) ints -> (..., n).
    The transpose of :func:`direct_type1_np` (same +i sign convention).
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    modes = np.atleast_2d(np.asarray(modes, dtype=np.float64))
    phase = np.einsum("dk,dj->kj", modes, x)  # (m, n)
    return np.asarray(f) @ np.exp(1j * phase)


def direct_type3(x, c, s, source_block: int = 8192) -> torch.Tensor:
    """Exact f[., k] = sum_j c[., j] exp(+i s_k . x_j).

    x: (d, n) real tensor, c: (C, n) complex tensor, s: (d, m) real (tensor
    or array; moved to x's dtype and device). Blocks over sources so the
    (block, m) phase matrix stays bounded. Returns (C, m).
    """
    x = torch.atleast_2d(x)
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    s = torch.atleast_2d(s)
    out = torch.zeros((c.shape[0], s.shape[1]), dtype=c.dtype, device=c.device)
    for b0 in range(0, x.shape[1], source_block):
        xb = x[:, b0 : b0 + source_block]
        phase = torch.einsum("db,dm->bm", xb, s)  # (B, m)
        e = torch.complex(torch.cos(phase), torch.sin(phase))
        out += c[:, b0 : b0 + source_block] @ e
    return out


def direct_type1(x, c, modes, source_block: int = 8192) -> torch.Tensor:
    """Exact type-1 at integer ``modes`` (d, m): x (d, n) radians, c (C, n)
    -> (C, m), on x's device and in its dtype."""
    return direct_type3(x, c, np.asarray(modes, dtype=np.float64), source_block)


def direct_type2(x, f, modes, point_block: int = 8192) -> torch.Tensor:
    """Exact type-2: c[., j] = sum_k f[., k] exp(+i modes_k . x_j).

    x (d, n) radians (real tensor), f (C, m) complex, modes (d, m) ints ->
    (C, n). Blocks over points so the (m, block) phase matrix stays
    bounded."""
    x = torch.atleast_2d(x)
    k = torch.atleast_2d(torch.as_tensor(np.asarray(modes, dtype=np.float64),
                                         dtype=x.dtype, device=x.device))
    out = torch.empty((f.shape[0], x.shape[1]), dtype=f.dtype, device=f.device)
    for b0 in range(0, x.shape[1], point_block):
        phase = torch.einsum("dm,db->mb", k, x[:, b0 : b0 + point_block])  # (m, B)
        out[:, b0 : b0 + point_block] = f @ torch.complex(torch.cos(phase), torch.sin(phase))
    return out
