"""Exact (direct-DFT) type-3 transform on tensors.

The port of ``direct_type3_jax`` (``fftvis_tpu/nufft/direct.py``): for small
(n_src x n_targets) problems the direct sum is one dense complex matmul per
source block, exact to working precision. The engine's planner picks it
below the NUFFT crossover, and the on-card check runs it in float64 as the
oracle of the type-3 path.
"""

from __future__ import annotations

import torch


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
