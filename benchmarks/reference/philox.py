"""The benchmark's frozen copy of the port's ``ops/philox.py``.

Philox-4x32-10 (Salmon et al., SC'11; Random123's constants) in int64
tensor arithmetic: the plain version of ``csrc/philox.cuh``, bit for bit.

The seed-mode kernels draw every dropout mask element as a pure function of
(seed, global sample index, site, element index): key (seed, sample),
counter (element // 4, site, 0, 0), word element % 4; keep iff
``bits < uint32(keep · 0xFFFFFFFF)``. Sites 0-3 are the attention layer's
(``ops/attention.py::draw_keep_masks``), site 4 the projection head's
(``ops/projection.py::draw_keep_mask``).
"""

from __future__ import annotations

import numpy as np
import torch

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a·b for a constant a and int64 b < 2³²,
    without overflowing int64: a = a_hi·2¹⁶ + a_lo."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_10(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox-4x32-10 on int64 tensors holding uint32 values: four counter
    words and two key words (tensors or ints, broadcast) → four words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_rule(dropout_p: float) -> tuple[int, float]:
    """(threshold, value): keep iff bits < threshold, as the JAX kernels'
    ``np.uint32(int(keep * 0xFFFFFFFF))``; a kept element is ``1/keep``."""
    keep = 1.0 - dropout_p
    return int(keep * 0xFFFFFFFF), float(np.float32(1.0 / keep))


def site_bits(seed: int, rows: torch.Tensor, site: int, n: int) -> torch.Tensor:
    """(len(rows), n) uint32 draws (as int64) of one site."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=rows.device)
    c0 = groups[None, :].expand(len(rows), -1)
    zero = torch.zeros_like(c0)
    words = philox4x32_10((c0, zero + site, zero, zero),
                          (seed & _U32, rows[:, None]))
    return torch.stack(words, dim=-1).reshape(len(rows), -1)[:, :n]


def keep_mask(seed: int, rows: torch.Tensor, site: int, n: int,
              dropout_p: float) -> torch.Tensor:
    """(len(rows), n) fp32 keep-mask of one site: 1/keep where kept, else 0."""
    thresh, value = keep_rule(dropout_p)
    bits = site_bits(int(seed), rows, site, n)
    return torch.where(bits < thresh,
                       torch.tensor(value, device=rows.device),
                       torch.tensor(0.0, device=rows.device))
