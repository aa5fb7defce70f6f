"""Packed banded storage (paper §IV-b), batch-native.

The matrix entering stage 2 is upper-triangular banded: ``A[i, j] != 0`` only
for ``0 <= j - i <= bw``.  During bulge chasing with inner tilewidth ``tw``
fill-in stays within ``tw`` rows below the diagonal and ``tw`` columns beyond
the band, so the packed storage holds ``bw + 2*tw + 1`` diagonals:

    band[tw + (j - i), j] = A[i, j]        for -tw <= j - i <= bw + tw

Row ``tw`` is the main diagonal; rows above it are subdiagonals (bulge
space); rows below it are superdiagonals (band + overhang bulge space).
Every helper indexes the trailing two axes only, so a batch of B problems is
one tensor ``(B, H, n)``.
"""

from __future__ import annotations

import torch

__all__ = ["band_height", "pack", "unpack", "band_extract_diag",
           "pad_columns"]


def band_height(bw: int, tw: int) -> int:
    """Number of stored diagonals: tw sub + main + (bw + tw) super."""
    return bw + 2 * tw + 1


def pack(a: torch.Tensor, bw: int, tw: int) -> torch.Tensor:
    """Dense (..., n, n) -> packed band (..., band_height, n).

    Entries outside ``-tw <= j - i <= bw + tw`` are dropped (they must be zero
    for a well-formed banded input)."""
    n = a.shape[-1]
    h = band_height(bw, tw)
    d = torch.arange(h, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    i = j - (d - tw)                                   # source row
    valid = (i >= 0) & (i < n)
    vals = a[..., i.clamp(0, n - 1), j.expand(h, n)]
    return torch.where(valid, vals, torch.zeros((), dtype=a.dtype,
                                                device=a.device))


def unpack(band: torch.Tensor, bw: int, tw: int, n: int) -> torch.Tensor:
    """Packed band (..., band_height, >= n) -> dense (..., n, n)."""
    h = band_height(bw, tw)
    ncols = band.shape[-1]
    i = torch.arange(n, device=band.device)[:, None]
    j = torch.arange(n, device=band.device)[None, :]
    d = tw + (j - i)
    valid = (d >= 0) & (d < h)
    vals = band[..., d.clamp(0, h - 1), j.clamp(0, ncols - 1).expand(n, n)]
    return torch.where(valid, vals, torch.zeros((), dtype=band.dtype,
                                                device=band.device))


def band_extract_diag(band: torch.Tensor, tw: int, k: int,
                      n: int) -> torch.Tensor:
    """Diagonal k (0 main, 1 first super) as a (..., n) vector; entries
    before the matrix edge (j < k) are zero."""
    row = band[..., tw + k, :n]
    j = torch.arange(n, device=band.device)
    return torch.where(j - k >= 0, row, torch.zeros((), dtype=band.dtype,
                                                    device=band.device))


def pad_columns(band: torch.Tensor, pad: int) -> torch.Tensor:
    """A new tensor with ``pad`` zero columns on the right, so chase windows
    never clamp at the edge."""
    out = band.new_zeros(band.shape[:-1] + (band.shape[-1] + pad,))
    out[..., :band.shape[-1]] = band
    return out
