"""Stage 3: singular values of upper-bidiagonal matrices, by Sturm bisection.

Golub–Kahan form: the permuted matrix [[0, B^T], [B, 0]] is symmetric
tridiagonal of size 2n with zero diagonal and off-diagonal
``z = (d_1, e_1, d_2, e_2, ..., e_{n-1}, d_n)``; its eigenvalues are
±sigma.  Counting the eigenvalues below a shift with an LDL^T negative-pivot
recurrence and bisecting gives every sigma independently.

``bidiag_singular_values`` prescales and bounds with torch ops and hands the
bisection to ``ops.sturm_bisect``: the CUDA kernel ``csrc/sturm.cu`` on the
card, the plain version ``bisect_plain`` (built on ``sturm_count``) on the
CPU or under ``backend="ref"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.householder import acc_dtype

__all__ = ["default_bisect_iters", "gk_offdiag", "sturm_count",
           "bisect_plain", "gk_problem", "bidiag_singular_values",
           "bidiag_singular_values_plain"]


def default_bisect_iters(acc: torch.dtype) -> int:
    """Bisection steps that take the Gershgorin bracket below one ulp: 60
    cover fp64's 52-bit mantissa with headroom, 40 cover fp32."""
    return 60 if acc == torch.float64 else 40


def gk_offdiag(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Interleave (d, e) -> Golub–Kahan off-diagonal z (..., 2n-1).

    d: (..., n) main diagonal; e: (..., n) with e[..., 0] unused
    (e[i] = B[i-1, i])."""
    n = d.shape[-1]
    z = d.new_zeros(d.shape[:-1] + (2 * n - 1,))
    z[..., 0::2] = d
    z[..., 1::2] = e[..., 1:]
    return z


def sturm_count(z: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvalues below ``lam`` of the zero-diagonal tridiagonal with
    off-diagonal ``z`` (..., m-1); ``lam`` (..., K) holds K shifts per row.

    Pivot recurrence ``t_k = -lam - z_{k-1}^2 / t_{k-1}``, ``t_1 = -lam``,
    counting negative pivots, with pivots below ``4 * tiny`` lifted to
    ``±4 * tiny``.  The plain version of the kernel's inner loop."""
    acc = acc_dtype(z.dtype)
    z = z.to(acc)
    lam = lam.to(acc)
    tiny = torch.tensor(torch.finfo(acc).tiny * 4, dtype=acc, device=z.device)
    t = -lam
    cnt = (t < 0).to(torch.int32)
    zz = (z * z)[..., None]                   # (..., m-1, 1)
    for k in range(z.shape[-1]):
        t = torch.where(t.abs() < tiny, torch.where(t < 0, -tiny, tiny), t)
        t = -lam - zz[..., k, :] / t
        cnt = cnt + (t < 0)
    return cnt


def bisect_plain(z: torch.Tensor, bound: torch.Tensor, *, n: int,
                 max_iter: int) -> torch.Tensor:
    """Plain version of the kernel ``sturm_bisect_cuda``: singular values
    (B, n), descending, of the prescaled problems ``z`` (B, 2n-1) on
    ``[0, bound]``."""
    ks = torch.arange(1, n + 1, device=z.device)
    lo = torch.zeros(z.shape[:-1] + (n,), dtype=z.dtype, device=z.device)
    hi = bound[..., None].expand_as(lo).clone()
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        below = (sturm_count(z, mid) - n) >= ks
        lo = torch.where(below, lo, mid)
        hi = torch.where(below, mid, hi)
    return (0.5 * (lo + hi)).flip(-1)


def _gk_prescale(z: torch.Tensor) -> torch.Tensor:
    """Exact power-of-two scale of max|z| per row (1 for a zero row):
    dividing it out keeps z^2 inside the exponent range without touching a
    mantissa bit.  ``torch.round`` rounds half to even, as the reference."""
    zmax = z.abs().amax(-1)
    expo = torch.round(torch.log2(torch.where(zmax > 0, zmax,
                                              torch.ones_like(zmax))))
    return torch.exp2(expo)


def gk_problem(d: torch.Tensor, e: torch.Tensor):
    """The bisection's inputs for the bidiagonals (d, e) (..., n), n >= 2.

    Returns ``(z, bound, scale)``: the prescaled Golub–Kahan off-diagonals
    ``z`` (B, 2n-1) in the accumulation type, the Gershgorin bound
    ``||T_GK||_inf + 1`` (B,) of each, and the power-of-two scale (B,) to
    multiply the singular values back by; B is the product of the leading
    axes."""
    n = d.shape[-1]
    acc = acc_dtype(d.dtype)
    z = gk_offdiag(d.to(acc), e.to(acc)).reshape(-1, 2 * n - 1)
    scale = _gk_prescale(z)
    z = (z / scale[:, None]).contiguous()
    az = torch.nn.functional.pad(z.abs(), (1, 1))
    bound = ((az[:, :-1] + az[:, 1:]).amax(-1) + 1).contiguous()
    return z, bound, scale


def bidiag_singular_values(d: torch.Tensor, e: torch.Tensor, *,
                           max_iter: int | None = None,
                           backend: str = "auto") -> torch.Tensor:
    """All singular values of the bidiagonals (d, e) (..., n), descending.

    Bisection on ``[0, bound]``, ``bound = ||T_GK||_inf`` by Gershgorin plus
    one, after a power-of-two prescale.  ``max_iter=None`` picks the
    type-matched step count.  ``backend="auto"`` runs the CUDA kernel on a
    CUDA tensor and the plain version on the CPU."""
    from repro_torch.kernels import ops
    if max_iter is not None and max_iter < 1:
        raise ValueError(f"max_iter must be None (auto) or >= 1, got "
                         f"{max_iter}")
    lead = d.shape[:-1]
    n = d.shape[-1]
    if n == 1:
        return d.abs()
    z, bound, sc = gk_problem(d, e)
    if max_iter is None:
        max_iter = default_bisect_iters(z.dtype)
    sig = ops.sturm_bisect(z, bound, n=n, max_iter=max_iter, backend=backend)
    return (sig * sc[:, None]).to(d.dtype).reshape(lead + (n,))


def bidiag_singular_values_plain(d: torch.Tensor, e: torch.Tensor, *,
                                 max_iter: int | None = None) -> torch.Tensor:
    """``bidiag_singular_values`` through the plain version, on any device."""
    return bidiag_singular_values(d, e, max_iter=max_iter, backend="ref")
