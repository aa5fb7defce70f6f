"""Householder reflector numerics (LAPACK ``larfg``-style).

A reflector over ``x = [alpha, x2]`` gives ``(I - tau v v^T) x = [beta, 0]``
with ``v[0] = 1``.  Zero tails (``x2 == 0``, tested as ``sigma > 0`` on the
exact sum of squares) and all-zero vectors give ``tau = 0`` exactly: the
identity.  That is what makes the chase's padding free: padded windows and
the per-slot dump zones are exactly zero, so their reflectors never touch
anything.

Half types accumulate in float32; float32 and float64 stay in their type.
"""

from __future__ import annotations

import torch

__all__ = ["acc_dtype", "make_reflector", "apply_left", "apply_right"]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type of a storage type."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def make_reflector(x: torch.Tensor):
    """(v, tau, beta) for the last axis of ``x`` (length L), batched over the
    leading axes, all in the accumulation type.

    ``beta`` takes the sign opposite to ``alpha`` (no cancellation).  Where
    ``sigma == 0``: ``tau = 0``, ``v = e_0``, ``beta = alpha``."""
    acc = acc_dtype(x.dtype)
    xa = x.to(acc)
    alpha = xa[..., 0]
    x2 = xa[..., 1:]
    sigma = (x2 * x2).sum(-1)
    mu = torch.sqrt(alpha * alpha + sigma)
    beta = torch.where(alpha >= 0, -mu, mu)
    safe = sigma > 0
    one = torch.ones((), dtype=acc, device=x.device)
    zero = torch.zeros((), dtype=acc, device=x.device)
    denom = torch.where(safe, alpha - beta, one)
    tau = torch.where(safe, (beta - alpha) / torch.where(beta == 0, one, beta),
                      zero)
    v2 = torch.where(safe[..., None], x2 / denom[..., None], zero)
    v = torch.cat([torch.ones_like(alpha)[..., None], v2], dim=-1)
    return v, tau, torch.where(safe, beta, alpha)


def apply_left(v: torch.Tensor, tau: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """C <- (I - tau v v^T) C,  v: (L,), C: (L, m)."""
    acc = acc_dtype(c.dtype)
    vv = v.to(acc)
    w = vv @ c.to(acc)
    return (c.to(acc) - tau.to(acc) * torch.outer(vv, w)).to(c.dtype)


def apply_right(v: torch.Tensor, tau: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """C <- C (I - tau v v^T),  v: (L,), C: (m, L)."""
    acc = acc_dtype(c.dtype)
    vv = v.to(acc)
    w = c.to(acc) @ vv
    return (c.to(acc) - tau.to(acc) * torch.outer(w, vv)).to(c.dtype)
