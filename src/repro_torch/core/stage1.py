"""Stage 1: dense -> upper-banded reduction (blocked two-sided Householder),
batch-native.

Alternating QR panels (zero below the diagonal in an ``nb``-column stripe)
and LQ panels (zero beyond the ``nb``-th superdiagonal in an ``nb``-row
stripe), each followed by a compact-WY blocked trailing update.  A port of
the reference's ``core/stage1.py``:

* the matrix is zero-padded to a panel multiple, ``big = (P + 2) * nb``, so
  every stripe slice is aligned; padded reflectors are the identity
  (tau = 0) by construction;
* panels are factorized unblocked (rank-1 applies on the stripe), writing
  exact structural zeros after every reflector, as LAPACK does;
* the QR trailing update is one ``ops.hh_block_apply`` over the B matrices
  of a batch (on "cuda" the hand-written kernel,
  ``kernels/csrc/hh_apply.cu``), applied at full width as the reference's
  Pallas route does: the panel's own stripe is saved before the call (the
  kernel writes in place) and restored after it, and columns left of the
  panel hold exact zeros in V's row support, so the apply leaves them as
  they are;
* the LQ trailing update, ``V^T V`` of the T factor and the panels' rank-1
  updates are plain tensor ops, as in the reference, which runs them
  outside any Pallas kernel.

The P panels run in a Python loop (the reference's ``fori_loop``); a batch
(B, n, n) runs on one (B, big, big) tensor, never matrix by matrix.
"""

from __future__ import annotations

import torch

from repro_torch.core.householder import acc_dtype

__all__ = ["band_reduce", "wy_t_factor"]


def _masked_reflector(col: torch.Tensor, pivot: int):
    """Householder (v, tau, beta) for the entries of ``col`` (..., m) at
    indices >= ``pivot``.

    ``v[pivot] = 1`` (0 when the pivot is past the end), zeros above it;
    ``tau = 0`` (the identity) when the tail below the pivot is zero, which
    covers padded pivots, whose columns are zero."""
    m = col.shape[-1]
    idx = torch.arange(m, device=col.device)
    piv = min(max(pivot, 0), m - 1)
    alpha = col[..., piv]
    zero = torch.zeros((), dtype=col.dtype, device=col.device)
    one = torch.ones((), dtype=col.dtype, device=col.device)
    tail = torch.where(idx > pivot, col, zero)
    sigma = (tail * tail).sum(-1)
    mu = torch.sqrt(alpha * alpha + sigma)
    beta = torch.where(alpha >= 0, -mu, mu)
    safe = sigma > 0
    denom = torch.where(safe, alpha - beta, one)
    tau = torch.where(safe, (beta - alpha) / torch.where(beta == 0, one, beta),
                      zero)
    v = torch.where(idx > pivot, col / denom[..., None], zero)
    v[..., piv] = 1.0 if pivot < m else 0.0
    return v, tau, torch.where(safe, beta, alpha)


def wy_t_factor(v: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T (upper triangular) with ``H_0 H_1 ... H_{k-1} =
    I - V T V^T``; v (..., m, k), taus (..., k) -> (..., k, k)."""
    k = taus.shape[-1]
    vtv = v.transpose(-1, -2) @ v
    ar = torch.arange(k, device=v.device)
    t = v.new_zeros(v.shape[:-2] + (k, k))
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    for j in range(k):
        x = torch.where(ar < j, vtv[..., :, j], zero)
        col = -taus[..., j, None] * (t @ x[..., None])[..., 0]
        col[..., j] = taus[..., j]
        t[..., :, j] = torch.where(ar <= j, col, zero)
    return t


def band_reduce(a: torch.Tensor, *, nb: int, backend: str | None = None,
                config=None, tape: bool = False):
    """Reduce dense (..., n, n) to upper-banded form with bandwidth ``nb``.

    Singular values are preserved (two-sided orthogonal transforms).  An
    explicit ``backend=`` wins; otherwise a given ``config`` supplies it;
    otherwise "auto" (the device's backend).

    With ``tape=True`` returns ``(banded, (vq, tq, vl, tl))``: the per-panel
    compact-WY reflector tape, ``vq``/``vl`` (..., P, n, nb) (QR / LQ
    reflector blocks, rows truncated to n, since the padding rows are
    structurally zero) and ``tq``/``tl`` (..., P, nb, nb), their T factors.
    ``core/transforms.py`` replays it into U / V^T.  The banded output is
    bit-identical with and without the tape."""
    from repro_torch.kernels import ops
    if backend is None:
        backend = config.backend if config is not None else "auto"
    backend = ops.resolve_backend(backend, a.device)
    lead = a.shape[:-2]
    n = a.shape[-1]
    dt = a.dtype
    acc = acc_dtype(dt)
    dev = a.device
    n_panels = max(1, -(-(n - 1) // nb))
    big = (n_panels + 2) * nb
    a3 = a.reshape((-1, n, n))
    B = a3.shape[0]
    work = torch.zeros((B, big, big), dtype=acc, device=dev)
    work[:, :n, :n] = a3.to(acc)
    idx = torch.arange(big, device=dev)
    zero = torch.zeros((), dtype=acc, device=dev)
    if tape:
        vqs = torch.zeros((B, n_panels, big, nb), dtype=acc, device=dev)
        tqs = torch.zeros((B, n_panels, nb, nb), dtype=acc, device=dev)
        vls = torch.zeros_like(vqs)
        tls = torch.zeros_like(tqs)

    for k in range(n_panels):
        c0 = k * nb
        # -------- QR panel: columns [c0, c0+nb), pivot row c0+j ------------
        v_blk = torch.zeros((B, big, nb), dtype=acc, device=dev)
        taus = torch.zeros((B, nb), dtype=acc, device=dev)
        for j in range(nb):
            c = c0 + j
            stripe = work[:, :, c0:c0 + nb]
            v, tau, beta = _masked_reflector(stripe[:, :, j], c)
            w = (v[:, None, :] @ stripe)[:, 0, :]
            stripe = stripe - tau[:, None, None] * (v[:, :, None]
                                                    * w[:, None, :])
            newcol = torch.where(idx > c, zero, stripe[:, :, j])
            newcol[:, c] = torch.where(tau != 0, beta, newcol[:, c])
            stripe[:, :, j] = newcol
            work[:, :, c0:c0 + nb] = stripe
            v_blk[:, :, j] = v
            taus[:, j] = tau
        t = wy_t_factor(v_blk, taus)
        # blocked trailing update Q^T = I - V T^T V^T on columns >= c0+nb,
        # applied at full width; the panel's stripe is saved first (the
        # "cuda" apply is in place) and restored after
        saved = work[:, :, c0:c0 + nb].clone()
        work = ops.hh_block_apply(v_blk, t.transpose(-1, -2).contiguous(),
                                  work, backend=backend)
        work[:, :, c0:c0 + nb] = saved

        # -------- LQ panel: rows [c0, c0+nb), pivot column c0+nb+j ---------
        vr_blk = torch.zeros((B, big, nb), dtype=acc, device=dev)
        taus_r = torch.zeros((B, nb), dtype=acc, device=dev)
        for j in range(nb):
            c_piv = c0 + nb + j
            stripe = work[:, c0:c0 + nb, :]
            v, tau, beta = _masked_reflector(stripe[:, j, :], c_piv)
            w = (stripe @ v[:, :, None])[..., 0]
            stripe = stripe - tau[:, None, None] * (w[:, :, None]
                                                    * v[:, None, :])
            newrow = torch.where(idx > c_piv, zero, stripe[:, j, :])
            newrow[:, c_piv] = torch.where(tau != 0, beta, newrow[:, c_piv])
            stripe[:, j, :] = newrow
            work[:, c0:c0 + nb, :] = stripe
            vr_blk[:, :, j] = v
            taus_r[:, j] = tau
        tr = wy_t_factor(vr_blk, taus_r)
        # blocked trailing update from the right on rows >= c0+nb
        w = work @ vr_blk
        w = torch.where(idx[:, None] >= c0 + nb, w, zero)
        work = work - w @ (tr @ vr_blk.transpose(-1, -2))
        if tape:
            vqs[:, k] = v_blk
            tqs[:, k] = t
            vls[:, k] = vr_blk
            tls[:, k] = tr

    out = work[:, :n, :n].to(dt).reshape(lead + (n, n))
    if not tape:
        return out
    # rows >= n of every reflector block are structurally zero (the padded
    # region never becomes nonzero), so the tape keeps the matrix rows only
    return out, tuple(x.reshape(lead + x.shape[1:]) for x in (
        vqs[:, :, :n].contiguous(), tqs, vls[:, :, :n].contiguous(), tls))
