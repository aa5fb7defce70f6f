"""Stage 3 by divide and conquer: the singular values of upper-bidiagonal
matrices through Cuppen's method on the Golub–Kahan tridiagonal.

The Golub–Kahan (GK) tridiagonal ``[[0, B^T], [B, 0]]`` of size m = 2n is
padded to ``big = lm * 2^levels`` (lm = 2 * leaf_n; sentinel poles below
the spectrum, which deflate at every merge) and split at every leaf
boundary: each boundary off-diagonal ``b_i`` becomes the rank-one term of
one merge, its |b_i| taken off the two diagonal entries it touches.

  leaves  each lm-row leaf by Sturm bisection with a diagonal, then two
          rounds of guarded inverse iteration and a same-cluster
          Gram–Schmidt for the first and last rows of its eigenvectors;
  merge   level by level: the children's spectra and rows (f, l) form the
          secular equation ``1 + sum_i w_i / (d_i - mu) = 0``; negligible
          weights and near-equal poles deflate (a Givens scan), the roots
          of the active poles are solved, the weights are recomputed from
          the roots (Gu–Eisenstat's Loewner product) and the parent's f and
          l rows formed from them.

It is the reference's ``core/bidiag_dc.py`` in PyTorch, with the same
constants and arithmetic but two.  What differs:

* Two accuracy faults of the reference, which the bidiagonals of banded
  matrices show (``core/tuning.py`` has the cases), are fixed: the exact
  polish passes of a root are capped at ``DC_POLISH_ITERS`` = 64, not 12
  (a root of a banded fp64 n = 2048 bidiagonal needs more); and a leaf
  vector that collapses in the Gram–Schmidt gets ``DC_FALLBACK_ITERS``
  steps of inverse iteration on its projected unit vector, where the
  reference takes that vector as it is.  Where the reference's roots reach
  their floor in 12 passes and no leaf vector collapses, the arithmetic is
  the reference's.
* The reference skips all-deflated blocks with ``lax.cond`` per 512-wide
  block.  Here the active poles form a contiguous prefix after the merge's
  partitions, so each level reads its largest active count once (one
  ``.item()``) and runs every full-width pass on that prefix only.  The
  plain root solve takes its roots in blocks of ``_SECULAR_CHUNK``; the
  Loewner product and the f/l rows sum over the whole prefix at once and
  split only their target axis, into blocks as long as one (P, rows, nact)
  temporary of ``tuning.DC_MERGE_BLOCK_BYTES`` allows (every level of an
  fp64 n = 4096 call in one block), so a level launches a few dozen
  kernels there and not a few per pair of blocks.  Only the plain
  versions wait more: the root solve every 12 polish passes of a block,
  to stop when no root moves (the kernel stops each root's warp alone),
  and the leaves once an index, to skip the collapse fallback where no
  leaf needs it.
* The reference batches matrices with ``lax.map``; here the subproblems of
  all B matrices stand side by side on the pair axis of each level.  The
  arithmetic of each matrix is the same.
* Three sequential parts go through ``kernels/ops.py``, so that
  ``backend="cuda"`` runs them as kernels (``kernels/csrc/dc.cu``) and
  "ref" as their plain versions below: the leaves (``ops.dc_leaf``,
  :func:`leaf_eigen_plain`), the Givens scan (``ops.dc_deflate``,
  :func:`deflate_plain`) and the root solve (``ops.dc_secular``,
  :func:`secular_plain`).  Sorting, the partitions and the O(m^2) passes
  after the roots stay in torch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.bidiag_svd import (_gk_prescale, _vectors_from_sigma,
                                         bidiag_singular_values, bidiag_svd,
                                         default_bisect_iters, gk_offdiag)
from repro_torch.core.householder import acc_dtype
from repro_torch.core.tuning import (DC_FALLBACK_ITERS, DC_HEAVY_K,
                                     DC_MERGE_BLOCK_BYTES, DC_POLISH_ITERS,
                                     DC_WINDOW_K, DEFAULT_DC_LEAF_N,
                                     DEFAULT_DC_N_MIN)

__all__ = ["DEFAULT_DC_LEAF_N", "DEFAULT_DC_N_MIN", "leaf_eigen_plain",
           "deflate_plain", "secular_plain", "leaf_start",
           "bidiag_dc_singular_values", "bidiag_dc_svd"]

# Roots per block of a full-width pass: bounds the (roots, poles) temporary.
_SECULAR_CHUNK = 512

# Polish passes of the plain root solve between its reads of whether any
# root of a block still moves (the reference's cap on the passes).
_POLISH_CHECK = 12


# ---------------------------------------------------------------------------
# Leaves: Sturm bisection with a diagonal, and inverse iteration
# ---------------------------------------------------------------------------

def _guard(p: torch.Tensor, tiny) -> torch.Tensor:
    """Pivots below ``tiny`` in magnitude lifted to +-tiny."""
    return torch.where(p.abs() < tiny, torch.where(p < 0, -tiny, tiny), p)


def _tridiag_count(a: torch.Tensor, b: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """Eigenvalues below each shift of the symmetric tridiagonals (diag a
    (P, lm), off-diag b (P, lm-1)); lam (P, K) -> counts (P, K):
    q_k = (a_k - lam) - b_{k-1}^2 / q_{k-1}, pivots guarded at 4 * tiny."""
    tiny = torch.finfo(a.dtype).tiny * 4
    q = a[:, :1] - lam
    cnt = (q < 0).to(torch.int32)
    bb = b * b
    for k in range(1, a.shape[-1]):
        q = _guard(q, tiny)
        q = (a[:, k, None] - lam) - bb[:, k - 1, None] / q
        cnt += q < 0
    return cnt


def _tridiag_solve_diag(a: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``(T - lam I) x = rhs`` for every shift: T of diag a (P, lm)
    and off-diag b (P, lm-1), lam (P, K), rhs (P, K, lm) -> x (P, K, lm).
    Thomas elimination with pivots guarded at eps * max(|a|, |b|, 1)."""
    eps = torch.finfo(a.dtype).eps
    m = a.shape[-1]
    tiny = (eps * torch.maximum(a.abs().amax(-1),
                                b.abs().amax(-1)).clamp(min=1))[:, None]
    ys = rhs.new_empty((m,) + lam.shape)
    cs = rhs.new_empty((m - 1,) + lam.shape)
    piv = _guard(a[:, :1] - lam, tiny)
    y = rhs[..., 0] / piv
    ys[0] = y
    for i in range(1, m):
        bi = b[:, i - 1, None]
        c = bi / piv
        piv = _guard((a[:, i, None] - lam) - bi * c, tiny)
        y = (rhs[..., i] - bi * y) / piv
        ys[i] = y
        cs[i - 1] = c
    xs = torch.empty_like(ys)
    x = ys[m - 1]
    xs[m - 1] = x
    for i in range(m - 2, -1, -1):
        x = ys[i] - cs[i] * x
        xs[i] = x
    return xs.permute(1, 2, 0)


def leaf_start(lm: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The inverse iteration's start vectors (lm, lm), row k for
    eigenvalue k: ``sin(t * (k + 1) * 0.7) + 0.01``, t = 1..lm,
    normalised; deterministic and k-dependent, which decorrelates a
    cluster."""
    t = torch.arange(1, lm + 1, dtype=dtype, device=device)
    k = torch.arange(lm, dtype=dtype, device=device)
    x0 = torch.sin(t * (k[:, None] + 1) * 0.7) + 0.01
    return x0 / torch.linalg.vector_norm(x0, dim=-1, keepdim=True)


def _leaf_bracket(a: torch.Tensor, b: torch.Tensor):
    """(lo0, hi0, ctol) (P,) of each leaf: its Gershgorin bracket widened
    by eps * scale, and the cluster width of its Gram–Schmidt,
    ``max(1e-3, 64 eps) * scale`` with scale = max(max(|a| + radius), 1)."""
    eps = torch.finfo(a.dtype).eps
    rad = torch.nn.functional.pad(b.abs(), (1, 1))
    rad = rad[:, :-1] + rad[:, 1:]
    scale = (a.abs() + rad).amax(-1).clamp(min=1)
    lo0 = (a - rad).amin(-1) - eps * scale
    hi0 = (a + rad).amax(-1) + eps * scale
    ctol = torch.maximum(1e-3 * scale, 64 * eps * scale)
    return lo0, hi0, ctol


def leaf_eigen_plain(a: torch.Tensor, b: torch.Tensor, lo0: torch.Tensor,
                     hi0: torch.Tensor, ctol: torch.Tensor, x0: torch.Tensor,
                     *, bisect_iters: int, inv_iters: int):
    """Plain version of the kernel ``dc_leaf_cuda``: for each of P leaves
    (diag a (P, lm), off-diag b (P, lm-1)), its eigenvalues ascending and
    the first and last rows of its eigenvectors, each (P, lm).

    Every index k is bisected on [lo0, hi0] for ``bisect_iters`` steps;
    then ``inv_iters`` rounds of inverse iteration from the start rows
    ``x0`` (lm, lm) at each eigenvalue; then, in order of k, vector k loses
    its projections on the earlier vectors of its cluster (eigenvalues
    within ``ctol``).  Where it collapses below 0.01 (inverse iteration
    gave it the direction of an earlier one), the projected unit vector e_k
    takes its place after ``DC_FALLBACK_ITERS`` steps of inverse iteration
    at lam_k, each projected again, so that it lies in lam_k's invariant
    subspace."""
    acc = a.dtype
    tiny = torch.finfo(acc).tiny
    p, lm = a.shape
    ks = torch.arange(lm, device=a.device)
    lo = lo0[:, None].expand(p, lm).clone()
    hi = hi0[:, None].expand(p, lm).clone()
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        ge = _tridiag_count(a, b, mid) >= ks + 1
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    lam = 0.5 * (lo + hi)
    x = x0.expand(p, lm, lm)
    for _ in range(inv_iters):
        x = _tridiag_solve_diag(a, b, lam, x)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
            min=tiny)
    rows = x.clone()
    eye = torch.eye(lm, dtype=acc, device=a.device)

    def unit(w):
        return w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp(
            min=tiny)

    for k in range(1, lm):
        mask = ((ks < k) & (lam[:, k, None] - lam < ctol[:, None])).to(acc)

        def clean(w):
            proj = mask * (rows @ w[..., None])[..., 0]
            return w - (proj[:, None, :] @ rows)[:, 0]

        w1 = clean(rows[:, k])
        n1 = torch.linalg.vector_norm(w1, dim=-1, keepdim=True)
        rows[:, k] = w1 / n1.clamp(min=tiny)
        fall = ~(n1[:, 0] > 0.01)
        if bool(fall.any()):          # one host read an index: few collapse
            w2 = unit(clean(eye[k].expand(p, lm)))
            for _ in range(DC_FALLBACK_ITERS):
                w2 = unit(clean(_tridiag_solve_diag(a, b, lam[:, k, None],
                                                    w2[:, None, :])[:, 0]))
            rows[:, k] = torch.where(fall[:, None], w2, rows[:, k])
    return lam, rows[:, :, 0].contiguous(), rows[:, :, -1].contiguous()


def _leaf_eigen(a: torch.Tensor, b: torch.Tensor, *, bisect_iters: int,
                inv_iters: int, backend: str = "auto"):
    """(lam, f, l) (P, lm) of the P leaves (diag a (P, lm), off-diag b
    (P, lm-1)): the bracket and start vectors in torch, the rest through
    ``ops.dc_leaf``."""
    from repro_torch.kernels import ops
    lo0, hi0, ctol = _leaf_bracket(a, b)
    x0 = leaf_start(a.shape[-1], a.dtype, a.device)
    return ops.dc_leaf(a.contiguous(), b.contiguous(), lo0, hi0, ctol, x0,
                       bisect_iters=bisect_iters, inv_iters=inv_iters,
                       backend=backend)


# ---------------------------------------------------------------------------
# Merge: deflation, the secular roots, Gu's weights and the f/l rows
# ---------------------------------------------------------------------------

def deflate_plain(d: torch.Tensor, z: torch.Tensor, fe: torch.Tensor,
                  le: torch.Tensor, active: torch.Tensor, tol: torch.Tensor):
    """Plain version of the kernel ``dc_deflate_cuda``: the Givens scan of
    near-equal active poles over the columns of each of P subproblems
    (each input (P, m), ``tol`` (P,)); returns new (d, z, fe, le, active).

    Walking the columns in order, a carried pole c and the next pole i,
    both active, whose rotated off-diagonal |cg*sg*(d_i - d_c)| is within
    tol, merge: the rotation zeroes c's weight, hands c out deflated at
    cg^2 d_c + sg^2 d_i and carries i on at sg^2 d_c + cg^2 d_i with
    weight r = |(z_c, z_i)|; f and l rotate with them."""
    cols = [x.unbind(-1) for x in (d, z, fe, le, active)]
    out = [[None] * d.shape[-1] for _ in range(5)]
    d_c, z_c, f_c, l_c, a_c = (c[0] for c in cols)
    for i in range(1, d.shape[-1]):
        d_i, z_i, f_i, l_i, a_i = (c[i] for c in cols)
        r = torch.sqrt(z_c * z_c + z_i * z_i)
        pos = r > 0
        r_safe = torch.where(pos, r, 1)
        cg = torch.where(pos, z_i / r_safe, 1)
        sg = torch.where(pos, z_c / r_safe, 0)
        off = (cg * sg * (d_i - d_c)).abs()
        mrg = a_c & a_i & (off <= tol)
        cc, ss = cg * cg, sg * sg
        emit = (torch.where(mrg, cc * d_c + ss * d_i, d_c),
                torch.where(mrg, 0, z_c),
                torch.where(mrg, cg * f_c - sg * f_i, f_c),
                torch.where(mrg, cg * l_c - sg * l_i, l_c),
                a_c & ~mrg)
        for k in range(5):
            out[k][i - 1] = emit[k]
        d_c = torch.where(mrg, ss * d_c + cc * d_i, d_i)
        z_c = torch.where(mrg, r, z_i)
        f_c = torch.where(mrg, sg * f_c + cg * f_i, f_i)
        l_c = torch.where(mrg, sg * l_c + cg * l_i, l_i)
        a_c = a_i
    for k, last in enumerate((d_c, z_c, f_c, l_c, a_c)):
        out[k][-1] = last
    return tuple(torch.stack(o, -1) for o in out)


def _blocks(n: int):
    """[start, stop) blocks of at most ``_SECULAR_CHUNK`` covering n."""
    return [(s, min(s + _SECULAR_CHUNK, n))
            for s in range(0, n, _SECULAR_CHUNK)]


def _secular_block(d, w, gap, act, d_next, a_next, hidx, j0, j1, nact,
                   newton_iters):
    """(anc, tau) of the roots j0..j1-1 of every row: the reference's
    ``active_block`` (midpoint pass, windowed middle-way iteration against
    the frozen far field, exact polish), its pole sums over the active
    prefix [0, nact)."""
    acc = d.dtype
    eps = torch.finfo(acc).eps
    m = d.shape[-1]
    dev = d.device
    jidx = torch.arange(j0, j1, device=dev)
    dj, gapj, actj = d[:, j0:j1], gap[:, j0:j1], act[:, j0:j1]
    dnx, nxtj = d_next[:, j0:j1], a_next[:, j0:j1]
    gap_safe = torch.where(actj & (gapj > 0), gapj, 1)
    half = 0.5 * gap_safe
    poles = [(s, e, (torch.arange(s, e, device=dev)[:, None]
                     <= jidx[None, :])) for s, e in _blocks(nact)]

    def full_sums(anc_, t):
        # one-sided sums at mu = anc + t: psi (poles i <= j), phi (i > j)
        # and their derivatives, kept apart (see the reference)
        psi = psip = phip = tot = 0
        for s, e, left in poles:
            wc = w[:, s:e, None]
            denom = (d[:, s:e, None] - anc_[:, None, :]) - t[:, None, :]
            safe = torch.where(wc == 0, 1, denom)
            r = wc / safe
            r2 = r / safe
            tot = tot + r.sum(1)
            psi = psi + torch.where(left, r, 0).sum(1)
            psip = psip + torch.where(left, r2, 0).sum(1)
            phip = phip + torch.where(left, 0, r2).sum(1)
        return psi, tot - psi, psip, phip

    # the index-nearest window (slots outside [0, m) weigh nothing) and the
    # heaviest poles, zeroed where they repeat a window slot
    kwin = min(DC_WINDOW_K, m)
    base = jidx[:, None] - (kwin // 2) + torch.arange(kwin, device=dev)
    gidx = base.clamp(0, m - 1)
    dw = d[:, gidx]
    ww = torch.where((base >= 0) & (base < m), w[:, gidx], 0)
    leftw = base <= jidx[:, None]
    wt = w.gather(1, hidx)
    dh = d.gather(1, hidx)
    hcol = hidx[:, None, :]
    bmin = (jidx - (kwin // 2))[None, :, None]
    wh = torch.where((hcol >= bmin) & (hcol < bmin + kwin), 0,
                     wt[:, None, :])
    lefth = hcol <= jidx[None, :, None]

    def win_sums(delta, wwc, leftc, t):
        denomw = delta - t[..., None]
        safew = torch.where(wwc == 0, 1, denomw)
        rw = wwc / safew
        rw2 = rw / safew
        totw = rw.sum(-1)
        psiw = torch.where(leftc, rw, 0).sum(-1)
        psipw = torch.where(leftc, rw2, 0).sum(-1)
        phipw = torch.where(leftc, 0, rw2).sum(-1)
        return psiw, totw - psiw, psipw, phipw

    def near_sums(dwin, dhvy, t):
        pw, fw, ppw, fpw = win_sums(dwin, ww, leftw, t)
        ph, fh, pph, fph = win_sums(dhvy, wh, lefth, t)
        return pw + ph, fw + fh, ppw + pph, fpw + fph

    def mw_update(f, fscale, psip, phip, t, lo, hi):
        # the reference's middle-way step, bracketed, with the freeze at
        # the rounding floor
        done = f.abs() <= 8 * eps * fscale
        upd = ~done
        lo = torch.where(upd & (f < 0), t, lo)
        hi = torch.where(upd & (f >= 0), t, hi)
        d1 = -off - t
        d2 = (gap_safe - off) - t
        fp = psip + phip
        aq = (d1 + d2) * f - d1 * d2 * fp
        bq = d1 * d2 * f
        cq = f - d1 * psip - d2 * phip
        disc = torch.sqrt(torch.clamp(aq * aq - 4 * bq * cq, min=0))
        eta_pos = 2 * bq / (aq + disc)
        eta_neg = (aq - disc) / (2 * torch.where(cq == 0, 1, cq))
        eta = torch.where(aq > 0, eta_pos,
                          torch.where(cq == 0,
                                      bq / torch.where(aq == 0, 1, aq),
                                      eta_neg))
        cand = t + eta
        inside = (cand > lo) & (cand < hi)
        t_new = torch.where(inside, cand, 0.5 * (lo + hi))
        return torch.where(done, t, t_new), lo, hi

    # the midpoint pass: the anchor, and the far field's value and slope
    psi0, phi0, psip0, phip0 = full_sums(dj, half)
    f0 = 1 + psi0 + phi0
    psiw0, phiw0, psipw0, phipw0 = near_sums(
        dw - dj[..., None], dh[:, None, :] - dj[..., None], half)
    psi_f = torch.clamp(psi0 - psiw0, max=0)
    phi_f = torch.clamp(phi0 - phiw0, min=0)
    psip_f = torch.clamp(psip0 - psipw0, min=0)
    phip_f = torch.clamp(phip0 - phipw0, min=0)

    upper = (f0 < 0) & nxtj
    anc = torch.where(upper, dnx, dj)
    off = torch.where(upper, gap_safe, 0)
    lo0 = torch.where(upper, -half, torch.where(f0 < 0, half, 0))
    hi0 = torch.where(upper, 0, torch.where(f0 < 0, gap_safe, half))
    deltaw = dw - anc[..., None]
    deltah = dh[:, None, :] - anc[..., None]

    t0 = 0.5 * (lo0 + hi0)
    t, lo, hi = t0, lo0, hi0
    for _ in range(newton_iters):
        s = (off - half) + t
        psiw, phiw, psipw, phipw = near_sums(deltaw, deltah, t)
        psi_m = psi_f + psip_f * s + psiw
        phi_m = phi_f + phip_f * s + phiw
        f = 1 + psi_m + phi_m
        fscale = 1 + phi_m.abs() + psi_m.abs()
        t, lo, hi = mw_update(f, fscale, psip_f + psipw, phip_f + phipw,
                              t, lo, hi)
    # the windowed bracket moved on the model's signs: polish from the
    # original one
    t = torch.where((t > lo0) & (t < hi0), t, t0)
    lo, hi = lo0, hi0
    # a root frozen at its rounding floor gets the same sums and stays
    # frozen in every later pass; every _POLISH_CHECK passes one host read
    # asks whether an active root of the block still moved, and the loop
    # stops when none did: the same result as every pass, as the
    # reference's early exit and the kernel's per-warp exit give
    for it in range(DC_POLISH_ITERS):
        psi, phi, psip, phip = full_sums(anc, t)
        f, fscale = 1 + psi + phi, 1 + phi - psi
        t, lo, hi = mw_update(f, fscale, psip, phip, t, lo, hi)
        if (it + 1) % _POLISH_CHECK == 0 and not bool(
                (actj & ~(f.abs() <= 8 * eps * fscale)).any()):
            break
    return torch.where(actj, anc, dj), torch.where(actj, t, 0)


def secular_plain(d: torch.Tensor, w: torch.Tensor, gap: torch.Tensor,
                  act: torch.Tensor, d_next: torch.Tensor,
                  a_next: torch.Tensor, hidx: torch.Tensor, *, nact: int,
                  newton_iters: int):
    """Plain version of the kernel ``dc_secular_cuda``: the roots of
    ``1 + sum_i w_i / (d_i - mu) = 0`` of the first ``nact`` poles of each
    of P rows (each input (P, m); the active poles of a row are a prefix of
    at most nact), as (anc, tau) (P, nact) with mu_j = anc_j + tau_j,
    anchored at the nearer pole of (d_j, d_j + gap_j); a root that is not
    active returns (d_j, 0).  ``hidx`` (P, kh) are the heaviest poles
    (``torch.topk`` of w over the prefix, kh = min(32, nact))."""
    parts = [_secular_block(d, w, gap, act, d_next, a_next, hidx, j0, j1,
                            nact, newton_iters)
             for j0, j1 in _blocks(nact)]
    return (torch.cat([p[0] for p in parts], -1),
            torch.cat([p[1] for p in parts], -1))


def _row_blocks(p: int, nact: int, dtype):
    """[start, stop) blocks over the target axis of an O(nact^2) pass of
    the merge: the most rows for which one (p, rows, nact) temporary of
    ``dtype`` fits ``DC_MERGE_BLOCK_BYTES`` (read at call time), at least
    one."""
    per_row = p * nact * dtype.itemsize
    rows = max(1, min(nact, DC_MERGE_BLOCK_BYTES // max(per_row, 1)))
    return [(s, min(s + rows, nact)) for s in range(0, nact, rows)]


def _loewner_log(d, t, anc, tau, nact):
    """sum_j log((mu_j - d_i) / (d_j - d_i)) over the roots j of the
    prefix with d_j != d_i, for each target i of the prefix, (P, nact);
    t = mu - d, anc and tau are the roots' (P, nact).  log1p of t_j / (d_j
    - d_i) where that is small, else the log of the anchored ratio.  One
    sum over the whole prefix of roots j; the targets i in blocks.  A root
    j that is not active has t_j = 0 and adds log1p(0) = 0, so only equal
    poles are masked; a target i that is not active gets a sum the caller
    drops."""
    tiny = torch.finfo(d.dtype).tiny
    dj, tj = d[:, :nact, None], t[:, :, None]
    ancj, tauj = anc[:, :, None], tau[:, :, None]
    out = []
    for i0, i1 in _row_blocks(d.shape[0], nact, d.dtype):
        di = d[:, None, i0:i1]
        delta = dj - di
        apart = delta != 0
        safe = torch.where(apart, delta, 1)
        x = tj / safe
        ratio = ((ancj - di) + tauj) / safe
        logr = torch.where(x.abs() < 0.5,
                           torch.log1p(torch.clamp(x, min=-0.75)),
                           torch.log(torch.clamp(ratio, min=tiny)))
        out.append(torch.where(apart, logr, 0).sum(1))
    return out[0] if len(out) == 1 else torch.cat(out, -1)


def _fl_rows(d, zhat, rows, anc, tau, nact):
    """The parent's first and last eigenvector rows at the roots of the
    prefix, (P, 2, nact): sum_i x_i w_ij / ||w_j||, w_ij = zhat_i /
    (d_i - mu_j), for x the children's f and l rows (``rows``, (2, P, m)),
    zhat, anc and tau (P, nact).  One sum over the whole prefix of poles i;
    the roots j in blocks.  (Elementwise products and sums, not a matrix
    product: fp32 stays fp32 whatever TF32 setting the caller has.)  Where
    root j is not active the value is not a row, and the caller drops
    it."""
    tiny = torch.finfo(d.dtype).tiny
    di, zc = d[:, :nact, None], zhat[:, :, None]
    zero = zc == 0
    fi, li = rows[0, :, :nact, None], rows[1, :, :nact, None]
    out = []
    for j0, j1 in _row_blocks(d.shape[0], nact, d.dtype):
        denom = (di - anc[:, None, j0:j1]) - tau[:, None, j0:j1]
        bad = zero | (denom == 0)
        wv = torch.where(bad, 0, zc / torch.where(bad, 1, denom))
        nrm = torch.sqrt(torch.clamp((wv * wv).sum(1), min=tiny))
        out.append(torch.stack([(fi * wv).sum(1), (li * wv).sum(1)], 1)
                   / nrm[:, None, :])
    return out[0] if len(out) == 1 else torch.cat(out, -1)


def _partition(active, cols):
    """Active columns first, each group in its order (a stable sort), of
    the stacked columns ``cols`` (k, P, m) and of ``active`` (P, m)."""
    part = torch.argsort(active.view(torch.uint8), dim=-1, descending=True,
                         stable=True)
    return cols.gather(-1, part.expand_as(cols)), active.gather(-1, part)


def _merge_pair(d1, f1, l1, d2, f2, l2, rho_b, *, newton_iters: int,
                need_rows: bool = True, backend: str = "auto"):
    """One merge level: the children (ascending spectra and first/last
    eigenvector rows, (P, h) each) to the parent's triple (P, 2h); rho_b
    (P,) is the signed coupling.  ``need_rows=False`` (the top level)
    skips the Loewner product and the f/l rows and returns zero rows.
    The columns (d, z, fe, le) travel stacked, (4, P, 2h), so that each
    sort or partition moves them in one gather."""
    from repro_torch.kernels import ops
    acc = d1.dtype
    eps = torch.finfo(acc).eps
    tiny = torch.finfo(acc).tiny
    p, h = d1.shape
    rho = rho_b.abs()[:, None]
    sgn = torch.where(rho_b < 0, -1.0, 1.0).to(acc)[:, None]
    zero = torch.zeros_like(f2)
    # (d, z, fe, le) = ([d1 d2], [l1 sgn*f2], [f1 0], [0 l2]), by d
    cols = torch.stack([d1, l1, f1, zero, d2, sgn * f2, zero, l2]).view(
        2, 4, p, h).permute(1, 2, 0, 3).reshape(4, p, 2 * h)
    order = torch.argsort(cols[0], dim=-1, stable=True)
    cols = cols.gather(-1, order.expand_as(cols))
    d, z = cols[0], cols[1]

    norm_scale = d.abs().amax(-1, keepdim=True) + 2 * rho
    tol = torch.clamp(8 * eps * norm_scale, min=tiny * 16)

    # deflation 1: negligible weight; then the Givens scan of near-equal
    # poles, and the actives made a contiguous prefix again (the kernel
    # scans in place, the plain version returns new columns)
    active = rho * z.abs() > tol
    cols, active = _partition(active, cols)
    out = ops.dc_deflate(*cols, active, tol[:, 0], backend=backend)
    if any(o.data_ptr() != c.data_ptr() for o, c in zip(out, cols)):
        cols = torch.stack(out[:4])
    cols, active = _partition(out[4], cols)
    d, z = cols[0], cols[1]

    # the secular roots of the active prefix: its length read once.
    # d_next's last column is read nowhere (a_next is False there), so
    # a roll stands in for a padded shift
    w = torch.where(active, rho * z * z, 0)
    sum_w = w.sum(-1, keepdim=True)
    d_next = torch.roll(d, -1, -1)
    a_next = torch.nn.functional.pad(active[:, 1:], (0, 1))
    gap = torch.where(a_next, d_next - d,
                      sum_w * (1 + 4 * eps) + 4 * eps * norm_scale)
    nact = int(active.sum(-1).amax()) if active.numel() else 0
    # the roots mu_j = anc_j + tau_j of the prefix; mu = d elsewhere
    mu = d.clone()
    if nact:
        hidx = torch.topk(w[:, :nact], min(DC_HEAVY_K, nact), dim=-1)[1]
        anc, tau = ops.dc_secular(
            d, w, gap, active, d_next, a_next, hidx, nact=nact,
            newton_iters=newton_iters, backend=backend)
        act = active[:, :nact]
        torch.where(act, anc + tau, d[:, :nact], out=mu[:, :nact])
    order2 = torch.argsort(mu, dim=-1, stable=True)
    if not need_rows:
        mu = mu.gather(-1, order2)
        return mu, torch.zeros_like(mu), torch.zeros_like(mu)

    # Gu's weights from the roots, then the parent's rows in place of the
    # children's at the active roots
    if nact:
        t = torch.where(act, (anc - d[:, :nact]) + tau, 0)
        rho_safe = torch.where(rho > 0, rho, 1)
        logprod = _loewner_log(d, t, anc, tau, nact)
        zhat2 = torch.where(act, t / rho_safe * torch.exp(logprod), 0)
        # the sign of z (never 0 at an active pole; 0 rows elsewhere)
        zhat = torch.copysign(torch.sqrt(zhat2), z[:, :nact])
        rows = _fl_rows(d, zhat, cols[2:], anc, tau, nact)
        torch.where(act, rows.transpose(0, 1), cols[2:, :, :nact],
                    out=cols[2:, :, :nact])
    cols[1].copy_(mu)
    res = cols[1:].gather(-1, order2.expand(3, -1, -1))
    return res[0], res[1], res[2]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _check_leaf_n(leaf_n: int) -> None:
    if leaf_n < 2:
        raise ValueError(f"leaf_n must be >= 2, got {leaf_n}")


def bidiag_dc_singular_values(d: torch.Tensor, e: torch.Tensor, *,
                              leaf_n: int = DEFAULT_DC_LEAF_N,
                              newton_iters: int = 30, inv_iters: int = 2,
                              backend: str = "auto") -> torch.Tensor:
    """All singular values of the bidiagonals (d, e) (..., n), descending,
    by divide and conquer: the contract of ``bidiag_singular_values``
    (e[..., 0] unused).  n <= ``leaf_n`` is that function's result, bit
    for bit.  ``backend`` picks the leaf, deflation and secular kernels
    ("auto": the kernels on a CUDA tensor, their plain versions on the
    CPU)."""
    _check_leaf_n(leaf_n)
    lead = d.shape[:-1]
    n = d.shape[-1]
    if n <= leaf_n:
        return bidiag_singular_values(d, e, backend=backend)
    dt = d.dtype
    acc = acc_dtype(dt)
    z = gk_offdiag(d.to(acc), e.to(acc)).reshape(-1, 2 * n - 1)
    sc = _gk_prescale(z)
    z = z / sc[:, None]
    nb = z.shape[0]

    m = 2 * n
    lm = 2 * leaf_n
    levels = max(0, math.ceil(math.log2(m / lm)))
    big = lm << levels
    a = z.new_zeros((nb, big))
    b = z.new_zeros((nb, big - 1))
    b[:, :m - 1] = z
    if big > m:
        # decoupled sentinel poles below the spectrum: zero weight at every
        # merge, so they deflate and sort to the bottom
        bound = z.abs().amax(-1, keepdim=True) * 2 + 1
        a[:, m:] = -(bound + torch.arange(big - m, dtype=acc,
                                          device=z.device) + 1)
    # the rank-one term of each merge takes |b_i| off both entries it
    # touches, at every interior leaf boundary i
    idx = torch.arange(big - 1, device=z.device)
    corr = torch.where((idx + 1) % lm == 0, b.abs(), 0)
    a = a - torch.nn.functional.pad(corr, (0, 1))
    a = a - torch.nn.functional.pad(corr, (1, 0))

    nleaf = big // lm
    a_leaf = a.reshape(nb * nleaf, lm)
    b_leaf = torch.nn.functional.pad(b, (0, 1)).reshape(
        nb * nleaf, lm)[:, :lm - 1]
    lam, f, el = _leaf_eigen(a_leaf, b_leaf,
                             bisect_iters=default_bisect_iters(acc),
                             inv_iters=inv_iters, backend=backend)
    for lev in range(levels):
        sz = lm << lev
        npair = big // (2 * sz)
        # the couplings at (2k + 1) sz - 1, k < npair
        rho_b = b[:, sz - 1::2 * sz].reshape(-1)
        lam2, f2, l2 = (x.reshape(nb * npair, 2, sz) for x in (lam, f, el))
        lam, f, el = _merge_pair(
            lam2[:, 0], f2[:, 0], l2[:, 0], lam2[:, 1], f2[:, 1], l2[:, 1],
            rho_b, newton_iters=newton_iters, need_rows=lev + 1 < levels,
            backend=backend)
    lam = lam.reshape(nb, big)
    sig = lam[:, big - n:].flip(-1).abs()            # top n, descending
    return (sig * sc[:, None]).to(dt).reshape(lead + (n,))


def bidiag_dc_svd(d: torch.Tensor, e: torch.Tensor, *,
                  leaf_n: int = DEFAULT_DC_LEAF_N, newton_iters: int = 30,
                  inv_iters: int = 2, backend: str = "auto"):
    """Full SVD of the bidiagonals (d, e) (..., n) with divide-and-conquer
    values: (U, sigma, V^T), the contract of ``bidiag_svd``.  The vectors
    come from the same inverse iteration as the bisection path's
    (``_vectors_from_sigma``); n <= ``leaf_n`` is ``bidiag_svd``."""
    _check_leaf_n(leaf_n)
    lead = d.shape[:-1]
    n = d.shape[-1]
    if n <= leaf_n:
        return bidiag_svd(d, e, inv_iters=inv_iters, backend=backend)
    sig = bidiag_dc_singular_values(d, e, leaf_n=leaf_n,
                                    newton_iters=newton_iters,
                                    inv_iters=inv_iters, backend=backend)
    u, vt = _vectors_from_sigma(d.reshape(-1, n), e.reshape(-1, n),
                                sig.reshape(-1, n), inv_iters=inv_iters)
    return (u.reshape(lead + (n, n)), sig, vt.reshape(lead + (n, n)))
