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

Singular vectors (``bidiag_svd``, ``bidiag_vectors``) come from inverse
iteration on the Golub–Kahan tridiagonal at each sigma, then cluster
reorthogonalization and left/right re-pairing, as in the reference.  They
are plain torch, batched over all (matrix, sigma) pairs: the recurrences
are loops of 2n dependent steps, and the reorthogonalization a loop over
the n values.
"""

from __future__ import annotations

import torch

from repro_torch.core.householder import acc_dtype

__all__ = ["default_bisect_iters", "gk_offdiag", "sturm_count",
           "bisect_plain", "gk_problem", "bidiag_singular_values",
           "bidiag_singular_values_plain", "bidiag_vectors", "bidiag_svd"]


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


# ---------------------------------------------------------------------------
# Singular vectors: inverse iteration on the Golub–Kahan tridiagonal
# ---------------------------------------------------------------------------

def _tridiag_solve(z: torch.Tensor, lam: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Solve ``(T - lam I) x = b`` for every shift at once: T the
    zero-diagonal tridiagonal with off-diagonal ``z`` (B, m-1), ``lam``
    (B, n) shifts, ``b`` (B, n, m) right-hand sides; returns x (B, n, m).

    Thomas elimination with pivots guarded away from zero: near-singular
    shifts are the point of inverse iteration (the guarded solve just
    scales the eigen-direction up)."""
    m = z.shape[-1] + 1
    eps = torch.finfo(z.dtype).eps
    tiny = (eps * z.abs().amax(-1).clamp(min=1))[:, None]        # (B, 1)

    def guard(p):
        return torch.where(p.abs() < tiny, torch.where(p < 0, -tiny, tiny), p)

    ys = b.new_empty((m,) + lam.shape)
    cs = b.new_empty((m - 1,) + lam.shape)
    piv = guard(-lam)
    y = b[..., 0] / piv
    ys[0] = y
    for i in range(1, m):
        z_im1 = z[:, i - 1, None]
        c = z_im1 / piv                         # elimination multiplier
        piv = guard(-lam - z_im1 * c)
        y = (b[..., i] - z_im1 * y) / piv
        ys[i] = y
        cs[i - 1] = c
    xs = torch.empty_like(ys)
    x = ys[m - 1]
    xs[m - 1] = x
    for i in range(m - 2, -1, -1):
        x = ys[i] - cs[i] * x
        xs[i] = x
    return xs.permute(1, 2, 0)


def _orthonormalize_pairs(us: torch.Tensor, vs: torch.Tensor,
                          sig: torch.Tensor, dd: torch.Tensor,
                          ee: torch.Tensor):
    """Cluster reorthogonalization and left/right re-pairing (cf. LAPACK
    stein), batched over B bidiagonals; rows of us / vs (B, n, n) are the
    vectors, sig (B, n) descending.

    In order of k: v_k minus its projections on the earlier v_j whose sigma
    lies in its cluster (width 1e-3 relative), renormalized; then
    ``u_k = B v_k / ||B v_k||``, exact for a true right vector and sign-
    aligned (u^T B v > 0).  For sigma ~ 0 that identity degenerates, so the
    zero cluster orthogonalizes the u's directly.  The reference masks a
    dense projection onto all earlier rows; here it runs over the rows from
    the cluster's first member to k - 1 only (the rows the mask keeps, and
    no projection at all for a lone value), which subtracts the same
    terms.

    ``B v_k / ||B v_k||`` carries v_k's rounding times sigma_1 / sigma_k,
    so each u_k then loses its projections on all earlier u's (one pass,
    renormalized), which the reference does not do: without it a small
    sigma above the zero cluster costs U its orthogonality
    (``chip_smoke.py`` read max|U^T U - I| = 5.5e-11 over 64 random fp64
    matrices of n = 64)."""
    acc = vs.dtype
    B, n = sig.shape
    eps = torch.finfo(acc).eps
    tiny = torch.finfo(acc).tiny
    scale = sig[:, 0].clamp(min=1)
    ctol = (1e-3 * scale)[:, None]            # cluster width (relative)
    stol = torch.sqrt(torch.tensor(eps, dtype=acc)) * scale  # zero cluster
    in_cluster = (sig[:, :, None] - sig[:, None, :]) < ctol[..., None]
    # first j (<= k) whose sigma lies in k's cluster, over the batch
    starts = in_cluster.int().argmax(1).amin(0).tolist()
    eye = torch.eye(n, dtype=acc, device=sig.device)

    def mgs(k, rows, vec):
        """vec minus its projections on the earlier same-cluster rows,
        renormalized; an orthogonalized one-hot when it collapses."""
        j0 = starts[k]
        if j0 >= k:
            w1, w2 = vec, eye[k].expand_as(vec)
        else:
            blk = rows[:, j0:k]                                   # (B, r, n)
            mask = in_cluster[:, j0:k, k].to(acc)                 # (B, r)

            def clean(w):
                proj = mask * (blk @ w[..., None])[..., 0]
                return w - (proj[:, None, :] @ blk)[:, 0]

            w1, w2 = clean(vec), clean(eye[k].expand_as(vec))
        n1 = torch.linalg.vector_norm(w1, dim=-1, keepdim=True)
        n2 = torch.linalg.vector_norm(w2, dim=-1, keepdim=True)
        return torch.where(n1 > 0.01, w1 / n1.clamp(min=tiny),
                           w2 / n2.clamp(min=tiny))

    for k in range(n):
        v = mgs(k, vs, vs[:, k])
        bv = dd * v + torch.nn.functional.pad(ee[:, 1:] * v[:, 1:], (0, 1))
        nbv = torch.linalg.vector_norm(bv, dim=-1, keepdim=True)
        u_zero = mgs(k, us, us[:, k])
        u = torch.where((sig[:, k] > stol)[:, None],
                        bv / nbv.clamp(min=tiny), u_zero)
        if k:
            prev = us[:, :k]                                      # (B, k, n)
            u = u - ((prev @ u[..., None])[..., 0][:, None, :] @ prev)[:, 0]
            u = u / torch.linalg.vector_norm(u, dim=-1,
                                             keepdim=True).clamp(min=tiny)
        us[:, k] = u
        vs[:, k] = v
    return us, vs


def _vectors_from_sigma(d: torch.Tensor, e: torch.Tensor, sig: torch.Tensor,
                        *, inv_iters: int = 2):
    """(U, V^T) of the bidiagonals (d, e) (B, n), n >= 2, given their
    singular values ``sig`` (B, n), descending: ``inv_iters`` rounds of
    inverse iteration on the Golub–Kahan tridiagonal at each sigma, whose
    eigenvector interleaves (v, u), then :func:`_orthonormalize_pairs`."""
    B, n = d.shape
    dt = d.dtype
    acc = acc_dtype(dt)
    z = gk_offdiag(d.to(acc), e.to(acc))
    sc = _gk_prescale(z)
    z = z / sc[:, None]
    m = 2 * n
    dd = d.to(acc)
    ee = e.to(acc)
    # deterministic, k-dependent start: decorrelates degenerate clusters
    t = torch.arange(1, m + 1, dtype=acc, device=d.device)
    kk = torch.arange(n, dtype=acc, device=d.device)
    b0 = torch.sin(t * (kk[:, None] + 1) * 0.7) + 0.01                # (n, m)
    x = (b0 / torch.linalg.vector_norm(b0, dim=-1, keepdim=True)).expand(
        B, n, m)
    lam = sig.to(acc) / sc[:, None]
    tiny = torch.finfo(acc).tiny
    for _ in range(inv_iters):
        x = _tridiag_solve(z, lam, x)
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
            min=tiny)
    v = x[..., 0::2]
    u = x[..., 1::2]
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    nu = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    ok = torch.minimum(nv, nu) > 1e-6
    onehot = torch.eye(n, dtype=acc, device=d.device)
    one = torch.ones((), dtype=acc, device=d.device)
    v = torch.where(ok, v / torch.where(ok, nv, one), onehot)
    u = torch.where(ok, u / torch.where(ok, nu, one), onehot)
    us, vs = _orthonormalize_pairs(u.contiguous(), v.contiguous(),
                                   sig.to(acc), dd, ee)
    return us.transpose(-1, -2).to(dt), vs.to(dt)


def bidiag_vectors(d: torch.Tensor, e: torch.Tensor, sig: torch.Tensor, *,
                   inv_iters: int = 2):
    """(U, V^T), each (..., n, n), of the bidiagonals (d, e) (..., n) given
    their singular values ``sig`` (..., n), descending."""
    lead = d.shape[:-1]
    n = d.shape[-1]
    if n == 1:
        # 1x1: d = u * sigma * v with u = 1, v = sign(d)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        sgn = torch.where(d < 0, -one, one)
        return torch.ones(lead + (1, 1), dtype=d.dtype,
                          device=d.device), sgn[..., None]
    u, vt = _vectors_from_sigma(d.reshape(-1, n), e.reshape(-1, n),
                                sig.reshape(-1, n), inv_iters=inv_iters)
    return u.reshape(lead + (n, n)), vt.reshape(lead + (n, n))


def bidiag_svd(d: torch.Tensor, e: torch.Tensor, *,
               max_iter: int | None = None, inv_iters: int = 2,
               backend: str = "auto"):
    """Full SVD of the upper bidiagonals (d, e) (..., n): (U, sigma, V^T).

    sigma comes from the same :func:`bidiag_singular_values` call as the
    values path, so it is bit-identical to it; the vectors come from
    :func:`bidiag_vectors`."""
    sig = bidiag_singular_values(d, e, max_iter=max_iter, backend=backend)
    u, vt = bidiag_vectors(d, e, sig, inv_iters=inv_iters)
    return u, sig, vt
