"""Plain PyTorch versions of the chase kernels (``csrc/chase.cu``), of the
compact-WY apply (``csrc/hh_apply.cu``), of the fused small-n SVD
(``csrc/fused_small.cu``) and of causal flash attention
(``csrc/flash_attn.cu``, ``csrc/flash_attn_wgmma.cu``).

They run on any device.  The CPU tests hold them against the reference's
``kernels/ref.py``, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.

A *rolled dense window* of one chase cycle (paper Alg. 2) is

    window[y, w] = A[p - b_in - tw + y, p + w],
    H = b_in + 2*tw + 1,  W = b_in + tw + 1,

and a cycle is (1) a right reflector that annihilates the row bulge in
columns ``[0, tw]`` of row ``tw`` (row ``2*tw`` on a sweep's first cycle),
applied to rows ``[tw, H)``; then (2) a left reflector that annihilates the
column bulge of column 0, rows ``[H-1-tw, H)``, applied across all W
columns.  Only those two panels change, and every cell of them has
``y >= w``: it lies inside the band storage.

Half types accumulate in float32 and are rounded to their storage type
after each of the two updates, as the reference kernel does.
"""

from __future__ import annotations

import torch

from repro_torch.core.bidiag_svd import bidiag_singular_values
from repro_torch.core.householder import acc_dtype, make_reflector

__all__ = ["chase_cycle_ref", "chase_superstep_ref", "chase_cycle_band_ref",
           "chase_superstep_band_ref", "BandStageRef", "tape_apply_ref",
           "hh_block_apply_ref", "effective_bw", "fused_walk", "fused_lines",
           "fused_reduce_band", "fused_small_svd_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "gqa_group"]


def _chase_window(win: torch.Tensor, first: torch.Tensor, *, b_in: int,
                  tw: int):
    """One chase cycle on each of G windows (G, H, W); returns a new tensor
    and the reflector pairs ``(v, tau), (v2, tau2)`` in the accumulation
    type."""
    g, h, w = win.shape
    assert h == b_in + 2 * tw + 1 and w == b_in + tw + 1, (win.shape, b_in, tw)
    dt = win.dtype
    acc = acc_dtype(dt)
    ln = tw + 1
    gi = torch.arange(g, device=win.device)
    out = win.clone()

    # right reflector on the pivot row, applied to rows [tw, H), cols [0, tw]
    yr = torch.where(first, 2 * tw, tw)
    v, tau, beta = make_reflector(out[gi, yr, :ln])
    blk = out[:, tw:, :ln].to(acc)
    wdot = (blk @ v[:, :, None])[..., 0]
    blk = blk - tau[:, None, None] * (wdot[:, :, None] * v[:, None, :])
    fix = torch.zeros((g, ln), dtype=acc, device=win.device)
    fix[:, 0] = beta
    r = yr - tw
    blk[gi, r] = torch.where((tau != 0)[:, None], fix, blk[gi, r])
    out[:, tw:, :ln] = blk.to(dt)

    # left reflector on column 0, rows [H-1-tw, H), applied across W columns
    y0 = h - 1 - tw
    blk2 = out[:, y0:, :].to(acc)
    v2, tau2, beta2 = make_reflector(blk2[:, :, 0])
    w2 = (v2[:, None, :] @ blk2)[:, 0, :]
    blk2 = blk2 - tau2[:, None, None] * (v2[:, :, None] * w2[:, None, :])
    colfix = torch.zeros((g, ln), dtype=acc, device=win.device)
    colfix[:, 0] = beta2
    blk2[:, :, 0] = torch.where((tau2 != 0)[:, None], colfix, blk2[:, :, 0])
    out[:, y0:, :] = blk2.to(dt)
    return out, (v, tau), (v2, tau2)


def _tape(pair1, pair2, dt):
    (v, tau), (v2, tau2) = pair1, pair2
    return (torch.stack([v, v2], 1).to(dt), torch.stack([tau, tau2], 1).to(dt))


def chase_cycle_ref(windows: torch.Tensor, is_first: torch.Tensor, *,
                    b_in: int, tw: int, with_tape: bool = False):
    """One chase cycle on each of G disjoint windows (G, H, W).

    Returns the updated windows (a new tensor); with ``with_tape`` also the
    reflector tape ``vs (G, 2, tw+1)``, ``taus (G, 2)`` (right reflector
    first, then left)."""
    out, p1, p2 = _chase_window(windows, is_first.bool(), b_in=b_in, tw=tw)
    if with_tape:
        return (out,) + _tape(p1, p2, windows.dtype)
    return out


def chase_superstep_ref(blocks: torch.Tensor, is_first: torch.Tensor,
                        active: torch.Tensor, *, b_in: int, tw: int,
                        fuse: int, with_tape: bool = False):
    """K = ``fuse`` consecutive cycles of one sweep on each of G contiguous
    band blocks (G, H, K*b_in + tw + 1).

    Cycle i's window cell (y, w) is ``block[H-1-(y-w), i*b_in + w]``; the
    cycles run in order on the block itself, so each reads what the one
    before it wrote.  ``is_first`` applies to cycle 0; ``active[g, i]``
    gates cycle i (an inactive cycle leaves the block as it was, but its
    reflector pair is still recorded).  Returns a new tensor; with
    ``with_tape`` also ``vs (G, K, 2, tw+1)``, ``taus (G, K, 2)``."""
    g, h, wk = blocks.shape
    assert h == b_in + 2 * tw + 1 and wk == fuse * b_in + tw + 1, (
        blocks.shape, b_in, tw, fuse)
    w = b_in + tw + 1
    dev = blocks.device
    yy = torch.arange(h, device=dev)[:, None]
    ww = torch.arange(w, device=dev)[None, :]
    rows = (h - 1 - (yy - ww)).clamp(0, h - 1)        # band row of window cell
    valid = yy >= ww                                  # the cell is stored
    vy, vw = valid.nonzero(as_tuple=True)
    zero = torch.zeros((), dtype=blocks.dtype, device=dev)
    out = blocks.clone()
    first = is_first.bool()
    active = active.bool()
    vs, taus = [], []
    for i in range(fuse):
        win = torch.where(valid, out[:, rows, (i * b_in + ww).expand(h, w)],
                          zero)
        new, p1, p2 = _chase_window(win, first & (i == 0), b_in=b_in, tw=tw)
        new = torch.where(active[:, i, None, None], new, win)
        out[:, rows[vy, vw], i * b_in + vw] = new[:, vy, vw]
        v, t = _tape(p1, p2, blocks.dtype)
        vs.append(v)
        taus.append(t)
    if with_tape:
        return out, torch.stack(vs, 1), torch.stack(taus, 1)
    return out


def chase_cycle_band_ref(bandp: torch.Tensor, p_safe: torch.Tensor,
                         first: torch.Tensor, live: torch.Tensor, t: int, *,
                         b_in: int, tw: int, tape=None,
                         cycle=chase_cycle_ref) -> torch.Tensor:
    """Cycle ``t`` of one fuse-1 stage on the padded band (B, H, n_pad), in
    place, as ``chase_cycle_band_cuda`` runs it: each slot's rolled window,
    ``window[y, w] = band[H-1-(y-w), p_safe[t, g] + w]``, is gathered from
    every band, chased by ``cycle`` (``first[t]``), and its stored cells
    (y >= w) are scattered back where ``live[t, g, 0]``; with ``tape``
    (``vs (B, T, G, 1, 2, tw+1)``, ``taus (B, T, G, 1, 2)``) row t of the
    tape is written, tau = 0 where not live.  Returns ``bandp``.
    ``cycle`` is :func:`chase_cycle_ref`, or the windows entry
    ``chase_cycle_cuda`` when the band entry is held to it."""
    b, h, _ = bandp.shape
    g = p_safe.shape[1]
    w = b_in + tw + 1
    dev = bandp.device
    yy = torch.arange(h, device=dev)[:, None]
    ww = torch.arange(w, device=dev)[None, :]
    # window cell (y, w) <- band cell (H-1+w-y, p+w); cells with y < w are
    # not stored, read a clamped neighbour, and are never used
    d_gather = (h - 1 + ww - yy).clamp(0, h - 1)
    vy, vw = (yy >= ww).nonzero(as_tuple=True)
    p = p_safe[t]
    win = bandp[:, d_gather, p[:, None, None] + ww].reshape(b * g, h, w)
    out = cycle(win.clone(), first[t], b_in=b_in, tw=tw,
                with_tape=tape is not None)
    on = live[t][:, 0]
    zero = torch.zeros((), dtype=bandp.dtype, device=dev)
    if tape is not None:
        out, vs, taus = out
        tape[0][:, t] = vs.reshape(tape[0].shape[:1] + tape[0].shape[2:])
        taus = taus.reshape(tape[1].shape[:1] + tape[1].shape[2:])
        tape[1][:, t] = torch.where(on[None, :, None, None], taus, zero)
    out = torch.where(on.repeat(b)[:, None, None], out, win)
    bandp[:, h - 1 + vw - vy, p[:, None] + vw] = out.reshape(b, g, h, w)[
        :, :, vy, vw]
    return bandp


def chase_superstep_band_ref(bandp: torch.Tensor, p_safe: torch.Tensor,
                             first: torch.Tensor, live: torch.Tensor, t: int,
                             *, b_in: int, tw: int, fuse: int, tape=None):
    """Super-cycle ``t`` of one stage on the padded band (B, H, n_pad), in
    place, as ``chase_superstep_band_cuda`` runs it: each slot's block
    ``[p_safe[t, g], + fuse*b_in + tw + 1)`` of every band is gathered,
    chased by :func:`chase_superstep_ref` (``first[t]``, ``live[t]``), and
    scattered back; with ``tape`` (``vs (B, T, G, K, 2, tw+1)``, ``taus (B,
    T, G, K, 2)``) row t of the tape is written, tau = 0 where not live.
    Returns ``bandp``."""
    b, h, _ = bandp.shape
    g = p_safe.shape[1]
    wk = fuse * b_in + tw + 1
    rows = torch.arange(h, device=bandp.device)[:, None]
    cols = p_safe[t][:, None, None] + torch.arange(wk, device=bandp.device)
    blocks = bandp[:, rows, cols]                            # (B,G,H,WK)
    res = chase_superstep_ref(blocks.reshape(b * g, h, wk), first[t],
                              live[t].repeat(b, 1), b_in=b_in, tw=tw,
                              fuse=fuse, with_tape=tape is not None)
    if tape is not None:
        res, vs, taus = res
        tape[0][:, t] = vs.reshape(tape[0].shape[:1] + tape[0].shape[2:])
        taus = taus.reshape(tape[1].shape[:1] + tape[1].shape[2:])
        zero = torch.zeros((), dtype=taus.dtype, device=taus.device)
        tape[1][:, t] = torch.where(live[t][None, :, :, None], taus, zero)
    bandp[:, rows, cols] = res.reshape(b, g, h, wk)
    return bandp


class BandStageRef:
    """The plain version of ``bulge_chase.BandStage``: ``stage(t)`` runs
    (super-)cycle t of the stage through :func:`chase_cycle_band_ref`
    (fuse 1) or :func:`chase_superstep_band_ref`, on any device."""

    def __init__(self, bandp, p_safe, first, live, *, b_in: int, tw: int,
                 fuse: int, tape=None):
        self._args = (bandp, p_safe, first, live)
        self._kw = dict(b_in=b_in, tw=tw, tape=tape)
        if fuse > 1:
            self._kw["fuse"] = fuse
        self._fn = chase_cycle_band_ref if fuse == 1 else \
            chase_superstep_band_ref
        self.cycles = p_safe.shape[0]

    def __call__(self, t: int) -> None:
        self._fn(*self._args, t, **self._kw)

    def __enter__(self) -> "BandStageRef":
        return self

    def __exit__(self, *exc) -> None:
        pass


def tape_apply_ref(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                   rows: torch.Tensor | None = None) -> torch.Tensor:
    """Per slot s, ``C[s] <- C[s] - V[s] (T[s] (V[s]^T C[s]))``.

    v: (S, m, k), t: (S, k, k), c: (S, m, w), any strides; returns a new
    tensor.  The stage-1 panels use k = nb blocks, the chase tape k = 1 (a
    Householder reflector, t = tau).  Half types accumulate in float32.

    With ``rows`` ((spm, m) integer row table) ``c`` is an accumulator
    (S / spm, R, w): slot s gathers rows ``rows[s % spm]`` of matrix
    ``s // spm``, is applied, and is scattered back into ``c``, which is
    updated in place and returned, as the CUDA kernel does."""
    if rows is not None:
        idx = rows.long()
        spm, m = idx.shape
        b, w = c.shape[0], c.shape[-1]
        sl = c[:, idx].reshape(b * spm, m, w)
        c[:, idx] = tape_apply_ref(v, t, sl).reshape(b, spm, m, w)
        return c
    acc = acc_dtype(c.dtype)
    vv, tt, cc = v.to(acc), t.to(acc), c.to(acc)
    w1 = vv.transpose(-1, -2) @ cc
    return (cc - vv @ (tt @ w1)).to(c.dtype)


def hh_block_apply_ref(v: torch.Tensor, t: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """``C <- (I - V T V^T) C`` for v (..., m, k), t (..., k, k),
    c (..., m, w): :func:`tape_apply_ref` with the leading axes as slots
    (one slot for a single problem)."""
    m, k, w = c.shape[-2], v.shape[-1], c.shape[-1]
    return tape_apply_ref(v.reshape(-1, m, k), t.reshape(-1, k, k),
                          c.reshape(-1, m, w)).reshape(c.shape)


# ---------------------------------------------------------------------------
# The fused small-n SVD: the whole per-matrix pipeline (dense -> band(bw),
# one SBR stage bw -> 1, then Sturm bisection).  The reflector bounds are
# Python ints, so each reflector works on its support slice [lo, hi].
# ---------------------------------------------------------------------------

def effective_bw(n: int, bw: int) -> int:
    """Clamp a requested bandwidth to the fused kernel's valid range: 0
    ("pick for me") becomes 1, and more than n - 1 becomes n - 1."""
    return int(max(1, min(int(bw), max(int(n) - 1, 1))))


def fused_walk(n: int, bw: int):
    """The reflectors of the fused reduction of an (n, n) matrix, in order,
    as ``(right, k, lo, hi)``: a right reflector on row k over columns
    [lo, hi], or a left one on column k (= lo) over rows [lo, hi].

    Phase 1 (dense -> upper band bw): for j < n - 1, left on column j, rows
    [j, n-1], then right on row j, columns [j+bw, n-1].  Phase 2 (one SBR
    stage b_in = bw, tw = bw - 1, when bw >= 2 and n >= 3): for sweep
    R < n - 2 and cycle jc < (n-2)//bw + 1, pivot p = R + 1 + jc*bw, row
    r = R on a sweep's first cycle and p - bw after, hi = min(p+bw-1, n-1):
    right on row r over [p, hi], then left on column p over [p, hi].
    Supports of one entry or none (``tau = 0``, no-ops in the reference) are
    left out; the kernel walks the same list."""
    bw = effective_bw(n, bw)
    for j in range(n - 1):
        yield False, j, j, n - 1
        if j + bw < n - 1:
            yield True, j, j + bw, n - 1
    if bw < 2 or n < 3:
        return
    ncyc = (n - 2) // bw + 1
    for sweep in range(n - 2):
        for jc in range(ncyc):
            p = sweep + 1 + jc * bw
            if p >= n - 1:
                break
            r = sweep if jc == 0 else p - bw
            hi = min(p + bw - 1, n - 1)
            yield True, r, p, hi
            yield False, p, p, hi


def _fixed(seg: torch.Tensor, beta: torch.Tensor, tau: torch.Tensor):
    """``seg`` (B, L) with beta at 0 and exact zeros after it, where
    ``tau != 0``; unchanged where ``tau == 0``."""
    fix = torch.zeros_like(seg)
    fix[:, 0] = beta
    return torch.where((tau != 0)[:, None], fix, seg)


def _fix_row(a, r, lo, hi, beta, tau) -> None:
    """After a right reflector: row r gets beta at lo and exact zeros on
    (lo, hi], gated on ``tau != 0`` (in place)."""
    a[:, r, lo:hi + 1] = _fixed(a[:, r, lo:hi + 1], beta, tau)


def _fix_col(a, c, lo, hi, beta, tau) -> None:
    """After a left reflector: column c gets beta at row lo and exact zeros
    on (lo, hi], gated on ``tau != 0`` (in place)."""
    a[:, lo:hi + 1, c] = _fixed(a[:, lo:hi + 1, c], beta, tau)


def _reduce(a: torch.Tensor, *, bw: int, compute_uv: bool):
    """Phases 1 and 2 on a batch (B, n, n) in the accumulation type.

    Returns ``(d, e, u, vt)``: the bidiagonal (e[..., 0] = 0) and, with
    ``compute_uv``, U2 and V2^T with ``A = U2 B V2^T`` (else None).  A right
    reflector H updates every row of the columns [lo, hi] and V <- V H (the
    rows [lo, hi] of V^T); a left one every column of the rows [lo, hi] and
    U <- U H."""
    b, n, _ = a.shape
    a = a.clone()
    u = vt = None
    if compute_uv:
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(b, n, n)
        u, vt = eye.clone(), eye.clone()
    for right, k, lo, hi in fused_walk(n, bw):
        s = slice(lo, hi + 1)
        if right:
            v, tau, beta = make_reflector(a[:, k, s])
            blk = a[:, :, s]
            w = (blk @ v[:, :, None])[..., 0]
            a[:, :, s] = blk - tau[:, None, None] * (w[:, :, None]
                                                     * v[:, None, :])
            _fix_row(a, k, lo, hi, beta, tau)
            if compute_uv:
                blk = vt[:, s, :]
                w2 = (v[:, None, :] @ blk)[:, 0, :]
                vt[:, s, :] = blk - tau[:, None, None] * (v[:, :, None]
                                                          * w2[:, None, :])
        else:
            v, tau, beta = make_reflector(a[:, s, k])
            blk = a[:, s, :]
            w = (v[:, None, :] @ blk)[:, 0, :]
            a[:, s, :] = blk - tau[:, None, None] * (v[:, :, None]
                                                     * w[:, None, :])
            _fix_col(a, k, lo, hi, beta, tau)
            if compute_uv:
                blk = u[:, :, s]
                w2 = (blk @ v[:, :, None])[..., 0]
                u[:, :, s] = blk - tau[:, None, None] * (w2[:, :, None]
                                                         * v[:, None, :])
    d = a.diagonal(0, -2, -1).clone()
    e = torch.zeros_like(d)
    e[:, 1:] = a.diagonal(1, -2, -1)
    return d, e, u, vt


class _Store:
    """A working matrix as ``csrc/fused_small.cu`` stores it, a flat
    (B, words) buffer: row-major with origin (o, o) and row stride ``ld``
    ("dense": the matrix in device memory, or phase 1's trailing block), or
    diagonal-major ("band": A[i, j] at (j - i + dlo) * ld + j, ``h``
    diagonals)."""

    def __init__(self, buf, kind, ld, o=0, dlo=0, h=0):
        self.buf, self.kind, self.ld, self.o = buf, kind, ld, o
        self.dlo, self.h = dlo, h

    def index(self, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
        if self.kind == "band":
            dd = j - i + self.dlo
            if bool(((dd < 0) | (dd >= self.h)).any()):
                raise IndexError("a reflector reaches outside the stored "
                                 "diagonals of the band")
            return dd * self.ld + j
        if bool(((i < self.o) | (j < self.o)).any()):
            raise IndexError("a reflector reaches outside the trailing block")
        return (i - self.o) * self.ld + (j - self.o)


def fused_lines(right: bool, k: int, lo: int, hi: int, n: int,
                bw: int) -> tuple[int, int]:
    """The lines a reflector of the walk meets, first to last: a right one
    on row k over columns [lo, hi] meets rows [k, hi], a left one on column
    lo over rows [lo, hi] meets columns [lo, min(hi + bw, n - 1)].  Every
    other entry of its support's columns (rows) is an exact zero when it
    acts.  The first line is the pivot line."""
    return (k, hi) if right else (lo, min(hi + bw, n - 1))


def _reflect_lines(store: _Store, uv, right, k, lo, hi, n, bw) -> None:
    """One reflector on its lines only, in place: the block (B, lines, L)
    of line l's support entries, updated as ``_reduce`` updates the whole
    matrix; the pivot line gets beta and exact zeros where tau != 0.  ``uv``
    (B, n, n), U2 or V2 (V2^T transposed), gets all n rows."""
    first, last = fused_lines(right, k, lo, hi, n, bw)
    dev = store.buf.device
    lines = torch.arange(first, last + 1, device=dev)[:, None]
    sup = torch.arange(lo, hi + 1, device=dev)[None, :]
    i, j = (lines, sup) if right else (sup, lines)
    idx = store.index(*torch.broadcast_tensors(i, j)).reshape(-1)
    b, m, ln = store.buf.shape[0], last - first + 1, hi - lo + 1
    blk = store.buf[:, idx].reshape(b, m, ln)
    v, tau, beta = make_reflector(blk[:, 0, :])
    w = (blk @ v[:, :, None])[..., 0]
    new = blk - tau[:, None, None] * (w[:, :, None] * v[:, None, :])
    new[:, 0, :] = _fixed(new[:, 0, :], beta, tau)
    store.buf[:, idx] = new.reshape(b, -1)
    if uv is not None:
        seg = uv[:, :, lo:hi + 1]
        w2 = (seg @ v[:, :, None])[..., 0]
        uv[:, :, lo:hi + 1] = seg - tau[:, None, None] * (w2[:, :, None]
                                                         * v[:, None, :])


def fused_reduce_band(a: torch.Tensor, *, bw: int, compute_uv: bool = False,
                      route=None):
    """Phases 1 and 2 of ``fused_small_svd_cuda`` on its own storage, in
    plain torch (B, n, n) in the accumulation type: each reflector on the
    lines it meets (``fused_lines``); phase 1 on the whole matrix until
    column ``route.j0``, then on the trailing block A[j0:, j0:] (row stride
    ``route.ldt``); the band entries then move to the band storage (``h``
    diagonals of stride ``ldb``, the first ``dlo`` below the main one), on
    which phase 2 runs.  On the "global" route every phase runs on the
    whole matrix.  ``route`` defaults to ``tuning.fused_route``.  Returns
    ``(d, e, u, vt)`` as ``_reduce``; a reflector that reached outside its
    storage raises ``IndexError``."""
    from repro_torch.core import tuning
    b, n, _ = a.shape
    bw = effective_bw(n, bw)
    if route is None:
        route = tuning.fused_route(n, bw, a.dtype, compute_uv=compute_uv)
    dense = _Store(a.clone().reshape(b, n * n), "dense", n)
    u = v = None
    if compute_uv:
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(b, n, n)
        u, v = eye.clone(), eye.clone()
    smem = route.name == "smem"
    store = dense
    for j in range(n - 1):
        if smem and j == route.j0:         # the trailing block moves in
            blk = dense.buf.reshape(b, n, n)[:, j:, j:]
            buf = torch.zeros((b, n - j, route.ldt), dtype=a.dtype,
                              device=a.device)
            buf[:, :, :n - j] = blk
            store = _Store(buf.reshape(b, -1), "dense", route.ldt, o=j)
        _reflect_lines(store, u, False, j, j, n - 1, n, bw)
        if j + bw < n - 1:
            _reflect_lines(store, v, True, j, j + bw, n - 1, n, bw)
    if store is not dense:                 # its rows back, then the band
        full = dense.buf.reshape(b, n, n)
        j0 = store.o
        full[:, j0:, j0:] = store.buf.reshape(b, n - j0, route.ldt)[
            :, :, :n - j0]
    if smem:
        full = dense.buf.reshape(b, n, n)
        dd = torch.arange(route.h, device=a.device)[:, None]
        c = torch.arange(route.ldb, device=a.device)[None, :]
        i = c + route.dlo - dd
        keep = (c < n) & (i >= 0) & (i <= c) & (c - i <= bw)
        vals = full[:, i.clamp(0, n - 1), c.clamp(max=n - 1)]
        band = torch.where(keep, vals, torch.zeros((), dtype=a.dtype,
                                                   device=a.device))
        store = _Store(band.reshape(b, -1), "band", route.ldb,
                       dlo=route.dlo, h=route.h)
    if bw >= 2 and n >= 3:
        phase1 = (n - 1) + max(0, n - 1 - bw)
        for right, k, lo, hi in list(fused_walk(n, bw))[phase1:]:
            _reflect_lines(store, v if right else u, right, k, lo, hi, n, bw)
    kk = torch.arange(n, device=a.device)
    fin = store.buf[:, store.index(kk, kk)]
    e = torch.zeros_like(fin)
    if n > 1:
        e[:, 1:] = store.buf[:, store.index(kk[:-1], kk[1:])]
    return fin, e, u, (v.mT.contiguous() if compute_uv else None)


def fused_small_svd_ref(mats: torch.Tensor, *, bw: int,
                        compute_uv: bool = False,
                        max_iter: int | None = None):
    """Plain version of ``fused_small_svd_cuda`` on a (B, n, n) stack.

    Values mode returns sigma (B, n), descending: phases 1 and 2, then the
    port's stage 3 (``bidiag_singular_values`` on ``backend="ref"``).
    ``compute_uv=True`` returns ``(d, e, U2, V2^T)`` with ``e[..., 0] = 0``
    and ``A = U2 B V2^T``.  bw goes through :func:`effective_bw`.  Half
    types work in float32 and are rounded once, at the end."""
    if mats.dim() != 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"expected stacked (B, n, n), got "
                         f"{tuple(mats.shape)}")
    n = mats.shape[-1]
    dt = mats.dtype
    d, e, u, vt = _reduce(mats.to(acc_dtype(dt)), bw=effective_bw(n, bw),
                          compute_uv=compute_uv)
    if compute_uv:
        return d.to(dt), e.to(dt), u.to(dt), vt.to(dt)
    return bidiag_singular_values(d, e, max_iter=max_iter,
                                  backend="ref").to(dt)


def gqa_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The query heads g that share one KV head: q (BH, S, D), k and v
    (BH / g, S, D).  Raises ``ValueError`` when the shapes disagree or k's
    rows do not divide q's."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"expected q (BH, S, D) and k, v (BH/g, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[1:] != q.shape[1:]:
        raise ValueError(f"k, v {tuple(k.shape)}: (S, D) must be q's "
                         f"{tuple(q.shape[1:])}")
    bh, bh_kv = q.shape[0], k.shape[0]
    if bh_kv == 0 or bh % bh_kv:
        raise ValueError(f"k, v have {bh_kv} rows, which do not divide q's "
                         f"{bh}")
    return bh // bh_kv


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain causal softmax attention, the reference's
    ``flash_attention_ref`` with grouped KV heads: q (BH, S, D), k and v
    (BH / g, S, D), query row bh reading KV row bh // g (the reference's
    ``jnp.repeat(k, g, axis=2)`` once heads are flattened as b*nh + h; g = 1
    is the reference's contract).  Computed in fp32 with scale 1/sqrt(D)
    (the softmax weights stay fp32 for the product with v), the result in
    ``q.dtype``."""
    g = gqa_group(q, k, v)
    if g > 1:
        k = k.repeat_interleave(g, dim=0)
        v = v.repeat_interleave(g, dim=0)
    s_len = q.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()).mul_(scale)
    future = torch.ones((s_len, s_len), dtype=torch.bool,
                        device=q.device).triu(1)
    w = torch.softmax(scores.masked_fill_(future, -1e30), dim=-1)
    return torch.einsum("bst,btd->bsd", w, v.float()).to(q.dtype)


# (BH, S, S) elements of fp32 temporaries formed at once by the plain
# backward: it walks the KV rows in chunks of at most this many scores
_BWD_CHUNK = 1 << 28


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor):
    """The plain backward of :func:`flash_attention_ref`: (dq, dk, dv) given
    q, o = the forward's output and do = its gradient (BH, S, D), and k, v
    (BH / g, S, D), written out as the kernel computes it, not by autograd:
    the row log-sum-exp of the scaled causal scores LSE, D = rowsum(dO * O),
    P = exp(S - LSE), dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K * scale,
    dK = dS^T Q * scale, dK and dV summed over the g query rows bh that read
    KV row bh // g.  Computed in fp32 (fp64 for fp64 inputs), the results in
    the inputs' dtype.  The KV rows are walked in chunks, so that the (rows,
    S, S) temporaries stay near 1 GiB at the LM's training shapes."""
    g = gqa_group(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    bh, s_len, d = q.shape
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / d ** 0.5
    future = torch.ones((s_len, s_len), dtype=torch.bool,
                        device=q.device).triu(1)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    per = max(1, _BWD_CHUNK // max(1, g * s_len * s_len))
    for c0 in range(0, k.shape[0], per):
        kv = slice(c0, min(c0 + per, k.shape[0]))
        rows = slice(kv.start * g, kv.stop * g)
        qf, of, dof = (x[rows].to(acc) for x in (q, o, do))
        kf, vf = (x[kv].to(acc).repeat_interleave(g, dim=0) for x in (k, v))
        scores = torch.einsum("bsd,btd->bst", qf, kf).mul_(scale)
        scores.masked_fill_(future, float("-inf"))
        lse = torch.logsumexp(scores, dim=-1, keepdim=True)
        p = scores.sub_(lse).exp_()
        dsum = (dof * of).sum(-1, keepdim=True)
        dv_rows = torch.einsum("bst,bsd->btd", p, dof)
        ds = torch.einsum("bsd,btd->bst", dof, vf).sub_(dsum).mul_(p)
        del p
        dq[rows] = torch.einsum("bst,btd->bsd", ds, kf).mul_(scale).to(q.dtype)
        dk_rows = torch.einsum("bst,bsd->btd", ds, qf).mul_(scale)
        n_kv = kv.stop - kv.start
        dk[kv] = dk_rows.reshape(n_kv, g, s_len, d).sum(1).to(k.dtype)
        dv[kv] = dv_rows.reshape(n_kv, g, s_len, d).sum(1).to(v.dtype)
    return dq, dk, dv
