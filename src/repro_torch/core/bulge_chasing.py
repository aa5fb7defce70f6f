"""Band -> bidiagonal reduction by memory-aware bulge chasing (paper Alg. 1),
on packed band storage, batch-native.

Scheduling (one stage reduces the bandwidth ``b_in -> b_out = b_in - tw``):
sweep R starts at global cycle ``3R`` and at local cycle j owns pivot column
``p = R + b_out + j*b_in``.  Cycle j = 0 annihilates row R's outermost ``tw``
band elements; cycle j > 0 the row bulge of row ``p - b_in``; each cycle then
the column bulge of pivot column p.  The 3-cycle separation keeps the
windows of one global cycle disjoint, so all of them go to one kernel
launch, over B*G slots for a batch of B matrices.  With fuse depth K a
launch chases K consecutive cycles of each sweep on one contiguous band
block (``_chase_loop``).

The band is updated in place.  The reference rebuilds its arrays with
``.at[].set`` inside a ``fori_loop``; here each stage pads the band once into
a new tensor.  Each (super-)cycle is one call of the stage that
``ops.band_stage`` makes (``ops.chase_cycle_band`` at fuse 1,
``ops.chase_superstep_band`` at fuse K), which on the card is one launch
that chases every slot's window or block where it lies and writes the
tape.  The schedule of all T cycles is computed on the device
once per stage as (T, G) tensors, so the loop does no ``.item()`` and no
host-to-device copy.
"""

from __future__ import annotations

import torch

from repro_torch.core import band as bandmod
from repro_torch.core import tuning

__all__ = ["stage_schedule", "chase_cycle_indices", "reduce_stage_packed",
           "bidiagonalize_packed", "bidiagonalize"]


def stage_schedule(n: int, b_in: int, tw: int, fuse: int = 1
                   ) -> tuple[int, int, int]:
    """(n_sweeps, total_super_cycles, max_concurrent) of one stage.

    Sweep R starts at super-cycle ``sep*R`` (``sep = sweep_separation(K)``)
    and lives ``ceil((j_max(R)+1)/K)`` super-cycles; the last sweep finishes
    last."""
    conc = tuning.max_concurrent_sweeps(n, b_in, fuse, tw)
    b_out = b_in - tw
    nsweeps = max(n - 1 - b_out, 0)
    if nsweeps == 0:
        return 0, 0, conc
    last = nsweeps - 1
    max_j_last = max((n - 1 - last - b_out) // b_in, 0)
    sep = tuning.sweep_separation(fuse)
    total = sep * last + -(-(max_j_last + 1) // fuse)
    return nsweeps, total, conc


def chase_cycle_indices(t, g, n: int, b_in: int, tw: int, fuse: int = 1):
    """Slot -> (sweep, base local cycle, base pivot, active, is_first).

    Slot g at (super-)cycle t hosts sweep ``R = t//sep - g`` at base local
    cycle ``j = (t - sep*R)*fuse``.  ``R`` is negative for slots whose sweep
    has not started; ``//`` floors on Python ints and on integer tensors
    alike, as the reference's does.  Works on ints and on tensors."""
    sep = tuning.sweep_separation(fuse)
    b_out = b_in - tw
    nsweeps = max(n - 1 - b_out, 0)
    R = t // sep - g
    j = (t - sep * R) * fuse
    p = R + b_out + j * b_in
    active = (R >= 0) & (R < nsweeps) & (p <= n - 1)
    return R, j, p, active, (j == 0)


def _cycle_table(n: int, b_in: int, tw: int, fuse: int, T: int, G: int,
                 B: int, device):
    """The whole stage's schedule on the device.

    Returns ``p_safe (T, G)``: each slot's first band column, pointing an
    inactive slot at its own all-zero dump zone (``n + WK + g*WK``);
    ``first (T, B*G)``; and ``live (T, G, K)``, the live prefix of each
    slot's K cycles (K = 1 at fuse 1)."""
    wk = fuse * b_in + tw + 1
    t = torch.arange(T, device=device)[:, None]
    g = torch.arange(G, device=device)[None, :]
    _, _, p, on, first = chase_cycle_indices(t, g, n, b_in, tw, fuse)
    p_safe = torch.where(on, p, n + wk + g * wk)
    off = torch.arange(fuse, device=device) * b_in
    live = on[..., None] & (p[..., None] + off <= n - 1)
    return p_safe, first.repeat(1, B), live


def _chase_loop(bandp: torch.Tensor, p_safe, first, live, *, n: int,
                b_in: int, tw: int, fuse: int, backend: str, config,
                tape=None) -> None:
    """Run every (super-)cycle of one stage on the padded band, in place.

    The one place a cycle is launched: a CUDA graph or a persistent kernel
    can replace this loop without touching its callers.

    Slots that are not live point at their dump zones and leave the band
    as it was.  ``tape``, when given, is the pair of buffers ``(vs (B, T,
    G, K, 2, tw+1), taus (B, T, G, K, 2))``; each cycle's reflectors are
    stored there, with tau set to 0 on inactive slots and cycles, so that
    their replay is the identity.  The band arithmetic is the same with and
    without it.

    The stage is checked once (``ops.band_stage``); then each (super-)cycle
    is one call of the stage, ``ops.chase_cycle_band`` at fuse 1 and
    ``ops.chase_superstep_band`` at fuse K, which on the card is one launch
    and no other torch op."""
    from repro_torch.kernels import ops
    with ops.band_stage(bandp, p_safe.to(torch.int32), first, live, n=n,
                        b_in=b_in, tw=tw, fuse=fuse, tape=tape,
                        backend=backend, config=config) as stage:
        for t in range(p_safe.shape[0]):
            stage(t)


def reduce_stage_packed(band: torch.Tensor, *, n: int, b_in: int, tw: int,
                        backend: str = "auto", config=None,
                        fuse: int | None = None, tape: bool = False):
    """One SBR stage on packed storage (..., b_in + 2*tw + 1, >= n).

    Returns a new tensor of the same shape whose bandwidth is ``b_in - tw``.
    All B problems of a batch advance on one wavefront clock: each
    (super-)cycle is one kernel launch over B*G slots.  ``fuse=K`` chases K
    consecutive cycles per launch; the result does not depend on K.
    Explicit ``backend=``/``fuse=`` win over ``config``.

    With ``tape=True`` returns ``(band, vs, taus)``, the stage's reflector
    tape as the reference records it: ``vs (..., T, G, 2, tw+1)`` and
    ``taus (..., T, G, 2)`` at fuse 1, ``(..., T, G, K, 2, tw+1)`` and
    ``(..., T, G, K, 2)`` at fuse K, right reflector first, tau = 0 on
    inactive slots and cycles.  The band is bit-identical either way."""
    if fuse is None:
        fuse = config.fuse if config is not None else 1
    fuse = max(int(fuse), 1)
    assert b_in - tw >= 1, (b_in, tw)
    H = b_in + 2 * tw + 1
    if band.dim() < 2 or band.shape[-2] != H:
        raise ValueError(f"band has shape {tuple(band.shape)}, expected "
                         f"(..., {H}, >= {n})")
    lead = band.shape[:-2]
    ncols0 = band.shape[-1]
    band3 = band.reshape((-1, H, ncols0))
    B = band3.shape[0]
    nsweeps, T, G = stage_schedule(n, b_in, tw, fuse)
    pair = (G, 2) if fuse == 1 else (G, fuse, 2)
    if nsweeps == 0 or T == 0:
        if not tape:
            return band.clone()
        empty = band.new_zeros(lead + (0,) + pair + (tw + 1,))
        return band.clone(), empty, band.new_zeros(lead + (0,) + pair)
    n_pad = tuning.band_padding(n, b_in, tw, fuse, G)   # dump zones at the end
    bandp = bandmod.pad_columns(band3, max(n_pad - ncols0, 0))
    p_safe, first, live = _cycle_table(n, b_in, tw, fuse, T, G, B,
                                       band.device)
    bufs = None
    if tape:
        bufs = (band.new_empty((B, T, G, fuse, 2, tw + 1)),
                band.new_empty((B, T, G, fuse, 2)))
    _chase_loop(bandp, p_safe, first, live, n=n, b_in=b_in, tw=tw,
                fuse=fuse, backend=backend, config=config, tape=bufs)
    out = bandp[..., :ncols0].reshape(lead + (H, ncols0))
    if not tape:
        return out
    return (out, bufs[0].reshape(lead + (T,) + pair + (tw + 1,)),
            bufs[1].reshape(lead + (T,) + pair))


def bidiagonalize_packed(band: torch.Tensor, *, n: int, bw: int, tw: int,
                         backend: str = "auto", config=None,
                         fuse: int | None = None, tape: bool = False):
    """Full SBR bw -> 1 on packed storage; returns (diag, superdiag).

    ``band`` is packed with ``tw_0 = min(tw, bw-1)`` sub rows
    (``band.pack(a, bw, min(tw, bw-1))``).  Entering each stage (b_in, tw_i)
    of the plan the storage holds ``tw_i`` sub rows, the diagonal and
    ``b_in + tw_i`` super rows; between stages it is re-sliced.  With
    ``tape=True`` returns ``(diag, superdiag, tapes)``, ``tapes`` a list of
    :class:`repro_torch.core.transforms.ChaseTape`, one per stage, in
    order."""
    if tape:
        from repro_torch.core import transforms   # transforms imports us
    if fuse is None:
        fuse = config.fuse if config is not None else 1
    fuse = max(int(fuse), 1)
    plan = tuning.stage_plan(bw, tw)
    if not plan:
        h = band.shape[-2]
        tw0 = (h - 2) // 2 if h > 2 else 0
        d = bandmod.band_extract_diag(band, tw0, 0, n)
        e = (bandmod.band_extract_diag(band, tw0, 1, n) if bw >= 1
             else torch.zeros_like(d))
        return (d, e, []) if tape else (d, e)
    cur = band
    tw_cur = plan[0][1]
    if cur.shape[-2] != plan[0][0] + 2 * tw_cur + 1:
        raise ValueError(f"band has {cur.shape[-2]} rows; the plan {plan} "
                         f"needs {plan[0][0] + 2 * tw_cur + 1}")
    tapes = []
    for b_in, twi in plan:
        h_i = b_in + 2 * twi + 1
        start = tw_cur - twi
        cur = cur[..., start:start + h_i, :]
        cur = reduce_stage_packed(cur, n=n, b_in=b_in, tw=twi,
                                  backend=backend, config=config, fuse=fuse,
                                  tape=tape)
        if tape:
            cur, tv, tt = cur
            tapes.append(transforms.ChaseTape(n=n, b_in=b_in, tw=twi, v=tv,
                                              tau=tt, fuse=fuse))
        tw_cur = twi
    d = bandmod.band_extract_diag(cur, tw_cur, 0, n)
    e = bandmod.band_extract_diag(cur, tw_cur, 1, n)
    return (d, e, tapes) if tape else (d, e)


def bidiagonalize(a: torch.Tensor, *, bw: int, tw: int,
                  backend: str = "auto", config=None,
                  fuse: int | None = None, tape: bool = False):
    """Dense upper-banded (..., n, n) -> (diag, superdiag), each (..., n);
    with ``tape=True`` also the per-stage reflector tapes
    (:func:`bidiagonalize_packed`)."""
    n = a.shape[-1]
    tw0 = min(tw, max(bw - 1, 1))
    packed = bandmod.pack(a, bw, tw0)
    return bidiagonalize_packed(packed, n=n, bw=bw, tw=tw, backend=backend,
                                config=config, fuse=fuse, tape=tape)
