"""Reflector-tape replay: turn recorded Householder tapes into U and V^T.

With ``tape=True`` the stages record their orthogonal transforms instead of
discarding them:

* stage 1 (``core/stage1.py``): per-panel compact-WY blocks
  ``(V_qr, T_qr, V_lq, T_lq)``;
* stage 2 (``core/bulge_chasing.py``): per (super-cycle, wavefront slot)
  Householder pairs ``(v, tau)``, shapes ``(T, G, 2, tw+1)``, or
  ``(T, G, K, 2, tw+1)`` at fuse depth K.

This module replays them into accumulators, giving U and V^T with
``A = U B V^T`` (B the bidiagonal the chase produced).  Both accumulators
are kept TRANSPOSED (U^T and V^T), so every reflector, left or right, is
replayed as one primitive, the compact-WY left apply
``X <- (I - V T V^T) X`` of ``kernels/ops.py::tape_apply``: the
hand-written kernel ``kernels/csrc/hh_apply.cu`` on the card.

The chase replay keeps the chase's own wavefront batching: per super-cycle
the row slices of all B*G*K (matrix, slot, fused cycle) triples are gathered
into one ``tape_apply`` over B*G*K slots and scattered back.  The schedule
that keeps the chase's windows disjoint keeps the replayed row ranges
``[p, p+tw]`` disjoint too, and inactive triples go to their own scratch
rows past n, so the scatter has no two writers on one row.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import bulge_chasing as bc
from repro_torch.core.householder import acc_dtype

__all__ = ["ChaseTape", "accumulate_transforms", "replay_stage1",
           "replay_chase"]


@dataclasses.dataclass(frozen=True)
class ChaseTape:
    """Reflector tape of one chase stage: its schedule and its tensors.

    ``v``: (..., T, G, 2, tw+1) reflectors, pair axis (right -> V,
    left -> U); ``tau``: (..., T, G, 2), 0 on inactive slots.  At fuse
    depth K >= 2 there are K pairs per (super-cycle, slot):
    ``v (..., T, G, K, 2, tw+1)``, ``tau (..., T, G, K, 2)``."""
    n: int
    b_in: int
    tw: int
    v: torch.Tensor
    tau: torch.Tensor
    fuse: int = 1


def replay_stage1(ut: torch.Tensor, vt: torch.Tensor, tape, *, config=None):
    """Replay the stage-1 panel tape into the transposed accumulators.

    ut / vt: (B, n, n) holding U^T / V^T so far.  Panel k recorded
    ``Q_k = I - Vq Tq Vq^T`` (left, QR) and ``R_k = I - Vl Tl Vl^T`` (right,
    LQ), with ``A_banded = Q_P^T ... Q_0^T A R_0 ... R_P``; so the replay
    left-applies ``Q_k^T = I - Vq Tq^T Vq^T`` to U^T, and the ``R_k``
    counterpart to V^T, in panel order.  Returns the updated pair (the
    "cuda" backend updates them in place)."""
    from repro_torch.kernels import ops
    vq, tq, vl, tl = (x.transpose(0, 1) for x in tape)      # (P, B, ...)
    vq, vl = vq.contiguous(), vl.contiguous()
    tq = tq.transpose(-1, -2).contiguous()
    tl = tl.transpose(-1, -2).contiguous()
    for k in range(vq.shape[0]):
        ut = ops.tape_apply(vq[k], tq[k], ut, config=config)
        vt = ops.tape_apply(vl[k], tl[k], vt, config=config)
    return ut, vt


def _replay_rows(n: int, b_in: int, tw: int, fuse: int, T: int, G: int,
                 device) -> torch.Tensor:
    """(T, G, K, tw+1) accumulator rows that each (super-cycle, slot, fused
    cycle) replays onto: ``[p + i*b_in, p + i*b_in + tw]`` when the cycle is
    live, else its own scratch rows ``n + W + (g*K + i)*W`` past the
    matrix."""
    W = b_in + tw + 1
    t = torch.arange(T, device=device)[:, None]
    g = torch.arange(G, device=device)[None, :]
    _, _, p, active, _ = bc.chase_cycle_indices(t, g, n, b_in, tw, fuse)
    i = torch.arange(fuse, device=device)
    p_i = p[..., None] + i * b_in                              # (T, G, K)
    live = active[..., None] & (p_i <= n - 1)
    dump = n + W + (g[..., None] * fuse + i) * W
    p_safe = torch.where(live, p_i, dump)
    return p_safe[..., None] + torch.arange(tw + 1, device=device)


def _replay_loop(utp: torch.Tensor, vtp: torch.Tensor, rows: torch.Tensor,
                 v: torch.Tensor, tau: torch.Tensor, *, config) -> None:
    """Replay every super-cycle of one chase stage, in place on the padded
    accumulators (B, n_pad, n).

    The one place the chase replay launches: a CUDA graph can replace this
    loop without touching its callers.  ``rows`` (T, G, K, k) from
    :func:`_replay_rows`; ``v`` (T, 2, B*G*K, k, 1) and ``tau``
    (T, 2, B*G*K, 1, 1), contiguous per (super-cycle, side)."""
    from repro_torch.kernels import ops
    B, _, n = utp.shape
    T, G, K, k = rows.shape
    S = B * G * K
    for t in range(T):
        r = rows[t]
        for side, acc in ((1, utp), (0, vtp)):          # left -> U, right -> V
            sl = acc[:, r].reshape(S, k, n)
            out = ops.tape_apply(v[t, side], tau[t, side], sl, config=config)
            acc[:, r] = out.reshape(B, G, K, k, n)


def replay_chase(ut: torch.Tensor, vt: torch.Tensor, tape_v: torch.Tensor,
                 tape_tau: torch.Tensor, *, n: int, b_in: int, tw: int,
                 config=None, fuse: int = 1):
    """Replay one chase stage's tape into the transposed accumulators.

    ut / vt: (B, n, n); ``tape_v`` (B, T, G[, K], 2, tw+1) and ``tape_tau``
    (B, T, G[, K], 2).  The rows each slot replays onto come from the
    chase's own schedule (``chase_cycle_indices``): the tape stores only
    (v, tau).  Inactive slots, recorded with tau = 0, go to disjoint scratch
    rows.  At fuse K, fused cycle i's rows ``[p + i*b_in, p + i*b_in + tw]``
    are disjoint from its neighbours' (``b_in >= tw + 1``), so a whole
    super-cycle replays as one ``tape_apply`` over B*G*K slots.  Returns new
    accumulators."""
    nsweeps, T, G = bc.stage_schedule(n, b_in, tw, fuse)
    if nsweeps == 0 or T == 0:
        return ut, vt
    B = ut.shape[0]
    k = tw + 1
    W = b_in + tw + 1
    n_pad = n + W + G * fuse * W
    utp = ut.new_zeros((B, n_pad, n))
    vtp = vt.new_zeros((B, n_pad, n))
    utp[:, :n] = ut
    vtp[:, :n] = vt
    rows = _replay_rows(n, b_in, tw, fuse, T, G, ut.device)
    # (B, T, G*K, 2, k) -> (T, 2, B*G*K, k, 1): one contiguous operand per
    # (super-cycle, side)
    v = (tape_v.reshape(B, T, G * fuse, 2, k).permute(1, 3, 0, 2, 4)
         .reshape(T, 2, B * G * fuse, k, 1).contiguous())
    tau = (tape_tau.reshape(B, T, G * fuse, 2).permute(1, 3, 0, 2)
           .reshape(T, 2, B * G * fuse, 1, 1).contiguous())
    _replay_loop(utp, vtp, rows, v, tau, config=config)
    return utp[:, :n], vtp[:, :n]


def accumulate_transforms(n: int, *, s1_tape=None, chase_tapes=(),
                          lead: tuple = (), dtype=torch.float64, config=None,
                          device=None):
    """Replay all tapes from the identity: returns (U, V^T) with
    ``A = U B V^T``, each (lead..., n, n).

    The accumulators run in the accumulation type of ``dtype`` (float32 for
    bfloat16) and are cast back at the end.  ``device`` defaults to the
    tapes' device."""
    acc = acc_dtype(dtype)
    b = math.prod(lead)
    if device is None:
        first = (s1_tape[0] if s1_tape is not None else
                 chase_tapes[0].v if chase_tapes else None)
        device = first.device if first is not None else "cpu"
    eye = torch.eye(n, dtype=acc, device=device)
    ut = eye.repeat(b, 1, 1)
    vt = eye.repeat(b, 1, 1)
    if s1_tape is not None:
        flat = tuple(x.reshape((b,) + x.shape[len(lead):]).to(acc)
                     for x in s1_tape)
        ut, vt = replay_stage1(ut, vt, flat, config=config)
    for tape in chase_tapes:
        tv = tape.v.reshape((b,) + tape.v.shape[len(lead):]).to(acc)
        tt = tape.tau.reshape((b,) + tape.tau.shape[len(lead):]).to(acc)
        ut, vt = replay_chase(ut, vt, tv, tt, n=tape.n, b_in=tape.b_in,
                              tw=tape.tw, config=config, fuse=tape.fuse)
    u = ut.transpose(-1, -2)
    return (u.reshape(lead + (n, n)).to(dtype),
            vt.reshape(lead + (n, n)).to(dtype))
