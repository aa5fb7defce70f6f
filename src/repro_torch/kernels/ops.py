"""Backend registry and the dispatching wrappers of the port's kernels: the
SVD pipeline's and the LM's causal flash attention.

Backends are entries in a small registry (``register_backend``) that maps a
name to per-op implementations:

  "ref"          the plain PyTorch versions, on any device;
  "cuda"         the hand-written Hopper kernels, on CUDA tensors only;
  "fused_small"  the one-launch small-n tier: every op runs the "cuda"
                 implementation on a CUDA tensor and the "ref" one on a CPU
                 tensor, so a fused config can still run any staged op.

``resolve_backend`` turns "auto" into a concrete name from the *requested
device*, never from what the machine has: "cuda" for a CUDA device, "ref"
for the CPU.  Asking for "cuda" on the CPU raises; nothing falls back.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tuning import check_disjoint_blocks

__all__ = ["chase_cycle", "chase_cycle_band", "chase_superstep_band",
           "band_stage", "sturm_bisect", "dc_leaf", "dc_deflate",
           "dc_secular",
           "tape_apply", "hh_block_apply",
           "fused_svd", "flash_attention", "flash_attention_bwd",
           "register_backend", "check_device",
           "resolve_backend", "backend_names", "launch_counts",
           "reset_launch_counts"]

_REGISTRY: dict[str, dict[str, Callable]] = {}


def register_backend(name: str, **impls: Callable) -> None:
    """Register (or extend) a backend: op name -> implementation."""
    _REGISTRY.setdefault(name, {}).update(impls)


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    a card raises, naming the CPU option.  Nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this call runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def resolve_backend(backend: str = "auto", device="cuda") -> str:
    """A concrete registry key for ``backend`` on ``device``."""
    dev = torch.device(device)
    if backend == "auto":
        backend = "cuda" if dev.type == "cuda" else "ref"
    if backend not in _REGISTRY:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{backend_names()}")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(f"backend 'cuda' runs on CUDA tensors only, got "
                         f"device {dev}")
    return backend


def _impl(op: str, backend: str, config, device) -> Callable:
    if backend == "auto" and config is not None:
        backend = config.backend
    return _REGISTRY[resolve_backend(backend, device)][op]


# ---- "ref": plain PyTorch -------------------------------------------------

def _ref_chase(windows, is_first, *, b_in, tw, with_tape, fuse, active):
    from repro_torch.kernels import ref
    if fuse == 1:
        return ref.chase_cycle_ref(windows, is_first, b_in=b_in, tw=tw,
                                   with_tape=with_tape)
    return ref.chase_superstep_ref(windows, is_first, active, b_in=b_in,
                                   tw=tw, fuse=fuse, with_tape=with_tape)


def _ref_cycle_band(bandp, p_safe, first, live, t, *, b_in, tw, tape):
    from repro_torch.kernels import ref
    return ref.chase_cycle_band_ref(bandp, p_safe, first, live, t, b_in=b_in,
                                    tw=tw, tape=tape)


def _ref_superstep_band(bandp, p_safe, first, live, t, *, b_in, tw, fuse,
                        tape):
    from repro_torch.kernels import ref
    return ref.chase_superstep_band_ref(bandp, p_safe, first, live, t,
                                        b_in=b_in, tw=tw, fuse=fuse, tape=tape)


def _ref_band_stage(bandp, p_safe, first, live, *, b_in, tw, fuse, tape):
    from repro_torch.kernels import ref
    return ref.BandStageRef(bandp, p_safe, first, live, b_in=b_in, tw=tw,
                            fuse=fuse, tape=tape)


def _ref_bisect(z, bound, *, n, max_iter):
    from repro_torch.core.bidiag_svd import bisect_plain
    return bisect_plain(z, bound, n=n, max_iter=max_iter)


def _ref_dc_leaf(a, b, lo0, hi0, ctol, x0, *, bisect_iters, inv_iters):
    from repro_torch.core.bidiag_dc import leaf_eigen_plain
    return leaf_eigen_plain(a, b, lo0, hi0, ctol, x0,
                            bisect_iters=bisect_iters, inv_iters=inv_iters)


def _ref_dc_deflate(d, z, fe, le, active, tol):
    from repro_torch.core.bidiag_dc import deflate_plain
    return deflate_plain(d, z, fe, le, active, tol)


def _ref_dc_secular(d, w, gap, act, d_next, a_next, hidx, *, nact,
                    newton_iters):
    from repro_torch.core.bidiag_dc import secular_plain
    return secular_plain(d, w, gap, act, d_next, a_next, hidx, nact=nact,
                         newton_iters=newton_iters)


def _ref_tape(v, t, c, rows=None):
    from repro_torch.kernels import ref
    return ref.tape_apply_ref(v, t, c, rows=rows)


def _ref_hh(v, t, c):
    from repro_torch.kernels import ref
    return ref.hh_block_apply_ref(v, t, c)


def _ref_fused(mats, *, bw, compute_uv, max_iter):
    from repro_torch.kernels import ref
    return ref.fused_small_svd_ref(mats, bw=bw, compute_uv=compute_uv,
                                   max_iter=max_iter)


def _ref_flash(q, k, v):
    from repro_torch.kernels import ref
    return ref.flash_attention_ref(q, k, v)


def _ref_flash_bwd(q, k, v, o, do):
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(q, k, v, o, do)


register_backend("ref", chase_cycle=_ref_chase,
                 chase_cycle_band=_ref_cycle_band,
                 chase_superstep_band=_ref_superstep_band,
                 band_stage=_ref_band_stage,
                 sturm_bisect=_ref_bisect, dc_leaf=_ref_dc_leaf,
                 dc_deflate=_ref_dc_deflate, dc_secular=_ref_dc_secular,
                 tape_apply=_ref_tape, hh_block_apply=_ref_hh,
                 fused_svd=_ref_fused, flash_attention=_ref_flash,
                 flash_attention_bwd=_ref_flash_bwd)


# ---- "cuda": the Hopper kernels (built on first use) ----------------------

def _cuda_chase(windows, is_first, *, b_in, tw, with_tape, fuse, active):
    from repro_torch.kernels import bulge_chase
    if fuse == 1:
        return bulge_chase.chase_cycle_cuda(windows, is_first, b_in=b_in,
                                            tw=tw, with_tape=with_tape)
    return bulge_chase.chase_superstep_cuda(windows, is_first, active,
                                            b_in=b_in, tw=tw, fuse=fuse,
                                            with_tape=with_tape)


def _cuda_cycle_band(bandp, p_safe, first, live, t, *, b_in, tw, tape):
    from repro_torch.kernels import bulge_chase
    return bulge_chase.chase_cycle_band_cuda(bandp, p_safe, first, live, t,
                                             b_in=b_in, tw=tw, tape=tape)


def _cuda_superstep_band(bandp, p_safe, first, live, t, *, b_in, tw, fuse,
                         tape):
    from repro_torch.kernels import bulge_chase
    return bulge_chase.chase_superstep_band_cuda(
        bandp, p_safe, first, live, t, b_in=b_in, tw=tw, fuse=fuse, tape=tape)


def _cuda_band_stage(bandp, p_safe, first, live, *, b_in, tw, fuse, tape):
    from repro_torch.kernels import bulge_chase
    return bulge_chase.BandStage(bandp, p_safe, first, live, b_in=b_in, tw=tw,
                                 fuse=fuse, tape=tape)


def _cuda_bisect(z, bound, *, n, max_iter):
    from repro_torch.kernels import bisect
    return bisect.sturm_bisect_cuda(z, bound, n=n, max_iter=max_iter)


def _cuda_dc_leaf(a, b, lo0, hi0, ctol, x0, *, bisect_iters, inv_iters):
    from repro_torch.kernels import dc
    return dc.dc_leaf_cuda(a, b, lo0, hi0, ctol, x0,
                           bisect_iters=bisect_iters, inv_iters=inv_iters)


def _cuda_dc_deflate(d, z, fe, le, active, tol):
    from repro_torch.kernels import dc
    return dc.dc_deflate_cuda(d, z, fe, le, active, tol)


def _cuda_dc_secular(d, w, gap, act, d_next, a_next, hidx, *, nact,
                     newton_iters):
    from repro_torch.kernels import dc
    return dc.dc_secular_cuda(d, w, gap, act, d_next, a_next, hidx,
                              nact=nact, newton_iters=newton_iters)


def _cuda_tape(v, t, c, rows=None):
    from repro_torch.kernels import hh_apply
    return hh_apply.tape_apply_cuda(v, t, c, rows)


def _cuda_hh(v, t, c):
    from repro_torch.kernels import hh_apply
    return hh_apply.hh_block_apply_cuda(v, t, c)


def _cuda_fused(mats, *, bw, compute_uv, max_iter):
    from repro_torch.kernels import fused_small
    return fused_small.fused_small_svd_cuda(mats, bw=bw,
                                            compute_uv=compute_uv,
                                            max_iter=max_iter)


def _cuda_flash(q, k, v):
    from repro_torch.kernels import flash_attention as fa
    if fa.kernel_for(q.dtype, q.shape[-1]) == "wgmma":
        return fa.flash_attention_wgmma_cuda(q, k, v)
    return fa.flash_attention_cuda(q, k, v)


def _cuda_flash_bwd(q, k, v, o, do):
    from repro_torch.kernels import flash_attention as fa
    if fa.bwd_kernel_for(q.dtype, q.shape[-1]) == "wgmma":
        return fa.flash_attention_bwd_wgmma_cuda(q, k, v, o, do)
    return fa.flash_attention_bwd_cuda(q, k, v, o, do)


register_backend("cuda", chase_cycle=_cuda_chase,
                 chase_cycle_band=_cuda_cycle_band,
                 chase_superstep_band=_cuda_superstep_band,
                 band_stage=_cuda_band_stage,
                 sturm_bisect=_cuda_bisect, dc_leaf=_cuda_dc_leaf,
                 dc_deflate=_cuda_dc_deflate, dc_secular=_cuda_dc_secular,
                 tape_apply=_cuda_tape, hh_block_apply=_cuda_hh,
                 fused_svd=_cuda_fused, flash_attention=_cuda_flash,
                 flash_attention_bwd=_cuda_flash_bwd)


# ---- "fused_small": by the device of the op's first tensor ----------------

def _fused_small_delegate(op: str) -> Callable:
    def impl(x, *args, **kwargs):
        name = "cuda" if x.device.type == "cuda" else "ref"
        return _REGISTRY[name][op](x, *args, **kwargs)
    return impl


register_backend("fused_small", **{op: _fused_small_delegate(op)
                                   for op in _REGISTRY["cuda"]})


# ---- public wrappers ------------------------------------------------------

def chase_cycle(windows: torch.Tensor, is_first: torch.Tensor, *, b_in: int,
                tw: int, backend: str = "auto", config=None,
                with_tape: bool = False, fuse: int = 1,
                active: torch.Tensor | None = None):
    """One wavefront of chase (super-)cycles.

    ``fuse=1``: rolled windows (G, H, W) and ``is_first`` (G,).  ``fuse=K``:
    contiguous band blocks (G, H, K*b_in + tw + 1), ``is_first`` and the
    ``active`` (G, K) prefix mask.  The "cuda" backend updates the operand in
    place and returns it; "ref" returns a new tensor.  With ``with_tape``
    also the reflector tape, as the reference's ``ops.chase_cycle``."""
    impl = _impl("chase_cycle", backend, config, windows.device)
    return impl(windows, is_first, b_in=b_in, tw=tw, with_tape=with_tape,
                fuse=fuse, active=active)


def chase_cycle_band(bandp: torch.Tensor, p_safe: torch.Tensor,
                     first: torch.Tensor, live: torch.Tensor, t: int, *,
                     n: int, b_in: int, tw: int, tape=None,
                     backend: str = "auto", config=None) -> torch.Tensor:
    """Cycle ``t`` of one fuse-1 stage on the padded band bandp (B, H,
    n_pad), in place, given the stage's tables (``bulge_chasing.
    _cycle_table``): p_safe (T, G) (int32 for "cuda"), first (T, B*G), live
    (T, G, 1); with ``tape`` also row t of the stage's tape (B, T, G, 1, 2,
    tw+1), (B, T, G, 1, 2), tau = 0 where not live.  "cuda": one launch,
    each slot addressing its window where it lies, a slot that is not live
    touching nothing in the band; "ref": gather, ``chase_cycle_ref``,
    scatter.  Returns ``bandp``.

    The slots' windows are chased in place at once, so they must be
    pairwise disjoint in band columns: a schedule or a padding that would
    let them overlap raises (``tuning.check_disjoint_blocks``)."""
    check_disjoint_blocks(n, b_in, tw, 1, p_safe.shape[-1], bandp.shape[-1])
    impl = _impl("chase_cycle_band", backend, config, bandp.device)
    return impl(bandp, p_safe, first, live, t, b_in=b_in, tw=tw, tape=tape)


def band_stage(bandp: torch.Tensor, p_safe: torch.Tensor,
               first: torch.Tensor, live: torch.Tensor, *, n: int, b_in: int,
               tw: int, fuse: int, tape=None, backend: str = "auto",
               config=None):
    """One stage's (super-)cycles on the padded band, in place: a context
    manager whose call ``stage(t)`` is :func:`chase_cycle_band` (fuse 1) or
    :func:`chase_superstep_band` at t, with what those check each call
    checked once here.  "cuda": ``bulge_chase.BandStage``, one launch and
    no other host work than a ``ctypes`` call per (super-)cycle; "ref":
    ``ref.BandStageRef``."""
    check_disjoint_blocks(n, b_in, tw, fuse, p_safe.shape[-1],
                          bandp.shape[-1])
    impl = _impl("band_stage", backend, config, bandp.device)
    return impl(bandp, p_safe, first, live, b_in=b_in, tw=tw, fuse=fuse,
                tape=tape)


def chase_superstep_band(bandp: torch.Tensor, p_safe: torch.Tensor,
                         first: torch.Tensor, live: torch.Tensor, t: int, *,
                         n: int, b_in: int, tw: int, fuse: int, tape=None,
                         backend: str = "auto", config=None) -> torch.Tensor:
    """Super-cycle ``t`` of one stage at fuse K on the padded band bandp
    (B, H, n_pad), in place, given the stage's tables (``bulge_chasing.
    _cycle_table``): p_safe (T, G) (int32 for "cuda"), first (T, B*G), live
    (T, G, K); with ``tape`` also row t of the stage's tape.  "cuda": one
    launch, each slot addressing its block where it lies; "ref": gather,
    ``chase_superstep_ref``, scatter.  Returns ``bandp``.

    The slots' blocks are chased in place at once, so they must be pairwise
    disjoint in band columns: a schedule or a padding that would let them
    overlap raises (``tuning.check_disjoint_blocks``)."""
    check_disjoint_blocks(n, b_in, tw, fuse, p_safe.shape[-1],
                          bandp.shape[-1])
    impl = _impl("chase_superstep_band", backend, config, bandp.device)
    return impl(bandp, p_safe, first, live, t, b_in=b_in, tw=tw, fuse=fuse,
                tape=tape)


def sturm_bisect(z: torch.Tensor, bound: torch.Tensor, *, n: int,
                 max_iter: int, backend: str = "auto", config=None):
    """Singular values (B, n), descending, of prescaled bidiagonals given by
    their Golub–Kahan off-diagonals ``z`` (B, 2n-1) and bounds (B,)."""
    impl = _impl("sturm_bisect", backend, config, z.device)
    return impl(z, bound, n=n, max_iter=max_iter)


def dc_leaf(a: torch.Tensor, b: torch.Tensor, lo0: torch.Tensor,
            hi0: torch.Tensor, ctol: torch.Tensor, x0: torch.Tensor, *,
            bisect_iters: int, inv_iters: int, backend: str = "auto",
            config=None):
    """Eigenvalues (ascending) and first and last eigenvector rows, each
    (P, lm), of P tridiagonal leaves (diag a (P, lm), off-diag b
    (P, lm-1)), given each leaf's bracket [lo0, hi0] and cluster width
    ctol (P,) and the start vectors x0 (lm, lm): the divide-and-conquer
    leaves (``core.bidiag_dc.leaf_eigen_plain``)."""
    impl = _impl("dc_leaf", backend, config, a.device)
    return impl(a, b, lo0, hi0, ctol, x0, bisect_iters=bisect_iters,
                inv_iters=inv_iters)


def dc_deflate(d: torch.Tensor, z: torch.Tensor, fe: torch.Tensor,
               le: torch.Tensor, active: torch.Tensor, tol: torch.Tensor, *,
               backend: str = "auto", config=None):
    """The Givens deflation scan of a merge over P subproblems (each input
    (P, m), tol (P,)); returns (d, z, fe, le, active)
    (``core.bidiag_dc.deflate_plain``).  The kernel and the plain version
    agree bit for bit."""
    impl = _impl("dc_deflate", backend, config, d.device)
    return impl(d, z, fe, le, active, tol)


def dc_secular(d: torch.Tensor, w: torch.Tensor, gap: torch.Tensor,
               act: torch.Tensor, d_next: torch.Tensor, a_next: torch.Tensor,
               hidx: torch.Tensor, *, nact: int, newton_iters: int,
               backend: str = "auto", config=None):
    """The secular roots of a merge's active prefix of ``nact`` poles, as
    (anc, tau) (P, nact) (``core.bidiag_dc.secular_plain``)."""
    impl = _impl("dc_secular", backend, config, d.device)
    return impl(d, w, gap, act, d_next, a_next, hidx, nact=nact,
                newton_iters=newton_iters)


def tape_apply(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor, *,
               rows: torch.Tensor | None = None, backend: str = "auto",
               config=None) -> torch.Tensor:
    """Slot-batched compact-WY left apply, per slot s
    ``C[s] <- (I - V[s] T[s] V[s]^T) C[s]``; v (S, m, k), t (S, k, k),
    c (S, m, w).  The chase-tape replay passes k = 1 with t = tau, the
    stage-1 panels k = nb.

    v and c may be strided views whose innermost stride is 1 (the stage-1
    trailing block, the replay's rows below a pivot); t is contiguous.  The
    "cuda" backend updates ``c`` in place and returns it; "ref" returns a
    new tensor.

    With ``rows`` (int32, (spm, m), rows in [0, R)) ``c`` is an accumulator
    (S / spm, R, w): slot s applies to rows ``rows[s % spm]`` of matrix
    ``s // spm``.  Then both backends update the accumulator in place and
    return it: the kernel addresses the rows where they lie, the plain
    version gathers, applies and scatters them."""
    return _impl("tape_apply", backend, config, c.device)(v, t, c, rows=rows)


def hh_block_apply(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor, *,
                   backend: str = "auto", config=None) -> torch.Tensor:
    """``C <- (I - V T V^T) C`` for v (..., m, k), t (..., k, k),
    c (..., m, w): the stage-1 blocked reflector apply, as
    :func:`tape_apply` with the leading axes as slots.  In place on "cuda",
    a new tensor on "ref", as :func:`tape_apply`."""
    return _impl("hh_block_apply", backend, config, c.device)(v, t, c)


def fused_svd(mats: torch.Tensor, *, bw: int, compute_uv: bool = False,
              max_iter: int | None = None, backend: str = "auto",
              config=None):
    """The whole per-matrix SVD of a (B, n, n) stack: sigma (B, n),
    descending, or with ``compute_uv`` ``(d, e, U2, V2^T)`` with
    ``A = U2 B V2^T``.  On a CUDA tensor one launch of the fused kernel;
    on the CPU its plain version."""
    impl = _impl("fused_svd", backend, config, mats.device)
    return impl(mats, bw=bw, compute_uv=compute_uv, max_iter=max_iter)


class _FlashAttention(torch.autograd.Function):
    """Causal flash attention with its gradient: the forward is the
    backend's ``flash_attention`` op, the backward its
    ``flash_attention_bwd`` op on the saved q, k, v and o (on the card the
    kernel that ``flash_attention.bwd_kernel_for`` names; the plain version
    on the CPU or with ``backend="ref"``).  Neither is differentiated by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, backend):
        o = _impl("flash_attention", backend, None, q.device)(q, k, v)
        ctx.backend = backend
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         backend=ctx.backend)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    backend: str = "auto", block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Causal attention of q (BH, S, D) against k, v (BH / g, S, D), query
    row bh reading KV row bh // g (g = 1: the reference's contract), scale
    1/sqrt(D), the result in ``q.dtype``.  On a CUDA tensor one launch of
    the flash kernel that ``flash_attention.kernel_for`` names (the wgmma
    kernel for bf16 and fp16 at D in {64, 128}, else ``flash_attn.cu``); on
    the CPU the plain version.  ``block_q``/``block_k`` are the
    reference's keywords; the kernels' tiles are their own, so both are
    ignored.

    Differentiable: where any input requires grad, the call goes through a
    ``torch.autograd.Function`` whose backward is :func:`flash_attention_bwd`
    of the same backend on the saved q, k, v and output; otherwise nothing
    is saved."""
    del block_q, block_k
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, backend)
    return _impl("flash_attention", backend, None, q.device)(q, k, v)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        backend: str = "auto"):
    """The gradients (dq, dk, dv) of :func:`flash_attention` given its
    output o and the output's gradient do (q's shape): on a CUDA tensor one
    launch (two kernels) of the backward kernel that
    ``flash_attention.bwd_kernel_for`` names (``flash_attn_bwd_wgmma.cu``
    for bf16 and fp16 at D in {64, 128}, else ``flash_attn_bwd.cu``), on
    the CPU the plain version ``ref.flash_attention_bwd_ref``.  dk and dv are summed over the
    g query rows of each KV row."""
    return _impl("flash_attention_bwd", backend, None, q.device)(q, k, v, o,
                                                                 do)


def _launch_tables():
    from repro_torch.kernels import (bisect, bulge_chase, dc,
                                     flash_attention, fused_small, hh_apply)
    return (bulge_chase.launches, bisect.launches, hh_apply.launches,
            fused_small.launches, flash_attention.launches, dc.launches)


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel since the last reset."""
    return {k: v for counts in _launch_tables() for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _launch_tables():
        for key in counts:
            counts[key] = 0
