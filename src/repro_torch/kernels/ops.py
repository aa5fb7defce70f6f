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

from repro_torch.core.tuning import LATER

__all__ = ["chase_cycle", "sturm_bisect", "tape_apply", "hh_block_apply",
           "fused_svd", "flash_attention", "register_backend", "check_device",
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
    if backend in LATER:
        raise NotImplementedError(LATER[backend])
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


def _ref_bisect(z, bound, *, n, max_iter):
    from repro_torch.core.bidiag_svd import bisect_plain
    return bisect_plain(z, bound, n=n, max_iter=max_iter)


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


register_backend("ref", chase_cycle=_ref_chase, sturm_bisect=_ref_bisect,
                 tape_apply=_ref_tape, hh_block_apply=_ref_hh,
                 fused_svd=_ref_fused, flash_attention=_ref_flash)


# ---- "cuda": the Hopper kernels (built on first use) ----------------------

def _cuda_chase(windows, is_first, *, b_in, tw, with_tape, fuse, active):
    from repro_torch.kernels import bulge_chase
    if fuse == 1:
        return bulge_chase.chase_cycle_cuda(windows, is_first, b_in=b_in,
                                            tw=tw, with_tape=with_tape)
    return bulge_chase.chase_superstep_cuda(windows, is_first, active,
                                            b_in=b_in, tw=tw, fuse=fuse,
                                            with_tape=with_tape)


def _cuda_bisect(z, bound, *, n, max_iter):
    from repro_torch.kernels import bisect
    return bisect.sturm_bisect_cuda(z, bound, n=n, max_iter=max_iter)


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


register_backend("cuda", chase_cycle=_cuda_chase, sturm_bisect=_cuda_bisect,
                 tape_apply=_cuda_tape, hh_block_apply=_cuda_hh,
                 fused_svd=_cuda_fused, flash_attention=_cuda_flash)


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


def sturm_bisect(z: torch.Tensor, bound: torch.Tensor, *, n: int,
                 max_iter: int, backend: str = "auto", config=None):
    """Singular values (B, n), descending, of prescaled bidiagonals given by
    their Golub–Kahan off-diagonals ``z`` (B, 2n-1) and bounds (B,)."""
    impl = _impl("sturm_bisect", backend, config, z.device)
    return impl(z, bound, n=n, max_iter=max_iter)


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
    ignored."""
    del block_q, block_k
    return _impl("flash_attention", backend, None, q.device)(q, k, v)


def _launch_tables():
    from repro_torch.kernels import (bisect, bulge_chase, flash_attention,
                                     fused_small, hh_apply)
    return (bulge_chase.launches, bisect.launches, hh_apply.launches,
            fused_small.launches, flash_attention.launches)


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel since the last reset."""
    return {k: v for counts in _launch_tables() for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _launch_tables():
        for key in counts:
            counts[key] = 0
