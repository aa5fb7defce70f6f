"""Wrappers of the divide-and-conquer kernels (``csrc/dc.cu``).

``dc_leaf_cuda``, ``dc_deflate_cuda`` and ``dc_secular_cuda`` run the
leaves, the Givens deflation scan and the secular root solve of
``core/bidiag_dc.py`` on the card, in the accumulation type (float64 or
float32).  Their plain versions are ``bidiag_dc.leaf_eigen_plain``,
``deflate_plain`` and ``secular_plain``: the leaf eigenvalues and the
deflation agree with them bit for bit, the eigenvector rows and the roots
within rounding.

They take CUDA tensors only: each launches its kernel or raises, and counts
the launch in ``launches``.  The plain versions are chosen for CPU tensors
by ``kernels/ops.py``, not here.

The leaves bisect on the Sturm kernels' schedule (``leaf_schedule``: the
tree's top counted once per leaf, then s levels a round over groups of
2^s lanes), so their eigenvalues keep the plain version's midpoints.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build, bisect

__all__ = ["dc_leaf_cuda", "dc_deflate_cuda", "dc_secular_cuda",
           "leaf_schedule", "launches"]

launches = {"dc_leaf_cuda": 0, "dc_deflate_cuda": 0, "dc_secular_cuda": 0}

_SUFFIX = {torch.float64: ("f64", ctypes.c_double),
           torch.float32: ("f32", ctypes.c_float)}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {"leaf": lambda real: [_P] * 10 + [_I] * 7 + [real, real, _I, _P],
         "deflate": lambda real: [_P] * 8 + [_I] * 3 + [_P],
         "secular": lambda real: [_P] * 9 + [_I] * 7 + [_P]}
_FNS: dict = {}


def _fn(kind: str, dtype: torch.dtype):
    f = _FNS.get((kind, dtype))
    if f is None:
        suffix, real = _SUFFIX[dtype]
        f = getattr(_build.load("dc"), f"dc_{kind}_{suffix}")
        f.argtypes = _ARGS[kind](real)
        f.restype = ctypes.c_int
        _FNS[(kind, dtype)] = f
    return f


def _check(name: str, ref: torch.Tensor, **tensors) -> None:
    """CUDA, a dtype the kernels take, and every tensor contiguous on
    ``ref``'s device; the shapes are checked by the callers."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: a CUDA tensor is required, got "
                         f"{ref.device}")
    if ref.dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {ref.dtype} not in {tuple(_SUFFIX)}")
    for key, t in tensors.items():
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on "
                             f"{ref.device}")


def _call(name: str, kind: str, dtype: torch.dtype, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(kind, dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    _build.count_launch(launches, name)


def leaf_schedule(p: int, lm: int, bisect_iters: int) -> tuple[int, int]:
    """(d, s) of the leaf kernel's bisection for P leaves of lm rows: the
    Sturm kernels' ``bisect.schedule`` for P problems of lm indices, s
    capped so that a block's lm 2^s threads stay within
    ``tuning.DC_LEAF_THREADS``."""
    cap = max(0, (tuning.DC_LEAF_THREADS // lm).bit_length() - 1)
    return bisect.schedule(p, lm, bisect_iters, max_s=cap)


def dc_leaf_cuda(a: torch.Tensor, b: torch.Tensor, lo0: torch.Tensor,
                 hi0: torch.Tensor, ctol: torch.Tensor, x0: torch.Tensor, *,
                 bisect_iters: int, inv_iters: int):
    """(lam, f, l), each (P, lm), of P leaves: one block a leaf; the
    bisection over the block's lm 2^s threads (``leaf_schedule``), then one
    thread a vector, then the Gram-Schmidt one warp a cluster run
    (``bidiag_dc.leaf_eigen_plain``).  The factors of each vector's shift
    (multipliers and reciprocal pivots) go to a (2, P, lm, lm) scratch
    allocated here."""
    name = "dc_leaf_cuda"
    _check(name, a, a=a, b=b, lo0=lo0, hi0=hi0, ctol=ctol, x0=x0)
    p, lm = a.shape
    if (lm % 2 or tuple(b.shape) != (p, lm - 1)
            or tuple(x0.shape) != (lm, lm)
            or any(tuple(x.shape) != (p,) for x in (lo0, hi0, ctol))
            or any(x.dtype != a.dtype for x in (b, lo0, hi0, ctol, x0))):
        raise ValueError(f"{name}: a (P, lm) with lm even, b (P, lm-1), "
                         f"lo0, hi0, ctol (P,) and x0 (lm, lm), all of a's "
                         f"dtype")
    if bisect_iters < 0 or inv_iters < 0:
        raise ValueError(f"{name}: iteration counts must be >= 0")
    smem = tuning.check_dc_leaf_budget(lm // 2, a.dtype)
    lam, f, l = (a.new_empty((p, lm)) for _ in range(3))
    if p:
        fi = torch.finfo(a.dtype)
        scratch = a.new_empty((2, p, lm, lm))
        d, s = leaf_schedule(p, lm, bisect_iters)
        _call(name, "leaf", a.dtype, a.device, a.data_ptr(), b.data_ptr(),
              lo0.data_ptr(), hi0.data_ptr(), ctol.data_ptr(),
              x0.data_ptr(), lam.data_ptr(), f.data_ptr(), l.data_ptr(),
              scratch.data_ptr(), p, lm, d, s, bisect_iters, inv_iters,
              tuning.DC_FALLBACK_ITERS, fi.tiny * 4, fi.tiny, smem)
    return lam, f, l


def dc_deflate_cuda(d: torch.Tensor, z: torch.Tensor, fe: torch.Tensor,
                    le: torch.Tensor, active: torch.Tensor,
                    tol: torch.Tensor):
    """The Givens deflation scan of P subproblems, in place on d, z, fe, le
    (P, m) and the bool ``active`` (P, m), tol (P,); returns them, bit for
    bit ``bidiag_dc.deflate_plain``.  One block a subproblem, its steps in
    chunks run side by side and repaired where a merge run crosses a
    chunk's start (``tuning.dc_deflate_schedule``); the outputs go through
    a scratch copy allocated here."""
    name = "dc_deflate_cuda"
    _check(name, d, d=d, z=z, fe=fe, le=le, active=active, tol=tol)
    p, m = d.shape
    if (any(tuple(x.shape) != (p, m) for x in (z, fe, le, active))
            or tuple(tol.shape) != (p,) or active.dtype != torch.bool
            or any(x.dtype != d.dtype for x in (z, fe, le, tol))):
        raise ValueError(f"{name}: d, z, fe, le (P, m) of one dtype, active "
                         f"(P, m) bool and tol (P,)")
    if p and m:
        scratch = d.new_empty((4, p, m))
        sact = torch.empty((p, m), dtype=torch.uint8, device=d.device)
        _call(name, "deflate", d.dtype, d.device, d.data_ptr(), z.data_ptr(),
              fe.data_ptr(), le.data_ptr(), active.data_ptr(),
              tol.data_ptr(), scratch.data_ptr(), sact.data_ptr(), p, m,
              tuning.DC_DEFLATE_CHUNK)
    return d, z, fe, le, active


def dc_secular_cuda(d: torch.Tensor, w: torch.Tensor, gap: torch.Tensor,
                    act: torch.Tensor, d_next: torch.Tensor,
                    a_next: torch.Tensor, hidx: torch.Tensor, *, nact: int,
                    newton_iters: int):
    """(anc, tau) (P, nact): the secular roots of the active prefix, one
    warp a root (``bidiag_dc.secular_plain``)."""
    name = "dc_secular_cuda"
    _check(name, d, d=d, w=w, gap=gap, act=act, d_next=d_next,
           a_next=a_next, hidx=hidx)
    p, m = d.shape
    kh = hidx.shape[-1] if hidx.dim() == 2 else -1
    if (any(tuple(x.shape) != (p, m) for x in (w, gap, act, d_next, a_next))
            or any(x.dtype != d.dtype for x in (w, gap, d_next))
            or act.dtype != torch.bool or a_next.dtype != torch.bool
            or hidx.dtype != torch.int64 or tuple(hidx.shape) != (p, kh)
            or not 0 <= nact <= m or kh != min(32, nact)):
        raise ValueError(f"{name}: d, w, gap, d_next (P, m), act, a_next "
                         f"(P, m) bool, hidx (P, min(32, nact)) int64, "
                         f"0 <= nact <= m")
    anc, tau = d.new_empty((p, nact)), d.new_empty((p, nact))
    if p and nact:
        _call(name, "secular", d.dtype, d.device, d.data_ptr(), w.data_ptr(),
              gap.data_ptr(), act.data_ptr(), d_next.data_ptr(),
              a_next.data_ptr(), hidx.data_ptr(), anc.data_ptr(),
              tau.data_ptr(), p, m, nact, kh, min(tuning.DC_WINDOW_K, m),
              newton_iters, tuning.DC_POLISH_ITERS)
    return anc, tau
