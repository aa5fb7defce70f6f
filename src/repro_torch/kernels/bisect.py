"""Wrapper of the CUDA Sturm-bisection kernel (``csrc/sturm.cu``).

``sturm_bisect_cuda`` takes the prescaled Golub–Kahan off-diagonal
``z (B, 2n-1)`` and the Gershgorin bound ``(B,)``, both in the accumulation
type (float64 or float32), and returns the B rows of singular values of the
prescaled problem, descending.  The prescale and the bound are computed by
the caller (``core/bidiag_svd.py``) with torch ops.

It takes CUDA tensors only: it launches the kernel or raises, and counts
the launch in ``launches``.  The plain version
``core.bidiag_svd.bisect_plain`` is chosen for CPU tensors by
``kernels/ops.py``, not here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["sturm_bisect_cuda", "launches"]

launches = {"sturm_bisect_cuda": 0}

_SYMBOL = {torch.float64: ("sturm_bisect_f64", ctypes.c_double),
           torch.float32: ("sturm_bisect_f32", ctypes.c_float)}
_FNS: dict = {}


def _fn(dtype: torch.dtype):
    f = _FNS.get(dtype)
    if f is None:
        name, real = _SYMBOL[dtype]
        f = getattr(_build.load("sturm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, i, i, i, real, p]
        f.restype = ctypes.c_int
        _FNS[dtype] = f
    return f


def sturm_bisect_cuda(z: torch.Tensor, bound: torch.Tensor, *, n: int,
                      max_iter: int) -> torch.Tensor:
    """Singular values (B, n), descending, of the prescaled bidiagonals whose
    Golub–Kahan off-diagonals are the rows of ``z`` (B, 2n-1)."""
    if z.device.type != "cuda":
        raise ValueError(f"z must be a CUDA tensor, got {z.device}")
    if z.dtype not in _SYMBOL:
        raise ValueError(f"z: dtype {z.dtype} not in {tuple(_SYMBOL)}")
    if z.dim() != 2 or z.shape[1] != 2 * n - 1 or not z.is_contiguous():
        raise ValueError(f"z must be contiguous (B, {2 * n - 1}), got "
                         f"{tuple(z.shape)}")
    b = z.shape[0]
    if (bound.device != z.device or bound.dtype != z.dtype
            or tuple(bound.shape) != (b,) or not bound.is_contiguous()):
        raise ValueError("bound must be a contiguous (B,) tensor on z's "
                         "device and of z's dtype")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    out = z.new_empty((b, n))
    if b * n:
        tiny = float(torch.finfo(z.dtype).tiny) * 4
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(z.dtype)(z.data_ptr(), bound.data_ptr(), out.data_ptr(),
                               b, n, max_iter, tiny, stream)
        if err != 0:
            raise RuntimeError(f"sturm_bisect_cuda: CUDA error {err}")
        launches["sturm_bisect_cuda"] += 1
    return out
