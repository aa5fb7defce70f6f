"""Wrapper of the CUDA Sturm-bisection kernels (``csrc/sturm.cu``).

``sturm_bisect_cuda`` takes the prescaled Golub–Kahan off-diagonal
``z (B, 2n-1)`` and the Gershgorin bound ``(B,)``, both in the accumulation
type (float64 or float32), and returns the B rows of singular values of the
prescaled problem, descending.  The prescale and the bound are computed by
the caller (``core/bidiag_svd.py``) with torch ops.

The bisection runs as ``schedule`` lays it out: the top d levels of the
bisection tree counted once per matrix, then the other levels s at a time
over groups of 2^s lanes, s chosen from B*n.  Every midpoint is the one
the sequential bisection makes, so the result is bit for bit the plain
version's.

It takes CUDA tensors only: it launches the kernels or raises, and counts
the call in ``launches``.  The plain version
``core.bidiag_svd.bisect_plain`` is chosen for CPU tensors by
``kernels/ops.py``, not here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

__all__ = ["sturm_bisect_cuda", "schedule", "launches"]

launches = {"sturm_bisect_cuda": 0}

_SYMBOL = {torch.float64: ("sturm_bisect_f64", ctypes.c_double),
           torch.float32: ("sturm_bisect_f32", ctypes.c_float)}
_FNS: dict = {}
# warps per SM at which the count loop stops hiding its latency and turns
# throughput-bound (about 16-18 for fp32 and fp64 on an H100 80GB HBM3 at
# 700 W, from the kernels' times per round at a few warps and at about 31
# warps per SM), and the card's SMs
_WARPS_AT_THROUGHPUT = 16
_SMS = 132


def _fn(dtype: torch.dtype, lib=None):
    """The C function of the built library for ``dtype``, or of ``lib`` (a
    copy of ``sturm.cu`` built elsewhere)."""
    f = _FNS.get(dtype) if lib is None else None
    if f is None:
        name, real = _SYMBOL[dtype]
        f = getattr(lib or _build.load("sturm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, i, i, i, i, i, real, p]
        f.restype = ctypes.c_int
        if lib is None:
            _FNS[dtype] = f
    return f


def schedule(b: int, n: int, max_iter: int) -> tuple[int, int]:
    """(d, s) of the kernels for B = ``b`` matrices of size n: the levels
    of the tree counted once per matrix, d = min(floor(log2 n), max_iter),
    and the levels a group of 2^s lanes counts at once after them, s in [0,
    5].  A round of s levels takes one chain of counts while the SMs hold
    fewer than ``_WARPS_AT_THROUGHPUT`` warps each, and proportionally
    longer above; s minimises rounds times that factor (the smaller s on a
    tie).  s = 1 never wins: it counts one node per round, as s = 0 does,
    on twice the lanes."""
    d = min(n.bit_length() - 1, max_iter)
    rest = max_iter - d

    def cost(s):
        rounds = -(-rest // max(s, 1))
        warps = b * n * 2 ** s / 32 / _SMS
        return rounds * max(1.0, warps / _WARPS_AT_THROUGHPUT)

    return d, min(range(6), key=lambda s: (cost(s), s))


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
    if b:
        d, s = schedule(b, n, max_iter)
        counts = torch.empty((b, 1 << d), dtype=torch.int32, device=z.device)
        tiny = float(torch.finfo(z.dtype).tiny) * 4
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(z.dtype)(z.data_ptr(), bound.data_ptr(),
                               counts.data_ptr(), out.data_ptr(), b, n,
                               max_iter, d, s, tiny, stream)
        if err != 0:
            raise RuntimeError(f"sturm_bisect_cuda: CUDA error {err}")
        _build.count_launch(launches, "sturm_bisect_cuda")
    return out
