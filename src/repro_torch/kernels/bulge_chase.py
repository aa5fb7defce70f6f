"""Wrappers of the CUDA chase kernels (``csrc/chase.cu``).

``chase_cycle_cuda`` takes the contract of the reference's
``chase_cycle_pallas``: G disjoint rolled windows (G, H, W), updated in
place, plus ``is_first`` (G,).  ``chase_superstep_cuda`` takes that of
``chase_superstep_pallas``: G contiguous band blocks (G, H, K*b_in + tw + 1)
updated in place, ``is_first`` (G,) and the ``active`` (G, K) prefix mask.
With ``with_tape`` both also return the reflector tape.

A wrapper takes CUDA tensors only: it launches its kernel or raises, and
counts each launch in ``launches``.  The plain versions (``kernels/ref.py``)
are chosen for CPU tensors by ``kernels/ops.py``, not here.  The library is
built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

__all__ = ["chase_cycle_cuda", "chase_superstep_cuda", "launches"]

launches = {"chase_cycle_cuda": 0, "chase_superstep_cuda": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "chase_cycle": [_P, _P, _I, _I, _I, _P, _P, _I, _P],
    "chase_superstep": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
}


_FNS: dict = {}


def _fn(base: str, dtype: torch.dtype):
    f = _FNS.get((base, dtype))
    if f is None:
        f = getattr(_build.load("chase"), f"{base}_{_SUFFIX[dtype]}")
        f.argtypes = _ARGTYPES[base]
        f.restype = ctypes.c_int
        _FNS[(base, dtype)] = f
    return f


def _check(x: torch.Tensor, name: str, shape, dtype=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(x: torch.Tensor, name: str, shape):
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {x.dtype} not in {tuple(_SUFFIX)}")
    _check(x, name, shape)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def chase_cycle_cuda(windows: torch.Tensor, is_first: torch.Tensor, *,
                     b_in: int, tw: int, with_tape: bool = False):
    """One chase cycle on each of G windows (G, H, W), in place.

    Returns ``windows``; with ``with_tape`` ``(windows, vs (G, 2, tw+1),
    taus (G, 2))``."""
    g = windows.shape[0]
    h, w, ln = b_in + 2 * tw + 1, b_in + tw + 1, tw + 1
    _check_band(windows, "windows", (g, h, w))
    _check(is_first, "is_first", (g,), torch.bool)
    smem = tuning.check_smem_budget(b_in, tw, windows.dtype)
    vs = taus = None
    if with_tape:
        vs = windows.new_empty((g, 2, ln))
        taus = windows.new_empty((g, 2))
    if g:
        with torch.cuda.device(windows.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn("chase_cycle", windows.dtype)(
                windows.data_ptr(), is_first.data_ptr(), g, b_in, tw,
                vs.data_ptr() if with_tape else None,
                taus.data_ptr() if with_tape else None, smem, stream)
        _raise_on(err, "chase_cycle_cuda")
        launches["chase_cycle_cuda"] += 1
    return (windows, vs, taus) if with_tape else windows


def chase_superstep_cuda(blocks: torch.Tensor, is_first: torch.Tensor,
                         active: torch.Tensor, *, b_in: int, tw: int,
                         fuse: int, with_tape: bool = False):
    """K = ``fuse`` chase cycles on each of G band blocks
    (G, H, K*b_in + tw + 1), in place.

    Returns ``blocks``; with ``with_tape`` ``(blocks, vs (G, K, 2, tw+1),
    taus (G, K, 2))``."""
    g = blocks.shape[0]
    h, wk, ln = b_in + 2 * tw + 1, fuse * b_in + tw + 1, tw + 1
    _check_band(blocks, "blocks", (g, h, wk))
    _check(is_first, "is_first", (g,), torch.bool)
    _check(active, "active", (g, fuse), torch.bool)
    smem = tuning.check_smem_budget(b_in, tw, blocks.dtype, fuse)
    vs = taus = None
    if with_tape:
        vs = blocks.new_empty((g, fuse, 2, ln))
        taus = blocks.new_empty((g, fuse, 2))
    if g:
        with torch.cuda.device(blocks.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn("chase_superstep", blocks.dtype)(
                blocks.data_ptr(), is_first.data_ptr(), active.data_ptr(), g,
                b_in, tw, fuse, vs.data_ptr() if with_tape else None,
                taus.data_ptr() if with_tape else None, smem, stream)
        _raise_on(err, "chase_superstep_cuda")
        launches["chase_superstep_cuda"] += 1
    return (blocks, vs, taus) if with_tape else blocks
