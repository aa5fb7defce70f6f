"""Wrappers of the CUDA chase kernels (``csrc/chase.cu``).

``chase_cycle_cuda`` takes the contract of the reference's
``chase_cycle_pallas``: G disjoint rolled windows (G, H, W), updated in
place, plus ``is_first`` (G,).  ``chase_superstep_cuda`` takes that of
``chase_superstep_pallas``: G contiguous band blocks (G, H, K*b_in + tw + 1)
updated in place, ``is_first`` (G,) and the ``active`` (G, K) prefix mask.
With ``with_tape`` both also return the reflector tape.
``chase_superstep_band_cuda`` launches the same super-step kernel on one
super-cycle of a stage, on the padded band in place: each slot addresses
its block where it lies and writes its reflectors into the stage's tape.

A wrapper takes CUDA tensors only: it launches its kernel or raises, and
counts each launch in ``launches`` (both super-step entries under
``chase_superstep_cuda``).  The plain versions (``kernels/ref.py``)
are chosen for CPU tensors by ``kernels/ops.py``, not here.  The library is
built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

__all__ = ["chase_cycle_cuda", "chase_superstep_cuda",
           "chase_superstep_band_cuda", "band_args", "launches"]

launches = {"chase_cycle_cuda": 0, "chase_superstep_cuda": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "chase_cycle": [_P, _P, _I, _I, _I, _P, _P, _I, _P],
    "chase_superstep": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "chase_superstep_band": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _LL, _I, _I,
                             _I, _I, _P],
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


def band_args(bandp: torch.Tensor, p_safe: torch.Tensor, first: torch.Tensor,
              live: torch.Tensor, t: int, *, b_in: int, tw: int, fuse: int,
              tape=None) -> tuple:
    """The arguments of ``chase_superstep_band_<dtype>`` (``csrc/chase.cu``)
    for super-cycle ``t``: pointers to row t of the stage's tables and of
    its tape, no copy.  Checks what the kernel takes and raises otherwise.

    bandp (B, H, n_pad) contiguous; p_safe (T, G) int32; first (T, B*G) and
    live (T, G, K) bool; tape None or ``(vs (B, T, G, K, 2, tw+1), taus (B,
    T, G, K, 2))`` of bandp's dtype."""
    b, h, n_pad = bandp.shape
    T, g = p_safe.shape
    ln = tw + 1
    _check_band(bandp, "bandp", (b, b_in + 2 * tw + 1, n_pad))
    _check(p_safe, "p_safe", (T, g), torch.int32)
    _check(first, "first", (T, b * g), torch.bool)
    _check(live, "live", (T, g, fuse), torch.bool)
    if not 0 <= t < T:
        raise ValueError(f"super-cycle {t} outside [0, {T})")
    vp = tp = None
    if tape is not None:
        _check(tape[0], "tape v", (b, T, g, fuse, 2, ln), bandp.dtype)
        _check(tape[1], "tape tau", (b, T, g, fuse, 2), bandp.dtype)
        row = t * g * fuse                     # pairs before row t of a band
        vp = tape[0].data_ptr() + row * 2 * ln * bandp.element_size()
        tp = tape[1].data_ptr() + row * 2 * bandp.element_size()
    smem = tuning.check_smem_budget(b_in, tw, bandp.dtype, fuse)
    return (bandp.data_ptr(), b, n_pad, p_safe.data_ptr() + t * g * 4, g,
            first.data_ptr() + t * b * g, live.data_ptr() + t * g * fuse,
            vp, tp, T * g * fuse, b_in, tw, fuse, smem)


def chase_superstep_band_cuda(bandp: torch.Tensor, p_safe: torch.Tensor,
                              first: torch.Tensor, live: torch.Tensor,
                              t: int, *, b_in: int, tw: int, fuse: int,
                              tape=None) -> torch.Tensor:
    """Super-cycle ``t`` of one stage on the padded band, in place: slot
    (b, g) chases band b's columns ``[p_safe[t, g], + fuse*b_in + tw + 1)``
    through K = ``fuse`` cycles, cycle i only where ``live[t, g, i]``.
    With ``tape`` it writes the reflector pairs of row t, tau = 0 where not
    live.  One launch over B*G slots; returns ``bandp``.  The blocks must
    be pairwise disjoint in band columns (``ops.chase_superstep_band``
    checks the schedule)."""
    args = band_args(bandp, p_safe, first, live, t, b_in=b_in, tw=tw,
                     fuse=fuse, tape=tape)
    with torch.cuda.device(bandp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("chase_superstep_band", bandp.dtype)(*args, stream)
    _raise_on(err, "chase_superstep_band_cuda")
    launches["chase_superstep_cuda"] += 1
    return bandp
