"""Wrappers of the CUDA chase kernels (``csrc/chase.cu``).

``chase_cycle_cuda`` takes the contract of the reference's
``chase_cycle_pallas``: G disjoint rolled windows (G, H, W), updated in
place, plus ``is_first`` (G,).  ``chase_superstep_cuda`` takes that of
``chase_superstep_pallas``: G contiguous band blocks (G, H, K*b_in + tw + 1)
updated in place, ``is_first`` (G,) and the ``active`` (G, K) prefix mask.
With ``with_tape`` both also return the reflector tape.

A stage on the padded band runs in place through :class:`BandStage`: it
checks the stage's band, tables and tape once, makes the kernels' plan
(for fuse 1 the tensor map of the one-cycle TMA kernel) and looks up the
stream once, so that a (super-)cycle is one launch through one ``ctypes``
call of three arguments.  ``chase_cycle_band_cuda`` and
``chase_superstep_band_cuda`` run one (super-)cycle of a stage that way.

A wrapper takes CUDA tensors only: it launches its kernel or raises, and
counts each launch in ``launches`` (both cycle entries under
``chase_cycle_cuda``, both super-step entries under
``chase_superstep_cuda``).  The plain versions (``kernels/ref.py``) are
chosen for CPU tensors by ``kernels/ops.py``, not here.  The library is
built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.kernels import _build

__all__ = ["chase_cycle_cuda", "chase_superstep_cuda", "BandStage",
           "chase_cycle_band_cuda", "chase_superstep_band_cuda", "launches"]

launches = {"chase_cycle_cuda": 0, "chase_superstep_cuda": 0}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "chase_cycle": [_P, _P, _I, _I, _I, _P, _P, _I, _P],
    "chase_superstep": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "chase_band_plan": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _I],
    "chase_band_run": [_P, _I, _P],
}


_FNS: dict = {}


def _fn(base: str, dtype: torch.dtype, lib=None):
    """The C function ``<base>_<dtype suffix>`` of the built library, or of
    ``lib`` (a copy of ``chase.cu`` built elsewhere)."""
    f = _FNS.get((base, dtype)) if lib is None else None
    if f is None:
        f = getattr(lib or _build.load("chase"), f"{base}_{_SUFFIX[dtype]}")
        f.argtypes = _ARGTYPES[base]
        f.restype = ctypes.c_int
        if lib is None:
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


class BandStage:
    """The (super-)cycles of one stage on the padded band, in place.

    bandp (B, H, n_pad) contiguous; p_safe (T, G) int32, first (T, B*G) and
    live (T, G, K) bool (``bulge_chasing._cycle_table``); tape None or
    ``(vs (B, T, G, K, 2, tw+1), taus (B, T, G, K, 2))`` of bandp's dtype.
    Everything is checked here, once; the tensors must not move or be
    freed while the stage runs.  ``stage(t)`` runs (super-)cycle t: slot
    (b, g) chases band b's columns from ``p_safe[t, g]`` through K =
    ``fuse`` cycles, cycle i only where ``live[t, g, i]``, and writes the
    reflector pairs of row t of the tape, tau = 0 where not live.  One
    launch over B*G slots on the stream current when the stage was made.

    At fuse 1 the launch is the one-cycle kernel, moving each slot's band
    rectangle by TMA (``route == "tma"``), where ``tuning.cycle_tile`` takes
    the shape and the band's rows start on 16-byte boundaries
    (``tuning.band_padding``); otherwise, and at fuse K, the super-step
    kernel (``route == "panels"``), whose moves walk the panels' cells.
    Both give the same bits; ``tma=False`` takes the super-step kernel at
    fuse 1 too (to time and hold one against the other).  The slots'
    blocks must be pairwise disjoint in band columns (``ops.band_stage``
    checks the schedule).  ``lib``: a copy of ``chase.cu`` built
    elsewhere, in place of the package's.  Use it as a context manager to
    make bandp's card the current one."""

    def __init__(self, bandp: torch.Tensor, p_safe: torch.Tensor,
                 first: torch.Tensor, live: torch.Tensor, *, b_in: int,
                 tw: int, fuse: int, tape=None, lib=None, tma: bool = True):
        b, h, n_pad = bandp.shape
        T, g = p_safe.shape
        ln = tw + 1
        dt = bandp.dtype
        _check_band(bandp, "bandp", (b, b_in + 2 * tw + 1, n_pad))
        _check(p_safe, "p_safe", (T, g), torch.int32)
        _check(first, "first", (T, b * g), torch.bool)
        _check(live, "live", (T, g, fuse), torch.bool)
        vp = tp = None
        if tape is not None:
            _check(tape[0], "tape v", (b, T, g, fuse, 2, ln), dt)
            _check(tape[1], "tape tau", (b, T, g, fuse, 2), dt)
            vp, tp = tape[0].data_ptr(), tape[1].data_ptr()
        smem = tuning.check_smem_budget(b_in, tw, dt, fuse)
        tile = tuning.cycle_tile(b_in, tw, dt) if fuse == 1 and tma else None
        if tile is not None and (n_pad * bandp.element_size() % 16
                                 or bandp.data_ptr() % 16):
            tile = None
        self.route = "panels" if tile is None else "tma"
        box_w, tile_smem = tile or (0, 0)
        size = (lib or _build.load("chase")).chase_band_plan_size()
        self._buf = ctypes.create_string_buffer(size)
        self._plan = ctypes.addressof(self._buf)
        err = _fn("chase_band_plan", dt, lib)(
            self._plan, bandp.data_ptr(), b, n_pad, p_safe.data_ptr(), T, g,
            first.data_ptr(), live.data_ptr(), vp, tp, b_in, tw, fuse, smem,
            tile_smem, box_w)
        _raise_on(err, "chase band plan")
        self._run = _fn("chase_band_run", dt, lib)
        self._stream = torch.cuda.current_stream(bandp.device).cuda_stream
        self._device = torch.cuda.device(bandp.device)
        self._key = "chase_cycle_cuda" if fuse == 1 else "chase_superstep_cuda"
        self._tensors = (bandp, p_safe, first, live, tape)
        self.cycles = T

    def __call__(self, t: int) -> None:
        err = self._run(self._plan, t, self._stream)
        if err:
            raise RuntimeError(f"{self._key} band entry, cycle {t}: CUDA "
                               f"error {err}")
        launches[self._key] += 1

    def __enter__(self) -> "BandStage":
        self._device.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._device.__exit__(*exc)


def chase_cycle_band_cuda(bandp: torch.Tensor, p_safe: torch.Tensor,
                          first: torch.Tensor, live: torch.Tensor, t: int, *,
                          b_in: int, tw: int, tape=None) -> torch.Tensor:
    """Cycle ``t`` of one fuse-1 stage on the padded band, in place, as
    :class:`BandStage` runs it (live (T, G, 1), the tape's K axis 1).  One
    launch; returns ``bandp``.  The slots' windows must be pairwise
    disjoint (``ops.chase_cycle_band`` checks the schedule)."""
    with BandStage(bandp, p_safe, first, live, b_in=b_in, tw=tw, fuse=1,
                   tape=tape) as stage:
        stage(t)
    return bandp


def chase_superstep_band_cuda(bandp: torch.Tensor, p_safe: torch.Tensor,
                              first: torch.Tensor, live: torch.Tensor,
                              t: int, *, b_in: int, tw: int, fuse: int,
                              tape=None) -> torch.Tensor:
    """Super-cycle ``t`` of one stage on the padded band, in place, as
    :class:`BandStage` runs it.  One launch over B*G slots; returns
    ``bandp``.  The blocks must be pairwise disjoint in band columns
    (``ops.chase_superstep_band`` checks the schedule)."""
    with BandStage(bandp, p_safe, first, live, b_in=b_in, tw=tw, fuse=fuse,
                   tape=tape) as stage:
        stage(t)
    return bandp
