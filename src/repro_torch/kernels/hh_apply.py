"""Wrapper of the CUDA compact-WY apply kernel (``csrc/hh_apply.cu``).

``tape_apply_cuda`` takes the contract of the reference's
``tape_apply_pallas``: per slot s, ``C[s] <- C[s] - V[s] T[s] V[s]^T C[s]``
with v (S, m, k), t (S, k, k), c (S, m, w), all of one dtype (float64,
float32 or bfloat16).  It updates ``c`` in place and returns it.
``hh_block_apply_cuda`` is its view for (..., m, k) blocks, whose leading
axes become the slots: one slot for a single problem, as
``hh_block_apply_pallas`` is in the reference, and B slots for the stage-1
trailing update of a batch.

The wrapper takes CUDA tensors only: it launches the kernel or raises, and
counts each launch in ``launches``.  The plain versions
(``kernels/ref.py``) are chosen for CPU tensors by ``kernels/ops.py``, not
here.  The library is built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.householder import acc_dtype
from repro_torch.core.tuning import SMEM_PER_BLOCK
from repro_torch.kernels import _build
from repro_torch.kernels.bulge_chase import _check

__all__ = ["tape_apply_cuda", "hh_block_apply_cuda", "launch_shape",
           "launches", "MAX_K"]

launches = {"tape_apply_cuda": 0}

THREADS = 256
ROWS_PER_THREAD = 8
MAX_K = 128                       # k * stripe <= 4096 with a stripe >= 32
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_FNS: dict = {}


def _fn(dtype: torch.dtype):
    f = _FNS.get(dtype)
    if f is None:
        f = getattr(_build.load("hh_apply"), f"tape_apply_{_SUFFIX[dtype]}")
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, i, i, i, i, i, i, p]
        f.restype = ctypes.c_int
        _FNS[dtype] = f
    return f


def launch_shape(s: int, k: int, w: int, dtype, sms: int = 132
                 ) -> tuple[int, int]:
    """(stripe width, shared-memory bytes) of one launch.

    The widest stripe in {256, 128, 64, 32} with ``k * stripe <= 4096``,
    narrowed while the grid has fewer than two blocks per SM.  The block
    holds a V tile (TM, k), a C tile (TM, stripe) and W (k, stripe) in the
    accumulation type, TM = 8 * 256 / stripe rows.  Raises when k or the
    shared memory is more than the kernel takes."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"tape_apply_cuda takes 1 <= k <= {MAX_K}, got "
                         f"k={k}")
    bc = 256
    while k * bc > 4096:
        bc //= 2
    while bc > 32 and s * -(-w // bc) < 2 * sms:
        bc //= 2
    tm = ROWS_PER_THREAD * THREADS // bc
    words = tm * k + tm * bc + k * bc
    smem = words * torch.empty((), dtype=acc_dtype(dtype)).element_size()
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"tape_apply_cuda at k={k} needs {smem} B of shared "
                         f"memory per block; the H100 gives {SMEM_PER_BLOCK}")
    return bc, smem


def tape_apply_cuda(v: torch.Tensor, t: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Per slot s, ``C[s] <- C[s] - V[s] (T[s] (V[s]^T C[s]))``, in place
    on ``c``; returns ``c``."""
    if c.dtype not in _SUFFIX:
        raise ValueError(f"c: dtype {c.dtype} not in {tuple(_SUFFIX)}")
    if c.dim() != 3 or v.dim() != 3:
        raise ValueError(f"v and c must be (S, m, k) and (S, m, w), got "
                         f"{tuple(v.shape)} and {tuple(c.shape)}")
    s, m, w = c.shape
    k = v.shape[-1]
    _check(c, "c", (s, m, w))
    _check(v, "v", (s, m, k), c.dtype)
    _check(t, "t", (s, k, k), c.dtype)
    dev = c.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bc, smem = launch_shape(s, k, w, c.dtype, sms)
    if s * m * w:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(c.dtype)(v.data_ptr(), t.data_ptr(), c.data_ptr(), s, m,
                               k, w, bc, smem, stream)
        if err != 0:
            raise RuntimeError(f"tape_apply_cuda: CUDA error {err}")
        launches["tape_apply_cuda"] += 1
    return c


def hh_block_apply_cuda(v: torch.Tensor, t: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """``C <- (I - V T V^T) C`` for v (..., m, k), t (..., k, k),
    c (..., m, w), in place on ``c``: :func:`tape_apply_cuda` with the
    leading axes as slots (one slot for a single problem)."""
    m, k, w = c.shape[-2], v.shape[-1], c.shape[-1]
    tape_apply_cuda(v.reshape(-1, m, k), t.reshape(-1, k, k),
                    c.view(-1, m, w))
    return c
