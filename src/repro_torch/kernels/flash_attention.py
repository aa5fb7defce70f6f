"""Wrappers of the two CUDA causal flash-attention kernels, and the rule that
picks one.

Both take the contract of the reference's ``flash_attention_pallas`` with
grouped KV heads: causal softmax attention of q (BH, S, D) against k, v
(BH / g, S, D), query row bh reading KV row bh // g (g = 1 is the
reference's contract), scale 1/sqrt(D), an online softmax in fp32, forward
only, the result in ``q.dtype``, any S (the ragged edge is masked in the
kernels).  Nothing here takes the reference's ``block_q``/``block_k``: each
kernel's tile is its own.

- ``flash_attention_wgmma_cuda`` (``csrc/flash_attn_wgmma.cu``): bf16 and
  fp16 with D in {64, 128}, on the tensor cores (wgmma on tiles that TMA
  brings into shared memory).  P is rounded to the storage type before
  P.V.
- ``flash_attention_cuda`` (``csrc/flash_attn.cu``): fp32, bf16 and fp16,
  1 <= D <= 256 with D a multiple of 8, both products on the tensor cores
  at fp32 accuracy: each fp32 operand (and P, kept in fp32) is split into
  two TF32 parts and a product is three TF32 products summed in fp32
  (3xTF32).  bf16 and fp16 values are exact in TF32.

``kernel_for`` is the rule ``ops.flash_attention`` follows.  Each wrapper
takes CUDA tensors only: it launches its kernel or raises, and counts the
launch in ``launches`` under its own key.  The plain version
``ref.flash_attention_ref`` is chosen for CPU tensors by ``kernels/ops.py``,
not here.  The libraries are built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gqa_group

__all__ = ["flash_attention_cuda", "flash_attention_wgmma_cuda",
           "kernel_for", "launches", "row_error", "MAX_D", "MAX_BH",
           "WGMMA_D", "CHECK_TOLS", "PREFILL_TOLS"]

launches = {"flash_attention": 0, "flash_attention_wgmma": 0}

# How the kernels are held against their plain version (the card tests,
# chip_smoke.py and the CPU tests against the reference): ``row_error`` at
# most CHECK_TOLS.  Each query row is held to its own size, since late rows
# of causal attention average many keys and are far smaller than the first
# (one scale for the whole output hid faults confined to late key tiles).
# Each limit sits between the sound kernels' readings and those of faults
# planted in copies of the kernels (``chip_smoke.py --flash-planted-faults``
# on an H100 80GB HBM3 at 700 W): bf16 sound 5.1e-3, two stale-tile faults
# 0.57-0.71; fp16 sound 6.4e-4, fp16 computed at bf16 precision 1.6e-3;
# fp32 (flash_attn.cu) sound 3.0e-6 on fp32 FMAs; its 3xTF32 design is held
# to the same limit against faults that drop the lo terms.
CHECK_TOLS = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 1e-3}

# How a phi3-medium-14b-width prefill through the kernels is held against
# the same prefill through the plain version: max |logit difference| over
# max(1, max|logit|) (chip_smoke.py's lm phases and the card test).  Under
# the reference's init every softmax is nearly one-hot and amplifies
# rounding, so the sound kernel reads far above 1e-4; each limit sits
# between the sound readings and those of two planted faults (the causal
# mask off by one, the GQA group order tiled), from
# ``chip_smoke.py --lm-planted-faults`` on an H100 80GB HBM3 at 700 W:
# fp32, 2-4 layers (flash_attn.cu): sound 2.3e-4-2.6e-3, faults 0.94-1.48;
# bf16, 40 layers (flash_attn_wgmma.cu): sound 0.1117, faults 1.19-1.38.
PREFILL_TOLS = {"float32": 3e-2, "bfloat16": 0.4}

MAX_D = 256                 # flash_attn.cu's widest padded head (DP)
MAX_BH = 65535              # flash_attn.cu: one grid row per (batch, head)
WGMMA_D = (64, 128)         # the head widths flash_attn_wgmma.cu takes
_WGMMA_MAX_TILES = 65535    # flash_attn_wgmma.cu: grid y, 128 rows a tile
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_FNS: dict = {}


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes causal attention of this storage type and head
    width on the card: ``"wgmma"`` for bf16 and fp16 with D in {64, 128},
    else ``"simt"`` (``flash_attn.cu``)."""
    if dtype in (torch.bfloat16, torch.float16) and d in WGMMA_D:
        return "wgmma"
    return "simt"


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` lies from ``want``, both (..., S, D): the largest over
    query rows of |got_row - want_row| / |want_row| (2-norms, in fp64).  A
    row of zeros in ``want`` must be matched exactly."""
    g = got.detach().double().reshape(-1, got.shape[-1])
    w = want.detach().to(g.device, torch.float64).reshape(-1, want.shape[-1])
    if not w.numel():
        return 0.0
    den = w.norm(dim=-1).clamp_min(torch.finfo(torch.float64).tiny)
    return float(((g - w).norm(dim=-1) / den).max())


def _fn(source: str, dtype: torch.dtype):
    f = _FNS.get((source, dtype))
    if f is None:
        f = getattr(_build.load(source), f"{source}_{_SUFFIX[dtype]}")
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, p]
        f.restype = ctypes.c_int
        _FNS[(source, dtype)] = f
    return f


def _check(q, k, v, dtypes) -> int:
    """Device, dtype and layout checks shared by both wrappers; returns g."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {x.dtype} not in {dtypes}")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                             f"q's {q.dtype} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return gqa_group(q, k, v)


def _check_aligned(q, k, v, why: str) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"({why})")


def _launch(source: str, key: str, q, k, v) -> torch.Tensor:
    bh, s, d = q.shape
    out = torch.empty_like(q)
    if bh * s:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(source, q.dtype)(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), bh,
                                       k.shape[0], s, d, 1.0 / d ** 0.5,
                                       stream)
        if err != 0:
            raise RuntimeError(f"{source}: error {err} (a CUDA error code; "
                               f"100000 + a CUresult: a refused tensor map; "
                               f"-1: no cuTensorMapEncodeTiled)")
        _build.count_launch(launches, key)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """``flash_attn.cu``: causal attention of contiguous CUDA tensors of one
    dtype, q (BH, S, D), k, v (BH / g, S, D); returns a new (BH, S, D)
    tensor of that dtype."""
    _check(q, k, v, tuple(_SUFFIX))
    bh, _, d = q.shape
    if not (1 <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"head dim {d}: the kernel takes 1 <= D <= {MAX_D} "
                         f"with D % 8 == 0")
    if bh > MAX_BH:
        raise ValueError(f"BH = {bh}: the kernel takes at most {MAX_BH}")
    _check_aligned(q, k, v, "cp.async")
    return _launch("flash_attn", "flash_attention", q, k, v)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """``flash_attn_wgmma.cu``: causal attention of contiguous bf16 or fp16
    CUDA tensors, q (BH, S, D), k, v (BH / g, S, D), D in {64, 128};
    returns a new (BH, S, D) tensor of that dtype."""
    _check(q, k, v, (torch.bfloat16, torch.float16))
    _, s, d = q.shape
    if d not in WGMMA_D:
        raise ValueError(f"head dim {d}: the wgmma kernel takes D in "
                         f"{WGMMA_D}")
    if -(-s // 128) > _WGMMA_MAX_TILES:
        raise ValueError(f"S = {s}: the wgmma kernel takes at most "
                         f"{_WGMMA_MAX_TILES * 128}")
    _check_aligned(q, k, v, "TMA")
    return _launch("flash_attn_wgmma", "flash_attention_wgmma", q, k, v)
