"""Wrapper of the CUDA causal flash-attention kernel (``csrc/flash_attn.cu``).

``flash_attention_cuda`` takes the contract of the reference's
``flash_attention_pallas``: causal softmax attention on q, k, v (BH, S, D),
scale 1/sqrt(D), an online softmax in fp32, forward only, the result in
``q.dtype``.  It takes float32, bfloat16 and float16, 1 <= D <= 256 with D a
multiple of 8, and any S (the ragged edge is masked in the kernel).  The
kernel's tile (64 query rows, 64 keys) is its own; nothing here takes the
reference's ``block_q``/``block_k``.

It takes CUDA tensors only: it launches the kernel or raises, and counts the
launch in ``launches``.  The plain version ``ref.flash_attention_ref`` is
chosen for CPU tensors by ``kernels/ops.py``, not here.  The library is
built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_cuda", "launches", "MAX_D", "MAX_BH",
           "CHECK_TOLS", "PREFILL_TOLS"]

launches = {"flash_attention": 0}

# How the kernel is held against its plain version (the card tests and
# chip_smoke.py): the reference's kernel-test tolerances
# (tests/test_kernels.py: fp32 3e-6, bf16 3e-2; fp16, whose rounding is
# finer than bf16's, as bf16), times the output's scale max(1, max|o|).
CHECK_TOLS = {"float32": 3e-6, "bfloat16": 3e-2, "float16": 3e-2}

# How a phi3-medium-14b-width prefill through the kernel is held against
# the same prefill through the plain version: max |logit difference| over
# max(1, max|logit|) (chip_smoke.py's lm phases and the card test).  Under
# the reference's init every softmax is nearly one-hot and amplifies
# rounding, so the sound kernel reads far above 1e-4; each limit sits
# between the sound readings and those of two planted faults (the causal
# mask off by one, the GQA group order tiled), from
# ``chip_smoke.py --lm-planted-faults`` on an H100 80GB HBM3 at 700 W:
# fp32, 2-4 layers: sound 2.3e-4-2.6e-3, faults 0.94-1.48; bf16, 40
# layers: sound 0.106-0.131, faults 1.19-1.40.
PREFILL_TOLS = {"float32": 3e-2, "bfloat16": 0.4}

MAX_D = 256                 # the kernel's widest padded head (DP)
MAX_BH = 65535              # one grid row per (batch, head): grid y
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_FNS: dict = {}


def _fn(dtype: torch.dtype):
    f = _FNS.get(dtype)
    if f is None:
        f = getattr(_build.load("flash_attn"), f"flash_attn_{_SUFFIX[dtype]}")
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
        f.restype = ctypes.c_int
        _FNS[dtype] = f
    return f


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Causal attention of contiguous (BH, S, D) CUDA tensors of one dtype;
    returns a new (BH, S, D) tensor of that dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype not in _SUFFIX:
            raise ValueError(f"{name}: dtype {x.dtype} not in "
                             f"{tuple(_SUFFIX)}")
        if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, expected q's {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D), got {tuple(q.shape)}")
    bh, s, d = q.shape
    if not (1 <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"head dim {d}: the kernel takes 1 <= D <= {MAX_D} "
                         f"with D % 8 == 0")
    if bh > MAX_BH:
        raise ValueError(f"BH = {bh}: the kernel takes at most {MAX_BH}")
    out = torch.empty_like(q)
    if bh * s:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), bh, s, d, 1.0 / d ** 0.5,
                               stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_cuda: CUDA error {err}")
        launches["flash_attention"] += 1
    return out
