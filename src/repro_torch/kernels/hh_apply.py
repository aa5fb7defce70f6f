"""Wrapper of the CUDA compact-WY apply kernels (``csrc/hh_apply.cu``).

``tape_apply_cuda`` takes the contract of the reference's
``tape_apply_pallas``: per slot s, ``C[s] <- C[s] - V[s] T[s] V[s]^T C[s]``
with v (S, m, k), t (S, k, k), c (S, m, w), all of one dtype (float64,
float32 or bfloat16).  It updates ``c`` in place and returns it.

V and C may be strided views (a slot stride and a row stride, the innermost
stride 1): the stage-1 trailing update passes the trailing block of its
padded matrix, the stage-1 replay the accumulator rows at and below a
panel's first pivot.  With ``rows`` (int32, (slots per matrix, m)) C is an
accumulator (B, R, w) with B = S / slots per matrix: slot s reads and writes
rows ``rows[s % spm]`` of matrix ``s // spm`` in place, which is how the
chase replay addresses its accumulators.  Rows must lie in [0, R); the
kernel reads a row outside as zeros and never writes it.

``launch_shape`` picks the path from m and k: the small-m kernel (one
launch; the chase replay) or the three large-m kernels (stage 1).
``hh_block_apply_cuda`` is the view for (..., m, k) blocks, whose leading
axes become the slots.

The wrapper takes CUDA tensors only: it launches the kernels or raises, and
counts each call that launches in ``launches``.  The plain versions
(``kernels/ref.py``) are chosen for CPU tensors by ``kernels/ops.py``, not
here.  The library is built on first use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.householder import acc_dtype
from repro_torch.core.tuning import SMEM_PER_BLOCK
from repro_torch.kernels import _build

__all__ = ["tape_apply_cuda", "hh_block_apply_cuda", "launch_shape",
           "launch_with", "set_argtypes", "LaunchPlan", "launches", "MAX_K",
           "SMALL_M", "SMALL_K"]

launches = {"tape_apply_cuda": 0}

MAX_K = 128
SMALL_M, SMALL_K = 64, 16          # the small-m path: m <= 64 and k <= 16
KP_CLASSES = (16, 32, 64, 128)     # W1 and W2 rows of the large-m path
SMALL_COLS = 128                   # columns of C per tile, small path
W1_TK, W1_STAGES = 32, 2           # kernel 1: rows per ring stage, stages
T_COLS = 32                        # kernel 2: columns of W2 per block
TM, TN = 64, 64                    # kernel 3: the tile of C of one block
# kernel 1's grid at S = 1 aims at two blocks on each of the H100's 132
# SMs (one wave); the split depends on m, k and w only, so a slot's sums
# do not depend on how many slots share the launch
TARGET_BLOCKS = 2 * 132
MIN_SPLIT_ROWS = 4 * W1_TK
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_FNS: dict = {}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call launches.  ``path`` "small" (one kernel) or "large"
    (three); ``kp`` the rows of W1 and W2 (k rounded up to a tile class,
    0 on the small path); ``nsplit`` splits of ``rows_per_split`` rows of
    kernel 1; ``wp`` the padded row length of the scratch buffers; ``smem``
    the dynamic shared memory of each kernel, bytes."""
    path: str
    kp: int
    nsplit: int
    rows_per_split: int
    wp: int
    smem: tuple

    @property
    def kernels(self) -> int:
        return len(self.smem)


def _fn(dtype: torch.dtype):
    f = _FNS.get(dtype)
    if f is None:
        f = set_argtypes(getattr(_build.load("hh_apply"),
                                 f"tape_apply_{_SUFFIX[dtype]}"))
        _FNS[dtype] = f
    return f


def _pad_ld(cols: int, itemsize: int) -> int:
    """Row stride of a shared-memory tile (``pad_ld`` in the source)."""
    want = 32 if itemsize == 8 else 16
    ld = cols
    while (ld * itemsize) % 16 or (ld * itemsize) % 128 != want:
        ld += 1
    return ld


def _w1_cols(kp: int) -> int:
    return 64 if kp >= 128 else 128


@functools.lru_cache(maxsize=None)
def launch_shape(m: int, k: int, w: int, dtype) -> LaunchPlan:
    """The launch of one call at (m, k, w) in ``dtype``, for any S.

    m <= SMALL_M and k <= SMALL_K take the small-m kernel; the rest the
    large-m kernels.  Raises when k or the shared memory is more than the
    kernels take."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"tape_apply_cuda takes 1 <= k <= {MAX_K}, got "
                         f"k={k}")
    item, acc = dtype.itemsize, acc_dtype(dtype).itemsize
    if m <= SMALL_M and k <= SMALL_K:
        tile = -(-m * SMALL_COLS * item // 16) * 16
        smem = SMALL_M * 8 + 2 * tile + (m * k + k * k) * acc
        plan = LaunchPlan("small", 0, 1, m, 0, (smem,))
    else:
        kp = next(c for c in KP_CLASSES if c >= k)
        tn = _w1_cols(kp)
        wp = -(-w // 128) * 128
        rows = max(m, 1)
        nsplit = max(1, min(-(-TARGET_BLOCKS // (wp // tn)),
                            -(-rows // MIN_SPLIT_ROWS)))
        rps = -(-rows // (nsplit * W1_TK)) * W1_TK
        s1 = W1_STAGES * W1_TK * (_pad_ld(kp, item) + _pad_ld(tn, item)) * item
        s3 = TM * _pad_ld(kp, item) * item + kp * _pad_ld(TN, acc) * acc
        s2 = (kp * T_COLS + k * k) * acc
        plan = LaunchPlan("large", kp, -(-rows // rps), rps, wp, (s1, s2, s3))
    if max(plan.smem) > SMEM_PER_BLOCK:
        raise ValueError(f"tape_apply_cuda at m={m}, k={k} needs "
                         f"{max(plan.smem)} B of shared memory per block; "
                         f"the H100 gives {SMEM_PER_BLOCK}")
    return plan


def _aligned(x: torch.Tensor) -> bool:
    """Every row of ``x`` (its first two axes: slots and rows) starts on
    16 bytes."""
    item = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        (st * item) % 16 == 0 for st, n in zip(x.stride()[:2], x.shape[:2])
        if n > 1)


def _check_operand(x: torch.Tensor, name: str, dtype: torch.dtype):
    if dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {dtype} not in {tuple(_SUFFIX)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name} must have 3 axes, got {tuple(x.shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{name}: the innermost stride must be 1, got "
                         f"strides {x.stride()}")


def tape_apply_cuda(v: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                    rows: torch.Tensor | None = None) -> torch.Tensor:
    """Per slot s, ``C[s] <- C[s] - V[s] (T[s] (V[s]^T C[s]))``, in place
    on ``c``; returns ``c``.

    v (S, m, k) and c (S, m, w) may be strided views; t is contiguous
    (S, k, k).  With ``rows`` (int32, contiguous, (spm, m)), c is an
    accumulator (S / spm, R, w) and slot s works on rows ``rows[s % spm]``
    of matrix ``s // spm``."""
    _check_operand(c, "c", c.dtype)
    if launch_with(_fn(c.dtype), v, t, c, rows):
        _build.count_launch(launches, "tape_apply_cuda")
    return c


def launch_with(fn, v: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                rows: torch.Tensor | None = None) -> bool:
    """Check the operands of :func:`tape_apply_cuda` and launch ``fn``, a
    ``tape_apply_<dtype>`` symbol of a build of ``csrc/hh_apply.cu`` (the
    repository's, or a copy with a planted fault), on them.  Returns
    whether anything was launched (nothing for an empty operand); raises on
    a CUDA error."""
    for x, name in ((v, "v"), (t, "t"), (c, "c")):
        _check_operand(x, name, c.dtype)
    s, m, k = v.shape
    w = c.shape[-1]
    if tuple(t.shape) != (s, k, k) or not t.is_contiguous():
        raise ValueError(f"t must be contiguous ({s}, {k}, {k}), got "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    if rows is None:
        if tuple(c.shape[:2]) != (s, m):
            raise ValueError(f"c has shape {tuple(c.shape)}, expected "
                             f"({s}, {m}, w)")
        spm, r_acc, table = 1, m, None
    else:
        if (rows.device != c.device or rows.dtype != torch.int32
                or rows.dim() != 2 or rows.shape[1] != m
                or not rows.is_contiguous()):
            raise ValueError(f"rows must be a contiguous int32 (spm, {m}) "
                             f"tensor on {c.device}, got {rows.dtype} "
                             f"{tuple(rows.shape)} on {rows.device}")
        spm, r_acc = rows.shape[0], c.shape[1]
        if spm == 0 or s % spm or c.shape[0] != s // spm:
            raise ValueError(f"{s} slots of {spm} per matrix do not match "
                             f"an accumulator of {c.shape[0]} matrices")
        table = rows.data_ptr()
    plan = launch_shape(m, k, w, c.dtype)
    if s * m * w == 0:
        return False
    dev = c.device
    part = w2 = None
    if plan.path == "large":
        acc = acc_dtype(c.dtype)
        part = torch.empty((plan.nsplit, s, plan.kp, plan.wp), dtype=acc,
                           device=dev)
        w2 = torch.empty((s, plan.kp, plan.wp), dtype=acc, device=dev)
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), v.stride(0), v.stride(1), t.data_ptr(),
                 c.data_ptr(), c.stride(0), c.stride(1), table, spm, r_acc,
                 s, m, k, w, int(_aligned(v)), int(_aligned(c)), plan.kp,
                 None if part is None else part.data_ptr(),
                 None if w2 is None else w2.data_ptr(), plan.wp, plan.nsplit,
                 plan.rows_per_split, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tape_apply_cuda: CUDA error {err}")
    return True


def set_argtypes(f):
    """The ctypes signature of a ``tape_apply_<dtype>`` symbol."""
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f.argtypes = [p, q, q, p, p, q, q, p, i, i, i, i, i, i, i, i, i, p, p, i,
                  i, i, p]
    f.restype = ctypes.c_int
    return f


def hh_block_apply_cuda(v: torch.Tensor, t: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """``C <- (I - V T V^T) C`` for v (..., m, k), t (..., k, k),
    c (..., m, w), in place on ``c`` (a strided view is fine where its
    leading axes merge into one): :func:`tape_apply_cuda` with the leading
    axes as slots (one slot for a single problem)."""
    m, k, w = c.shape[-2], v.shape[-1], c.shape[-1]
    tape_apply_cuda(v.reshape(-1, m, k), t.reshape(-1, k, k),
                    c.view(-1, m, w))
    return c
