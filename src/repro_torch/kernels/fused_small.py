"""Wrapper of the CUDA fused small-n SVD kernel (``csrc/fused_small.cu``).

``fused_small_svd_cuda`` takes the contract of the reference's
``fused_small_svd_pallas``: a (B, n, n) stack, reduced whole inside one
launch, one block per matrix.  Values mode returns sigma (B, n), descending;
``compute_uv=True`` returns ``(d, e, U2, V2^T)`` (``e[..., 0] = 0``,
``A = U2 B V2^T``), whose vectors the caller composes with the staged
stage 3.  float64 and float32 work in their type, bfloat16 in float32,
rounded once at the store.

``tuning.fused_route`` picks the kernel's route ("smem": the band, and
phase 1's trailing block once it fits, in shared memory; "global": the
matrix in device memory) and lays out its shared memory;
``bisect_schedule`` picks the in-launch bisection's (d, s).

It takes CUDA tensors only: it launches the kernel or raises, and counts
the launch in ``launches``.  The plain version ``ref.fused_small_svd_ref``
is chosen for CPU tensors by ``kernels/ops.py``, not here.  The library is
built on first use.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.core.bidiag_svd import default_bisect_iters
from repro_torch.core.householder import acc_dtype
from repro_torch.kernels import _build, bisect
from repro_torch.kernels.ref import effective_bw

__all__ = ["fused_small_svd_cuda", "bisect_schedule", "launches",
           "CHECK_SHAPES", "CHECK_TOLS", "ENTRY_TOL_FP64", "uv_invariants",
           "entry_error"]

launches = {"fused_small_svd_cuda": 0}

MAX_BATCH = 2**31 - 1              # one block per matrix on the grid's x axis
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
_FNS: dict = {}

# How the kernel is held against its plain version (the card tests and
# chip_smoke.py): (B, n, bw) of the reference's tests
# (tests/test_fused_small.py), and per dtype the tolerance on sigma, and on
# the sigma of the uv mode's (d, e), times max(1, sigma_max), and on the uv
# factors' own invariants (uv_invariants).
CHECK_SHAPES = sorted({(3, n, bw) for n in (1, 2, 16, 64)
                       for bw in (0, 1, 4, n - 1)} | {(3, 16, 4), (3, 33, 7)})
CHECK_TOLS = {"float64": (1e-12, 1e-11), "float32": (1e-5, 1e-4)}
# Entry by entry (entry_error), only at fp64.  The bidiagonal of a chase is
# an ill-conditioned function of its input, its sigma are not: the plain
# version's own (d, e, U2, V2^T) move far more than sigma when each entry
# of A moves by one ulp, and at fp32 such a move can flip the sign of a d_k
# with its columns.  chip_smoke.py prints that witness beside the kernel's
# error; PERF.md has the readings this limit was set from.
ENTRY_TOL_FP64 = 1e-8


def uv_invariants(a, d, e, u, vt) -> tuple[float, float, float]:
    """(max|U2 B V2^T - A| / max(1, max|A|), max|U2^T U2 - I|,
    max|V2^T V2 - I|) of a uv-mode result, in fp64."""
    a, d, e, u, vt = (x.double() for x in (a, d, e, u, vt))
    b = torch.diag_embed(d) + torch.diag_embed(e[:, 1:], 1)
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    scale = max(1.0, float(a.abs().max()))
    return (float((u @ b @ vt - a).abs().max()) / scale,
            float((u.mT @ u - eye).abs().max()),
            float((vt @ vt.mT - eye).abs().max()))


def entry_error(got, want) -> float:
    """Largest entry error of two uv-mode results over d, |e|, U2 and V2^T,
    each over its scale max(1, max|want|), in fp64."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double(), w.double().to(g.device)
        if i == 1:
            g, w = g.abs(), w.abs()
        if w.numel():
            worst = max(worst, float((g - w).abs().max())
                        / max(1.0, float(w.abs().max())))
    return worst


def _fn(dtype: torch.dtype, lib=None):
    """The C function of the built library for ``dtype``, or of ``lib`` (a
    copy of ``fused_small.cu`` built elsewhere)."""
    f = _FNS.get(dtype) if lib is None else None
    if f is None:
        f = getattr(lib or _build.load("fused_small"),
                    f"fused_small_{_SUFFIX[dtype]}")
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p] * 9 + [i, i, i, i, ctypes.c_double] + [i] * 14 + [p]
        f.restype = ctypes.c_int
        if lib is None:
            _FNS[dtype] = f
    return f


def bisect_schedule(n: int, max_iter: int) -> tuple[int, int]:
    """(d, s) of the bisection inside the fused launch, one block of
    ``tuning.FUSED_THREADS`` threads per matrix: the tree's top d =
    min(floor(log2 n), max_iter) levels counted once, then s levels a round
    over groups of 2^s lanes, the largest s in [0, 5] whose n * 2^s lanes
    the block holds without passing the warps per SM at which the count
    chain turns throughput-bound (``bisect._WARPS_AT_THROUGHPUT``); s = 1
    counts one node a round, as s = 0 does, so it becomes 0."""
    d = min(n.bit_length() - 1, max_iter)
    lanes = min(tuning.FUSED_THREADS, 32 * bisect._WARPS_AT_THROUGHPUT)
    s = max((x for x in range(6) if n << x <= lanes), default=0)
    return d, 0 if s == 1 else s


def fused_small_svd_cuda(mats: torch.Tensor, *, bw: int,
                         compute_uv: bool = False,
                         max_iter: int | None = None, lib=None):
    """Whole-pipeline SVD of a (B, n, n) stack in one launch.

    Values mode returns sigma (B, n), descending; ``compute_uv=True``
    returns ``(d, e, U2, V2^T)``.  bw goes through ``ref.effective_bw``;
    ``max_iter=None`` is 60 bisection steps at fp64 and 40 otherwise.
    ``lib``: a copy of ``fused_small.cu`` built elsewhere (planted-fault
    checks); by default the package's build."""
    if mats.device.type != "cuda":
        raise ValueError(f"mats must be a CUDA tensor, got {mats.device}")
    if mats.dtype not in _SUFFIX:
        raise ValueError(f"mats: dtype {mats.dtype} not in {tuple(_SUFFIX)}")
    if (mats.dim() != 3 or mats.shape[-1] != mats.shape[-2]
            or not mats.is_contiguous()):
        raise ValueError(f"mats must be a contiguous (B, n, n) stack, got "
                         f"{tuple(mats.shape)}")
    b, n, _ = mats.shape
    if b > MAX_BATCH:
        raise ValueError(f"fused_small_svd_cuda takes at most {MAX_BATCH} "
                         f"matrices per launch, got {b}")
    acc = acc_dtype(mats.dtype)
    if max_iter is None:
        max_iter = default_bisect_iters(acc)
    elif max_iter < 1:
        raise ValueError(f"max_iter must be None (auto) or >= 1, got "
                         f"{max_iter}")
    bw = effective_bw(n, bw)
    tuning.check_fused_smem_budget(n, mats.dtype, compute_uv=compute_uv)
    route = tuning.fused_route(n, bw, mats.dtype, compute_uv=compute_uv)
    ws = torch.empty((b, n, n), dtype=acc, device=mats.device)
    sig = d = e = u = vt = uws = vws = None
    if compute_uv:
        d, e = mats.new_empty((b, n)), mats.new_empty((b, n))
        u, vt = mats.new_empty((b, n, n)), mats.new_empty((b, n, n))
        if not route.uv_smem:
            uws, vws = torch.empty_like(ws), torch.empty_like(ws)
    else:
        sig = mats.new_empty((b, n))
    if b * n:
        tiny = float(torch.finfo(acc).tiny) * 4
        dtop, s = bisect_schedule(n, max_iter)
        ptr = [x.data_ptr() if x is not None else None
               for x in (mats, ws, uws, vws, sig, d, e, u, vt)]
        with torch.cuda.device(mats.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _fn(mats.dtype, lib)(
                *ptr, b, n, bw, max_iter, tiny, int(compute_uv),
                int(route.name == "smem"), route.j0, int(route.uv_smem),
                route.scratch, route.region, route.ldt, route.ldb, route.ldu,
                route.dlo, route.h, dtop, s, route.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"fused_small_svd_cuda: CUDA error {err}")
        _build.count_launch(launches, "fused_small_svd_cuda")
    return (d, e, u, vt) if compute_uv else sig
