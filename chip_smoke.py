#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N] [--lm-planted-faults |
                           --flash-planted-faults | --wy-planted-faults |
                           --wy-bounds | --svd-parts TREE]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card at every shape the main path launches it with,
then drives the main path: ``banded_singular_values`` (a banded matrix to
its singular values) at fuse=1 and fuse=4, ``singular_values`` and ``svd``
of a dense fp64 matrix at n = 4096 (U, sigma, V^T, timed part by part),
``svd_batched(..., compute_uv=True)`` on 16 fp32 matrices, and the fused
small-n tier (``backend="fused_small"``, one launch per batch) on 64 fp64
matrices of n = 64 and 64 fp32 matrices of n = 256, each timed against the
staged pipeline on the same batch.  Results are checked against
``torch.linalg.svdvals``, which serves here only as a yardstick, and U and
V^T by reconstruction and orthogonality.  Then the LM serving path with
phi3-medium-14b at full width: a four-layer fp32 prefill (b = 2, s = 2048)
with attention through the fp32 flash kernel (``flash_attn.cu``), held to
the same prefill through the kernels' plain version and to one-token
decode; then all 40 layers in bf16, a timed prefill through the
tensor-core flash kernel (``flash_attn_wgmma.cu``, the KV heads grouped)
held to the same through the plain version, beside
a witness of bf16 rounding (the plain path's bf16 logits against its fp32
logits), and 8 requests answered by the token ``Engine`` through
``repro_torch.launch.serve``.  Every phase prints one JSON line; the line before the last two is the ``kernels``
summary, then the card's name and power limit as ``nvidia-smi`` gives them,
then ``{"ok": true, "device": ...}``.

Exits non-zero, with no result line, when there is no CUDA device, when the
port's package is not next to this script, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (b_in, tw, G) of the reference's kernel tests (tests/test_kernels.py)
CHASE_SHAPES = [(4, 2, 3), (6, 2, 4), (8, 3, 5), (12, 4, 3), (16, 8, 2),
                (32, 8, 2), (5, 4, 6), (2, 1, 8)]
# (m, k, w) of the reference's compact-WY tests (tests/test_kernels.py)
WY_SHAPES = [(64, 8, 100), (128, 16, 64), (33, 4, 7), (256, 32, 512),
             (16, 1, 5)]
TOLS = {"float64": 1e-12, "float32": 3e-5, "bfloat16": 8e-2}
# the compact-WY apply at bf16: kernel and plain version both accumulate in
# fp32 and round once at the store, so about one bf16 ulp of the scale
# (at most 2**-7), whatever k; fp64 and fp32 take TOLS times max(1, k // 4)
WY_TOL_BF16 = 1e-2
# Faults planted in copies of hh_apply.cu (--wy-planted-faults): fault ->
# (the main shapes it acts at, [(text, replacement, times it occurs)]).
# Each must read at least WY_FAULT_FACTOR times the fp64 wy_tol there.
WY_FAULT_FACTOR = 100
WY_FAULTS = {
    # the last m-partial dropped: kernel 2 sums all splits of the m rows but
    # the last, and the small path's W1 all rows but the last
    "last_m_partial_dropped": (("panel", "trailing", "replay"), [
        ("if (sp0 + u < a.nsplit) acc[q] += x[u][q];",
         "if (sp0 + u < a.nsplit - 1) acc[q] += x[u][q];", 1),
        ("        for (int r = 0; r < m; ++r)\n          sum = fma_acc(",
         "        for (int r = 0; r < m - 1; ++r)\n          sum = fma_acc(",
         1)]),
    # a ring stage read stale in the last m tile: kernel 1 multiplies the
    # stage that held the tile before it
    "stale_ring_stage_last_m_tile": (("panel", "trailing"), [
        ("const int slot = it % kStages;",
         "const int slot = (it == ntiles - 1 && it > 0 ? it - 1 : it) % "
         "kStages;", 1)]),
    # a row-table offset shifted by one
    "row_table_offset_by_one": (("replay",), [
        ("const int row = a.rows[(s % a.spm) * a.m + r];",
         "const int row = a.rows[(s % a.spm) * a.m + r] + 1;", 1)])}
STURM_TOLS = {"float64": 1e-13, "float32": 1e-5}
STURM_CHECK_STEPS = 3       # bisection steps of the main-path-shape checks
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 67e12}
# bf16 is computed in fp32 units, outside the tensor cores
# matrix products (the compact-WY apply): fp64 on the tensor cores, 67
# TFLOP/s; fp32 at fp32 precision has no tensor-core route (TF32 is not
# fp32), 67 TFLOP/s; bf16 with fp32 sums on the tensor cores, 989 TFLOP/s
PEAK_MATMUL_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12,
                     "float16": 989e12}
# causal flash attention: (BH, S, D) of the reference's kernel test
# (tests/test_kernels.py), a ragged S and D = 64, and the main path's shape
# (phi3-medium-14b prefill at b = 2, s = 2048: 2 x 40 query heads of 128,
# 2 x 10 KV heads, g = 4) in bf16 (the serving run, the wgmma kernel) and
# fp32 (the fp32 check, flash_attn.cu); the wgmma kernel also at the short
# lengths FLASH_SHORT_S around its 128-row tile; tolerances
# flash_attention.CHECK_TOLS
FLASH_SHAPES = [(4, 256, 64), (2, 128, 32), (1, 64, 16), (3, 192, 64),
                (80, 1000, 64), (80, 2047, 128)]
FLASH_SHORT_S = (1, 63, 65, 129)
FLASH_MAIN = (80, 2048, 128)
FLASH_GROUP = 4                    # phi3-medium-14b: 40 query, 10 KV heads
# the lengths of the card tests of the wgmma kernel (2 * g query rows)
FLASH_CARD_S = (1, 2, 63, 64, 65, 127, 128, 129, 1000, 2047, 2048)
# Faults planted in copies of the flash kernels (--flash-planted-faults):
# fault -> (source, the dtype it is read in, [(text, replacement, times it
# occurs)]).  Faults confined to late key tiles, whose moves are small
# beside the first rows' outputs, and arithmetic a step coarser than the
# dtype's.
FLASH_FAULTS = {
    # a ring stage read stale: the last two key tiles hold the K and V of
    # the tile two before, what the stage held one round earlier
    "stale_stage_last_two_tiles": ("flash_attn_wgmma", "bfloat16", [(
        "kt * kBK, bkv);",
        "(kt >= n_tiles - 2 && kt >= 2 ? kt - 2 : kt) * kBK, bkv);", 2)]),
    # the last query tile's diagonal takes V (only) of the tile two before
    "stale_v_last_diagonal": ("flash_attn_wgmma", "bfloat16", [(
        "&vmap, bar_full(bar, s),\n                   h * kBoxCols, "
        "kt * kBK, bkv);",
        "&vmap, bar_full(bar, s), h * kBoxCols, (kt == tile && tile == "
        "n_tiles - 1 && kt >= 2 ? kt - 2 : kt) * kBK, bkv);", 1)]),
    # fp16 at bf16 precision: P and the output rounded through bf16
    "fp16_at_bf16_precision": ("flash_attn_wgmma", "float16", [(
        "__half2 h = __floats2half2_rn(lo, hi);",
        "__half2 h = __floats2half2_rn(__bfloat162float(__float2bfloat16("
        "lo)), __bfloat162float(__float2bfloat16(hi)));", 1)]),
    # flash_attn.cu: the last two key tiles take V of the tile two before
    "fp32_stale_v_last_two_tiles": ("flash_attn", "float32", [(
        "load_tile<T, DP>(v + kv_base, S, D, k0, 1.0f, vs, DP);",
        "load_tile<T, DP>(v + kv_base, S, D, kt >= n_tiles - 2 && kt >= 2 "
        "? k0 - 2 * kBK : k0, 1.0f, vs, DP);", 1)]),
    # flash_attn.cu at TF32 precision: Q, K and V truncated to TF32's 10
    # mantissa bits as they are staged
    "fp32_at_tf32_precision": ("flash_attn", "float32", [(
        "? to_f(x[(size_t)row * D + c]) * mul : 0.0f;",
        "? __uint_as_float(__float_as_uint(to_f(x[(size_t)row * D + c]) "
        "* mul) & 0xffffe000u) : 0.0f;", 1)])}
# Probes of what bounds the large-m path (--wy-bounds): copies of
# hh_apply.cu with kernel 1's or kernel 3's products left out, and with
# kernel 1's staging left out (its ring multiplies stale shared memory)
WY_PROBES = {
    "kernel_1_without_products": [(
        "    warp_product<MT, NT, true>(d, vs + slot * kTK * LDV, LDV,",
        "    if (a.k < 0) warp_product<MT, NT, true>(d, vs + slot * kTK * "
        "LDV, LDV,", 1)],
    "kernel_1_without_staging": [
        ("    if (i < ntiles) load(i, i);",
         "    if (i < ntiles && a.k < 0) load(i, i);", 1),
        ("    if (next < ntiles) load(next, next % kStages);",
         "    if (next < ntiles && a.k < 0) load(next, next % kStages);", 1)],
    "kernel_3_without_products": [
        ("    warp_product<MT, NT, false>(d, va, LDV, wb, LDW, 0, "
         "min(KC, k8), A(-1));",
         "    if (a.k < 0) warp_product<MT, NT, false>(d, va, LDV, wb, LDW, "
         "0, min(KC, k8), A(-1));", 1),
        ("    warp_product<MT, NT, false>(d, va, LDV, wb, LDW, KC, k8, "
         "A(-1));",
         "    if (a.k < 0) warp_product<MT, NT, false>(d, va, LDV, wb, LDW, "
         "KC, k8, A(-1));", 1)]}
# phi3-medium-14b: the prefill batch, the fp32 check's depth, and the
# Engine's requests (the reference launcher's prompts of 2-8 tokens)
LM_ARCH, LM_B, LM_S, LM_CHECK_LAYERS = "phi3-medium-14b", 2, 2048, 4
LM_REQUESTS, LM_NEW_TOKENS, LM_MAX_BATCH, LM_MAX_SEQ = 8, 16, 4, 128
# Under the reference's init (std 1/sqrt(L) for every stacked layer weight)
# the scores q.k/sqrt(128) are of order 1e2: each softmax is nearly
# one-hot and amplifies rounding.  The LM checks hold the kernel-backed
# logits (and, at fp32, decode) to the plain-backed ones within
# flash_attention.PREFILL_TOLS, placed by planted faults
# (--lm-planted-faults).  The witnesses beside them are reports: the plain
# path on the card against it on the CPU (fp32), and the plain path's bf16
# logits against its fp32 logits (bf16).


class PhaseFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-planted-faults", action="store_true",
                    help="only read how far planted attention faults move "
                    "the phi3 logits (the readings behind PREFILL_TOLS), "
                    "then exit")
    ap.add_argument("--flash-planted-faults", action="store_true",
                    help="only read how far faults planted in copies of "
                    "the flash kernels move their output (the readings "
                    "behind flash_attention.CHECK_TOLS), then exit")
    ap.add_argument("--svd-parts", metavar="TREE", type=Path,
                    help="only time the dense fp64 n = 4096 svd part by "
                    "part with the port under TREE/src (a checkout of this "
                    "or another commit), then exit; run it on two trees in "
                    "turns to compare them on one card")
    ap.add_argument("--wy-bounds", action="store_true",
                    help="only time the large-m compact-WY kernels at the "
                    "stage-1 panel with and without their products and "
                    "staging, beside PyTorch's copies of C, then exit")
    ap.add_argument("--wy-planted-faults", action="store_true",
                    help="only read how far faults planted in copies of "
                    "the compact-WY apply move its output at the main "
                    "shapes, against the fp64 wy_tol, then exit")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 1
    tree = (args.svd_parts or ROOT).resolve()
    if not (tree / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch in {tree}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree / "src"))
    try:
        if args.lm_planted_faults:
            return lm_planted_faults(args, torch)
        if args.flash_planted_faults:
            return flash_planted_faults(args, torch)
        if args.wy_planted_faults:
            return wy_planted_faults(args, torch)
        if args.wy_bounds:
            return wy_bounds(args, torch)
        if args.svd_parts:
            return svd_parts(args, torch, tree)
        return run(args, torch)
    except PhaseFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# measuring helpers
# ---------------------------------------------------------------------------

def gpu_ms(torch, fn, iters: int = 1, warmup: int = 0) -> float:
    """Device milliseconds per call, from CUDA events around ``iters``
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(key: str) -> str:
    """A profiler key without its return type, namespace and arguments:
    ``void (anonymous namespace)::k<double, 64>((anonymous namespace)::
    Args)`` -> ``k<double, 64>``."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("(")[0].removeprefix("void ").strip()


def profiler_ms(torch, fn, name: str, iters: int):
    """(device ms per call, kernels per call, ms of each kernel) of the
    kernels whose name contains ``name``, over ``iters`` calls of ``fn``,
    from torch.profiler: a call launches each of its kernels (each of its
    own name) once, so its time is the sum over those names of the
    kernel's mean time (which a trace that drops an event does not skew).
    None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    means = {kernel_name(ev.key):
             ev.device_time_total / ev.count / 1e3
             for ev in prof.key_averages()
             if name in ev.key and ev.count and ev.device_time_total > 0}
    return ((sum(means.values()), len(means), means) if means else None)


def max_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, the output's scale max(1, max |want|))."""
    g = got.double()
    w = want.double()
    return (float((g - w).abs().max()) if w.numel() else 0.0,
            max(1.0, float(w.abs().max())) if w.numel() else 1.0)


def panel_cells(b_in: int, tw: int, fuse: int) -> int:
    """Band cells a (super-)cycle reads and writes: the union over its
    cycles of the two panels each cycle changes."""
    h = b_in + 2 * tw + 1
    w = b_in + tw + 1
    cells = set()
    for i in range(fuse):
        for y in range(h):
            for x in range(w):
                in_col = y >= tw and x <= tw
                in_row = y >= h - 1 - tw
                if in_col or in_row:
                    cells.add((h - 1 - (y - x), i * b_in + x))
    return len(cells)


def chase_bound(b_in, tw, g, fuse, dtype, itemsize):
    """(bound_ms, bound_by, bytes, flops) of one chase launch: each panel
    cell read once and written once, about 5 flops per panel cell per cycle
    (dot product and rank-1 update)."""
    h = b_in + 2 * tw + 1
    w = b_in + tw + 1
    nbytes = 2 * g * panel_cells(b_in, tw, fuse) * itemsize + g * (1 + fuse)
    flops = g * fuse * 5 * ((h - tw) * (tw + 1) + (tw + 1) * w)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def sturm_bound(b, n, max_iter, dtype, itemsize):
    """z, bound read once, sigma written once; 3 flops (multiply, divide,
    subtract) per step of every pivot recurrence, a division counted as
    one."""
    nbytes = (b * (2 * n - 1) + b + b * n) * itemsize
    flops = 3 * b * n * max_iter * (2 * n - 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def main_path_shapes(bc, runs):
    """Kernel shapes the main-path runs launch, from each run's stage plan
    and wavefront width: every stage (b_in, tw) with B*G slots for a batch
    of B, at the run's fuse depth and dtype, and the bisection's (B, n)."""
    cycle, superstep, sturm = [], [], []
    for lead, n, cfg in runs:
        b = math.prod(lead)
        for b_in, tw in cfg.plan:
            g = b * bc.stage_schedule(n, b_in, tw, cfg.fuse)[2]
            if cfg.fuse == 1:
                cycle.append((b_in, tw, g, cfg.dtype))
            else:
                superstep.append((b_in, tw, g, cfg.fuse, cfg.dtype))
        sturm.append((b, n, cfg.dtype))
    return (sorted(set(cycle)), sorted(set(superstep)), sorted(set(sturm)))


def tape_apply_calls(bc, runs):
    """``tape_apply`` calls of the full-SVD runs ``(lead, n, cfg)``, as
    (layout, S, m, k, w, dtype, where), addressed as the main path does:
    the stage-1 QR update of the trailing block of the padded (B, big, big)
    matrix ("trailing", where = (big, c0)) and the stage-1 replay on the
    accumulator rows at and below a pivot ("below", where = (n, first
    row), the QR and the LQ block), at panels 0, P // 2 and P - 1 (the
    others differ in m and w only); and each chase stage's replay through
    a row table into the padded (B, n_pad, n) accumulators ("rows", where =
    (b_in, tw, fuse))."""
    calls = set()
    for lead, n, cfg in runs:
        b, nb = math.prod(lead), cfg.bw
        panels = max(1, -(-(n - 1) // nb))
        big = (panels + 2) * nb
        for p in {0, panels // 2, panels - 1}:
            c0 = p * nb
            calls.add(("trailing", b, big - c0, nb, big - c0 - nb,
                       cfg.dtype, (big, c0)))
            for r0 in (c0, c0 + nb):
                if r0 < n:
                    calls.add(("below", b, n - r0, nb, n, cfg.dtype,
                               (n, r0)))
        for b_in, tw in cfg.plan:
            g = bc.stage_schedule(n, b_in, tw, cfg.fuse)[2]
            calls.add(("rows", b * g * cfg.fuse, tw + 1, 1, n, cfg.dtype,
                       (b_in, tw, cfg.fuse)))
    return sorted(calls)


def replay_table(torch, bc, tr, n, b_in, tw, fuse):
    """The row table of super-cycle T // 2 of one chase stage, as the
    replay passes it (int32, (G*K, tw+1)), and the accumulators' rows."""
    _, T, G = bc.stage_schedule(n, b_in, tw, fuse)
    rows = tr._replay_rows(n, b_in, tw, fuse, T, G, "cuda")[T // 2]
    n_pad = n + (b_in + tw + 1) * (1 + G * fuse)
    return rows.reshape(G * fuse, tw + 1).to(torch.int32), n_pad


def tape_call_inputs(torch, bc, tr, call, dtype, gen):
    """(v, t, c, rows, whole) of one ``tape_apply_calls`` call on the card:
    V unit lower trapezoidal from its first row, T upper triangular times
    0.2, as the reference's kernel test makes them; c the view or the
    accumulator the main path passes, and ``whole`` the tensor it lies
    in."""
    layout, s, m, k, w, _, where = call

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device="cuda")

    t = (torch.triu(randn(s, k, k)) * 0.2).to(dtype)
    v = torch.tril(randn(s, m, k), -1)
    d = min(m, k)
    v[:, torch.arange(d), torch.arange(d)] = 1.0
    if layout == "rows":
        rows, n_pad = replay_table(torch, bc, tr, w, *where)
        whole = randn(s // rows.shape[0], n_pad, w).to(dtype)
        return v.to(dtype), t, whole, rows, whole
    size, r0 = where
    whole = randn(s, size, size).to(dtype)
    c = whole[:, r0:, r0 + k:] if layout == "trailing" else whole[:, r0:]
    vpar = torch.zeros((s, r0 + m, k), dtype=dtype, device="cuda")
    vpar[:, r0:] = v.to(dtype)
    return vpar[:, r0:], t, c, None, whole


def fused_bound(b, n, bw, max_iter, dtype, itemsize):
    """Values mode: the matrices read once and sigma written once; per
    reflector of the walk (support L) 3L flops to build it and 5L per
    nonzero row or column it meets (dot products 2, update 3); 3 flops per
    step of the bisection's pivot recurrences.

    The nonzeros a reflector meets: a right one on row k over columns
    [lo, hi] meets rows [k, hi] (above k the band ends before lo); a left
    one on column lo over rows [lo, hi] meets columns [lo, min(hi + bw,
    n - 1)] (the band, and the bulge, end there).  This holds for both
    phases.  The kernel does more work than this: like the reference, it
    applies every reflector across all n rows or columns."""
    from repro_torch.kernels.ref import effective_bw, fused_walk
    bw = effective_bw(n, bw)
    flops = 3 * b * n * max_iter * (2 * n - 1)
    for right, k, lo, hi in fused_walk(n, bw):
        meets = hi - k + 1 if right else min(hi + bw, n - 1) - lo + 1
        flops += b * (3 + 5 * meets) * (hi - lo + 1)
    nbytes = (b * n * n + b * n) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_bound(bh, bh_kv, s, d, dtype, itemsize):
    """q (bh rows) and the grouped k, v (bh_kv rows) read once and o
    written once; 4*D flops per (query, key) pair on or below the diagonal
    (two products), at the card's peak for matrix products of the type
    (bf16/fp16 on the tensor cores; fp32 at fp32 precision, 67 TFLOP/s)."""
    nbytes = 2 * (bh + bh_kv) * s * d * itemsize
    flops = 4 * bh * d * s * (s + 1) // 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_MATMUL_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_check_cases(wgmma_d) -> dict:
    """Cases (BH, S, D, g, dtype) that hold each flash kernel to the plain
    version, k and v of BH / g rows.  The wgmma kernel: the FLASH_SHAPES of
    D in ``wgmma_d`` and (8, S, D) at FLASH_SHORT_S, in bf16 and fp16, at
    g = 1 and 4 (where 4 divides BH), and the serving run's shape.
    flash_attn.cu: every FLASH_SHAPE in fp32, those of the D it alone takes
    in bf16 and fp16, one more grouped case and the fp32 check's shape."""
    wg_shapes = [sh for sh in FLASH_SHAPES if sh[2] in wgmma_d] + [
        (8, sl, d) for sl in FLASH_SHORT_S for d in wgmma_d]
    return {
        "flash_attention_wgmma_cuda": [
            (bh, sl, d, g, dn) for bh, sl, d in wg_shapes
            for g in (1, FLASH_GROUP) if bh % g == 0
            for dn in ("bfloat16", "float16")] + [
            FLASH_MAIN + (FLASH_GROUP, "bfloat16")],
        "flash_attention_cuda": [
            sh + (1, "float32") for sh in FLASH_SHAPES] + [
            sh + (1, dn) for sh in FLASH_SHAPES if sh[2] not in wgmma_d
            for dn in ("bfloat16", "float16")] + [
            (8, 300, 32, FLASH_GROUP, "float32"),
            FLASH_MAIN + (FLASH_GROUP, "float32")]}


def flash_inputs(torch, rng, bh, s, d, g, dname):
    """Standard normal q (bh, s, d) and k, v (bh / g, s, d) on the card."""
    return tuple(torch.from_numpy(rng.standard_normal((rows, s, d))).to(
        "cuda", getattr(torch, dname)) for rows in (bh, bh // g, bh // g))


def logit_err(torch, got, want) -> float:
    """max |got - want| over max(1, max |want|), in chunks along the
    sequence (each logits tensor is 1.6 GB at b = 2, s = 2048)."""
    err, scale = 0.0, 1.0
    for g, w in zip(got.split(256, dim=1), want.split(256, dim=1)):
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err / scale


def wy_inputs(torch, s, m, k, w, dtype, rng, orthogonal=False):
    """V (unit lower trapezoidal), T and C of a compact-WY apply, made from
    ``rng`` on the card.  ``orthogonal``: T from Householder taus, so that
    I - V T V^T is orthogonal and repeated applies stay bounded (timing);
    else T upper triangular times 0.2, as the reference's kernel test."""
    import numpy as np

    from repro_torch.core import stage1
    v = np.tril(rng.standard_normal((s, m, k)), -1)
    v[:, np.arange(k), np.arange(k)] = 1.0
    v = torch.from_numpy(v).cuda()
    if orthogonal:
        taus = 2.0 / (v * v).sum(1)
        t = stage1.wy_t_factor(v, taus)
    else:
        t = torch.from_numpy(np.triu(rng.standard_normal((s, k, k))) * 0.2
                             ).cuda()
    c = torch.from_numpy(rng.standard_normal((s, m, w))).cuda()
    return v.to(dtype), t.to(dtype), c.to(dtype)


def wy_tol(dname: str, k: int) -> float:
    return WY_TOL_BF16 if dname == "bfloat16" else TOLS[dname] * max(1, k // 4)


def tape_bound(s, m, k, w, dtype, itemsize, table_bytes=0):
    """V, T, C (and a row table) read once and C written once; 4*m*k*w +
    2*k*k*w flops per slot (the three products and the subtraction), at the
    card's peak for matrix products of the type."""
    nbytes = (s * m * k + s * k * k + 2 * s * m * w) * itemsize + table_bytes
    flops = s * (4 * m * k * w + 2 * k * k * w)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_MATMUL_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


@contextlib.contextmanager
def timed_parts(torch, parts):
    """While open, each function ``getattr(module, name)`` of ``parts``
    (label -> (module, name)) runs between CUDA events and ends in a
    synchronise, so the host clock covers that part alone.  Yields the dict
    label -> {"device_ms", "wall_s"} that the calls fill.

    ``core/svd.py``'s pipeline calls its parts through these module
    attributes.  torch.profiler would name the parts too, but a full SVD
    at n = 4096 runs millions of ops, whose trace takes minutes to parse."""
    out, saved = {}, []

    def timed(label, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            res = fn(*a, **kw)
            end.record()
            torch.cuda.synchronize()
            out[label] = {"device_ms": start.elapsed_time(end),
                          "wall_s": time.perf_counter() - t0}
            return res
        return call

    try:
        for label, (mod, name) in parts.items():
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, timed(label, saved[-1][2]))
        yield out
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def banded_matrix(torch, lead, n, bw, dtype, gen):
    """Random upper-banded (lead..., n, n) matrix on the card."""
    a = torch.zeros(tuple(lead) + (n, n), dtype=torch.float64, device="cuda")
    for k in range(bw + 1):
        vals = torch.randn(tuple(lead) + (n - k,), generator=gen,
                           dtype=torch.float64, device="cuda")
        a.diagonal(k, -2, -1).copy_(vals)
    return a.to(dtype)


# ---------------------------------------------------------------------------
# the LM serving path
# ---------------------------------------------------------------------------

def lm_phases(args, torch, rng, drive, gen) -> None:
    """phi3-medium-14b at full width.  ``lm_phi3_fp32_check``: four layers
    in fp32, the kernel-backed prefill against the plain-backed one and
    against one-token decode at every position.  ``lm_phi3_serve``: all
    40 layers in bf16, a timed prefill against the plain-backed one, the
    bf16 witness, and the Engine.  Each model is freed before the next
    phase."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import PREFILL_TOLS
    from repro_torch.launch import serve as lserve
    from repro_torch.models import build
    from repro_torch.serve import ServeConfig

    phi3 = get_config(LM_ARCH)
    toks = torch.from_numpy(rng.integers(0, phi3.vocab, (LM_B, LM_S))).cuda()
    batch = {"tokens": toks}

    # ---- 10. four layers in fp32: kernel against plain, decode ---------
    torch.cuda.reset_peak_memory_stats()
    cfg4 = dataclasses.replace(phi3, n_layers=LM_CHECK_LAYERS,
                               dtype="float32")
    m4 = build(cfg4).init_params(gen)
    m4.prefill({"tokens": toks[:, :64]})          # warm-up: cuBLAS, kernel
    got, run_k = drive(f"{LM_ARCH} fp32 {LM_CHECK_LAYERS} layers prefill "
                       f"b={LM_B} s={LM_S} (flash_attn.cu)",
                       lambda: m4.prefill(batch), ["flash_attention"])
    check(run_k["launches"]["flash_attention"] == LM_CHECK_LAYERS
          and run_k["launches"]["flash_attention_wgmma"] == 0,
          f"phase 10: expected {LM_CHECK_LAYERS} launches of flash_attn.cu "
          f"and none of the wgmma kernel, got {run_k['launches']}")
    t0 = time.perf_counter()
    want = m4.prefill(batch, backend="ref")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = logit_err(torch, got, want)
    finite = bool(torch.isfinite(got).all())
    # the witness: the plain path on the CPU against it on the card
    host = build(cfg4, device="cpu")
    host.load_state_dict(m4.state_dict())
    t0 = time.perf_counter()
    want_cpu = host.prefill({"tokens": toks[:1].cpu()})
    cpu_s = time.perf_counter() - t0
    witness = logit_err(torch, want[:1].cpu(), want_cpu)
    del host, want_cpu
    caches = m4.init_caches(LM_B, LM_S)
    step_err, step_err_plain = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(LM_S):
        logits, caches = m4.decode_step(toks[:, t:t + 1], caches, t)
        step_err.append((logits[:, 0] - got[:, t]).abs().amax())
        step_err_plain.append((logits[:, 0] - want[:, t]).abs().amax())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    scale = max(1.0, float(got.abs().max()))
    step_err = torch.stack(step_err).cpu().numpy() / scale
    dec_plain = float(torch.stack(step_err_plain).max()) / scale
    del want
    dec_all, dec_last8 = float(step_err.max()), float(step_err[-8:].max())
    tol = PREFILL_TOLS["float32"]
    ok10 = (finite and err <= tol and dec_all <= tol
            and tuple(got.shape) == (LM_B, LM_S, phi3.padded_vocab))
    emit({"phase": "lm_phi3_fp32_check", "ok": ok10, "arch": LM_ARCH,
          "layers": LM_CHECK_LAYERS, "dtype": "float32", "tf32": False,
          "b": LM_B, "s": LM_S, "params": sum(p.numel()
                                             for p in m4.parameters()),
          "kernel_vs_plain_err_over_scale": err,
          "tol": tol, "witness_plain_card_vs_cpu_row0": witness,
          "cpu_prefill_s": cpu_s,
          "logit_scale": scale,
          "decode_vs_prefill_err_over_scale": dec_all,
          "decode_vs_prefill_last8": dec_last8,
          "decode_vs_plain_prefill": dec_plain,
          "prefill_kernel_s": run_k["wall_s"], "prefill_plain_s": plain_s,
          "decode_steps": LM_S, "decode_ms_per_step": decode_s / LM_S * 1e3,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "runs": [run_k]})
    check(ok10, f"phase 10: phi3 fp32 prefill beyond {tol:.0e} of its "
          "plain version or of decode")
    del m4, got, caches, logits
    torch.cuda.empty_cache()

    # ---- 11. all 40 layers in bf16: prefill, witness, the Engine -------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = build(phi3).init_params(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m.prefill(batch)                                   # warm-up
    got, run_p = drive(f"{LM_ARCH} bf16 prefill b={LM_B} s={LM_S} "
                       f"(flash_attn_wgmma.cu)", lambda: m.prefill(batch),
                       ["flash_attention_wgmma"])
    check(run_p["launches"]["flash_attention_wgmma"] == phi3.n_layers
          and run_p["launches"]["flash_attention"] == 0,
          f"phase 11: expected {phi3.n_layers} launches of the wgmma kernel "
          f"and none of flash_attn.cu, got {run_p['launches']}")
    prefill_s = run_p["device_ms"] / 1e3
    split = prefill_split(torch, m, batch)
    got = got.cpu()
    t0 = time.perf_counter()
    plain = m.prefill(batch, backend="ref")
    torch.cuda.synchronize()
    plain_prefill_s = time.perf_counter() - t0
    plain = plain.cpu()
    reqs = lserve.make_requests(phi3, LM_REQUESTS, LM_NEW_TOKENS, args.seed)
    stats, run_e = drive(
        f"{LM_ARCH} bf16 Engine: {LM_REQUESTS} requests x {LM_NEW_TOKENS} "
        f"new tokens", lambda: lserve.serve(
            m, reqs, ServeConfig(max_batch=LM_MAX_BATCH,
                                 max_seq=LM_MAX_SEQ)), [])
    peak_bf16 = torch.cuda.max_memory_allocated() / 2**30
    m.to_dtype(torch.float32)                          # the same weights
    ref32 = m.prefill(batch, backend="ref").cpu()
    peak_fp32 = torch.cuda.max_memory_allocated() / 2**30
    del m
    torch.cuda.empty_cache()
    finite = bool(torch.isfinite(got).all())
    kern_err = logit_err(torch, got, ref32)
    witness = logit_err(torch, plain, ref32)
    kern_vs_plain = logit_err(torch, got, plain)
    v = phi3.vocab
    top1 = ref32[..., :v].argmax(-1)
    agree_k = float((got[..., :v].argmax(-1) == top1).float().mean())
    agree_p = float((plain[..., :v].argmax(-1) == top1).float().mean())
    served = stats["done"]
    tol = PREFILL_TOLS["bfloat16"]
    ok11 = (finite and kern_vs_plain <= tol
            and len(served) == LM_REQUESTS
            and all(len(r.output) == LM_NEW_TOKENS
                    and all(0 <= t < v for t in r.output) for r in served))
    emit({"phase": "lm_phi3_serve", "ok": ok11, "arch": LM_ARCH,
          "layers": phi3.n_layers, "d_model": phi3.d_model,
          "heads": [phi3.n_heads, phi3.n_kv, phi3.head_dim],
          "d_ff": phi3.d_ff, "vocab": phi3.vocab, "dtype": phi3.dtype,
          "params": phi3.total_params(), "init_s": init_s,
          "prefill": {"b": LM_B, "s": LM_S, "seconds": prefill_s,
                      "wall_s": run_p["wall_s"],
                      "tokens_per_s": LM_B * LM_S / prefill_s,
                      "plain_attention_wall_s": plain_prefill_s,
                      "launches": run_p["launches"], "split": split},
          "kernel_vs_plain_bf16": kern_vs_plain, "tol": tol,
          "witness": {"kernel_bf16_vs_fp32": kern_err,
                      "plain_bf16_vs_fp32": witness,
                      "top1_agreement_with_fp32_kernel": agree_k,
                      "top1_agreement_with_fp32_plain": agree_p,
                      "scale": "max(1, max|fp32 logit|)"},
          "engine": {"requests": stats["requests"], "tokens": stats["tokens"],
                     "rounds": stats["rounds"], "seconds": stats["seconds"],
                     "tokens_per_s": stats["tokens_per_s"],
                     "max_batch": LM_MAX_BATCH, "max_seq": LM_MAX_SEQ,
                     "launches": run_e["launches"],
                     "first_outputs": [r.output for r in served[:2]]},
          "peak_gib_bf16": peak_bf16, "peak_gib_with_fp32_copy": peak_fp32,
          "runs": [run_p, run_e]})
    check(ok11, f"phase 11: phi3 bf16 prefill beyond {tol} of its plain "
          "version, or the Engine did not answer every request")
    del got, plain, ref32, top1


def prefill_split(torch, model, batch) -> dict:
    """Where one prefill's device time goes, from one torch.profiler trace:
    device busy time, the wgmma attention kernel, the fp32 logits product
    (the prefill's one fp32 GEMM, found by cuBLAS's kernel names), the rest
    (the layer products, norms, RoPE and elementwise work), and the largest
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.prefill(batch)
        torch.cuda.synchronize()
    kern = [ev for ev in prof.key_averages() if ev.device_time_total > 0]

    def ms(evs):
        return sum(ev.device_time_total for ev in evs) / 1e3

    attn = [ev for ev in kern if "attn_wgmma_kernel" in ev.key]
    logits = [ev for ev in kern if "gemm" in ev.key
              and ("f32f32" in ev.key or "sgemm" in ev.key)]
    busy = ms(kern)
    top = sorted(kern, key=lambda ev: ev.device_time_total, reverse=True)[:6]
    return {"profiled_busy_ms": busy, "attention_kernel_ms": ms(attn),
            "attention_launches": sum(ev.count for ev in attn),
            "logits_product_ms": ms(logits),
            "logits_kernels": [[ev.key[:80], ev.count] for ev in logits],
            "rest_ms": busy - ms(attn) - ms(logits),
            "top_device_kernels": [
                {"kernel": ev.key[:80], "count": ev.count,
                 "device_ms": ev.device_time_total / 1e3} for ev in top]}


@contextlib.contextmanager
def planted_fault(torch, ops, fault: str, cfg):
    """Swap a faulty attention op in for ``ops.flash_attention``:
    ``"mask_off_by_one"``, plain causal attention in which row i also sees
    key i + 1; ``"gqa_group_order"``, the kernel with the KV heads expanded
    to the query heads in tiled order (query head h reads KV head h % n_kv,
    not h // g) and handed over with g = 1."""
    orig = ops.flash_attention
    nh, nkv = cfg.n_heads, cfg.n_kv
    tiled = [h % nkv for h in range(nh)]

    def faulty(q, k, v, **kw):
        if fault == "mask_off_by_one":
            s_len, d = q.shape[1], q.shape[2]
            g = q.shape[0] // k.shape[0]
            k, v = k.repeat_interleave(g, 0), v.repeat_interleave(g, 0)
            sc = torch.einsum("bsd,btd->bst", q.float(), k.float())
            sc.mul_(d ** -0.5)
            ahead = torch.ones((s_len, s_len), dtype=torch.bool,
                               device=q.device).triu(2)
            w = torch.softmax(sc.masked_fill_(ahead, -1e30), dim=-1)
            return torch.einsum("bst,btd->bsd", w, v.float()).to(q.dtype)
        bkv, s_len, d = k.shape
        k, v = (t.view(bkv // nkv, nkv, s_len, d)[:, tiled].reshape(
            bkv // nkv * nh, s_len, d).contiguous() for t in (k, v))
        return orig(q, k, v, **kw)

    ops.flash_attention = faulty
    try:
        yield
    finally:
        ops.flash_attention = orig


def lm_planted_faults(args, torch) -> int:
    """How far a planted attention fault moves the phi3 logits, beside the
    sound kernel's error, at the shapes the LM checks hold: phase 10's
    (four layers fp32, b = 2, s = 2048, kernel against plain), the card
    test's (two layers fp32, b = 1, s = 70, kernel on the card against
    plain on the CPU) and phase 11's (40 layers bf16, kernel against
    plain).  One JSON line each; these readings place LM_TOLS."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    phi3 = get_config(LM_ARCH)
    faults = ("mask_off_by_one", "gqa_group_order")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, phi3.vocab, (LM_B, LM_S))).cuda()

    def readings(label, model, batch, want):
        out = {"case": label,
               "sound": logit_err(torch, model.prefill(batch).cpu(), want)}
        for fault in faults:
            with planted_fault(torch, ops, fault, phi3):
                out[fault] = logit_err(torch, model.prefill(batch).cpu(),
                                       want)
        emit(out)

    cfg4 = dataclasses.replace(phi3, n_layers=LM_CHECK_LAYERS,
                               dtype="float32")
    m = build(cfg4).init_params(gen)
    readings("fp32 4 layers b=2 s=2048, kernel vs plain on the card", m,
             {"tokens": toks}, m.prefill({"tokens": toks},
                                         backend="ref").cpu())
    del m
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(phi3, n_layers=2, dtype="float32")
    m = build(cfg2).init_params(torch.Generator(device="cuda").manual_seed(0))
    host = build(cfg2, device="cpu")
    host.load_state_dict(m.state_dict())
    t2 = np.random.default_rng(3).integers(0, cfg2.vocab, (1, 70))
    readings("fp32 2 layers b=1 s=70, card kernel vs CPU plain "
             "(test_phi3_width_prefill_on_the_card_matches_the_cpu)", m,
             {"tokens": t2}, host.prefill({"tokens": t2}))
    del m, host
    torch.cuda.empty_cache()

    m = build(phi3).init_params(gen)
    readings("bf16 40 layers b=2 s=2048, kernel vs plain on the card", m,
             {"tokens": toks}, m.prefill({"tokens": toks},
                                         backend="ref").cpu())
    return 0


def flash_planted_faults(args, torch) -> int:
    """How far the faults of FLASH_FAULTS, each built into its own copy of
    its kernel's source in a temporary directory, move the kernel's output
    from the plain version, beside the sound kernels' readings: at every
    case of flash_check_cases and of the wgmma kernel's card tests, as
    ``flash_attention.row_error`` (what CHECK_TOLS holds) and as the former
    whole-output measure max|err| / max(1, max|o|).  The late-tile faults
    are read where S spans more than two 128-row tiles.  One JSON line per
    kernel and dtype; these readings place CHECK_TOLS."""
    import ctypes
    import tempfile

    import numpy as np

    from repro_torch.kernels import _build, flash_attention, ref

    rng = np.random.default_rng(args.seed)
    tmp = tempfile.TemporaryDirectory()
    procs = {}
    for fault, (source, _, edits) in FLASH_FAULTS.items():
        text = (_build.CSRC / _build.SOURCES[source]).read_text()
        for old, new, times in edits:
            check(text.count(old) == times, f"{fault}: {old!r} occurs "
                  f"{text.count(old)} times, expected {times}")
            text = text.replace(old, new)
        cu, so = (Path(tmp.name) / f"{fault}{ext}" for ext in (".cu", ".so"))
        cu.write_text(text)
        procs[fault] = (subprocess.Popen(
            _build.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for fault, (proc, so) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{fault}: nvcc failed:\n{log}")
        libs[fault] = ctypes.CDLL(str(so))

    def planted(fault, q, k, v):
        bh, s_len, d = q.shape
        suffix = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}[q.dtype]
        fn = getattr(libs[fault], f"{FLASH_FAULTS[fault][0]}_{suffix}")
        out = torch.empty_like(q)
        err = fn(*(ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, out)),
                 bh, k.shape[0], s_len, d, ctypes.c_float(1.0 / d ** 0.5),
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        check(err == 0, f"{fault}: error {err}")
        return out

    def whole(got, want):
        err, scale = max_err(torch, got, want)
        return err / scale

    cases = flash_check_cases(flash_attention.WGMMA_D)
    cases["flash_attention_wgmma_cuda"] += [
        (2 * g, sl, d, g, dn) for sl in FLASH_CARD_S
        for d in flash_attention.WGMMA_D for g in (1, FLASH_GROUP)
        for dn in ("bfloat16", "float16")]
    sources = {"flash_attention_wgmma_cuda": "flash_attn_wgmma",
               "flash_attention_cuda": "flash_attn"}
    for name, kcases in cases.items():
        fn = getattr(flash_attention, name)
        for dname in ("float32", "bfloat16", "float16"):
            sound, faults = [], {}
            for case in (c for c in kcases if c[4] == dname):
                q, k, v = flash_inputs(torch, rng, *case)
                want = ref.flash_attention_ref(q, k, v)
                got = fn(q, k, v)
                sound.append((flash_attention.row_error(got, want),
                              whole(got, want), case))
                here = [f for f, (src, dn, _) in FLASH_FAULTS.items()
                        if src == sources[name] and dn == dname
                        and ("stale" not in f or case[1] > 2 * 128)]
                for fault in here:
                    got = planted(fault, q, k, v)
                    faults.setdefault(fault, []).append(
                        (flash_attention.row_error(got, want),
                         whole(got, want), case))
                del q, k, v, want, got
            if not sound:
                continue
            emit({"kernel": name, "dtype": dname, "cases": len(sound),
                  "tol": flash_attention.CHECK_TOLS[dname],
                  "sound_row_error_max": max(sound),
                  "sound_whole_max": max(x[1] for x in sound),
                  "faults": {f: {"cases": len(r),
                                 "row_error_min": min(r),
                                 "whole_min": min(x[1] for x in r),
                                 "whole_max": max(x[1] for x in r)}
                             for f, r in faults.items()}})
    tmp.cleanup()
    return 0


def replay_profile(torch, bc, tr, ops, n, cfg, gen) -> None:
    """One chase stage's replay (the dense run's last stage, at its real
    shape) through ``transforms.replay_chase`` on Householder tapes made
    from ``gen``: timed, then under torch.profiler, counting its
    ``tape_apply`` calls, their device kernels and the eager gathers and
    scatters (``aten::index``, ``aten::index_put_``).  Fails unless every
    call is one kernel, no call gathers or scatters and the result is
    finite.  (The tapes are random, so their last reflectors reach past
    row n, which a chase's never do: U is not held to orthogonality
    here.)"""
    from torch.profiler import ProfilerActivity, profile
    b_in, tw = cfg.plan[-1]
    _, T, G = bc.stage_schedule(n, b_in, tw, cfg.fuse)
    v = torch.randn((1, T, G, cfg.fuse, 2, tw + 1), generator=gen,
                    dtype=torch.float64, device="cuda")
    v[..., 0] = 1.0
    tau = 2.0 / (v * v).sum(-1)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")[None]

    def stage():
        return tr.replay_chase(eye.clone(), eye.clone(), v, tau, n=n,
                               b_in=b_in, tw=tw, fuse=cfg.fuse)

    stage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ut, vt = stage()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(ut).all() and torch.isfinite(vt).all())
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    calls = ops.launch_counts()["tape_apply_cuda"]
    ka = prof.key_averages()
    count = {key: sum(ev.count for ev in ka if ev.key == key)
             for key in ("aten::index", "aten::index_put_")}
    kernels = [ev for ev in ka if "tape_apply_kernel" in ev.key]
    n_kernels = sum(ev.count for ev in kernels)
    busy_us = sum(ev.device_time_total for ev in ka
                  if "CUDA" in str(ev.device_type))
    ok = (calls == 2 * T and n_kernels == calls
          and sum(count.values()) < calls and finite)
    emit({"phase": "replay_profile", "ok": ok, "n": n, "b_in": b_in,
          "tw": tw, "fuse": cfg.fuse, "slots": G * cfg.fuse,
          "super_cycles": T, "tape_apply_calls": calls,
          "tape_apply_device_kernels": n_kernels,
          "kernel_names": sorted({ev.key[:60] for ev in kernels}),
          "eager_ops": count, "wall_s": wall,
          "us_per_call": wall / max(calls, 1) * 1e6,
          "profiled_wall_s": wall_prof,
          "device_busy_share": busy_us / 1e6 / wall_prof,
          "finite": finite})
    check(ok, "replay profile: a tape_apply call was not one kernel, or "
          "the replay still gathers or scatters per call")


def wy_copies(variants):
    """Build each variant of ``hh_apply.cu`` (name -> [(text, replacement,
    times it occurs)]) in a temporary directory, one ``nvcc`` each, all at
    once; returns the directory and name -> its fp64 entry point, bound as
    ``hh_apply.launch_with`` takes it."""
    import ctypes
    import tempfile

    from repro_torch.kernels import _build, hh_apply

    tmp = tempfile.TemporaryDirectory()
    procs = {}
    text0 = (_build.CSRC / _build.SOURCES["hh_apply"]).read_text()
    for name, edits in variants.items():
        text = text0
        for old, new, times in edits:
            check(text.count(old) == times, f"{name}: {old!r} occurs "
                  f"{text.count(old)} times, expected {times}")
            text = text.replace(old, new)
        cu, so = (Path(tmp.name) / f"{name}{ext}" for ext in (".cu", ".so"))
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            _build.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{name}: nvcc failed:\n{log}")
        fns[name] = hh_apply.set_argtypes(ctypes.CDLL(str(so)).tape_apply_f64)
    return tmp, fns


def wy_bounds(args, torch) -> int:
    """What bounds the large-m path at the stage-1 panel (1, 4224, 64, 4224)
    fp64: each of its three kernels' device time (torch.profiler, mean of
    20 calls) in the repository's build and in copies of ``hh_apply.cu``
    without the products (WY_PROBES), beside two copies of C by PyTorch (a
    read, ``sum``; a read and a write, ``copy_``) as the card's yardsticks
    for the bytes.  One JSON line; changes nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import stage1
    from repro_torch.kernels import _build, hh_apply

    _build.build_all(["hh_apply"])
    tmp, fns = wy_copies(WY_PROBES)
    fns["repository"] = hh_apply._fn(torch.float64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    v = torch.tril(torch.randn((1, 4224, 64), generator=gen,
                               dtype=torch.float64, device="cuda"), -1)
    v[:, torch.arange(64), torch.arange(64)] = 1.0
    t = stage1.wy_t_factor(v, 2.0 / (v * v).sum(1))
    c = torch.randn((1, 4224, 4224), generator=gen, dtype=torch.float64,
                    device="cuda")
    c2 = torch.empty_like(c)

    def per_kernel(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return {kernel_name(ev.key):
                ev.device_time_total / ev.count / 1e3
                for ev in prof.key_averages()
                if ev.count and ev.device_time_total > 0}

    out = {name: per_kernel(lambda fn=fn: hh_apply.launch_with(fn, v, t, c))
           for name, fn in fns.items()}
    out["torch sum of C (read)"] = gpu_ms(torch, lambda: c.sum(), 20, 2)
    out["torch copy_ of C (read and write)"] = gpu_ms(
        torch, lambda: c2.copy_(c), 20, 2)
    tmp.cleanup()
    emit({"wy_bounds": "S=1, m=4224, k=64, w=4224 fp64", "ms": out,
          "card": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True, text=True,
              timeout=60).stdout.strip()})
    return 0


SVD_PARTS = {"stage1": ("s1", "band_reduce"),
             "stage2": ("bc", "bidiagonalize"),
             "replay": ("transforms", "accumulate_transforms"),
             "stage3_values": ("s3", "bidiag_singular_values"),
             "stage3_vectors": ("s3", "bidiag_vectors")}


def svd_parts(args, torch, tree) -> int:
    """The dense fp64 n = 4096 ``svd`` (bw 64, fuse 4) of the main path,
    part by part (``timed_parts``), with the port under ``tree``, after a
    warm-up at n = 256; with its reconstruction and orthogonality.  One
    JSON line."""
    from repro_torch.core import svd as tsvd
    from repro_torch.core.tuning import PipelineConfig
    from repro_torch.kernels import _build

    _build.build_all()
    f64 = torch.float64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    warm = torch.randn((256, 256), generator=gen, dtype=f64, device="cuda")
    tsvd.svd(warm, config=PipelineConfig.resolve(bw=64, dtype=f64, n=256,
                                                 fuse=4))
    n = 4096
    cfg = PipelineConfig.resolve(bw=64, dtype=f64, n=n, fuse=4)
    a = torch.randn((n, n), generator=gen, dtype=f64, device="cuda")
    torch.cuda.synchronize()
    parts = {label: (getattr(tsvd, mod), name)
             for label, (mod, name) in SVD_PARTS.items()}
    with timed_parts(torch, parts) as times:
        t0 = time.perf_counter()
        u, s, vt = tsvd.svd(a, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eye = torch.eye(n, dtype=f64, device="cuda")
    recon = float(torch.linalg.norm(a - (u * s) @ vt) / torch.linalg.norm(a))
    orth = max(float((u.mT @ u - eye).abs().max()),
               float((vt @ vt.mT - eye).abs().max()))
    ok = recon <= 50 * n * torch.finfo(f64).eps and orth <= 1e-9
    emit({"svd_parts_of": str(tree), "ok": ok, "n": n, "wall_s": wall,
          "parts_wall_s": {k: v["wall_s"] for k, v in times.items()},
          "recon_rel_fro": recon, "orth": orth})
    check(ok, "svd off its reconstruction or orthogonality bounds")
    return 0


def wy_planted_faults(args, torch) -> int:
    """How far the faults of WY_FAULTS, each built into its own copy of
    ``hh_apply.cu`` in a temporary directory, move ``tape_apply_cuda``'s
    output from the plain version at the main shapes, beside the sound
    kernel's reading: the stage-1 panel (1, 4224, 64, 4224), the first
    panel's trailing block (a view of the padded matrix) and the last
    chase stage's replay through its row table, all fp64 at n = 4096.
    One JSON line per shape: max|err| over max(1, max|plain|), and that
    over the fp64 ``wy_tol``.  Fails when a fault reads less than
    WY_FAULT_FACTOR times wy_tol where it acts."""
    from repro_torch.core import bulge_chasing as bc
    from repro_torch.core import transforms as tr
    from repro_torch.core.tuning import PipelineConfig
    from repro_torch.kernels import hh_apply, ref

    tmp, fns = wy_copies({f: edits for f, (_, edits) in WY_FAULTS.items()})
    n, bw = 4096, 64
    cfg = PipelineConfig.resolve(bw=bw, dtype=torch.float64, n=n, fuse=4)
    big = (max(1, -(-(n - 1) // bw)) + 2) * bw
    b_in, tw = cfg.plan[-1]
    s_last = bc.stage_schedule(n, b_in, tw, cfg.fuse)[2] * cfg.fuse
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    shapes = {
        "panel": ("below", 1, big, bw, big, "float64", (big, 0)),
        "trailing": ("trailing", 1, big, bw, big - bw, "float64", (big, 0)),
        "replay": ("rows", s_last, tw + 1, 1, n, "float64",
                   (b_in, tw, cfg.fuse))}
    failed = []
    for label, call in shapes.items():
        v, t, c, rows, whole = tape_call_inputs(torch, bc, tr, call,
                                                torch.float64, gen)
        before = whole.clone()
        if rows is None:
            want = ref.tape_apply_ref(v, t, c)
        else:
            want = ref.tape_apply_ref(v, t, before.clone(), rows=rows)
        tol = wy_tol("float64", call[3])

        def reading(fn):
            whole.copy_(before)
            hh_apply.launch_with(fn, v, t, c if rows is None else whole,
                                 rows)
            torch.cuda.synchronize()
            err, scale = max_err(torch, c if rows is None else whole, want)
            return err / scale

        sound = reading(hh_apply._fn(torch.float64))
        faults = {}
        for fault, (acts, _) in WY_FAULTS.items():
            got = reading(fns[fault])
            faults[fault] = {"err_over_scale": got, "over_tol": got / tol,
                             "acts_here": label in acts}
            if label in acts and got < WY_FAULT_FACTOR * tol:
                failed.append((label, fault, got / tol))
        emit({"shape": label, "call": call[:6], "plan": str(
            hh_apply.launch_shape(*call[2:5], torch.float64)),
              "wy_tol": tol, "sound_err_over_scale": sound,
              "sound_over_tol": sound / tol, "faults": faults})
        del v, t, c, rows, whole, before, want
    tmp.cleanup()
    check(not failed, f"planted faults below {WY_FAULT_FACTOR} x wy_tol: "
          f"{failed}")
    return 0


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run(args, torch) -> int:
    import numpy as np

    from repro_torch.core import bidiag_svd as s3
    from repro_torch.core import bulge_chasing as bc
    from repro_torch.core import svd as tsvd
    from repro_torch.core import transforms as tr
    from repro_torch.core.tuning import PipelineConfig
    from repro_torch.kernels import (_build, bisect, bulge_chase,
                                     flash_attention, fused_small, hh_apply,
                                     ops, ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for log in _build.LOGS.values()
             for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "sources": sorted(_build.SOURCES.values()), "ptxas": ptxas})

    # ---- 1. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    emit({"phase": "device", "ok": True, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- the main path's runs, resolved before they are driven ----------
    n3, bw3 = 4096, 64                    # phase 3: fp64, tw = 16
    n4, bw4 = 16384, 64                   # phase 4: the paper's scale
    b5, n5, bw5 = 32, 1024, 32            # phase 5: batched
    f64, f32 = torch.float64, torch.float32
    cfg1 = PipelineConfig.resolve(bw=bw3, dtype=f64, n=n3, fuse=1)
    cfg4 = PipelineConfig.resolve(bw=bw3, dtype=f64, n=n3, fuse=4)
    cfg32 = PipelineConfig.resolve(bw=bw3, dtype=f32, n=n3)
    c1 = PipelineConfig.resolve(bw=bw4, dtype=f32, n=n4, fuse=1)
    c4 = PipelineConfig.resolve(bw=bw4, dtype=f32, n=n4, fuse=4)
    c5 = PipelineConfig.resolve(bw=bw5, dtype=f64, n=n5)
    nd, bwd = 4096, 64                    # dense fp64 full SVD, tw = 16
    b7, n7, bw7 = 16, 512, 32             # batched fp32 full SVD
    cd = PipelineConfig.resolve(bw=bwd, dtype=f64, n=nd, fuse=4)
    c7 = PipelineConfig.resolve(bw=bw7, dtype=f32, n=n7, fuse=4)
    tw4 = c1.tw
    # the fused small-n tier: (B, n, bw, dtype) of its two runs
    fused_main = [(64, 64, 8, "float64"), (64, 256, 32, "float32")]
    runs = [((), n3, cfg1), ((), n3, cfg4), ((), n3, cfg32), ((), n4, c1),
            ((), n4, c4), ((b5,), n5, c5), ((), nd, cd), ((b7,), n7, c7)]
    main_cycle, main_super, main_sturm = main_path_shapes(bc, runs)
    main_tape = tape_apply_calls(bc, [((), nd, cd), ((b7,), n7, c7)])

    # ---- 2. kernels against their plain versions ------------------------
    # The reference's test shapes in every dtype and K in {2, 4}; every
    # stage shape the main path launches (derived above) in every dtype;
    # the bisection at every (B, n, dtype) of the main path for a few steps
    # and at n = 512 for its full step count.
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    dtypes = {"float64": f64, "float32": f32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    cycle_shapes = sorted({s + (d,) for s in CHASE_SHAPES for d in TOLS} | {
        s[:3] + (d,) for s in main_cycle for d in TOLS})
    super_shapes = sorted({s + (k, d) for s in CHASE_SHAPES for k in (2, 4)
                           for d in TOLS} | {
        s[:4] + (d,) for s in main_super for d in TOLS})
    worst = {"chase_cycle_cuda": 0.0, "chase_superstep_cuda": 0.0,
             "sturm_bisect_cuda": 0.0, "tape_apply_cuda": 0.0,
             "fused_small_svd_cuda": 0.0, "flash_attention_cuda": 0.0,
             "flash_attention_wgmma_cuda": 0.0}
    main_err = dict.fromkeys(worst, 0.0)
    n_cmp = 0

    def compare(name, got, want, tol, key, main, err_of=None):
        """Hold ``got`` to ``want``: max |got - want| within ``tol`` times
        max(1, max|want|), or ``err_of(got, want)`` within ``tol``;
        ``main``: a main-path shape in the main path's dtype, whose max
        |got - want| goes into the kernels line."""
        nonlocal n_cmp
        for g_, w_ in zip(got, want):
            err, scale = (max_err(torch, g_, w_) if err_of is None
                          else (err_of(g_, w_), 1.0))
            ratio = err / (tol * scale)
            worst[name] = max(worst[name], ratio)
            check(ratio <= 1.0, f"{name} at {key}: err {err:.3e} > "
                  f"{tol:.1e} * {scale:.3g}")
            n_cmp += 1
        if main:
            main_err[name] = max(main_err[name],
                                 max_err(torch, got[0], want[0])[0])

    for b_in, tw, g, dname in cycle_shapes:
        h, w = b_in + 2 * tw + 1, b_in + tw + 1
        win = torch.from_numpy(rng.standard_normal((g, h, w))).to(
            dev, dtypes[dname])
        first = torch.from_numpy(np.arange(g) % 2 == 0).to(dev)
        want = ref.chase_cycle_ref(win, first, b_in=b_in, tw=tw,
                                   with_tape=True)
        got = bulge_chase.chase_cycle_cuda(win.clone(), first, b_in=b_in,
                                           tw=tw, with_tape=True)
        torch.cuda.synchronize()
        key = (b_in, tw, g, dname)
        compare("chase_cycle_cuda", got, want, TOLS[dname], key,
                key in main_cycle)
    for b_in, tw, g, k, dname in super_shapes:
        h, wk = b_in + 2 * tw + 1, k * b_in + tw + 1
        blk = torch.from_numpy(rng.standard_normal((g, h, wk))).to(
            dev, dtypes[dname])
        first = torch.from_numpy(np.arange(g) % 2 == 0).to(dev)
        live = torch.from_numpy(rng.integers(1, k + 1, size=g)).to(dev)
        act = torch.arange(k, device=dev)[None, :] < live[:, None]
        kw = dict(b_in=b_in, tw=tw, fuse=k, with_tape=True)
        want = ref.chase_superstep_ref(blk, first, act, **kw)
        got = bulge_chase.chase_superstep_cuda(blk.clone(), first, act, **kw)
        torch.cuda.synchronize()
        key = (b_in, tw, g, k, dname)
        compare("chase_superstep_cuda", got, want, TOLS[dname], key,
                key in main_super)

    def gk_inputs(n, b, dtype):
        d = torch.from_numpy(rng.standard_normal((b, n))).to(dev, dtype)
        e = torch.from_numpy(rng.standard_normal((b, n))).to(dev, dtype)
        return s3.gk_problem(d, e)[:2]

    n_s = 512
    sturm_cases = [(b, n, d, STURM_CHECK_STEPS, True)
                   for b, n, d in main_sturm] + [
        (1, n_s, d, s3.default_bisect_iters(dtypes[d]), False)
        for d in STURM_TOLS]
    for b, n, dname, iters, main in sturm_cases:
        z, bound = gk_inputs(n, b, dtypes[dname])
        want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
        got = bisect.sturm_bisect_cuda(z, bound, n=n, max_iter=iters)
        torch.cuda.synchronize()
        compare("sturm_bisect_cuda", [got], [want], STURM_TOLS[dname],
                (b, n, dname, iters), main)
    # the compact-WY apply: the reference's shapes (one slot and five),
    # contiguous, and every main-path call as the main path addresses it
    # (views of the trailing block and of the rows below a pivot; row
    # tables into the replay's accumulators), each in fp64, fp32 and bf16
    # (tolerance: wy_tol); a view's call leaves the rest of its tensor as it
    # was, bit for bit
    tape_cases = sorted({(sl, m, k, w, d) for m, k, w in WY_SHAPES
                         for sl in (1, 5) for d in TOLS})
    for sl, m, k, w, dname in tape_cases:
        v, t, c = wy_inputs(torch, sl, m, k, w, dtypes[dname], rng)
        want = ref.tape_apply_ref(v, t, c)
        got = hh_apply.tape_apply_cuda(v, t, c.clone())
        torch.cuda.synchronize()
        compare("tape_apply_cuda", [got], [want], wy_tol(dname, k),
                (sl, m, k, w, dname), False)
        del v, t, c, want, got
    wy_gen = torch.Generator(device="cuda")
    wy_gen.manual_seed(args.seed)
    for call in main_tape:
        for dname in TOLS:
            v, t, c, rows, whole = tape_call_inputs(torch, bc, tr, call,
                                                    dtypes[dname], wy_gen)
            before = whole.clone()
            if rows is None:
                want = ref.tape_apply_ref(v, t, c)
                hh_apply.tape_apply_cuda(v, t, c)
                got = c.clone()
                c.copy_(before[:, -c.shape[1]:, -c.shape[2]:])
                check(torch.equal(whole, before), f"tape_apply_cuda at "
                      f"{call[:6]} {dname}: wrote outside its view")
            else:
                want = ref.tape_apply_ref(v, t, before.clone(), rows=rows)
                got = hh_apply.tape_apply_cuda(v, t, whole, rows)
            torch.cuda.synchronize()
            compare("tape_apply_cuda", [got], [want], wy_tol(dname, call[3]),
                    call[:6] + (dname,), dname == call[5])
            del v, t, c, rows, whole, before, want, got
    one = wy_inputs(torch, 1, 64, 8, 100, f64, rng)
    got = hh_apply.hh_block_apply_cuda(one[0][0], one[1][0],
                                       one[2][0].clone())
    torch.cuda.synchronize()
    compare("tape_apply_cuda", [got],
            [ref.hh_block_apply_ref(one[0][0], one[1][0], one[2][0])],
            TOLS["float64"] * 2, "hh_block_apply (64, 8, 100)", False)
    # the fused kernel: the reference's shapes and the main path's, each in
    # fp64 and fp32, in values and in uv mode (tolerances: fused_small's
    # CHECK_TOLS and ENTRY_TOL_FP64).  At the main path's shapes a witness
    # of how far the plain version's own (d, e, U2, V2^T) move: on the CPU
    # against on the card, and on the card when each entry of A moves by
    # about one ulp.
    fused_errs, witness = {}, {}

    def fused_err(kind, dname, err):
        fused_errs[f"{kind} {dname}"] = max(
            fused_errs.get(f"{kind} {dname}", 0.0), err)

    def rel(got_, want_):
        err, scale = max_err(torch, got_, want_)
        return err / scale

    fused_cases = sorted({sh + (d,) for sh in fused_small.CHECK_SHAPES
                          for d in fused_small.CHECK_TOLS} | {
        sh[:3] + (d,) for sh in fused_main for d in fused_small.CHECK_TOLS})
    name = "fused_small_svd_cuda"
    for b, n, bw, dname in fused_cases:
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to(
            dev, dtypes[dname])
        tol, tol_uv = fused_small.CHECK_TOLS[dname]
        key = (b, n, bw, dname)
        want = ref.fused_small_svd_ref(a, bw=bw)
        got = fused_small.fused_small_svd_cuda(a, bw=bw)
        torch.cuda.synchronize()
        compare(name, [got], [want], tol, key, key in fused_main)
        fused_err("sigma", dname, rel(got, want))
        got = fused_small.fused_small_svd_cuda(a, bw=bw, compute_uv=True)
        want = ref.fused_small_svd_ref(a, bw=bw, compute_uv=True)
        torch.cuda.synchronize()
        sg, sw = (s3.bidiag_singular_values(x[0], x[1]) for x in (got, want))
        compare(name, [sg], [sw], tol, key + ("uv sigma of (d, e)",), False)
        inv = fused_small.uv_invariants(a, *got)
        worst[name] = max(worst[name], max(inv) / tol_uv)
        fused_err("uv invariants", dname, max(inv))
        check(max(inv) <= tol_uv, f"{name} at {key}: uv factors' "
              f"(recon, orth U2, orth V2) {inv} > {tol_uv:.1e}")
        n_cmp += 1
        entries = fused_small.entry_error(got, want)
        fused_err("uv entries", dname, entries)
        if dname == "float64":
            tol_e = fused_small.ENTRY_TOL_FP64
            worst[name] = max(worst[name], entries / tol_e)
            check(entries <= tol_e, f"{name} at {key}: uv entries "
                  f"{entries:.3e} > {tol_e:.1e} of the scale")
            n_cmp += 1
        if key in fused_main:
            eps = torch.finfo(a.dtype).eps
            moved = (a.double() * (1 + eps * torch.from_numpy(
                rng.standard_normal((b, n, n))).to(dev))).to(a.dtype)
            witness[f"B={b} n={n} bw={bw} {dname}"] = {
                "kernel_vs_plain": entries,
                "plain_card_vs_cpu": fused_small.entry_error(
                    want, ref.fused_small_svd_ref(a.cpu(), bw=bw,
                                                  compute_uv=True)),
                "plain_one_ulp_move_of_a": fused_small.entry_error(
                    ref.fused_small_svd_ref(moved, bw=bw, compute_uv=True),
                    want)}
            del moved
        del a, got, want
    # causal flash attention (flash_check_cases), each query row held to
    # its own size (flash_attention.row_error)
    flash_cases = flash_check_cases(flash_attention.WGMMA_D)
    flash_main = {"flash_attention_wgmma_cuda": "bfloat16",
                  "flash_attention_cuda": "float32"}
    for name, cases in flash_cases.items():
        fn = getattr(flash_attention, name)
        for bh, sl, d, g, dname in cases:
            q, k, v = flash_inputs(torch, rng, bh, sl, d, g, dname)
            want = ref.flash_attention_ref(q, k, v)
            got = fn(q, k, v)
            torch.cuda.synchronize()
            compare(name, [got], [want], flash_attention.CHECK_TOLS[dname],
                    (bh, sl, d, g, dname),
                    (bh, sl, d) == FLASH_MAIN and g == FLASH_GROUP
                    and dname == flash_main[name],
                    err_of=flash_attention.row_error)
            del q, k, v, want, got
    emit({"phase": "kernels_vs_plain", "ok": True, "comparisons": n_cmp,
          "main_path_shapes": {
              "chase_cycle_cuda (b_in, tw, slots, dtype)": main_cycle,
              "chase_superstep_cuda (b_in, tw, slots, K, dtype)": main_super,
              "sturm_bisect_cuda (B, n, dtype)": main_sturm,
              "tape_apply_cuda (layout, S, m, k, w, dtype, where)":
                  main_tape,
              "fused_small_svd_cuda (B, n, bw, dtype)": fused_main,
              "flash_attention_wgmma_cuda (BH, S, D, g, dtype)":
                  FLASH_MAIN + (FLASH_GROUP, "bfloat16"),
              "flash_attention_cuda (BH, S, D, g, dtype)":
                  FLASH_MAIN + (FLASH_GROUP, "float32")},
          "flash_cases": flash_cases,
          "fused_cases": len(fused_cases),
          "fused_worst_err_over_scale": fused_errs,
          "fused_uv_entries_witness": witness,
          "tape_apply_cases": len(tape_cases) + len(main_tape) * len(TOLS),
          "sturm_steps_at_main_path_shapes": STURM_CHECK_STEPS,
          "worst_err_over_tol": {k: round(v, 6) for k, v in worst.items()},
          "main_path_max_abs_err": main_err,
          "tolerances": {"chase fp64/fp32/bf16": [1e-12, 3e-5, 8e-2],
                         "sturm fp64/fp32": [1e-13, 1e-5],
                         "tape_apply fp64/fp32": "chase's, times "
                                                 "max(1, k // 4)",
                         "tape_apply bf16": WY_TOL_BF16,
                         "fused fp64/fp32 (sigma, uv invariants)":
                             [fused_small.CHECK_TOLS["float64"],
                              fused_small.CHECK_TOLS["float32"]],
                         "fused uv entries fp64": fused_small.ENTRY_TOL_FP64,
                         "flash fp32/bf16/fp16 (per query row: "
                         "|got - plain| / |plain|)":
                             list(flash_attention.CHECK_TOLS.values()),
                         "scale": "max(1, max|plain|)"}})

    # ---- per-kernel times at the main path's shapes ----------------------
    # "ms" is the kernel's own device time from torch.profiler when the
    # profiler sees it; "events_ms" is CUDA events over back-to-back calls
    # of the wrapper, which includes the host's launch gaps.
    timing = {}
    g1 = bc.stage_schedule(n4, bw4, tw4, 1)[2]
    g2 = bc.stage_schedule(n4, bw4, tw4, 4)[2]

    def time_kernel(name, symbol, call, plain, iters, plain_iters, shape,
                    bound, library=None, library_iters=5):
        events = gpu_ms(torch, call, iters=iters, warmup=2)
        prof = profiler_ms(torch, call, symbol, min(iters, 50))
        timing[name] = dict(
            shape=shape, ms=prof[0] if prof is not None else events,
            ms_from="torch.profiler" if prof is not None else "cuda events",
            events_ms=events, profiler_ms=prof and prof[0],
            kernels_per_call=prof and prof[1],
            ms_by_kernel=prof and prof[2],
            plain_ms=gpu_ms(torch, plain, iters=plain_iters,
                            warmup=1 if plain_iters > 1 else 0),
            library_ms=(gpu_ms(torch, library, iters=library_iters,
                               warmup=1) if library is not None else None),
            bound=bound)

    win = torch.from_numpy(rng.standard_normal(
        (g1, bw4 + 2 * tw4 + 1, bw4 + tw4 + 1))).to(dev, torch.float32)
    first = torch.zeros(g1, dtype=torch.bool, device=dev)
    kw = dict(b_in=bw4, tw=tw4)
    time_kernel(
        "chase_cycle_cuda", "chase_cycle_kernel",
        lambda: bulge_chase.chase_cycle_cuda(win, first, **kw),
        lambda: ref.chase_cycle_ref(win, first, **kw), 500, 20,
        f"windows ({g1},{bw4 + 2 * tw4 + 1},{bw4 + tw4 + 1}) fp32, "
        f"b_in={bw4}, tw={tw4}", chase_bound(bw4, tw4, g1, 1, "float32", 4))

    wk = 4 * bw4 + tw4 + 1
    blk = torch.from_numpy(rng.standard_normal(
        (g2, bw4 + 2 * tw4 + 1, wk))).to(dev, torch.float32)
    first2 = torch.zeros(g2, dtype=torch.bool, device=dev)
    act = torch.ones(g2, 4, dtype=torch.bool, device=dev)
    kw2 = dict(b_in=bw4, tw=tw4, fuse=4)
    time_kernel(
        "chase_superstep_cuda", "chase_superstep_kernel",
        lambda: bulge_chase.chase_superstep_cuda(blk, first2, act, **kw2),
        lambda: ref.chase_superstep_ref(blk, first2, act, **kw2), 500, 10,
        f"blocks ({g2},{bw4 + 2 * tw4 + 1},{wk}) fp32, b_in={bw4}, "
        f"tw={tw4}, K=4", chase_bound(bw4, tw4, g2, 4, "float32", 4))

    # the library yardstick computes the same values from the dense
    # bidiagonal whose Golub-Kahan off-diagonal is z (built outside the
    # timing)
    z, bound = gk_inputs(n_s, 1, torch.float64)
    dense_b = (torch.diag(z[0, 0::2]) + torch.diag(z[0, 1::2], 1))
    time_kernel(
        "sturm_bisect_cuda", "sturm_bisect_kernel",
        lambda: bisect.sturm_bisect_cuda(z, bound, n=n_s, max_iter=60),
        lambda: s3.bisect_plain(z, bound, n=n_s, max_iter=60), 5, 1,
        f"B=1, n={n_s} fp64, 60 steps",
        sturm_bound(1, n_s, 60, "float64", 8),
        library=lambda: torch.linalg.svdvals(dense_b))
    # the compact-WY apply at the stage-1 panel shape (contiguous, the
    # shape earlier designs were timed at) and at the last chase stage's
    # replay shape of the dense run, through its row table into the padded
    # accumulator as the replay calls it; I - V T V^T is orthogonal here,
    # so the repeated in-place applies stay bounded.  The library yardstick
    # is the same function as a PyTorch user writes it, three cuBLAS
    # products (the subtraction fused into the last), on the replay's rows
    # gathered beforehand
    big_d = (max(1, -(-(nd - 1) // bwd)) + 2) * bwd
    b_last, tw_last = cd.plan[-1]
    v, t, c = wy_inputs(torch, 1, big_d, bwd, big_d, f64, rng,
                        orthogonal=True)
    time_kernel(
        "tape_apply_cuda", "tape_apply_kernel",
        lambda: hh_apply.tape_apply_cuda(v, t, c),
        lambda: ref.tape_apply_ref(v, t, c), 20, 3,
        f"S=1, m={big_d}, k={bwd}, w={big_d} fp64",
        tape_bound(1, big_d, bwd, big_d, "float64", 8),
        library=lambda: torch.baddbmm(c, v, torch.bmm(t, torch.bmm(v.mT, c)),
                                      alpha=-1))
    rows, n_pad = replay_table(torch, bc, tr, nd, b_last, tw_last, cd.fuse)
    s_last, m_last = rows.shape
    v, t, _ = wy_inputs(torch, s_last, m_last, 1, 1, f64, rng,
                        orthogonal=True)
    acc = torch.randn((1, n_pad, nd), generator=wy_gen, dtype=f64,
                      device="cuda")
    slab = acc[:, rows.long()].reshape(s_last, m_last, nd)
    time_kernel(
        "tape_apply_cuda (replay)", "tape_apply_kernel",
        lambda: hh_apply.tape_apply_cuda(v, t, acc, rows),
        lambda: ref.tape_apply_ref(v, t, acc, rows=rows), 200, 20,
        f"S={s_last}, m={m_last}, k=1, w={nd} fp64, row table into "
        f"(1, {n_pad}, {nd})",
        tape_bound(s_last, m_last, 1, nd, "float64", 8,
                   table_bytes=rows.numel() * 4),
        library=lambda: torch.baddbmm(slab, v, torch.bmm(t, torch.bmm(
            v.mT, slab)), alpha=-1))
    del v, t, c, acc, slab
    # the fused kernel at both main-path shapes, values mode; the library
    # yardstick is one cuSOLVER call for the singular values of the batch
    for i, (b, n, bw, dname) in enumerate(fused_main):
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to(
            dev, dtypes[dname])
        iters = s3.default_bisect_iters(dtypes[dname])
        time_kernel(
            "fused_small_svd_cuda" + ("" if i == 0 else " (second shape)"),
            "fused_small_kernel",
            lambda a=a, bw=bw: fused_small.fused_small_svd_cuda(a, bw=bw),
            lambda a=a, bw=bw: ref.fused_small_svd_ref(a, bw=bw),
            20 if i == 0 else 10, 1, f"B={b}, n={n}, bw={bw} {dname}, "
            f"values", fused_bound(b, n, bw, iters, dname,
                                   a.element_size()),
            library=lambda a=a: torch.linalg.svdvals(a))
        del a
    # causal flash attention at the main path's shape with grouped KV
    # heads: the wgmma kernel in bf16 (the serving run), flash_attn.cu in
    # fp32 (the fp32 check).  The library yardstick is PyTorch's fused
    # attention, scaled_dot_product_attention with is_causal=True, on q and
    # the KV heads repeated to the query heads (built outside the timing)
    import torch.nn.functional as tnf
    bh, sl, d = FLASH_MAIN
    bkv = bh // FLASH_GROUP
    for name, symbol, dname, iters, plain_iters in (
            ("flash_attention_wgmma_cuda", "attn_wgmma_kernel", "bfloat16",
             50, 5),
            ("flash_attention_cuda", "flash_attn_kernel", "float32", 10, 3)):
        fn = getattr(flash_attention, name)
        q, k, v = (torch.from_numpy(rng.standard_normal((rows, sl, d))).to(
            dev, dtypes[dname]) for rows in (bh, bkv, bkv))
        kr, vr = (x.repeat_interleave(FLASH_GROUP, 0) for x in (k, v))
        time_kernel(
            name, symbol, lambda fn=fn, q=q, k=k, v=v: fn(q, k, v),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v), iters,
            plain_iters, f"q ({bh},{sl},{d}), k and v ({bkv},{sl},{d}) "
            f"{dname}, causal",
            flash_bound(bh, bkv, sl, d, dname, q.element_size()),
            library=lambda q=q, kr=kr, vr=vr: tnf.scaled_dot_product_attention(
                q[None], kr[None], vr[None], is_causal=True),
            library_iters=iters)
        del q, k, v, kr, vr
    emit({"phase": "kernel_times", "ok": True, "card": smi_line,
          "kernels": {k: {kk: (vv if kk != "bound" else
                               {"ms": vv[0], "by": vv[1], "bytes": vv[2],
                                "flops": vv[3]})
                          for kk, vv in v.items()}
                      for k, v in timing.items()}})

    # ---- main path: counts set to 0 before each run, read after ---------
    main_counts = {k: 0 for k in ops.launch_counts()}

    def drive(label, fn, expect):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_host
        counts = ops.launch_counts()
        for k in expect:
            check(counts[k] > 0, f"{label}: kernel {k} was not launched")
        for k, v in counts.items():
            main_counts[k] += v
        return out, {"label": label, "device_ms": start.elapsed_time(end),
                     "wall_s": wall, "launches": counts}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    # warm-up on a small problem: loads the kernels, fills the allocator
    warm = banded_matrix(torch, (), 256, 64, torch.float64, gen)
    for f in (1, 4):
        tsvd.banded_singular_values(warm, config=PipelineConfig.resolve(
            bw=64, dtype=torch.float64, fuse=f))
    torch.cuda.synchronize()

    # ---- 3. fp64, n = 4096, bw = 64, checked against cuSOLVER -----------
    a3 = banded_matrix(torch, (), n3, bw3, torch.float64, gen)
    sig1, r1 = drive("fp64 n=4096 fuse=1 banded_singular_values",
                     lambda: tsvd.banded_singular_values(a3, config=cfg1),
                     ["chase_cycle_cuda", "sturm_bisect_cuda"])
    (d4, e4), r4a = drive("fp64 n=4096 fuse=4 bidiagonal_of",
                          lambda: tsvd.bidiagonal_of(a3, config=cfg4),
                          ["chase_superstep_cuda"])
    sig4, r4b = drive("fp64 n=4096 fuse=4 bidiag_singular_values",
                      lambda: s3.bidiag_singular_values(d4, e4),
                      ["sturm_bisect_cuda"])
    sv3 = torch.linalg.svdvals(a3)
    smax3 = float(sv3.max())
    err1 = float((sig1 - sv3).abs().max())
    err41 = float((sig4 - sig1).abs().max())
    tsvd.validate_sigma(sig1)
    ok3 = err1 <= 1e-10 * smax3 and err41 <= 1e-12 * smax3
    emit({"phase": "main_fp64_n4096", "ok": ok3, "n": n3, "bw": bw3,
          "tw": cfg1.tw, "plan": list(cfg1.plan), "sigma_max": smax3,
          "err_vs_svdvals": err1, "tol_vs_svdvals": 1e-10 * smax3,
          "err_fuse4_vs_fuse1": err41, "tol_fuse4": 1e-12 * smax3,
          "runs": [r1, r4a, r4b]})
    check(ok3, "phase 3: sigma off the fp64 yardstick or fuse-dependent")

    # the phase-3 matrix in fp32, against the fp64 yardstick
    sig32, r32 = drive("fp32 n=4096 fuse=1 banded_singular_values",
                       lambda: tsvd.banded_singular_values(
                           a3.float(), config=cfg32),
                       ["chase_cycle_cuda", "sturm_bisect_cuda"])
    err32 = float((sig32.double() - sv3).abs().max())
    ok32 = err32 <= 2e-4 * smax3
    del a3

    # ---- 4. fp32 at the paper's scale, n = 16384, bw = 64 ----------------
    a4 = banded_matrix(torch, (), n4, bw4, torch.float32, gen)
    fro2 = float((a4.double() ** 2).sum())
    s41, q1 = drive("fp32 n=16384 fuse=1 banded_singular_values",
                    lambda: tsvd.banded_singular_values(a4, config=c1,
                                                        check=True),
                    ["chase_cycle_cuda", "sturm_bisect_cuda"])
    (d, e), q4a = drive("fp32 n=16384 fuse=4 bidiagonal_of",
                        lambda: tsvd.bidiagonal_of(a4, config=c4),
                        ["chase_superstep_cuda"])
    s44, q4b = drive("fp32 n=16384 fuse=4 bidiag_singular_values",
                     lambda: s3.bidiag_singular_values(d, e),
                     ["sturm_bisect_cuda"])
    tsvd.validate_sigma(s44)
    rel1 = abs(float((s41.double() ** 2).sum()) - fro2) / fro2
    rel4 = abs(float((s44.double() ** 2).sum()) - fro2) / fro2
    smax4 = float(s41.max())
    d14 = float((s41 - s44).abs().max())
    ok4 = (rel1 <= 1e-4 and rel4 <= 1e-4 and d14 <= 1e-5 * smax4
           and ok32)
    emit({"phase": "main_fp32_n16384", "ok": ok4, "n": n4, "bw": bw4,
          "tw": c1.tw, "plan": list(c1.plan),
          "supercycles_per_stage_fuse4": [
              bc.stage_schedule(n4, b, t, 4)[1] for b, t in c1.plan],
          "cycles_per_stage_fuse1": [
              bc.stage_schedule(n4, b, t, 1)[1] for b, t in c1.plan],
          "frobenius_rel_err_fuse1": rel1, "frobenius_rel_err_fuse4": rel4,
          "tol_frobenius": 1e-4, "fuse4_vs_fuse1_max_abs": d14,
          "tol_fuse4_vs_fuse1": 1e-5 * smax4, "sigma_max": smax4,
          "fp32_n4096_err_vs_fp64_svdvals": err32,
          "tol_fp32_n4096": 2e-4 * smax3, "runs": [q1, q4a, q4b, r32]})
    check(ok4, "phase 4: Frobenius identity, fuse invariance or fp32 "
          "accuracy failed")
    timing["sturm_bisect_cuda"]["main_path_ms"] = q4b["device_ms"]
    timing["sturm_bisect_cuda"]["main_path_shape"] = \
        f"B=1, n={n4} fp32, 40 steps"
    timing["sturm_bisect_cuda"]["main_path_bound"] = sturm_bound(
        1, n4, 40, "float32", 4)
    del a4

    # ---- 5. batched, B = 32, n = 1024, bw = 32, fp64 --------------------
    a5 = banded_matrix(torch, (b5,), n5, bw5, torch.float64, gen)
    s5, q5 = drive("fp64 B=32 n=1024 fuse=1 banded_singular_values",
                   lambda: tsvd.banded_singular_values(a5, config=c5,
                                                       check=True),
                   ["chase_cycle_cuda", "sturm_bisect_cuda"])
    sv5 = torch.linalg.svdvals(a5)
    err5 = float(((s5 - sv5).abs().amax(-1) / sv5.amax(-1)).max())
    ok5 = s5.shape == (b5, n5) and err5 <= 1e-10
    emit({"phase": "batched_fp64_B32_n1024", "ok": ok5,
          "max_err_over_sigma_max": err5, "tol": 1e-10, "runs": [q5]})
    check(ok5, "phase 5: batched sigma off the yardstick")

    # ---- 6. dense fp64 n = 4096: singular values, then the full SVD -----
    full_path = ["chase_superstep_cuda", "sturm_bisect_cuda",
                 "tape_apply_cuda"]
    ad = torch.randn((nd, nd), generator=gen, dtype=f64, device="cuda")
    sig_d, rv = drive("fp64 n=4096 fuse=4 singular_values",
                      lambda: tsvd.singular_values(ad, config=cd), full_path)
    part_fns = {label: (getattr(tsvd, mod), name)
                for label, (mod, name) in SVD_PARTS.items()}
    with timed_parts(torch, part_fns) as parts:
        (ud, sd, vtd), ru = drive("fp64 n=4096 fuse=4 svd",
                                  lambda: tsvd.svd(ad, config=cd), full_path)
    # the compose (two products) and the entry point's own work
    parts["compose_and_rest"] = {"wall_s": ru["wall_s"] - sum(
        p["wall_s"] for p in parts.values())}
    svd_d = torch.linalg.svdvals(ad)
    smax_d = float(svd_d.max())
    err_d = float((sig_d - svd_d).abs().max())
    bits_d = float((sd - sig_d).abs().max())
    eye = torch.eye(nd, dtype=f64, device="cuda")
    recon_d = float(torch.linalg.norm(ad - (ud * sd) @ vtd)
                    / torch.linalg.norm(ad))
    orth_ud = float((ud.mT @ ud - eye).abs().max())
    orth_vd = float((vtd @ vtd.mT - eye).abs().max())
    tol_rec_d = 50 * nd * torch.finfo(f64).eps
    ok_d = (err_d <= 1e-10 * smax_d and bits_d == 0.0
            and torch.equal(sd, sig_d) and recon_d <= tol_rec_d
            and orth_ud <= 1e-9 and orth_vd <= 1e-9)
    emit({"phase": "dense_fp64_n4096", "ok": ok_d, "n": nd, "bw": bwd,
          "tw": cd.tw, "fuse": cd.fuse, "plan": list(cd.plan),
          "supercycles_per_stage": [bc.stage_schedule(nd, b, t, cd.fuse)[1]
                                    for b, t in cd.plan],
          "sigma_max": smax_d, "err_vs_svdvals": err_d,
          "tol_vs_svdvals": 1e-10 * smax_d,
          "svd_vs_singular_values_max_abs": bits_d,
          "recon_rel_fro": recon_d, "tol_recon": tol_rec_d,
          "orth_u": orth_ud, "orth_v": orth_vd, "tol_orth": 1e-9,
          "svd_parts": parts,
          "stage3_vectors_share_of_svd": (parts["stage3_vectors"]["wall_s"]
                                          / ru["wall_s"]),
          "runs": [rv, ru]})
    check(ok_d, "phase 6: dense fp64 full SVD off its bounds, or sigma not "
          "bit-identical to the values path")
    del ad, ud, vtd, eye
    replay_profile(torch, bc, tr, ops, nd, cd, wy_gen)

    # ---- 7. batched fp32 full SVD, B = 16, n = 512, bw = 32 -------------
    a7 = torch.randn((b7, n7, n7), generator=gen, dtype=f32, device="cuda")
    (u7, s7, vt7), r7 = drive(
        "fp32 B=16 n=512 fuse=4 svd_batched(compute_uv=True)",
        lambda: tsvd.svd_batched(a7, c7, compute_uv=True), full_path)
    a7d = a7.double()
    sv7 = torch.linalg.svdvals(a7d)
    err7 = float(((s7.double() - sv7).abs().amax(-1) / sv7.amax(-1)).max())
    res7 = (a7d - (u7.double() * s7.double()[..., None, :]) @ vt7.double())
    recon7 = float((torch.linalg.norm(res7, dim=(-2, -1))
                    / torch.linalg.norm(a7d, dim=(-2, -1))).max())
    eye7 = torch.eye(n7, dtype=f64, device="cuda")
    orth_u7 = float((u7.double().mT @ u7.double() - eye7).abs().max())
    orth_v7 = float((vt7.double() @ vt7.double().mT - eye7).abs().max())
    tol_rec7 = 50 * n7 * torch.finfo(f32).eps
    ok7 = (tuple(u7.shape) == (b7, n7, n7) and err7 <= 2e-4
           and recon7 <= tol_rec7 and orth_u7 <= 5e-3 and orth_v7 <= 5e-3)
    emit({"phase": "batched_fp32_B16_n512", "ok": ok7, "B": b7, "n": n7,
          "bw": bw7, "tw": c7.tw, "fuse": c7.fuse,
          "max_err_over_sigma_max": err7, "tol_sigma": 2e-4,
          "max_recon_rel_fro": recon7, "tol_recon": tol_rec7,
          "orth_u": orth_u7, "orth_v": orth_v7, "tol_orth": 5e-3,
          "runs": [r7]})
    check(ok7, "phase 7: batched fp32 full SVD off its bounds")
    del a7, a7d, u7, vt7, res7

    # ---- 8 and 9. the fused small-n tier against the staged pipeline ----
    def one_fused_launch(label, run, also=()):
        """The fused call launched the fused kernel once and, of the other
        kernels, only those in ``also``."""
        got = {k: v for k, v in run["launches"].items() if k not in also}
        want = {k: int(k == "fused_small_svd_cuda") for k in got}
        check(got == want,
              f"{label}: launches {run['launches']}, expected one "
              f"fused_small_svd_cuda and no chase or bisection launch")

    def fused_vs_staged(a, cfg, staged, iters):
        """Seconds per call of the fused tier and of the staged pipeline on
        the same batch, CUDA events around back-to-back calls after a
        warm-up call, and matrices per second."""
        t_f = gpu_ms(torch, lambda: tsvd.svd_batched(a, cfg), iters=iters,
                     warmup=1) / 1e3
        t_s = gpu_ms(torch, lambda: tsvd.svd_batched(a, staged), iters=1,
                     warmup=1) / 1e3
        b = a.shape[0]
        return {"fused_s": t_f, "staged_s": t_s,
                "fused_matrices_per_s": b / t_f,
                "staged_matrices_per_s": b / t_s,
                "staged_over_fused": t_s / t_f, "fused_iters": iters}

    def rel_err(s, want):
        return float(((s.double() - want.double()).abs().amax(-1)
                      / want.double().amax(-1)).max())

    staged_path = ["chase_cycle_cuda", "sturm_bisect_cuda", "tape_apply_cuda"]
    (bf, nf, bwf, _), (bg, ng, bwg, _) = fused_main
    cf = PipelineConfig.resolve(bw=bwf, dtype=f64, n=nf,
                                backend="fused_small")
    cs = PipelineConfig.resolve(bw=bwf, dtype=f64, n=nf)
    af = torch.randn((bf, nf, nf), generator=gen, dtype=f64, device="cuda")
    sig_f, rf = drive(f"fp64 B={bf} n={nf} fused svd_batched",
                      lambda: tsvd.svd_batched(af, cf, check=True),
                      ["fused_small_svd_cuda"])
    one_fused_launch("fused fp64 values", rf)
    sig_s, rs = drive(f"fp64 B={bf} n={nf} staged svd_batched",
                      lambda: tsvd.svd_batched(af, cs), staged_path)
    svf = torch.linalg.svdvals(af)
    err_fs, err_fl = rel_err(sig_f, sig_s), rel_err(sig_f, svf)
    (uf, suf, vtf), ruv = drive(
        f"fp64 B={bf} n={nf} fused svd_batched(compute_uv=True)",
        lambda: tsvd.svd_batched(af, cf, compute_uv=True, check=True),
        ["fused_small_svd_cuda", "sturm_bisect_cuda"])
    one_fused_launch("fused fp64 uv", ruv, also=("sturm_bisect_cuda",))
    eyef = torch.eye(nf, dtype=f64, device="cuda")
    res_f = (af - (uf * suf[..., None, :]) @ vtf).abs().amax((-2, -1))
    recon_f = float((res_f / suf.amax(-1)).max())
    orth_uf = float((uf.mT @ uf - eyef).abs().max())
    orth_vf = float((vtf @ vtf.mT - eyef).abs().max())
    err_uv = rel_err(suf, sig_f)
    ok_f = (tuple(sig_f.shape) == (bf, nf) and err_fs <= 1e-12
            and err_fl <= 1e-12 and recon_f <= 1e-11 and orth_uf <= 1e-11
            and orth_vf <= 1e-11 and err_uv <= 1e-13)
    times_f = fused_vs_staged(af, cf, cs, 10)
    emit({"phase": f"fused_fp64_B{bf}_n{nf}", "ok": ok_f, "B": bf, "n": nf,
          "bw": bwf, "staged_tw": cs.tw,
          "err_vs_staged_over_sigma_max": err_fs,
          "err_vs_svdvals_over_sigma_max": err_fl, "tol_sigma": 1e-12,
          "uv_recon_max_over_sigma_max": recon_f, "uv_orth_u": orth_uf,
          "uv_orth_v": orth_vf, "tol_uv": 1e-11,
          "uv_sigma_vs_values_over_sigma_max": err_uv, "tol_uv_sigma": 1e-13,
          **times_f, "runs": [rf, rs, ruv]})
    check(ok_f, "phase 8: fused fp64 sigma or vectors off their bounds")
    del af, uf, vtf

    cg = PipelineConfig.resolve(bw=bwg, dtype=f32, n=ng,
                                backend="fused_small")
    csg = PipelineConfig.resolve(bw=bwg, dtype=f32, n=ng)
    ag = torch.randn((bg, ng, ng), generator=gen, dtype=f32, device="cuda")
    sig_g, rg = drive(f"fp32 B={bg} n={ng} fused svd_batched",
                      lambda: tsvd.svd_batched(ag, cg, check=True),
                      ["fused_small_svd_cuda"])
    one_fused_launch("fused fp32 values", rg)
    sig_gs, rgs = drive(f"fp32 B={bg} n={ng} staged svd_batched",
                        lambda: tsvd.svd_batched(ag, csg), staged_path)
    svg = torch.linalg.svdvals(ag.double())
    err_gl = rel_err(sig_g, svg)
    ok_g = tuple(sig_g.shape) == (bg, ng) and err_gl <= 5e-4
    times_g = fused_vs_staged(ag, cg, csg, 5)
    emit({"phase": f"fused_fp32_B{bg}_n{ng}", "ok": ok_g, "B": bg, "n": ng,
          "bw": bwg, "staged_tw": csg.tw,
          "err_vs_fp64_svdvals_over_sigma_max": err_gl, "tol_sigma": 5e-4,
          "staged_err_vs_fp64_svdvals_over_sigma_max": rel_err(sig_gs, svg),
          **times_g, "runs": [rg, rgs]})
    check(ok_g, "phase 9: fused fp32 sigma off the fp64 yardstick")
    del ag

    # ---- 10 and 11. the LM serving path: phi3-medium-14b ---------------
    lm_phases(args, torch, rng, drive, gen)

    # ---- where stage 2's time goes: torch.profiler over one stage ------
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import band as bandmod
    n6 = 2048
    band6 = bandmod.pack(banded_matrix(torch, (), n6, bw4, torch.float32,
                                       gen), bw4, tw4)
    for f in (1, 4):
        def one_stage():
            return bc.reduce_stage_packed(band6, n=n6, b_in=bw4, tw=tw4,
                                          fuse=f, backend="cuda")
        one_stage()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_stage()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_stage()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        ka = prof.key_averages()
        on_card = [ev for ev in ka if "CUDA" in str(ev.device_type)]
        busy_us = sum(ev.device_time_total for ev in on_card)
        cpu_ops = [ev for ev in ka if ev not in on_card]
        top = sorted(cpu_ops, key=lambda ev: ev.self_cpu_time_total,
                     reverse=True)[:8]
        kern = sorted(on_card, key=lambda ev: ev.device_time_total,
                      reverse=True)[:5]
        cycles = bc.stage_schedule(n6, bw4, tw4, f)[1]
        emit({"phase": "stage2_profile", "ok": True, "n": n6, "b_in": bw4,
              "tw": tw4, "fuse": f, "dtype": "float32", "cycles": cycles,
              "wall_s": wall, "us_per_cycle": wall / cycles * 1e6,
              "profiled_wall_s": wall_prof,
              "device_busy_s": busy_us / 1e6 if busy_us else None,
              "device_idle_share": (1 - busy_us / 1e6 / wall_prof
                                    if busy_us else None),
              "top_host_ops": [
                  {"op": ev.key, "count": ev.count,
                   "self_cpu_ms": ev.self_cpu_time_total / 1e3}
                  for ev in top],
              "top_device_kernels": [
                  {"kernel": ev.key[:80], "count": ev.count,
                   "device_ms": ev.device_time_total / 1e3}
                  for ev in kern]})

    # ---- summary ---------------------------------------------------------
    sources = {"chase_cycle_cuda": "src/repro_torch/kernels/csrc/chase.cu",
               "chase_superstep_cuda": "src/repro_torch/kernels/csrc/chase.cu",
               "sturm_bisect_cuda": "src/repro_torch/kernels/csrc/sturm.cu",
               "tape_apply_cuda": "src/repro_torch/kernels/csrc/hh_apply.cu",
               "fused_small_svd_cuda":
                   "src/repro_torch/kernels/csrc/fused_small.cu",
               "flash_attention_cuda":
                   "src/repro_torch/kernels/csrc/flash_attn.cu",
               "flash_attention_wgmma_cuda":
                   "src/repro_torch/kernels/csrc/flash_attn_wgmma.cu"}
    replaces = {
        "chase_cycle_cuda": "src/repro/kernels/bulge_chase.py:126",
        "chase_superstep_cuda": "src/repro/kernels/bulge_chase.py:225",
        "sturm_bisect_cuda": "src/repro/core/bidiag_svd.py:97 (jnp "
                             "fori_loop; no pallas_call)",
        "tape_apply_cuda": "src/repro/kernels/hh_apply.py:56 (and "
                           "hh_block_apply_pallas :33)",
        "fused_small_svd_cuda": "src/repro/kernels/fused_small.py:266 "
                                "(pallas_call :298)",
        "flash_attention_cuda": "src/repro/kernels/flash_attention.py:64 "
                                "(pallas_call :74), fp32 and other D",
        "flash_attention_wgmma_cuda": "src/repro/kernels/flash_attention.py:"
                                      "64 (pallas_call :74), bf16/fp16 at "
                                      "D in {64, 128}"}
    # the flash kernels' counters keep the op's name, under which
    # ops.launch_counts() reports them; the others are named after their
    # kernel
    count_key = {"flash_attention_cuda": "flash_attention",
                 "flash_attention_wgmma_cuda": "flash_attention_wgmma"}
    kernels = []
    for name in sources:
        t = timing[name]
        bound = t["bound"]
        row = {"name": name, "route": "cuda", "source": sources[name],
               "replaces": replaces[name],
               "launches": main_counts[count_key.get(name, name)],
               "max_abs_err": main_err[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": bound[0],
               "bound_by": bound[1], "library_ms": t["library_ms"],
               "shape": t["shape"], "ms_from": t["ms_from"],
               "events_ms": t["events_ms"],
               "kernels_per_call": t["kernels_per_call"],
               "worst_err_over_tol": worst[name]}
        if "main_path_ms" in t:
            row.update(main_path_ms=t["main_path_ms"],
                       main_path_shape=t["main_path_shape"],
                       main_path_bound_ms=t["main_path_bound"][0])
        for suffix, field in ((" (replay)", "replay_shape"),
                              (" (second shape)", "second_shape")):
            second = timing.get(f"{name}{suffix}")
            if second is None:
                continue
            row[field] = {
                "shape": second["shape"], "ms": second["ms"],
                "ms_from": second["ms_from"],
                "kernels_per_call": second["kernels_per_call"],
                "plain_ms": second["plain_ms"],
                "library_ms": second["library_ms"],
                "bound_ms": second["bound"][0],
                "bound_by": second["bound"][1]}
        kernels.append(row)
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main path was never launched")
    emit({"phase": "total", "ok": True,
          "seconds": round(time.perf_counter() - t_all, 3)})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
