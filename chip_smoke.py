#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N] [--lm-planted-faults |
                           --flash-planted-faults | --chase-planted-faults |
                           --chase-bounds | --wy-planted-faults |
                           --wy-bounds | --fused-planted-faults |
                           --fused-threads | --fused-bounds |
                           --svd-parts TREE | --svd-serve | --svd-fabric]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card at every shape the main path launches it with,
then drives the main path: ``banded_singular_values`` (a banded matrix to
its singular values) at fuse=1 and fuse=4, ``singular_values`` and ``svd``
of a dense fp64 matrix at n = 4096 (U, sigma, V^T, timed part by part),
``svd_batched(..., compute_uv=True)`` on 16 fp32 matrices, and the fused
small-n tier (``backend="fused_small"``, one launch per batch) on 64 fp64
matrices of n = 64 and 64 fp32 matrices of n = 256, each timed against the
staged pipeline on the same batch.  Stage 3 by divide and conquer
(``stage3="dc"``, the kernels of ``dc.cu``) runs on the banded fp64 n =
4096 and fp32 n = 16384 matrices beside their bisection, and in the full
SVD of a dense fp64 n = 1024; then the autotuner searches (tw, fuse) at
fp64 n = 4096 and the stage-3 crossover on the bidiagonals the pipeline
makes of banded inputs (fp64 and fp32, one matrix and four), and reads
them back from a temporary cache; the fused-vs-staged crossover at (bw 8,
fp64) and (bw 32, fp32) and the batch axis at n = 1024 around
``default_bucket_batch``.  The ``svd_serve`` phase serves a mix of small
matrices (the fused tier) and large ones (the staged kernels) through
``AsyncSVDEngine`` on the card: a burst, an open-loop stream, the same
stream under injected faults, and one traced dispatch.  The ``svd_fabric``
phase serves across devices and processes on the one card: every bucket of
the mix split over a mesh of two shards of ``cuda:0``
(``sharded_pipeline_dispatch``, a lost shard, ``AsyncSVDEngine(mesh=)``),
the band of an fp64 n = 4096 matrix split by column over that mesh
(``bidiagonalize_sharded``, the one-cycle band kernel of
``chase_cycle_cuda`` on each shard), and an ``SVDRouter`` with its default
heartbeat over two worker processes on the card (a burst, a Poisson
stream, the same stream with one worker SIGKILLed), every answer held bit
for bit to the in-process engine's.  Results are checked against
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
# TFLOP/s; fp32 on FMAs (the apply's fp32 path), 67 TFLOP/s; bf16 with fp32
# sums on the tensor cores, 989 TFLOP/s
PEAK_MATMUL_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12,
                     "float16": 989e12}
# fp32 products at fp32 accuracy on the tensor cores (flash_attn.cu): each
# is three TF32 products (3xTF32) at 495 TFLOP/s, so 165 TFLOP/s of fp32
# products; flash_bound reports the fp32 FMA bound (67 TFLOP/s) beside it
PEAK_3XTF32_FLOPS = 495e12 / 3
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
        "ldv, v + kv_base, S, D,\n                       (kt + 1) * BK,",
        "ldv, v + kv_base, S, D, (kt + 1 >= n_kv - 2 && kt >= 1 ? kt - 1 : "
        "kt + 1) * BK,", 1)]),
    # flash_attn.cu with Q, K and V at TF32 precision: their lo terms
    # dropped (P keeps its own)
    "fp32_at_tf32_precision": ("flash_attn", "float32", [(
        "    lo = tf32(x - __uint_as_float(hi));\n  } else {",
        "    lo = 0u;\n  } else {", 1)]),
    # flash_attn.cu at 1xTF32: every lo term dropped, P's too, so each
    # product is one TF32 product
    "fp32_lo_terms_dropped": ("flash_attn", "float32", [(
        "constexpr bool kLoTerms = true;",
        "constexpr bool kLoTerms = false;", 1)])}
# Faults planted in copies of chase.cu (--chase-planted-faults), read by
# the band entries at every main-path stage of the fuse depth they act at,
# with ragged live masks: fault -> (fuse depth, [(text, replacement, times
# it occurs)])
CHASE_FAULTS = {
    # the in-place column offset shifted by one: each slot chases its block
    # one band column to the right of where it lies
    "band_column_offset_by_one": (4, [(
        "const int p = a.p != nullptr ? a.p[g] : 0;",
        "const int p = a.p != nullptr ? a.p[g] + 1 : 0;", 1)]),
    # live ignored: every slot chases all K cycles
    "live_ignored": (4, [
        ("  int last = tape ? K - 1 : -1;", "  int last = K - 1;", 1),
        ("    const bool act = live[i] != 0;", "    const bool act = true;",
         1)]),
    # the one-cycle kernel's column offset shifted by one
    "cycle_band_column_offset_by_one": (1, [(
        "  const int p = a.p[g];", "  const int p = a.p[g] + 1;", 1)]),
    # the one-cycle kernel with live ignored: every slot chases its window
    "cycle_band_live_ignored": (1, [(
        "  const bool act = a.live[g] != 0;", "  const bool act = true;", 1)])}
# Faults planted in copies of sturm.cu, read at the bisection's checks: a
# wrong path pick at one level of the walk down the counted top of the tree
STURM_FAULTS = {
    "wrong_pick_at_one_top_level": [(
        "    if (cb[j] - n >= k) { hi = mid; j = 2 * j; }",
        "    if ((cb[j] - n >= k) != (l == d / 2)) { hi = mid; j = 2 * j; }",
        1)]}
# Faults planted in copies of fused_small.cu (--fused-planted-faults), read
# at every fused check case: fault -> [(text, replacement, times it occurs)]
FUSED_FAULTS = {
    # a right reflector's lines one row short: row hi keeps its entries
    "extent_one_row_short": [(
        "          right ? hi : min(hi + bw, n - 1)};",
        "          right ? hi - 1 : min(hi + bw, n - 1)};", 1)],
    # the reflectors' band index one column off (the band is filled and
    # read out by its own map, which stays right)
    "band_index_off_by_one": [(
        "    return (j - i + dlo) * ld + j;",
        "    return (j - i + dlo) * ld + j - (j > 0);", 1)],
    # a wrong pick at one level of the walk down the in-launch tree top
    "wrong_pick_at_one_top_level":
        STURM_FAULTS["wrong_pick_at_one_top_level"]}
# Probes of where the fused kernel's time goes (--fused-bounds): copies of
# fused_small.cu that stop before phase 3, that stop after phase 1, that
# stop where phase 1's trailing block would move into shared memory, whose
# reflectors stop after they are built (no lines updated), and whose
# reflectors are a block barrier only
_PHASE_3 = "  // phase 3: sigma by Sturm bisection (csrc/sturm_device.cuh)\n"
_NO_PHASE_3 = (_PHASE_3, "  if (n > 0) return;\n" + _PHASE_3, 1)
FUSED_PROBES = {
    "without_phase_3": [_NO_PHASE_3],
    "phase_1_only": [(
        "  // the band into shared memory: rows still in the trailing block",
        "  if (n > 0) return;\n"
        "  // the band into shared memory: rows still in the trailing block",
        1)],
    "phase_1_device_memory_only": [(
        "      if (j == a.j0 && j > 0) {              // the trailing block",
        "      if (n > 0) return;\n"
        "      if (j == a.j0 && j > 0) {              // the trailing block",
        1)],
    "reflectors_built_only": [_NO_PHASE_3, (
        "  if (tid < 32) bar_sync_1(busy); else bar_arrive_1(busy);\n",
        "  if (tid < 32) bar_sync_1(busy); else bar_arrive_1(busy);\n"
        "  if (n > 0) return;\n", 1)],
    "reflectors_barrier_only": [_NO_PHASE_3, (
        "  if constexpr (Mat::kGlobal) {\n", "  if (G < 0) {\n", 1), (
        "  } else {\n    reflect_fast<A, Right, Mat, UV>(m, uv, r, G, n);",
        "  } else if (G < 0) {\n"
        "    reflect_fast<A, Right, Mat, UV>(m, uv, r, G, n);", 1)]}
# the fused small-n tier's main-path runs: (B, n, bw, dtype)
FUSED_MAIN = [(64, 64, 8, "float64"), (64, 256, 32, "float32")]
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
# Probes of what bounds the super-step (--chase-bounds): copies of chase.cu
# without the two rank-1 updates of each cycle (phases 1-2), without the
# moves between the panels and the band between cycles, and without both
# (what is left: the launch, the first load and the last store)
_NO_CYCLES = ("    if (act || tape) {", "    if (act && a.b_in < 0) {", 1)
_NO_MOVES = [
    ("    if (act)\n      panels_out<T, A>(pn, gm, band, a.ld, col0, "
     "!(next && live[i + 1]));",
     "    if (act && a.b_in < 0)\n      panels_out<T, A>(pn, gm, band, a.ld, "
     "col0, !(next && live[i + 1]));", 1),
    ("      panels_in<T, A>(pn, gm, band, a.ld, col0 + a.b_in, true);",
     "      if (a.b_in < 0) panels_in<T, A>(pn, gm, band, a.ld, col0 + "
     "a.b_in, true);", 1)]
CHASE_PROBES = {"without_cycles": [_NO_CYCLES], "without_moves": _NO_MOVES,
                "without_both": [_NO_CYCLES] + _NO_MOVES}
# and of the one-cycle kernel: a copy without its cycle (what is left: the
# launch and the two TMA copies)
CYCLE_PROBES = {"cycle_band_without_cycle": [(
    "  cycle<T, GS, true>(lay, gm, x2, act, a.first[s] != 0,",
    "  if (a.b_in < 0) cycle<T, GS, true>(lay, gm, x2, act, a.first[s] != 0,",
    1)]}
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
    ap.add_argument("--chase-planted-faults", action="store_true",
                    help="only read how far faults planted in copies of "
                    "chase.cu (the band entries' column offset shifted by "
                    "one, live ignored) move the band and tape at the "
                    "main-path stages, and a fault planted in a copy of "
                    "sturm.cu moves sigma, then exit")
    ap.add_argument("--chase-bounds", action="store_true",
                    help="only time the super-step kernel at its timing "
                    "shape in the repository's build and in copies without "
                    "its cycles' updates or its moves, and the one-cycle "
                    "kernel in place with and without its cycle, then exit")
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
    ap.add_argument("--fused-planted-faults", action="store_true",
                    help="only read how far faults planted in copies of "
                    "fused_small.cu (an extent one row short, a band index "
                    "off by one, a wrong pick at one level of the tree "
                    "top) move the fused kernel's output at its checks, "
                    "against CHECK_TOLS, then exit")
    ap.add_argument("--fused-threads", action="store_true",
                    help="only time the fused kernel's values mode at the "
                    "main shapes with 512 threads a block (the "
                    "repository's build) and 256 (a copy), then exit")
    ap.add_argument("--svd-serve", action="store_true",
                    help="only build the kernels and run the svd_serve "
                    "phase (AsyncSVDEngine on the card), then exit")
    ap.add_argument("--svd-fabric", action="store_true",
                    help="only build the kernels and run the svd_fabric "
                    "phase (sharded dispatch and the column-sharded chase "
                    "on a mesh of two shards of the card, the router and "
                    "two worker processes on it), then exit")
    ap.add_argument("--fused-bounds", action="store_true",
                    help="only time the fused kernel's values mode at the "
                    "main shapes in the repository's build and in copies "
                    "without parts of it (FUSED_PROBES), then exit")
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
        if args.chase_planted_faults:
            return chase_planted_faults(args, torch)
        if args.chase_bounds:
            return chase_bounds(args, torch)
        if args.wy_planted_faults:
            return wy_planted_faults(args, torch)
        if args.wy_bounds:
            return wy_bounds(args, torch)
        if args.fused_planted_faults:
            return fused_planted_faults(args, torch)
        if args.fused_threads:
            return fused_threads(args, torch)
        if args.fused_bounds:
            return fused_bounds(args, torch)
        if args.svd_parts:
            return svd_parts(args, torch, tree)
        if args.svd_serve:
            from repro_torch.kernels import _build
            _build.build_all()
            svd_serve_phase(torch)
            return 0
        if args.svd_fabric:
            from repro_torch.kernels import _build
            _build.build_all()
            svd_fabric_phase(torch)
            return 0
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


def fuse4_runs(torch):
    """(lead, n, cfg) of the main path's fuse-4 SVD runs: banded fp64 n =
    4096 bw 64 and fp32 n = 16384 bw 64, dense fp64 n = 4096 bw 64, and 16
    fp32 matrices of n = 512 bw 32."""
    from repro_torch.core.tuning import PipelineConfig
    f64, f32 = torch.float64, torch.float32
    return [((), 4096, PipelineConfig.resolve(bw=64, dtype=f64, n=4096,
                                              fuse=4)),
            ((), 16384, PipelineConfig.resolve(bw=64, dtype=f32, n=16384,
                                               fuse=4)),
            ((), 4096, PipelineConfig.resolve(bw=64, dtype=f64, n=4096,
                                              fuse=4)),
            ((16,), 512, PipelineConfig.resolve(bw=32, dtype=f32, n=512,
                                                fuse=4))]


def main_path_shapes(bc, runs):
    """Kernel shapes the main-path runs launch, from each run's stage plan
    and wavefront width: every stage (b_in, tw) with B*G slots for a batch
    of B, at the run's fuse depth and dtype; the bisection's (B, n); and
    each stage as the band entries take it, (n, b_in, tw, B, K, dtype), at
    fuse K and at fuse 1."""
    cycle, superstep, sturm, band, cycle_band = [], [], [], [], []
    for lead, n, cfg in runs:
        b = math.prod(lead)
        for b_in, tw in cfg.plan:
            g = b * bc.stage_schedule(n, b_in, tw, cfg.fuse)[2]
            stage = (n, b_in, tw, b, cfg.fuse, cfg.dtype)
            if cfg.fuse == 1:
                cycle.append((b_in, tw, g, cfg.dtype))
                cycle_band.append(stage)
            else:
                superstep.append((b_in, tw, g, cfg.fuse, cfg.dtype))
                band.append(stage)
        sturm.append((b, n, cfg.dtype))
    return (sorted(set(cycle)), sorted(set(superstep)), sorted(set(sturm)),
            sorted(set(band)), sorted(set(cycle_band)))


def band_stage(torch, bc, rng, n, b_in, tw, fuse, b, dtype, ragged=True):
    """One stage on the card as the band entries take it: the padded band
    (B, H, n_pad) as ``reduce_stage_packed`` pads it, random in its first n
    columns and zero past them (dump zones included), the stage's tables
    (p_safe as int32), a (super-)cycle t = T // 2 and tape buffers (B, T,
    G, K, 2, tw+1), (B, T, G, K, 2) filled with 7.  With ``ragged`` row t
    of ``live`` is cut to a random prefix for every started slot."""
    from repro_torch.core import tuning
    _, T, G = bc.stage_schedule(n, b_in, tw, fuse)
    h = b_in + 2 * tw + 1
    bandp = torch.zeros((b, h, tuning.band_padding(n, b_in, tw, fuse, G)),
                        dtype=torch.float64)
    bandp[..., :n] = torch.from_numpy(rng.standard_normal((b, h, n)))
    p_safe, first, live = bc._cycle_table(n, b_in, tw, fuse, T, G, b,
                                          "cuda")
    t = T // 2
    if ragged:
        n_live = torch.from_numpy(rng.integers(0, fuse + 1, size=G)).cuda()
        live[t] = ((torch.arange(fuse, device="cuda")[None, :]
                    < n_live[:, None]) & (p_safe[t] < n)[:, None])
    bandp = bandp.to("cuda", dtype)
    tape = (torch.full((b, T, G, fuse, 2, tw + 1), 7.0, dtype=dtype,
                       device="cuda"),
            torch.full((b, T, G, fuse, 2), 7.0, dtype=dtype, device="cuda"))
    return bandp, p_safe.to(torch.int32), first, live, t, tape


def fuse1_runs(torch):
    """(lead, n, cfg) of the main path's fuse-1 SVD runs: banded fp64 and
    fp32 n = 4096 bw 64, fp32 n = 16384 bw 64, 32 fp64 matrices of n =
    1024 bw 32, the warm-up (fp64 n = 256 bw 64) and the stage-2 profile's
    stage (fp32 n = 2048 bw 64)."""
    from repro_torch.core.tuning import PipelineConfig
    f64, f32 = torch.float64, torch.float32
    return [((), 4096, PipelineConfig.resolve(bw=64, dtype=f64, n=4096,
                                              fuse=1)),
            ((), 4096, PipelineConfig.resolve(bw=64, dtype=f32, n=4096)),
            ((), 16384, PipelineConfig.resolve(bw=64, dtype=f32, n=16384,
                                               fuse=1)),
            ((32,), 1024, PipelineConfig.resolve(bw=32, dtype=f64, n=1024)),
            ((), 256, PipelineConfig.resolve(bw=64, dtype=f64, fuse=1)),
            ((), 2048, PipelineConfig.resolve(bw=64, dtype=f32, n=2048,
                                              fuse=1))]


def gk_inputs(torch, rng, s3, n, b, dtype):
    """Prescaled Golub-Kahan inputs (z, bound) on the card of b random
    bidiagonals of size n."""
    d = torch.from_numpy(rng.standard_normal((b, n))).to("cuda", dtype)
    e = torch.from_numpy(rng.standard_normal((b, n))).to("cuda", dtype)
    return s3.gk_problem(d, e)[:2]


def sturm_cases(torch, bisect, s3, main_sturm):
    """(B, n, dtype, max_iter, d, s, main) of the bisection's checks: every
    main-path (B, n, dtype) at STURM_CHECK_STEPS steps as the wrapper
    schedules them (the tree's top only), and with a top of one level and
    the main path's s so that the walk runs one full round of s levels and
    one of a level; n = 512 at the full step count in both dtypes."""
    cases = []
    for b, n, dname in main_sturm:
        full = s3.default_bisect_iters(getattr(torch, dname))
        s = bisect.schedule(b, n, full)[1]
        cases.append((b, n, dname, STURM_CHECK_STEPS,
                      *bisect.schedule(b, n, STURM_CHECK_STEPS), True))
        if n > 1:
            cases.append((b, n, dname, 2 + max(s, 1), 1, s, True))
    for dname in STURM_TOLS:
        full = s3.default_bisect_iters(getattr(torch, dname))
        cases.append((1, 512, dname, full, *bisect.schedule(1, 512, full),
                      False))
    return cases


def sturm_run(torch, fn, z, bound, n, max_iter, d, s):
    """sigma (B, n) from ``fn`` (``sturm_bisect_<dtype>`` of the package's
    build or of a copy, ``bisect._fn``) with the schedule (d, s)."""
    b = z.shape[0]
    counts = torch.empty((b, 1 << d), dtype=torch.int32, device=z.device)
    out = z.new_empty((b, n))
    err = fn(z.data_ptr(), bound.data_ptr(), counts.data_ptr(),
             out.data_ptr(), b, n, max_iter, d, s,
             float(torch.finfo(z.dtype).tiny) * 4,
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"sturm_bisect (d={d}, s={s}): CUDA error {err}")
    torch.cuda.synchronize()
    return out


# the divide-and-conquer kernels' ops, their kernels and their plain
# versions, and the tolerance of the secular roots against the plain
# version's, times the pole scale of the row (max|d| + sum w)
DC_OPS = {"dc_leaf": ("dc_leaf_cuda", "leaf_eigen_plain"),
          "dc_deflate": ("dc_deflate_cuda", "deflate_plain"),
          "dc_secular": ("dc_secular_cuda", "secular_plain")}
DC_ROOT_TOLS = {"float64": 1e-13, "float32": 1e-5}
# the first and last eigenvector rows of a leaf with no two eigenvalues in
# one Gram-Schmidt cluster (1e-3 of its scale apart) are well conditioned
# and held to these; a leaf with a cluster may hold any basis of it, so
# there each resolved cluster (dc_cluster_sums) is held by what no rotation
# inside it changes, and the rows' own difference is reported only
DC_ROW_TOLS = {"float64": 1e-12, "float32": 1e-4}


def dc_cluster_sums(torch, lam, f, l, ctol):
    """Per cluster of each leaf (a run of eigenvalues whose neighbours are
    within ``ctol``, the Gram-Schmidt's reach), at the cluster's index:
    the sums of f^2, f*l and l^2 over its members (3, P, lm), zeros past
    the last cluster, which do not change when the basis of the cluster
    rotates; its members' count (P, lm); and (P, lm) whether the cluster
    is resolved, no two of its
    eigenvalues closer than 64 eps times the leaf's scale (``ctol``'s
    floor; the scale is ctol / 1e-3).  Inside an unresolved cluster (a
    degenerate eigenvalue: the tail of a random banded matrix's bidiagonal
    is ~1e-26 at fp32 n = 16384) inverse iteration cannot tell the vectors
    apart and one Gram-Schmidt pass leaves rounding that no fixed
    tolerance bounds, in the plain version as in the kernel."""
    eps = torch.finfo(lam.dtype).eps
    gap = lam[:, 1:] - lam[:, :-1]
    start = torch.ones_like(lam, dtype=torch.bool)
    start[:, 1:] = gap >= ctol[:, None]
    cid = torch.cumsum(start.to(torch.int64), -1) - 1
    tight = (gap < 64 * eps * 1e3 * ctol[:, None]).to(torch.int64)
    unresolved = torch.zeros_like(cid).scatter_add_(-1, cid[:, 1:], tight)
    sums = torch.zeros((3,) + tuple(lam.shape), dtype=lam.dtype,
                       device=lam.device).scatter_add_(
        -1, cid.expand(3, -1, -1), torch.stack((f * f, f * l, l * l)))
    size = torch.zeros_like(cid).scatter_add_(-1, cid, torch.ones_like(cid))
    return sums, size, unresolved == 0


def dc_recorded(torch, ops, s3dc, d, e):
    """sigma of the bidiagonals (d, e) by ``bidiag_dc_singular_values``
    through the kernels, and every kernel op call it made: (op, the
    arguments, cloned before the call, keywords)."""
    calls = []
    kept = {op: getattr(ops, op) for op in DC_OPS}

    def recorder(op):
        def call(*a, **kw):
            calls.append((op, tuple(x.clone() if isinstance(x, torch.Tensor)
                                    else x for x in a), kw))
            return kept[op](*a, **kw)
        return call

    for op in DC_OPS:
        setattr(ops, op, recorder(op))
    try:
        sig = s3dc.bidiag_dc_singular_values(d, e, backend="cuda")
    finally:
        for op, fn in kept.items():
            setattr(ops, op, fn)
    torch.cuda.synchronize()
    return sig, calls


def dc_run(torch, dc, s3dc, op, args, kw, plain=False):
    """The kernel of one recorded call (or its plain version), on clones of
    its arguments (the deflation works in place)."""
    kw = {k: v for k, v in kw.items() if k != "backend"}
    args = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                 for x in args)
    kernel, twin = DC_OPS[op]
    fn = getattr(s3dc, twin) if plain else getattr(dc, kernel)
    return fn(*args, **kw)


def dc_call_shape(op, args, kw) -> tuple:
    """(op, P, m, nact or None, dtype) of a recorded call."""
    p, m = args[0].shape
    return (op, p, m, kw.get("nact"), str(args[0].dtype).removeprefix(
        "torch."))


def dc_leaf_bound(p, lm, iters, inv_iters, dname, itemsize):
    """Leaves: a, b, brackets and start vectors read once, lam, f, l written
    once; per leaf and index: ``iters`` counts of lm steps (subtract,
    multiply, divide, subtract: 4), ``inv_iters`` solves (8 per row) and
    norms (3 per row), and the Gram-Schmidt's two projections (4 per
    earlier vector and row); a division counted as one."""
    nbytes = (p * (2 * lm - 1 + 3) + lm * lm + 3 * p * lm) * itemsize
    flops = p * (lm * (iters * lm * 4 + inv_iters * lm * 11)
                 + 2 * lm * lm * (lm - 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def dc_deflate_bound(p, m, dname, itemsize):
    """The scan: d, z, fe, le and the active flags read and written once,
    tol read; about 24 operations a column step (the rotation, its test,
    the emitted and the carried column), a square root counted as one."""
    nbytes = 2 * p * m * (4 * itemsize + 1) + p * itemsize
    flops = 24 * p * max(m - 1, 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def dc_secular_bound(p, m, nact, roots, kh, newton_iters, dname, itemsize):
    """The roots: d, w, gap, the next poles and the flags read once, the
    heavy poles' indices read once, anc and tau written once.  Operations:
    what every active root needs at the least, its midpoint pass and one
    polish pass over the prefix (subtract, subtract, two divisions and two
    sums: 6 per pole), and the windowed iterations over its 128 + kh poles
    (6 per pole); the polish passes past the first depend on the data and
    are not counted, so this is a bound from below."""
    nbytes = (p * m * (4 * itemsize + 2) + p * kh * 8
              + 2 * p * nact * itemsize)
    flops = roots * (2 * 6 * nact + newton_iters * 6 * (128 + kh))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


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


def fused_bound(b, n, bw, max_iter, dtype, itemsize, compute_uv=False):
    """Values mode: the matrices read once and sigma written once; per
    reflector of the walk (support L) 3L flops to build it and 5L per
    nonzero row or column it meets (dot products 2, update 3); 3 flops per
    step of the bisection's pivot recurrences.  uv mode: d, e, U2 and V2^T
    written instead of sigma, 5L flops per row of U2 or V2 a reflector
    updates (all n), no bisection.

    The nonzeros a reflector meets (``ref.fused_lines``): a right one on
    row k over columns [lo, hi] meets rows [k, hi] (above k the band ends
    before lo); a left one on column lo over rows [lo, hi] meets columns
    [lo, min(hi + bw, n - 1)] (the band, and the bulge, end there).  This
    holds for both phases, and the kernel applies each reflector to those
    lines only."""
    from repro_torch.kernels.ref import effective_bw, fused_lines, fused_walk
    bw = effective_bw(n, bw)
    flops = 0 if compute_uv else 3 * b * n * max_iter * (2 * n - 1)
    for right, k, lo, hi in fused_walk(n, bw):
        first, last = fused_lines(right, k, lo, hi, n, bw)
        meets = last - first + 1 + (n if compute_uv else 0)
        flops += b * (3 + 5 * meets) * (hi - lo + 1)
    nbytes = (b * n * n + b * n * (2 + 2 * n if compute_uv else 1)) \
        * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def flash_bound(bh, bh_kv, s, d, dtype, itemsize, fma=False):
    """q (bh rows) and the grouped k, v (bh_kv rows) read once and o
    written once; 4*D flops per (query, key) pair on or below the diagonal
    (two products), at the card's peak for the kernels' route: bf16/fp16
    on the tensor cores, 989 TFLOP/s; fp32 as 3xTF32 products on the tensor
    cores (PEAK_3XTF32_FLOPS), or with ``fma`` at the fp32 FMA rate, 67
    TFLOP/s."""
    nbytes = 2 * (bh + bh_kv) * s * d * itemsize
    flops = 4 * bh * d * s * (s + 1) // 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (PEAK_3XTF32_FLOPS if dtype == "float32" and not fma
                     else PEAK_MATMUL_FLOPS[dtype])
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


def banded_matrix(torch, lead, n, bw, dtype, gen, device="cuda"):
    """Random upper-banded (lead..., n, n) matrix on the card."""
    a = torch.zeros(tuple(lead) + (n, n), dtype=torch.float64, device=device)
    for k in range(bw + 1):
        vals = torch.randn(tuple(lead) + (n - k,), generator=gen,
                           dtype=torch.float64, device=device)
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

    from repro_torch.kernels import flash_attention, ref

    rng = np.random.default_rng(args.seed)
    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {f: (src, edits) for f, (src, _, edits)
                                   in FLASH_FAULTS.items()})

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


def build_copies(tmp: str, faults: dict) -> dict:
    """Build one copy of a kernel source per fault (fault -> (source name,
    [(text, replacement, times it occurs)])), each with its edits, all
    ``nvcc`` at once in the directory ``tmp``; returns fault -> loaded
    library.  The headers of ``csrc/`` a source includes are copied into
    it first, so an edit may act on them."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    procs = {}
    for fault, (source, edits) in faults.items():
        text = re.sub(r'#include "(\w+\.cuh)"',
                      lambda m: (_build.CSRC / m.group(1)).read_text(),
                      (_build.CSRC / _build.SOURCES[source]).read_text())
        for old, new, times in edits:
            check(text.count(old) == times, f"{fault}: {old!r} occurs "
                  f"{text.count(old)} times, expected {times}")
            text = text.replace(old, new)
        cu, so = (Path(tmp) / f"{fault}{ext}" for ext in (".cu", ".so"))
        cu.write_text(text)
        procs[fault] = (subprocess.Popen(
            _build.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for fault, (proc, so) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{fault}: nvcc failed:\n{log}")
        libs[fault] = ctypes.CDLL(str(so))
    return libs


def chase_planted_faults(args, torch) -> int:
    """How far the faults of CHASE_FAULTS and STURM_FAULTS, each built into
    its own copy of chase.cu or sturm.cu, move their kernel's output from
    the plain version, beside the sound kernel: the chase faults through
    the band entries (band and tape) at (super-)cycle T // 2 of every
    main-path stage of their fuse depth, in its run's dtype, with ragged
    live masks (the kernels_vs_plain comparison); the Sturm fault at the
    bisection's checks (sturm_cases).  Readings are max |err| over the
    kernel's tolerance times the scale.  One JSON line per fault; fails
    unless the sound kernels read at most 1 and every fault above 1 at
    some shape."""
    import tempfile

    import numpy as np

    from repro_torch.core import bidiag_svd as s3
    from repro_torch.core import bulge_chasing as bc
    from repro_torch.kernels import bisect, bulge_chase, ref

    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {
        **{f: ("chase", e) for f, (_, e) in CHASE_FAULTS.items()},
        **{f: ("sturm", e) for f, e in STURM_FAULTS.items()}})
    rng = np.random.default_rng(args.seed)
    runs = fuse1_runs(torch) + fuse4_runs(torch)
    shapes = main_path_shapes(bc, runs)
    stages = {1: shapes[4], 4: shapes[3]}
    readings = {f: [] for f in ["sound fuse 1", "sound fuse 4",
                                *CHASE_FAULTS]}
    for fuse, cases in stages.items():
        for n, b_in, tw, b, k, dname in cases:
            dtype = getattr(torch, dname)
            stage = band_stage(torch, bc, rng, n, b_in, tw, k, b, dtype)
            bandp, p32, first, live, t, tape = stage
            kw = dict(b_in=b_in, tw=tw, fuse=k)
            want, want_tape = bandp.clone(), tuple(x.clone() for x in tape)
            ref.BandStageRef(want, p32, first, live, tape=want_tape,
                             **kw)(t)
            for fault in readings:
                if fault.startswith("sound"):
                    if fault != f"sound fuse {fuse}":
                        continue
                    lib = None
                elif CHASE_FAULTS[fault][0] != fuse:
                    continue
                else:
                    lib = libs[fault]
                got, got_tape = bandp.clone(), tuple(x.clone() for x in tape)
                with bulge_chase.BandStage(got, p32, first, live,
                                           tape=got_tape, lib=lib,
                                           **kw) as run_t:
                    run_t(t)
                torch.cuda.synchronize()
                ratio = max(
                    max_err(torch, g_, w_)[0]
                    / (TOLS[dname] * max_err(torch, g_, w_)[1])
                    for g_, w_ in ((got, want),
                                   (got_tape[0][:, t], want_tape[0][:, t]),
                                   (got_tape[1][:, t], want_tape[1][:, t])))
                readings[fault].append((ratio, (n, b_in, tw, b, k, dname)))
            del stage, bandp, tape, want_tape, want
    readings.update({"sound sturm": [], **{f: [] for f in STURM_FAULTS}})
    for case in sturm_cases(torch, bisect, s3, shapes[2]):
        b, n, dname, iters, d, s, _ = case
        z, bound = gk_inputs(torch, rng, s3, n, b, getattr(torch, dname))
        want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
        for fault in ["sound sturm", *STURM_FAULTS]:
            got = sturm_run(torch, bisect._fn(z.dtype, libs.get(fault)), z,
                            bound, n, iters, d, s)
            err, scale = max_err(torch, got, want)
            readings[fault].append((err / (STURM_TOLS[dname] * scale),
                                    case[:6]))
    for fault, r in readings.items():
        emit({"fault": fault, "cases": len(r),
              "err_over_tol_min": min(r), "err_over_tol_max": max(r),
              "caught": max(r)[0] > 1.0})
    check(all(max(r)[0] <= 1.0 for f, r in readings.items()
              if f.startswith("sound")),
          "a sound kernel reads above its tolerance")
    check(all(max(r)[0] > 1.0 for f, r in readings.items()
              if not f.startswith("sound")),
          "a planted fault passed the compare")
    tmp.cleanup()
    return 0


def fused_check_cases(fused_small) -> list:
    """(B, n, bw, dtype) of the fused kernel's checks: the reference's
    shapes and the main path's, each in fp64 and fp32."""
    return sorted({sh + (d,) for sh in fused_small.CHECK_SHAPES
                   for d in fused_small.CHECK_TOLS} | {
        sh[:3] + (d,) for sh in FUSED_MAIN for d in fused_small.CHECK_TOLS})


def fused_route_label(tuning, n, bw, dtype, compute_uv) -> str:
    """The fused launch's route (``tuning.fused_route``) in a few words."""
    r = tuning.fused_route(n, bw, dtype, compute_uv=compute_uv)
    label = r.name + (f", phase 1 in shared memory from column {r.j0}"
                      if r.name == "smem" and r.j0 < n - 1 else "")
    if compute_uv:
        label += (", U2 and V2 in shared memory" if r.uv_smem
                  else ", U2 and V2 in device memory")
    return label


def fused_planted_faults(args, torch) -> int:
    """How far the faults of FUSED_FAULTS, each built into its own copy of
    fused_small.cu, move the fused kernel's output from the plain version,
    beside the sound kernel, at every fused check (fused_check_cases):
    the largest of sigma (values mode), the sigma of uv mode's (d, e) and
    the uv invariants, each over its CHECK_TOLS, and at fp64 the uv entries
    over ENTRY_TOL_FP64 (NaN read as inf).  One JSON line per fault; fails
    unless the sound kernel reads at most 1 and every fault above 1 at some
    check."""
    import tempfile

    import numpy as np

    from repro_torch.core import bidiag_svd as s3
    from repro_torch.core import tuning
    from repro_torch.kernels import fused_small, ref

    def over(err, tol):
        return math.inf if math.isnan(err) else err / tol

    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {f: ("fused_small", e)
                                   for f, e in FUSED_FAULTS.items()})
    rng = np.random.default_rng(args.seed)
    readings = {f: [] for f in ["sound", *FUSED_FAULTS]}
    for b, n, bw, dname in fused_check_cases(fused_small):
        dtype = getattr(torch, dname)
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to("cuda",
                                                                dtype)
        tol, tol_uv = fused_small.CHECK_TOLS[dname]
        want = ref.fused_small_svd_ref(a, bw=bw)
        want_uv = ref.fused_small_svd_ref(a, bw=bw, compute_uv=True)
        sig_uv = s3.bidiag_singular_values(want_uv[0], want_uv[1])
        where = (b, n, bw, dname, fused_route_label(tuning, n, bw, dtype,
                                                     True))
        for fault in readings:
            lib = libs.get(fault)
            got = fused_small.fused_small_svd_cuda(a, bw=bw, lib=lib)
            got_uv = fused_small.fused_small_svd_cuda(a, bw=bw, lib=lib,
                                                      compute_uv=True)
            torch.cuda.synchronize()
            err, scale = max_err(torch, got, want)
            r = [over(err, tol * scale)]
            err, scale = max_err(torch, s3.bidiag_singular_values(
                got_uv[0], got_uv[1]), sig_uv)
            r.append(over(err, tol * scale))
            r.append(over(max(fused_small.uv_invariants(a, *got_uv)), tol_uv))
            if dname == "float64":
                r.append(over(fused_small.entry_error(got_uv, want_uv),
                              fused_small.ENTRY_TOL_FP64))
            readings[fault].append((max(r), where))
        del a, want, want_uv
    for fault, r in readings.items():
        emit({"fault": fault, "cases": len(r),
              "cases_above_tol": sum(x[0] > 1.0 for x in r),
              "err_over_tol_min": min(r), "err_over_tol_max": max(r),
              "caught": max(r)[0] > 1.0})
    check(max(readings["sound"])[0] <= 1.0,
          "the sound fused kernel reads above its tolerance")
    check(all(max(r)[0] > 1.0 for f, r in readings.items() if f != "sound"),
          "a planted fault passed the compare")
    tmp.cleanup()
    return 0


def fused_launch(torch, fused_small, tuning, lib, a, bw, sig, threads=512):
    """One values-mode launch of the fused kernel of ``lib`` (None: the
    repository's build) on ``a`` with the route of its shape and the
    bisection's s chosen for a block of ``threads`` as bisect_schedule
    chooses it; sigma into ``sig``."""
    from repro_torch.core.bidiag_svd import default_bisect_iters
    b, n, _ = a.shape
    iters = default_bisect_iters(a.dtype)
    r = tuning.fused_route(n, bw, a.dtype)
    s = max(x for x in range(6) if n << x <= threads or x == 0)
    ws = torch.empty((b, n, n), dtype=a.dtype, device="cuda")
    code = fused_small._fn(a.dtype, lib)(
        a.data_ptr(), ws.data_ptr(), None, None, sig.data_ptr(), None, None,
        None, None, b, n, bw, iters, float(torch.finfo(a.dtype).tiny) * 4,
        0, int(r.name == "smem"), r.j0, 0, r.scratch, r.region, r.ldt, r.ldb,
        r.ldu, r.dlo, r.h, fused_small.bisect_schedule(n, iters)[0],
        0 if s == 1 else s, r.smem_bytes,
        torch.cuda.current_stream().cuda_stream)
    check(code == 0, f"fused ({threads} threads): CUDA error {code}")


def fused_bounds(args, torch) -> int:
    """Where the fused kernel's time goes at FUSED_MAIN, values mode: its
    device ms (CUDA events over 10 back-to-back launches) in the
    repository's build and in copies without parts of it (FUSED_PROBES),
    on the same inputs, the build first and last.  One JSON line per
    shape."""
    import tempfile

    import numpy as np

    from repro_torch.core import tuning
    from repro_torch.kernels import fused_small, ref

    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {f: ("fused_small", e)
                                   for f, e in FUSED_PROBES.items()})
    rng = np.random.default_rng(args.seed)
    for b, n, bw, dname in FUSED_MAIN:
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to(
            "cuda", getattr(torch, dname))
        sig = a.new_empty((b, n))
        ms = {}
        for name in ["build", *FUSED_PROBES, "build again"]:
            lib = libs.get(name)
            ms[name] = gpu_ms(torch, lambda: fused_launch(
                torch, fused_small, tuning, lib, a, bw, sig), iters=10,
                warmup=1)
        emit({"phase": "fused_bounds", "B": b, "n": n, "bw": bw,
              "dtype": dname,
              "reflectors_per_matrix": len(list(ref.fused_walk(n, bw))),
              "route": fused_route_label(tuning, n, bw, a.dtype, False),
              "ms": ms})
        del a
    tmp.cleanup()
    return 0


def fused_threads(args, torch) -> int:
    """The fused kernel's values mode at FUSED_MAIN with 512 threads a
    block (the repository's build) and 256 (a copy of fused_small.cu with
    kThreads = 256), on the same layout and inputs, in turns (512, 256,
    256, 512): device ms per launch from CUDA events over back-to-back
    launches, the bisection's s chosen for each block size as
    bisect_schedule chooses it (n * 2^s lanes at most the block's)."""
    import tempfile

    import numpy as np

    from repro_torch.core import tuning
    from repro_torch.kernels import fused_small, ref

    tmp = tempfile.TemporaryDirectory()
    lib256 = build_copies(tmp.name, {"threads_256": ("fused_small", [(
        "constexpr int kThreads = 512;", "constexpr int kThreads = 256;",
        1)])})["threads_256"]
    rng = np.random.default_rng(args.seed)
    for b, n, bw, dname in FUSED_MAIN:
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to(
            "cuda", getattr(torch, dname))
        want = ref.fused_small_svd_ref(a, bw=bw)
        out, err = {}, {}
        for threads, lib in ((512, None), (256, lib256), (256, lib256),
                             (512, None)):
            sig = a.new_empty((b, n))
            out.setdefault(threads, []).append(gpu_ms(
                torch, lambda: fused_launch(torch, fused_small, tuning, lib,
                                            a, bw, sig, threads),
                iters=10, warmup=1))
            e, scale = max_err(torch, sig, want)
            err[threads] = e / scale
        emit({"phase": "fused_threads", "B": b, "n": n, "bw": bw,
              "dtype": dname, "ms_by_threads": out,
              "err_over_scale_by_threads": err,
              "tol": fused_small.CHECK_TOLS[dname][0]})
        check(all(x <= fused_small.CHECK_TOLS[dname][0]
                  for x in err.values()),
              "a block size read above the tolerance")
        del a
    tmp.cleanup()
    return 0


def chase_bounds(args, torch) -> int:
    """What bounds the super-step at its timing shape, blocks (32, 129, 289)
    fp32, b_in 64, tw 32, K 4, every cycle live: its device time
    (torch.profiler, mean of 50 launches) in the repository's build and in
    copies of chase.cu without parts of it (CHASE_PROBES), on the same
    blocks; and the one-cycle kernel's in place on cycle T // 2 of the n =
    16384 fp32 stage (b_in 64, tw 32, every slot live, no tape) in the
    repository's build and without its cycle (CYCLE_PROBES).  One JSON
    line; changes nothing."""
    import ctypes
    import tempfile

    import numpy as np

    from repro_torch.core import bulge_chasing as bc
    from repro_torch.core import tuning
    from repro_torch.kernels import bulge_chase

    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {f: ("chase", e) for f, e in
                                   {**CHASE_PROBES, **CYCLE_PROBES}.items()})
    b_in, tw, k, g = 64, 32, 4, 32
    h, wk = b_in + 2 * tw + 1, k * b_in + tw + 1
    rng = np.random.default_rng(args.seed)
    blocks = torch.from_numpy(rng.standard_normal((g, h, wk))).to(
        "cuda", torch.float32)
    first = torch.zeros(g, dtype=torch.bool, device="cuda")
    live = torch.ones((g, k), dtype=torch.bool, device="cuda")
    smem = tuning.check_smem_budget(b_in, tw, torch.float32, k)
    fns = {"repository": bulge_chase._fn("chase_superstep", torch.float32)}
    for name in CHASE_PROBES:
        fns[name] = libs[name].chase_superstep_f32
        fns[name].argtypes = bulge_chase._ARGTYPES["chase_superstep"]
    out = {}
    for name, fn in fns.items():
        def call(fn=fn):
            err = fn(blocks.data_ptr(), first.data_ptr(), live.data_ptr(), g,
                     b_in, tw, k, None, None, smem, ctypes.c_void_p(
                         torch.cuda.current_stream().cuda_stream))
            check(err == 0, f"{name}: CUDA error {err}")
        call()
        prof = profiler_ms(torch, call, "chase_superstep_kernel", 50)
        out[name] = prof[0] if prof is not None else None
    bandp, p32, firstb, liveb, t, _ = band_stage(
        torch, bc, rng, 16384, b_in, tw, 1, 1, torch.float32, ragged=False)
    cycle = {}
    for name in ["repository", *CYCLE_PROBES]:
        stage = bulge_chase.BandStage(bandp, p32, firstb, liveb, b_in=b_in,
                                      tw=tw, fuse=1, lib=libs.get(name))
        check(stage.route == "tma", "the stage did not take kernel 3")
        prof = profiler_ms(torch, lambda st=stage: st(t),
                           "chase_cycle_band_kernel", 50)
        cycle[name] = prof[0] if prof is not None else None
    tmp.cleanup()
    emit({"chase_bounds": f"blocks ({g}, {h}, {wk}) fp32, b_in={b_in}, "
                          f"tw={tw}, K={k}", "ms": out,
          "cycle_band": f"band (1, {h}, {bandp.shape[2]}) fp32, cycle {t} "
                        f"of the n = 16384 stage, {p32.shape[1]} slots, "
                        f"b_in={b_in}, tw={tw}, no tape",
          "cycle_band_ms": cycle,
          "card": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True, text=True,
              timeout=60).stdout.strip()})
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
    import tempfile

    from repro_torch.kernels import hh_apply

    tmp = tempfile.TemporaryDirectory()
    libs = build_copies(tmp.name, {name: ("hh_apply", edits)
                                   for name, edits in variants.items()})
    return tmp, {name: hh_apply.set_argtypes(lib.tape_apply_f64)
                 for name, lib in libs.items()}


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

DC_PATH = ["dc_leaf_cuda", "dc_deflate_cuda", "dc_secular_cuda"]


def dc_profile(torch, fn):
    """Where one stage-3 call's time goes: device ms by kernel (the three
    dc kernels and the rest, summed by name), busy ms and wall seconds,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [ev for ev in prof.key_averages()
               if "CUDA" in str(ev.device_type) and ev.device_time_total > 0]
    by = {}
    for ev in on_card:
        key = next((k for k in ("dc_leaf_kernel", "dc_deflate_kernel",
                                "dc_secular_kernel") if k in ev.key),
                   "other")
        by[key] = by.get(key, 0.0) + ev.device_time_total / 1e3
    busy = sum(by.values())
    top = sorted(on_card, key=lambda ev: ev.device_time_total,
                 reverse=True)[:6]
    return {"wall_s": wall, "device_busy_ms": busy or None,
            "device_idle_share": 1 - busy / 1e3 / wall if busy else None,
            "device_ms_by_kernel": by,
            "launches_of_other_kernels": sum(
                ev.count for ev in on_card
                if not any(k in ev.key for k in ("dc_leaf", "dc_deflate",
                                                 "dc_secular"))),
            "top_device_kernels": [{"kernel": ev.key[:60],
                                    "count": ev.count,
                                    "device_ms": ev.device_time_total / 1e3}
                                   for ev in top]}


def stage3_dc(torch, tsvd, s3, s3dc, drive, PipelineConfig, gen, mats):
    """Banded sigma with stage3="dc" on the matrices of phases 3 and 4
    (fp64 n = 4096 and fp32 n = 16384, bw 64, fuse 1), held to those
    phases' yardsticks and to their bisection's sigma (fp64: 1e-12 *
    sigma_max, the reference's gate; fp32: 1e-4 * sigma_max); stage 3
    alone on each bidiagonal, dc beside bisection (CUDA events, 3 calls
    after a warm-up) and dc profiled; then the full SVD of a dense fp64
    n = 1024 with stage3="dc"."""
    out = {"phase": "stage3_dc"}
    oks = []
    for a, cfg, sig_bi, yard, (d, e) in mats:
        n, dname = a.shape[-1], cfg.dtype
        cfg_dc = PipelineConfig.resolve(bw=cfg.bw, dtype=a.dtype, n=n,
                                        fuse=cfg.fuse, stage3="dc")
        sig, run_ = drive(f"{dname} n={n} fuse={cfg.fuse} stage3=dc "
                          f"banded_singular_values",
                          lambda: tsvd.banded_singular_values(
                              a, config=cfg_dc, check=True),
                          ["chase_cycle_cuda"] + DC_PATH)
        smax = float(sig_bi.max())
        vs_bisect = float((sig.double() - sig_bi.double()).abs().max())
        row = {"n": n, "dtype": dname, "bw": cfg.bw, "tw": cfg.tw,
               "leaf_n": cfg_dc.dc_leaf_n, "sigma_max": smax,
               "dc_vs_bisect_max_abs": vs_bisect, "runs": [run_]}
        if dname == "float64":
            row.update(tol_vs_bisect=1e-12 * smax,
                       err_vs_svdvals=float((sig - yard).abs().max()),
                       tol_vs_svdvals=1e-10 * smax)
            ok = (vs_bisect <= row["tol_vs_bisect"]
                  and row["err_vs_svdvals"] <= row["tol_vs_svdvals"])
        else:
            rel = abs(float((sig.double() ** 2).sum()) - yard) / yard
            row.update(tol_vs_bisect=1e-4 * smax, frobenius_rel_err=rel,
                       tol_frobenius=1e-4)
            ok = vs_bisect <= row["tol_vs_bisect"] and rel <= 1e-4
        times = {}
        for solver, fn in (
                ("bisect", lambda: s3.bidiag_singular_values(d, e)),
                ("dc", lambda: s3dc.bidiag_dc_singular_values(d, e)),
                ("bisect again", lambda: s3.bidiag_singular_values(d, e)),
                ("dc again", lambda: s3dc.bidiag_dc_singular_values(d, e))):
            times[solver] = gpu_ms(torch, fn, iters=3, warmup=1)
        row["stage3_alone_ms"] = times
        row["stage3_dc_profile"] = dc_profile(
            torch, lambda: s3dc.bidiag_dc_singular_values(d, e))
        oks.append(ok)
        out[f"banded_{dname}_n{n}"] = row
    nd = 1024
    cfg_sd = PipelineConfig.resolve(bw=64, dtype=torch.float64, n=nd,
                                    fuse=4, stage3="dc")
    ad = torch.randn((nd, nd), generator=gen, dtype=torch.float64,
                     device="cuda")
    uv_path = ["chase_superstep_cuda", "tape_apply_cuda"] + DC_PATH
    (u, sg, vt), ru = drive("fp64 n=1024 fuse=4 stage3=dc svd",
                            lambda: tsvd.svd(ad, config=cfg_sd), uv_path)
    sv, rv = drive("fp64 n=1024 fuse=4 stage3=dc singular_values",
                   lambda: tsvd.singular_values(ad, config=cfg_sd),
                   ["chase_superstep_cuda"] + DC_PATH)
    eye = torch.eye(nd, dtype=torch.float64, device="cuda")
    recon = float(torch.linalg.norm(ad - (u * sg) @ vt)
                  / torch.linalg.norm(ad))
    dense = {"n": nd, "bw": 64, "fuse": 4, "recon_rel_fro": recon,
             "tol_recon": 50 * nd * torch.finfo(torch.float64).eps,
             "orth_u": float((u.mT @ u - eye).abs().max()),
             "orth_v": float((vt @ vt.mT - eye).abs().max()),
             "tol_orth": 1e-9, "sigma_bitwise_vs_singular_values":
                 torch.equal(sg, sv),
             "err_vs_svdvals_over_sigma_max": float(
                 (sg - torch.linalg.svdvals(ad)).abs().max() / sg.max()),
             "runs": [ru, rv]}
    oks.append(recon <= dense["tol_recon"] and dense["orth_u"] <= 1e-9
               and dense["orth_v"] <= 1e-9 and torch.equal(sg, sv)
               and dense["err_vs_svdvals_over_sigma_max"] <= 1e-10)
    out["dense_fp64_n1024_svd"] = dense
    out["ok"] = all(oks)
    emit(out)
    check(out["ok"], "stage3_dc: dc sigma off its yardsticks, or the dense "
          "dc svd off its bounds")


def autotune_phase(torch, PipelineConfig) -> None:
    """The autotuner on the card: the (tw, fuse) search at fp64 n = 4096,
    bw 64 (top-k 2, with the model's predicted against the measured
    times), and the stage-3 crossover over n = 512 ... 16384 on the
    bidiagonals stage 2 makes of banded bw-64 inputs (what the pipeline
    hands stage 3), fp64 and fp32, B = 1 (the banded entry point's one
    matrix) and B = 4 up to n = 4096; beside them the reference's sweep on
    i.i.d. normal bidiagonals (fp64, B = 4).  The search and the B = 1
    crossovers are persisted to a temporary cache that
    ``PipelineConfig.resolve(autotune=True)`` then reads back.  ``DEFAULT_DC_N_MIN`` is compared
    with the largest banded reading: dc only where it won in every sweep."""
    import os
    import tempfile

    from repro_torch.autotune import cache as at_cache
    from repro_torch.autotune import search as at_search
    from repro_torch.core import tuning
    f64, f32 = torch.float64, torch.float32
    ns = (512, 1024, 2048, 4096, 8192, 16384)
    t0 = time.perf_counter()
    res = at_search.search(4096, 64, dtype=f64, backend="cuda", top_k=2,
                           warmup=1, iters=2, device="cuda")
    t1 = time.perf_counter()
    random = at_search.search_stage3_crossover(
        dtype=f64, ns=ns, batch=4, warmup=1, iters=5, backend="cuda",
        device="cuda")
    # B = 4 up to 4096, the sizes the batched entry points are driven at
    # here; no warm-up beyond the agreement call that precedes the timing
    banded = {(dt, b): at_search.search_stage3_crossover(
        dtype=dt, ns=ns if b == 1 else ns[:4], batch=b, warmup=0, iters=3,
        backend="cuda", device="cuda", bw=64)
        for dt in (f64, f32) for b in (1, 4)}
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cache.json")
        at_cache.store(res.to_entry(), device_kind=res.device_kind, n=4096,
                       bw=64, dtype="float64", compute_uv=False,
                       backend="cuda", path=path)
        for dt in (f64, f32):
            cross = banded[(dt, 1)]
            at_cache.store_stage3(cross.to_entry(),
                                  device_kind=cross.device_kind,
                                  dtype=cross.dtype, compute_uv=False,
                                  path=path)
        cfg = PipelineConfig.resolve(bw=64, dtype=f64, n=4096,
                                     stage3="auto", autotune=True,
                                     autotune_cache=path)
        free = {dt: PipelineConfig.resolve(bw=64, dtype=dt, stage3="auto",
                                           autotune=True,
                                           autotune_cache=path)
                for dt in (f64, f32)}
    sweeps = [random] + list(banded.values())
    agree = max(p[3] for c in sweeps if c.dtype == "float64"
                for p in c.points)
    agree32 = max(p[3] for c in sweeps if c.dtype == "float32"
                  for p in c.points)
    reading = max(c.dc_n_min for c in banded.values())
    ok = ((cfg.tw, cfg.fuse) == (res.best.tw, res.best.fuse)
          and all(free[dt].dc_n_min == banded[(dt, 1)].dc_n_min
                  for dt in (f64, f32))
          and agree <= 1e-12 and agree32 <= 1e-4)
    emit({"phase": "autotune", "ok": ok,
          "search_table": res.table().splitlines(),
          "model_rank_of_measured_best": res.model_rank_of_best(),
          "candidates": len(res.candidates),
          "measured": [{"tw": c.tw, "fuse": c.fuse,
                        "predicted_us": c.predicted_s * 1e6,
                        "measured_us": c.measured_s * 1e6,
                        "error_pct": c.error_pct} for c in res.measured],
          "best": res.to_entry(), "search_s": t1 - t0,
          "stage3_random_fp64_B4": {
              "table": random.table().splitlines(),
              "dc_n_min": random.dc_n_min},
          "stage3_banded_bw64": {
              f"{c.dtype} B={b}": {"table": c.table().splitlines(),
                                   "points": c.to_entry()["points"],
                                   "dc_n_min": c.dc_n_min,
                                   "predicted_dc_n_min": c.predicted_n_min}
              for (_, b), c in banded.items()},
          "dc_n_min_reading": reading,
          "stage3_search_s": t2 - t1, "max_agree_fp64": agree,
          "max_agree_fp32": agree32,
          "default_dc_n_min": tuning.DEFAULT_DC_N_MIN,
          "default_equals_reading": tuning.DEFAULT_DC_N_MIN == reading,
          "read_back": {"tw": cfg.tw, "fuse": cfg.fuse,
                        "stage3_at_n4096": cfg.stage3,
                        "dc_n_min": {tuning.dtype_name(dt): c.dc_n_min
                                     for dt, c in free.items()}}})
    check(ok, "autotune: the cache did not read back what the searches "
          "measured, or dc and bisection disagreed")
    autotune_serving(torch)


def autotune_serving(torch) -> None:
    """The serving knobs on the card: the fused-vs-staged crossover
    (``search_fused_crossover``, batch 8) at (bw 8, fp64) and (bw 32,
    fp32), whose smaller reading ``tuning.DEFAULT_FUSED_CROSSOVER`` must
    equal, and with U, Sigma, V^T at (bw 32, fp64), which must not read
    below it (the engine sends U Sigma V^T buckets to the fused tier by the
    same default); and where ``default_bucket_batch`` ranks on the batch
    axis at n = 1024, bw 64, fp32: a search over batches (1, d, 2d), and
    stage 2 at the default (tw, fuse) timed at each of the three."""
    from repro_torch.autotune import measure
    from repro_torch.autotune import search as at_search
    from repro_torch.core import tuning
    f64, f32 = torch.float64, torch.float32
    t0 = time.perf_counter()
    fused = {(bw, tuning.dtype_name(dt)): at_search.search_fused_crossover(
        bw, dtype=dt, warmup=1, iters=2, device="cuda")
        for bw, dt in ((8, f64), (32, f32))}
    reading = min(c.fused_n_max for c in fused.values())
    fused_uv = at_search.search_fused_crossover(
        32, dtype=f64, compute_uv=True, warmup=1, iters=2, device="cuda")
    t1 = time.perf_counter()
    n, bw = 1024, 64
    d = tuning.default_bucket_batch(n, bw, f32)
    batches = (1, d, 2 * d)
    res = at_search.search(n, bw, dtype=f32, backend="cuda", top_k=3,
                           fuses=(1, 2), batches=batches, warmup=1, iters=2,
                           device="cuda")
    by_measured = sorted(res.measured, key=lambda c: c.measured_s)
    tw_d, fuse_d = res.default.tw, res.default.fuse
    per_batch = {b: measure.time_stage2(n, bw, tw=tw_d, fuse=fuse_d, batch=b,
                                        backend="cuda", dtype=f32, warmup=1,
                                        iters=3, device="cuda") / b
                 for b in batches}
    ranked = sorted(batches, key=per_batch.get)
    t2 = time.perf_counter()
    same = tuning.DEFAULT_FUSED_CROSSOVER == reading
    uv_ok = tuning.DEFAULT_FUSED_CROSSOVER <= fused_uv.fused_n_max
    tables = {f"bw={bw_} {dn}": c for (bw_, dn), c in fused.items()}
    tables["bw=32 float64 uv"] = fused_uv
    emit({"phase": "autotune_serving", "ok": same and uv_ok,
          "fused_crossover": {
              label: {"table": c.table().splitlines(),
                      "fused_n_max": c.fused_n_max,
                      "predicted_n_max": c.predicted_n_max}
              for label, c in tables.items()},
          "fused_n_max_reading": reading,
          "fused_n_max_uv_reading": fused_uv.fused_n_max,
          "default_fused_crossover": tuning.DEFAULT_FUSED_CROSSOVER,
          "default_equals_reading": same,
          "default_within_uv_reading": uv_ok,
          "crossover_s": t1 - t0,
          "batch_search": {
              "n": n, "bw": bw, "dtype": "float32", "batches": batches,
              "default_bucket_batch": d,
              "table": res.table().splitlines(),
              "default": res.default.label(),
              "default_measured_rank": by_measured.index(res.default) + 1,
              "measured": len(by_measured),
              "model_rank_of_measured_best": res.model_rank_of_best(),
              "best": res.best.label()},
          "stage2_us_per_matrix_at_default_knobs": {
              str(b): t * 1e6 for b, t in per_batch.items()},
          "default_batch_rank": ranked.index(d) + 1,
          "search_s": t2 - t1})
    check(same, f"DEFAULT_FUSED_CROSSOVER {tuning.DEFAULT_FUSED_CROSSOVER} "
          f"is not the reading {reading}")
    check(uv_ok, f"DEFAULT_FUSED_CROSSOVER {tuning.DEFAULT_FUSED_CROSSOVER} "
          f"lies above the U Sigma V^T reading {fused_uv.fused_n_max}")


# the SVD serving mix: bucket key (n, bw, dtype, banded, compute_uv) ->
# share of the stream (the reference's FULL_MIX, benchmarks/serve_load.py:68-70) or a
# count of requests mixed in (they reach the staged kernels: n above
# DEFAULT_FUSED_CROSSOVER, so the U Sigma V^T row is at n = 1024)
SERVE_STREAM = {(96, 8, "float64", False, False): 0.7,
                (96, 8, "float64", False, True): 0.1,
                (64, 8, "float32", False, False): 0.2}
SERVE_STAGED = {(1024, 64, "float32", False, False): 8,
                (1024, 32, "float64", False, True): 4,
                (4096, 64, "float64", True, False): 2}
SERVE_BURST = 512               # closed-loop burst and each open-loop stream
SERVE_WINDOW_S = 0.01           # the engines' micro-batch window


def serve_tol(n: int, dname: str) -> float:
    """sigma against fp64 svdvals, over sigma_max (PERF.md section 1): fp64
    1e-12 to n = 128, 1e-11 to 1024, 1e-10 beyond; fp32 5e-4."""
    if dname == "float32":
        return 5e-4
    return 1e-12 if n <= 128 else 1e-11 if n <= 1024 else 1e-10


def serve_expected_kernels(tier: str, key, fuse: int) -> set:
    """The kernels a bucket of ``tier`` launches on the card."""
    n, _bw, _dt, banded, uv = key
    if tier == "fused":
        return {"fused_small_svd_cuda"} | ({"sturm_bisect_cuda"} if uv
                                           else set())
    out = {"chase_cycle_cuda" if fuse == 1 else "chase_superstep_cuda"}
    if tier == "staged-dc":
        out |= {"dc_leaf_cuda", "dc_deflate_cuda", "dc_secular_cuda"}
    else:
        out.add("sturm_bisect_cuda")
    if uv or not banded:
        out.add("tape_apply_cuda")           # stage 1 (dense) or the replay
    return out


def serve_requests(torch, gen, rng, count: int, with_staged: bool,
                   device="cuda"):
    """A seeded stream: ``count`` requests drawn from SERVE_STREAM's shares,
    and with ``with_staged`` SERVE_STAGED's requests at random positions.
    Matrices are made on the card in bulk; returns [(uid, key, matrix)]."""
    from repro_torch.core import tuning
    keys = list(SERVE_STREAM)
    picks = rng.choice(len(keys), size=count, p=list(SERVE_STREAM.values()))
    order = [keys[i] for i in picks]
    if with_staged:
        for key, c in SERVE_STAGED.items():
            for _ in range(c):
                order.insert(int(rng.integers(len(order) + 1)), key)
    out, pools = [], {}
    for key in dict.fromkeys(order):
        n, bw, dname, banded, _uv = key
        m = order.count(key)
        dt = tuning.dtype_of(dname)
        pools[key] = iter(
            banded_matrix(torch, (m,), n, bw, dt, gen, device) if banded
            else torch.randn((m, n, n), generator=gen, dtype=torch.float64,
                             device=device).to(dt))
    for uid, key in enumerate(order):
        out.append((uid, key, next(pools[key])))
    return out


def serve_submit(eng, SVDRequest, items, gaps=None, timeout_s=None):
    """Submit ``items`` (open loop with ``gaps`` between arrivals, else as one
    burst); returns (futures, requests, seconds from the first submit to the
    last completion)."""
    reqs, futs = [], []
    t0 = time.perf_counter()
    for i, (uid, key, a) in enumerate(items):
        if gaps is not None:
            time.sleep(gaps[i])
        n, bw, _dn, banded, uv = key
        r = SVDRequest(uid=uid, matrix=a, bw=bw, banded=banded,
                       compute_uv=uv)
        reqs.append(r)
        futs.append(eng.submit(r, timeout_s=timeout_s))
    errors = []
    for f in futs:
        try:
            f.result(timeout=600)
        except Exception as exc:                 # noqa: BLE001 — counted
            errors.append(repr(exc))
    return reqs, errors, time.perf_counter() - t0


def serve_latency(snap) -> dict:
    return {t: {q: row.get(q) for q in ("count", "p50_ms", "p95_ms",
                                         "p99_ms")}
            for t, row in snap["latency"]["tiers"].items()}


def svd_serve_phase(torch, main_counts=None, device="cuda") -> dict:
    """SVD serving on the card through ``AsyncSVDEngine(device="cuda")``:
    every bucket of the mix warmed once (the builds), a closed-loop burst of
    SERVE_BURST stream requests (the sustained rate), an open-loop Poisson
    stream at half that rate with the staged requests mixed in, the same
    stream under a seeded FaultPlan (the default RetryPolicy without
    backoff), one request forced through the degraded ref tier, and one
    traced dispatch of the n = 1024 bucket beside an untraced one.  The
    engines are built as a user builds them: no config, no cap, so each
    bucket holds ``default_bucket_batch`` matrices.  Holds sigma to fp64 svdvals, U and V^T
    to 50 n eps, each bucket's first clean dispatch bit for bit to a direct
    call on the same padded stack (its padded rows zero and finite), the
    clean run to no retry, degraded, failed or timed-out request and each
    bucket to the tier ``_fused_n_max_for`` / ``_dc_n_min_for`` give, the
    kernels of every tier served to a launch, the faulted run to every
    request answered and agreeing with the clean one, the forced request
    served degraded and right, and the traced
    dispatch's stage spans to >= 90 % of its root.  The two streams'
    launches join ``main_counts``.  (``device="cpu"`` rehearses the phase's
    logic on the plain versions, with smaller SERVE_* tables.)"""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core import svd as tsvd
    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    from repro_torch.serve import (AsyncSVDEngine, FaultPlan, RetryPolicy,
                                   SVDEngine, SVDRequest, bucket_key_str)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1234)
    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    sync_dev = (torch.cuda.synchronize if device == "cuda"
                else (lambda: None))
    out = {"phase": "svd_serve", "window_s": SERVE_WINDOW_S}
    failures = []

    def engine(**kw):
        return AsyncSVDEngine(device=device, batch_window_s=SERVE_WINDOW_S,
                              **kw)

    # ---- 1. warm every bucket (builds, allocator), untimed --------------
    eng = engine()
    warm = []
    for key in list(SERVE_STREAM) + list(SERVE_STAGED):
        n, bw, dname, banded, _uv = key
        dt = tuning.dtype_of(dname)
        a = (banded_matrix(torch, (), n, bw, dt, gen, device) if banded
             else torch.randn((n, n), generator=gen, dtype=torch.float64,
                              device=device).to(dt))
        warm.append((len(warm), key, a))
    _, errs, warm_s = serve_submit(eng, SVDRequest, warm)
    eng.stop(timeout=600)
    cfgs = {key: eng._cfg_for(key) for key in dict.fromkeys(
        [k for _, k, _ in warm])}
    tiers = {key: eng.metrics.tier_of_bucket(key) for key in cfgs}
    want_tier = {}
    for key, cfg in cfgs.items():
        n = key[0]
        fused_ok = n <= eng._fused_n_max_for(key)
        if fused_ok:
            try:
                tuning.check_fused_smem_budget(n, key[2], compute_uv=key[4])
            except ValueError:
                fused_ok = False
        want_tier[key] = ("fused" if fused_ok else "staged-dc"
                          if n >= max(eng._dc_n_min_for(key), 1) else
                          "staged")
    out["warm"] = {"seconds": warm_s, "errors": errs,
                   "buckets": {bucket_key_str(k): {
                       "tier": tiers[k], "expected_tier": want_tier[k],
                       "max_batch": c.max_batch, "tw": c.tw, "fuse": c.fuse,
                       "backend": c.backend} for k, c in cfgs.items()}}
    if errs:
        failures.append("warm-up errors")
    if tiers != want_tier:
        failures.append("a bucket's tier is not the one its crossovers give")

    # ---- 2. closed-loop burst of the stream ------------------------------
    burst = serve_requests(torch, gen, rng, SERVE_BURST, False, device)
    eng = engine()
    _, errs, burst_s = serve_submit(eng, SVDRequest, burst)
    eng.stop(timeout=600)
    rate = SERVE_BURST / burst_s
    snap = eng.metrics.snapshot()
    out["burst"] = {"requests": SERVE_BURST, "seconds": burst_s,
                    "requests_per_s": rate, "errors": len(errs),
                    "batches": snap["batches"],
                    "batch_fill_ratio": snap["batch_fill_ratio"],
                    "latency": serve_latency(snap)}
    if errs:
        failures.append("burst errors")

    # ---- 3. open-loop Poisson stream at half the rate, staged mixed in --
    stream = serve_requests(torch, gen, rng, SERVE_BURST, True, device)
    gaps = rng.exponential(2.0 / rate, len(stream))
    dispatches = {}
    eng = engine()
    orig = eng._serve_batch

    def recording(key, cfg, reqs):
        dispatches.setdefault(key, (cfg, [r.uid for r in reqs]))
        return orig(key, cfg, reqs)
    eng._serve_batch = recording
    ops.reset_launch_counts()
    clean, errs, clean_s = serve_submit(eng, SVDRequest, stream, gaps)
    eng.stop(timeout=600)
    counts = ops.launch_counts()
    snap, health = eng.metrics.snapshot(), eng.metrics.health()
    if main_counts is not None:
        for k, v in counts.items():
            main_counts[k] += v
    out["poisson_clean"] = {
        "requests": len(stream), "offered_per_s": rate / 2,
        "seconds": clean_s, "requests_per_s": len(stream) / clean_s,
        "errors": errs[:5], "latency": serve_latency(snap),
        "launches": {k: v for k, v in counts.items() if v},
        "snapshot": snap, "health": health}
    if errs or any(snap[k] for k in ("retried", "degraded", "failed",
                                     "timed_out")):
        failures.append("the clean stream retried, degraded, failed or "
                        "timed out a request")
    expect = set()
    for key in cfgs:
        expect |= serve_expected_kernels(tiers[key], key, cfgs[key].fuse)
    out["poisson_clean"]["expected_kernels"] = sorted(expect)
    missing = sorted(k for k in expect if not counts.get(k))
    if missing:
        failures.append(f"kernels of a served tier not launched: {missing}")

    # accuracy of every answer: sigma against fp64 svdvals, U and V^T
    by_uid = {r.uid: r for r in clean}
    acc = {}
    for key in cfgs:
        n, _bw, dname, _banded, uv = key
        rs = [r for r in clean if r.key() == key]
        if not rs:
            continue
        a = torch.stack([torch.as_tensor(r.matrix) for r in rs]).double()
        sv = torch.linalg.svdvals(a).cpu().numpy()
        got = np.stack([r.sigma for r in rs]).astype(np.float64)
        err = float(np.max(np.abs(got - sv) / sv[:, :1]))
        row = {"requests": len(rs), "sigma_err_over_max": err,
               "tol": serve_tol(n, dname)}
        if err > row["tol"]:
            failures.append(f"sigma of {bucket_key_str(key)} off svdvals")
        if uv:
            u = torch.from_numpy(np.stack([r.u for r in rs])).to(a)
            vt = torch.from_numpy(np.stack([r.vt for r in rs])).to(a)
            s_ = torch.from_numpy(got).to(a)
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            recon = float((torch.linalg.norm(a - (u * s_[:, None]) @ vt,
                                             dim=(-2, -1))
                           / torch.linalg.norm(a, dim=(-2, -1))).max())
            orth = max(float((u.mT @ u - eye).abs().max()),
                       float((vt @ vt.mT - eye).abs().max()))
            lim = 50 * n * torch.finfo(tuning.dtype_of(dname)).eps
            row.update(recon=recon, orth=orth, uv_tol=lim)
            if recon > lim or orth > lim:
                failures.append(f"U, V^T of {bucket_key_str(key)} off 50 n eps")
        acc[bucket_key_str(key)] = row
    out["poisson_clean"]["accuracy"] = acc

    # each bucket's first dispatch, bit for bit a direct call on the same
    # padded stack; the padded rows zero and finite
    bitwise = {}
    for key, (cfg, uids) in dispatches.items():
        n, _bw, dname, banded, uv = key
        dt = tuning.dtype_of(dname)
        stack = torch.zeros((cfg.max_batch, n, n), dtype=dt, device=device)
        for i, uid in enumerate(uids):
            stack[i].copy_(torch.as_tensor(by_uid[uid].matrix))
        if uv:
            fn = tsvd.banded_svd if banded else tsvd.svd
            u, sig, vt = fn(stack, config=cfg, compute_uv=True)
        elif banded:
            u = vt = None
            sig = tsvd.banded_singular_values(stack, config=cfg)
        else:
            u = vt = None
            sig = tsvd.svd_batched(stack, cfg)
        k = len(uids)
        same = all(torch.equal(sig[i].cpu(), torch.from_numpy(
            by_uid[uid].sigma)) for i, uid in enumerate(uids))
        if uv:
            same = same and all(
                torch.equal(u[i].cpu(), torch.from_numpy(by_uid[uid].u))
                and torch.equal(vt[i].cpu(), torch.from_numpy(
                    by_uid[uid].vt)) for i, uid in enumerate(uids))
        pad = sig[k:]
        eps = torch.finfo(dt).eps
        pad_ok = bool(torch.isfinite(pad).all()) and (
            pad.numel() == 0 or float(pad.abs().max()) <= eps)
        if uv and k < cfg.max_batch:
            pad_ok = pad_ok and bool(torch.isfinite(u[k:]).all()
                                     and torch.isfinite(vt[k:]).all())
        bitwise[bucket_key_str(key)] = {
            "served": k, "padded": cfg.max_batch - k, "bitwise": same,
            "padded_max_sigma": float(pad.abs().max()) if pad.numel() else 0.0,
            "padded_zero_and_finite": pad_ok}
        if not (same and pad_ok):
            failures.append(f"{bucket_key_str(key)}: not bit for bit the direct "
                            f"call, or padded rows not zero and finite")
    out["poisson_clean"]["bitwise_vs_direct"] = bitwise

    # ---- 4. the same stream under a seeded FaultPlan --------------------
    # the default policy without backoff: a request whose attempts all fail
    # is served on the plain ref tier, slow at n = 4096 (PERF.md section 7)
    no_backoff = dict(backoff_base_s=0.0, backoff_max_s=0.0)
    plan = FaultPlan(seed=7, dispatch_error_rate=0.05, nan_rate=0.05)
    eng = engine(faults=plan, retry=RetryPolicy(**no_backoff))
    ops.reset_launch_counts()
    faulted, errs, fault_s = serve_submit(eng, SVDRequest, stream, gaps)
    eng.stop(timeout=600)
    counts = ops.launch_counts()
    if main_counts is not None:
        for k, v in counts.items():
            main_counts[k] += v
    snap = eng.metrics.snapshot()
    worst = 0.0
    for r in faulted:
        c = by_uid[r.uid]
        if r.error is not None or r.sigma is None:
            continue
        worst = max(worst, float(np.max(np.abs(
            r.sigma.astype(np.float64) - c.sigma)) / max(
                float(np.max(c.sigma)), 1e-300)) / serve_tol(
                    r.key()[0], r.key()[2]))
    out["poisson_faults"] = {
        "seconds": fault_s, "requests_per_s": len(stream) / fault_s,
        "errors": errs[:5],
        "completed": snap["completed"], "retried": snap["retried"],
        "degraded": snap["degraded"], "quarantined": snap["quarantined"],
        "failed": snap["failed"], "timed_out": snap["timed_out"],
        "injected": plan.snapshot(), "latency": serve_latency(snap),
        "tiers": snap["tiers"], "health": eng.metrics.health()["status"],
        "sigma_vs_clean_over_tol": worst}
    if errs or snap["completed"] != len(stream) or worst > 1.0:
        failures.append("the faulted stream lost a request or moved sigma")

    # ---- 4b. one request of the main fused bucket, its two attempts given
    # NaN sigma, so the ladder serves it on the degraded ref tier ---------
    key = next(iter(SERVE_STREAM))
    n, bw, dname, _banded, _uv = key
    a = torch.randn((n, n), generator=gen, dtype=torch.float64,
                    device=device).to(tuning.dtype_of(dname))
    sync = SVDEngine(device=device, faults=FaultPlan(nan_at=(0, 1)),
                     retry=RetryPolicy(**no_backoff))
    sync.submit(SVDRequest(uid=0, matrix=a, bw=bw))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    (r,) = sync.run()
    deg_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v != before[k]}
    snap = sync.metrics.snapshot()
    sv = torch.linalg.svdvals(a.double()).cpu().numpy()
    err = (float(np.max(np.abs(r.sigma - sv)) / sv[0])
           if r.error is None else None)
    out["forced_degraded"] = {
        "bucket": bucket_key_str(key), "seconds": deg_s,
        "degraded_cap": sync._degraded_cfg(key, 0).max_batch,
        "retried": snap["retried"], "degraded": snap["degraded"],
        "failed": snap["failed"], "error": repr(r.error),
        "launches": launched,
        "latency": serve_latency(snap), "sigma_err_over_max": err,
        "tol": serve_tol(n, dname)}
    if (r.error is not None or snap["degraded"] != 1
            or snap["retried"] != 1 or err > serve_tol(n, dname)):
        failures.append("the forced request was not served right on the "
                        "degraded tier")

    # ---- the fused kernel at the stream's bucket shapes (CUDA events) --
    if device == "cuda":
        fused_ms = {}
        for key, cfg in cfgs.items():
            if tiers[key] != "fused":
                continue
            n, bw, dname, _banded, uv = key
            a = torch.randn((cfg.max_batch, n, n), generator=gen,
                            dtype=torch.float64, device=device).to(
                                tuning.dtype_of(dname))
            fused_ms[bucket_key_str(key)] = gpu_ms(
                torch, lambda: ops.fused_svd(a, bw=cfg.bw, compute_uv=uv,
                                             config=cfg), iters=5, warmup=1)
        out["fused_kernel_ms_at_bucket_shape"] = fused_ms

    # ---- 5. one traced dispatch of the n = 1024 bucket -----------------
    key = next(iter(SERVE_STAGED))          # the n = 1024 bucket
    n, bw, dname, _banded, _uv = key
    mats = torch.randn((SERVE_STAGED[key], n, n), generator=gen,
                       dtype=torch.float64, device=device).to(
                           tuning.dtype_of(dname))
    times = {}
    tr = obs.Tracer("svd_serve")
    for label in ("untraced", "traced", "traced", "untraced"):
        sync = SVDEngine(device=device,
                         tracer=tr if label == "traced" else None)
        for i in range(len(mats)):
            sync.submit(SVDRequest(uid=i, matrix=mats[i], bw=bw))
        sync_dev()
        t0 = time.perf_counter()
        done = sync.run()
        times.setdefault(label, []).append(time.perf_counter() - t0)
        if sync.calls != 1 or any(r.error for r in done):
            failures.append("the n = 1024 dispatch was not one call")
    root = tr.roots[-1]
    entry = root.children[0] if root.children else root
    stage = entry.total_child_seconds() / entry.dur_s
    out["traced_dispatch"] = {
        "bucket": bucket_key_str(key), "batch": SERVE_STAGED[key],
        "untraced_s": times["untraced"], "traced_s": times["traced"],
        "stage_cover_of_entry": stage,
        "entry_cover_of_dispatch": entry.dur_s / root.dur_s,
        "first_tree": tr.roots[0].format().splitlines(),
        "tree": root.format().splitlines()}
    if stage < 0.9:
        failures.append(f"stage spans cover {stage:.1%} of the traced root")

    out["seconds"] = time.perf_counter() - t_phase
    out["failures"] = failures
    out["ok"] = not failures
    emit(out)
    check(out["ok"], f"svd_serve: {failures}")
    return out


# the svd_fabric phase: two shards of a mesh on the one card, the
# column-sharded chase at fp64 (n, bw), and worker processes on the card
FABRIC_SHARDS = 2
FABRIC_CHASE = (4096, 64)
FABRIC_HOSTS = 2


def fabric_dispatch(torch, mesh, gen, device, failures) -> dict:
    """(a) Every bucket of the serving mix through
    ``sharded_pipeline_dispatch`` on ``mesh`` (its config as the engines
    resolve it; B odd, so the padding to the shards is exercised): against
    the unsharded pipeline on the same stack, bit for bit or within
    ``serve_tol``, and with shard 0 lost, bit for bit the clean sharded run;
    then an ``AsyncSVDEngine(mesh=...)``."""
    import numpy as np

    from repro_torch.core import distributed as tdist
    from repro_torch.core import tuning
    from repro_torch.serve import (AsyncSVDEngine, FaultPlan, SVDEngine,
                                   SVDRequest, bucket_key_str)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    eng = SVDEngine(device=device)
    rows = {}
    for key in list(SERVE_STREAM) + list(SERVE_STAGED):
        n, bw, dname, banded, uv = key
        cfg = eng._cfg_for(key)
        b = SERVE_STAGED[key] + 1 if key in SERVE_STAGED else cfg.max_batch - 1
        dt = tuning.dtype_of(dname)
        mats = (banded_matrix(torch, (b,), n, bw, dt, gen, device) if banded
                else torch.randn((b, n, n), generator=gen, dtype=torch.float64,
                                 device=device).to(dt))
        kw = dict(banded=banded, compute_uv=uv)
        sync()
        t0 = time.perf_counter()
        ref = tdist._local(mats, cfg, **kw)
        sync()
        t_un = time.perf_counter() - t0
        got = tdist.sharded_pipeline_dispatch(mats, mesh, config=cfg, **kw)
        sync()
        t_sh = time.perf_counter() - t0 - t_un
        retries = []
        lost = tdist.sharded_pipeline_dispatch(
            mats, mesh, config=cfg, faults=FaultPlan(shard_loss_at=(0,)),
            on_shard_retry=retries.append, **kw)
        names = ("u", "sigma", "vt") if uv else ("sigma",)
        parts = [t if uv else (t,) for t in (got, ref, lost)]
        bitwise = {nm: torch.equal(x, y)
                   for nm, x, y in zip(names, parts[0], parts[1])}
        diff = {nm: float((x.double() - y.double()).abs().max())
                for nm, x, y in zip(names, parts[0], parts[1])}
        scale = float(parts[1][names.index("sigma")].abs().max())
        tol = serve_tol(n, dname)
        row = {"batch": b, "per_shard": -(-b // len(mesh)),
               "max_batch": cfg.max_batch, "tier": eng._tier_of(cfg, n),
               "unsharded_s": t_un, "sharded_s": t_sh, "bitwise": bitwise,
               "sigma_diff_over_max": diff["sigma"] / scale, "tol": tol,
               "lost_shard_retries": sum(retries),
               "lost_shard_bitwise_vs_clean": all(
                   torch.equal(x, y) for x, y in zip(parts[2], parts[0]))}
        if all(bitwise.values()):
            row["verdict"] = "bitwise"
        else:
            off = [nm for nm, same in bitwise.items() if not same]
            row.update(uv_max_abs_diff={nm: diff[nm] for nm in names
                                        if nm != "sigma"})
            within = (diff["sigma"] / scale <= tol and all(
                diff[nm] <= tol for nm in names if nm != "sigma"))
            row["verdict"] = "within_serve_tol" if within else "off"
            # the same pipeline, unsharded, on shard 0's slice alone: bit
            # for bit shard 0's results when only the batch size differs
            per = row["per_shard"]
            alone = tdist._local(mats[:per], cfg, **kw)
            alone = alone if uv else (alone,)
            row["shard0_bitwise_vs_unsharded_at_its_batch"] = all(
                torch.equal(x[:per], y) for x, y in zip(parts[0], alone))
            calls = []
            if not banded and row["tier"] != "fused":
                calls.append("stage 1's products (core/stage1.py)")
            if uv:
                calls.append("stage 3's vector products "
                             "(core/bidiag_svd.py) and the composition "
                             "U2 Ub, Vb^T V2^T")
            row["reason"] = (
                f"{', '.join(off)} not bit for bit: a shard runs "
                f"{per} matrices where the unsharded call runs {b}, and "
                f"{' and '.join(calls)} are batched library products (cuBLAS "
                f"on the card) whose kernel depends on the batch count "
                f"(every kernel of the "
                f"port treats each matrix alone); shard 0 against the "
                f"unsharded pipeline on its own {per}: "
                + ("bit for bit" if row[
                    "shard0_bitwise_vs_unsharded_at_its_batch"]
                   else "not bit for bit either"))
            if not within:
                failures.append(f"svd_fabric (a): {bucket_key_str(key)} "
                                f"sharded off the unsharded dispatch")
        if not (row["lost_shard_bitwise_vs_clean"]
                and row["lost_shard_retries"] == 1):
            failures.append(f"svd_fabric (a): {bucket_key_str(key)} lost "
                            f"shard not recovered bit for bit")
        rows[bucket_key_str(key)] = row

    key = next(iter(SERVE_STREAM))
    n, bw, dname, _banded, _uv = key
    mats = torch.randn((8, n, n), generator=gen, dtype=torch.float64,
                       device=device).to(tuning.dtype_of(dname))
    with AsyncSVDEngine(device=device, mesh=mesh,
                        batch_window_s=SERVE_WINDOW_S) as aeng:
        futs = [aeng.submit(SVDRequest(uid=i, matrix=mats[i], bw=bw))
                for i in range(len(mats))]
        done = [f.result(timeout=600) for f in futs]
    snap = aeng.metrics.snapshot()
    sv = torch.linalg.svdvals(mats.double()).cpu().numpy()
    err = max(float(np.max(np.abs(r.sigma - sv[i])) / sv[i, 0])
              for i, r in enumerate(done))
    engine_row = {"bucket": bucket_key_str(key), "requests": len(done),
                  "batches": snap["batches"],
                  "sharded_batches": snap["sharded_batches"],
                  "sigma_err_over_max": err, "tol": serve_tol(n, dname)}
    if snap["sharded_batches"] < 1 or any(r.error for r in done) \
            or err > serve_tol(n, dname):
        failures.append("svd_fabric (a): AsyncSVDEngine(mesh=) did not "
                        "serve through the mesh")
    return {"buckets": rows, "async_engine": engine_row}


def fabric_column_chase(torch, mesh, gen, device, failures, n, bw):
    """(b) ``bidiagonalize_sharded`` at fp64 (n, bw) on ``mesh``: sigma
    through stage 3 against the unsharded ``banded_singular_values`` within
    1e-10 sigma_max, the one-cycle band kernel launched once a shard a
    cycle.
    Returns the phase's row and the sharded run's launches."""
    from repro_torch.core import bidiag_svd as s3
    from repro_torch.core import bulge_chasing as bc
    from repro_torch.core import distributed as tdist
    from repro_torch.core import svd as tsvd
    from repro_torch.core import tuning
    from repro_torch.kernels import ops
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    a = banded_matrix(torch, (), n, bw, torch.float64, gen, device)
    cfg = tuning.PipelineConfig.resolve(bw=bw, dtype=torch.float64, n=n,
                                        device=device)
    plan = tuning.stage_plan(bw, cfg.tw)
    cycles = sum(bc.stage_schedule(n, b_in, tw)[1] for b_in, tw in plan)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    d, e = tdist.bidiagonalize_sharded(a, bw=bw, tw=cfg.tw, mesh=mesh)
    sync()
    t_sh = time.perf_counter() - t0
    sharded_launches = ops.launch_counts()
    sig_sh = s3.bidiag_singular_values(d, e)
    sync()
    t0 = time.perf_counter()
    d1, e1 = tsvd.bidiagonal_of(a, config=cfg)
    sync()
    t_un = time.perf_counter() - t0
    unsharded_launches = ops.launch_counts()
    sig_un = tsvd.banded_singular_values(a, config=cfg)
    err = float((sig_sh - sig_un).abs().max() / sig_un.abs().max())
    sharded = sharded_launches["chase_cycle_cuda"]
    row = {"n": n, "bw": bw, "dtype": "float64", "shards": len(mesh),
           "plan": [list(p) for p in plan], "cycles": cycles,
           "sharded_s": t_sh, "unsharded_stage2_s": t_un,
           "sharded_band_launches": sharded,
           "unsharded_band_launches": (unsharded_launches["chase_cycle_cuda"]
                                       - sharded),
           "sigma_diff_over_max": err, "tol": 1e-10,
           "bidiagonal_bitwise_vs_unsharded": bool(
               torch.equal(d, d1) and torch.equal(e, e1))}
    if err > 1e-10:
        failures.append("svd_fabric (b): column-sharded sigma off the "
                        "unsharded call")
    if device == "cuda" and sharded != cycles * len(mesh):
        failures.append(f"svd_fabric (b): {sharded} band-entry launches "
                        f"for {cycles} cycles on {len(mesh)} shards")
    return row, sharded_launches


def fabric_fleet(torch, gen, rng, device, failures, offered_rate) -> dict:
    """(c) An ``SVDRouter`` here, with the heartbeat and timeout it ships
    with, over FABRIC_HOSTS worker processes, each pinned to a card as
    ``launch/serve.py --svd --hosts`` pins them (all on the one card here):
    every bucket warmed on every host, a burst and a Poisson stream of the
    mix, then the same stream with the owner of a just-submitted request
    SIGKILLed in the middle; every answer bit for bit the in-process
    engine's on the same matrix and bucket.  The largest gap between a live
    worker's pongs is watched from the workers' start, per segment, and
    fails the phase where it reaches the router's heartbeat timeout."""
    import signal
    import threading

    import numpy as np

    from repro_torch.core import tuning
    from repro_torch.serve import (SVDEngine, SVDRequest, SVDRouter,
                                   bucket_key_str, spawn_worker_process)
    keys = list(SERVE_STREAM) + list(SERVE_STAGED)
    host_items = [
        (uid, key, a.cpu().numpy()) for uid, key, a in
        serve_requests(torch, gen, rng, SERVE_BURST, False, device)]
    stream = [(uid, key, a.cpu().numpy()) for uid, key, a in
              serve_requests(torch, gen, rng, SERVE_BURST, True, device)]
    res = {"hosts": FABRIC_HOSTS}
    router = SVDRouter()
    res["heartbeat_s"] = router.heartbeat_s
    res["heartbeat_timeout_s"] = router.heartbeat_timeout_s
    cards = torch.cuda.device_count() if device == "cuda" else 0
    segment, ages, watching = ["connect"], {}, threading.Event()

    def watch():                     # the largest gap between pongs
        while not watching.wait(0.02):
            for row in router.fleet()["hosts"].values():
                if row["alive"]:
                    ages[segment[0]] = max(ages.get(segment[0], 0.0),
                                           row["last_seen_age_s"])

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    procs = {f"w{i}": spawn_worker_process(
        router.address, f"w{i}", device=device,
        card=i % cards if cards else None,
        window_ms=SERVE_WINDOW_S * 1e3) for i in range(FABRIC_HOSTS)}
    answers = {}
    try:
        t0 = time.perf_counter()
        while not router.wait_for_hosts(FABRIC_HOSTS, timeout=1.0):
            dead = {h: p.returncode for h, p in procs.items()
                    if p.poll() is not None}
            if dead or time.perf_counter() - t0 > 300:
                raise PhaseFailed(f"svd_fabric: workers did not connect "
                                  f"(exit codes {dead})")
        res["hosts_up_s"] = time.perf_counter() - t0
        res["hello"] = {h: {k: row.get(k) for k in (
            "pid", "device", "devices", "global_devices", "process_index",
            "processes")} for h, row in router.fleet()["hosts"].items()}
        warm = []
        for i, key in enumerate(keys):
            n, bw, dname, banded, uv = key
            dt = tuning.dtype_of(dname)
            a = (banded_matrix(torch, (), n, bw, dt, gen, device) if banded
                 else torch.randn((n, n), generator=gen, dtype=torch.float64,
                                  device=device).to(dt))
            warm.append(SVDRequest(uid=-1 - i, matrix=a.cpu().numpy(), bw=bw,
                                   banded=banded, compute_uv=uv))
        segment[0] = "warm"
        t0 = time.perf_counter()
        router.warm(warm, timeout=900)
        res["warm_s"] = time.perf_counter() - t0
        res["owners"] = {bucket_key_str(k): router.owner_of(k) for k in keys}

        segment[0] = "burst"
        router.reset_stats()
        reqs, errs, secs = serve_submit(router, SVDRequest, host_items)
        rate = len(host_items) / secs
        answers["burst"] = reqs
        res["burst"] = {"requests": len(host_items), "seconds": secs,
                        "requests_per_s": rate, "errors": errs[:5],
                        "completed_per_host": {
                            h: row["completed"] for h, row in
                            router.metrics.snapshot()["hosts"].items()}}
        offered = offered_rate or rate / 2
        gaps = rng.exponential(1.0 / offered, len(stream))
        segment[0] = "poisson"
        router.reset_stats()
        reqs, errs, secs = serve_submit(router, SVDRequest, stream, gaps)
        snap = router.metrics.snapshot()
        answers["poisson"] = reqs
        res["poisson"] = {
            "requests": len(stream), "offered_per_s": offered,
            "seconds": secs, "requests_per_s": len(stream) / secs,
            "errors": errs[:5], "latency": serve_latency(snap),
            "completed_per_host": {h: row["completed"]
                                   for h, row in snap["hosts"].items()},
            "retried": snap["retried"], "failed": snap["failed"],
            "timed_out": snap["timed_out"],
            "host_stats": {h: {"batches": p["snapshot"]["batches"],
                               "tiers": p["snapshot"]["tiers"]}
                           for h, p in router.collect_host_stats(30).items()}}
        if errs or snap["retried"] or snap["failed"] or snap["timed_out"]:
            failures.append("svd_fabric (c): the clean stream retried, "
                            "failed or timed out a request")
        if errs or len(answers["burst"]) != len(host_items):
            failures.append("svd_fabric (c): burst errors")

        # the same stream; the owner of the request submitted at its middle
        # is SIGKILLed right after that submit
        segment[0] = "kill"
        router.reset_stats()
        mid = len(stream) // 2
        victim = None
        resolved: dict = {}
        kill_reqs, futs = [], []
        t0 = time.perf_counter()
        for i, (uid, key, a) in enumerate(stream):
            time.sleep(gaps[i])
            n, bw, _dn, banded, uv = key
            r = SVDRequest(uid=uid, matrix=a, bw=bw, banded=banded,
                           compute_uv=uv)
            f = router.submit(r)
            f.add_done_callback(
                lambda _f, uid=uid: resolved.__setitem__(
                    uid, resolved.get(uid, 0) + 1))
            kill_reqs.append(r)
            futs.append(f)
            if i == mid:
                victim = router.owner_of(key)
                procs[victim].send_signal(signal.SIGKILL)
                t_kill = time.perf_counter() - t0
        kerrs = []
        for f in futs:
            try:
                f.result(timeout=900)
            except Exception as exc:             # noqa: BLE001 — counted
                kerrs.append(repr(exc))
        ksecs = time.perf_counter() - t0
        snap = router.metrics.snapshot()
        survivor = next(h for h in procs if h != victim)
        orphaned = [bucket_key_str(k) for k in keys
                    if res["owners"][bucket_key_str(k)] == victim]
        owners_after = {bucket_key_str(k): router.owner_of(k) for k in keys}
        answers["kill"] = kill_reqs
        res["kill"] = {
            "victim": victim, "survivor": survivor, "killed_at_s": t_kill,
            "seconds": ksecs, "errors": kerrs[:5],
            "completed": snap["completed"], "retried": snap["retried"],
            "failed": snap["failed"], "timed_out": snap["timed_out"],
            "dropped": len(stream) - snap["completed"],
            "resolved_once": (len(resolved) == len(stream)
                              and set(resolved.values()) == {1}),
            "per_host": snap["hosts"], "orphaned_buckets": orphaned,
            "owners_after": owners_after,
            "dead_hosts": router.fleet()["dead_hosts"],
            "latency": serve_latency(snap)}
        k = res["kill"]
        if (kerrs or not k["resolved_once"] or k["dropped"] or k["retried"] < 1
                or any(owners_after[b] != survivor for b in orphaned)
                or snap["hosts"].get(survivor, {}).get("requeued", 0) < 1
                or victim not in k["dead_hosts"]):
            failures.append("svd_fabric (c): the SIGKILL stream lost, "
                            "doubled or misrouted a request")
    finally:
        watching.set()
        router.stop()
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
        res["exit_codes"] = {h: p.returncode for h, p in procs.items()}
    res["largest_pong_gap_s"] = max(ages.values(), default=0.0)
    res["largest_pong_gap_by_segment_s"] = ages
    if res["largest_pong_gap_s"] >= router.heartbeat_timeout_s:
        failures.append(f"svd_fabric (c): a live worker's pongs "
                        f"{res['largest_pong_gap_s']:.2f} s apart, at or past "
                        f"the router's heartbeat timeout of "
                        f"{router.heartbeat_timeout_s} s")

    # the in-process engine on the same matrices and buckets
    ref = {}
    for name, items in (("burst", host_items), ("poisson", stream)):
        eng = SVDEngine(device=device)
        for uid, key, a in items:
            n, bw, _dn, banded, uv = key
            eng.submit(SVDRequest(uid=uid, matrix=a, bw=bw, banded=banded,
                                  compute_uv=uv))
        ref[name] = {r.uid: r for r in eng.run()}
    ref["kill"] = ref["poisson"]
    bitwise = {}
    for name, reqs in answers.items():
        same = 0
        for r in reqs:
            want = ref[name][r.uid]
            ok = (r.error is None and want.error is None
                  and np.array_equal(r.sigma, want.sigma))
            if ok and r.compute_uv:
                ok = (np.array_equal(r.u, want.u)
                      and np.array_equal(r.vt, want.vt))
            same += ok
        bitwise[name] = {"requests": len(reqs), "bitwise": same}
        if same != len(reqs):
            failures.append(f"svd_fabric (c): {len(reqs) - same} {name} "
                            f"answers not bit for bit the in-process engine")
    res["bitwise_vs_in_process"] = bitwise
    return res


def svd_fabric_phase(torch, main_counts=None, device="cuda",
                     offered_rate=None) -> None:
    """SVD serving across devices and processes on the one card: (a) batch
    dispatch over a mesh of FABRIC_SHARDS shards on ``cuda:0``, (b) the
    column-sharded chase at fp64 FABRIC_CHASE on that mesh, (c) the router
    and FABRIC_HOSTS worker processes (``fabric_dispatch``,
    ``fabric_column_chase``, ``fabric_fleet``).  The launches of (a) and
    (b) join ``main_counts``; the workers' launches are their own
    processes'.  (``device="cpu"`` rehearses the phase's logic on the plain
    versions, with smaller tables.)"""
    import os

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh, serve_mesh
    t_phase = time.perf_counter()
    rng = np.random.default_rng(4321)
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    mesh = DeviceMesh([f"{device}:0" if device == "cuda" else device]
                      * FABRIC_SHARDS)
    out = {"phase": "svd_fabric", "mesh": [str(d) for d in mesh]}
    failures = []
    saved = os.environ.get("REPRO_SERVE_MESH")
    os.environ["REPRO_SERVE_MESH"] = "auto"
    try:
        auto = serve_mesh()
    finally:
        if saved is None:
            del os.environ["REPRO_SERVE_MESH"]
        else:
            os.environ["REPRO_SERVE_MESH"] = saved
    out["serve_mesh_auto"] = None if auto is None else [str(d) for d in auto]
    if auto is None and device == "cuda" and torch.cuda.device_count() > 1:
        failures.append("serve_mesh() under auto is None on several cards")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out["sharded_dispatch"] = fabric_dispatch(torch, mesh, gen, device,
                                              failures)
    out["sharded_dispatch"]["seconds"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    out["sharded_dispatch"]["launches"] = {k: v for k, v in counts.items()
                                           if v}
    if main_counts is not None:
        for k, v in counts.items():
            main_counts[k] += v

    n, bw = FABRIC_CHASE
    out["column_chase"], counts = fabric_column_chase(
        torch, mesh, gen, device, failures, n, bw)
    if main_counts is not None:
        for k, v in counts.items():
            main_counts[k] += v

    t0 = time.perf_counter()
    out["fleet"] = fabric_fleet(torch, gen, rng, device, failures,
                                offered_rate)
    out["fleet"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    out["failures"] = failures
    out["ok"] = not failures
    emit(out)
    check(out["ok"], f"svd_fabric: {failures}")


def run(args, torch) -> int:
    import numpy as np

    from repro_torch.core import bidiag_dc as s3dc
    from repro_torch.core import bidiag_svd as s3
    from repro_torch.core import bulge_chasing as bc
    from repro_torch.core import svd as tsvd
    from repro_torch.core import transforms as tr
    from repro_torch.core import tuning
    from repro_torch.core.tuning import PipelineConfig
    from repro_torch.kernels import (_build, bisect, bulge_chase, dc,
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
    runs1 = fuse1_runs(torch)
    cfg1, cfg32, c1, c5 = (cfg for _, _, cfg in runs1[:4])
    nd, bwd = 4096, 64                    # dense fp64 full SVD, tw = 16
    b7, n7, bw7 = 16, 512, 32             # batched fp32 full SVD
    runs4 = fuse4_runs(torch)
    cfg4, c4, cd, c7 = (cfg for _, _, cfg in runs4)
    tw4 = c1.tw
    fused_main = FUSED_MAIN               # the fused small-n tier's runs
    runs = runs1 + runs4
    (main_cycle, main_super, main_sturm, main_band,
     main_cycle_band) = main_path_shapes(bc, runs)
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
             "flash_attention_wgmma_cuda": 0.0, "dc_leaf_cuda": 0.0,
             "dc_deflate_cuda": 0.0, "dc_secular_cuda": 0.0}
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
    # the band entry: super-cycle T // 2 of every main-path fuse-K stage,
    # in every dtype, with ragged live masks, band and tape against the
    # plain version on the same padded band
    band_cases = sorted({s[:5] + (d,) for s in main_band for d in TOLS})
    for n, b_in, tw, b, k, dname in band_cases:
        bandp, p32, first, live, t, tape = band_stage(
            torch, bc, rng, n, b_in, tw, k, b, dtypes[dname])
        want_tape = tuple(x.clone() for x in tape)
        kw = dict(b_in=b_in, tw=tw, fuse=k)
        want = ref.chase_superstep_band_ref(bandp.clone(), p32, first, live,
                                            t, tape=want_tape, **kw)
        got = bulge_chase.chase_superstep_band_cuda(bandp, p32, first, live,
                                                    t, tape=tape, **kw)
        torch.cuda.synchronize()
        compare("chase_superstep_cuda", [got, tape[0][:, t], tape[1][:, t]],
                [want, want_tape[0][:, t], want_tape[1][:, t]], TOLS[dname],
                ("band", n, b_in, tw, b, k, dname), False)
        del bandp, tape, want_tape, want, got
    # the band entry against the blocks entry at the timing shape (the
    # n = 16384 fp32 stage, b_in 64, tw 32, K 4), bit for bit: band, v and
    # the live taus; tau = 0 where not live
    bandp, p32, first, live, t, tape = band_stage(torch, bc, rng, n4, bw4,
                                                  c1.tw, 4, 1, f32)
    h, wk = bandp.shape[1], 4 * bw4 + c1.tw + 1
    rows = torch.arange(h, device=dev)[:, None]
    cols = p32[t].long()[:, None, None] + torch.arange(wk, device=dev)
    blocks = bandp[:, rows, cols].reshape(-1, h, wk).contiguous()
    _, vs, taus = bulge_chase.chase_superstep_cuda(
        blocks, first[t].contiguous(), live[t].contiguous(), b_in=bw4,
        tw=c1.tw, fuse=4, with_tape=True)
    want = bandp.clone()
    want[:, rows, cols] = blocks.reshape(want[:, rows, cols].shape)
    bulge_chase.chase_superstep_band_cuda(bandp, p32, first, live, t,
                                          b_in=bw4, tw=c1.tw, fuse=4,
                                          tape=tape)
    torch.cuda.synchronize()
    on = live[t][None, :, :, None].expand_as(tape[1][:, t])
    taus = taus.reshape(tape[1][:, t].shape)
    band_bitwise = {
        "shape": f"band (1, {h}, {bandp.shape[2]}) fp32, b_in={bw4}, "
                 f"tw={c1.tw}, K=4, slots={p32.shape[1]}, t={t}",
        "band": torch.equal(bandp, want),
        "v": torch.equal(tape[0][:, t], vs.reshape(tape[0][:, t].shape)),
        "live_tau": torch.equal(tape[1][:, t][on], taus[on]),
        "dead_tau_zero": bool((tape[1][:, t][~on] == 0).all())}
    check(all(v for k_, v in band_bitwise.items() if k_ != "shape"),
          f"chase_superstep_cuda: band entry against blocks entry not bit "
          f"for bit: {band_bitwise}")
    n_cmp += 1
    del bandp, tape, blocks, want

    # the fuse-1 band entry: cycle T // 2 of every main-path fuse-1 stage,
    # in every dtype, with ragged live masks: band and tape against the
    # plain version on the same padded band, and bit for bit (band, v, the
    # live taus; tau = 0 where not live) against the windows entry on the
    # gathered windows and the super-step kernel at K = 1
    cycle_band_cases = sorted({s[:5] + (d,) for s in main_cycle_band
                               for d in TOLS})
    cycle_band = {"cases": 0, "routes": {}, "bitwise_vs_windows": True,
                  "bitwise_vs_superstep_k1": True}
    for n, b_in, tw, b, _, dname in cycle_band_cases:
        bandp, p32, first, live, t, tape = band_stage(
            torch, bc, rng, n, b_in, tw, 1, b, dtypes[dname])
        kw = dict(b_in=b_in, tw=tw)
        bands = [bandp.clone() for _ in range(4)]
        tapes = [tuple(x.clone() for x in tape) for _ in range(4)]
        with bulge_chase.BandStage(bands[0], p32, first, live, fuse=1,
                                   tape=tapes[0], **kw) as stage:
            stage(t)
        with bulge_chase.BandStage(bands[1], p32, first, live, fuse=1,
                                   tape=tapes[1], tma=False, **kw) as k1:
            k1(t)
        ref.chase_cycle_band_ref(bands[2], p32, first, live, t,
                                 tape=tapes[2], cycle=bulge_chase.
                                 chase_cycle_cuda, **kw)
        ref.chase_cycle_band_ref(bands[3], p32, first, live, t,
                                 tape=tapes[3], **kw)
        torch.cuda.synchronize()
        key = ("band", n, b_in, tw, b, dname)
        cycle_band["routes"][str(key)] = stage.route
        on = live[t][None, :, :, None].expand_as(tapes[0][1][:, t])
        for name, i in (("bitwise_vs_superstep_k1", 1),
                        ("bitwise_vs_windows", 2)):
            same = (torch.equal(bands[0], bands[i])
                    and torch.equal(tapes[0][0][:, t], tapes[i][0][:, t])
                    and torch.equal(tapes[0][1][:, t][on],
                                    tapes[i][1][:, t][on])
                    and bool((tapes[0][1][:, t][~on] == 0).all()))
            cycle_band[name] = cycle_band[name] and same
            check(same, f"chase_cycle_cuda: band entry at {key} against "
                  f"{name[11:]} not bit for bit")
        compare("chase_cycle_cuda", [bands[0], tapes[0][0][:, t],
                                     tapes[0][1][:, t]],
                [bands[3], tapes[3][0][:, t], tapes[3][1][:, t]],
                TOLS[dname], key, (n, b_in, tw, b, 1, dname)
                in main_cycle_band)
        cycle_band["cases"] += 1
        del bandp, tape, bands, tapes
    check(all(r == "tma" for k_, r in cycle_band["routes"].items()
              if "float32" in k_ or "float64" in k_),
          f"a main-path fuse-1 stage did not take the one-cycle kernel: "
          f"{cycle_band['routes']}")

    # the bisection (sturm_cases), each against the plain version within
    # STURM_TOLS and, reported, bit for bit
    sturm_bitwise = {}
    for b, n, dname, iters, d, s, main in sturm_cases(torch, bisect, s3,
                                                      main_sturm):
        z, bound = gk_inputs(torch, rng, s3, n, b, dtypes[dname])
        want = s3.bisect_plain(z, bound, n=n, max_iter=iters)
        if (d, s) == bisect.schedule(b, n, iters):
            got = bisect.sturm_bisect_cuda(z, bound, n=n, max_iter=iters)
        else:
            got = sturm_run(torch, bisect._fn(z.dtype), z, bound, n, iters,
                            d, s)
        torch.cuda.synchronize()
        key = (b, n, dname, iters, d, s)
        sturm_bitwise[str(key)] = torch.equal(got, want)
        compare("sturm_bisect_cuda", [got], [want], STURM_TOLS[dname], key,
                main)
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
    fused_errs, witness, fused_routes, fused_bitwise = {}, {}, {}, {}

    def fused_err(kind, dname, err):
        fused_errs[f"{kind} {dname}"] = max(
            fused_errs.get(f"{kind} {dname}", 0.0), err)

    def rel(got_, want_):
        err, scale = max_err(torch, got_, want_)
        return err / scale

    fused_cases = fused_check_cases(fused_small)
    name = "fused_small_svd_cuda"
    for b, n, bw, dname in fused_cases:
        a = torch.from_numpy(rng.standard_normal((b, n, n))).to(
            dev, dtypes[dname])
        tol, tol_uv = fused_small.CHECK_TOLS[dname]
        key = (b, n, bw, dname)
        label = f"B={b} n={n} bw={bw} {dname}"
        fused_routes[label] = {
            mode: fused_route_label(tuning, n, bw, dtypes[dname], uv)
            for mode, uv in (("values", False), ("uv", True))}
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
        # values mode: bit for bit the plain bisection on uv mode's (d, e)
        fused_bitwise[label] = torch.equal(
            fused_small.fused_small_svd_cuda(a, bw=bw),
            s3.bidiag_singular_values(got[0], got[1], backend="ref"))
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
    # the divide-and-conquer kernels at every level shape of the two
    # main-path dc calls (phase stage3_dc): bidiagonals of banded matrices
    # of those sizes go through bidiag_dc on the kernels, and every kernel
    # call's inputs are given again to the kernel and to its plain version
    # on the card.  Leaf eigenvalues and the deflation bit for bit, the
    # leaves' rows within DC_ROW_TOLS where no cluster is in the leaf, and
    # in the other leaves each resolved cluster's sums of f^2, f*l and l^2
    # within DC_ROW_TOLS; the roots within DC_ROOT_TOLS of the pole scale
    dc_gen = torch.Generator(device="cuda")
    dc_gen.manual_seed(args.seed + 1)
    dc_calls, dc_bitwise, dc_rows = {}, {}, {}
    for n, dt, cfg in ((n3, f64, cfg1), (n4, f32, c1)):
        d_, e_ = tsvd.bidiagonal_of(banded_matrix(torch, (), n, bw3, dt,
                                                  dc_gen), config=cfg)
        dc_calls[n] = dc_recorded(torch, ops, s3dc, d_, e_)[1]
        del d_, e_
    for n, calls in dc_calls.items():
        for op, a_, kw in calls:
            key = dc_call_shape(op, a_, kw)
            dname = key[-1]
            kernel = DC_OPS[op][0]
            got = dc_run(torch, dc, s3dc, op, a_, kw)
            want = dc_run(torch, dc, s3dc, op, a_, kw, plain=True)
            torch.cuda.synchronize()
            if op == "dc_leaf":
                same = torch.equal(got[0], want[0])
                dc_bitwise[str(key) + " lam"] = same
                check(same, f"{kernel} at {key}: eigenvalues not bit for "
                      f"bit the plain version's")
                lam, ctol = want[0], a_[4]
                gaps = (lam[:, 1:] - lam[:, :-1]).amin(-1)
                sep = gaps >= ctol
                err_rows = [float((g_ - w_).abs().amax(-1)[sep].max())
                            if bool(sep.any()) else 0.0
                            for g_, w_ in zip(got[1:], want[1:])]
                sums_g, size, resolved = dc_cluster_sums(
                    torch, got[0], *got[1:], ctol)
                sums_w = dc_cluster_sums(torch, want[0], *want[1:], ctol)[0]
                held = resolved & ~sep[:, None]
                dc_rows[str(key)] = {
                    "separated_leaves": int(sep.sum()),
                    "max_row_err_separated": max(err_rows),
                    "max_row_err_clustered": max(
                        float((g_ - w_).abs()[~sep].max()) if bool(
                            (~sep).any()) else 0.0
                        for g_, w_ in zip(got[1:], want[1:])),
                    "held_clusters_of_two_or_more": int(
                        (held & (size >= 2)).sum()),
                    "largest_held_cluster": int(size[held].max()) if bool(
                        held.any()) else 0,
                    "unresolved_clusters": int((~resolved).sum()),
                    "max_cluster_sum_err_held": float(
                        (sums_g - sums_w)[:, held].abs().max()) if bool(
                            held.any()) else 0.0,
                    "max_cluster_sum_err_unresolved": float(
                        (sums_g - sums_w)[:, ~resolved].abs().max()) if bool(
                            (~resolved).any()) else 0.0}
                compare(kernel, [g_[sep] for g_ in got[1:]],
                        [w_[sep] for w_ in want[1:]], DC_ROW_TOLS[dname],
                        key, False)
                if bool(held.any()):
                    compare(kernel, [sums_g[:, held]], [sums_w[:, held]],
                            DC_ROW_TOLS[dname], key + ("cluster sums",),
                            False)
                main_err[kernel] = max(main_err[kernel],
                                       float((got[0] - want[0]).abs().max()))
            elif op == "dc_deflate":
                same = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
                dc_bitwise[str(key)] = same
                check(same, f"{kernel} at {key}: not bit for bit the plain "
                      f"scan")
                n_cmp += 1
                main_err[kernel] = max(main_err[kernel], max(
                    float((g_.double() - w_.double()).abs().max())
                    for g_, w_ in zip(got, want)))
            else:
                scale = float((a_[0].abs().amax(-1)
                               + a_[1].sum(-1)).max())
                mu_g, mu_w = got[0] + got[1], want[0] + want[1]
                compare(kernel, [mu_g], [mu_w], DC_ROOT_TOLS[dname], key,
                        False, err_of=lambda g_, w_, s_=scale: float(
                            (g_ - w_).abs().max()) / s_ if w_.numel()
                        else 0.0)
                main_err[kernel] = max(main_err[kernel], float(
                    (mu_g - mu_w).abs().max()) if mu_w.numel() else 0.0)
            del got, want
    dc_shapes = sorted({dc_call_shape(op, a_, kw)[:4] + (
        dc_call_shape(op, a_, kw)[4],) for calls in dc_calls.values()
        for op, a_, kw in calls}, key=str)
    check(all(fused_bitwise.values()), "fused values-mode sigma is not bit "
          "for bit the plain bisection on uv mode's (d, e)")
    emit({"phase": "kernels_vs_plain", "ok": True, "comparisons": n_cmp,
          "main_path_shapes": {
              "chase_cycle_cuda (b_in, tw, slots, dtype)": main_cycle,
              "chase_cycle_cuda band entry (n, b_in, tw, B, K, dtype)":
                  main_cycle_band,
              "chase_superstep_cuda (b_in, tw, slots, K, dtype)": main_super,
              "chase_superstep_cuda band entry (n, b_in, tw, B, K, dtype)":
                  main_band,
              "sturm_bisect_cuda (B, n, dtype)": main_sturm,
              "tape_apply_cuda (layout, S, m, k, w, dtype, where)":
                  main_tape,
              "fused_small_svd_cuda (B, n, bw, dtype)": fused_main,
              "flash_attention_wgmma_cuda (BH, S, D, g, dtype)":
                  FLASH_MAIN + (FLASH_GROUP, "bfloat16"),
              "flash_attention_cuda (BH, S, D, g, dtype)":
                  FLASH_MAIN + (FLASH_GROUP, "float32")},
          "band_cases": len(band_cases),
          "band_vs_blocks_bitwise": band_bitwise,
          "cycle_band": cycle_band,
          "sturm_bitwise_vs_plain": sturm_bitwise,
          "flash_cases": flash_cases,
          "fused_cases": len(fused_cases),
          "fused_routes": fused_routes,
          "fused_sigma_bitwise_vs_plain_bisection": fused_bitwise,
          "fused_worst_err_over_scale": fused_errs,
          "fused_uv_entries_witness": witness,
          "dc_level_shapes (op, P, m, nact, dtype)": dc_shapes,
          "dc_bitwise_vs_plain": dc_bitwise,
          "dc_leaf_rows": dc_rows,
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
                         "dc leaf rows fp64/fp32 (leaves with no cluster; "
                         "resolved clusters' sums of f^2, f*l, l^2 in the "
                         "others)":
                             list(DC_ROW_TOLS.values()),
                         "dc roots fp64/fp32 (times max|d| + sum w)":
                             list(DC_ROOT_TOLS.values()),
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
            # (a second trace where the first saw no device time)
            library_kernels=(profiler_ms(torch, library, "", 2)
                             or profiler_ms(torch, library, "", 2)
                             if library is not None else None),
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
    # the same cycle in place on the main path's stage: cycle T // 2 of the
    # n = 16384 fp32 stage (every slot live), through the band entry as
    # reduce_stage_packed launches it for banded_singular_values (no
    # tape): the one-cycle kernel, its rectangles moved by TMA, beside the
    # super-step kernel at K = 1 on the same cycle, whose moves walk the
    # panels' cells
    bandp, p32, firstb, liveb, tb, _ = band_stage(
        torch, bc, rng, n4, bw4, tw4, 1, 1, torch.float32, ragged=False)
    stages = {route: bulge_chase.BandStage(bandp, p32, firstb, liveb,
                                           fuse=1, tma=route == "tma", **kw)
              for route in ("tma", "panels")}
    check(stages["tma"].route == "tma", "the n = 16384 fp32 stage did not "
          "take the one-cycle kernel")
    band_ms = {}
    for route, symbol in (("tma", "chase_cycle_band_kernel"),
                          ("panels", "chase_superstep_kernel")):
        call = (lambda st=stages[route]: st(tb))
        prof = profiler_ms(torch, call, symbol, 50)
        band_ms[route] = (prof[0] if prof is not None else None,
                          gpu_ms(torch, call, iters=500, warmup=2))
    timing["chase_cycle_cuda"].update(
        main_path_ms=band_ms["tma"][0] or band_ms["tma"][1],
        main_path_events_ms=band_ms["tma"][1],
        superstep_k1_main_path_ms=band_ms["panels"][0] or band_ms["panels"][1],
        superstep_k1_main_path_events_ms=band_ms["panels"][1],
        main_path_shape=f"in place: band (1, {bandp.shape[1]}, "
                        f"{bandp.shape[2]}) fp32, cycle {tb} of "
                        f"{p32.shape[0]}, {p32.shape[1]} slots, b_in={bw4}, "
                        f"tw={tw4}, no tape; one TMA box of "
                        f"{tuning.cycle_tile(bw4, tw4, torch.float32)[0]} "
                        f"columns each way per slot",
        main_path_bound=chase_bound(bw4, tw4, g1, 1, "float32", 4))
    del bandp, stages

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
    # the same kernel in place on the main path's stage: super-cycle T // 2
    # of the n = 16384 fp32 stage (every slot live), through the band
    # entry with the tape, as reduce_stage_packed launches it
    bandp, p32, firstb, liveb, tb, tape = band_stage(
        torch, bc, rng, n4, bw4, tw4, 4, 1, torch.float32, ragged=False)
    band_call = (lambda: bulge_chase.chase_superstep_band_cuda(
        bandp, p32, firstb, liveb, tb, tape=tape, **kw2))
    band_prof = profiler_ms(torch, band_call, "chase_superstep_kernel", 50)
    timing["chase_superstep_cuda"].update(
        main_path_ms=(band_prof[0] if band_prof is not None
                      else gpu_ms(torch, band_call, iters=500, warmup=2)),
        main_path_events_ms=gpu_ms(torch, band_call, iters=500, warmup=2),
        main_path_shape=f"in place: band (1, {bandp.shape[1]}, "
                        f"{bandp.shape[2]}) fp32, super-cycle {tb} of "
                        f"{p32.shape[0]}, {p32.shape[1]} slots, b_in={bw4}, "
                        f"tw={tw4}, K=4, with the tape",
        main_path_bound=chase_bound(bw4, tw4, g2, 4, "float32", 4))
    del bandp, tape

    # the library yardstick computes the same values from the dense
    # bidiagonal whose Golub-Kahan off-diagonal is z (built outside the
    # timing)
    n_s = 512
    z, bound = gk_inputs(torch, rng, s3, n_s, 1, torch.float64)
    dense_b = (torch.diag(z[0, 0::2]) + torch.diag(z[0, 1::2], 1))
    time_kernel(
        "sturm_bisect_cuda", "sturm_bisect",
        lambda: bisect.sturm_bisect_cuda(z, bound, n=n_s, max_iter=60),
        lambda: s3.bisect_plain(z, bound, n=n_s, max_iter=60), 5, 1,
        f"B=1, n={n_s} fp64, 60 steps, (d, s) = "
        f"{bisect.schedule(1, n_s, 60)}",
        sturm_bound(1, n_s, 60, "float64", 8),
        library=lambda: torch.linalg.svdvals(dense_b))
    timing["sturm_bisect_cuda"]["bitwise_vs_plain"] = torch.equal(
        bisect.sturm_bisect_cuda(z, bound, n=n_s, max_iter=60),
        s3.bisect_plain(z, bound, n=n_s, max_iter=60))
    # the kernels alone at the main path's largest bisection, n = 16384
    # fp32 (phase 4 reads the whole call, prescale included)
    z, bound = gk_inputs(torch, rng, s3, n4, 1, torch.float32)
    big = profiler_ms(torch, lambda: bisect.sturm_bisect_cuda(
        z, bound, n=n4, max_iter=40), "sturm_bisect", 2)
    timing["sturm_bisect_cuda"].update(
        main_path_kernel_ms=big and big[0],
        main_path_ms_by_kernel=big and big[2],
        main_path_schedule=bisect.schedule(1, n4, 40))
    del z, bound
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
        key = "fused_small_svd_cuda" + ("" if i == 0 else " (second shape)")
        route = fused_route_label(tuning, n, bw, dtypes[dname], False)
        time_kernel(
            key, "fused_small_kernel",
            lambda a=a, bw=bw: fused_small.fused_small_svd_cuda(a, bw=bw),
            lambda a=a, bw=bw: ref.fused_small_svd_ref(a, bw=bw),
            20 if i == 0 else 10, 1, f"B={b}, n={n}, bw={bw} {dname}, "
            f"values, route {route}, (d, s) = "
            f"{fused_small.bisect_schedule(n, iters)}",
            fused_bound(b, n, bw, iters, dname, a.element_size()),
            library=lambda a=a: torch.linalg.svdvals(a))
        timing[key]["route"] = route
        if i == 0:        # uv mode at the same shape; no PyTorch call
            route = fused_route_label(tuning, n, bw, dtypes[dname], True)
            time_kernel(
                "fused_small_svd_cuda (uv)", "fused_small_kernel",
                lambda a=a, bw=bw: fused_small.fused_small_svd_cuda(
                    a, bw=bw, compute_uv=True),
                lambda a=a, bw=bw: ref.fused_small_svd_ref(
                    a, bw=bw, compute_uv=True),
                20, 1, f"B={b}, n={n}, bw={bw} {dname}, uv (d, e, U2, "
                f"V2^T), route {route}",
                fused_bound(b, n, bw, iters, dname, a.element_size(),
                            compute_uv=True))
            timing["fused_small_svd_cuda (uv)"]["route"] = route
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
        timing[name]["fma_bound_ms"] = flash_bound(
            bh, bkv, sl, d, dname, q.element_size(), fma=True)[0]
        del q, k, v, kr, vr
    # the divide-and-conquer kernels at the fp64 n = 4096 call's shapes (the
    # calls recorded for kernels_vs_plain): the leaves, and the deflation
    # scan and the secular roots of the top merge level.  The library
    # yardstick of the leaves is torch.linalg.eigh of the batch of dense
    # leaves (eigenvalues and all eigenvectors, more than the kernel
    # returns); the scan and the roots have no PyTorch counterpart
    top = {}
    for op, a_, kw in dc_calls[n3]:
        if op not in top or a_[0].shape[-1] >= top[op][1][0].shape[-1]:
            top[op] = (op, a_, kw)
    _, a_, kw = top["dc_leaf"]
    p_, lm_ = a_[0].shape
    dense_leaves = (torch.diag_embed(a_[0]) + torch.diag_embed(a_[1], 1)
                    + torch.diag_embed(a_[1], -1))
    time_kernel(
        "dc_leaf_cuda", "dc_leaf_kernel",
        lambda: dc_run(torch, dc, s3dc, "dc_leaf", a_, kw),
        lambda: dc_run(torch, dc, s3dc, "dc_leaf", a_, kw, plain=True), 20,
        1, f"P={p_} leaves of lm={lm_} fp64, {kw['bisect_iters']} bisection "
        f"steps, {kw['inv_iters']} inverse iterations",
        dc_leaf_bound(p_, lm_, kw["bisect_iters"], kw["inv_iters"],
                      "float64", 8),
        library=lambda: torch.linalg.eigh(dense_leaves))
    _, a_, kw = top["dc_deflate"]
    p_, m_ = a_[0].shape
    scan = tuple(x.clone() for x in a_)
    time_kernel(
        "dc_deflate_cuda", "dc_deflate_kernel",
        lambda: dc.dc_deflate_cuda(*scan),
        lambda: dc_run(torch, dc, s3dc, "dc_deflate", a_, kw, plain=True),
        20, 1, f"P={p_}, m={m_} fp64 (the top merge level)",
        dc_deflate_bound(p_, m_, "float64", 8))
    _, a_, kw = top["dc_secular"]
    p_, m_ = a_[0].shape
    nact_ = kw["nact"]
    roots = int(a_[3][:, :nact_].sum())
    time_kernel(
        "dc_secular_cuda", "dc_secular_kernel",
        lambda: dc_run(torch, dc, s3dc, "dc_secular", a_, kw),
        lambda: dc_run(torch, dc, s3dc, "dc_secular", a_, kw, plain=True),
        10, 1, f"P={p_}, m={m_}, nact={nact_}, {roots} active roots fp64 "
        f"(the top merge level)",
        dc_secular_bound(p_, m_, nact_, roots, a_[6].shape[-1],
                         kw["newton_iters"], "float64", 8))
    del scan, dense_leaves, top
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

    # ---- stage 3 by divide and conquer, on the matrices of phases 3-4 ---
    stage3_dc(torch, tsvd, s3, s3dc, drive, PipelineConfig, gen,
              [(a3, cfg1, sig1, sv3, (d4, e4)), (a4, c1, s41, fro2, (d, e))])
    del a3, a4

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

    # ---- the autotuner on the card --------------------------------------
    autotune_phase(torch, PipelineConfig)

    # ---- SVD serving: AsyncSVDEngine on the card -----------------------
    serve_out = svd_serve_phase(torch, main_counts)

    # ---- SVD serving across devices and processes ----------------------
    svd_fabric_phase(torch, main_counts, offered_rate=serve_out[
        "poisson_clean"]["offered_per_s"])

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
        key = "chase_cycle_cuda" if f == 1 else "chase_superstep_cuda"
        before = ops.launch_counts()[key]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_stage()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        launches = ops.launch_counts()[key] - before
        ka = prof.key_averages()
        on_card = [ev for ev in ka if "CUDA" in str(ev.device_type)]
        busy_us = sum(ev.device_time_total for ev in on_card)
        cpu_ops = [ev for ev in ka if ev not in on_card]
        top = sorted(cpu_ops, key=lambda ev: ev.self_cpu_time_total,
                     reverse=True)[:8]
        kern = sorted(on_card, key=lambda ev: ev.device_time_total,
                      reverse=True)[:5]
        cycles = bc.stage_schedule(n6, bw4, tw4, f)[1]
        eager = {key: sum(ev.count for ev in ka if ev.key == key)
                 for key in ("aten::index", "aten::index_put_")}
        symbol = ("chase_cycle_band_kernel" if f == 1
                  else "chase_superstep_kernel")
        # a (super-)cycle is one launch (the wrapper's count) and nothing
        # else; the trace's kernel count is reported beside it
        ok_f = launches == cycles and not any(eager.values())
        emit({"phase": "stage2_profile", "ok": ok_f, "n": n6, "b_in": bw4,
              "tw": tw4, "fuse": f, "dtype": "float32", "cycles": cycles,
              "eager_ops": eager, "kernel": symbol,
              "launches_per_cycle": launches / cycles,
              "traced_kernels_per_cycle": sum(
                  ev.count for ev in ka if symbol in ev.key) / cycles,
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
        check(ok_f, f"stage2_profile fuse {f}: {launches} launches for "
              f"{cycles} (super-)cycles, eager ops {eager}")

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
                   "src/repro_torch/kernels/csrc/flash_attn_wgmma.cu",
               "dc_leaf_cuda": "src/repro_torch/kernels/csrc/dc.cu",
               "dc_deflate_cuda": "src/repro_torch/kernels/csrc/dc.cu",
               "dc_secular_cuda": "src/repro_torch/kernels/csrc/dc.cu"}
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
                                      "D in {64, 128}",
        "dc_leaf_cuda": "src/repro/core/bidiag_dc.py:171 (_leaf_eigen, with "
                        "_tridiag_count :114 and _tridiag_solve_diag :134; "
                        "jnp, no pallas_call)",
        "dc_deflate_cuda": "src/repro/core/bidiag_dc.py:574 (the Givens "
                           "scan of _merge_pair, :574-605; lax.scan, no "
                           "pallas_call)",
        "dc_secular_cuda": "src/repro/core/bidiag_dc.py:297 (_secular_roots"
                           "; jnp, no pallas_call)"}
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
        if t["library_kernels"] is not None:
            row["library_kernels"] = sorted(
                t["library_kernels"][2], key=t["library_kernels"][2].get,
                reverse=True)
        if "fma_bound_ms" in t:
            row["fma_bound_ms"] = t["fma_bound_ms"]
        if "main_path_ms" in t:
            row.update(main_path_ms=t["main_path_ms"],
                       main_path_shape=t["main_path_shape"],
                       main_path_bound_ms=t["main_path_bound"][0])
        for field in ("superstep_k1_main_path_ms", "main_path_kernel_ms",
                      "main_path_ms_by_kernel", "main_path_schedule",
                      "bitwise_vs_plain", "route"):
            if field in t:
                row[field] = t[field]
        for suffix, field in ((" (replay)", "replay_shape"),
                              (" (second shape)", "second_shape"),
                              (" (uv)", "uv_shape")):
            second = timing.get(f"{name}{suffix}")
            if second is None:
                continue
            row[field] = {
                "shape": second["shape"], "ms": second["ms"],
                "route": second.get("route"),
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
